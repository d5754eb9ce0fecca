"""FlowNet-C correlation cost volume (NCHW), its gradient, and their CUDA
kernels.

Counterpart of ``maskflownet_tpu/ops/correlation.py:27-100`` and of the
``custom_vjp`` pair ``correlation_pallas`` / ``correlation_pallas_cmajor``
(``maskflownet_tpu/ops/pallas/correlation.py:274-410``):

  ``out[n, (dy+md)*(2md+1) + (dx+md), y, x]
      = act(mean_c f1[n, c, y, x] * f2[n, c, y+dy, x+dx])``

for ``dy, dx in [-md, md]``, f2 zero outside the image, displacement
channels y-major, ``act`` LeakyReLU(``leaky``) or the identity.

``correlation`` goes through :class:`CorrelationFunction` on both devices.
A CPU tensor takes ``correlation_plain`` forward and
``correlation_bwd_plain`` backward; a CUDA tensor takes the hand-written
kernels of ``csrc/correlation.cu`` through ``corr_fwd``, ``corr_bwd_f1``
and ``corr_bwd_f2``, or raises. There is no fallback from a kernel to the
plain version. ``corr_fwd`` returns a tensor without a gradient, so it
refuses an input that asks for one while grad mode is on.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from maskflownet_torch.ops import _build

MAX_MD = 4  # the kernel is instantiated for md = 1..4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, md: int,
                      leaky: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: the kernel's contract on any device (f32
    products and sums, the activation on the f32 value, one cast to the
    input dtype at the end)."""
    n, c, h, w = f1.shape
    d = 2 * md + 1
    a = f1.float()
    b = F.pad(f2.float(), (md, md, md, md))
    out = torch.stack([(a * b[:, :, dy:dy + h, dx:dx + w]).sum(1)
                       for dy in range(d) for dx in range(d)], 1) * (1.0 / c)
    if leaky is not None:
        out = F.leaky_relu(out, leaky)
    return out.to(f1.dtype)


def _plain_cotangent(g, out, leaky):
    """g' in f32: the cotangent rescaled by the LeakyReLU's derivative, read
    off the sign of the saved output (``out >= 0 ? g : leaky*g``)."""
    gp = g.float()
    return gp if leaky is None else torch.where(out >= 0, gp, leaky * gp)


def correlation_bwd_f1_plain(g: torch.Tensor, f2: torch.Tensor,
                             out: torch.Tensor | None, md: int,
                             leaky: float | None = None) -> torch.Tensor:
    """Plain version of ``corr_bwd_f1`` (same arguments): one shifted
    multiply-add per displacement, ``df1 += g'_t * f2(y+dy, x+dx)``, f32
    throughout, one cast at the end."""
    n, c, h, w = f2.shape
    d = 2 * md + 1
    gp = _plain_cotangent(g, out, leaky)
    b = F.pad(f2.float(), (md, md, md, md))
    df1 = torch.zeros((n, c, h, w), device=f2.device)
    for t in range(d * d):
        dy, dx = divmod(t, d)
        df1 += gp[:, t:t + 1] * b[:, :, dy:dy + h, dx:dx + w]
    return (df1 * (1.0 / c)).to(f2.dtype)


def correlation_bwd_f2_plain(g: torch.Tensor, f1: torch.Tensor,
                             out: torch.Tensor | None, md: int,
                             leaky: float | None = None) -> torch.Tensor:
    """Plain version of ``corr_bwd_f2`` (same arguments): one shifted
    multiply-add per displacement into a zero-padded accumulator,
    ``df2(y+dy, x+dx) += g'_t * f1``, f32 throughout, one cast at the
    end."""
    n, c, h, w = f1.shape
    d = 2 * md + 1
    gp = _plain_cotangent(g, out, leaky)
    a = f1.float()
    df2 = torch.zeros((n, c, h + 2 * md, w + 2 * md), device=f1.device)
    for t in range(d * d):
        dy, dx = divmod(t, d)
        df2[:, :, dy:dy + h, dx:dx + w] += gp[:, t:t + 1] * a
    return (df2[:, :, md:md + h, md:md + w] * (1.0 / c)).to(f1.dtype)


def correlation_bwd_plain(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                          out: torch.Tensor | None, md: int,
                          leaky: float | None = None):
    """Plain PyTorch gradient of ``correlation_plain``: ``(df1, df2)`` for
    the cotangent ``g`` of its output, in the dtype of f1/f2. With
    ``leaky``, ``out`` is the saved output whose sign gives the
    activation's derivative; without it, None."""
    return (correlation_bwd_f1_plain(g, f2, out, md, leaky),
            correlation_bwd_f2_plain(g, f1, out, md, leaky))


# Mirrors of csrc/correlation.cu's tiling constants (see corr_plan).
FWD_CHUNK = 32      # channels a staged forward chunk (FKC)
FWD_GW = 3          # dy rows a forward warp (GW)
FWD_MAX_WARPS = 8   # warps a forward block at most
MAX_CLUSTER = 8     # cluster ranks (channel splits) at most, portable size
WINDOW_PAD = 4      # the forward's window starts at x0 - 4 (FP)
BWD_PAD = 8         # corr_bwd_f2's window starts at x0 - 8 (FP_BWD)
BWD_MAX_WARPS = 4   # warps a corr_bwd_f2 block at most
MIN_WARPS = 4       # warps a block at least (those past the tasks stage)
BWD_CHANNELS = 64   # channels a corr_bwd_f2 block owns at most
BWD_K = 32          # source pixels of a corr_bwd_f2 tile (BK)
BWD_STAGES = 3      # staged source rows a corr_bwd_f2 block (BST)
F1_MAX_WARPS = 8    # warps a corr_bwd_f1 block at most
F1_SHIFT = 4        # corr_bwd_f1's target columns start at x0 - 4
# a corr_bwd_f1 block aims at two blocks a multiprocessor: at most this much
# shared memory in a 2-byte type (the H100's 228 KB, 1 KB a block reserved)
F1_SMEM_AIM = 113 * 1024
MAX_SMEM = 232448   # dynamic shared memory a block may take on an H100


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_ld(n: int) -> int:
    """csrc's ``pad_ld``: a multiple of 8 elements whose 2-byte pitch is an
    odd multiple of 16 bytes."""
    n = _cdiv(n, 8) * 8
    return n + 8 if (n // 8) % 2 == 0 else n


def _band_pitch(th: int, tx: int) -> int:
    """csrc's ``band_pitch``: the forward's band-buffer row pitch (floats),
    >= tx with th * pitch = 4 (mod 32), else 8 (mod 32)."""
    for want in (4, 8):
        for bp in range(tx, tx + 32):
            if th * bp % 32 == want:
                return bp
    return tx


def fwd_smem_bytes(esize: int, md: int, th: int, wj: int, ndg: int,
                   kc: int) -> int:
    """Dynamic shared memory of one forward block (csrc's
    ``fwd_smem_bytes``): one or two staged chunks, or the f32 band buffer
    of the epilogue that aliases them."""
    tx = 16 * wj
    stage = FWD_CHUNK * (_pad_ld(th * tx) + _pad_ld(
        (th + FWD_GW * ndg - 1) * (tx + 2 * WINDOW_PAD)))
    staged = (2 if kc > FWD_CHUNK else 1) * stage * esize
    return max(staged,
               FWD_GW * ndg * (2 * md + 1) * th * _band_pitch(th, tx) * 4)


def bwd_smem_bytes(esize: int, md: int, th: int, wj: int, cpb: int) -> int:
    """Dynamic shared memory of one ``corr_bwd_f2`` block (csrc's
    ``bwd_smem_bytes``): a ring of staged source rows and M."""
    tx = 16 * wj
    stage = cpb * _pad_ld(tx + 2 * BWD_PAD) + 2 * th * (2 * md + 1) * (
        tx + 2 * BWD_PAD)
    return BWD_STAGES * stage * esize + th * wj * 16 * (BWD_K + 8) * 4


def _f1_tap_elems(th: int, wj: int) -> int:
    """csrc's ``f1_tap_elems``: elements one tap of a staged g (or out)
    tile may take, by rows or as a run."""
    return max(th * (16 * wj + 8), th * 16 * wj + 40)


def bwd_f1_smem_bytes(esize: int, md: int, th: int, wj: int, cpb: int,
                      runs: bool) -> int:
    """Dynamic shared memory of one ``corr_bwd_f1`` block (csrc's
    ``bwd_f1_smem_bytes``): the th + 2md rows of f2 in the window layout,
    the g and out tiles, and, when one column tile spans the image
    (``runs``), f2's rows as runs."""
    d = 2 * md + 1
    return ((th + 2 * md) * cpb * _pad_ld(16 * wj + BWD_PAD)
            + 2 * d * d * _f1_tap_elems(th, wj)
            + (cpb * ((th + 2 * md) * 16 * wj + 32) if runs else 0)) * esize


def bwd_f1_run_pitch(length: int, reach: int, stride: int) -> int:
    """csrc's ``f1_run_pitch``: the pitch (elements) of runs of ``length``
    elements staged as 16-byte chunks at an offset in [8, 16), holding
    ``reach`` elements from a run's start, rounded up to ``stride`` (the
    runs' distance in memory) modulo 8."""
    need = max(length + 22, reach + 15)
    return need + (stride - need) % 8


class CorrPlan(NamedTuple):
    """The tiling of ``csrc/correlation.cu`` for one shape and md.

    * forward: blocks of ``fwd_th`` output rows x ``16 * fwd_wj`` columns
      x ``fwd_ndg`` groups of 3 dy rows (one warp a row, column tile and
      group, at least ``MIN_WARPS``), ``fwd_kc`` channels a cluster rank,
      ``fwd_cs`` ranks a cluster (1: no cluster);
    * ``corr_bwd_f2``: blocks of ``bwd_th`` target rows x ``16 * bwd_wj``
      columns (one warp each, at least ``MIN_WARPS``) x ``bwd_cpb``
      channels;
    * ``corr_bwd_f1``: the same with ``f1_th``, ``f1_wj``, ``f1_cpb`` (up
      to ``F1_MAX_WARPS`` warps), its tiles small enough that two blocks
      fit a multiprocessor where a split allows.

    ``*_blocks`` and ``*_threads`` size each grid; ``*_floor`` is True
    when the plan launches fewer than two blocks a multiprocessor because
    no split is left (every block holds one row, one dy group and one
    16-channel chunk, or one target row, tile and 16 channels)."""

    fwd_th: int
    fwd_wj: int
    fwd_ndg: int
    fwd_kc: int
    fwd_cs: int
    fwd_blocks: int
    fwd_threads: int
    fwd_floor: bool
    bwd_th: int
    bwd_wj: int
    bwd_cpb: int
    bwd_blocks: int
    bwd_threads: int
    bwd_floor: bool
    f1_th: int
    f1_wj: int
    f1_cpb: int
    f1_blocks: int
    f1_threads: int
    f1_floor: bool


def _fwd_tiling(n, c, h, w, md, sms):
    ng = _cdiv(2 * md + 1, FWD_GW)
    k16 = _cdiv(c, 16)
    ndg = ng

    def rows(wj):
        return max(1, min(h, FWD_MAX_WARPS // (wj * ndg)))

    def staged(wj):
        # f1 and f2 elements an image's blocks stage a channel
        th, tx = rows(wj), 16 * wj
        return _cdiv(h, th) * _cdiv(w, tx) * (
            th * tx + (th + FWD_GW * ndg - 1) * (tx + 2 * WINDOW_PAD))

    wj = min((1, 2) if w > 16 else (1,), key=staged)
    th = rows(wj)
    kr = k16  # k16 steps a rank

    def blocks(th, ndg, kr):
        return (n * _cdiv(h, th) * _cdiv(w, 16 * wj) * _cdiv(ng, ndg)
                * _cdiv(k16, kr))

    def more_ranks(kr, least):
        # the next smaller k16 steps a rank that adds ranks, <= MAX_CLUSTER
        for k in range(kr - 1, least - 1, -1):
            if _cdiv(k16, kr) < _cdiv(k16, k) <= MAX_CLUSTER:
                return k
        return None

    # split until two blocks a multiprocessor: channels across a cluster
    # while each rank keeps a whole chunk, then the dy groups, then
    # channels down to one k16 step a rank, then rows
    while blocks(th, ndg, kr) < 2 * sms:
        if (k := more_ranks(kr, FWD_CHUNK // 16)) is not None:
            kr = k
        elif ndg > 1:
            ndg = 1
        elif (k := more_ranks(kr, 1)) is not None:
            kr = k
        elif th > 1:
            th = _cdiv(th, 2)
        else:
            break
    b = blocks(th, ndg, kr)
    return (th, wj, ndg, 16 * kr, _cdiv(k16, kr), b,
            32 * max(MIN_WARPS, th * wj * ndg), b < 2 * sms)


def _bwd_tiling(n, c, h, w, sms, max_warps, fits=lambda th, wj, cpb: True,
                shift=0):
    """A gradient kernel's blocks of th target rows x 16*wj columns x cpb
    channels, one warp a row and column tile (at most ``max_warps``); the
    column tiles start ``shift`` left of column 0."""
    wj = 2 if w + shift > 16 else 1
    th = max(1, min(h, max_warps // wj))
    cpb = min(BWD_CHANNELS, _cdiv(c, 16) * 16)

    def blocks(th, cpb):
        return n * _cdiv(h, th) * _cdiv(w + shift, 16 * wj) * _cdiv(c, cpb)

    def split(th, cpb):
        # channels down to 32 a block, then target rows, then channels
        # down to 16; None when every split is taken
        if cpb > 32:
            return th, 32
        if th > 1:
            return _cdiv(th, 2), cpb
        if cpb > 16:
            return th, 16
        return None

    # split until the tiles fit, then until two blocks a multiprocessor
    for done in (lambda th, cpb: fits(th, wj, cpb),
                 lambda th, cpb: blocks(th, cpb) >= 2 * sms):
        while not done(th, cpb) and (nxt := split(th, cpb)) is not None:
            th, cpb = nxt
    b = blocks(th, cpb)
    return th, wj, cpb, b, 32 * max(MIN_WARPS, th * wj), b < 2 * sms


def f1_runs(w: int, wj: int) -> bool:
    """Whether corr_bwd_f1's one column tile spans an image of width w,
    so that it stages g, out and f2 as runs."""
    return w + F1_SHIFT <= 16 * wj


def _f1_fits(md, w):
    """Whether a corr_bwd_f1 tile leaves two blocks a multiprocessor in a
    2-byte type and fits one block in f32."""
    return lambda th, wj, cpb: all(
        bwd_f1_smem_bytes(es, md, th, wj, cpb, f1_runs(w, wj)) <= most
        for es, most in ((2, F1_SMEM_AIM), (4, MAX_SMEM)))


@functools.lru_cache(maxsize=1024)
def corr_plan(n: int, c: int, h: int, w: int, md: int,
              sms: int = 132) -> CorrPlan:
    """The kernels' tiling for features (n, c, h, w) at ``md`` on a card of
    ``sms`` multiprocessors: each kernel splits its work until it launches
    two blocks a multiprocessor or every split is taken (the latency floor
    of the coarse levels, ``*_floor``)."""
    return CorrPlan(*_fwd_tiling(n, c, h, w, md, sms),
                    *_bwd_tiling(n, c, h, w, sms, BWD_MAX_WARPS),
                    *_bwd_tiling(n, c, h, w, sms, F1_MAX_WARPS,
                                 _f1_fits(md, w), F1_SHIFT))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(t: torch.Tensor, md: int) -> CorrPlan:
    return corr_plan(*t.shape, md, _sm_count(t.device.index))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("correlation")
    lib.mfn_corr_fwd.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.mfn_corr_fwd.restype = ctypes.c_int
    for fn in (lib.mfn_corr_bwd_f1, lib.mfn_corr_bwd_f2):
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.mfn_corr_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.mfn_corr_smem_bytes.restype = ctypes.c_int
    lib.mfn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mfn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def dense_per_image(t: torch.Tensor) -> bool:
    """Whether each image of an (N, K, H, W) tensor is one dense (K, H, W)
    block, the images at any non-overlapping distance (a channel slice of
    a larger NCHW tensor is): the layout the gradient kernels read g in."""
    n, k, h, w = t.shape
    sizes, strides = (k, h, w), t.stride()[1:]
    expect = 1
    for size, stride in zip(reversed(sizes), reversed(strides)):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return n == 1 or t.stride(0) >= expect


def _check(name: str, feats, maps, md: int) -> None:
    """Raise unless the kernel takes these inputs: ``feats`` are the (N,C,H,W)
    feature maps, ``maps`` the (N,(2md+1)^2,H,W) cotangent/output maps. The
    first map may be any tensor each of whose images is dense
    (:func:`dense_per_image`); every other input is contiguous."""
    ts = list(feats) + list(maps)
    dev, dtype = ts[0].device, ts[0].dtype
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: inputs must lie on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in ts):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in ts]} not taken; "
                        "expected one of f32, bf16, f16 for all")
    shape = feats[0].shape
    if feats[0].dim() != 4 or 0 in shape or any(
            t.shape != shape for t in feats):
        raise ValueError(f"{name}: expected equal non-empty NCHW feature "
                         f"shapes, got {[tuple(t.shape) for t in feats]}")
    if not 1 <= md <= MAX_MD:
        raise ValueError(f"{name}: md={md} outside 1..{MAX_MD}")
    n, c, h, w = shape
    dshape = (n, (2 * md + 1) ** 2, h, w)
    if any(tuple(t.shape) != dshape for t in maps):
        raise ValueError(f"{name}: expected {dshape} for the cost-volume "
                         f"maps, got {[tuple(t.shape) for t in maps]}")
    if not all(t.is_contiguous() for t in list(feats) + list(maps[1:])) \
            or (maps and not dense_per_image(maps[0])):
        raise ValueError(f"{name}: inputs must be contiguous NCHW (the "
                         "cotangent: each image one dense block)")
    if c * h * w >= 2 ** 31 or dshape[1] * h * w >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(shape)} too large")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: launch failed: "
                           f"{_lib().mfn_cuda_error_string(err).decode()}")


def corr_fwd(f1: torch.Tensor, f2: torch.Tensor, md: int,
             leaky: float | None = None) -> torch.Tensor:
    """Launch the CUDA forward kernel on the current stream, tiled by
    :func:`corr_plan`.

    f1/f2: contiguous NCHW CUDA tensors of one shape and dtype (f32, bf16
    or f16). Returns (N, (2md+1)^2, H, W) in that dtype, without a
    gradient: with grad mode on, an input that requires one raises (use
    ``correlation``). Raises on any input the kernel does not take, and if
    the launch reports an error."""
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        raise RuntimeError("corr_fwd: an input requires grad, and the "
                           "kernel's output would drop it; call "
                           "correlation(), whose backward runs the "
                           "gradient kernels")
    _check("corr_fwd", (f1, f2), (), md)
    n, c, h, w = f1.shape
    d = 2 * md + 1
    plan = _plan_for(f1, md)
    out = torch.empty((n, d * d, h, w), dtype=f1.dtype, device=f1.device)
    with torch.cuda.device(f1.device):
        err = _lib().mfn_corr_fwd(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, c, h, w, md,
            _DTYPE_CODES[f1.dtype], 0.0 if leaky is None else float(leaky),
            int(leaky is not None), plan.fwd_th, plan.fwd_wj, plan.fwd_ndg,
            plan.fwd_kc, torch.cuda.current_stream().cuda_stream)
    _raise_on("corr_fwd", err)
    corr_fwd.launches += 1
    return out


corr_fwd.launches = 0


def _bwd(name: str, g, feat, out, md, leaky):
    if (out is None) != (leaky is None):
        raise ValueError(f"{name}: pass the saved output exactly when the "
                         "LeakyReLU is fused (leaky is not None)")
    _check(name, (feat,), (g,) if out is None else (g, out), md)
    n, c, h, w = feat.shape
    grad = torch.empty_like(feat)
    lib = _lib()
    args = (g.data_ptr(), None if out is None else out.data_ptr(),
            feat.data_ptr(), grad.data_ptr(), n, c, h, w, md,
            _DTYPE_CODES[feat.dtype], 0.0 if leaky is None else float(leaky),
            g.stride(0))
    plan = _plan_for(feat, md)
    tiling = ((plan.f1_th, plan.f1_wj, plan.f1_cpb) if name == "corr_bwd_f1"
              else (plan.bwd_th, plan.bwd_wj, plan.bwd_cpb))
    with torch.cuda.device(feat.device):
        err = getattr(lib, f"mfn_{name}")(
            *args, *tiling, torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    return grad


def corr_bwd_f1(g: torch.Tensor, f2: torch.Tensor, out: torch.Tensor | None,
                md: int, leaky: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel for d cost / d f1 on the current stream,
    tiled by :func:`corr_plan`.

    g (the cotangent): (N,(2md+1)^2,H,W), each image one dense block (a
    channel slice of a larger tensor is taken as it is); out (the
    forward's saved output, None without ``leaky``): contiguous, as g;
    f2: contiguous (N,C,H,W); one CUDA device and dtype. Returns df1
    (N,C,H,W) in that dtype."""
    df1 = _bwd("corr_bwd_f1", g, f2, out, md, leaky)
    corr_bwd_f1.launches += 1
    return df1


corr_bwd_f1.launches = 0


def corr_bwd_f2(g: torch.Tensor, f1: torch.Tensor, out: torch.Tensor | None,
                md: int, leaky: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel for d cost / d f2; arguments as
    :func:`corr_bwd_f1`, with f1 in place of f2. Returns df2."""
    df2 = _bwd("corr_bwd_f2", g, f1, out, md, leaky)
    corr_bwd_f2.launches += 1
    return df2


corr_bwd_f2.launches = 0


class CorrelationFunction(torch.autograd.Function):
    """The cost volume with its gradient (``correlation_pallas``'s
    ``custom_vjp``): saves ``(f1, f2, out if leaky else None)``; backward
    rescales the cotangent by the sign of the saved output and returns
    ``(df1, df2)`` in the input dtype. CUDA tensors run the kernels, CPU
    tensors the plain versions."""

    @staticmethod
    def forward(ctx, f1, f2, md, leaky):
        if f1.device.type == "cuda":
            out = corr_fwd(f1, f2, md, leaky)
        else:
            out = correlation_plain(f1, f2, md, leaky)
        ctx.md, ctx.leaky = md, leaky
        ctx.save_for_backward(f1, f2, None if leaky is None else out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        f1, f2, out = ctx.saved_tensors
        md, leaky = ctx.md, ctx.leaky
        g = g.to(f1.dtype)
        if not dense_per_image(g):
            g = g.contiguous()
        if f1.device.type != "cuda":
            df1, df2 = correlation_bwd_plain(g, f1, f2, out, md, leaky)
            return df1, df2, None, None
        df1 = (corr_bwd_f1(g, f2, out, md, leaky)
               if ctx.needs_input_grad[0] else None)
        df2 = (corr_bwd_f2(g, f1, out, md, leaky)
               if ctx.needs_input_grad[1] else None)
        return df1, df2, None, None


def correlation(f1: torch.Tensor, f2: torch.Tensor, md: int,
                leaky: float | None = None) -> torch.Tensor:
    """Cost volume with (2md+1)^2 channels; see the module docstring."""
    if f1.device.type in ("cuda", "cpu"):
        return CorrelationFunction.apply(f1, f2, md, leaky)
    # 'meta' is the parameter-shape pass of nn.collect_shapes
    if f1.device.type == "meta":
        return correlation_plain(f1, f2, md, leaky)
    raise ValueError(f"correlation: no path for device {f1.device}")
