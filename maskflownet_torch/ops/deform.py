"""Flow-guided deformable 3x3 convolution (NCHW, OIHW weight).

Counterpart of ``maskflownet_tpu/ops/deform.py:74-116, 228-280``:

  ``out[n, o, y, x] = bias[o] + sum_{ky,kx in {-1,0,1}} sum_c
        w[o, c, ky+1, kx+1] * bilinear(x_in[n, c], y + dy + ky, x + dx + kx)``

a 3x3 conv whose window is shifted rigidly per output pixel by the flow
(dy, dx); out-of-image bilinear corners contribute zero.

Two exact formulations, as in the JAX package:

* ``warpconv`` (the main path off the card; the JAX package's default on
  the TPU): all
  nine taps share one fractional offset, so the bilinear weights commute
  with the tap sum. One stock 3x3 conv over the input zero-padded by two
  gives the conv on the one-pixel-extended grid [-1, H] x [-1, W], and one
  bilinear gather of that, with zero padding, at ``p + 1 + flow`` is the
  result (the extended border reads the image through the outer taps,
  beyond it every tap is outside).
* ``gather``: the 4x4 integer window around ``floor(p + flow)`` gathered
  once (16 corners), nine bilinear taps, one contraction over 9*Cin. It
  is the plain check of ``warpconv``.

A third method, ``kernel``, is the counterpart of the JAX package's
``pallas`` (``maskflownet_tpu/ops/pallas/deform.py``, ``_fwd_kernel`` and
``_bwd_kernel``): :class:`DeformFunction` runs the hand-written CUDA
kernels of ``csrc/deform.cu`` on a CUDA tensor (``deform_fwd``,
``deform_bwd``) or raises, and ``deform_fwd_plain``/``deform_bwd_plain``
on a CPU tensor; it is the main path on the card. ``auto`` (the default)
resolves to ``kernel`` on a CUDA tensor and ``warpconv`` elsewhere
(:func:`resolve_method`). Both kernels take the sample coordinates ``sy = y
+ dy``, ``sx = x + dx`` (N,H,W) f32 and the weight as ``w9`` (9, Cin,
Cout), its rows padded to ``W9_ALIGN`` elements (:func:`weight_to_w9`), tap
``ky*3 + kx`` major, in the input's dtype; the bias is the caller's.

Its gradient is the floor-based one of ``gather`` and ``warpconv``: at an
integer coordinate the flow gradient is the one-sided difference toward
the next pixel. The Pallas backward takes the slope ``-sign(s - i)`` of
``max(0, 1 - |s - i|)`` there, which is 0 at ``s = i``
(``ops/pallas/deform.py:204, 221``), and so drops the whole flow gradient
at integer flows (ROADMAP queue 3).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from maskflownet_torch import nn
from maskflownet_torch.ops import _build
from maskflownet_torch.ops.warp import _gather, backwarp_coords, base_grid

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_COUT = 256  # the kernels take up to 256 output channels


def _warpconv(x, flow, weight, bias):
    conv = F.conv2d(F.pad(x, (2, 2, 2, 2)), weight.to(x.dtype))
    sy, sx = base_grid(flow, offset=1.0)
    out = backwarp_coords(conv, sy, sx)
    return out if bias is None else out + bias.to(x.dtype)[:, None, None]


def _window(x, sy, sx):
    """The shared 4x4 window of every pixel: ``{(u, v): (N,Cin,H,W)}`` in
    x's dtype, the values at rows ``floor(sy) - 1 + u`` and columns
    ``floor(sx) - 1 + v`` (u, v in 0..3), zero outside the image; and the
    fractions ``fy``/``fx`` (N,1,H,W) f32 with the integer corner
    ``y0``/``x0``."""
    n, cin, h, w = x.shape
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = (sy - y0).unsqueeze(1)
    fx = (sx - x0).unsqueeze(1)
    y0 = y0.long()
    x0 = x0.long()
    win = {}
    for u in range(4):
        for v in range(4):
            yy = y0 + (u - 1)
            xx = x0 + (v - 1)
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            g = _gather(x, yy.clamp(0, h - 1), xx.clamp(0, w - 1))
            win[(u, v)] = torch.where(valid.unsqueeze(1), g, g.new_zeros(()))
    return win, fy, fx, y0, x0


def _taps(win, fy, fx):
    """The nine bilinear taps (ky, kx major) as (N, 9, Cin, H, W): tap
    (a, b) interpolates the window's corners (a..a+1, b..b+1)."""
    taps = []
    for a in range(3):
        for b in range(3):
            r0 = (1 - fx) * win[(a, b)] + fx * win[(a, b + 1)]
            r1 = (1 - fx) * win[(a + 1, b)] + fx * win[(a + 1, b + 1)]
            taps.append((1 - fy) * r0 + fy * r1)
    return torch.stack(taps, 1)


def _gather_deform(x, flow, weight, bias):
    dtype = x.dtype
    sy, sx = base_grid(flow)
    win, fy, fx, _, _ = _window(x, sy, sx)
    stacked = _taps(win, fy.to(dtype), fx.to(dtype))    # (N, 9, Cin, H, W)
    wk = weight.to(dtype).reshape(weight.shape[0], x.shape[1], 9)
    out = torch.einsum("nkchw,ock->nohw", stacked, wk)
    return out if bias is None else out + bias.to(dtype)[:, None, None]


def deform_fwd_plain(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                     w9: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``deform_fwd`` (same arguments): the shared
    4x4 window, nine bilinear taps, one contraction over 9*Cin, all in
    f32, one cast to the input dtype at the end."""
    win, fy, fx, _, _ = _window(x.float(), sy, sx)
    out = torch.einsum("nkchw,kco->nohw", _taps(win, fy, fx), w9.float())
    return out.to(x.dtype)


def deform_bwd_plain(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                     w9: torch.Tensor, g: torch.Tensor,
                     needs=(True, True, True)):
    """Plain PyTorch version of ``deform_bwd`` (same arguments): for the
    cotangent ``g`` (N,Cout,H,W) of ``deform_fwd_plain``, ``(dx, dsy, dsx,
    dw)`` in f32 -- (N,Cin,H,W), (N,H,W), (N,H,W), (9,Cin,Cout) -- with
    None for each gradient that ``needs = (dx, dflow, dweight)`` does not
    ask for. ``dtap = g . w9^T`` feeds dx (scattered to the window's
    corners with the bilinear weights) and the flow (the taps'
    derivatives in the fractions, floor-based); ``dw = taps^T . g``."""
    need_dx, need_flow, need_w = needs
    n, cin, h, w = x.shape
    win, fy, fx, y0, x0 = _window(x.float(), sy, sx)
    gf = g.float()
    dx = dsy = dsx = dw = None
    if need_w:
        dw = torch.einsum("nkchw,nohw->kco", _taps(win, fy, fx), gf)
    if not (need_dx or need_flow):
        return dx, dsy, dsx, dw
    dtap = torch.einsum("nohw,kco->nkchw", gf, w9.float())
    if need_flow:
        dfy = dfx = 0
        for a in range(3):
            for b in range(3):
                d = dtap[:, a * 3 + b]
                dfy = dfy + d * ((1 - fx) * (win[(a + 1, b)] - win[(a, b)])
                                 + fx * (win[(a + 1, b + 1)]
                                         - win[(a, b + 1)]))
                dfx = dfx + d * ((1 - fy) * (win[(a, b + 1)] - win[(a, b)])
                                 + fy * (win[(a + 1, b + 1)]
                                         - win[(a + 1, b)]))
        dsy, dsx = dfy.sum(1), dfx.sum(1)
    if need_dx:
        dx = torch.zeros((n, cin, h * w), device=x.device)
        wy, wx = (1 - fy, fy), (1 - fx, fx)
        for u in range(4):
            for v in range(4):
                s = 0
                for a in (u - 1, u):
                    for b in (v - 1, v):
                        if 0 <= a <= 2 and 0 <= b <= 2:
                            s = s + dtap[:, a * 3 + b] * (wy[u - a]
                                                          * wx[v - b])
                yy = y0 + (u - 1)
                xx = x0 + (v - 1)
                valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(
                    n, 1, -1).expand(n, cin, -1)
                dx.scatter_add_(2, idx, torch.where(
                    valid.unsqueeze(1), s, s.new_zeros(())).reshape(
                        n, cin, -1))
        dx = dx.reshape(n, cin, h, w)
    return dx, dsy, dsx, dw


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("deform")
    lib.mfn_deform_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.mfn_deform_fwd.restype = ctypes.c_int
    lib.mfn_deform_bwd.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.mfn_deform_bwd.restype = ctypes.c_int
    lib.mfn_deform_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.mfn_deform_smem_bytes.restype = ctypes.c_int
    lib.mfn_deform_error_string.argtypes = [ctypes.c_int]
    lib.mfn_deform_error_string.restype = ctypes.c_char_p
    return lib


CHUNK = 16       # input channels a K chunk (csrc/deform.cu: CCH)
TILE = 32        # pixels a forward and data-kernel tile (16 * FWD_MI)
DW_PIXELS = 32   # pixels a dweight tile (DW_BP)
W9_ALIGN = 8     # w9's row pitch, in elements: 16 bytes of bf16
# cap on a dweight call's f32 partial sums: split K no further
DW_PARTIAL_BYTES = 32 * 2 ** 20


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class DeformPlan:
    """The tiling of ``csrc/deform.cu`` for one shape (its design note).

    * forward: blocks of ``TILE`` pixels x ``32 * fwd_ni`` output
      channels, each over ``fwd_cps`` chunks of 16 input channels:
      ``fwd_splits`` K splits (summed by a reduction when > 1);
    * dx/dflow: blocks of one chunk walking ``data_tpg`` tiles of
      ``TILE`` pixels;
    * dweight: blocks of one chunk x ``8 * dw_nwn * (8 // dw_wm)`` output
      channels walking ``dw_tps`` tiles of 32 pixels: ``dw_splits``
      partial sums (reduced when > 1).

    ``*_blocks`` count each kernel's grid, the reduction not included."""

    fwd_ni: int
    fwd_cps: int
    fwd_splits: int
    fwd_blocks: int
    data_tpg: int
    data_blocks: int
    dw_nwn: int
    dw_wm: int
    dw_tps: int
    dw_splits: int
    dw_blocks: int


@functools.lru_cache(maxsize=1024)
def deform_plan(n: int, cin: int, h: int, w: int, cout: int,
                sms: int = 132) -> DeformPlan:
    """The kernels' tiling for x (n, cin, h, w) and cout output channels
    on a card of ``sms`` multiprocessors, as a sweep of the knobs on an
    H100 ranked them at the paths' levels (PERF.md): the forward splits K
    until it launches two blocks a multiprocessor; the data kernel walks
    one tile a block, two when there are more than 16 blocks a
    multiprocessor; dweight sums 3 pixel tiles a split, 8 from 1024 tiles
    on, with at most ``DW_PARTIAL_BYTES`` of partial sums."""
    p = n * h * w
    chunks = _cdiv(cin, CHUNK)
    tiles = _cdiv(p, TILE)
    # forward: all of Cout in one to two column tiles of <= 128
    ni_total = _cdiv(cout, 32)
    col_tiles = _cdiv(ni_total, 4)
    ni = _cdiv(ni_total, col_tiles)
    base = tiles * col_tiles
    cps = max(1, chunks // min(chunks, _cdiv(2 * sms, base)))
    fwd_splits = _cdiv(chunks, cps)
    # dx/dflow
    tpg = 2 if tiles * chunks >= 16 * sms else 1
    # dweight: Cout <= 128 in one column tile (level 6's 196 in two)
    nwn, wm = ((1, 8) if cout <= 8 else (1, 4) if cout <= 16 else
               (1, 2) if cout <= 32 else (1, 1) if cout <= 64 else (2, 1))
    bn = 8 * nwn * (8 // wm)
    dtiles = _cdiv(p, DW_PIXELS)
    most = max(1, min(65535, DW_PARTIAL_BYTES // (9 * cin * cout * 4)))
    tps = min(dtiles, 8 if dtiles >= 1024 else 3)
    tps = max(tps, _cdiv(dtiles, most))
    dw_splits = _cdiv(dtiles, tps)
    return DeformPlan(
        fwd_ni=ni, fwd_cps=cps, fwd_splits=fwd_splits,
        fwd_blocks=base * fwd_splits, data_tpg=tpg,
        data_blocks=_cdiv(tiles, tpg) * chunks, dw_nwn=nwn, dw_wm=wm,
        dw_tps=tps, dw_splits=dw_splits,
        dw_blocks=chunks * _cdiv(cout, bn) * dw_splits)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def w9_pitch(w9: torch.Tensor) -> int | None:
    """The row pitch (elements) of a (9, Cin, Cout) ``w9`` that the kernels
    take as it is -- rows ``pitch`` apart, ``pitch`` >= Cout and a multiple
    of ``W9_ALIGN``, 16-byte aligned -- else None."""
    cin, cout = w9.shape[1], w9.shape[2]
    pitch = w9.stride(1) if cin > 1 else w9.stride(0)
    if (w9.stride(2) == 1 and w9.stride(0) == cin * pitch and pitch >= cout
            and pitch % W9_ALIGN == 0 and w9.data_ptr() % 16 == 0):
        return pitch
    return None


def pad_w9(w9: torch.Tensor) -> torch.Tensor:
    """``w9`` (9, Cin, Cout) as a view of a zero-padded (9, Cin, pitch)
    buffer, pitch = Cout rounded up to ``W9_ALIGN`` (the layout
    :func:`w9_pitch` accepts)."""
    cout = w9.shape[2]
    pitch = _cdiv(cout, W9_ALIGN) * W9_ALIGN
    if pitch == cout:
        return w9.contiguous()
    return F.pad(w9, (0, pitch - cout))[..., :cout]


def _check(name: str, x, sy, sx, w9, g=None) -> None:
    """Raise unless the kernels take these inputs."""
    ts = [t for t in (x, sy, sx, w9, g) if t is not None]
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"{name}: inputs must lie on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if x.dtype not in _DTYPE_CODES or w9.dtype != x.dtype or (
            g is not None and g.dtype != x.dtype) or \
            sy.dtype != torch.float32 or sx.dtype != torch.float32:
        raise TypeError(f"{name}: x, w9 (and g) must share f32 or bf16 and "
                        f"sy/sx be f32, got {[t.dtype for t in ts]}")
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"{name}: x must be non-empty NCHW, got "
                         f"{tuple(x.shape)}")
    n, cin, h, w = x.shape
    if tuple(sy.shape) != (n, h, w) or sx.shape != sy.shape:
        raise ValueError(f"{name}: sy/sx must be {(n, h, w)}, got "
                         f"{tuple(sy.shape)} and {tuple(sx.shape)}")
    if w9.dim() != 3 or tuple(w9.shape[:2]) != (9, cin) or \
            not 1 <= w9.shape[2] <= MAX_COUT:
        raise ValueError(f"{name}: w9 must be (9, {cin}, Cout) with Cout in "
                         f"1..{MAX_COUT}, got {tuple(w9.shape)}")
    if g is not None and tuple(g.shape) != (n, w9.shape[2], h, w):
        raise ValueError(f"{name}: g must be {(n, w9.shape[2], h, w)}, got "
                         f"{tuple(g.shape)}")
    if not all(t.is_contiguous() for t in (x, sy, sx, g) if t is not None):
        raise ValueError(f"{name}: x, sy, sx (and g) must be contiguous")
    if n > 65535 or n * max(_cdiv(cin, CHUNK) * CHUNK,
                            w9.shape[2]) * h * w >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(x.shape)} too large")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: launch failed: "
                           f"{_lib().mfn_deform_error_string(err).decode()}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on(device: torch.device):
    """The device's context, or none when it is current already (entering
    one costs host time on every call)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _nhwc_scratch(x: torch.Tensor) -> torch.Tensor:
    """Room for the kernels' NHWC copy of x: (N, H, W, Cin rounded up to
    ``CHUNK``) in x's dtype, the padding channels written zero there."""
    n, cin, h, w = x.shape
    return torch.empty((n, h, w, _cdiv(cin, CHUNK) * CHUNK), dtype=x.dtype,
                       device=x.device)


def _prepare(name, x, sy, sx, w9, g=None):
    """Checked inputs: w9 in a pitch the kernels take (a padded copy when
    it is not), its pitch, and the plan for the shape on x's card."""
    _check(name, x, sy, sx, w9, g)
    pitch = w9_pitch(w9)
    if pitch is None:
        w9 = pad_w9(w9.clone(memory_format=torch.contiguous_format))
        pitch = w9_pitch(w9)
    n, cin, h, w = x.shape
    return w9, pitch, deform_plan(n, cin, h, w, w9.shape[2],
                                  _sm_count(x.device.index))


def deform_fwd(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
               w9: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA forward kernel on the current stream.

    x (N,Cin,H,W) contiguous and w9 (9,Cin,Cout) (rows may be padded, as
    :func:`weight_to_w9` makes it), both f32 or both bf16; sy/sx (N,H,W)
    contiguous f32 sample coordinates; one CUDA device. Returns
    (N,Cout,H,W) in x's dtype, without a gradient (use
    :class:`DeformFunction`). Raises on any input the kernel does not
    take, and if a launch reports an error."""
    w9, pitch, plan = _prepare("deform_fwd", x, sy, sx, w9)
    n, cin, h, w = x.shape
    cout = w9.shape[2]
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    partial = None
    if plan.fwd_splits > 1:
        partial = torch.empty((plan.fwd_splits, n, cout, h, w),
                              dtype=torch.float32, device=x.device)
    xt = _nhwc_scratch(x)
    with _on(x.device):
        err = _lib().mfn_deform_fwd(
            x.data_ptr(), sy.data_ptr(), sx.data_ptr(), w9.data_ptr(),
            out.data_ptr(), _ptr(partial), xt.data_ptr(), n, cin, h, w,
            cout, pitch,
            _DTYPE_CODES[x.dtype], plan.fwd_ni, plan.fwd_cps,
            torch.cuda.current_stream().cuda_stream)
    _raise_on("deform_fwd", err)
    deform_fwd.launches += 1
    return out


deform_fwd.launches = 0


def deform_bwd(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
               w9: torch.Tensor, g: torch.Tensor,
               needs=(True, True, True)):
    """Launch the CUDA backward kernels on the current stream for the
    gradients that ``needs = (dx, dflow, dweight)`` asks for; arguments and
    results as :func:`deform_bwd_plain` (g in x's dtype). dx and dflow come
    from one kernel, dweight from another, each with a fixed-order
    reduction of its split sums, both reading an NHWC copy of x; nothing is
    launched for a gradient that is not asked for, and one call counts one
    launch."""
    w9, pitch, plan = _prepare("deform_bwd", x, sy, sx, w9, g)
    need_dx, need_flow, need_w = (bool(v) for v in needs)
    n, cin, h, w = x.shape
    cout = w9.shape[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = dxt = xt = dflow = dflow_partial = dw = dw_partial = None
    if need_dx:
        dx = torch.empty((n, cin, h, w), **f32)
        dxt = torch.zeros((n, h, w, _cdiv(cin, CHUNK) * CHUNK), **f32)
    if need_flow or need_w:
        xt = _nhwc_scratch(x)
    if need_flow:
        dflow = torch.empty((2, n, h, w), **f32)
        if cin > CHUNK:
            dflow_partial = torch.empty((_cdiv(cin, CHUNK), 2, n, h, w),
                                        **f32)
    if need_w:
        dw = torch.empty((9, cin, cout), **f32)
        if plan.dw_splits > 1:
            dw_partial = torch.empty((plan.dw_splits, 9, cin, cout), **f32)
    with _on(x.device):
        err = _lib().mfn_deform_bwd(
            x.data_ptr(), sy.data_ptr(), sx.data_ptr(), w9.data_ptr(),
            g.data_ptr(), _ptr(dx), _ptr(dxt), _ptr(dflow),
            _ptr(dflow_partial), _ptr(dw), _ptr(dw_partial), _ptr(xt), n,
            cin, h, w, cout, pitch,
            _DTYPE_CODES[x.dtype], plan.data_tpg, plan.dw_nwn,
            plan.dw_wm, plan.dw_tps, torch.cuda.current_stream().cuda_stream)
    _raise_on("deform_bwd", err)
    deform_bwd.launches += 1
    dsy, dsx = (None, None) if dflow is None else (dflow[0], dflow[1])
    return dx, dsy, dsx, dw


deform_bwd.launches = 0


def weight_to_w9(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW (Cout,Cin,3,3) -> the kernels' (9, Cin, Cout), tap major, in
    ``dtype``: a view of a zero-padded buffer whose rows are Cout rounded
    up to ``W9_ALIGN`` elements apart (:func:`pad_w9`)."""
    cout, cin = weight.shape[:2]
    return pad_w9(weight.to(dtype).permute(2, 3, 1, 0).reshape(9, cin, cout))


class DeformFunction(torch.autograd.Function):
    """The flow-guided deformable conv without bias, with its gradient
    (``deform_conv3x3_pallas``'s ``custom_vjp``): ``apply(x, flow,
    weight)`` with x (N,Cin,H,W), flow (N,2,H,W) (dy, dx), weight OIHW.
    CUDA tensors run ``deform_fwd``/``deform_bwd``, CPU tensors the plain
    pair. The backward asks only for the gradients in
    ``ctx.needs_input_grad`` and launches nothing when none is needed;
    gradients come back in their inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, flow, weight):
        sy, sx = base_grid(flow)
        x = x.contiguous()
        w9 = weight_to_w9(weight, x.dtype)
        if x.device.type == "cuda":
            out = deform_fwd(x, sy, sx, w9)
        else:
            out = deform_fwd_plain(x, sy, sx, w9)
        ctx.save_for_backward(x, sy, sx, w9)
        ctx.dtypes = (flow.dtype, weight.dtype)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        needs = tuple(ctx.needs_input_grad[:3])
        if not any(needs):
            return None, None, None
        x, sy, sx, w9 = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        bwd = deform_bwd if x.device.type == "cuda" else deform_bwd_plain
        dx, dsy, dsx, dw = bwd(x, sy, sx, w9, g, needs)
        flow_dtype, weight_dtype = ctx.dtypes
        if dx is not None:
            dx = dx.to(x.dtype)
        dflow = None if dsy is None else torch.stack([dsy, dsx], 1).to(
            flow_dtype)
        if dw is not None:
            dw = dw.permute(2, 1, 0).reshape(
                w9.shape[2], w9.shape[1], 3, 3).to(weight_dtype)
        return dx, dflow, dw


def _kernel_deform(x, flow, weight, bias):
    if x.device.type in ("cuda", "cpu"):
        out = DeformFunction.apply(x, flow, weight)
    elif x.device.type == "meta":   # the parameter-shape pass
        out = x.new_empty((x.shape[0], weight.shape[0]) + x.shape[2:])
    else:
        raise ValueError(f"deform: no path for device {x.device}")
    return out if bias is None else out + bias.to(out.dtype)[:, None, None]


_METHODS = {"warpconv": _warpconv, "gather": _gather_deform,
            "kernel": _kernel_deform}


def resolve_method(method: str, device: torch.device | str) -> str:
    """``"auto"`` picks the formulation by device, as the JAX package's
    ``"auto"`` picks by backend (``maskflownet_tpu/ops/deform.py:207-218``):
    the CUDA kernels (``"kernel"``) on a CUDA device, ``"warpconv"``
    elsewhere; any other method is returned as it is."""
    if method != "auto":
        return method
    return "kernel" if torch.device(device).type == "cuda" else "warpconv"


def flow_guided_deform_conv3x3(x: torch.Tensor, flow: torch.Tensor,
                               weight: torch.Tensor,
                               bias: torch.Tensor | None = None,
                               method: str = "auto") -> torch.Tensor:
    """x: (N,Cin,H,W); flow: (N,2,H,W) (dy, dx) pixels at this level;
    weight: (Cout,Cin,3,3); bias: (Cout,) or None. -> (N,Cout,H,W)."""
    try:
        fn = _METHODS[resolve_method(method, x.device)]
    except KeyError:
        raise ValueError(f"deform method {method!r}: expected one of "
                         f"{sorted(_METHODS) + ['auto']}") from None
    return fn(x, flow, weight, bias)


def deform_conv(ctx: nn.Ctx, name: str, x: torch.Tensor, flow: torch.Tensor,
                cout: int, *, use_bias: bool = True,
                method: str = "auto") -> torch.Tensor:
    """Parameterized wrapper (kernel 3, stride 1, pad 1, one group). Under
    ``ctx.rows`` (a row-sharded forward) it takes the ``warpconv`` form
    whatever ``method`` says: the same function."""
    wgt = ctx.param(f"{name}/w", (cout, x.shape[1], 3, 3), nn.msra_prelu())
    b = ctx.param(f"{name}/b", (cout,), nn.zeros_init) if use_bias else None
    if ctx.rows is not None:
        return ctx.rows.deform(x, flow, wgt, b)
    return flow_guided_deform_conv3x3(x, flow, wgt, b, method)
