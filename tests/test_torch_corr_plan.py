"""Host-side logic of the correlation kernels, on the CPU: the tiling plan
that ``ops/correlation.py::corr_plan`` hands ``csrc/correlation.cu`` and
the rule by which a cotangent is passed to the gradient kernels without a
copy. Nothing here launches a kernel or compiles JAX: the kernels run only
on the card (``chip_smoke.py`` phase "kernels").
"""

import itertools

import numpy as np

import pytest
import torch

from maskflownet_torch.ops import correlation as tcorr

SMS = 132
GRID_X_MAX = 2 ** 31 - 1
# (md, (N, C, H, W)) of every cost volume on the main paths: the S step
# (batch 8, 320x448, md=4), inference (batch 4, 448x1024; md=4, and md=2
# for the cascade's stage 2) and the cascade step (batch 4, 320x768; md=4
# and md=2)
TRAIN = [(8, 32, 80, 112), (8, 64, 40, 56), (8, 96, 20, 28),
         (8, 128, 10, 14), (8, 196, 5, 7)]
INFER = [(4, 32, 112, 256), (4, 64, 56, 128), (4, 96, 28, 64),
         (4, 128, 14, 32), (4, 196, 7, 16)]
CASCADE = [(4, 32, 80, 192), (4, 64, 40, 96), (4, 96, 20, 48),
           (4, 128, 10, 24), (4, 196, 5, 12)]
PATHS = ([(4, s) for s in TRAIN + INFER + CASCADE]
         + [(2, s) for s in INFER + CASCADE])
# odd shapes: N = 1, W = 7, 9 and 13, C = 8 and 20, md 1-4
ODD = [(md, (1, c, h, w)) for md, (c, h, w) in zip(
    (1, 2, 3, 4, 4, 1), ((8, 9, 13), (20, 6, 7), (8, 5, 9), (20, 9, 13),
                         (196, 5, 7), (20, 3, 9)))]
# a batch whose N * ceil(C / 8) = 66560 passes the 65535 that a grid's y
# and z dimensions hold
BIG = [(4, (1040, 512, 2, 3))]


def _cdiv(a, b):
    return -(-a // b)


def _exactly_once(ranges, extent):
    cover = [0] * extent
    for lo, hi in ranges:
        assert 0 <= lo < hi <= extent
        for i in range(lo, hi):
            cover[i] += 1
    return cover == [1] * extent


def _fwd_blocks(plan, n, c, h, w, md):
    """Each forward block's (n, rows, columns, dy indices, channels) in
    ``corr_fwd_kernel``'s decoding of blockIdx.x."""
    d = 2 * md + 1
    ng = _cdiv(d, tcorr.FWD_GW)
    tx = 16 * plan.fwd_wj
    ytiles, xtiles = _cdiv(h, plan.fwd_th), _cdiv(w, tx)
    dyblocks = _cdiv(ng, plan.fwd_ndg)
    span = tcorr.FWD_GW * plan.fwd_ndg
    for b in range(n * ytiles * xtiles * dyblocks * plan.fwd_cs):
        rank, b = b % plan.fwd_cs, b // plan.fwd_cs
        dyb, b = b % dyblocks, b // dyblocks
        xt, b = b % xtiles, b // xtiles
        yt, img = b % ytiles, b // ytiles
        yield (img, (yt * plan.fwd_th, min(h, (yt + 1) * plan.fwd_th)),
               (xt * tx, min(w, (xt + 1) * tx)),
               (dyb * span, min(d, (dyb + 1) * span)),
               (rank * plan.fwd_kc, min(c, (rank + 1) * plan.fwd_kc)))


def _bwd_blocks(plan, n, c, h, w, kernel="bwd"):
    """Each corr_bwd_f2 block's (or, kernel "f1", corr_bwd_f1 block's) (n,
    target rows, columns, channels) in the kernel's decoding of
    blockIdx.x."""
    th, wj, cpb = (getattr(plan, f"{kernel}_{k}") for k in ("th", "wj", "cpb"))
    tx = 16 * wj
    shift = tcorr.F1_SHIFT if kernel == "f1" else 0  # columns start at -shift
    ytiles, xtiles = _cdiv(h, th), _cdiv(w + shift, tx)
    cblocks = _cdiv(c, cpb)
    for b in range(n * ytiles * xtiles * cblocks):
        cb, b = b % cblocks, b // cblocks
        xt, b = b % xtiles, b // xtiles
        yt, img = b % ytiles, b // ytiles
        yield (img, (yt * th, min(h, (yt + 1) * th)),
               (max(0, xt * tx - shift), min(w, (xt + 1) * tx - shift)),
               (cb * cpb, min(c, (cb + 1) * cpb)))


@pytest.mark.parametrize("md,shape", PATHS + ODD + BIG,
                         ids=[f"md{m}-{s}" for m, s in PATHS + ODD + BIG])
def test_plan_covers_every_output_once(md, shape):
    """Every (n, dy, y, x, channel) lies in exactly one forward block, and
    every (n, y, x, channel) of df2 and of df1 in exactly one corr_bwd_f2
    and corr_bwd_f1 block: the blocks are the product of one tiling a
    dimension, each a partition, with no empty block."""
    n, c, h, w = shape
    d = 2 * md + 1
    plan = tcorr.corr_plan(n, c, h, w, md, SMS)
    fwd = list(_fwd_blocks(plan, n, c, h, w, md))
    assert len(fwd) == plan.fwd_blocks
    assert len(set(fwd)) == len(fwd)
    dims = list(zip(*fwd))
    assert sorted(set(dims[0])) == list(range(n))
    for extent, ranges in zip((h, w, d, c), dims[1:]):
        assert _exactly_once(sorted(set(ranges)), extent)
    assert set(fwd) == set(itertools.product(*(sorted(set(r))
                                               for r in dims)))
    for kernel in ("bwd", "f1"):
        bwd = list(_bwd_blocks(plan, n, c, h, w, kernel))
        assert len(bwd) == getattr(plan, f"{kernel}_blocks")
        assert len(set(bwd)) == len(bwd)
        dims = list(zip(*bwd))
        assert sorted(set(dims[0])) == list(range(n))
        for extent, ranges in zip((h, w, c), dims[1:]):
            assert _exactly_once(sorted(set(ranges)), extent)
        assert set(bwd) == set(itertools.product(*(sorted(set(r))
                                                   for r in dims)))


@pytest.mark.parametrize("md,shape", PATHS + ODD + BIG,
                         ids=[f"md{m}-{s}" for m, s in PATHS + ODD + BIG])
def test_plan_stays_in_the_limits(md, shape):
    """Grids, clusters, threads and shared memory (f32, the widest) within
    what the kernels and an H100 take; channel ranks in whole k16 steps;
    every grid one-dimensional (gridDim.x), so no batch size meets the
    65535 of the y and z dimensions (BIG)."""
    n, c, h, w = shape
    plan = tcorr.corr_plan(n, c, h, w, md, SMS)
    assert plan.fwd_kc % 16 == 0 and plan.fwd_cs == _cdiv(c, plan.fwd_kc)
    assert 1 <= plan.fwd_cs <= tcorr.MAX_CLUSTER
    assert plan.fwd_blocks % plan.fwd_cs == 0
    assert plan.fwd_threads == 32 * max(
        tcorr.MIN_WARPS, plan.fwd_th * plan.fwd_wj * plan.fwd_ndg)
    assert plan.fwd_wj in (1, 2) and plan.bwd_wj in (1, 2)
    assert plan.fwd_threads <= 32 * tcorr.FWD_MAX_WARPS
    assert plan.fwd_ndg <= _cdiv(2 * md + 1, tcorr.FWD_GW)
    assert plan.bwd_cpb % 16 == 0 and 16 <= plan.bwd_cpb <= 64
    assert plan.bwd_threads == 32 * max(tcorr.MIN_WARPS,
                                        plan.bwd_th * plan.bwd_wj)
    assert plan.bwd_threads <= 32 * tcorr.BWD_MAX_WARPS
    assert plan.f1_wj in (1, 2)
    assert plan.f1_cpb % 16 == 0 and 16 <= plan.f1_cpb <= 64
    assert plan.f1_threads == 32 * max(tcorr.MIN_WARPS,
                                       plan.f1_th * plan.f1_wj)
    assert plan.f1_threads <= 32 * tcorr.F1_MAX_WARPS
    assert 1 <= plan.fwd_blocks <= GRID_X_MAX
    assert 1 <= plan.bwd_blocks <= GRID_X_MAX
    assert 1 <= plan.f1_blocks <= GRID_X_MAX
    for es in (2, 4):
        assert tcorr.fwd_smem_bytes(es, md, plan.fwd_th, plan.fwd_wj,
                                    plan.fwd_ndg, plan.fwd_kc) \
            <= tcorr.MAX_SMEM
        assert tcorr.bwd_smem_bytes(es, md, plan.bwd_th, plan.bwd_wj,
                                    plan.bwd_cpb) <= tcorr.MAX_SMEM
        assert tcorr.bwd_f1_smem_bytes(
            es, md, plan.f1_th, plan.f1_wj, plan.f1_cpb,
            tcorr.f1_runs(w, plan.f1_wj)) <= tcorr.MAX_SMEM
    if tcorr.f1_runs(w, plan.f1_wj):  # g/out and f2 staged as runs
        th, wj = plan.f1_th, plan.f1_wj
        assert tcorr.bwd_f1_run_pitch(
            th * w, (th - 1) * w + 16 * wj - tcorr.F1_SHIFT, h * w) \
            <= tcorr._f1_tap_elems(th, wj)
        assert tcorr.bwd_f1_run_pitch(min(th + 2 * md, h) * w, 0, h * w) \
            <= (th + 2 * md) * 16 * wj + 32


@pytest.mark.parametrize("md,shape", PATHS,
                         ids=[f"md{m}-{s}" for m, s in PATHS])
def test_plan_fills_the_card(md, shape):
    """At every main-path level each kernel launches two blocks a
    multiprocessor, or says it is at its floor -- and then every split is
    taken: a forward block of one row and one dy group over at most 32
    channels or the most ranks a cluster holds; a gradient block of one
    target row over 16 channels. A corr_bwd_f1 block leaves room for a
    second on its multiprocessor (bf16)."""
    n, c, h, w = shape
    plan = tcorr.corr_plan(n, c, h, w, md, SMS)
    assert plan.fwd_floor == (plan.fwd_blocks < 2 * SMS)
    assert plan.bwd_floor == (plan.bwd_blocks < 2 * SMS)
    assert plan.f1_floor == (plan.f1_blocks < 2 * SMS)
    if plan.f1_floor:
        assert plan.f1_th == 1 and plan.f1_cpb == 16
    assert tcorr.bwd_f1_smem_bytes(2, md, plan.f1_th, plan.f1_wj,
                                   plan.f1_cpb, tcorr.f1_runs(w, plan.f1_wj)) \
        <= tcorr.F1_SMEM_AIM
    if plan.fwd_floor:
        assert plan.fwd_th == 1 and plan.fwd_ndg == 1
        assert plan.fwd_kc == 16 or _cdiv(c, plan.fwd_kc - 16) > \
            tcorr.MAX_CLUSTER
    if plan.bwd_floor:
        assert plan.bwd_th == 1 and plan.bwd_cpb == 16


def test_plan_is_at_least_two_blocks_a_multiprocessor_on_the_s_step():
    """The S step's five levels, where the first version launched 8-320
    forward blocks, all launch two or more a multiprocessor now, with each
    of the three kernels."""
    for shape in TRAIN:
        plan = tcorr.corr_plan(*shape, 4, SMS)
        assert plan.fwd_blocks >= 2 * SMS and plan.bwd_blocks >= 2 * SMS
        assert plan.f1_blocks >= 2 * SMS


def test_smem_padding_spreads_ldmatrix_rows_over_the_banks():
    """A padded pitch is a multiple of 8 elements whose 2-byte pitch is an
    odd multiple of 16 bytes, at least the row it pads."""
    for n in range(1, 700):
        p = tcorr._pad_ld(n)
        assert p >= n and p % 8 == 0 and (p * 2 // 16) % 2 == 1


def _cat_slice(n, dd, h, w):
    big = torch.zeros(n, dd + 7, h, w)
    return big, big[:, 3:3 + dd]


@pytest.mark.parametrize("n", [1, 3])
def test_dense_per_image_takes_a_concatenations_channel_slice(n):
    """The cotangent of a cost volume that enters torch.cat is a channel
    slice of the concatenation's gradient: dense per image, the images
    further apart; the kernels take it as it is."""
    big, g = _cat_slice(n, 81, 5, 7)
    assert tcorr.dense_per_image(g)
    assert g.is_contiguous() == (n == 1)
    assert g.stride(0) == big.stride(0)
    assert tcorr.dense_per_image(big)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(2, 81, 5, 7).transpose(2, 3),
    lambda: torch.zeros(2, 81, 5, 14)[..., ::2],
    lambda: torch.zeros(2, 81, 10, 7)[:, :, ::2],
    lambda: torch.zeros(2, 5, 7, 81).permute(0, 3, 1, 2),
    lambda: torch.zeros(1, 81, 5, 7).expand(2, 81, 5, 7),
], ids=["transposed", "strided-w", "strided-h", "nhwc", "expanded"])
def test_dense_per_image_refuses_what_the_kernels_cannot_read(make):
    assert not tcorr.dense_per_image(make())


def test_backward_passes_the_slice_uncopied():
    """CorrelationFunction.backward hands the gradient a dense-per-image
    cotangent as it is (here the CPU's plain gradient, spied), and copies
    one that is not."""
    seen = []
    real = tcorr.correlation_bwd_plain

    def spy(g, *args):
        seen.append(g)
        return real(g, *args)

    rng = torch.Generator().manual_seed(0)
    f1, f2 = (torch.randn(2, 4, 5, 7, generator=rng).requires_grad_()
              for _ in range(2))
    tcorr.correlation_bwd_plain = spy
    try:
        other = torch.zeros(2, 3, 5, 7)
        y = torch.cat([other, tcorr.correlation(f1, f2, 4, 0.1), other], 1)
        gy = torch.randn(y.shape, generator=rng)
        y.backward(gy)
        tcorr.correlation(f1, f2, 4, 0.1).transpose(2, 3).sum().backward()
    finally:
        tcorr.correlation_bwd_plain = real
    assert seen[0].data_ptr() == gy[:, 3:].data_ptr()
    assert seen[0].stride() == gy.stride() and not seen[0].is_contiguous()
    assert seen[1].is_contiguous()


def _model_bwd_f1(g, out, f2, md, leaky, plan, tensor_cores, phase):
    """``corr_bwd_f1_kernel`` written out in torch: every block of ``plan``
    stages its f2 rows and g/out tiles into flat shared-memory arrays at the
    kernel's offsets (g/out as the kernel's 16-byte chunks when one column
    tile spans the image, from a flat memory whose element addresses start
    at ``phase``), then each warp forms, for every dy, the B values each
    lane would hold -- the band M', split into M+ and M- by the saved
    output's sign -- and multiplies (``tensor_cores``), or runs the f32
    path's per-lane sums. Unstaged shared memory and memory outside the
    tensors hold NaN, so a read of either reaches an output. Returns df1 in
    f32."""
    n_img, c, h, w = f2.shape
    d, hw = 2 * md + 1, h * w
    dd = d * d
    th, wj, cpb = plan.f1_th, plan.f1_wj, plan.f1_cpb
    tx = 16 * wj
    ldf = tcorr._pad_ld(tx + tcorr.BWD_PAD)
    shift = tcorr.F1_SHIFT  # the target columns start at x0 - shift
    ytiles, cblocks = _cdiv(h, th), _cdiv(c, cpb)
    xtiles = _cdiv(w + shift, tx)
    runs = xtiles == 1
    vec = 8 if tensor_cores else 4  # elements a 16-byte chunk
    gt = (tcorr.bwd_f1_run_pitch(th * w, (th - 1) * w + tx - shift, hw)
          if runs else tx + 8)
    fct = tcorr.bwd_f1_run_pitch(min(th + 2 * md, h) * w, 0, hw)
    gr = w if runs else dd * (tx + 8)
    xc = 0 if runs else 8  # a tile's column of image column x0
    tap = tcorr._f1_tap_elems(th, wj)
    mt_tiles = 1 if cpb <= 16 else 2 if cpb <= 32 else 4
    nan = float("nan")
    # global memory: a margin of 2 chunks, then the tensor, whose element i
    # lies at address phase + 2 * vec + i (elements)
    mem = {}
    for name, t, stride in (("g", g, g.stride(0)), ("out", out, dd * hw),
                            ("f2", f2, c * hw)):
        if t is not None:
            size = t[0].numel()
            flat = torch.full((2 * vec + n_img * stride + 2 * vec,), nan)
            for i in range(n_img):
                flat[2 * vec + i * stride:][:size] = t[i].reshape(-1)
            mem[name] = (flat, stride)

    def stage_runs(flat, first, stride, units, length, s, pitch):
        """The kernel's stage_runs: returns the runs' offset g0."""
        g0 = vec + (phase + first) % vec
        for u in range(units):
            ga = phase + first + u * stride
            lo = ga - ga % vec
            k = 0
            while lo + k * vec < ga + length:
                dst = g0 + u * pitch - (ga - lo) + k * vec
                assert u * pitch <= dst and dst + vec <= (u + 1) * pitch
                assert dst % vec == 0
                s[dst:dst + vec] = flat[lo - phase + k * vec:][:vec]
                k += 1
            assert k <= (length + 2 * vec - 2) // vec
        return g0

    df1 = torch.full((n_img, c, h, w), nan)
    lane = torch.arange(32)
    for blk in range(n_img * ytiles * xtiles * cblocks):
        cb, b = blk % cblocks, blk // cblocks
        xt, b = b % xtiles, b // xtiles
        yt, n = b % ytiles, b // ytiles
        x0, y0, c_beg = xt * tx, yt * th, cb * cpb
        nc, rows = min(cpb, c - c_beg), min(th, h - y0)
        q_lo, q_hi = max(0, md - y0), min(th + 2 * md, h - y0 + md)
        sf = torch.full(((th + 2 * md) * cpb, ldf), nan)
        if runs:  # f2's rows as runs, then laid out as windows
            flat, stride = mem["f2"]
            sr = torch.full((cpb * ((th + 2 * md) * tx + 32),), nan)
            g0f = stage_runs(flat, 2 * vec + n * stride + c_beg * hw
                             + (y0 - md + q_lo) * w, hw, nc,
                             (q_hi - q_lo) * w, sr, fct)
            for q in range(q_lo, q_hi):
                win = torch.zeros(cpb, ldf)
                idx = (g0f + torch.arange(nc)[:, None] * fct
                       + (q - q_lo) * w + torch.arange(w))
                win[:nc, tcorr.BWD_PAD:tcorr.BWD_PAD + w] = sr[idx]
                sf[q * cpb:(q + 1) * cpb] = win
        else:
            for q in range(q_lo, q_hi):
                ys = y0 - md + q
                # window column col is x = x0 - BWD_PAD + col
                lo = max(0, x0 - tcorr.BWD_PAD)
                hi = min(w, x0 + tx)
                win = torch.zeros(cpb, ldf)
                win[:nc, lo - x0 + tcorr.BWD_PAD:hi - x0 + tcorr.BWD_PAD] = \
                    f2[n, c_beg:c_beg + nc, ys, lo:hi]
                sf[q * cpb:(q + 1) * cpb] = win
        sf = sf.reshape(-1)
        tiles = {}
        for name in ("g", "out"):
            if name not in mem:
                continue
            flat, stride = mem[name]
            s = torch.full((dd * tap,), nan)
            base = 2 * vec + n * stride
            if runs:
                g0 = stage_runs(flat, base + y0 * w, hw, dd, rows * w, s, gt)
            else:  # s[r][t][x] = the tensor's (t, y0 + r, x0 - 8 + x)
                g0 = 0
                view = s[:th * dd * gt].view(th, dd, gt)
                view[:rows, :, :tx + 8] = 0.0
                lo, hi = max(0, x0 - 8), min(w, x0 + tx)
                idx = (base + torch.arange(dd)[None, :, None] * hw
                       + (y0 + torch.arange(rows))[:, None, None] * w
                       + torch.arange(lo, hi))
                view[:rows, :, lo - x0 + 8:hi - x0 + 8] = flat[idx]
            tiles[name] = (s, g0)
        sg, g0g = tiles["g"]
        so, g0o = tiles.get("out", (None, 0))
        for wp in range(th * wj):
            r, j = wp % th, wp // th
            y, xw = y0 + r, x0 - shift + 16 * j  # first target column
            if y >= h or xw >= w:
                continue
            cols = xw + torch.arange(16)  # the tile's target columns
            keep_x = (cols >= 0) & (cols < w)
            if tensor_cores:
                # each lane's 8 values (nt, hh, e): target column xw + 8nt
                # + gq, k = 8hh + 2t4 + e of the nt tile's k16 window
                nt, hh, e = (torch.tensor(v)[:, None] for v in zip(
                    *itertools.product(range(2), range(2), range(2))))
                gq, t4 = lane // 4, lane % 4
                bb = 8 * hh + 2 * t4 + e - gq - (tcorr.BWD_PAD - shift) + md
                live = (bb >= 0) & (bb <= 2 * md)
                col0 = r * gr + xc - shift + 16 * j + gq
                k = (8 * hh + 2 * t4 + e)[live]
                n8 = (8 * nt + gq)[live]  # the target column in the tile
                acc = {}
                for dyi in range(d):
                    if not 0 <= y + dyi - md < h:
                        continue
                    at = (col0 + 8 * nt + (bb + dyi * d) * gt)[live]
                    assert ((g0g + at >= 0) & (g0g + at < dd * tap)).all()
                    gv = sg[g0g + at]
                    neg = (~(so[g0o + at] >= 0) if so is not None
                           else torch.zeros_like(gv, dtype=torch.bool))
                    q = r + dyi
                    rows_f = sf.reshape(-1, ldf)[q * cpb:][:16 * mt_tiles]
                    rows_f = rows_f[:16 * _cdiv(nc, 16)]
                    for tile in range(2):  # one k16 step a tile
                        on = (n8 // 8) == tile
                        for sign, vals in (("p", torch.where(neg, 0.0, gv)),
                                           ("m", torch.where(neg, gv, 0.0))):
                            bmat = torch.zeros(16, 8)
                            bmat[k[on], n8[on] - 8 * tile] = vals[on]
                            a = rows_f[:, 16 * j + 8 * tile:][:, :16]
                            key = (sign, tile)
                            acc[key] = acc.get(key, 0.0) + a @ bmat
                lk = leaky if leaky is not None else 0.0
                res = torch.zeros(16 * _cdiv(nc, 16), 16)
                for tile in range(2):
                    res[:, 8 * tile:8 * tile + 8] = (
                        acc.get(("p", tile), 0.0)
                        + lk * acc.get(("m", tile), 0.0)) * (1.0 / c)
                df1[n, c_beg:c_beg + nc, y, cols[keep_x]] = \
                    res[:nc][:, keep_x]
            else:
                xl, hh = lane % 16, lane // 16
                og = g0g + r * gr + xc - shift + 16 * j + xl
                oo = g0o + r * gr + xc - shift + 16 * j + xl
                acc = torch.zeros(8 * mt_tiles, 32)
                chans = 2 * torch.arange(8 * mt_tiles)[:, None] + hh
                for dyi in range(d):
                    if not 0 <= y + dyi - md < h:
                        continue
                    q = r + dyi
                    for bb in range(d):
                        t = dyi * d + bb
                        gv = sg[og + t * gt]
                        if so is not None:
                            gv = torch.where(so[oo + t * gt] >= 0, gv,
                                             leaky * gv)
                        at = ((q * cpb + chans) * ldf + 16 * j + xl
                              + tcorr.BWD_PAD - shift - md + bb)
                        fv = torch.where(chans < nc,
                                         sf[at.clamp(max=len(sf) - 1)], 0.0)
                        acc += gv * fv
                x = (xw + xl).expand_as(chans)
                keep = (chans < nc) & (x >= 0) & (x < w)
                df1[n, c_beg + chans[keep], y, x[keep]] = acc[keep] / c
    return df1


MODEL_CASES = ODD + [(4, (1, 40, 8, 40)), (2, (2, 24, 10, 28))]


@pytest.mark.parametrize("sms", [SMS, 1], ids=["h100", "one-sm"])
@pytest.mark.parametrize("md,shape", MODEL_CASES,
                         ids=[f"md{m}-{s}" for m, s in MODEL_CASES])
def test_bwd_f1_tiling_model_matches_plain(md, shape, sms):
    """The corr_bwd_f1 kernel's tiling and indexing, written out in torch
    (``_model_bwd_f1``: staging offsets, the runs' 16-byte chunks, each
    lane's band values of M+ and M-, the products), equals
    ``correlation_bwd_f1_plain`` in f32 -- for the tensor-core path and the
    f32 path, with the LeakyReLU fused and without, on a cotangent that is
    a channel slice and at every alignment phase of the runs. ``one-sm``
    plans the largest tiles (no split to fill a card)."""
    n, c, h, w = shape
    d = 2 * md + 1
    rng = np.random.default_rng(sum(shape) + md)
    f1, f2 = (torch.from_numpy(rng.standard_normal(shape, np.float32))
              for _ in range(2))
    big = torch.from_numpy(rng.standard_normal((n, d * d + 3, h, w),
                                               np.float32))
    g = big[:, 1:1 + d * d]
    plan = tcorr.corr_plan(n, c, h, w, md, sms)
    for leaky, tensor_cores, phase in ((0.1, True, 3), (None, True, 0),
                                       (0.1, False, 1), (0.1, True, 6)):
        out = (tcorr.correlation_plain(f1, f2, md, leaky)
               if leaky is not None else None)
        want = tcorr.correlation_bwd_f1_plain(g, f2, out, md, leaky)
        got = _model_bwd_f1(g, out, f2, md, leaky, plan, tensor_cores, phase)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wj", [1, 2])
def test_bwd_f1_band_loads_hit_distinct_banks(wj):
    """By rows, a staged g tile's tap pitch is 16*wj + 8 elements (8 mod
    16): for every load a warp makes to form its B values (each lane's
    value nt, hh, e at tap bb of its own column), the 2-byte elements of
    the lanes on the band fall in distinct 4-byte banks or share a word;
    the lanes off it read their column's first tap of the dy row, which
    costs at most a second way."""
    gt = 16 * wj + 8
    for md, r, j, nt, hh, e in itertools.product(
            range(1, 5), range(2), range(wj), range(2), range(2), range(2)):
        on_band, every = {}, {}
        for gq, t4 in itertools.product(range(8), range(4)):
            bb = 8 * hh + 2 * t4 + e - gq - (tcorr.BWD_PAD - tcorr.F1_SHIFT) \
                + md
            live = 0 <= bb <= 2 * md
            at = (r * 81 * gt + 8 - tcorr.F1_SHIFT + 16 * j + gq + 8 * nt
                  + (64 + (bb if live else 0)) * gt)
            for banks, take in ((on_band, live), (every, True)):
                if take:
                    banks.setdefault((at // 2) % 32, set()).add(at // 2)
        assert max(len(words) for words in on_band.values()) == 1
        assert max(len(words) for words in every.values()) <= 2
