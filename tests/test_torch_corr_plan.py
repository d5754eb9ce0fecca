"""Host-side logic of the correlation kernels, on the CPU: the tiling plan
that ``ops/correlation.py::corr_plan`` hands ``csrc/correlation.cu`` and
the rule by which a cotangent is passed to the gradient kernels without a
copy. Nothing here launches a kernel or compiles JAX: the kernels run only
on the card (``chip_smoke.py`` phase "kernels").
"""

import itertools

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


def _bwd_blocks(plan, n, c, h, w):
    """Each corr_bwd_f2 block's (n, target rows, columns, channels)."""
    tx = 16 * plan.bwd_wj
    ytiles, xtiles = _cdiv(h, plan.bwd_th), _cdiv(w, tx)
    cblocks = _cdiv(c, plan.bwd_cpb)
    for b in range(n * ytiles * xtiles * cblocks):
        cb, b = b % cblocks, b // cblocks
        xt, b = b % xtiles, b // xtiles
        yt, img = b % ytiles, b // ytiles
        yield (img, (yt * plan.bwd_th, min(h, (yt + 1) * plan.bwd_th)),
               (xt * tx, min(w, (xt + 1) * tx)),
               (cb * plan.bwd_cpb, min(c, (cb + 1) * plan.bwd_cpb)))


@pytest.mark.parametrize("md,shape", PATHS + ODD,
                         ids=[f"md{m}-{s}" for m, s in PATHS + ODD])
def test_plan_covers_every_output_once(md, shape):
    """Every (n, dy, y, x, channel) lies in exactly one forward block, and
    every (n, y, x, channel) of df2 in exactly one corr_bwd_f2 block: the
    blocks are the product of one tiling a dimension, each a partition,
    with no empty block."""
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
    bwd = list(_bwd_blocks(plan, n, c, h, w))
    assert len(bwd) == plan.bwd_blocks
    assert len(set(bwd)) == len(bwd)
    dims = list(zip(*bwd))
    assert sorted(set(dims[0])) == list(range(n))
    for extent, ranges in zip((h, w, c), dims[1:]):
        assert _exactly_once(sorted(set(ranges)), extent)
    assert set(bwd) == set(itertools.product(*(sorted(set(r))
                                               for r in dims)))


@pytest.mark.parametrize("md,shape", PATHS + ODD,
                         ids=[f"md{m}-{s}" for m, s in PATHS + ODD])
def test_plan_stays_in_the_limits(md, shape):
    """Grids, clusters, threads and shared memory (f32, the widest) within
    what the kernels and an H100 take; channel ranks in whole k16 steps."""
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
    assert 1 <= plan.fwd_blocks <= GRID_X_MAX
    assert 1 <= plan.bwd_blocks <= GRID_X_MAX
    for es in (2, 4):
        assert tcorr.fwd_smem_bytes(es, md, plan.fwd_th, plan.fwd_wj,
                                    plan.fwd_ndg, plan.fwd_kc) \
            <= tcorr.MAX_SMEM
        assert tcorr.bwd_smem_bytes(es, md, plan.bwd_th, plan.bwd_wj,
                                    plan.bwd_cpb) <= tcorr.MAX_SMEM


@pytest.mark.parametrize("md,shape", PATHS,
                         ids=[f"md{m}-{s}" for m, s in PATHS])
def test_plan_fills_the_card(md, shape):
    """At every main-path level each kernel launches two blocks a
    multiprocessor, or says it is at its floor -- and then every split is
    taken: a forward block of one row and one dy group over at most 32
    channels or the most ranks a cluster holds; a corr_bwd_f2 block of one
    target row over 16 channels."""
    n, c, h, w = shape
    plan = tcorr.corr_plan(n, c, h, w, md, SMS)
    assert plan.fwd_floor == (plan.fwd_blocks < 2 * SMS)
    assert plan.bwd_floor == (plan.bwd_blocks < 2 * SMS)
    if plan.fwd_floor:
        assert plan.fwd_th == 1 and plan.fwd_ndg == 1
        assert plan.fwd_kc == 16 or _cdiv(c, plan.fwd_kc - 16) > \
            tcorr.MAX_CLUSTER
    if plan.bwd_floor:
        assert plan.bwd_th == 1 and plan.bwd_cpb == 16


def test_plan_is_at_least_two_blocks_a_multiprocessor_on_the_s_step():
    """The S step's five levels, where the first version launched 8-320
    forward blocks, all launch two or more a multiprocessor now."""
    for shape in TRAIN:
        plan = tcorr.corr_plan(*shape, 4, SMS)
        assert plan.fwd_blocks >= 2 * SMS and plan.bwd_blocks >= 2 * SMS


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
