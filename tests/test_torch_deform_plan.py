"""Host-side logic of the deform kernels, on the CPU: the tiling plan that
``ops/deform.py::deform_plan`` hands ``csrc/deform.cu``, the padded ``w9``
layout the kernels read, and the ``"auto"`` method's choice by device.
Nothing here launches a kernel or compiles JAX: the kernels run only on
the card (``chip_smoke.py`` phase "deform").
"""

import pytest
import torch

from maskflownet_torch.models import ModelConfig
from maskflownet_torch.ops import deform as tdeform

SMS = 132
# ((N, Cin, H, W), Cout) of every deformable conv on the paths: the
# MaskFlownet_S step (batch 8, 320x448), inference (batch 4, 448x1024) and
# the cascade step (batch 4, 320x768), levels 6..2, and the checks' odd and
# edge shapes
PATHS = [((8, 128, 10, 14), 128), ((8, 96, 20, 28), 96),
         ((8, 64, 40, 56), 64), ((8, 32, 80, 112), 32)]
PATHS += [((4, c, h, w), c) for c, h, w in
          ((196, 7, 16), (128, 14, 32), (96, 28, 64), (64, 56, 128),
           (32, 112, 256), (196, 5, 12), (128, 10, 24), (96, 20, 48),
           (64, 40, 96), (32, 80, 192))]
EDGES = [((2, 5, 9, 13), 7), ((3, 20, 7, 9), 40), ((2, 24, 6, 11), 150),
         ((1, 1, 1, 1), 1), ((1, 300, 2, 3), 256)]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("shape,cout", PATHS + EDGES,
                         ids=[f"{s}->{c}" for s, c in PATHS + EDGES])
def test_plan_covers_the_work_once(shape, cout):
    """Every grid covers every pixel, channel chunk and output channel, with
    tilings the source instantiates, and no K split or pixel range empty."""
    n, cin, h, w = shape
    p = n * h * w
    chunks = _cdiv(cin, tdeform.CHUNK)
    plan = tdeform.deform_plan(n, cin, h, w, cout, SMS)
    tiles = _cdiv(p, tdeform.TILE)
    # forward: TILE x 32*ni tiles, at most 4 n8 tiles a warp
    assert plan.fwd_ni in (1, 2, 3, 4)
    col_tiles = _cdiv(cout, 32 * plan.fwd_ni)
    assert col_tiles * 32 * plan.fwd_ni >= cout > (col_tiles - 1) * 32 * \
        plan.fwd_ni
    assert plan.fwd_splits == _cdiv(chunks, plan.fwd_cps)
    assert (plan.fwd_splits - 1) * plan.fwd_cps < chunks
    assert plan.fwd_blocks == tiles * col_tiles * plan.fwd_splits
    # dx/dflow: groups of tpg tiles, one chunk a block
    assert 1 <= plan.data_tpg <= max(tiles, 1)
    assert plan.data_blocks == _cdiv(tiles, plan.data_tpg) * chunks
    # dweight: one column tile up to 128 outputs, 2 for level 6's 196
    bn = 8 * plan.dw_nwn * (8 // plan.dw_wm)
    assert (plan.dw_nwn, plan.dw_wm) in ((1, 8), (1, 4), (1, 2), (1, 1),
                                         (2, 1))
    assert bn >= min(cout, 128) and _cdiv(cout, bn) == _cdiv(cout, 128)
    dtiles = _cdiv(p, tdeform.DW_PIXELS)
    assert plan.dw_splits == _cdiv(dtiles, plan.dw_tps)
    assert (plan.dw_splits - 1) * plan.dw_tps < dtiles
    assert plan.dw_splits <= 65535
    assert plan.dw_blocks == chunks * _cdiv(cout, bn) * plan.dw_splits
    if plan.dw_splits > 1:
        assert (plan.dw_splits * 9 * cin * cout * 4
                <= tdeform.DW_PARTIAL_BYTES)


@pytest.mark.parametrize("shape,cout", PATHS,
                         ids=[f"{s}->{c}" for s, c in PATHS])
def test_plan_fills_the_card(shape, cout):
    """On the paths' shapes the forward launches two blocks a
    multiprocessor, or every (tile, column tile, chunk) block there is; the
    data kernel one a (tile, chunk); dweight at least one for every two
    multiprocessors; from 17920 pixels on every kernel two a
    multiprocessor or more."""
    plan = tdeform.deform_plan(*shape, cout, SMS)
    n, cin, h, w = shape
    tiles = _cdiv(n * h * w, tdeform.TILE)
    chunks = _cdiv(cin, tdeform.CHUNK)
    most = tiles * _cdiv(cout, 128) * chunks
    assert plan.fwd_blocks >= min(2 * SMS, most)
    assert plan.data_blocks >= min(2 * SMS, tiles * chunks)
    assert plan.dw_blocks >= SMS // 2
    if n * h * w >= 17920:
        assert min(plan.fwd_blocks, plan.data_blocks, plan.dw_blocks) \
            >= 2 * SMS


def test_plan_follows_the_card():
    """Fewer multiprocessors, fewer K splits and tiles a data block; the
    plan is cached by shape."""
    big = tdeform.deform_plan(8, 128, 10, 14, 128, 132)
    small = tdeform.deform_plan(8, 128, 10, 14, 128, 16)
    assert small.fwd_splits < big.fwd_splits
    assert small.data_tpg >= big.data_tpg
    assert tdeform.deform_plan(8, 128, 10, 14, 128, 132) is big


@pytest.mark.parametrize("cout", [1, 7, 8, 40, 150, 196, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_w9_maps_back_to_oihw(cout, dtype):
    """weight_to_w9 is a (9, Cin, Cout) view of rows padded to a multiple
    of 8 elements with zeros; it maps back to the OIHW weight exactly and
    is a layout the kernels take as it is."""
    cin = 5
    weight = torch.randn(cout, cin, 3, 3, generator=torch.Generator()
                         .manual_seed(cout))
    w9 = tdeform.weight_to_w9(weight, dtype)
    pitch = tdeform.w9_pitch(w9)
    assert w9.shape == (9, cin, cout) and w9.dtype == dtype
    assert pitch == _cdiv(cout, 8) * 8
    back = w9.permute(2, 1, 0).reshape(cout, cin, 3, 3)
    assert torch.equal(back, weight.to(dtype))
    full = w9.as_strided((9, cin, pitch), w9.stride())
    assert not full[..., cout:].any()
    assert torch.equal(w9.contiguous(), weight.to(dtype).permute(
        2, 3, 1, 0).reshape(9, cin, cout))


def test_w9_pitch_rejects_what_the_kernels_cannot_read():
    """A compact w9 whose rows are not 16 bytes apart, or a transposed
    view, has no pitch; pad_w9 makes one that has, with the same values."""
    w9 = torch.randn(9, 3, 7)
    assert tdeform.w9_pitch(w9) is None
    assert tdeform.w9_pitch(torch.randn(9, 3, 16)) == 16
    assert tdeform.w9_pitch(torch.randn(9, 16, 3).transpose(1, 2)) is None
    padded = tdeform.pad_w9(w9)
    assert tdeform.w9_pitch(padded) == 8
    assert torch.equal(padded, w9)


def test_plain_pair_reads_the_padded_w9():
    """The plain pair (the CPU path) gives the same results from the padded
    view as from a compact copy of it."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 5, 6, 7, generator=gen)
    flow = 2 * torch.randn(1, 2, 6, 7, generator=gen)
    sy, sx = tdeform.base_grid(flow)
    w9 = tdeform.weight_to_w9(torch.randn(7, 5, 3, 3, generator=gen),
                              torch.float32)
    g = torch.randn(1, 7, 6, 7, generator=gen)
    compact = w9.contiguous()
    assert torch.equal(tdeform.deform_fwd_plain(x, sy, sx, w9),
                       tdeform.deform_fwd_plain(x, sy, sx, compact))
    for a, b in zip(tdeform.deform_bwd_plain(x, sy, sx, w9, g),
                    tdeform.deform_bwd_plain(x, sy, sx, compact, g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device,want", [("cpu", "warpconv"),
                                         (torch.device("cpu"), "warpconv"),
                                         ("meta", "warpconv"),
                                         ("cuda", "kernel"),
                                         (torch.device("cuda", 0), "kernel")])
def test_auto_resolves_by_device(device, want):
    """"auto", the default, takes the CUDA kernels on a CUDA device and
    warpconv elsewhere (no card needed to decide); a forced method stays."""
    assert ModelConfig().deform == "auto"
    assert tdeform.resolve_method("auto", device) == want
    for method in ("warpconv", "gather", "kernel"):
        assert tdeform.resolve_method(method, device) == method


def test_auto_on_the_cpu_is_warpconv():
    """On a CPU tensor the default method computes exactly what warpconv
    does, so the CPU tests run what they ran before the default changed."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 4, 8, 9, generator=gen)
    flow = 3 * torch.randn(2, 2, 8, 9, generator=gen)
    weight = torch.randn(6, 4, 3, 3, generator=gen)
    bias = torch.randn(6, generator=gen)
    got = tdeform.flow_guided_deform_conv3x3(x, flow, weight, bias)
    want = tdeform.flow_guided_deform_conv3x3(x, flow, weight, bias,
                                              method="warpconv")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="auto"):
        tdeform.flow_guided_deform_conv3x3(x, flow, weight, bias,
                                           method="pallas")
