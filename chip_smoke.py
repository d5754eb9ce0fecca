#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each timed on its own line:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA source of the port, one nvcc each, all at once;
  3. kernels: ``corr_fwd`` against ``correlation_plain`` on the card at the
     five MaskFlownet_S level shapes of Sintel's 448x1024 working size,
     batch 4, and ``corr_bwd_f1``/``corr_bwd_f2`` against their plain
     versions at the five level shapes of the FlyingChairs train step
     (batch 8, 320x448); each plus md=2 and an odd shape, f32 and bf16,
     LeakyReLU on and off; then each level's bf16 kernel time (CUDA
     events, warm, median) beside its bound and the plain version's time;
  4. slice: ``Predictor.do_batch`` on 4 Sintel-sized pairs (436x1024) with
     seeded weights at the published widths: f32 with the kernel against
     f32 with the plain correlation, the card against the CPU on a small
     pair, then the main path in bf16 with the kernel launch count, and
     its time per frame;
  5. train: ``Trainer.train_batch`` on a synthetic FlyingChairs-sized batch
     (image 2 is image 1 shifted by a known flow) with the same weights:
     an f32 step on the card against the same step on the CPU, an f32
     step with the kernels against one with the plain correlation (batch
     2, 320x448), then the main path -- bf16, batch 8, 320x448 -- with
     the launch count of each kernel, ms/step, samples/s, peak memory, and
     a loss after 30 steps below the first;
  6. augment: ``affine_sample`` (the sampler of geometric augmentation)
     against ``affine_sample_plain`` at both of the FlyingChairs step's
     launches (batch 8, 384x512 sources sampled at 320x448, coordinates
     from ``draw_geometry`` with the chairs presets) and at an odd shape
     whose coordinates leave the image, f32 and bf16 input; its time
     with the L2 flushed before each call, beside its bound (the source
     pixels the coordinates touch, read once), the plain version's and
     ``F.grid_sample``'s; an
     f32 augmented step on the card against the same step on the CPU with
     the same draws (batch 1, 96x128 -> 64x128); then the main path --
     ``Trainer.train_batch`` with colour and geometry on, bf16, batch 8,
     384x512 -> 320x448 -- with the launch count of every kernel, ms/step,
     samples/s, peak memory and a finite loss, after checking that the
     step draws and augments without waiting for the card.
Then one JSON line describing the kernels, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

import maskflownet_torch.models.maskflownet as model_module
from maskflownet_torch.augment import draw_geometry
from maskflownet_torch.augment.geometry import sample_grids
from maskflownet_torch.config import presets
from maskflownet_torch.inference import Predictor
from maskflownet_torch.models import init_params
from maskflownet_torch.ops import _build
from maskflownet_torch.ops.affine import affine_sample, affine_sample_plain
from maskflownet_torch.ops.correlation import (corr_bwd_f1, corr_bwd_f2,
                                               corr_fwd,
                                               correlation_bwd_f1_plain,
                                               correlation_bwd_f2_plain,
                                               correlation_plain)
from maskflownet_torch.ops.warp import normalized_to_pixels
from maskflownet_torch.training import TrainSettings, Trainer

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,       # f32 outside the tensor cores
              torch.bfloat16: 989e12,     # dense bf16 / f16 tensor cores
              torch.float16: 989e12}
# (level, (N, C, H, W)) of MaskFlownet_S at 448x1024, batch 4
LEVELS = [(2, (4, 32, 112, 256)), (3, (4, 64, 56, 128)), (4, (4, 96, 28, 64)),
          (5, (4, 128, 14, 32)), (6, (4, 196, 7, 16))]
EXTRA_CASES = [(2, (4, 64, 56, 128)), (4, (1, 8, 9, 13)), (2, (1, 8, 9, 13))]
# (level, (N, C, H, W)) of the MaskFlownet_S train step: FlyingChairs crop
# 320x448, batch 8
TRAIN_LEVELS = [(2, (8, 32, 80, 112)), (3, (8, 64, 40, 56)),
                (4, (8, 96, 20, 28)), (5, (8, 128, 10, 14)),
                (6, (8, 196, 5, 7))]
TRAIN_EXTRA = [(2, (8, 64, 40, 56)), (4, (1, 8, 9, 13)), (2, (1, 8, 9, 13))]
# f32: kernel and plain version sum over C in different orders; bf16: the
# kernel's output is one bf16 rounding (<= 2^-8 relative) of the f32 value
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=8e-3, atol=1e-5)}
SLICE_BATCH, SLICE_HW = 4, (436, 1024)
# f32 slice, kernel path vs plain path: both f32 with TF32 off, differing
# only in the correlation's summation order (~1e-7 relative), which the
# following convs carry to the flow far below a thousandth of a pixel
FLOW_TOL_PX = 1e-3
TRAIN_BATCH, TRAIN_HW, TRAIN_LR = 8, (320, 448), 1e-4
# f32 steps, card vs CPU and kernel vs plain: the loss within rtol 1e-5 and
# every parameter's gradient within 1e-3 of its norm (summation order
# only; the same bounds hold the CPU step against JAX in the tests)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
# the augmented FlyingChairs step: sources at the chairs preset's native
# size, crops at TRAIN_HW; the card-vs-CPU check at a small size
AUG_SRC_HW = presets.ORIG_SHAPE["chairs"]
AUG_SMALL_SRC_HW, AUG_SMALL_HW = (96, 128), (64, 128)
# the sampler: f32 weights and sums on both sides, in another order (FMA
# contraction), on values of order 1 to 10 (images, flow * mask)
AFFINE_TOL = dict(rtol=1e-5, atol=1e-5)
# augmented inputs, card vs CPU: images and mask 1e-5; the flow, the
# difference of two pixel coordinates of up to ~127 (f32 ulp 7.6e-6) whose
# sin/cos-derived maps may round differently on the two devices, 1e-4 px
# where the mask is solidly inside
AUG_IMAGE_TOL, AUG_FLOW_TOL_PX = 1e-5, 1e-4
# (name, launcher, plain version, feature the gradient is taken against):
# corr_bwd_f1 reads f2, corr_bwd_f2 reads f1
BWD = [("corr_bwd_f1", corr_bwd_f1, correlation_bwd_f1_plain, 1),
       ("corr_bwd_f2", corr_bwd_f2, correlation_bwd_f2_plain, 0)]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def corr_bound_ms(shape, md: int, dtype: torch.dtype):
    """Least time for one cost volume: each input read once, the output
    written once, against the multiply-adds at the dtype's peak."""
    n, c, h, w = shape
    dd = (2 * md + 1) ** 2
    size = torch.tensor([], dtype=dtype).element_size()
    bytes_ms = (2 * n * c * h * w + n * dd * h * w) * size / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * c * h * w * dd / PEAK_FLOPS[dtype] * 1e3
    return bytes_ms, ops_ms


def bwd_bound_ms(shape, md: int, dtype: torch.dtype, leaky: bool):
    """Least time for one gradient kernel: g (and, with the LeakyReLU, the
    saved output) and one feature map read once, the gradient written
    once, against its multiply-adds at the dtype's peak."""
    n, c, h, w = shape
    dd = (2 * md + 1) ** 2
    size = torch.tensor([], dtype=dtype).element_size()
    maps = (2 if leaky else 1) * n * dd * h * w
    bytes_ms = (maps + 2 * n * c * h * w) * size / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * c * h * w * dd / PEAK_FLOPS[dtype] * 1e3
    return bytes_ms, ops_ms


def check_kernel(gen):
    """corr_fwd vs the plain version on every case; returns the largest f32
    error."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(4, s) for _, s in LEVELS] + EXTRA_CASES
    for md, shape in cases:
        base1 = torch.randn(shape, generator=gen, device="cuda")
        base2 = torch.randn(shape, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            f1, f2 = base1.to(dtype), base2.to(dtype)
            for leaky in (None, 0.1):
                got = corr_fwd(f1, f2, md, leaky)
                torch.cuda.synchronize()
                want = correlation_plain(f1.float(), f2.float(), md, leaky)
                require(got.dtype == dtype and got.shape == want.shape,
                        f"corr_fwd output {got.dtype} {tuple(got.shape)}")
                torch.testing.assert_close(got.float(), want, **TOL[dtype])
                err = (got.float() - want).abs().max().item()
                worst[dtype] = max(worst[dtype], err)
        print(f"corr_fwd check md={md} {shape}: ok", flush=True)
    print(f"corr_fwd max |err|: f32 {worst[torch.float32]:.3e} "
          f"(tol {TOL[torch.float32]}), bf16 {worst[torch.bfloat16]:.3e} "
          f"(tol {TOL[torch.bfloat16]})", flush=True)
    return worst[torch.float32]


def _bwd_inputs(shape, md, dtype, leaky, gen):
    """f1, f2, the cotangent g and the saved output (None without leaky)."""
    n, c, h, w = shape
    f1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    f2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn((n, (2 * md + 1) ** 2, h, w), generator=gen,
                    device="cuda").to(dtype)
    out = None if leaky is None else correlation_plain(f1, f2, md, leaky)
    return (f1, f2), g, out


def check_bwd_kernels(gen):
    """corr_bwd_f1/f2 vs their plain versions at the train step's level
    shapes and the extra cases; returns the largest f32 error of each."""
    worst = {(name, dt): 0.0 for name, *_ in BWD
             for dt in (torch.float32, torch.bfloat16)}
    for md, shape in [(4, s) for _, s in TRAIN_LEVELS] + TRAIN_EXTRA:
        for dtype in (torch.float32, torch.bfloat16):
            for leaky in (None, 0.1):
                feats, g, out = _bwd_inputs(shape, md, dtype, leaky, gen)
                if leaky is not None:
                    require(bool((out < 0).any() and (out > 0).any()),
                            "the saved output holds both signs")
                for name, kernel, plain, which in BWD:
                    got = kernel(g, feats[which], out, md, leaky)
                    torch.cuda.synchronize()
                    want = plain(g.float(), feats[which].float(),
                                 None if out is None else out.float(), md,
                                 leaky)
                    require(got.dtype == dtype and got.shape == want.shape,
                            f"{name} output {got.dtype} {tuple(got.shape)}")
                    torch.testing.assert_close(got.float(), want,
                                               **TOL[dtype])
                    err = (got.float() - want).abs().max().item()
                    worst[(name, dtype)] = max(worst[(name, dtype)], err)
        print(f"corr_bwd_f1/f2 check md={md} {shape}: ok", flush=True)
    for name, *_ in BWD:
        print(f"{name} max |err|: f32 {worst[(name, torch.float32)]:.3e} "
              f"(tol {TOL[torch.float32]}), bf16 "
              f"{worst[(name, torch.bfloat16)]:.3e} "
              f"(tol {TOL[torch.bfloat16]})", flush=True)
    return {name: worst[(name, torch.float32)] for name, *_ in BWD}


def time_bwd_levels(gen):
    """Per-level times of each gradient kernel and its plain version, bf16
    with the LeakyReLU (the train step's case)."""
    totals = {name: dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
              for name, *_ in BWD}
    for lvl, shape in TRAIN_LEVELS:
        feats, g, out = _bwd_inputs(shape, 4, torch.bfloat16, 0.1, gen)
        bytes_ms, ops_ms = bwd_bound_ms(shape, 4, torch.bfloat16, True)
        bound = max(bytes_ms, ops_ms)
        for name, kernel, plain, which in BWD:
            f = feats[which]
            ms = cuda_ms(lambda: kernel(g, f, out, 4, 0.1))
            plain_ms = cuda_ms(lambda: plain(g, f, out, 4, 0.1), reps=11,
                               inner=3)
            print(f"{name} level {lvl} {shape} bf16: kernel {ms:.5f} ms, "
                  f"plain {plain_ms:.5f} ms, bound {bound:.5f} ms "
                  f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
                  f"bytes {bytes_ms:.5f}, ops {ops_ms:.5f}), kernel/bound "
                  f"{ms / bound:.2f}", flush=True)
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                totals[name][key] += v
    return totals


def time_levels(gen, levels=LEVELS):
    """Per-level forward kernel and plain times in bf16 (the main path's
    dtype)."""
    total = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for lvl, shape in levels:
        f1 = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        f2 = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        ms = cuda_ms(lambda: corr_fwd(f1, f2, 4, 0.1))
        plain_ms = cuda_ms(lambda: correlation_plain(f1, f2, 4, 0.1), reps=11,
                           inner=3)
        g1, g2 = f1.float(), f2.float()
        f32_ms = cuda_ms(lambda: corr_fwd(g1, g2, 4, 0.1))
        bytes_ms, ops_ms = corr_bound_ms(shape, 4, torch.bfloat16)
        bound = max(bytes_ms, ops_ms)
        print(f"corr_fwd level {lvl} {shape} bf16: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, bound {bound:.5f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; bytes "
              f"{bytes_ms:.5f}, ops {ops_ms:.5f}), kernel/bound "
              f"{ms / bound:.2f}; f32 kernel {f32_ms:.5f} ms",
              flush=True)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            total[key] += v
    return total


def drive_slice(gen):
    """Returns (launches in one bf16 main-path forward, ms per frame)."""
    params = init_params(0)
    h, w = SLICE_HW
    img1 = torch.rand((SLICE_BATCH, 3, h, w), generator=gen, device="cuda")
    img2 = torch.rand((SLICE_BATCH, 3, h, w), generator=gen, device="cuda")

    def check(outs, what):
        flow, occ, warped = outs
        require(flow.shape == (SLICE_BATCH, 2, h, w), f"{what}: flow shape")
        require(occ.shape == (SLICE_BATCH, 1, h, w), f"{what}: occ shape")
        require(warped.shape == (SLICE_BATCH, 3, h, w),
                f"{what}: warped shape")
        for t in outs:
            require(bool(torch.isfinite(t).all()), f"{what}: non-finite output")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p32 = Predictor(params, device="cuda", dtype=torch.float32)
    corr_fwd.launches = 0
    kern = p32.do_batch(img1, img2)
    torch.cuda.synchronize()
    require(corr_fwd.launches == 5,
            f"{corr_fwd.launches} kernel launches in one forward, not 5")
    with mock.patch.object(model_module, "correlation", correlation_plain):
        plain = p32.do_batch(img1, img2)
    torch.cuda.synchronize()
    require(corr_fwd.launches == 5, "the plain path launched the kernel")
    check(kern, "f32 kernel path")
    check(plain, "f32 plain path")
    dflow = (kern[0] - plain[0]).abs().max().item()
    print(f"slice f32 kernel vs plain correlation: max |dflow| {dflow:.3e} px "
          f"(tol {FLOW_TOL_PX}), |flow| max {kern[0].abs().max().item():.3f} "
          f"px", flush=True)
    require(dflow <= FLOW_TOL_PX, "f32 kernel path vs plain path")

    # the card against the CPU path (the one the tests hold against JAX)
    small1, small2 = img1[:1, :, :64, :96], img2[:1, :, :64, :96]
    card = p32.do_batch(small1, small2)[0].cpu()
    cpu = Predictor(params, device="cpu", dtype=torch.float32).do_batch(
        small1.cpu(), small2.cpu())[0]
    dcpu = (card - cpu).abs().max().item()
    print(f"slice f32 card vs CPU at 64x96: max |dflow| {dcpu:.3e} px "
          f"(tol {FLOW_TOL_PX})", flush=True)
    require(dcpu <= FLOW_TOL_PX, "card vs CPU")
    del p32, kern, plain

    pbf = Predictor(params, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):                             # warm-up
        pbf.do_batch(img1, img2)
    torch.cuda.synchronize()
    corr_fwd.launches = 0
    out = pbf.do_batch(img1, img2)                 # the main path, counted
    torch.cuda.synchronize()
    launches = corr_fwd.launches
    require(launches == 5,
            f"{launches} kernel launches in the main-path forward, not 5")
    check(out, "bf16 main path")
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(20):
        t0 = time.perf_counter()
        pbf.do_batch(img1, img2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_frame = statistics.median(times) / SLICE_BATCH
    print(f"slice bf16 do_batch {SLICE_BATCH}x{h}x{w}: "
          f"{statistics.median(times):.3f} ms/batch (min {min(times):.3f}, "
          f"max {max(times):.3f}), {per_frame:.3f} ms/frame, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches, per_frame


def shifted_batch(gen, b: int, hw, shift=(3, -2)):
    """A FlyingChairs-like batch: smooth random images in [0, 255], image 2
    image 1 moved by the integer flow ``shift`` = (dy, dx), so that
    ``img2(p + shift) = img1(p)``; the label is that flow everywhere, the
    mask all valid. Made on the card from ``gen``."""
    h, w = hw
    m = 8                                           # margin for the shift
    coarse = torch.rand((b, 3, (h + 2 * m) // 8, (w + 2 * m) // 8),
                        generator=gen, device="cuda")
    big = 255 * torch.nn.functional.interpolate(
        coarse, size=(h + 2 * m, w + 2 * m), mode="bilinear",
        align_corners=False)
    img1 = big[:, :, m:m + h, m:m + w].contiguous()
    img2 = big[:, :, m - shift[0]:m - shift[0] + h,
               m - shift[1]:m - shift[1] + w].contiguous()
    flow = torch.tensor(shift, dtype=torch.float32, device="cuda")
    flow = flow[None, :, None, None].expand(b, 2, h, w).contiguous()
    return img1, img2, flow


def step_grads(trainer, batch, draws=None):
    """Loss and every parameter's gradient of one step (no update)."""
    loss, _ = trainer.loss(*batch, draws=draws)
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in trainer.params.items()}
    trainer.opt.zero_grad(set_to_none=True)
    return loss.item(), grads


def compare_steps(what, got, want):
    """Require (loss, grads) ``got`` within LOSS_RTOL / GRAD_RTOL of
    ``want``; print the worst relative gradient error."""
    (lg, gg), (lw, gw) = got, want
    worst = max(((gg[k] - gw[k]).norm() / gw[k].norm()).item() for k in gw
                if gw[k].norm() > 0)
    print(f"train {what}: loss {lg:.7f} vs {lw:.7f} (rel "
          f"{abs(lg - lw) / abs(lw):.3e}, tol {LOSS_RTOL}); worst parameter "
          f"|dgrad|/|grad| {worst:.3e} (tol {GRAD_RTOL})", flush=True)
    require(abs(lg - lw) <= LOSS_RTOL * abs(lw), f"{what}: loss")
    require(worst <= GRAD_RTOL, f"{what}: gradients")


def drive_train(gen):
    """Returns (launches of each kernel in the main-path run, ms/step,
    samples/s)."""
    params = init_params(0)
    f32 = TrainSettings(compute_dtype="float32")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # an f32 step on the card against the same step on the CPU (the path
    # the tests hold against JAX); 64x128, the smallest x64 shape with W
    # and H unequal
    small = shifted_batch(gen, 1, (64, 128))
    card = step_grads(Trainer(f32, device="cuda", params=params), small)
    cpu = step_grads(Trainer(f32, device="cpu", params=params),
                     [t.cpu() for t in small])
    compare_steps("f32 card vs CPU at 64x128", card, cpu)

    # the kernels against the plain correlation, f32, 320x448
    batch = shifted_batch(gen, 2, TRAIN_HW)
    trainer = Trainer(f32, device="cuda", params=params)
    kern = step_grads(trainer, batch)
    counts = [k.launches for k in (corr_fwd, corr_bwd_f1, corr_bwd_f2)]
    with mock.patch.object(model_module, "correlation", correlation_plain):
        plain = step_grads(trainer, batch)
    require([k.launches for k in (corr_fwd, corr_bwd_f1, corr_bwd_f2)]
            == counts, "the plain path launched a kernel")
    compare_steps("f32 kernels vs plain correlation, 2x320x448", kern, plain)
    del trainer, kern, plain

    # the main path: bf16, batch 8, 320x448
    batch = shifted_batch(gen, TRAIN_BATCH, TRAIN_HW)
    trainer = Trainer(TrainSettings(), device="cuda", params=params)
    losses = [trainer.train_batch(*batch, lr=TRAIN_LR, sync=True)["loss"]
              for _ in range(3)]                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = 20
    for k in (corr_fwd, corr_bwd_f1, corr_bwd_f2):
        k.launches = 0
    t0 = time.perf_counter()
    metrics = [trainer.train_batch(*batch, lr=TRAIN_LR)
               for _ in range(timed)]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / timed
    launches = {k.__name__: k.launches
                for k in (corr_fwd, corr_bwd_f1, corr_bwd_f2)}
    print(f"train main path: {timed} steps launched {launches}", flush=True)
    for name, n in launches.items():
        require(n == 5 * timed, f"{name}: {n} launches in {timed} steps, "
                f"not {5 * timed}")
    losses += [m["loss"].item() for m in metrics]
    losses += [trainer.train_batch(*batch, lr=TRAIN_LR, sync=True)["loss"]
               for _ in range(30 - len(losses))]
    require(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    print(f"train bf16 {TRAIN_BATCH}x{TRAIN_HW[0]}x{TRAIN_HW[1]}: "
          f"{ms_step:.3f} ms/step, {TRAIN_BATCH * 1e3 / ms_step:.2f} "
          f"samples/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss step "
          f"1 {losses[0]:.4f}, step 30 {losses[-1]:.4f}", flush=True)
    require(losses[-1] < losses[0], "the loss after 30 steps is not below "
            "the first")
    return launches, ms_step, TRAIN_BATCH * 1e3 / ms_step


def cuda_ms_cold(fn, reps: int = 25) -> float:
    """Median over ``reps`` of one call's time by CUDA events, each call
    after a read of a buffer four times the L2's size, so that the call
    reads its inputs from HBM as it does in the step, not from the L2 that
    a back-to-back launch left them in. A read leaves clean lines, so the
    call pays no write-back of the flush."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0)
    # as many f32 elements as the L2 has bytes: four times its size
    flush = torch.ones(max(l2, 50 * 2 ** 20), dtype=torch.float32,
                       device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def touched_source_pixels(img, sy, sx) -> int:
    """Source pixels of one channel plane, summed over the batch, that the
    bilinear samples at (sy, sx) read: every in-image corner of every
    point, each pixel counted once."""
    n, _, h, w = img.shape
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    base = (torch.arange(n, device=img.device) * (h * w)).view(n, 1, 1)
    hit = torch.zeros(n * h * w, dtype=torch.bool, device=img.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            hit[(base + yy * w + xx)[inside]] = True
    return int(hit.sum().item())


def affine_bound_ms(img, sy, sx):
    """Least time for one sampling: the source pixels this run's
    coordinates touch read once in every channel, both coordinate maps
    read once and the f32 output written once, against ~8 flops a channel
    and 10 a pixel at the f32 peak. Returns (bytes ms, operations ms, the
    touched share of the source)."""
    n, c, h, w = img.shape
    ho, wo = sy.shape[1:]
    pixels = n * ho * wo
    touched = touched_source_pixels(img, sy, sx)
    nbytes = (touched * c * img.element_size() + 2 * pixels * 4
              + pixels * c * 4)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            pixels * (8 * c + 10) / PEAK_FLOPS[torch.float32] * 1e3,
            touched / (n * h * w))


def affine_cases(gen):
    """(name, img, sy, sx) of both sampling launches of one augmented
    FlyingChairs step -- packed img1 + mask + flow*mask (6 channels), then
    img2 (3) -- at coordinates from the chairs presets' own draws, and an
    odd shape whose coordinates leave the image on every side."""
    cfg = presets.geometry_aug_config("chairs", TRAIN_HW, AUG_SRC_HW)
    (g1x, g1y), (g2x, g2y) = sample_grids(
        draw_geometry(gen, TRAIN_BATCH, cfg, "cuda"), cfg)
    h, w = AUG_SRC_HW
    packed = torch.rand((TRAIN_BATCH, 6, h, w), generator=gen, device="cuda")
    packed[:, 4:] = 20 * packed[:, 4:] - 10               # flow * mask
    img2 = torch.rand((TRAIN_BATCH, 3, h, w), generator=gen, device="cuda")
    odd = torch.rand((1, 5, 9, 13), generator=gen, device="cuda")
    sy = torch.rand((1, 7, 11), generator=gen, device="cuda") * 14 - 3
    sx = torch.rand((1, 7, 11), generator=gen, device="cuda") * 19 - 3
    return [("packed", packed, *normalized_to_pixels(g1x, g1y, h, w)),
            ("img2", img2, *normalized_to_pixels(g2x, g2y, h, w)),
            ("odd", odd, sy, sx)]


def check_affine(cases):
    """affine_sample vs affine_sample_plain on every case, f32 and bf16
    input; returns the largest f32 error."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, img, sy, sx in cases:
        out_of_image = ((sy < 0) | (sy > img.shape[2] - 1) | (sx < 0)
                        | (sx > img.shape[3] - 1)).float().mean().item()
        for dtype in (torch.float32, torch.bfloat16):
            x = img.to(dtype)
            got = affine_sample(x, sy, sx)
            torch.cuda.synchronize()
            want = affine_sample_plain(x.float(), sy, sx)
            require(got.dtype == torch.float32 and got.shape == want.shape,
                    f"affine_sample output {got.dtype} {tuple(got.shape)}")
            torch.testing.assert_close(got, want, **AFFINE_TOL)
            worst[dtype] = max(worst[dtype],
                               (got - want).abs().max().item())
        print(f"affine_sample check {name} {tuple(img.shape)} -> "
              f"{tuple(sy.shape[1:])}, {out_of_image:.3f} of the points "
              f"outside the image: ok", flush=True)
    print(f"affine_sample max |err|: f32 {worst[torch.float32]:.3e}, bf16 "
          f"input {worst[torch.bfloat16]:.3e} (tol {AFFINE_TOL})", flush=True)
    return worst[torch.float32]


def time_affine(cases):
    """The two launches of one step: the kernel, its plain version and
    ``F.grid_sample`` (the same function in one PyTorch call, on grids
    normalized beforehand), each with the L2 flushed before the call,
    summed, with the bound; the kernel also back to back, and the host
    time of one call of its wrapper."""
    total = dict(ms=0.0, warm_ms=0.0, host_ms=0.0, plain_ms=0.0,
                 library_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for name, img, sy, sx in cases[:2]:
        h, w = img.shape[2:]
        grid = torch.stack([sx * (2.0 / (w - 1)) - 1,
                            sy * (2.0 / (h - 1)) - 1], -1)

        def library():
            return torch.nn.functional.grid_sample(
                img, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True)

        dlib = (library() - affine_sample(img, sy, sx)).abs().max().item()
        warm_ms = cuda_ms(lambda: affine_sample(img, sy, sx))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):            # well inside the launch queue
            affine_sample(img, sy, sx)
        host_ms = (time.perf_counter() - t0) * 1e3 / 100
        torch.cuda.synchronize()
        ms = cuda_ms_cold(lambda: affine_sample(img, sy, sx))
        plain_ms = cuda_ms_cold(lambda: affine_sample_plain(img, sy, sx),
                                reps=11)
        library_ms = cuda_ms_cold(library)
        bytes_ms, ops_ms, share = affine_bound_ms(img, sy, sx)
        bound = max(bytes_ms, ops_ms)
        print(f"affine_sample {name} {tuple(img.shape)} -> "
              f"{tuple(sy.shape[1:])} f32, L2 flushed before each call: "
              f"kernel {ms:.5f} ms (back to back, L2-warm: {warm_ms:.5f}; "
              f"the wrapper's host time a call {host_ms:.5f}), "
              f"plain {plain_ms:.5f} ms, F.grid_sample {library_ms:.5f} ms "
              f"(max |diff| {dlib:.2e}), bound {bound:.5f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; bytes "
              f"{bytes_ms:.5f} with {share:.3f} of the source touched, ops "
              f"{ops_ms:.5f}), kernel/bound {ms / bound:.2f}", flush=True)
        for key, v in (("ms", ms), ("warm_ms", warm_ms),
                       ("host_ms", host_ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms),
                       ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            total[key] += v
    return total


def drive_augment(gen):
    """Returns (launches of each kernel in the main-path run, ms/step,
    samples/s)."""
    params = init_params(0)
    color = presets.color_aug_config("chairs")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # an f32 augmented step on the card against the same step, with the
    # same draws, on the CPU
    small = TrainSettings(compute_dtype="float32", color=color,
                          geo=presets.geometry_aug_config(
                              "chairs", AUG_SMALL_HW, AUG_SMALL_SRC_HW))
    batch = shifted_batch(gen, 1, AUG_SMALL_SRC_HW)
    card_trainer = Trainer(small, device="cuda", params=params)
    cpu_trainer = Trainer(small, device="cpu", params=params)
    cpu_batch = [t.cpu() for t in batch]
    draws = card_trainer.draw(1, AUG_SMALL_SRC_HW)
    card = [t.cpu() for t in card_trainer.prepare(*batch, draws=draws)]
    cpu = cpu_trainer.prepare(*cpu_batch, draws=draws)
    derr = max((card[i] - cpu[i]).abs().max().item() for i in (0, 1, 3))
    inside = cpu[3][:, 0] > 0.99
    dflow = (card[2] - cpu[2]).abs().amax(1)[inside].max().item()
    print(f"augment f32 card vs CPU at {AUG_SMALL_SRC_HW} -> {AUG_SMALL_HW}: "
          f"images and mask max |diff| {derr:.3e} (tol {AUG_IMAGE_TOL}), "
          f"flow {dflow:.3e} px where the mask > 0.99 (tol "
          f"{AUG_FLOW_TOL_PX}), {inside.float().mean().item():.2f} of the "
          f"pixels", flush=True)
    require(derr <= AUG_IMAGE_TOL, "augmented images card vs CPU")
    require(dflow <= AUG_FLOW_TOL_PX, "augmented flow card vs CPU")
    compare_steps("f32 augmented card vs CPU",
                  step_grads(card_trainer, batch, draws),
                  step_grads(cpu_trainer, cpu_batch, draws))
    del card_trainer, cpu_trainer

    # the main path: chairs presets, bf16, batch 8, 384x512 -> 320x448
    settings = TrainSettings(color=color, geo=presets.geometry_aug_config(
        "chairs", TRAIN_HW, AUG_SRC_HW))
    batch = shifted_batch(gen, TRAIN_BATCH, AUG_SRC_HW)
    trainer = Trainer(settings, device="cuda", params=params)
    losses = [trainer.train_batch(*batch, lr=TRAIN_LR, sync=True)["loss"]
              for _ in range(3)]                    # warm-up
    # the step draws and augments without waiting for the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.prepare(*batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = 20
    kernels = (affine_sample, corr_fwd, corr_bwd_f1, corr_bwd_f2)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    metrics = [trainer.train_batch(*batch, lr=TRAIN_LR)
               for _ in range(timed)]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / timed
    launches = {k.__name__: k.launches for k in kernels}
    print(f"augment main path: {timed} steps launched {launches}", flush=True)
    for name, n in launches.items():
        per_step = 2 if name == "affine_sample" else 5
        require(n == per_step * timed, f"{name}: {n} launches in {timed} "
                f"augmented steps, not {per_step * timed}")
    losses += [m["loss"].item() for m in metrics]
    require(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    print(f"augment bf16 {TRAIN_BATCH}x{AUG_SRC_HW[0]}x{AUG_SRC_HW[1]} -> "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}: {ms_step:.3f} ms/step, "
          f"{TRAIN_BATCH * 1e3 / ms_step:.2f} samples/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss step 1 "
          f"{losses[0]:.4f}, step {len(losses)} {losses[-1]:.4f}", flush=True)
    return launches, ms_step, TRAIN_BATCH * 1e3 / ms_step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"device: {kind}, torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, count {torch.cuda.device_count()}")
        print(smi, flush=True)

    with phase("build"):
        _build.build()
        for name, info in _build.build_log.items():
            print(f"nvcc {name}.cu: {info['seconds']:.2f} s", flush=True)
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    with phase("kernels"):
        max_err = check_kernel(gen)
        timing = time_levels(gen)
        print("corr_fwd at the train step's levels:", flush=True)
        time_levels(gen, TRAIN_LEVELS)
        bwd_err = check_bwd_kernels(gen)
        bwd_timing = time_bwd_levels(gen)

    with phase("slice"):
        infer_launches, per_frame = drive_slice(gen)

    with phase("train"):
        launches, ms_step, samples_s = drive_train(gen)

    with phase("augment"):
        cases = affine_cases(gen)
        affine_err = check_affine(cases)
        affine_timing = time_affine(cases)
        del cases
        aug_launches, aug_ms_step, aug_samples_s = drive_augment(gen)

    def entry(name, source, replaces, timing, err, launched, shapes,
              **extra):
        return {
            "name": name, "route": "cuda",
            "source": f"maskflownet_torch/csrc/{source}.cu",
            "replaces": ", ".join(f"maskflownet_tpu/ops/pallas/"
                                  f"{source}.py:{line}" for line in replaces),
            "launches": launched, "max_abs_err": err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": max(timing["bytes_ms"], timing["ops_ms"]),
            "bound_by": ("bytes" if timing["bytes_ms"] >= timing["ops_ms"]
                         else "operations"),
            "library_ms": timing.get("library_ms"), "shapes": shapes,
            "train_ms_per_step": ms_step,
            "train_samples_per_s": samples_s,
            "aug_train_ms_per_step": aug_ms_step,
            "aug_train_samples_per_s": aug_samples_s, **extra}

    train_shapes = ("sum over the 5 level shapes of one bf16 train step, "
                    "batch 8 at 320x448; launches in 20 steps")
    print(json.dumps({"kernels": [
        entry("corr_fwd", "correlation", (62, 191), timing, max_err,
              launches["corr_fwd"],
              "sum over the 5 level shapes of one bf16 forward, batch 4 at "
              "448x1024; launches in 20 train steps",
              launches_infer_forward=infer_launches,
              launches_aug_train=aug_launches["corr_fwd"],
              slice_ms_per_frame=per_frame),
        entry("corr_bwd_f1", "correlation", (104, 232),
              bwd_timing["corr_bwd_f1"], bwd_err["corr_bwd_f1"],
              launches["corr_bwd_f1"], train_shapes,
              launches_aug_train=aug_launches["corr_bwd_f1"]),
        entry("corr_bwd_f2", "correlation", (127, 253),
              bwd_timing["corr_bwd_f2"], bwd_err["corr_bwd_f2"],
              launches["corr_bwd_f2"], train_shapes,
              launches_aug_train=aug_launches["corr_bwd_f2"]),
        entry("affine_sample", "affine", (52,), affine_timing, affine_err,
              aug_launches["affine_sample"],
              "sum over the 2 launches of one augmented step, f32, batch 8: "
              "(8,6,384,512) and (8,3,384,512) sampled at 320x448; "
              "launches in 20 augmented steps; ms with the L2 flushed "
              "before each call", ms_l2_warm=affine_timing["warm_ms"],
              host_ms_per_call=affine_timing["host_ms"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
