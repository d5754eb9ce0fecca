#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each timed on its own line:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA source of the port, one nvcc each, all at once;
  3. kernels: ``corr_fwd`` against ``correlation_plain`` on the card at the
     five MaskFlownet_S level shapes of Sintel's 448x1024 working size,
     batch 4, plus md=2 and an odd shape; f32 and bf16, LeakyReLU on and
     off; then each level's kernel time (CUDA events, warm, median) beside
     its bound and the plain version's time;
  4. slice: ``Predictor.do_batch`` on 4 Sintel-sized pairs (436x1024) with
     seeded weights at the published widths: f32 with the kernel against
     f32 with the plain correlation, the card against the CPU on a small
     pair, then the main path in bf16 with the kernel launch count, and
     its time per frame.
Then one JSON line describing the kernels, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

import maskflownet_torch.models.maskflownet as model_module
from maskflownet_torch.inference import Predictor
from maskflownet_torch.models import init_params
from maskflownet_torch.ops import _build
from maskflownet_torch.ops.correlation import corr_fwd, correlation_plain

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,       # f32 outside the tensor cores
              torch.bfloat16: 989e12,     # dense bf16 / f16 tensor cores
              torch.float16: 989e12}
# (level, (N, C, H, W)) of MaskFlownet_S at 448x1024, batch 4
LEVELS = [(2, (4, 32, 112, 256)), (3, (4, 64, 56, 128)), (4, (4, 96, 28, 64)),
          (5, (4, 128, 14, 32)), (6, (4, 196, 7, 16))]
EXTRA_CASES = [(2, (4, 64, 56, 128)), (4, (1, 8, 9, 13)), (2, (1, 8, 9, 13))]
# f32: kernel and plain version sum over C in different orders; bf16: the
# kernel's output is one bf16 rounding (<= 2^-8 relative) of the f32 value
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=8e-3, atol=1e-5)}
SLICE_BATCH, SLICE_HW = 4, (436, 1024)
# f32 slice, kernel path vs plain path: both f32 with TF32 off, differing
# only in the correlation's summation order (~1e-7 relative), which the
# following convs carry to the flow far below a thousandth of a pixel
FLOW_TOL_PX = 1e-3


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


def time_levels(gen):
    """Per-level kernel and plain times in bf16 (the main path's dtype)."""
    total = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for lvl, shape in LEVELS:
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

    with phase("slice"):
        launches, per_frame = drive_slice(gen)

    bound_ms = max(timing["bytes_ms"], timing["ops_ms"])
    print(json.dumps({"kernels": [{
        "name": "corr_fwd", "route": "cuda",
        "source": "maskflownet_torch/csrc/correlation.cu",
        "replaces": "maskflownet_tpu/ops/pallas/correlation.py:62, "
                    "maskflownet_tpu/ops/pallas/correlation.py:191",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if timing["bytes_ms"] >= timing["ops_ms"]
                     else "operations"),
        "library_ms": None,
        "shapes": "sum over the 5 level shapes of one bf16 forward, batch 4 "
                  "at 448x1024",
        "slice_ms_per_frame": per_frame}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
