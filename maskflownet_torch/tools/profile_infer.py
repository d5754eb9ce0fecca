"""Where the time of MaskFlownet_S inference goes on the card.

    python -m maskflownet_torch.tools.profile_infer [--out PATH]

Seeded weights at the published widths drive ``Predictor.do_batch`` in
bf16 on 4 Sintel-sized pairs (436x1024), the slice of ``chip_smoke.py``. For
cuDNN autotuning off and on, in turns (off, on, on, off): host time per
batch ended by ``torch.cuda.synchronize()`` (median, min, max of 20), then
one ``torch.profiler`` window of 5 batches giving the device time by kernel
name and category and the device's idle share of the window. Prints a
summary and writes the full table as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from maskflownet_torch.inference import Predictor
from maskflownet_torch.models import init_params

BATCH, HEIGHT, WIDTH = 4, 436, 1024
# kernel-name fragments -> category, first match wins
CATEGORIES = (("corr_fwd_kernel", "correlation (hand kernel)"),
              ("conv", "convolution"), ("cudnn", "convolution"),
              ("xmma", "convolution"), ("gemm", "convolution"),
              ("sm90", "convolution"), ("dgrad", "convolution"),
              ("gather", "gather (warp/deform)"),
              ("index", "gather (warp/deform)"),
              ("cat", "concat/copy"), ("copy", "concat/copy"),
              ("upsample", "resize"), ("interp", "resize"))


def _category(name: str) -> str:
    low = name.lower()
    for frag, cat in CATEGORIES:
        if frag in low:
            return cat
    return "elementwise/other"


def _fmt(v) -> str:
    return "not measured (no device events)" if v is None else f"{v:.3f}"


def _host_ms(pred, img1, img2, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pred.do_batch(img1, img2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _profile(pred, img1, img2, steps):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            pred.do_batch(img1, img2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    intervals = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and \
                evt.time_range.elapsed_us() > 0:
            kernels.append((evt.name, evt.time_range.elapsed_us()))
            intervals.append((evt.time_range.start, evt.time_range.end))
    by_name: dict[str, float] = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
    by_cat: dict[str, float] = {}
    for name, us in by_name.items():
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + us
    # busy time = union of kernel intervals over the device timeline
    busy = 0.0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    span = (max(e for _, e in intervals) - min(s for s, _ in intervals)
            if intervals else 0.0)
    return dict(steps=steps, wall_us=wall_us, device_span_us=span,
                device_busy_us=busy,
                idle_share=1.0 - busy / span if span else None,
                kernels_per_step=len(kernels) / steps,
                by_category_us_per_step={k: v / steps for k, v in sorted(
                    by_cat.items(), key=lambda kv: -kv[1])},
                top_kernels_us_per_step=[
                    (n, us / steps) for n, us in sorted(
                        by_name.items(), key=lambda kv: -kv[1])[:25]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_infer.json")
    args = ap.parse_args(argv)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (BATCH, 3, HEIGHT, WIDTH)
    img1 = torch.rand(shape, generator=gen, device="cuda")
    img2 = torch.rand(shape, generator=gen, device="cuda")
    pred = Predictor(init_params(0), device="cuda", dtype=torch.bfloat16)

    report = dict(card=smi, batch=BATCH, hw=[HEIGHT, WIDTH], dtype="bf16",
                  runs=[])
    for bench in (False, True, True, False):
        torch.backends.cudnn.benchmark = bench
        _host_ms(pred, img1, img2, 3)                        # warm-up
        times = _host_ms(pred, img1, img2, 20)
        prof = _profile(pred, img1, img2, 5)
        run = dict(cudnn_benchmark=bench, host_ms_median=statistics.median(
            times), host_ms_min=min(times), host_ms_max=max(times), **prof)
        report["runs"].append(run)
        print(f"cudnn.benchmark={bench}: {run['host_ms_median']:.3f} ms/batch "
              f"(min {run['host_ms_min']:.3f}, max {run['host_ms_max']:.3f}), "
              f"{run['host_ms_median'] / BATCH:.3f} ms/frame; profiled "
              f"device busy {prof['device_busy_us'] / 5 / 1e3:.3f} ms/batch, "
              f"idle share {_fmt(prof['idle_share'])}, "
              f"{prof['kernels_per_step']:.0f} kernels/batch", flush=True)
        for cat, us in prof["by_category_us_per_step"].items():
            print(f"    {cat:28s} {us / 1e3:8.3f} ms/batch")
        for name, us in prof["top_kernels_us_per_step"][:12]:
            print(f"    {us / 1e3:8.3f} ms  {name[:110]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
