"""Where the time of inference, or of a train step, goes on the card.

    python -m maskflownet_torch.tools.profile_infer [--path infer|train]
        [--aug] [--model MaskFlownet_S|MaskFlownet]
        [--deform auto|warpconv|kernel] [--out PATH]

Seeded weights at the published widths drive, in bf16, either
``Predictor.do_batch`` on 4 Sintel-sized pairs (436x1024; ``--path
infer``, the default) or ``Trainer.train_batch`` on a synthetic batch
(``--path train``): for MaskFlownet_S (the default) the FlyingChairs
batch of 8 at 320x448, for the MaskFlownet cascade the frozen-head step
(``fix_head``) on a batch of 4 at 320x768 -- the paths of
``chip_smoke.py``. ``--deform`` picks the deformable conv's formulation
(``auto``, the default: on the card ``kernel``, the CUDA kernels of
``csrc/deform.cu``; or ``warpconv`` for the A/B). With ``--aug`` the MaskFlownet_S step augments as
the FlyingChairs stage does (the chairs presets' colour and geometry,
from 384x512 sources to 320x448 crops). For cuDNN autotuning off and on, in
turns (off, on, on, off): host time per batch ended by
``torch.cuda.synchronize()`` (median, min, max of 20), then one
``torch.profiler`` window of 5 batches giving the device time by kernel
name and category and the device's idle share of the window. Prints a
summary and writes the full table as JSON to ``--out`` (default
``build/profile_<path>[_aug][_cascade][_kernel].json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from maskflownet_torch.config import (ORIG_SHAPE, color_aug_config,
                                      geometry_aug_config)
from maskflownet_torch.inference import Predictor
from maskflownet_torch.models import ModelConfig, init_params
from maskflownet_torch.training import TrainSettings, Trainer

# (model, path) -> (batch, height, width)
SHAPES = {("MaskFlownet_S", "infer"): (4, 436, 1024),
          ("MaskFlownet_S", "train"): (8, 320, 448),
          ("MaskFlownet", "infer"): (4, 436, 1024),
          ("MaskFlownet", "train"): (4, 320, 768)}
# kernel-name fragments -> category, first match wins
CATEGORIES = (("affine_sample_kernel", "augmentation sampler (hand kernel)"),
              ("deform_", "deformable conv (hand kernels)"),
              ("corr_fwd_kernel", "correlation (hand kernel)"),
              ("corr_bwd_f", "correlation gradients (hand kernels)"),
              ("multi_tensor", "optimizer (Adam)"),
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


def _host_ms(step, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _profile(step, steps):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    intervals = []
    for evt in prof.events():
        # user annotations (e.g. "Optimizer.step#Adam.step") are mirrored
        # onto the device timeline; they are spans, not kernels
        if evt.device_type == torch.autograd.DeviceType.CUDA and \
                evt.time_range.elapsed_us() > 0 and \
                not getattr(evt, "is_user_annotation", False):
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
    ap.add_argument("--path", choices=("infer", "train"), default="infer")
    ap.add_argument("--aug", action="store_true",
                    help="train with the chairs colour and geometry "
                         "augmentation, from 384x512 sources")
    ap.add_argument("--model", choices=("MaskFlownet_S", "MaskFlownet"),
                    default="MaskFlownet_S")
    ap.add_argument("--deform", choices=("auto", "warpconv", "kernel"),
                    default="auto")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.aug and (args.path != "train" or args.model != "MaskFlownet_S"):
        ap.error("--aug needs --path train and --model MaskFlownet_S")
    batch, height, width = SHAPES[(args.model, args.path)]
    cfg = ModelConfig(deform=args.deform)
    params = init_params(0, cfg, args.model)
    src_hw = ORIG_SHAPE["chairs"] if args.aug else (height, width)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (batch, 3) + src_hw
    img1 = torch.rand(shape, generator=gen, device="cuda")
    img2 = torch.rand(shape, generator=gen, device="cuda")
    if args.path == "infer":
        pred = Predictor(params, device="cuda", dtype=torch.bfloat16,
                         cfg=cfg, model=args.model)

        def step():
            pred.do_batch(img1, img2)
    else:
        settings = TrainSettings(model=args.model, model_cfg=cfg,
                                 fix_head=args.model == "MaskFlownet")
        if args.aug:
            settings = dataclasses.replace(
                settings, color=color_aug_config("chairs"),
                geo=geometry_aug_config("chairs", (height, width), src_hw))
        trainer = Trainer(settings, device="cuda", params=params)
        flow = torch.randn((batch, 2) + src_hw, generator=gen,
                           device="cuda")

        def step():
            trainer.train_batch(255 * img1, 255 * img2, flow)

    report = dict(card=smi, path=args.path, aug=args.aug, model=args.model,
                  deform=args.deform, batch=batch,
                  hw=[height, width], source_hw=list(src_hw), dtype="bf16",
                  runs=[])
    for bench in (False, True, True, False):
        torch.backends.cudnn.benchmark = bench
        _host_ms(step, 3)                                    # warm-up
        times = _host_ms(step, 20)
        prof = _profile(step, 5)
        run = dict(cudnn_benchmark=bench, host_ms_median=statistics.median(
            times), host_ms_min=min(times), host_ms_max=max(times), **prof)
        report["runs"].append(run)
        print(f"cudnn.benchmark={bench}: {run['host_ms_median']:.3f} ms/batch "
              f"(min {run['host_ms_min']:.3f}, max {run['host_ms_max']:.3f}), "
              f"{run['host_ms_median'] / batch:.3f} ms/frame; profiled "
              f"device busy {prof['device_busy_us'] / 5 / 1e3:.3f} ms/batch, "
              f"idle share {_fmt(prof['idle_share'])}, "
              f"{prof['kernels_per_step']:.0f} kernels/batch", flush=True)
        for cat, us in prof["by_category_us_per_step"].items():
            print(f"    {cat:28s} {us / 1e3:8.3f} ms/batch")
        for name, us in prof["top_kernels_us_per_step"][:12]:
            print(f"    {us / 1e3:8.3f} ms  {name[:110]}")
    out = Path(args.out or (
        f"build/profile_{args.path}{'_aug' if args.aug else ''}"
        f"{'_cascade' if args.model == 'MaskFlownet' else ''}"
        f"{'_warpconv' if args.deform == 'warpconv' else ''}.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
