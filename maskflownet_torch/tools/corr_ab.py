"""Time the correlation kernels against an earlier version of
``csrc/correlation.cu`` on one card, in turns, and sweep the tiling plan.

    python3 -m maskflownet_torch.tools.corr_ab --parent DIR/correlation.cu \\
        [--kernels corr_bwd_f1 ...] [--sweep] [--out DIR/corr_ab.json]

``--parent`` names a ``correlation.cu`` of the first design (its C
interface: ``mfn_corr_fwd(f1, f2, out, n, c, h, w, md, dtype, leaky,
use_leaky, stream)`` and ``mfn_corr_bwd_f1/f2(g, out, f, df, n, c, h, w,
md, dtype, leaky, stream)``), for example one unpacked from a parent
commit with ``git show``. It is built here with the port's nvcc flags into
``build/corr_ab/`` and called only by this tool. At every level of the
three main paths (bf16, the LeakyReLU fused), each kernel pair is timed
with the L2 flushed before each call in the order parent, current,
current, parent; the two outputs are held to each other (bf16 tolerance).
``--kernels`` keeps only the named kernels. ``--sweep`` also times the
current kernels under other plans (the warps a block aims for), to rank
``corr_plan``'s knobs. Prints one line a row and writes every row as JSON
to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from maskflownet_torch.ops import _build
from maskflownet_torch.ops import correlation as corr

# (level, (N, C, H, W)) of the main paths: the S step (batch 8, 320x448),
# inference (batch 4, 448x1024) and the cascade step (batch 4, 320x768)
TRAIN = [(2, (8, 32, 80, 112)), (3, (8, 64, 40, 56)), (4, (8, 96, 20, 28)),
         (5, (8, 128, 10, 14)), (6, (8, 196, 5, 7))]
INFER = [(2, (4, 32, 112, 256)), (3, (4, 64, 56, 128)),
         (4, (4, 96, 28, 64)), (5, (4, 128, 14, 32)), (6, (4, 196, 7, 16))]
CASCADE = [(2, (4, 32, 80, 192)), (3, (4, 64, 40, 96)), (4, (4, 96, 20, 48)),
           (5, (4, 128, 10, 24)), (6, (4, 196, 5, 12))]
FWD_PATHS = [("S step", 4, TRAIN), ("inference", 4, INFER),
             ("cascade inference", 2, INFER), ("cascade step", 4, CASCADE),
             ("cascade step", 2, CASCADE)]
BWD_PATHS = [("S step", 4, TRAIN), ("cascade step", 2, CASCADE)]
BF16 = 1  # the libraries' dtype code
TOL = dict(rtol=8e-3, atol=1e-5)


def build_parent(src: Path) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR.parent / "corr_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = out_dir / f"libcorrelation_parent-{digest}.so"
    if not so.exists():
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.mfn_corr_fwd.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    for fn in (lib.mfn_corr_bwd_f1, lib.mfn_corr_bwd_f2):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.mfn_corr_fwd, lib.mfn_corr_bwd_f1, lib.mfn_corr_bwd_f2):
        fn.restype = ctypes.c_int
    return lib


def cold_ms(fn, flush, reps: int = 25) -> float:
    """Median of one call's time by CUDA events, each call after a read of
    ``flush`` (four times the L2) and a sleep of twice the call's host
    time, so the events time the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host_s, 1e-4) * 2 * 2e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.sum()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def parent_call(lib, name, args):
    """A call of the parent library's kernel on bf16 tensors, returning
    the output."""
    stream = torch.cuda.current_stream().cuda_stream
    if name == "corr_fwd":
        f1, f2, md = args
        n, c, h, w = f1.shape
        out = torch.empty((n, (2 * md + 1) ** 2, h, w), dtype=f1.dtype,
                          device=f1.device)
        err = lib.mfn_corr_fwd(f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                               n, c, h, w, md, BF16, 0.1, 1, stream)
    else:
        g, f, out_saved, md = args
        n, c, h, w = f.shape
        out = torch.empty_like(f)
        err = getattr(lib, f"mfn_{name}")(
            g.data_ptr(), out_saved.data_ptr(), f.data_ptr(), out.data_ptr(),
            n, c, h, w, md, BF16, 0.1, stream)
    if err:
        raise RuntimeError(f"parent {name}: launch error {err}")
    return out


KERNELS = ("corr_fwd", "corr_bwd_f1", "corr_bwd_f2")


def rows_for(gen, flush, parent, sweep, kernels=KERNELS):
    rows = []
    jobs = [(k, p) for k, p in [("corr_fwd", p) for p in FWD_PATHS] + [
        (k, p) for p in BWD_PATHS for k in ("corr_bwd_f1", "corr_bwd_f2")]
        if k in kernels]
    for name, (path, md, levels) in jobs:
        for lvl, shape in levels:
            n, c, h, w = shape
            f1, f2 = (torch.randn(shape, generator=gen, device="cuda")
                      .bfloat16() for _ in range(2))
            g = torch.randn((n, (2 * md + 1) ** 2, h, w), generator=gen,
                            device="cuda").bfloat16()
            out = corr.correlation_plain(f1, f2, md, 0.1)
            if name == "corr_fwd":
                args = (f1, f2, md)

                def cur():
                    return corr.corr_fwd(f1, f2, md, 0.1)
            else:
                feat = f2 if name == "corr_bwd_f1" else f1
                args = (g, feat, out, md)
                kernel = getattr(corr, name)

                def cur(kernel=kernel, feat=feat):
                    return kernel(g, feat, out, md, 0.1)
            row = dict(kernel=name, path=path, md=md, level=lvl,
                       shape=list(shape))
            if parent is not None:
                torch.testing.assert_close(
                    cur().float(), parent_call(parent, name, args).float(),
                    **TOL)
                a = cold_ms(lambda: parent_call(parent, name, args), flush)
                b = cold_ms(cur, flush)
                b2 = cold_ms(cur, flush)
                a2 = cold_ms(lambda: parent_call(parent, name, args), flush)
                row.update(parent_ms=(a + a2) / 2, ms=(b + b2) / 2,
                           parent_ms_turns=[a, a2], ms_turns=[b, b2])
            else:
                row["ms"] = cold_ms(cur, flush)
            if sweep:
                row["sweep"] = sweep_plans(name, shape, md, cur, flush)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def sweep_plans(name, shape, md, cur, flush):
    """The current kernel's time under the plans fewer warps a block give
    (corr_plan's FWD_MAX_WARPS, BWD_MAX_WARPS or F1_MAX_WARPS)."""
    knob, values = {"corr_fwd": ("FWD_MAX_WARPS", (4, 6, 8)),
                    "corr_bwd_f2": ("BWD_MAX_WARPS", (2, 4)),
                    "corr_bwd_f1": ("F1_MAX_WARPS", (4, 8))}[name]
    kept = getattr(corr, knob)
    res = {}
    try:
        for v in values:
            setattr(corr, knob, v)
            corr.corr_plan.cache_clear()
            plan = corr.corr_plan(*shape, md, torch.cuda.get_device_properties(
                0).multi_processor_count)
            res[str(v)] = dict(ms=cold_ms(cur, flush), plan=plan._asdict())
    finally:
        setattr(corr, knob, kept)
        corr.corr_plan.cache_clear()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier csrc/correlation.cu to time against")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=KERNELS, help="the kernels to time")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the current kernels under other plans")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("corr_ab: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    parent = build_parent(args.parent) if args.parent else None
    _build.build(("correlation",))
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0)
    flush = torch.ones(max(l2, 50 * 2 ** 20), dtype=torch.float32,
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = rows_for(gen, flush, parent, args.sweep, args.kernels)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "rows": rows},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
