"""Where a correlation kernel's block spends its time, on one card.

    python3 -m maskflownet_torch.tools.corr_trace

Builds a copy of ``csrc/correlation.cu`` into ``build/corr_trace/`` with
``%globaltimer`` stamps (thread 0 of each block) at its phase boundaries
and the SM each block ran on, launches ``corr_fwd``, ``corr_bwd_f2`` and
``corr_bwd_f1`` at the S step's levels and the cascade step's level 2
(bf16, the LeakyReLU fused, the L2 flushed before the call, the plan
``corr_plan`` gives), and prints for each launch the medians over its
blocks:

* forward: start to chunk 0 landed (block start, staging issue, the
  loads' latency), the products, the band written to shared memory, and
  the epilogue's sums and stores;
* ``corr_bwd_f2``: a whole block, and for each source row but the first
  and last, the copies of the next rows issued, M assembled, the barrier
  after it, and the products with the wait for the next row;
* ``corr_bwd_f1`` (its first warp): a whole block, every copy issued,
  the wait for them and the barrier, f2's window rows laid out from their
  runs (one column tile), then for each dy row M' formed in registers and
  the products, and the stores.

The stamps cost a few instructions a phase; the port never loads this
build. The card's name and power limit head the output.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from maskflownet_torch.ops import _build
from maskflownet_torch.ops import correlation as corr

LEVELS = [(4, (8, 32, 80, 112)), (4, (8, 64, 40, 56)), (4, (8, 96, 20, 28)),
          (4, (8, 128, 10, 14)), (4, (8, 196, 5, 7)), (2, (4, 32, 80, 192))]
SLOTS = 16  # stamps a block

PRELUDE = r"""
__device__ unsigned long long g_trace[1 << 20];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %smid;" : "=r"(s));
  return s;
}
#define TR_AT(i, v)                                                \
  do {                                                             \
    if (threadIdx.x == 0 && blockIdx.x < (1 << 16))                \
      g_trace[blockIdx.x * 16 + (i)] = (v);                        \
  } while (0)
#define TR(i) TR_AT(i, gtime())
"""

# (anchor in the source, text put in its place); each anchor must occur
EDITS = [
    ("namespace {\n\nusing bf16", PRELUDE + "namespace {\n\nusing bf16"),
    # forward: 0 start, 1 chunk 0 landed, 2 products done, 3 band written,
    # 4 stores done, 7 the SM
    ("    corr_fwd_kernel(const FwdArgs p) {\n",
     "    corr_fwd_kernel(const FwdArgs p) {\n  TR(0);\n  TR_AT(7, smid());\n"),
    ("    __syncthreads();  // chunk ch landed; every warp is done with ch - 1"
     "\n",
     "    __syncthreads();  // chunk ch landed; every warp is done with ch - 1"
     "\n    if (ch == 0) TR(1);\n"),
    ("  __syncthreads();  // the band buffer aliases the stages\n",
     "  __syncthreads();  // the band buffer aliases the stages\n  TR(2);\n"),
    ("  const int vpr = TX / p.vo, step = nthr / vpr;\n",
     "  TR(3);\n  const int vpr = TX / p.vo, step = nthr / vpr;\n"),
    ("  if (p.cs > 1) cluster.sync();  // no block leaves while another "
     "reads it\n}",
     "  __syncthreads();\n  TR(4);\n  if (p.cs > 1) cluster.sync();  // no "
     "block leaves while another reads it\n}"),
    # corr_bwd_f2: 0 start, 4 end, 7 the SM, 1 source rows, 2 copies issued,
    # 3 M assembled, 5 barrier after M, 6 products and wait (sums over the
    # middle rows)
    ("    corr_bwd_f2_kernel(const BwdArgs p) {\n",
     "    corr_bwd_f2_kernel(const BwdArgs p) {\n  TR(0);\n"
     "  TR_AT(7, smid());\n  unsigned long long a_issue = 0, a_build = 0, "
     "a_barb = 0, a_mma = 0, tq = 0;\n"),
    ("    __syncthreads();  // row ys landed; every warp is done with ys - 1\n",
     "    __syncthreads();  // row ys landed; every warp is done with ys - 1\n"
     "    const unsigned long long t0 = gtime();\n"
     "    if (i > 0 && i < S - 1) a_mma += t0 - tq;\n"),
    ("    cp_async_commit();\n    // assemble the band of M",
     "    cp_async_commit();\n    const unsigned long long t1 = gtime();\n"
     "    if (i > 0 && i < S - 1) a_issue += t1 - t0;\n"
     "    // assemble the band of M"),
    ("    __syncthreads();\n    const int a = y - ys + MD;\n",
     "    const unsigned long long t2 = gtime();\n"
     "    if (i > 0 && i < S - 1) a_build += t2 - t1;\n    __syncthreads();\n"
     "    tq = gtime();\n    if (i > 0 && i < S - 1) a_barb += tq - t2;\n"
     "    const int a = y - ys + MD;\n"),
    ("  if (!live) return;\n  // each lane",
     "  __syncthreads();\n  TR(4);\n  TR_AT(1, S);\n  TR_AT(2, a_issue);\n"
     "  TR_AT(3, a_build);\n  TR_AT(5, a_barb);\n  TR_AT(6, a_mma);\n"
     "  if (!live) return;\n  // each lane"),
    # corr_bwd_f1 (thread 0, of warp 0): 0 start, 1 every copy issued, 2
    # landed (after the barrier), 3 f2's window rows laid out (one column
    # tile; else as 2), 4 stores done, 5 M' formed and 6 products (sums
    # over its dy rows), 8 its dy rows, 7 the SM
    ("    corr_bwd_f1_kernel(const Bf1Args p) {\n",
     "    corr_bwd_f1_kernel(const Bf1Args p) {\n  TR(0);\n"
     "  TR_AT(7, smid());\n  unsigned long long a_form = 0, a_mma = 0, "
     "tq = 0, n_dy = 0;\n"),
    ("  cp_async_commit();\n  cp_async_wait<0>();\n  __syncthreads();  // "
     "every copy landed\n",
     "  TR(1);\n  cp_async_commit();\n  cp_async_wait<0>();\n"
     "  __syncthreads();  // every copy landed\n  TR(2);\n"),
    ("    __syncthreads();  // the window rows are laid out\n  }\n",
     "    __syncthreads();  // the window rows are laid out\n  }\n  TR(3);\n"),
    ("      // form M' (M+ and M-) for this dy in registers\n",
     "      const unsigned long long tf0 = gtime();\n"
     "      if (tq) a_mma += tf0 - tq;\n      ++n_dy;\n"
     "      // form M' (M+ and M-) for this dy in registers\n"),
    ("      // the products: one k16 step a tile",
     "      tq = gtime();\n      a_form += tq - tf0;\n"
     "      // the products: one k16 step a tile"),
    ("    // each lane's two neighbouring columns in one store where W is even\n"
     "    const float lk",
     "    if (tq) a_mma += gtime() - tq;\n    TR_AT(5, a_form);\n"
     "    TR_AT(6, a_mma);\n    TR_AT(8, n_dy);\n"
     "    // each lane's two neighbouring columns in one store where W is "
     "even\n    const float lk"),
    ("            if (x + 1 < W) o[c * plane + x + 1] = from_f32<T>(v[1]);\n"
     "          }\n        }\n  }\n}\n",
     "            if (x + 1 < W) o[c * plane + x + 1] = from_f32<T>(v[1]);\n"
     "          }\n        }\n    TR(4);\n  }\n}\n"),
]
EXPORT = ('\nextern "C" int mfn_trace_copy(void* dst, long long bytes) {\n'
          '  return (int)cudaMemcpyFromSymbol(dst, g_trace, bytes);\n}\n')


def instrumented_source() -> str:
    src = (_build.CSRC / "correlation.cu").read_text()
    for anchor, text in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"corr_trace: anchor not found once: "
                               f"{anchor!r}")
        src = src.replace(anchor, text)
    return src + EXPORT


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR.parent / "corr_trace"
    out.mkdir(parents=True, exist_ok=True)
    (out / "correlation_trace.cu").write_text(instrumented_source())
    so = out / "libcorrelation_trace.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(out / "correlation_trace.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.mfn_corr_fwd.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for fn in (lib.mfn_corr_bwd_f1, lib.mfn_corr_bwd_f2):
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
    lib.mfn_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return lib


def stamps(lib, blocks: int):
    buf = torch.zeros(blocks * SLOTS, dtype=torch.int64)
    err = lib.mfn_trace_copy(buf.data_ptr(), blocks * SLOTS * 8)
    if err:
        raise RuntimeError(f"corr_trace: copy failed ({err})")
    return buf.view(blocks, SLOTS).tolist()


def med_us(values) -> str:
    return f"{statistics.median(values) / 1e3:.3f}"


def per_sm_peak(rows) -> float:
    """The median over SMs of the most blocks resident at once."""
    peaks = []
    by_sm = {}
    for r in rows:
        by_sm.setdefault(r[7], []).append(r)
    for rs in by_sm.values():
        events = sorted([(r[0], 1) for r in rs] + [(r[4], -1) for r in rs])
        now = peak = 0
        for _, step in events:
            now += step
            peak = max(peak, now)
        peaks.append(peak)
    return statistics.median(peaks)


def main() -> int:
    if not torch.cuda.is_available():
        print("corr_trace: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0)
    flush = torch.ones(max(l2, 50 * 2 ** 20), dtype=torch.float32,
                       device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for md, shape in LEVELS:
        n, c, h, w = shape
        f1, f2 = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for _ in range(2))
        g = torch.randn((n, (2 * md + 1) ** 2, h, w), generator=gen,
                        device="cuda").bfloat16()
        out = corr.correlation_plain(f1, f2, md, 0.1)
        plan = corr.corr_plan(*shape, md, sms)
        stream = torch.cuda.current_stream().cuda_stream
        res = torch.empty_like(out)
        df2 = torch.empty_like(f1)
        df1 = torch.empty_like(f1)
        calls = {
            "corr_fwd": lambda: lib.mfn_corr_fwd(
                f1.data_ptr(), f2.data_ptr(), res.data_ptr(), n, c, h, w, md,
                1, 0.1, 1, plan.fwd_th, plan.fwd_wj, plan.fwd_ndg,
                plan.fwd_kc, stream),
            "corr_bwd_f2": lambda: lib.mfn_corr_bwd_f2(
                g.data_ptr(), out.data_ptr(), f1.data_ptr(), df2.data_ptr(),
                n, c, h, w, md, 1, 0.1, g.stride(0), plan.bwd_th,
                plan.bwd_wj, plan.bwd_cpb, stream),
            "corr_bwd_f1": lambda: lib.mfn_corr_bwd_f1(
                g.data_ptr(), out.data_ptr(), f2.data_ptr(), df1.data_ptr(),
                n, c, h, w, md, 1, 0.1, g.stride(0), plan.f1_th, plan.f1_wj,
                plan.f1_cpb, stream)}
        for name, call in calls.items():
            for _ in range(2):          # the second launch is the one read
                flush.sum()
                torch.cuda._sleep(1_000_000)
                if call():
                    raise RuntimeError(f"corr_trace: {name} launch failed")
                torch.cuda.synchronize()
            blocks = {"corr_fwd": plan.fwd_blocks,
                      "corr_bwd_f2": plan.bwd_blocks,
                      "corr_bwd_f1": plan.f1_blocks}[name]
            rows = stamps(lib, blocks)
            span = max(r[4] for r in rows) - min(r[0] for r in rows)
            whole = med_us([r[4] - r[0] for r in rows])
            head = (f"{name} md={md} {shape}: {blocks} blocks, span "
                    f"{span / 1e3:.2f} us, block {whole} us, at most "
                    f"{per_sm_peak(rows)} blocks an SM at once")
            if name == "corr_fwd":
                print(f"{head}; start to chunk 0 landed "
                      f"{med_us([r[1] - r[0] for r in rows])} us, products "
                      f"{med_us([r[2] - r[1] for r in rows])}, band "
                      f"{med_us([r[3] - r[2] for r in rows])}, epilogue "
                      f"{med_us([r[4] - r[3] for r in rows])}", flush=True)
            elif name == "corr_bwd_f1":
                dys = [max(1, r[8]) for r in rows]
                print(f"{head}; every copy issued "
                      f"{med_us([r[1] - r[0] for r in rows])} us, landed "
                      f"{med_us([r[2] - r[1] for r in rows])} after, f2's "
                      f"windows laid out {med_us([r[3] - r[2] for r in rows])}"
                      f"; a dy row of warp 0 ({statistics.median(dys)} of "
                      f"them): M' formed "
                      f"{med_us([r[5] / k for r, k in zip(rows, dys)])}, "
                      f"products "
                      f"{med_us([r[6] / k for r, k in zip(rows, dys)])}; "
                      "stores "
                      + med_us([r[4] - r[3] - r[5] - r[6] for r in rows]),
                      flush=True)
            else:
                mid = [max(1, r[1] - 2) for r in rows]
                per = [[r[j] / k for r, k in zip(rows, mid)]
                       for j in (2, 3, 5, 6)]
                print(f"{head}; a middle source row: copies issued "
                      f"{med_us(per[0])} us, M assembled {med_us(per[1])}, "
                      f"barrier {med_us(per[2])}, products and wait "
                      f"{med_us(per[3])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
