// FlowNet-C correlation cost volume -- the Hopper (sm_90a) kernels of
// maskflownet_torch: the forward with the fused LeakyReLU epilogue
// (corr_fwd_kernel) and the two gradients (corr_bwd_f1_kernel,
// corr_bwd_f2_kernel, further below).
//
//   out[n, (dy+md)(2md+1) + (dx+md), y, x]
//       = act(1/C * sum_c f1[n, c, y, x] * f2[n, c, y+dy, x+dx])
//
// for dy, dx in [-md, md], f2 zero outside the image, NCHW f1/f2 in f32,
// bf16 or f16, output (N, D*D, H, W) in the input dtype. act is
// LeakyReLU(leaky) applied to the f32 sum before the single cast-and-store,
// or the identity.
//
// corr_fwd_kernel replaces both TPU forward kernels of
// maskflownet_tpu/ops/pallas/correlation.py: _corr_fwd_kernel :62 (NHWC, C
// on the lanes) and _hm_fwd_kernel :191 (H-major, W on the lanes). They
// compute this one function in two layouts; the split exists for the TPU's
// (8, 128) lane tiling (maskflownet_tpu/ops/correlation.py:51-60) and has
// no reason on Hopper.
//
// What bounds it on an H100: on paper bytes, 2*C inputs and D*D = 81
// outputs a pixel (md = 4) against 2*C*81 flops; the cost volume is the
// largest activation of the network. In practice the level shapes are small
// (C = 32..196, 35 to 28672 pixels an image) and a block's chain of load,
// barrier, products and epilogue is short work behind long latencies, so
// what bounds a call is how many blocks a multiprocessor keeps in flight
// and the instructions a block spends staging and storing (PERF.md §6).
// The first version launched 8-320 blocks on 132 SMs and did one
// shared-memory load per FMA. What this design does:
//   * a band GEMM on the tensor cores. For one output row y, a tile of 16
//     columns x0.. and one displacement row dy, A = f1[y, x0:x0+16, c] (16 x
//     C) times B = f2[y+dy, x0-4 : x0+20, c]^T (C x 24, three n8 tiles) with
//     mma.sync m16n8k16 (bf16 or f16 in, f32 accumulate); the outputs are
//     the band acc[x, x + 4 - md + dx], dx in [0, 2md], 9 of every 24
//     columns at md = 4. bf16 x bf16 products are exact in f32, so the
//     result is the f32 sum in another order, rounded once; so for f16.
//     The window starts at x0 - 4 for every md, so that its copies are
//     8-byte aligned whenever W % 4 == 0 (a 16-byte copy would need a
//     fourth n8 tile, and ldmatrix needs the window's first column on a
//     16-byte boundary).
//   * f1's tile and f2's halo are staged from NCHW as they lie (pixels
//     contiguous) by cp.async -- 16 or 8 bytes where the addresses allow,
//     narrower down to one element where W is odd -- double buffered over
//     chunks of 32 channels, and read by ldmatrix.trans: no NHWC copy.
//     Channel rows are padded to an odd multiple of 16 bytes, so the eight
//     rows of an ldmatrix hit distinct banks.
//   * a warp owns one (output row, 16-column tile, group of 3 dy rows) of
//     its block: one A fragment serves three dy rows, and 36 f32
//     accumulators stay in registers over the whole channel loop. A block
//     covers th output rows, 16*wj columns and ndg groups (up to all of
//     them; at least 4 warps, the extra ones only stage and store), so f2's
//     rows are staged once for th + 3*ndg - 1 rows instead of once a row
//     and dy. Three blocks a multiprocessor (80 registers).
//   * the grid fills the card at every level: corr_plan (ops/correlation.py)
//     splits the dy groups across blocks and the channels across the blocks
//     of one thread-block cluster (up to 8) until a level launches two
//     blocks a multiprocessor. The ranks of a cluster leave their band
//     partials in shared memory; after a cluster barrier each rank sums
//     every rank's partial of its share of the outputs through distributed
//     shared memory in rank order (deterministic), applies 1/C and the
//     activation to the f32 sum and stores once: one launch, no scratch.
//   * the epilogue passes the band through shared memory (rows padded so a
//     warp's scatter hits 32 banks), so the stores go to one displacement
//     plane at a time, up to 16 bytes a thread, coalesced along W. The
//     large dimension of the grid is on gridDim.x: no batch limit.
// f32 inputs keep the same tiles and fragment layout, with the products as
// CUDA-core FMAs (fma_16x8x16): exact f32, run by the checks only.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// ---------------------------------------------------------------------------
// PTX: ldmatrix, mma.sync, cp.async

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// c (the lane's four f32 of a 16x8 tile) += A (16x16) . B (16x8).
template <typename T>
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<bf16>(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float c[4], const uint32_t a[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One copy of `bytes` (4, 8 or 16) from global to shared memory; zeros
// where !valid (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes, bool valid) {
  const int src = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(smem)),
                 "l"(gmem), "r"(src)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_u32(smem)),
                 "l"(gmem), "r"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(smem)),
                 "l"(gmem), "r"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x / d for 0 <= x < 2^32 / d by one multiply-high (m = ceil(2^32 / d),
// which needs d > 1; d = 1 returns x), the magic number made on the host:
// the tiling's runtime divisors in the staging and epilogue loops.
struct FastDiv {
  uint32_t m;
  int one;
  __device__ __forceinline__ int div(int x) const {
    return one ? x : (int)__umulhi((uint32_t)x, m);
  }
};

inline FastDiv fast_div(int d) {
  FastDiv f;
  f.m = d > 1 ? (uint32_t)((0x100000000ull + d - 1) / d) : 0u;
  f.one = d == 1;
  return f;
}

// A thread's share of staging rows of `cols` elements (cols % v == 0) into
// shared memory, v elements a copy, worked out once a block: the vector
// column (t % (cols / v)) * v and the rows t / (cols / v), t / (cols / v) +
// step, ... with step = blockDim.x / (cols / v); gx0 is the global x of
// column 0, and cok whether this thread's column lies in [0, W).
struct StageMap {
  int col, rho0, step, bytes;
  bool on, cok;
};

template <typename T>
__device__ __forceinline__ StageMap stage_map(int cols, int v, int gx0,
                                              int W) {
  StageMap m;
  const int vpr = cols / v, t = threadIdx.x;
  m.step = blockDim.x / vpr;
  m.on = t < m.step * vpr;
  m.col = (t % vpr) * v;
  m.rho0 = t / vpr;
  m.cok = gx0 + m.col >= 0 && gx0 + m.col < W;
  m.bytes = v * (int)sizeof(T);
  return m;
}

// Stage `rows` rows by the map: row(rho, src, dst) gives row rho's global
// start at column 0 (nullptr: a zero row) and its shared start (nullptr:
// leave the row). Copies of 4 bytes or more go by cp.async (zero-filled
// outside the image); single 2-byte elements (odd W) by plain loads, eight
// in flight a thread, then plain stores.
template <typename T, typename Row>
__device__ __forceinline__ void stage_rows(const StageMap& m, int rows,
                                           const T* any, Row row) {
  if (!m.on) return;
  if (m.bytes >= 4) {
    for (int rho = m.rho0; rho < rows; rho += m.step) {
      const T* src;
      T* dst;
      row(rho, src, dst);
      if (dst == nullptr) continue;
      const bool ok = m.cok && src != nullptr;
      cp_async(dst + m.col, ok ? src + m.col : any, m.bytes, ok);
    }
  } else {
    constexpr int B = 8;
    for (int rho0 = m.rho0; rho0 < rows; rho0 += B * m.step) {
      T val[B];
      T* out[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int rho = rho0 + u * m.step;
        out[u] = nullptr;
        val[u] = from_f32<T>(0.f);
        if (rho < rows) {
          const T* src;
          T* dst;
          row(rho, src, dst);
          if (dst != nullptr) {
            out[u] = dst + m.col;
            if (m.cok && src != nullptr) val[u] = src[m.col];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (out[u] != nullptr) *out[u] = val[u];
    }
  }
}

__device__ __forceinline__ uint32_t bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits(bf16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits(__half v) {
  return __half_as_ushort(v);
}

// Store n (1, 2, 4 or 8; at most 16 bytes) consecutive values v[0..n),
// cast to T, in one access (dst aligned to it).
template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float* v, int n) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = sizeof(T) == 4
               ? bits(from_f32<T>(v[i]))
               : bits(from_f32<T>(v[2 * i])) |
                     (bits(from_f32<T>(v[2 * i + 1])) << 16);
  const int words = n * (int)sizeof(T) / 4;
  if (words == 4)
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else if (words == 2)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else if (words == 1)
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  else
    *dst = from_f32<T>(v[0]);
}

// Fragments from shared memory for mma.sync m16n8k16 (lane l; the four 8x8
// matrices of an .x4 take their row addresses from lanes 0-7, 8-15, 16-23,
// 24-31). A is 16 (rows) x 16 (k), B is 16 (k) x 8 (n) a tile.
// A(r, k) at base[r * ld + k]:
template <typename T>
__device__ __forceinline__ void frag_a_rows(uint32_t a[4], const T* base,
                                            int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, base + (l & 15) * ld + (l >> 4) * 8);
}
// A(r, k) at base[k * ld + r]:
template <typename T>
__device__ __forceinline__ void frag_a_cols(uint32_t a[4], const T* base,
                                            int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(a, base + ((l & 7) + (l >> 4) * 8) * ld + ((l >> 3) & 1) * 8);
}
// Two n8 tiles (b[0..1]: n 0-7, b[2..3]: n 8-15), B(k, n) at base[k*ld + n]:
template <typename T>
__device__ __forceinline__ void frag_b2_krows(uint32_t b[4], const T* base,
                                              int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, base + (l & 15) * ld + (l >> 4) * 8);
}
// One n8 tile, B(k, n) at base[k * ld + n] (lanes 0-15 address):
template <typename T>
__device__ __forceinline__ void frag_b1_krows(uint32_t b[2], const T* base,
                                              int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x2_t(b, base + (l & 15) * ld);
}
// Two n8 tiles, B(k, n) at base[n * ld + k]:
template <typename T>
__device__ __forceinline__ void frag_b2_nrows(uint32_t b[4], const T* base,
                                              int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, base + ((l & 7) + (l >> 4) * 8) * ld + ((l >> 3) & 1) * 8);
}

// The f32 counterpart of one mma on the CUDA cores, in its fragment layout:
// c += A . B with A(r, k) = a[r * ar + k * ak], B(k, n) = b[k * bk + n * bn],
// lane (g, t) = (l / 4, l % 4) holding rows g, g + 8 x columns 2t, 2t + 1.
__device__ __forceinline__ void fma_16x8x16(float c[4], const float* a,
                                            int ar, int ak, const float* b,
                                            int bk, int bn) {
  const int l = threadIdx.x & 31;
  const float* a0 = a + (l >> 2) * ar;
  const float* a1 = a0 + 8 * ar;
  const float* b0 = b + 2 * (l & 3) * bn;
  const float* b1 = b0 + bn;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float x0 = a0[k * ak], x1 = a1[k * ak];
    const float y0 = b0[k * bk], y1 = b1[k * bk];
    c[0] = fmaf(x0, y0, c[0]);
    c[1] = fmaf(x0, y1, c[1]);
    c[2] = fmaf(x1, y0, c[2]);
    c[3] = fmaf(x1, y1, c[3]);
  }
}

// A shared-memory row pitch (elements) for ldmatrix: a multiple of 8 whose
// byte pitch (2-byte types) is an odd multiple of 16, so the eight rows of
// an 8x8 matrix fall on distinct bank groups. Mirrored by
// ops/correlation.py::_pad_ld.
__host__ __device__ constexpr int pad_ld(int n) {
  return ((n + 7) / 8) % 2 == 0 ? (n + 7) / 8 * 8 + 8 : (n + 7) / 8 * 8;
}

// ---------------------------------------------------------------------------
// The forward

constexpr int FP = 4;     // window origin x0 - FP (FP >= md)
constexpr int FKC = 32;   // channels a staged chunk: two k16 steps
constexpr int GW = 3;     // dy rows a warp
constexpr int FWD_MAX_WARPS = 8;
constexpr int MAX_CLUSTER = 8;
// warps a block at least: those past the warp tasks only stage and store
constexpr int MIN_WARPS = 4;

__host__ __device__ constexpr int block_warps(int tasks) {
  return tasks > MIN_WARPS ? tasks : MIN_WARPS;
}

// The plan (ops/correlation.py::CorrPlan) and what the launcher derives.
struct FwdArgs {
  const void* f1;
  const void* f2;
  void* out;
  int C, H, W;
  float inv_c, leaky;
  int use_leaky;
  int th, wj, ndg, cs, kc;      // the plan (cs = ceil(C / kc))
  int ytiles, xtiles, dyblocks;
  int v1, v2;                   // copy widths (elements) of f1 and f2
  int vo;                       // store width (elements) of out
  FastDiv by_th, by_r2;         // th and th + GW*ndg - 1
};

__host__ __device__ constexpr int fwd_stage_elems(int th, int wj, int ndg) {
  return FKC * (pad_ld(th * 16 * wj) +
                pad_ld((th + GW * ndg - 1) * (16 * wj + 2 * FP)));
}

// The band buffer's row pitch (floats): at least tx, with th * pitch = 4
// (mod 32), so that a warp's scatter of its accumulators (lanes (g, t):
// row dx*th + r moves by 2*th rows with t and -th with g, column g) hits 32
// distinct banks; th = 8 allows no such pitch and takes 8 (mod 32), two
// ways. Mirrored by ops/correlation.py::_band_pitch.
__host__ __device__ constexpr int band_pitch(int th, int tx) {
  for (int bp = tx; bp < tx + 32; ++bp)
    if (th * bp % 32 == 4) return bp;
  for (int bp = tx; bp < tx + 32; ++bp)
    if (th * bp % 32 == 8) return bp;
  return tx;
}

// Bytes of dynamic shared memory: two stages (one when the block's channels
// fit one chunk), or the f32 band buffer of the epilogue that aliases them.
__host__ __device__ constexpr int fwd_smem_bytes(int esize, int md, int th,
                                                 int wj, int ndg, int kc) {
  const int stages = kc > FKC ? 2 : 1;
  const int staged = stages * fwd_stage_elems(th, wj, ndg) * esize;
  const int band =
      GW * ndg * (2 * md + 1) * th * band_pitch(th, 16 * wj) * 4;
  return staged > band ? staged : band;
}

// acc[s][nt] += A . B over one k16 step for the warp's dy rows s < rows:
// A at a (A(x, k) = a[k * lda + x]), the window of dy row s at b + s * sw
// (B(k, n) = b[k * ldb + n]).
template <typename T>
__device__ __forceinline__ void fwd_step(float (&acc)[GW][3][4], const T* a,
                                         int lda, const T* b, int ldb, int sw,
                                         int rows) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int s = 0; s < GW; ++s) {
      if (s >= rows) break;
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
        fma_16x8x16(acc[s][nt], a, 1, lda, b + s * sw + 8 * nt, ldb, 1);
    }
  } else {
    uint32_t af[4];
    frag_a_cols(af, a, lda);
#pragma unroll
    for (int s = 0; s < GW; ++s) {
      if (s >= rows) break;
      uint32_t bf[4], bl[2];
      frag_b2_krows(bf, b + s * sw, ldb);
      frag_b1_krows(bl, b + s * sw + 16, ldb);
      mma<T>(acc[s][0], af, bf[0], bf[1]);
      mma<T>(acc[s][1], af, bf[2], bf[3]);
      mma<T>(acc[s][2], af, bl[0], bl[1]);
    }
  }
}

// Block blockIdx.x = (((n * ytiles + yt) * xtiles + xt) * dyblocks + dyb) *
// cs + rank: output rows yt*th.., columns xt*16*wj.., dy indices from
// dyb*ndg*3, channels rank*kc.. (the rank fastest: a cluster is cs
// consecutive blocks). Warp w: row w % th, column tile (w / th) % wj, dy
// group w / (th * wj).
template <typename T, int MD>
__global__ void __launch_bounds__(FWD_MAX_WARPS * 32, 3)
    corr_fwd_kernel(const FwdArgs p) {
  constexpr int D = 2 * MD + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  float* band = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int TX = 16 * p.wj, SW2 = TX + 2 * FP;
  const int R2 = p.th + GW * p.ndg - 1;
  const int LD1 = pad_ld(p.th * TX), LD2 = pad_ld(R2 * SW2);
  const int stage_elems = FKC * (LD1 + LD2);
  const int BP = band_pitch(p.th, TX);
  const FastDiv by_th = p.by_th, by_r2 = p.by_r2;

  // 32-bit decode: the grid has fewer than 2^32 blocks
  uint32_t b = blockIdx.x;
  const int rank = (int)(b % (uint32_t)p.cs);
  b /= (uint32_t)p.cs;
  const int dyb = (int)(b % (uint32_t)p.dyblocks);
  b /= (uint32_t)p.dyblocks;
  const int xt = (int)(b % (uint32_t)p.xtiles);
  b /= (uint32_t)p.xtiles;
  const int yt = (int)(b % (uint32_t)p.ytiles);
  const int n = (int)(b / (uint32_t)p.ytiles);
  const int x0 = xt * TX, y0 = yt * p.th, d0 = dyb * p.ndg * GW;
  const int c_beg = rank * p.kc, c_end = min(p.C, c_beg + p.kc);
  const int nch = c_end > c_beg ? (c_end - c_beg + FKC - 1) / FKC : 0;
  const int H = p.H, W = p.W;
  const size_t plane = (size_t)H * W;
  const T* f1n = static_cast<const T*>(p.f1) + (size_t)n * p.C * plane;
  const T* f2n = static_cast<const T*>(p.f2) + (size_t)n * p.C * plane;

  // chunk ch: s1[k][r][x] = f1[c, y0+r, x0+x], s2[k][q][col] = f2[c,
  // y0+d0-MD+q, x0-FP+col], c = c_beg + ch*FKC + k; zero outside the image
  // and past the rank's channels
  auto load = [&](int ch, T* s1) {
    T* s2 = s1 + FKC * LD1;
    const int cb = c_beg + ch * FKC;
    // the maps are made a chunk (one or two a block), not kept in registers
    stage_rows<T>(stage_map<T>(TX, p.v1, x0, W), FKC * p.th, f1n,
                  [&](int rho, const T*& src, T*& dst) {
                    const int k = by_th.div(rho), r = rho - k * p.th;
                    const int c = cb + k, y = y0 + r;
                    src = c < c_end && y < H
                              ? f1n + c * plane + (size_t)y * W + x0
                              : nullptr;
                    dst = s1 + k * LD1 + r * TX;
                  });
    stage_rows<T>(stage_map<T>(SW2, p.v2, x0 - FP, W), FKC * R2, f2n,
                  [&](int rho, const T*& src, T*& dst) {
                    const int k = by_r2.div(rho), q = rho - k * R2;
                    const int c = cb + k, gy = y0 + d0 - MD + q;
                    src = c < c_end && gy >= 0 && gy < H
                              ? f2n + c * plane + (size_t)gy * W + x0 - FP
                              : nullptr;
                    dst = s2 + k * LD2 + q * SW2;
                  });
  };

  const int r = warp % p.th, j = (warp / p.th) % p.wj;
  const int dl0 = (warp / (p.th * p.wj)) * GW;  // the warp's first local dy
  const int rows = min(GW, D - d0 - dl0);       // its dy rows in range
  const bool live = warp < p.th * p.wj * p.ndg && rows > 0 && y0 + r < H &&
                    x0 + 16 * j < W;

  float acc[GW][3][4];
#pragma unroll
  for (int s = 0; s < GW; ++s)
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][nt][e] = 0.f;

  if (nch > 0) {
    load(0, stage);
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch landed; every warp is done with ch - 1
    if (ch + 1 < nch) {
      load(ch + 1, stage + ((ch + 1) & 1) * stage_elems);
      cp_async_commit();
    }
    if (live) {
      const T* s1 = stage + (ch & 1) * stage_elems;
      const T* s2 = s1 + FKC * LD1;
      const int kn = c_end - (c_beg + ch * FKC);  // channels left
#pragma unroll
      for (int ks = 0; ks < FKC / 16; ++ks)
        if (ks * 16 < kn)
          fwd_step<T>(acc, s1 + ks * 16 * LD1 + r * TX + 16 * j, LD1,
                      s2 + ks * 16 * LD2 + (r + dl0) * SW2 + 16 * j, LD2, SW2,
                      rows);
    }
  }
  __syncthreads();  // the band buffer aliases the stages

  // band[(dl*D + dx)*th + r][x] (rows BP apart): dy row d0 + dl, dx, output
  // (y0 + r, x0 + x)
  if (live) {
    const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int s = 0; s < GW; ++s) {
      if (s >= rows) break;
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = gq + 8 * (e >> 1);
          const int dx = 8 * nt + 2 * t4 + (e & 1) - FP - m + MD;
          if (dx >= 0 && dx < D)
            band[(((dl0 + s) * D + dx) * p.th + r) * BP + 16 * j + m] =
                acc[s][nt][e];
        }
    }
  }
  // the epilogue: rank q of cs takes band rows [q R / cs, (q+1) R / cs),
  // sums them over every rank in rank order, and stores p.vo outputs a
  // thread and access
  const int R = GW * p.ndg * D * p.th;
  T* out = static_cast<T*>(p.out);
  cg::cluster_group cluster = cg::this_cluster();
  if (p.cs > 1)
    cluster.sync();  // every rank's partials are in its shared memory
  else
    __syncthreads();
  const int vpr = TX / p.vo, step = nthr / vpr;
  if (tid < step * vpr) {
    const int x = (tid % vpr) * p.vo, gx = x0 + x;
    const int hi = (rank + 1) * R / p.cs;
    for (int row = rank * R / p.cs + tid / vpr; row < hi; row += step) {
      const int t = by_th.div(row), y = y0 + row - t * p.th;
      const int d = d0 + t / D, dx = t % D;
      if (d >= D || y >= H || gx >= W) continue;
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q) {
        if (q >= p.cs) break;
        const float* src = (p.cs > 1 ? cluster.map_shared_rank(band, q)
                                     : band) + row * BP + x;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < p.vo) v[u] += src[u];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] *= p.inv_c;
        if (p.use_leaky) v[u] = v[u] >= 0.f ? v[u] : p.leaky * v[u];
      }
      store_vec(out + ((size_t)n * D * D + d * D + dx) * plane +
                    (size_t)y * W + gx,
                v, p.vo);
    }
  }
  if (p.cs > 1) cluster.sync();  // no block leaves while another reads it
}

// The widest copy (elements, a power of 2 up to max_elems) that keeps every
// staged vector inside or outside the image and its global address aligned:
// W, the batch stride and the base address all multiples of it.
int copy_width(const void* ptr, long long batch_stride, int w, int esize,
               int max_elems) {
  int v = max_elems;
  while (v > 1 && (w % v || batch_stride % v ||
                   reinterpret_cast<uintptr_t>(ptr) % (v * esize)))
    v >>= 1;
  return v;
}

template <typename K>
int allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return 0;
  const int e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!e) allowed = bytes;
  return e;
}

template <typename T, int MD>
int launch_fwd_md(FwdArgs a, int n, cudaStream_t stream) {
  static int allowed = 0;
  const int smem =
      fwd_smem_bytes((int)sizeof(T), MD, a.th, a.wj, a.ndg, a.kc);
  if (int e = allow_smem(corr_fwd_kernel<T, MD>, smem, allowed)) return e;
  const long long blocks =
      (long long)n * a.ytiles * a.xtiles * a.dyblocks * a.cs;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(32 * block_warps(a.th * a.wj * a.ndg));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, corr_fwd_kernel<T, MD>, a);
  return e ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* f1, const void* f2, void* out, int n, int c,
               int h, int w, int md, float leaky, int use_leaky, int th,
               int wj, int ndg, int kc, cudaStream_t stream) {
  const int D = 2 * md + 1;
  FwdArgs a;
  a.f1 = f1;
  a.f2 = f2;
  a.out = out;
  a.C = c;
  a.H = h;
  a.W = w;
  a.inv_c = (float)(1.0 / c);
  a.leaky = leaky;
  a.use_leaky = use_leaky;
  a.th = th;
  a.wj = wj;
  a.ndg = ndg;
  a.kc = kc;
  a.cs = (c + kc - 1) / kc;
  a.ytiles = (h + th - 1) / th;
  a.xtiles = (w + 16 * wj - 1) / (16 * wj);
  a.dyblocks = ((D + GW - 1) / GW + ndg - 1) / ndg;
  const long long bstride = (long long)c * h * w;
  const int es = (int)sizeof(T);
  a.v1 = copy_width(f1, bstride, w, es, 16 / es);
  a.v2 = copy_width(f2, bstride, w, es, FP);
  a.vo = copy_width(out, (long long)D * D * h * w, w, es, 16 / es);
  a.by_th = fast_div(th);
  a.by_r2 = fast_div(th + GW * ndg - 1);
  switch (md) {
    case 1:
      return launch_fwd_md<T, 1>(a, n, stream);
    case 2:
      return launch_fwd_md<T, 2>(a, n, stream);
    case 3:
      return launch_fwd_md<T, 3>(a, n, stream);
    case 4:
      return launch_fwd_md<T, 4>(a, n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The gradients of the cost volume.
//
//   g'[n, t, y, x] = out[n, t, y, x] >= 0 ? g[n, t, y, x] : leaky * g[...]
//     (with the LeakyReLU fused, the activation's derivative is read off the
//     saved output's sign -- the slope is positive -- as
//     maskflownet_tpu/ops/pallas/correlation.py:293-295 and :359-360 do;
//     without it g' = g)
//   df1[n, c, y, x] = 1/C * sum_t g'[n, t, y, x] * f2[n, c, y+dy, x+dx]
//   df2[n, c, y, x] = 1/C * sum_t g'[n, t, y-dy, x-dx] * f1[n, c, y-dy, x-dx]
//
// with t = (dy+md)(2md+1) + (dx+md), f2 zero outside the image, and every
// df2 term whose source pixel (y-dy, x-dx) lies outside the image zero: the
// gather form of the scatter that the forward's transpose is, so no
// atomics. g may be a channel slice of a larger tensor (the gradient of the
// concatenation each cost volume enters): its images lie g_stride elements
// apart, each a dense (D*D, H, W) block; out is dense.
//
// What bounds them on an H100: bytes. Each reads g (D*D values a pixel),
// out (D*D, with the LeakyReLU) and one feature map (C), and writes one
// gradient (C), against 2*C*D*D flops a pixel: at most ~C/2 flops a byte in
// bf16, below the ridge of either the tensor cores or the CUDA cores at the
// fine levels.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// corr_bwd_f2_kernel replaces _corr_bwd_f2_kernel :127 (NHWC) and
// _hm_bwd_f2_kernel :253 (H-major) of maskflownet_tpu/ops/pallas/
// correlation.py: the TPU kernels carry the sum over a sequential dy grid
// axis in a revisited output block. What bounds it: as the forward, on
// paper bytes (g and out are 81 planes each), in practice the instructions
// and latency of each source row's staging and assembly (PERF.md §6).
// The first version read g and out ceil(C / 8) times (a block owned 8
// channels) and restaged one dy row of g' behind two barriers 9 times a
// block. This design:
//   * a band GEMM over source pixels on the tensor cores. Fix a source row
//     ys and a tile of 16 target columns x0..; then df2[c, ys + dy', x0 +
//     x] += sum_xs F[c, xs] M[x, xs], F = f1[c, ys, x0-8 : x0+24] (K = 32
//     source pixels, two k16 steps) and M[x, xs] = g'[t(dy', x - xs), ys,
//     xs] on the band |x - xs| <= md, zero off it. F is A (channels x
//     K, ldmatrix), M is B (K x 16 targets, two n8 tiles). The window
//     starts at x0 - 8, so the copies are 16 bytes where W % 8 == 0.
//   * exact products in bf16/f16: M is assembled in shared memory from g
//     split by the sign of the saved out, M+ (out >= 0) and M- (out < 0),
//     both exact in the input type like f1; df2 = 1/C (M+ F + leaky M- F)
//     in f32 from two MMAs. 0.1 * g is never rounded to bf16. A thread
//     assembles one (x, tap) pair of the band for each reached tile, four
//     tiles' loads in flight before their stores.
//   * a block owns th target rows x 16*wj columns x cpb channels (a cap of
//     64, lowered at the coarse levels so the grid fills the card; one warp
//     a target row and column tile, its cpb / 16 m16 tiles of channels in
//     f32 accumulators, at least 4 warps), so g and out are read
//     ceil(C / cpb) times, and it loops over the th + 2md source rows that
//     reach its targets: a ring of 3 staged rows, the next two rows' f1
//     and g/out windows arriving by cp.async while the current one is
//     assembled and multiplied, two barriers a row. f1's rows are staged
//     once for th + 2md source rows, not 2md + 1 times a target row.
//   * each df2 value is written once, after the f32 sum over every tap,
//     two neighbouring columns a store where W is even. The grid comes
//     from corr_plan, the large dimension on gridDim.x: no batch limit.
// f32 inputs: one M = g' in f32 and CUDA-core FMAs in the same layout.
// ---------------------------------------------------------------------------

constexpr int BWD_MAX_WARPS = 4;
constexpr int BST = 3;       // staged source rows a block: a ring
constexpr int BK = 32;       // source pixels a target tile's K
// the backward's window origin x0 - 8: 16-byte copies where W % 8 == 0;
// the band k = x - dx' + 8 lies in [4, 27] of a tile's K
constexpr int FP_BWD = 8;
constexpr int LDM = BK + 8;  // M's row pitch (elements; 80 bytes in bf16)

struct BwdArgs {
  const void* g;
  const void* out;
  const void* f1;
  void* df2;
  long long g_stride;
  int C, H, W;
  float inv_c, leaky;
  int th, wj, cpb;  // the plan
  int ytiles, xtiles, cblocks;
  int vf, vg;       // copy widths (elements) of f1 and of g/out
  FastDiv by_wj;
};

__host__ __device__ constexpr int bwd_stage_elems(int md, int th, int wj,
                                                  int cpb) {
  return cpb * pad_ld(16 * wj + 2 * FP_BWD) +
         2 * th * (2 * md + 1) * (16 * wj + 2 * FP_BWD);
}

// Bytes of dynamic shared memory: BST stages and M (M+ and M- in a 2-byte
// type, one f32 M: the same bytes).
__host__ __device__ constexpr int bwd_smem_bytes(int esize, int md, int th,
                                                 int wj, int cpb) {
  return BST * bwd_stage_elems(md, th, wj, cpb) * esize +
         th * wj * 16 * LDM * 4;
}

// Block blockIdx.x = ((n * ytiles + yt) * xtiles + xt) * cblocks + cb:
// target rows yt*th.., columns xt*16*wj.., channels cb*cpb... Warp w:
// target row w % th, column tile w / th. MT: the warp's m16 tiles of
// channels (cpb <= 16 * MT), so that the accumulators a plan leaves unused
// take no registers.
template <typename T, int MD, int MT>
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32, 4)
    corr_bwd_f2_kernel(const BwdArgs p) {
  constexpr int D = 2 * MD + 1;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int TX = 16 * p.wj, SWF = TX + 2 * FP_BWD, SWG = TX + 2 * FP_BWD;
  const int LDF = pad_ld(SWF);
  const int stage_elems = bwd_stage_elems(MD, p.th, p.wj, p.cpb);
  const FastDiv by_wj = p.by_wj;
  T* stage = reinterpret_cast<T*>(smem);
  // M (after the stages): bf16/f16 M+ and M- of (row, tile) at
  // ((r * wj + j) * 2 + sign) * 16 * LDM, f32 M at (r * wj + j) * 16 * LDM
  unsigned char* mbuf = smem + BST * stage_elems * sizeof(T);
  T* mh = reinterpret_cast<T*>(mbuf);
  float* mf = reinterpret_cast<float*>(mbuf);
  const bool leaky = p.out != nullptr;

  uint32_t b = blockIdx.x;
  const int cbk = (int)(b % (uint32_t)p.cblocks);
  b /= (uint32_t)p.cblocks;
  const int xt = (int)(b % (uint32_t)p.xtiles);
  b /= (uint32_t)p.xtiles;
  const int yt = (int)(b % (uint32_t)p.ytiles);
  const int n = (int)(b / (uint32_t)p.ytiles);
  const int x0 = xt * TX, y0 = yt * p.th;
  const int c_beg = cbk * p.cpb, nc = min(p.cpb, p.C - c_beg);
  const int H = p.H, W = p.W;
  const size_t plane = (size_t)H * W;
  const T* f1n =
      static_cast<const T*>(p.f1) + ((size_t)n * p.C + c_beg) * plane;
  const T* gn = static_cast<const T*>(p.g) + (size_t)n * p.g_stride;
  const T* on = leaky ? static_cast<const T*>(p.out) +
                            (size_t)n * D * D * plane
                      : nullptr;

  // the target rows source row ys reaches: y0 + tr, tr in [lo, hi]
  auto reach_lo = [&](int ys) { return max(0, ys - MD - y0); };
  auto reach_hi = [&](int ys) {
    return min(min(p.th, H - y0) - 1, ys + MD - y0);
  };

  const StageMap mapf = stage_map<T>(SWF, p.vf, x0 - FP_BWD, W);
  const StageMap mapg = stage_map<T>(SWG, p.vg, x0 - FP_BWD, W);
  // source row ys: sF[k][col] = f1[c_beg + k, ys, x0-FP_BWD+col]; for each
  // target row tr it reaches (a = y0 + tr - ys + MD in [0, D)),
  // sG[tr][bb][col] = g[a*D + bb, ys, x0-FP_BWD+col] and sO the same of out;
  // zero outside the image
  auto load = [&](int ys, T* sF) {
    T* sG = sF + p.cpb * LDF;
    T* sO = sG + p.th * D * SWG;
    stage_rows<T>(mapf, p.cpb, f1n,
                  [&](int k, const T*& src, T*& dst) {
                    src = k < nc ? f1n + k * plane + (size_t)ys * W + x0 -
                                       FP_BWD
                                 : nullptr;
                    dst = sF + k * LDF;
                  });
    const int lo = reach_lo(ys), rows = (reach_hi(ys) - lo + 1) * D;
    const size_t at = (size_t)ys * W + x0 - FP_BWD;
    auto row_of = [&](const T* base, T* s) {
      return [=](int rho, const T*& src, T*& dst) {
        const int tr = lo + rho / D, bb = rho % D;
        const int a = y0 + tr - ys + MD;
        src = base + (size_t)(a * D + bb) * plane + at;
        dst = s + (tr * D + bb) * SWG;
      };
    };
    stage_rows<T>(mapg, rows, gn, row_of(gn, sG));
    if (leaky) stage_rows<T>(mapg, rows, on, row_of(on, sO));
  };

  const int r = warp % p.th, j = warp / p.th;
  const int y = y0 + r;
  const bool live = warp < p.th * p.wj && y < H && x0 + 16 * j < W;

  // M is zero off the band, once; the band is rewritten every source row
  {
    const int words = p.th * p.wj * 16 * LDM;  // 4-byte words
    for (int i = tid; i < words; i += nthr) mf[i] = 0.f;
  }

  float accp[MT][2][4], accm[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) accp[mt][nt][e] = accm[mt][nt][e] = 0.f;

  // a ring of BST staged source rows, BST - 1 in flight ahead
  const int ys_lo = max(0, y0 - MD), ys_hi = min(H - 1, y0 + p.th - 1 + MD);
  const int S = ys_hi - ys_lo + 1;
#pragma unroll
  for (int i = 0; i < BST - 1; ++i) {
    if (i < S) load(ys_lo + i, stage + i * stage_elems);
    cp_async_commit();
  }
  for (int i = 0; i < S; ++i) {
    const int ys = ys_lo + i;
    const T* sF = stage + (i % BST) * stage_elems;
    const T* sG = sF + p.cpb * LDF;
    const T* sO = sG + p.th * D * SWG;
    cp_async_wait<BST - 2>();
    __syncthreads();  // row ys landed; every warp is done with ys - 1
    if (i + BST - 1 < S)
      load(ys + BST - 1, stage + ((i + BST - 1) % BST) * stage_elems);
    cp_async_commit();
    // assemble the band of M for each target row ys reaches: M[x][k] with
    // k = x - dx' + FP_BWD, from sG[tr][bb = dx' + MD][16j + k]; a thread
    // takes one (x, bb) of the 16*D and walks the reached tiles
    const int lo = reach_lo(ys);
    const int cnt = (reach_hi(ys) - lo + 1) * p.wj;  // tiles reached, <= 8
    for (int pr = tid; pr < 16 * D; pr += nthr) {
      const int x = pr / D, bb = pr - x * D;
      const int k = x - bb + MD + FP_BWD;
      // the loads of four tiles in flight, then their stores
#pragma unroll
      for (int e0 = 0; e0 < BWD_MAX_WARPS; e0 += 4) {
        T gv[4];
        bool neg[4];
        int tile[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u;
          if (e >= cnt) break;
          const int q = by_wj.div(e);
          const int tj = e - q * p.wj;
          const int si = ((lo + q) * D + bb) * SWG + 16 * tj + k;
          tile[u] = (lo + q) * p.wj + tj;
          gv[u] = sG[si];
          neg[u] = leaky && to_f32(sO[si]) < 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (e0 + u >= cnt) break;
          if constexpr (kF32) {
            mf[(tile[u] * 16 + x) * LDM + k] =
                neg[u] ? p.leaky * gv[u] : gv[u];
          } else {
            const T zero = from_f32<T>(0.f);
            const int m = (tile[u] * 32 + x) * LDM + k;
            mh[m] = neg[u] ? zero : gv[u];
            mh[m + 16 * LDM] = neg[u] ? gv[u] : zero;
          }
        }
      }
    }
    __syncthreads();
    const int a = y - ys + MD;
    if (!live || a < 0 || a >= D) continue;
    const int tile = r * p.wj + j;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const T* fa = sF + 16 * j + 16 * ks;
      if constexpr (kF32) {
        const float* mb = mf + tile * 16 * LDM + 16 * ks;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (16 * mt >= nc) break;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            fma_16x8x16(accp[mt][nt], fa + 16 * mt * LDF, LDF, 1,
                        mb + 8 * nt * LDM, 1, LDM);
        }
      } else {
        uint32_t bp[4], bm[4];
        frag_b2_nrows(bp, mh + (tile * 2) * 16 * LDM + 16 * ks, LDM);
        if (leaky)
          frag_b2_nrows(bm, mh + (tile * 2 + 1) * 16 * LDM + 16 * ks, LDM);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (16 * mt >= nc) break;
          uint32_t af[4];
          frag_a_rows(af, fa + 16 * mt * LDF, LDF);
          mma<T>(accp[mt][0], af, bp[0], bp[1]);
          mma<T>(accp[mt][1], af, bp[2], bp[3]);
          if (leaky) {
            mma<T>(accm[mt][0], af, bm[0], bm[1]);
            mma<T>(accm[mt][1], af, bm[2], bm[3]);
          }
        }
      }
    }
  }
  if (!live) return;
  // each lane's two neighbouring columns in one store where W is even
  const int gq = lane >> 2, t4 = lane & 3;
  const float lk = leaky ? p.leaky : 0.f;
  T* o = static_cast<T*>(p.df2) + ((size_t)n * p.C + c_beg) * plane +
         (size_t)y * W;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 16 * mt + gq + 8 * h;
        const int x = x0 + 16 * j + 8 * nt + 2 * t4;
        if (c >= nc || x >= W) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = (accp[mt][nt][2 * h + e] + lk * accm[mt][nt][2 * h + e]) *
                 p.inv_c;
        if (W % 2 == 0) {
          store_vec(o + c * plane + x, v, 2);
        } else {
          o[c * plane + x] = from_f32<T>(v[0]);
          if (x + 1 < W) o[c * plane + x + 1] = from_f32<T>(v[1]);
        }
      }
}

template <typename T, int MD, int MT>
int launch_bwd_f2_mt(BwdArgs a, int n, cudaStream_t stream) {
  static int allowed = 0;
  const int smem = bwd_smem_bytes((int)sizeof(T), MD, a.th, a.wj, a.cpb);
  if (int e = allow_smem(corr_bwd_f2_kernel<T, MD, MT>, smem, allowed))
    return e;
  const long long blocks = (long long)n * a.ytiles * a.xtiles * a.cblocks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  corr_bwd_f2_kernel<T, MD, MT>
      <<<(unsigned)blocks, 32 * block_warps(a.th * a.wj), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MD>
int launch_bwd_f2_md(BwdArgs a, int n, cudaStream_t stream) {
  if (a.cpb <= 16) return launch_bwd_f2_mt<T, MD, 1>(a, n, stream);
  if (a.cpb <= 32) return launch_bwd_f2_mt<T, MD, 2>(a, n, stream);
  return launch_bwd_f2_mt<T, MD, 4>(a, n, stream);
}

template <typename T>
int launch_bwd_f2(const void* g, const void* out, const void* f1, void* df2,
                  long long g_stride, int n, int c, int h, int w, int md,
                  float leaky, int th, int wj, int cpb, cudaStream_t stream) {
  BwdArgs a;
  a.g = g;
  a.out = out;
  a.f1 = f1;
  a.df2 = df2;
  a.g_stride = g_stride;
  a.C = c;
  a.H = h;
  a.W = w;
  a.inv_c = (float)(1.0 / c);
  a.leaky = leaky;
  a.th = th;
  a.wj = wj;
  a.cpb = cpb;
  a.ytiles = (h + th - 1) / th;
  a.xtiles = (w + 16 * wj - 1) / (16 * wj);
  a.cblocks = (c + cpb - 1) / cpb;
  a.by_wj = fast_div(wj);
  const int es = (int)sizeof(T);
  const long long dd = (long long)(2 * md + 1) * (2 * md + 1);
  a.vf = copy_width(f1, (long long)c * h * w, w, es, 16 / es);
  a.vg = copy_width(g, g_stride, w, es, 16 / es);
  if (out != nullptr) {
    const int vo = copy_width(out, dd * h * w, w, es, 16 / es);
    a.vg = vo < a.vg ? vo : a.vg;
  }
  switch (md) {
    case 1:
      return launch_bwd_f2_md<T, 1>(a, n, stream);
    case 2:
      return launch_bwd_f2_md<T, 2>(a, n, stream);
    case 3:
      return launch_bwd_f2_md<T, 3>(a, n, stream);
    case 4:
      return launch_bwd_f2_md<T, 4>(a, n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// corr_bwd_f1_kernel replaces _corr_bwd_f1_kernel :104 (NHWC) and
// _hm_bwd_f1_kernel :232 (H-major) of maskflownet_tpu/ops/pallas/
// correlation.py, which carry the sum over a sequential dy grid axis in a
// revisited output block. What bounds it: as corr_bwd_f2, bytes on paper (g
// and out are D*D planes each against C of f2 and of df1); in practice a
// block's staging (the copies' issue and latency) and its products and
// band, a few hundred ns a dy row (PERF.md §6). The first version (a block
// of 8 channels of an 8 x 32 tile) read g and out ceil(C / 8) times by
// scalar loads, staged f2 as f32 by a scalar loop and ran the products on
// the CUDA cores. This design:
//   * a band GEMM on the tensor cores, one k16 step a tile. Fix a target
//     row y, an n8 tile of target columns xg.. (xg = x0 - 4 + 8i, so the
//     block's f2 window starting at x0 - 8 takes 16-byte copies) and one
//     dy; then df1[c, y, xg+n] += sum_k F[c, k] M'[k, n], F = f2[c, y+dy,
//     xg-4 : xg+12] (K = 16) and M'[k, n] = g'[(dy+md) D + k - n - 4 + md,
//     y, xg+n] on the band |k - n - 4| <= md, which lies in the k16 window
//     for every md <= 4. F is A (channels x 16, ldmatrix from the window at
//     an 8-aligned column), M' is B. The products are exact as in
//     corr_bwd_f2: M' is split by the saved output's sign into M+ and M-,
//     df1 = 1/C (M+ F + leaky M- F) in f32 from two MMAs.
//   * g' reads at the target pixel, which the block owns, so M' exists in
//     no buffer: each lane builds its B fragments (8 values a dy row) in
//     registers from the staged g and out tiles, with no branch: which
//     values lie on the band is fixed per lane and folded into a mask once.
//     By rows, the tiles' tap pitch is 8 (mod 16) elements, so the loads of
//     the lanes on the band hit distinct banks (the lanes off it read their
//     column's first tap: at most two ways). The dy loop stays rolled.
//   * a block owns th target rows x 16*wj columns x cpb channels (one warp a
//     target row and column tile, its cpb / 16 m16 tiles of channels in f32
//     accumulators, at least 4 warps). It stages its g and out tiles (th x
//     D*D x (16*wj + 8) each) and the th + 2md rows of f2 that reach them,
//     all by cp.async in one group: one wait and one barrier, no ring. g and
//     out are read ceil(C / cpb) times, each f2 row (th + 2md) / th times.
//   * where one column tile spans the image, each tap's th rows of g and
//     out and each channel's rows of f2 are contiguous runs: they are
//     staged as the 16-byte chunks that cover them, whatever W, each run at
//     its own address modulo 16 bytes (the runs' pitch is their distance in
//     memory modulo 8 elements, so one offset a block serves them all);
//     f2's window rows are then laid out from its runs in shared memory
//     (one more barrier) -- no narrow copies at odd W.
//   * each df1 value is written once, after the f32 sum over every tap, two
//     neighbouring columns a store where W is even. The grid comes from
//     corr_plan, the large dimension on gridDim.x: no batch limit.
// f32 inputs stage the same tiles and run CUDA-core FMAs: a lane owns one
// column of a warp's tile and every other channel.
// ---------------------------------------------------------------------------

constexpr int F1_MAX_WARPS = 8;
// a block's target columns start F1_SHIFT left of x0 (its f2 window starts
// at x0 - FP_BWD): each n8 tile's band then fits one aligned k16 step
constexpr int F1_SHIFT = 4;

struct Bf1Args {
  const void* g;
  const void* out;
  const void* f2;
  void* df1;
  long long g_stride;
  int C, H, W;
  float inv_c, leaky;
  int th, wj, cpb;  // the plan
  int ytiles, xtiles, cblocks;
  int vf, vg;       // copy widths (elements) of f2 and g/out, row by row
  int gt, fct;      // tap and channel pitches of the runs (one column tile)
  FastDiv by_cpb;
};

// Elements one tap of a staged g (or out) tile may take: th rows of
// 16*wj + 8 columns (rows staged by column tile) or a run of th rows with
// its alignment and read-ahead margins (one column tile).
__host__ __device__ constexpr int f1_tap_elems(int th, int wj) {
  return th * (16 * wj + 8) > th * 16 * wj + 40 ? th * (16 * wj + 8)
                                                 : th * 16 * wj + 40;
}

// f2's th + 2md rows in the window layout (columns x0 - 8 .. x0 + 16*wj:
// every tile's k16 windows), and (one column tile) each channel's rows as
// the run they are in memory, before the window is laid out from it
__host__ __device__ constexpr int f1_f2_elems(int md, int th, int wj,
                                              int cpb) {
  return (th + 2 * md) * cpb * pad_ld(16 * wj + FP_BWD);
}
__host__ __device__ constexpr int f1_run_elems(int md, int th, int wj,
                                               int cpb) {
  return cpb * ((th + 2 * md) * 16 * wj + 32);
}

// Bytes of dynamic shared memory: f2's rows, the g and out tiles, then
// (runs: one column tile) f2's runs.
__host__ __device__ constexpr int bwd_f1_smem_bytes(int esize, int md, int th,
                                                    int wj, int cpb,
                                                    int runs) {
  return (f1_f2_elems(md, th, wj, cpb) +
          2 * (2 * md + 1) * (2 * md + 1) * f1_tap_elems(th, wj) +
          (runs ? f1_run_elems(md, th, wj, cpb) : 0)) *
         esize;
}

// The least pitch of runs of `len` elements, each staged as the 16-byte
// chunks that cover it at an offset in [8, 16) that keeps its address
// modulo 16 bytes, that also holds `reach` elements from the run's start
// (a warp's read-ahead); rounded up to `stride` (the runs' distance in
// memory) modulo 8, so that one offset a block serves every run. Mirrored
// by ops/correlation.py::bwd_f1_run_pitch.
int f1_run_pitch(int len, int reach, long long stride) {
  const int need = len + 22 > reach + 15 ? len + 22 : reach + 15;
  return need + (int)(((stride - need) % 8 + 8) % 8);
}

// 0xffff in each half of a pair of 2-byte values (low half first) that is
// not >= 0 -- negative or NaN, not -0 -- the half of the pair that M-
// takes; the LeakyReLU's own test of the saved output.
__device__ __forceinline__ uint32_t neg_halves(uint32_t pair, bf16) {
  return (__uint_as_float(pair << 16) >= 0.f ? 0u : 0xffffu) |
         (__uint_as_float(pair & 0xffff0000u) >= 0.f ? 0u : 0xffff0000u);
}
__device__ __forceinline__ uint32_t neg_halves(uint32_t pair, __half) {
  const float lo = __half2float(__ushort_as_half((unsigned short)pair));
  const float hi = __half2float(__ushort_as_half((unsigned short)(pair >> 16)));
  return (lo >= 0.f ? 0u : 0xffffu) | (hi >= 0.f ? 0u : 0xffff0000u);
}

// Block blockIdx.x = ((n * ytiles + yt) * xtiles + xt) * cblocks + cb:
// target rows yt*th.., columns xt*16*wj - F1_SHIFT.., channels cb*cpb...
// Warp w: target row w % th, column tile w / th (warps past th*wj only
// stage). MT: the m16 tiles of channels (cpb <= 16 * MT).
template <typename T, int MD, int MT>
__global__ void __launch_bounds__(F1_MAX_WARPS * 32, 2)
    corr_bwd_f1_kernel(const Bf1Args p) {
  constexpr int D = 2 * MD + 1, DD = D * D;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int V = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int TX = 16 * p.wj, SWF = TX + FP_BWD, LDF = pad_ld(SWF);
  const int R2 = p.th + 2 * MD, cpb = p.cpb;
  const bool leaky = p.out != nullptr;
  const bool runs = p.xtiles == 1;

  uint32_t b = blockIdx.x;
  const int cbk = (int)(b % (uint32_t)p.cblocks);
  b /= (uint32_t)p.cblocks;
  const int xt = (int)(b % (uint32_t)p.xtiles);
  b /= (uint32_t)p.xtiles;
  const int yt = (int)(b % (uint32_t)p.ytiles);
  const int n = (int)(b / (uint32_t)p.ytiles);
  const int x0 = xt * TX, y0 = yt * p.th;
  const int c_beg = cbk * cpb, nc = min(cpb, p.C - c_beg);
  const int H = p.H, W = p.W;
  const int rows = min(p.th, H - y0);  // target rows in the image
  // f2's rows in the image: q in [q_lo, q_hi), source row y0 - MD + q
  const int q_lo = max(0, MD - y0), q_hi = min(R2, H - y0 + MD);
  const size_t plane = (size_t)H * W;
  const T* f2n =
      static_cast<const T*>(p.f2) + ((size_t)n * p.C + c_beg) * plane;
  const T* gn = static_cast<const T*>(p.g) + (size_t)n * p.g_stride;
  const T* on = leaky ? static_cast<const T*>(p.out) +
                            (size_t)n * DD * plane
                      : nullptr;

  const int tap_elems = f1_tap_elems(p.th, p.wj);
  T* sF = reinterpret_cast<T*>(smem);
  T* sG = sF + f1_f2_elems(MD, p.th, p.wj, cpb);
  T* sO = sG + DD * tap_elems;
  T* sR = sO + DD * tap_elems;  // f2's runs
  // a staged tile's element (r, tap, column x of the image): s[g0 + tap *
  // GT + r * GR + x - x0 + XC]; by rows, [r][tap][TX + 8], columns from
  // x0 - 8 (XC = 8); as runs, x0 = 0 (XC = 0), g0 in [V, 2V) keeps each
  // run's address modulo 16 bytes
  const int GT = runs ? p.gt : TX + 8, GR = runs ? W : DD * (TX + 8);
  const int XC = runs ? 0 : 8;
  auto run_offset = [&](const T* first) {
    return V + (int)((reinterpret_cast<uintptr_t>(first) / sizeof(T)) &
                     (V - 1));
  };
  // units u < units of len elements at base + u * stride, each copied as
  // the 16-byte chunks that cover it to s + g0 + u * pitch (offset by its
  // address modulo 16 bytes, which g0 and pitch keep)
  auto stage_runs = [&](const T* base, size_t stride, int units, int len,
                        T* s, int g0, int pitch) {
    const int kmax = (len + 2 * V - 2) / V;  // chunks a run at most
    for (int i = tid; i < units * kmax; i += nthr) {
      const int u = i / kmax, k = i - u * kmax;
      const uintptr_t ga = reinterpret_cast<uintptr_t>(base + u * stride);
      const uintptr_t lo = ga & ~(uintptr_t)15;
      if (lo + 16 * k >= ga + (uintptr_t)len * sizeof(T)) continue;
      cp_async(s + g0 + u * pitch - (int)((ga - lo) / sizeof(T)) + k * V,
               reinterpret_cast<const T*>(lo) + k * V, 16, true);
    }
  };
  int g0g = 0, g0o = 0, g0f = 0;
  if (runs) {
    // x0 = 0: the tap planes' rows y0 .. y0 + rows - 1 and each channel's
    // rows in the image are contiguous runs
    g0g = run_offset(gn + (size_t)y0 * W);
    stage_runs(gn + (size_t)y0 * W, plane, DD, rows * W, sG, g0g, GT);
    if (leaky) {
      g0o = run_offset(on + (size_t)y0 * W);
      stage_runs(on + (size_t)y0 * W, plane, DD, rows * W, sO, g0o, GT);
    }
    const T* f2r = f2n + (size_t)(y0 - MD + q_lo) * W;
    g0f = run_offset(f2r);
    stage_runs(f2r, plane, nc, (q_hi - q_lo) * W, sR, g0f, p.fct);
  } else {
    // f2's rows: sF[q][k][col] = f2[c_beg + k, y0 - MD + q, x0 - FP_BWD +
    // col], zero outside the image and past the block's channels; rows
    // outside the image are never read and not staged
    const FastDiv by_cpb = p.by_cpb;
    stage_rows<T>(stage_map<T>(SWF, p.vf, x0 - FP_BWD, W), R2 * cpb, f2n,
                  [&](int rho, const T*& src, T*& dst) {
                    const int q = by_cpb.div(rho), k = rho - q * cpb;
                    const bool in = q >= q_lo && q < q_hi;
                    dst = in ? sF + rho * LDF : nullptr;
                    src = in && k < nc ? f2n + k * plane +
                                             (size_t)(y0 - MD + q) * W + x0 -
                                             FP_BWD
                                       : nullptr;
                  });
    // the g and out tiles of the block's target pixels
    auto tile = [&](const T* base, T* s) {
      stage_rows<T>(stage_map<T>(TX + 8, p.vg, x0 - 8, W), p.th * DD, base,
                    [&](int rho, const T*& src, T*& dst) {
                      const int r = rho / DD, t = rho - r * DD;
                      const bool in = r < rows;
                      dst = in ? s + r * GR + t * GT : nullptr;
                      src = in ? base + t * plane + (size_t)(y0 + r) * W +
                                     x0 - 8
                               : nullptr;
                    });
    };
    tile(gn, sG);
    if (leaky) tile(on, sO);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // every copy landed
  if (runs) {
    // lay f2's window rows out of the runs, a thread a row: columns
    // [FP_BWD, FP_BWD + W) from the run (zero past the block's channels),
    // zero elsewhere; 8 or 4 bytes a copy where W and the runs' offset
    // allow (the runs' pitch and row starts are then multiples of it)
    const int tail = FP_BWD + W, tailv = (tail + V - 1) / V * V;
    const int vb = W * sizeof(T) % 8 == 0 && g0f * sizeof(T) % 8 == 0 ? 8
                   : W * sizeof(T) % 4 == 0 && g0f * sizeof(T) % 4 == 0
                       ? 4
                       : (int)sizeof(T);
    for (int rho = tid; rho < (q_hi - q_lo) * cpb; rho += nthr) {
      const int qq = rho / cpb, k = rho - qq * cpb;
      T* dst = sF + ((q_lo + qq) * cpb + k) * LDF;
      const T* src = sR + g0f + k * p.fct + qq * W;
      for (int col = 0; col < FP_BWD; col += V)
        *reinterpret_cast<uint4*>(dst + col) = make_uint4(0, 0, 0, 0);
      const bool in = k < nc;
      if (vb == 8) {
        for (int x = 0; x < W; x += 8 / sizeof(T))
          *reinterpret_cast<uint2*>(dst + FP_BWD + x) =
              in ? *reinterpret_cast<const uint2*>(src + x) : make_uint2(0, 0);
      } else if (vb == 4) {
        for (int x = 0; x < W; x += 4 / sizeof(T))
          *reinterpret_cast<uint32_t*>(dst + FP_BWD + x) =
              in ? *reinterpret_cast<const uint32_t*>(src + x) : 0u;
      } else {
        for (int x = 0; x < W; ++x)
          dst[FP_BWD + x] = in ? src[x] : from_f32<T>(0.f);
      }
      for (int col = tail; col < tailv; ++col) dst[col] = from_f32<T>(0.f);
      for (int col = tailv; col < SWF; col += V)
        *reinterpret_cast<uint4*>(dst + col) = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();  // the window rows are laid out
  }

  const int r = warp % p.th, j = warp / p.th;
  const int y = y0 + r;
  const int xw = x0 - F1_SHIFT + 16 * j;  // the warp's first target column
  if (warp >= p.th * p.wj || y >= H || xw >= W) return;
  T* o = static_cast<T*>(p.df1) + ((size_t)n * p.C + c_beg) * plane +
         (size_t)y * W;

  if constexpr (kF32) {
    // lane: column 16j + xl of the block, channels h, h + 2, ...
    const int xl = lane & 15, h = lane >> 4;
    const int og = g0g + r * GR + XC - F1_SHIFT + 16 * j + xl;
    const int oo = g0o + r * GR + XC - F1_SHIFT + 16 * j + xl;
    float acc[8 * MT];
#pragma unroll
    for (int i = 0; i < 8 * MT; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int dyi = 0; dyi < D; ++dyi) {
      const int ys = y + dyi - MD;
      if (ys < 0 || ys >= H) continue;
      const T* fq = sF + (r + dyi) * cpb * LDF + 16 * j + xl + FP_BWD -
                    F1_SHIFT - MD;
#pragma unroll
      for (int bb = 0; bb < D; ++bb) {
        const int t = dyi * D + bb;
        float gv = sG[og + t * GT];
        if (leaky && !(sO[oo + t * GT] >= 0.f)) gv *= p.leaky;
#pragma unroll
        for (int i = 0; i < 8 * MT; ++i) {
          const int c = 2 * i + h;
          if (c >= nc) break;
          acc[i] = fmaf(gv, fq[c * LDF + bb], acc[i]);
        }
      }
    }
    const int x = xw + xl;
    if (x >= 0 && x < W) {
#pragma unroll
      for (int i = 0; i < 8 * MT; ++i) {
        const int c = 2 * i + h;
        if (c >= nc) break;
        o[c * plane + x] = acc[i] * p.inv_c;
      }
    }
  } else {
    const int gq = lane >> 2, t4 = lane & 3;
    // The lane's B values: n8 tile nt, target column xw + 8 nt + gq, k =
    // 8h + 2 t4 + e of the tile's k16 window at window column 16j + 8nt, so
    // the tap index within a dy row is bb = 8h + 2 t4 + e - gq - (FP_BWD -
    // F1_SHIFT) + MD, within [0, 2 MD] for some k of every column. Element
    // (r, dyi*D + bb, xw + 8nt + gq) lies at at[nt][h][e] + dyi*D*GT. Off
    // the band the lane reads tap dyi*D of its own column instead (in
    // range) and masks the value to 0: no branch.
    const int col0 = r * GR + XC - F1_SHIFT + 16 * j + gq;
    int at[2][2][2];
    uint32_t on_band[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        on_band[nt][hh] = 0u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bb = 8 * hh + 2 * t4 + e - gq - (FP_BWD - F1_SHIFT) + MD;
          const bool in = bb >= 0 && bb <= 2 * MD;
          at[nt][hh][e] = col0 + 8 * nt + (in ? bb * GT : 0);
          on_band[nt][hh] |= in ? 0xffffu << (16 * e) : 0u;
        }
      }
    const T* pg = sG + g0g;
    const T* po = sO + g0o;
    float accp[MT][2][4], accm[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) accp[mt][nt][e] = accm[mt][nt][e] = 0.f;
    // the dy loop stays rolled: a short body keeps the code in the
    // instruction caches
#pragma unroll 1
    for (int dyi = 0; dyi < D; ++dyi) {
      const int ys = y + dyi - MD;
      if (ys < 0 || ys >= H) continue;
      // form M' (M+ and M-) for this dy in registers
      const int dd = dyi * D * GT;
      uint32_t bp[2][2], bm[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t gv = (bits(pg[at[nt][hh][0] + dd]) |
                               bits(pg[at[nt][hh][1] + dd]) << 16) &
                              on_band[nt][hh];
          if (leaky) {
            const uint32_t neg =
                neg_halves(bits(po[at[nt][hh][0] + dd]) |
                               bits(po[at[nt][hh][1] + dd]) << 16,
                           T());
            bp[nt][hh] = gv & ~neg;
            bm[nt][hh] = gv & neg;
          } else {
            bp[nt][hh] = gv;
            bm[nt][hh] = 0u;
          }
        }
      // the products: one k16 step a tile, A = f2's window from column
      // 16j + 8nt
      const T* fq = sF + (r + dyi) * cpb * LDF + 16 * j;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (16 * mt >= nc) break;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t af[4];
          frag_a_rows(af, fq + 16 * mt * LDF + 8 * nt, LDF);
          mma<T>(accp[mt][nt], af, bp[nt][0], bp[nt][1]);
          if (leaky) mma<T>(accm[mt][nt], af, bm[nt][0], bm[nt][1]);
        }
      }
    }
    // each lane's two neighbouring columns in one store where W is even
    const float lk = leaky ? p.leaky : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = 16 * mt + gq + 8 * hh;
          const int x = xw + 8 * nt + 2 * t4;  // even: a pair is in or out
          if (c >= nc || x < 0 || x >= W) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = (accp[mt][nt][2 * hh + e] + lk * accm[mt][nt][2 * hh + e]) *
                   p.inv_c;
          if (W % 2 == 0) {
            store_vec(o + c * plane + x, v, 2);
          } else {
            o[c * plane + x] = from_f32<T>(v[0]);
            if (x + 1 < W) o[c * plane + x + 1] = from_f32<T>(v[1]);
          }
        }
  }
}

template <typename T, int MD, int MT>
int launch_bwd_f1_mt(Bf1Args a, int n, cudaStream_t stream) {
  static int allowed = 0;
  const int smem = bwd_f1_smem_bytes((int)sizeof(T), MD, a.th, a.wj, a.cpb,
                                     a.xtiles == 1);
  if (int e = allow_smem(corr_bwd_f1_kernel<T, MD, MT>, smem, allowed))
    return e;
  const long long blocks = (long long)n * a.ytiles * a.xtiles * a.cblocks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  corr_bwd_f1_kernel<T, MD, MT>
      <<<(unsigned)blocks, 32 * block_warps(a.th * a.wj), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MD>
int launch_bwd_f1_md(Bf1Args a, int n, cudaStream_t stream) {
  if (a.cpb <= 16) return launch_bwd_f1_mt<T, MD, 1>(a, n, stream);
  if (a.cpb <= 32) return launch_bwd_f1_mt<T, MD, 2>(a, n, stream);
  return launch_bwd_f1_mt<T, MD, 4>(a, n, stream);
}

template <typename T>
int launch_bwd_f1(const void* g, const void* out, const void* f2, void* df1,
                  long long g_stride, int n, int c, int h, int w, int md,
                  float leaky, int th, int wj, int cpb, cudaStream_t stream) {
  Bf1Args a;
  a.g = g;
  a.out = out;
  a.f2 = f2;
  a.df1 = df1;
  a.g_stride = g_stride;
  a.C = c;
  a.H = h;
  a.W = w;
  a.inv_c = (float)(1.0 / c);
  a.leaky = leaky;
  a.th = th;
  a.wj = wj;
  a.cpb = cpb;
  a.ytiles = (h + th - 1) / th;
  a.xtiles = (w + F1_SHIFT + 16 * wj - 1) / (16 * wj);
  a.cblocks = (c + cpb - 1) / cpb;
  a.by_cpb = fast_div(cpb);
  const int r2 = th + 2 * md < h ? th + 2 * md : h;
  a.gt = f1_run_pitch(th * w, (th - 1) * w + 16 * wj - F1_SHIFT,
                      (long long)h * w);
  a.fct = f1_run_pitch(r2 * w, 0, (long long)h * w);
  if (a.xtiles == 1 && (a.gt > f1_tap_elems(th, wj) ||
                        a.fct * cpb > f1_run_elems(md, th, wj, cpb)))
    return (int)cudaErrorInvalidValue;
  const int es = (int)sizeof(T);
  const long long dd = (long long)(2 * md + 1) * (2 * md + 1);
  a.vf = copy_width(f2, (long long)c * h * w, w, es, 16 / es);
  a.vg = copy_width(g, g_stride, w, es, 16 / es);
  if (out != nullptr) {
    const int vo = copy_width(out, dd * h * w, w, es, 16 / es);
    a.vg = vo < a.vg ? vo : a.vg;
  }
  switch (md) {
    case 1:
      return launch_bwd_f1_md<T, 1>(a, n, stream);
    case 2:
      return launch_bwd_f1_md<T, 2>(a, n, stream);
    case 3:
      return launch_bwd_f1_md<T, 3>(a, n, stream);
    case 4:
      return launch_bwd_f1_md<T, 4>(a, n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int n, int c, int h, int w, int md) {
  return n <= 0 || c <= 0 || h <= 0 || w <= 0 || md < 1 || md > 4;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16. The tiling (th, wj, ndg, kc) comes
// from ops/correlation.py::corr_plan: th output rows, 16*wj columns and
// ndg groups of 3 dy rows a block, kc channels (a multiple of 16) a
// cluster rank, ceil(c / kc) <= 8 ranks, 32*th*wj*ndg <= 512 threads.
// Returns the launch's error (0 on success); nothing is synchronised or
// allocated here.
extern "C" int mfn_corr_fwd(const void* f1, const void* f2, void* out, int n,
                            int c, int h, int w, int md, int dtype,
                            float leaky, int use_leaky, int th, int wj,
                            int ndg, int kc, void* stream) {
  if (bad_shape(n, c, h, w, md) || th < 1 || wj < 1 || ndg < 1 ||
      kc < 16 || kc % 16 || (c + kc - 1) / kc > MAX_CLUSTER ||
      th * wj * ndg > FWD_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(f1, f2, out, n, c, h, w, md, leaky, use_leaky,
                               th, wj, ndg, kc, s);
    case 1:
      return launch_fwd<bf16>(f1, f2, out, n, c, h, w, md, leaky, use_leaky,
                              th, wj, ndg, kc, s);
    case 2:
      return launch_fwd<__half>(f1, f2, out, n, c, h, w, md, leaky,
                                use_leaky, th, wj, ndg, kc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// g: (N, D*D, H, W) images g_stride elements apart, each a dense block;
// out (the forward's saved output, NULL without the LeakyReLU: leaky
// unread): dense (N, D*D, H, W); f2 / f1 and the result: dense (N, C, H, W);
// one dtype (0 = f32, 1 = bf16, 2 = f16). The tiling (th, wj, cpb) comes
// from corr_plan: th target rows and 16*wj columns a block, cpb channels (a
// multiple of 16, <= 64) a block, th*wj <= 8 warps. Return as mfn_corr_fwd.
extern "C" int mfn_corr_bwd_f1(const void* g, const void* out, const void* f2,
                               void* df1, int n, int c, int h, int w, int md,
                               int dtype, float leaky, long long g_stride,
                               int th, int wj, int cpb, void* stream) {
  if (bad_shape(n, c, h, w, md) || th < 1 || wj < 1 || cpb < 16 ||
      cpb > 64 || cpb % 16 || th * wj > F1_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd_f1<float>(g, out, f2, df1, g_stride, n, c, h, w, md,
                                  leaky, th, wj, cpb, s);
    case 1:
      return launch_bwd_f1<bf16>(g, out, f2, df1, g_stride, n, c, h, w, md,
                                 leaky, th, wj, cpb, s);
    case 2:
      return launch_bwd_f1<__half>(g, out, f2, df1, g_stride, n, c, h, w, md,
                                   leaky, th, wj, cpb, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As mfn_corr_bwd_f1, with f1 in place of f2 and th*wj <= 4 warps.
extern "C" int mfn_corr_bwd_f2(const void* g, const void* out, const void* f1,
                               void* df2, int n, int c, int h, int w, int md,
                               int dtype, float leaky, long long g_stride,
                               int th, int wj, int cpb, void* stream) {
  if (bad_shape(n, c, h, w, md) || th < 1 || wj < 1 || cpb < 16 ||
      cpb > 64 || cpb % 16 || th * wj > BWD_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd_f2<float>(g, out, f1, df2, g_stride, n, c, h, w, md,
                                  leaky, th, wj, cpb, s);
    case 1:
      return launch_bwd_f2<bf16>(g, out, f1, df2, g_stride, n, c, h, w, md,
                                 leaky, th, wj, cpb, s);
    case 2:
      return launch_bwd_f2<__half>(g, out, f1, df2, g_stride, n, c, h, w, md,
                                   leaky, th, wj, cpb, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory (bytes) a launch takes: kind 0 the forward (a..d =
// th, wj, ndg, kc), kind 1 corr_bwd_f2 (a..c = th, wj, cpb) and kind 2
// corr_bwd_f1 (a..d = th, wj, cpb, whether one column tile spans the
// image); esize the element size (4 or 2). ops/correlation.py computes the
// same.
extern "C" int mfn_corr_smem_bytes(int kind, int esize, int md, int a, int b,
                                   int c, int d) {
  return kind == 0   ? fwd_smem_bytes(esize, md, a, b, c, d)
         : kind == 1 ? bwd_smem_bytes(esize, md, a, b, c)
                     : bwd_f1_smem_bytes(esize, md, a, b, c, d);
}

extern "C" const char* mfn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
