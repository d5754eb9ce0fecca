// Flow-guided deformable 3x3 convolution -- the Hopper (sm_90a) kernels of
// maskflownet_torch: the forward (deform_fwd_kernel) and the backward
// (deform_bwd_data_kernel for dx and the flow, deform_bwd_weight_kernel for
// the weight), with one fixed-order reduction kernel for split sums and two
// transposes (x to NHWC, dx back to NCHW).
//
//   out[n, o, y, x] = sum_{ky, kx in 0..2} sum_c w9[ky*3 + kx, c, o] *
//                     bilinear(x[n, c], sy[n,y,x] + ky - 1, sx[n,y,x] + kx - 1)
//
// with (sy, sx) = (y + dy, x + dx) the sample point of the window's centre,
// out-of-image bilinear corners contributing zero. All nine taps share one
// fractional offset (fy, fx) = (sy - floor(sy), sx - floor(sx)), so their 36
// corners are the 4x4 integer window at rows floor(sy) - 1 .. + 2 and
// columns floor(sx) - 1 .. + 2, gathered once per pixel and channel; tap
// (a, b) interpolates the window's corners (a..a+1, b..b+1). x and w9 are f32
// or bf16 (w9 (9, Cin, Cout) tap major, rows `pitch` elements apart, pitch a
// multiple of 8), sy/sx (N, H, W) f32, out (N, Cout, H, W) in x's dtype. The
// gradients are f32: dx (N, Cin, H, W), dflow (2, N, H, W) (dsy, dsx: the
// flow's two channels), dw (9, Cin, Cout). The flow gradient is the
// floor-based one of the gather form: d tap / d sy = d tap / d fy.
//
// Replaces maskflownet_tpu/ops/pallas/deform.py::_fwd_kernel (forward) and
// ::_bwd_kernel (backward). They interpolate rows with one-hot matrices on
// the MXU over a whole zero-padded image held in VMEM, carry dx and dweight
// across the sequential grid, and take the slope -sign(s - i) of the one-hot
// weights, which is 0 at an integer coordinate. None of that carries over:
// the window is read straight from global memory with a clamped index and a
// zero for out-of-image corners, blocks run in parallel, and the flow
// gradient follows the floor-based derivative of maskflownet_torch's gather
// and warpconv forms (the Pallas one drops it at integer flows).
//
// Every contraction is an implicit GEMM over P = N*H*W pixels and K = 9*Cin
// tap rows, taken in chunks of 16 input channels (144 rows, k = tap * 16 +
// channel: nine k16 steps, one a tap):
//   forward  out[P x Cout]  = T[P x 9Cin] . W9[9Cin x Cout]
//   dtap     dtap[P x 9Cin] = G[P x Cout] . W9^T          (dx, dflow)
//   dweight  dW[9Cin x Cout] = T^T . G                     (depth P)
// T, the bilinear taps, is formed in f32 from each 4x4 window once per
// (pixel, channel) of a tile and written straight into the MMA's operand
// layout in shared memory (rows 152 elements apart: 304 bytes, so the eight
// 16-byte rows of an ldmatrix land on distinct banks; every other operand
// tile is padded the same way). The bf16 products run on the tensor cores
// with mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix, chosen
// over wgmma: these GEMMs are narrow (Cout 32-196, tiles of 32 pixels)
// and fed by a gather, so they never approach wgmma's 64-row, 989 TFLOP/s
// regime, and mma.sync keeps every tile shape, the f32 path and the
// epilogues in one fragment layout. The f32 instantiation runs the same
// tiles, grids and fragment layout with CUDA-core FMAs (fma_16x8x16): exact
// f32, only the parity checks run it. Precision of the bf16 path:
//   * forward and dweight: the f32 taps are split into bf16 hi + lo = t -
//     hi, both through the MMA (two products), leaving <= 2^-18 of each tap;
//     the weights and g are bf16 already, so every product is exact and
//     every sum f32; out is cast once on store. (One bf16 rounding of the
//     taps alone reads 7.4e-3 of the largest output against the plain
//     pair, next to the 8e-3 tolerance of a bf16 output; hi + lo 4.2e-3,
//     the output's own rounding.)
//   * dtap: g and w9 are both bf16, so each product is exact in f32.
// Split sums (forward over K, dflow over channel chunks, dweight over pixel
// ranges) go to f32 partial buffers that deform_reduce_kernel adds in a
// fixed order: every result is deterministic except dx, whose 16 corners a
// (pixel, channel) scatter with f32 atomics (the flow is arbitrary, so the
// inverse map is not local), and only when dx is asked for.
//
// What bounds it on an H100: on paper bytes at every level of the paths
// (9*Cin*Cout multiply-adds a pixel against 2*(Cin + Cout) bytes of bf16
// I/O: ~72 flops a byte at Cin = Cout = 32, ~290 at 128, the ridge); in
// practice the gather (16 corners a pixel and channel, at scattered
// places), dx's 16 f32 atomics a pixel and channel, and at the coarse
// levels the latency of a few dependent steps a block. The tensor cores
// run at a few percent. What the design does about it:
//   * the windows come from an NHWC copy of x (to_nhwc_kernel, Cp = Cin
//     rounded up to 16, the padding zero): a corner's channels of a chunk
//     lie side by side, so the threads of a pixel read one 32-byte sector
//     a corner where the NCHW planes cost one a channel and row (on an
//     H100 the NCHW gather, per lane, as aligned 8-byte row words or by a
//     whole warp, measured slower in every kernel);
//   * dx is accumulated in an NHWC buffer by 2- or 4-channel vector
//     atomics, then transposed (from_nhwc_kernel);
//   * the weight kernel runs on a second stream beside the data kernel
//     (both only read), fork and join by events.
// The kernels:
//   * forward: a block owns 32 pixels x 32*NI output channels (4 warps
//     side by side over the channels) and a range of K chunks. The taps are
//     double buffered: chunk k+1's windows are loaded while chunk k's MMAs
//     run; its weights arrive by cp.async into one buffer after a barrier
//     (a second weight buffer cost a block a multiprocessor and measured
//     slower). The plan (ops/deform.py::deform_plan) splits K until a
//     level launches two blocks a multiprocessor or every chunk is split:
//     on 132 SMs the MaskFlownet_S step's L5..L2 launch 280, 280, 560, 2240
//     blocks (L5 in 8 K splits, L4 in 2), the cascade's level 6 (4x196x7x16)
//     364 (2 column tiles x 13 K splits), its train step's 208.
//   * dx and dflow: a block owns one chunk of 16 channels, its 144 weight
//     rows resident in shared memory, and walks one or two 32-pixel tiles:
//     the cotangent tile is staged, dtap = G . W9^T comes off the tensor
//     cores into shared memory, then each thread takes a pixel and 4
//     channels: the flow's share (the taps' derivatives in fy and fx,
//     summed over channels in a fixed order, one partial per chunk) and
//     dx's shares. S step L5..L2: 280, 840, 1120, 2240 blocks; level 6: 182.
//   * dweight: a block owns one chunk (144 rows) x up to 128 output
//     channels (all of Cout but at level 6, which takes two column tiles)
//     and 3 (from 1024 tiles on, 8) 32-pixel tiles (split K): the taps (hi,
//     lo) and the cotangent of each tile are formed once for all its
//     columns, double buffered, the next tile's loads in flight during the
//     MMAs; partial sums are written once per block, at most 32 MiB of them
//     a call. S step L5..L2: 96, 282, 748, 560 blocks; level 6: 130.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CCH = 16;           // input channels per K chunk
constexpr int KCH = 9 * CCH;      // K rows per chunk: tap * CCH + channel
constexpr int TS = KCH + 8;       // tap tile row stride, elements (304 B bf16)
constexpr int MAX_COUT = 256;
constexpr int FWD_THREADS = 128;
constexpr int DATA_THREADS = 128;
constexpr int DW_THREADS = 256;
constexpr int DW_BP = 32;         // dweight: pixels a tile (two k16 steps)
constexpr int DW_GS = DW_BP + 8;  // dweight: cotangent tile row stride
constexpr int DATA_DS = KCH + 1;  // dx/dflow: dtap row stride (f32, odd)
// m16 tiles a forward / data-kernel block: 32-pixel tiles measured as fast
// as 16-pixel ones or faster at every level
constexpr int FWD_MI = 2;
constexpr int DATA_MI = 2;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

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

template <typename T>
constexpr bool kIsBf16 = sizeof(T) == 2;

// ---------------------------------------------------------------------------
// PTX: ldmatrix, mma.sync, cp.async

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// c (the lane's four f32 of a 16x8 tile) += A (16x16) . B (16x8), bf16 in.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Fragments from shared memory for mma.sync m16n8k16 (lane l; the four 8x8
// matrices of an .x4 take their row addresses from lanes 0-7, 8-15, 16-23,
// 24-31). A is 16 (rows) x 16 (k), B is 16 (k) x 8 (n) a tile.
// A(r, k) at base[r * ld + k]:
__device__ __forceinline__ void frag_a_rows(uint32_t a[4], const bf16* base,
                                            int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, base + (l & 15) * ld + (l >> 4) * 8);
}
// A(r, k) at base[k * ld + r]:
__device__ __forceinline__ void frag_a_cols(uint32_t a[4], const bf16* base,
                                            int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(a, base + ((l & 7) + (l >> 4) * 8) * ld + ((l >> 3) & 1) * 8);
}
// Two n8 tiles (b[0..1]: n 0-7, b[2..3]: n 8-15), B(k, n) at base[k*ld + n]:
__device__ __forceinline__ void frag_b2_krows(uint32_t b[4], const bf16* base,
                                              int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, base + (l & 15) * ld + (l >> 4) * 8);
}
// One n8 tile, B(k, n) at base[k * ld + n] (lanes 0-15 address):
__device__ __forceinline__ void frag_b1_krows(uint32_t b[2], const bf16* base,
                                              int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x2_t(b, base + (l & 15) * ld);
}
// Two n8 tiles, B(k, n) at base[n * ld + k]:
__device__ __forceinline__ void frag_b2_nrows(uint32_t b[4], const bf16* base,
                                              int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, base + ((l & 7) + (l >> 4) * 8) * ld + ((l >> 3) & 1) * 8);
}
// One n8 tile, B(k, n) at base[n * ld + k]:
__device__ __forceinline__ void frag_b1_nrows(uint32_t b[2], const bf16* base,
                                              int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x2(b, base + (l & 7) * ld + ((l >> 3) & 1) * 8);
}

// The f32 counterpart of one mma_bf16 on the CUDA cores, in its fragment
// layout: c += A . B with A(r, k) = a[r * ar + k * ak], B(k, n) = b[k * bk +
// n * bn], lane (g, t) = (l / 4, l % 4) holding rows g, g + 8 x columns 2t,
// 2t + 1.
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

// ---------------------------------------------------------------------------
// The window and its taps

// The window's integer corner and the fractions. The fractions come from
// the unclamped floor; the corner is clamped to [-4, H + 1] x [-4, W + 1]
// first, so that a far-away coordinate converts to an int safely and its
// window (rows y0 - 1 .. y0 + 2) still lies wholly outside the image.
__device__ __forceinline__ void corner(float sy, float sx, int H, int W,
                                       int& y0, int& x0, float& fy,
                                       float& fx) {
  const float y0f = floorf(sy);
  const float x0f = floorf(sx);
  fy = sy - y0f;
  fx = sx - x0f;
  y0 = (int)fminf(fmaxf(y0f, -4.0f), (float)(H + 1));
  x0 = (int)fminf(fmaxf(x0f, -4.0f), (float)(W + 1));
}

__device__ __forceinline__ float tap(const float v[4][4], int a, int b,
                                     float fy, float fx) {
  const float r0 = (1.0f - fx) * v[a][b] + fx * v[a][b + 1];
  const float r1 = (1.0f - fx) * v[a + 1][b] + fx * v[a + 1][b + 1];
  return (1.0f - fy) * r0 + fy * r1;
}

// One pixel of a tile: its image, its window's corner and fractions. A
// pixel past P is not live (and loads nothing).
struct Pixel {
  int n, y0, x0;
  float fy, fx;
  bool live;
};

__device__ __forceinline__ Pixel pixel_at(long long q, long long P, int H,
                                          int W, const float* __restrict__ sy,
                                          const float* __restrict__ sx) {
  Pixel px;
  const int HW = H * W;
  px.live = q < P;
  const long long qq = px.live ? q : 0;
  px.n = (int)(qq / HW);
  corner(sy[qq], sx[qq], H, W, px.y0, px.x0, px.fy, px.fx);
  return px;
}

// Pixel q's cotangent at channel 0 (channels HW apart), nullptr past P.
template <typename T>
__device__ __forceinline__ const T* g_column(const T* __restrict__ g,
                                             long long q, long long P,
                                             int HW, int Cout) {
  if (q >= P) return nullptr;
  const int n = (int)(q / HW);
  return g + (size_t)n * Cout * HW + (q - (long long)n * HW);
}

// The windows are gathered from an NHWC copy of x (xt: Cp = Cin rounded
// up to 16 channels a pixel, the padding zero), so that the channels of a
// chunk lie side by side: a thread loads CPT neighbouring channels of a
// corner in one 4-16 byte load, and the GPP = 16 / CPT threads of a pixel
// read one 32-byte sector a corner where the NCHW planes cost a sector a
// channel and row. dx is accumulated in an NHWC buffer the same way (CPT
// channels an atomic) and transposed back.

// xt[n][p][c] = x[n][c][p] for c < C, zero for C <= c < Cp: 32 x 32 tiles
// through shared memory, reads and writes coalesced. Grid (HW / 32, Cp /
// 32, N), block (32, 8).
template <typename T>
__global__ void to_nhwc_kernel(const T* __restrict__ x, T* __restrict__ xt,
                               int C, int HW, int Cp) {
  __shared__ float tile[32][33];
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i;
    const int p = p0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (c < C && p < HW) ? to_f32(x[((size_t)n * C + c) * HW + p]) : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int p = p0 + i;
    const int c = c0 + threadIdx.x;
    if (p < HW && c < Cp)
      xt[((size_t)n * HW + p) * Cp + c] = from_f32<T>(tile[threadIdx.x][i]);
  }
}

// dx[n][c][p] = dxt[n][p][c] for c < C. Grid (HW / 32, C / 32, N).
__global__ void from_nhwc_kernel(const float* __restrict__ dxt,
                                 float* __restrict__ dx, int C, int HW,
                                 int Cp) {
  __shared__ float tile[32][33];
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int p = p0 + i;
    const int c = c0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (p < HW && c < C) ? dxt[((size_t)n * HW + p) * Cp + c] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i;
    const int p = p0 + threadIdx.x;
    if (c < C && p < HW) dx[((size_t)n * C + c) * HW + p] = tile[threadIdx.x][i];
  }
}

// CPT neighbouring channels' 4x4 windows at one pixel as loaded: corner k
// = u * 4 + t in NW 32-bit words (zero outside the image).
template <typename T, int CPT>
struct Win {
  static constexpr int NW = CPT * (int)sizeof(T) / 4;
  uint32_t w[16][NW];
};

template <int NW>
__device__ __forceinline__ void ld_words(uint32_t* d, const void* p) {
  if constexpr (NW == 1) {
    d[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (NW == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    d[0] = v.x;
    d[1] = v.y;
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// The window of channels c .. c + CPT - 1 of the pixel whose image starts
// at xn (NHWC, Cp channels a pixel) and whose corner is (y0, x0). Every
// load is in bounds (clamped index); a dead pixel loads nothing.
template <typename T, int CPT>
__device__ __forceinline__ void load_win(Win<T, CPT>& win,
                                         const T* __restrict__ xn, int Cp,
                                         int H, int W, int y0, int x0, int c,
                                         bool live) {
  constexpr int NW = Win<T, CPT>::NW;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int yy = y0 - 1 + u;
    const bool vy = live && yy >= 0 && yy < H;
    const int row = min(max(yy, 0), H - 1) * W;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int xx = x0 - 1 + t;
      uint32_t* d = win.w[u * 4 + t];
      if (vy && xx >= 0 && xx < W) {
        ld_words<NW>(d, xn + (size_t)(row + min(max(xx, 0), W - 1)) * Cp + c);
      } else {
#pragma unroll
        for (int i = 0; i < NW; ++i) d[i] = 0u;
      }
    }
  }
}

// Channel j of a loaded window, as f32.
template <typename T, int CPT>
__device__ __forceinline__ void win_channel(const Win<T, CPT>& win, int j,
                                            float v[4][4]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if constexpr (kIsBf16<T>) {
      const uint32_t w = win.w[k][j >> 1];
      v[k / 4][k % 4] = __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
    } else {
      v[k / 4][k % 4] = __uint_as_float(win.w[k][j]);
    }
  }
}

// p[0 .. CPT) += v[0 .. CPT): one vector atomic where the card has it
// (CUDA 12.1+ on sm_90: float2/float4 atomicAdd on global memory).
template <int CPT>
__device__ __forceinline__ void atomic_add_vec(float* p, const float* v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  if constexpr (CPT == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
    return;
  } else if constexpr (CPT == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
    return;
  }
#endif
#pragma unroll
  for (int j = 0; j < CPT; ++j) atomicAdd(p + j, v[j]);
}

// The nine taps of a window, hi (and lo = t - hi in bf16) at row[tap * CCH]
// (lo at row[lo_off + tap * CCH]).
template <typename T>
__device__ __forceinline__ void store_taps(const float v[4][4], float fy,
                                           float fx, T* row, int lo_off) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float t = tap(v, a, b, fy, fx);
      const T h = from_f32<T>(t);
      row[(a * 3 + b) * CCH] = h;
      if constexpr (kIsBf16<T>)
        row[lo_off + (a * 3 + b) * CCH] = from_f32<T>(t - to_f32(h));
    }
}

// The taps of every channel of a loaded window, channel j at row[j].
template <typename T, int CPT>
__device__ __forceinline__ void store_win_taps(const Win<T, CPT>& win,
                                               float fy, float fx, T* row,
                                               int lo_off) {
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    float v[4][4];
    win_channel(win, j, v);
    store_taps<T>(v, fy, fx, row + j, lo_off);
  }
}

// Rows [chunk * CCH, + CCH) x tap of w9 into shared memory: dst[k * ld + j]
// = w9[tap, c, col0 + j] for k = tap * CCH + (c - chunk * CCH), j < cols
// (a multiple of 16 bytes' worth of elements), zero past Cin and Cout.
// Whole 16-byte pieces go by cp.async (the caller commits and waits); a
// piece that straddles Cout is copied element by element, so the row
// padding of w9 is never read.
template <typename T, int NT>
__device__ __forceinline__ void stage_w9(const T* __restrict__ w9, int pitch,
                                         int chunk, int Cin, int Cout,
                                         int col0, int cols, T* dst, int ld) {
  constexpr int EPP = 16 / sizeof(T);
  const int ppr = cols / EPP;
  for (int idx = threadIdx.x; idx < KCH * ppr; idx += NT) {
    const int k = idx / ppr;
    const int j = idx - k * ppr;
    const int t = k / CCH;
    const int c = chunk * CCH + k - t * CCH;
    const int col = col0 + j * EPP;
    T* d = dst + k * ld + j * EPP;
    const T* s = w9 + ((size_t)t * Cin + (c < Cin ? c : 0)) * pitch + col;
    if (c < Cin && col + EPP <= Cout) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < EPP; ++e)
        d[e] = (c < Cin && col + e < Cout) ? s[e] : from_f32<T>(0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward

template <typename T, int MI, int NI>
constexpr int fwd_smem_bytes() {
  return (2 * (kIsBf16<T> ? 2 : 1) * 16 * MI * TS + KCH * (32 * NI + 8)) *
         (int)sizeof(T);
}

// Block (pixel tile, column tile, K split): 16*MI pixels x 32*NI output
// channels (warp w: columns w*8*NI ..), chunks [z * cps, + cps). Thread t
// gathers pixel t / GPP of the tile, channels (t % GPP) * CPT .. + CPT of
// each chunk, from xt (NHWC). The taps are stored hi (and, bf16, lo = t -
// hi) and both go through the MMA, so the sum is within ~2^-18 of f32's.
// Without a K split (gridDim.z == 1) out is written in T, else this split's
// f32 partial sums (partial[z] laid out as out).
template <typename T, int MI, int NI>
__global__ void __launch_bounds__(FWD_THREADS)
    deform_fwd_kernel(const T* __restrict__ xt, const float* __restrict__ sy,
                      const float* __restrict__ sx, const T* __restrict__ w9,
                      int pitch, T* __restrict__ out,
                      float* __restrict__ partial, int Cin, int Cp, int H,
                      int W, int Cout, long long P, int cps) {
  constexpr bool kBf16 = kIsBf16<T>;
  constexpr int BM = 16 * MI;
  constexpr int BN = 32 * NI;
  constexpr int WS = BN + 8;
  constexpr int CPT = BM * CCH / FWD_THREADS;  // channels a thread: 2 * MI
  constexpr int GPP = CCH / CPT;                 // threads a pixel
  constexpr int TAPS = (kBf16 ? 2 : 1) * BM * TS;  // a buffer: hi[, lo]
  extern __shared__ float4 dyn_smem[];
  T* taps = reinterpret_cast<T*>(dyn_smem);  // [2][hi | lo]
  T* wts = taps + 2 * TAPS;                  // [KCH][WS]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HW = H * W;
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nchunks = (Cin + CCH - 1) / CCH;
  const int k_begin = blockIdx.z * cps;
  const int k_end = min(nchunks, k_begin + cps);

  const int gp = tid / GPP;
  const int gc = (tid % GPP) * CPT;
  const Pixel px = pixel_at(p0 + gp, P, H, W, sy, sx);
  const T* xn = xt + (size_t)px.n * HW * Cp;
  auto issue = [&](int chunk, Win<T, CPT>& win) {
    load_win(win, xn, Cp, H, W, px.y0, px.x0, chunk * CCH + gc, px.live);
  };
  auto finish = [&](const Win<T, CPT>& win, T* tb) {
    store_win_taps(win, px.fy, px.fx, tb + gp * TS + gc, BM * TS);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  stage_w9<T, FWD_THREADS>(w9, pitch, k_begin, Cin, Cout, n0, BN, wts, WS);
  cp_async_commit();
  {
    Win<T, CPT> win;
    issue(k_begin, win);
    finish(win, taps);
  }

  for (int k = k_begin; k < k_end; ++k) {
    const int b = (k - k_begin) & 1;
    cp_async_wait_all();
    __syncthreads();
    const bool next = k + 1 < k_end;
    const T* tb = taps + b * TAPS;
    const T* wb = wts + warp * 8 * NI;
    // the next chunk's windows are in flight during this chunk's MMAs
    Win<T, CPT> win;
    if (next) issue(k + 1, win);
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if constexpr (kBf16) {
        uint32_t ah[MI][4], al[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          frag_a_rows(ah[i], tb + 16 * i * TS + s * CCH, TS);
          frag_a_rows(al[i], tb + BM * TS + 16 * i * TS + s * CCH, TS);
        }
#pragma unroll
        for (int j = 0; j + 1 < NI; j += 2) {
          uint32_t bf[4];
          frag_b2_krows(bf, wb + s * CCH * WS + j * 8, WS);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_bf16(acc[i][j], ah[i], bf[0], bf[1]);
            mma_bf16(acc[i][j], al[i], bf[0], bf[1]);
            mma_bf16(acc[i][j + 1], ah[i], bf[2], bf[3]);
            mma_bf16(acc[i][j + 1], al[i], bf[2], bf[3]);
          }
        }
        if constexpr (NI & 1) {
          uint32_t bf[2];
          frag_b1_krows(bf, wb + s * CCH * WS + (NI - 1) * 8, WS);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_bf16(acc[i][NI - 1], ah[i], bf[0], bf[1]);
            mma_bf16(acc[i][NI - 1], al[i], bf[0], bf[1]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
            fma_16x8x16(acc[i][j], tb + 16 * i * TS + s * CCH, TS, 1,
                        wb + s * CCH * WS + j * 8, WS, 1);
      }
    }
    if (next) {
      finish(win, taps + (b ^ 1) * TAPS);
      __syncthreads();
      stage_w9<T, FWD_THREADS>(w9, pitch, k + 1, Cin, Cout, n0, BN, wts, WS);
      cp_async_commit();
    }
  }

  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long q = p0 + 16 * i + g8 + 8 * h;
      if (q >= P) continue;
      const int n = (int)(q / HW);
      const size_t base = (size_t)n * Cout * HW + (size_t)(q - (long long)n * HW);
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + warp * 8 * NI + j * 8 + 2 * t4 + e;
          if (co >= Cout) continue;
          const float val = acc[i][j][2 * h + e];
          const size_t o = base + (size_t)co * HW;
          if (split)
            partial[(size_t)blockIdx.z * P * Cout + o] = val;
          else
            out[o] = from_f32<T>(val);
        }
    }
}

// out[i] = sum over the S partials in order (deterministic), cast once.
template <typename T>
__global__ void deform_reduce_kernel(const float* __restrict__ partial,
                                     T* __restrict__ out, int S,
                                     long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
  for (int z = 0; z < S; ++z) s += partial[(size_t)z * count + i];
  out[i] = from_f32<T>(s);
}

// ---------------------------------------------------------------------------
// Backward: dx and dflow

template <typename T, int MI>
constexpr int data_smem_bytes(int cout) {
  const int cp = (cout + 15) / 16 * 16;
  return (KCH * (cp + 8) + cp * (16 * MI + 8)) * (int)sizeof(T) +
         (16 * MI * DATA_DS + 2 * DATA_THREADS) * (int)sizeof(float);
}

// Block (pixel-tile group, chunk): the chunk's 144 rows of w9 stay in
// shared memory while the block walks tiles [x * tpg, + tpg) of 16*MI
// pixels. A tile: the cotangent (Cout x BM) staged, dtap (BM x 144) =
// G . W9^T by the 4 warps (warp w: column pairs w, w + 4, w + 8 of 16), then
// thread t takes pixel t / GPP with channels (t % GPP) * CPT .. + CPT: the
// flow's share (windows from xt, NHWC) summed over its channels, then over
// the pixel's threads in order, written as this chunk's partial
// (dflow[chunk][2][P]; dflow itself when there is one chunk); dx's shares
// by CPT-wide atomics into dxt (NHWC, Cp channels, zeroed by the caller).
template <typename T, int MI>
__global__ void __launch_bounds__(DATA_THREADS)
    deform_bwd_data_kernel(const T* __restrict__ xt,
                           const float* __restrict__ sy,
                           const float* __restrict__ sx,
                           const T* __restrict__ w9, int pitch,
                           const T* __restrict__ g, float* __restrict__ dxt,
                           float* __restrict__ dflow, int Cin, int Cp, int H,
                           int W, int Cout, long long P, int tpg) {
  constexpr int BM = 16 * MI;
  constexpr int GS = BM + 8;
  constexpr int RPT = DATA_THREADS / BM;        // cotangent rows a pass
  constexpr int CPT = BM * CCH / DATA_THREADS;  // channels a thread: 2 * MI
  constexpr int GPP = CCH / CPT;                // threads a pixel
  const int CP = (Cout + 15) / 16 * 16;
  const int WS = CP + 8;
  extern __shared__ float4 dyn_smem[];
  T* wts = reinterpret_cast<T*>(dyn_smem);                   // [KCH][WS]
  T* gt = wts + KCH * WS;                                     // [CP][GS]
  float* dt = reinterpret_cast<float*>(gt + CP * GS);         // [BM][DS]
  float* red = dt + BM * DATA_DS;                             // [2][128]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HW = H * W;
  const int chunk = blockIdx.y;
  const long long tiles = (P + BM - 1) / BM;
  const long long t_begin = (long long)blockIdx.x * tpg;
  const long long t_end = min(tiles, t_begin + tpg);
  const bool need_flow = dflow != nullptr;
  const int gq = tid % BM;    // the cotangent column this thread stages
  const int gp = tid / GPP;   // the pixel whose pairs it takes
  const int gc = (tid % GPP) * CPT;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;

  stage_w9<T, DATA_THREADS>(w9, pitch, chunk, Cin, Cout, 0, CP, wts, WS);
  cp_async_commit();

  for (long long tile = t_begin; tile < t_end; ++tile) {
    const long long p0 = tile * BM;
    const Pixel px = pixel_at(p0 + gp, P, H, W, sy, sx);
    {
      const T* gcol = g_column(g, p0 + gq, P, HW, Cout);
      for (int co = tid / BM; co < CP; co += RPT)
        gt[co * GS + gq] = (gcol != nullptr && co < Cout)
                               ? gcol[(size_t)co * HW]
                               : from_f32<T>(0.0f);
    }
    cp_async_wait_all();
    __syncthreads();

    float acc[MI][3][2][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][h][e] = 0.0f;
    for (int ks = 0; ks < CP / 16; ++ks) {
      if constexpr (kIsBf16<T>) {
        uint32_t af[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          frag_a_cols(af[i], gt + 16 * ks * GS + 16 * i, GS);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int pr = warp + 4 * j;
          if (pr < 9) {
            uint32_t bf[4];
            frag_b2_nrows(bf, wts + 16 * pr * WS + 16 * ks, WS);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
              mma_bf16(acc[i][j][0], af[i], bf[0], bf[1]);
              mma_bf16(acc[i][j][1], af[i], bf[2], bf[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int pr = warp + 4 * j;
          if (pr < 9) {
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                fma_16x8x16(acc[i][j][h], gt + 16 * ks * GS + 16 * i, 1, GS,
                            wts + (16 * pr + 8 * h) * WS + 16 * ks, 1, WS);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int pr = warp + 4 * j;
      if (pr >= 9) continue;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              dt[(16 * i + g8 + 8 * r) * DATA_DS + 16 * pr + 8 * h + 2 * t4 +
                 e] = acc[i][j][h][2 * r + e];
    }
    __syncthreads();

    float ay = 0.0f, ax = 0.0f;
    const float fy = px.fy, fx = px.fx;
    float d[CPT][9];
#pragma unroll
    for (int j = 0; j < CPT; ++j)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        d[j][t] = dt[gp * DATA_DS + t * CCH + gc + j];
    if (need_flow) {
      Win<T, CPT> win;
      load_win(win, xt + (size_t)px.n * HW * Cp, Cp, H, W, px.y0, px.x0,
               chunk * CCH + gc, px.live);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float v[4][4];
        win_channel(win, j, v);
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const float dd = d[j][a * 3 + b];
            ay += dd * ((1.0f - fx) * (v[a + 1][b] - v[a][b]) +
                        fx * (v[a + 1][b + 1] - v[a][b + 1]));
            ax += dd * ((1.0f - fy) * (v[a][b + 1] - v[a][b]) +
                        fy * (v[a + 1][b + 1] - v[a + 1][b]));
          }
      }
    }
    if (dxt != nullptr && px.live) {
      float* xn = dxt + (size_t)px.n * HW * Cp + chunk * CCH + gc;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int yy = px.y0 - 1 + u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int xx = px.x0 - 1 + t;
          float sh[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            float acc_s = 0.0f;
#pragma unroll
            for (int a = u - 1; a <= u; ++a)
#pragma unroll
              for (int b = t - 1; b <= t; ++b)
                if (a >= 0 && a <= 2 && b >= 0 && b <= 2)
                  acc_s += d[j][a * 3 + b] * ((a == u ? 1.0f - fy : fy) *
                                              (b == t ? 1.0f - fx : fx));
            sh[j] = acc_s;
          }
          if (yy >= 0 && yy < H && xx >= 0 && xx < W)
            atomic_add_vec<CPT>(xn + (size_t)(yy * W + xx) * Cp, sh);
        }
      }
    }
    if (need_flow) {
      red[tid] = ay;
      red[DATA_THREADS + tid] = ax;
      __syncthreads();
      if (tid < BM && p0 + tid < P) {
        float ty = 0.0f, tx = 0.0f;
#pragma unroll
        for (int r = 0; r < GPP; ++r) {
          ty += red[tid * GPP + r];
          tx += red[DATA_THREADS + tid * GPP + r];
        }
        const long long q = p0 + tid;
        dflow[((size_t)chunk * 2) * P + q] = ty;
        dflow[((size_t)chunk * 2 + 1) * P + q] = tx;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dweight

template <typename T, int NWN, int WM>
constexpr int dw_smem_bytes() {
  constexpr int bn = 8 * NWN * (8 / WM);
  return 2 * ((kIsBf16<T> ? 2 : 1) * DW_BP * TS + bn * DW_GS) *
         (int)sizeof(T);
}

// Block (chunk, column tile, split): rows k of the chunk (m16 tile m = tap
// m, rows 16m + channel) x BN = 8 * NWN * (8 / WM) output channels from
// y * BN; tiles [z * tps, + tps) of 32 pixels. Warp w: column group w / WM
// (NWN n8 tiles), m tiles w % WM + WM * i. Thread t gathers pixel t / 8,
// channels 2 (t % 8) and + 1, from xt (NHWC), and stages rows t / 32 + 8 * i
// of the cotangent tile at pixel t % 32. Writes partial[z][tap][c][co]
// once.
template <typename T, int NWN, int WM>
__global__ void __launch_bounds__(DW_THREADS)
    deform_bwd_weight_kernel(const T* __restrict__ xt,
                             const float* __restrict__ sy,
                             const float* __restrict__ sx,
                             const T* __restrict__ g,
                             float* __restrict__ partial, int Cin, int Cp,
                             int H, int W, int Cout, long long P, int tps) {
  constexpr bool kBf16 = kIsBf16<T>;
  constexpr int WN = 8 / WM;
  constexpr int BN = 8 * NWN * WN;
  constexpr int MT = (9 + WM - 1) / WM;
  constexpr int CPT = DW_BP * CCH / DW_THREADS;    // channels a thread: 2
  constexpr int GPP = CCH / CPT;                    // threads a pixel
  constexpr int NG = BN * DW_BP / DW_THREADS;       // cotangent values
  constexpr int TILE = (kBf16 ? 2 : 1) * DW_BP * TS;  // taps (hi[, lo])
  constexpr int BUF = TILE + BN * DW_GS;
  extern __shared__ float4 dyn_smem[];
  T* smem = reinterpret_cast<T*>(dyn_smem);  // [2][hi | lo | G]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WM;
  const int nl0 = (warp / WM) * NWN * 8;
  const int HW = H * W;
  const int chunk = blockIdx.x;
  const int co0 = blockIdx.y * BN;
  const long long tiles = (P + DW_BP - 1) / DW_BP;
  const long long t_begin = (long long)blockIdx.z * tps;
  const long long t_end = min(tiles, t_begin + tps);
  const int gq = tid % DW_BP;  // the cotangent column this thread stages
  const int cl0 = tid / DW_BP;
  const int gp = tid / GPP;    // the pixel it gathers
  const int gc = (tid % GPP) * CPT;

  // the next tile's windows and cotangent values, loaded ahead
  Win<T, CPT> win;
  float gv[NG];
  Pixel px;
  auto load_tile = [&](long long tile) {
    px = pixel_at(tile * DW_BP + gp, P, H, W, sy, sx);
    load_win(win, xt + (size_t)px.n * HW * Cp, Cp, H, W, px.y0, px.x0,
             chunk * CCH + gc, px.live);
    const T* gcol = g_column(g, tile * DW_BP + gq, P, HW, Cout);
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int co = co0 + cl0 + 8 * i;
      gv[i] = (gcol != nullptr && co < Cout) ? to_f32(gcol[(size_t)co * HW])
                                             : 0.0f;
    }
  };
  auto store_tile = [&](T* buf) {
    store_win_taps(win, px.fy, px.fx, buf + gp * TS + gc, DW_BP * TS);
    T* gt = buf + TILE;
#pragma unroll
    for (int i = 0; i < NG; ++i)
      gt[(cl0 + 8 * i) * DW_GS + gq] = from_f32<T>(gv[i]);
  };

  float acc[MT][NWN][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NWN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  if (t_begin < t_end) {
    load_tile(t_begin);
    store_tile(smem);
  }
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const int b = (int)((tile - t_begin) & 1);
    __syncthreads();
    const bool next = tile + 1 < t_end;
    if (next) load_tile(tile + 1);
    const T* th = smem + b * BUF;
    const T* gt = th + TILE;
#pragma unroll
    for (int ks = 0; ks < DW_BP / 16; ++ks) {
      if constexpr (kBf16) {
        uint32_t bf[NWN][2];
        if constexpr (NWN == 2) {
          uint32_t b4[4];
          frag_b2_nrows(b4, gt + nl0 * DW_GS + 16 * ks, DW_GS);
          bf[0][0] = b4[0];
          bf[0][1] = b4[1];
          bf[NWN - 1][0] = b4[2];
          bf[NWN - 1][1] = b4[3];
        } else {
          frag_b1_nrows(bf[0], gt + nl0 * DW_GS + 16 * ks, DW_GS);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int m = wm + WM * i;
          if (m < 9) {
            uint32_t ah[4], al[4];
            frag_a_cols(ah, th + 16 * ks * TS + 16 * m, TS);
            frag_a_cols(al, th + DW_BP * TS + 16 * ks * TS + 16 * m, TS);
#pragma unroll
            for (int j = 0; j < NWN; ++j) {
              mma_bf16(acc[i][j], ah, bf[j][0], bf[j][1]);
              mma_bf16(acc[i][j], al, bf[j][0], bf[j][1]);
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int m = wm + WM * i;
          if (m < 9) {
#pragma unroll
            for (int j = 0; j < NWN; ++j)
              fma_16x8x16(acc[i][j], th + 16 * ks * TS + 16 * m, 1, TS,
                          gt + (nl0 + 8 * j) * DW_GS + 16 * ks, 1, DW_GS);
          }
        }
      }
    }
    if (next) store_tile(smem + (b ^ 1) * BUF);
  }

  const int g8 = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = wm + WM * i;  // the tap
    if (m >= 9) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = chunk * CCH + g8 + 8 * r;
      if (c >= Cin) continue;
#pragma unroll
      for (int j = 0; j < NWN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + nl0 + 8 * j + 2 * t4 + e;
          if (co < Cout)
            partial[(((size_t)blockIdx.z * 9 + m) * Cin + c) * Cout + co] =
                acc[i][j][2 * r + e];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers

template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_reduce(const float* partial, T* out, int S, long long count,
                  cudaStream_t stream) {
  const long long blocks = (count + 255) / 256;
  deform_reduce_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      partial, out, S, count);
  return (int)cudaGetLastError();
}

int chunk_pad(int cin) { return (cin + CCH - 1) / CCH * CCH; }

template <typename T>
int launch_to_nhwc(const void* x, void* xt, int n, int cin, int hw,
                   cudaStream_t stream) {
  const int cp = chunk_pad(cin);
  dim3 grid((hw + 31) / 32, (cp + 31) / 32, n);
  to_nhwc_kernel<T><<<grid, dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xt), cin, hw, cp);
  return (int)cudaGetLastError();
}

template <typename T, int MI, int NI>
int launch_fwd(const void* xt, const float* sy, const float* sx,
               const void* w9, int pitch, void* out, float* partial, int n,
               int cin, int h, int w, int cout, int cps,
               cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<T, MI, NI>();
  static int configured = -1;
  if (configured != 0) {
    configured = allow_smem(deform_fwd_kernel<T, MI, NI>, smem);
    if (configured) return configured;
  }
  const long long P = (long long)n * h * w;
  const int nchunks = (cin + CCH - 1) / CCH;
  const int splits = (nchunks + cps - 1) / cps;
  dim3 grid((unsigned)((P + 16 * MI - 1) / (16 * MI)),
            (cout + 32 * NI - 1) / (32 * NI), splits);
  deform_fwd_kernel<T, MI, NI><<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(xt), sy, sx, static_cast<const T*>(w9), pitch,
      static_cast<T*>(out), partial, cin, chunk_pad(cin), h, w, cout, P,
      cps);
  int e = (int)cudaGetLastError();
  if (e || splits == 1) return e;
  return launch_reduce<T>(partial, static_cast<T*>(out), splits,
                          P * cout, stream);
}

template <typename T>
int fwd(const void* x, const float* sy, const float* sx, const void* w9,
        int pitch, void* out, float* partial, void* xt, int n, int cin,
        int h, int w, int cout, int ni, int cps, cudaStream_t s) {
  const int e = launch_to_nhwc<T>(x, xt, n, cin, h * w, s);
  if (e) return e;
#define MFN_FWD(NI_)                                                         \
  if (ni == NI_)                                                             \
    return launch_fwd<T, FWD_MI, NI_>(xt, sy, sx, w9, pitch, out, partial, \
                                      n, cin, h, w, cout, cps, s);
  MFN_FWD(1) MFN_FWD(2) MFN_FWD(3) MFN_FWD(4)
#undef MFN_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T, int MI>
int launch_data(const void* xt, const float* sy, const float* sx,
                const void* w9, int pitch, const void* g, float* dx,
                float* dxt, float* dflow, float* dflow_partial, int n,
                int cin, int h, int w, int cout, int tpg,
                cudaStream_t stream) {
  static int configured = -1;
  if (configured != 0) {
    configured = allow_smem(deform_bwd_data_kernel<T, MI>,
                            data_smem_bytes<T, MI>(MAX_COUT));
    if (configured) return configured;
  }
  const long long P = (long long)n * h * w;
  const int nchunks = (cin + CCH - 1) / CCH;
  const long long tiles = (P + 16 * MI - 1) / (16 * MI);
  float* flow_out =
      dflow == nullptr ? nullptr : (nchunks > 1 ? dflow_partial : dflow);
  dim3 grid((unsigned)((tiles + tpg - 1) / tpg), nchunks);
  deform_bwd_data_kernel<T, MI>
      <<<grid, DATA_THREADS, data_smem_bytes<T, MI>(cout), stream>>>(
          static_cast<const T*>(xt), sy, sx, static_cast<const T*>(w9),
          pitch, static_cast<const T*>(g), dx == nullptr ? nullptr : dxt,
          flow_out, cin, chunk_pad(cin), h, w, cout, P, tpg);
  int e = (int)cudaGetLastError();
  if (e) return e;
  if (dx != nullptr) {
    const int hw = h * w;
    dim3 tgrid((hw + 31) / 32, (cin + 31) / 32, n);
    from_nhwc_kernel<<<tgrid, dim3(32, 8), 0, stream>>>(dxt, dx, cin, hw,
                                                        chunk_pad(cin));
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  if (dflow == nullptr || nchunks == 1) return 0;
  return launch_reduce<float>(dflow_partial, dflow, nchunks, 2 * P, stream);
}

template <typename T, int NWN, int WM>
int launch_dw(const void* xt, const float* sy, const float* sx,
              const void* g, float* dw, float* partial, int n, int cin,
              int h, int w, int cout, int tps, cudaStream_t stream) {
  constexpr int smem = dw_smem_bytes<T, NWN, WM>();
  constexpr int bn = 8 * NWN * (8 / WM);
  static int configured = -1;
  if (configured != 0) {
    configured = allow_smem(deform_bwd_weight_kernel<T, NWN, WM>, smem);
    if (configured) return configured;
  }
  const long long P = (long long)n * h * w;
  const long long tiles = (P + DW_BP - 1) / DW_BP;
  const int splits = (int)((tiles + tps - 1) / tps);
  dim3 grid((cin + CCH - 1) / CCH, (cout + bn - 1) / bn, splits);
  float* out = splits == 1 ? dw : partial;
  deform_bwd_weight_kernel<T, NWN, WM><<<grid, DW_THREADS, smem, stream>>>(
      static_cast<const T*>(xt), sy, sx, static_cast<const T*>(g), out, cin,
      chunk_pad(cin), h, w, cout, P, tps);
  int e = (int)cudaGetLastError();
  if (e || splits == 1) return e;
  return launch_reduce<float>(partial, dw, splits, 9LL * cin * cout, stream);
}

// A second stream a device, with fork and join events, so that the weight
// kernel runs beside the data kernel: both only read x's NHWC copy, g and
// w9, and either alone leaves most of the card idle at the coarse levels.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

int side_stream(Side*& side) {
  static Side sides[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  side = &sides[dev];
  if (side->stream == nullptr) {
    if ((e = cudaStreamCreateWithFlags(&side->stream,
                                       cudaStreamNonBlocking)) ||
        (e = cudaEventCreateWithFlags(&side->fork, cudaEventDisableTiming)) ||
        (e = cudaEventCreateWithFlags(&side->join, cudaEventDisableTiming)))
      return (int)e;
  }
  return 0;
}

template <typename T>
int bwd(const void* x, const float* sy, const float* sx, const void* w9,
        int pitch, const void* g, float* dx, float* dxt, float* dflow,
        float* dflow_partial, float* dw, float* dw_partial, void* xt, int n,
        int cin, int h, int w, int cout, int data_tpg,
        int dw_nwn, int dw_wm, int dw_tps, cudaStream_t s) {
  if (dflow != nullptr || dw != nullptr) {
    const int e = launch_to_nhwc<T>(x, xt, n, cin, h * w, s);
    if (e) return e;
  }
  const bool both = (dx != nullptr || dflow != nullptr) && dw != nullptr;
  cudaStream_t ws = s;  // the weight kernel's stream
  Side* side = nullptr;
  if (both) {
    int e = side_stream(side);
    if (e) return e;
    if ((e = (int)cudaEventRecord(side->fork, s)) ||
        (e = (int)cudaStreamWaitEvent(side->stream, side->fork, 0)))
      return e;
    ws = side->stream;
  }
  if (dw != nullptr) {
    int e = (int)cudaErrorInvalidValue;
#define MFN_DW(NWN_, WM_)                                             \
  if (dw_nwn == NWN_ && dw_wm == WM_)                                 \
    e = launch_dw<T, NWN_, WM_>(xt, sy, sx, g, dw, dw_partial, n, cin, \
                                h, w, cout, dw_tps, ws);
    MFN_DW(1, 8) MFN_DW(1, 4) MFN_DW(1, 2) MFN_DW(1, 1) MFN_DW(2, 1)
#undef MFN_DW
    if (e) return e;
  }
  if (dx != nullptr || dflow != nullptr) {
    const int e = launch_data<T, DATA_MI>(xt, sy, sx, w9, pitch, g, dx, dxt,
                                          dflow, dflow_partial, n, cin, h, w,
                                          cout, data_tpg, s);
    if (e) return e;
  }
  if (both) {
    int e;
    if ((e = (int)cudaEventRecord(side->join, side->stream)) ||
        (e = (int)cudaStreamWaitEvent(s, side->join, 0)))
      return e;
  }
  return 0;
}

bool bad_shape(int n, int cin, int h, int w, int cout, int pitch) {
  const int cp = chunk_pad(cin);
  return n <= 0 || n > 65535 || cin <= 0 || h <= 0 || w <= 0 || cout <= 0 ||
         cout > MAX_COUT || pitch < cout || pitch % 8 != 0 ||
         (long long)n * (cp > cout ? cp : cout) * h * w >= (1LL << 31);
}

}  // namespace

// x: (N, Cin, H, W), w9: (9, Cin, Cout) with rows `pitch` elements apart
// (pitch >= Cout, a multiple of 8, w9 16-byte aligned), both dtype 0 = f32
// or 1 = bf16; sy, sx: (N, H, W) f32; out: (N, Cout, H, W) in x's dtype;
// xt: scratch for x's NHWC copy, (N, H, W, Cp) in x's dtype with Cp = Cin
// rounded up to 16. The tiling (ni, cps) comes from
// ops/deform.py::deform_plan; with more than one K split (ceil(ceil(Cin /
// 16) / cps) > 1), `partial` is f32 of (splits, N, Cout, H, W). Returns the
// first launch error (0 on success); nothing is synchronised or allocated
// here.
extern "C" int mfn_deform_fwd(const void* x, const void* sy, const void* sx,
                              const void* w9, void* out, void* partial,
                              void* xt, int n, int cin, int h, int w,
                              int cout, int pitch, int dtype, int ni, int cps,
                              void* stream) {
  const int nchunks = (cin + CCH - 1) / CCH;
  if (bad_shape(n, cin, h, w, cout, pitch) || cps < 1 || xt == nullptr ||
      ((nchunks + cps - 1) / cps > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fy = static_cast<const float*>(sy);
  const float* fx = static_cast<const float*>(sx);
  float* part = static_cast<float*>(partial);
  switch (dtype) {
    case 0:
      return fwd<float>(x, fy, fx, w9, pitch, out, part, xt, n, cin, h, w,
                        cout, ni, cps, s);
    case 1:
      return fwd<bf16>(x, fy, fx, w9, pitch, out, part, xt, n, cin, h, w,
                       cout, ni, cps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Inputs as mfn_deform_fwd plus g: (N, Cout, H, W) in x's dtype. Outputs
// are f32 and optional (null when not asked for): dx (N, Cin, H, W) with
// dxt (N, H, W, Cp), zeroed by the caller, as its NHWC accumulator; dflow
// (2, N, H, W), with dflow_partial (ceil(Cin / 16), 2, N, H, W) as its
// scratch when Cin > 16; dw (9, Cin, Cout) with dw_partial (splits, 9, Cin,
// Cout) when the plan splits the pixels. xt as mfn_deform_fwd's, needed
// for dflow and dw. The tiling (data_tpg, dw_nwn, dw_wm, dw_tps)
// comes from deform_plan.
extern "C" int mfn_deform_bwd(const void* x, const void* sy, const void* sx,
                              const void* w9, const void* g, void* dx,
                              void* dxt, void* dflow, void* dflow_partial,
                              void* dw, void* dw_partial, void* xt, int n,
                              int cin, int h, int w, int cout, int pitch,
                              int dtype, int data_tpg,
                              int dw_nwn, int dw_wm, int dw_tps,
                              void* stream) {
  if (bad_shape(n, cin, h, w, cout, pitch) ||
      ((dx != nullptr || dflow != nullptr) && data_tpg < 1) ||
      (dx != nullptr && dxt == nullptr) ||
      ((dflow != nullptr || dw != nullptr) && xt == nullptr) ||
      (dflow != nullptr && cin > CCH && dflow_partial == nullptr) ||
      (dw != nullptr && dw_tps < 1))
    return (int)cudaErrorInvalidValue;
  if (dw != nullptr && dw_partial == nullptr) {
    const long long tiles = ((long long)n * h * w + DW_BP - 1) / DW_BP;
    if ((tiles + dw_tps - 1) / dw_tps > 1) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fy = static_cast<const float*>(sy);
  const float* fx = static_cast<const float*>(sx);
  float* ddx = static_cast<float*>(dx);
  float* ddxt = static_cast<float*>(dxt);
  float* df = static_cast<float*>(dflow);
  float* dfp = static_cast<float*>(dflow_partial);
  float* ddw = static_cast<float*>(dw);
  float* dwp = static_cast<float*>(dw_partial);
  switch (dtype) {
    case 0:
      return bwd<float>(x, fy, fx, w9, pitch, g, ddx, ddxt, df, dfp, ddw,
                        dwp, xt, n, cin, h, w, cout, data_tpg,
                        dw_nwn, dw_wm, dw_tps, s);
    case 1:
      return bwd<bf16>(x, fy, fx, w9, pitch, g, ddx, ddxt, df, dfp, ddw, dwp,
                       xt, n, cin, h, w, cout, data_tpg, dw_nwn,
                       dw_wm, dw_tps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of each kernel (bytes) for the checks: kind 0 the
// forward (a = ni), 1 the data kernel (a = cout), 2 the weight kernel (a =
// nwn, b = wm); -1 for a tiling that is not built.
extern "C" int mfn_deform_smem_bytes(int kind, int dtype, int a, int b) {
  const bool f = dtype == 0;
  if (kind == 0) {
#define MFN_S(NI_)                                                     \
  if (a == NI_)                                                        \
    return f ? fwd_smem_bytes<float, FWD_MI, NI_>()                    \
             : fwd_smem_bytes<bf16, FWD_MI, NI_>();
    MFN_S(1) MFN_S(2) MFN_S(3) MFN_S(4)
#undef MFN_S
  } else if (kind == 1 && a >= 1 && a <= MAX_COUT) {
    return f ? data_smem_bytes<float, DATA_MI>(a)
             : data_smem_bytes<bf16, DATA_MI>(a);
  } else if (kind == 2) {
#define MFN_S(NWN_, WM_)                                             \
  if (a == NWN_ && b == WM_)                                         \
    return f ? dw_smem_bytes<float, NWN_, WM_>()                     \
             : dw_smem_bytes<bf16, NWN_, WM_>();
    MFN_S(1, 8) MFN_S(1, 4) MFN_S(1, 2) MFN_S(1, 1) MFN_S(2, 1)
#undef MFN_S
  }
  return -1;
}

extern "C" const char* mfn_deform_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
