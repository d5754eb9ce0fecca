// Flow-guided deformable 3x3 convolution -- the Hopper (sm_90a) kernels of
// maskflownet_torch: the forward (deform_fwd_kernel) and the backward
// (deform_bwd_data_kernel for dx and the flow, deform_bwd_weight_kernel +
// deform_dw_reduce_kernel for the weight).
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
// or bf16 (w9 (9, Cin, Cout), tap major), sy/sx (N, H, W) f32, out (N, Cout,
// H, W) in x's dtype; every product and sum is f32 and out is cast once on
// store. The gradients are f32: dx (N, Cin, H, W), dsy/dsx (N, H, W) (the
// flow's two channels), dw (9, Cin, Cout). The flow gradient is the
// floor-based one of the gather form: d tap / d sy = d tap / d fy.
//
// Replaces maskflownet_tpu/ops/pallas/deform.py::_fwd_kernel and
// ::_bwd_kernel. They interpolate rows with one-hot matrices on the MXU over
// a whole zero-padded image held in VMEM, carry dx and dweight across the
// sequential grid, and take the slope -sign(s - i) of the one-hot weights,
// which is 0 at an integer coordinate. None of that carries over: the
// window is read straight from global memory with a clamped index and a zero
// for out-of-image corners, blocks run in parallel, and the flow gradient
// follows the floor-based derivative of maskflownet_torch's gather and
// warpconv forms (the Pallas one drops it at integer flows).
//
// What bounds it on an H100: operations at the coarse levels (9*Cin*Cout
// multiply-adds a pixel against 2*(Cin + Cout) bytes of bf16 I/O: ~290
// flops per byte at Cin = Cout = 128, the bf16 tensor-core ridge) and bytes
// at the fine ones (Cin = Cout = 32: ~72 flops per byte). This first version
// contracts on the CUDA cores in f32 (67 TFLOP/s, not 989), so it is bound by
// its arithmetic and by shared-memory reads, far above both bounds; tensor
// cores, wgmma and TMA are later work. The design:
//   * forward: a block owns 64 output pixels of one image and all of Cout.
//     The K = 9*Cin contraction runs in chunks of 8 channels (72 rows): each
//     warp gathers one channel's 4x4 windows at the block's pixels (lanes on
//     neighbouring x, so the loads coalesce), forms the nine taps and stages
//     them in shared memory with the chunk's 72 x Cout weight rows; then each
//     thread accumulates 2 pixels x Cout/8 outputs in registers. A 32-pixel
//     f32 tap tile of all 9*196 rows of level 6 alone would be 226 KB, the
//     whole shared memory, hence the chunks.
//   * dx and dflow (one kernel): a block owns 32 pixels, stages their
//     cotangent g (Cout x 32) once, and per chunk of 8 channels forms dtap =
//     g . w9^T for its (pixel, channel) pairs, then the flow's share (the
//     taps' derivatives in fy and fx, summed per thread in registers and
//     across the block's warps in a fixed order: deterministic) and dx: the
//     window's 16 corners each get their bilinear share of dtap by f32
//     atomicAdd into a zeroed buffer. The flow is arbitrary, so the inverse
//     map (which pixels read a given input) is not local and a gather form
//     would need a search; the atomics make dx depend on the order in which
//     blocks land, so dx is not bitwise repeatable from run to run (f32
//     rounding only).
//   * dweight: dw = taps^T . g is a product whose depth is the N*H*W pixels.
//     A block owns 8 channels (72 rows) x 64 output channels and one of S
//     contiguous ranges of pixel tiles (split-K), re-forms the taps of each
//     tile, accumulates in registers and writes its partial sums once; one
//     reduction kernel adds the S partials in a fixed order, so dw is
//     deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CC = WARPS;     // input channels per K chunk: one per warp
constexpr int KC = 9 * CC;    // K rows per chunk, tap major (tap * CC + cc)
constexpr int FP = 64;        // forward: output pixels per block, 2 per lane
constexpr int BP = 32;        // backward: pixels per tile, 1 per lane
constexpr int DW_CO = 64;     // dweight: output channels per block, 2 per lane
constexpr int MAX_COUT = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

// The 4x4 window of one channel plane: v[u][t] = plane[y0 - 1 + u][x0 - 1 +
// t], zero outside the image. Every load is in bounds (clamped index).
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ plane,
                                            int H, int W, int y0, int x0,
                                            float v[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int yy = y0 - 1 + u;
    const bool vy = yy >= 0 && yy < H;
    const int row = min(max(yy, 0), H - 1) * W;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int xx = x0 - 1 + t;
      const float val = to_f32(plane[row + min(max(xx, 0), W - 1)]);
      v[u][t] = (vy && xx >= 0 && xx < W) ? val : 0.0f;
    }
  }
}

__device__ __forceinline__ float tap(const float v[4][4], int a, int b,
                                     float fy, float fx) {
  const float r0 = (1.0f - fx) * v[a][b] + fx * v[a][b + 1];
  const float r1 = (1.0f - fx) * v[a + 1][b] + fx * v[a + 1][b + 1];
  return (1.0f - fy) * r0 + fy * r1;
}

// The chunk's weight rows in shared memory: w_s[k * CS + co] = w9[tap, c0 +
// cc, co] for k = tap * CC + cc, zero past Cin and Cout.
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w9,
                                              float* w_s, int c0, int Cin,
                                              int Cout, int CS) {
  for (int idx = threadIdx.x; idx < KC * CS; idx += THREADS) {
    const int k = idx / CS;
    const int co = idx - k * CS;
    const int t = k / CC;
    const int c = c0 + k - t * CC;
    w_s[idx] = (co < Cout && c < Cin)
                   ? to_f32(w9[((size_t)t * Cin + c) * Cout + co])
                   : 0.0f;
  }
}

// JT output channels per thread: co = warp + WARPS * j, j < JT.
template <typename T, int JT>
__global__ void __launch_bounds__(THREADS)
    deform_fwd_kernel(const T* __restrict__ x, const float* __restrict__ sy,
                      const float* __restrict__ sx, const T* __restrict__ w9,
                      T* __restrict__ out, int Cin, int H, int W, int Cout) {
  constexpr int CS = JT * WARPS;
  extern __shared__ float4 dyn_smem[];
  float* smem = reinterpret_cast<float*>(dyn_smem);
  float* taps_s = smem;              // [KC][FP]
  float* w_s = smem + KC * FP;       // [KC][CS]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int HW = H * W;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * FP;

  int y0[2], x0[2];
  float fy[2], fx[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = p0 + 32 * i + lane;
    live[i] = p < HW;
    const size_t q = (size_t)n * HW + (live[i] ? p : 0);
    corner(sy[q], sx[q], H, W, y0[i], x0[i], fy[i], fx[i]);
  }
  float acc[2][JT];
#pragma unroll
  for (int j = 0; j < JT; ++j) acc[0][j] = acc[1][j] = 0.0f;

  const T* xn = x + (size_t)n * Cin * HW;
  for (int c0 = 0; c0 < Cin; c0 += CC) {
    const int c = c0 + warp;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v[4][4];
      if (c < Cin && live[i]) {
        load_window(xn + (size_t)c * HW, H, W, y0[i], x0[i], v);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int t = 0; t < 4; ++t) v[u][t] = 0.0f;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          taps_s[((a * 3 + b) * CC + warp) * FP + 32 * i + lane] =
              tap(v, a, b, fy[i], fx[i]);
    }
    stage_weights(w9, w_s, c0, Cin, Cout, CS);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float t0 = taps_s[k * FP + lane];
      const float t1 = taps_s[k * FP + 32 + lane];
      const float* wr = w_s + k * CS + warp;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const float wv = wr[j * WARPS];
        acc[0][j] = fmaf(t0, wv, acc[0][j]);
        acc[1][j] = fmaf(t1, wv, acc[1][j]);
      }
    }
    __syncthreads();
  }

  T* on = out + (size_t)n * Cout * HW;
#pragma unroll
  for (int j = 0; j < JT; ++j) {
    const int co = warp + WARPS * j;
    if (co >= Cout) break;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (live[i]) on[(size_t)co * HW + p0 + 32 * i + lane] =
          from_f32<T>(acc[i][j]);
  }
}

// dx and the flow gradient. A block owns BP pixels of image blockIdx.y;
// thread (lane, warp) owns pixel lane and, in each chunk, channel c0 + warp.
// CS = Cout rounded up to 4 (float4 reads of the staged rows).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    deform_bwd_data_kernel(const T* __restrict__ x,
                           const float* __restrict__ sy,
                           const float* __restrict__ sx,
                           const T* __restrict__ w9, const T* __restrict__ g,
                           float* __restrict__ dx, float* __restrict__ dsy,
                           float* __restrict__ dsx, int Cin, int H, int W,
                           int Cout) {
  const int CS = (Cout + 3) & ~3;
  extern __shared__ float4 dyn_smem[];
  float* smem = reinterpret_cast<float*>(dyn_smem);
  float* g_s = smem;                 // [CS][BP]
  float* w_s = g_s + CS * BP;        // [KC][CS]
  float* red = w_s + KC * CS;        // [2][WARPS][BP]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int HW = H * W;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * BP;
  const int p = p0 + lane;
  const bool live = p < HW;
  const bool need_flow = dsy != nullptr;
  int y0, x0;
  float fy, fx;
  {
    const size_t q = (size_t)n * HW + (live ? p : 0);
    corner(sy[q], sx[q], H, W, y0, x0, fy, fx);
  }
  for (int idx = threadIdx.x; idx < CS * BP; idx += THREADS) {
    const int co = idx / BP;
    const int pp = p0 + idx - co * BP;
    g_s[idx] = (co < Cout && pp < HW)
                   ? to_f32(g[((size_t)n * Cout + co) * HW + pp])
                   : 0.0f;
  }
  float ay = 0.0f, ax = 0.0f;
  for (int c0 = 0; c0 < Cin; c0 += CC) {
    stage_weights(w9, w_s, c0, Cin, Cout, CS);
    __syncthreads();
    const int c = c0 + warp;
    if (c < Cin && live) {
      float d[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) d[t] = 0.0f;
      for (int co = 0; co < CS; co += 4) {
        const float g0 = g_s[(co + 0) * BP + lane];
        const float g1 = g_s[(co + 1) * BP + lane];
        const float g2 = g_s[(co + 2) * BP + lane];
        const float g3 = g_s[(co + 3) * BP + lane];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float4 wv =
              *reinterpret_cast<const float4*>(w_s + (t * CC + warp) * CS + co);
          d[t] = fmaf(g0, wv.x, d[t]);
          d[t] = fmaf(g1, wv.y, d[t]);
          d[t] = fmaf(g2, wv.z, d[t]);
          d[t] = fmaf(g3, wv.w, d[t]);
        }
      }
      if (need_flow) {
        float v[4][4];
        load_window(x + ((size_t)n * Cin + c) * HW, H, W, y0, x0, v);
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const float dd = d[a * 3 + b];
            ay += dd * ((1.0f - fx) * (v[a + 1][b] - v[a][b]) +
                        fx * (v[a + 1][b + 1] - v[a][b + 1]));
            ax += dd * ((1.0f - fy) * (v[a][b + 1] - v[a][b]) +
                        fy * (v[a + 1][b + 1] - v[a + 1][b]));
          }
      }
      if (dx != nullptr) {
        float* plane = dx + ((size_t)n * Cin + c) * HW;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int yy = y0 - 1 + u;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int xx = x0 - 1 + t;
            float s = 0.0f;
#pragma unroll
            for (int a = u - 1; a <= u; ++a)
#pragma unroll
              for (int b = t - 1; b <= t; ++b)
                if (a >= 0 && a <= 2 && b >= 0 && b <= 2)
                  s += d[a * 3 + b] * ((a == u ? 1.0f - fy : fy) *
                                       (b == t ? 1.0f - fx : fx));
            if (yy >= 0 && yy < H && xx >= 0 && xx < W)
              atomicAdd(plane + yy * W + xx, s);
          }
        }
      }
    }
    __syncthreads();
  }
  if (need_flow) {
    red[warp * BP + lane] = ay;
    red[(WARPS + warp) * BP + lane] = ax;
    __syncthreads();
    if (warp == 0 && live) {
      float ty = 0.0f, tx = 0.0f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        ty += red[k * BP + lane];
        tx += red[(WARPS + k) * BP + lane];
      }
      dsy[(size_t)n * HW + p] = ty;
      dsx[(size_t)n * HW + p] = tx;
    }
  }
}

// Partial dweight sums. Block (chunk, cout tile, split): channels chunk * CC
// + warp, output channels blockIdx.y * DW_CO + lane + 32 * j (j < 2), pixel
// tiles [split * tiles_per_split, ...) of the N*H*W pixels taken as one
// sequence. Writes partial[split, tap, c, co] once.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    deform_bwd_weight_kernel(const T* __restrict__ x,
                             const float* __restrict__ sy,
                             const float* __restrict__ sx,
                             const T* __restrict__ g,
                             float* __restrict__ partial, int N, int Cin,
                             int H, int W, int Cout, int tiles_per_split) {
  __shared__ float taps_s[KC * BP];               // [tap][cc][pixel]
  __shared__ float g_s[BP * (DW_CO + 1)];         // [pixel][co], padded
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int HW = H * W;
  const long long NP = (long long)N * HW;
  const int c = blockIdx.x * CC + warp;
  const int co0 = blockIdx.y * DW_CO;
  const long long tiles = (NP + BP - 1) / BP;
  const long long t_begin = (long long)blockIdx.z * tiles_per_split;
  const long long t_end = min(tiles, t_begin + tiles_per_split);
  float acc[9][2];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t][0] = acc[t][1] = 0.0f;

  for (long long tile = t_begin; tile < t_end; ++tile) {
    {
      const long long q = tile * BP + lane;
      float v[4][4];
      float fy = 0.0f, fx = 0.0f;
      if (q < NP && c < Cin) {
        const int n = (int)(q / HW);
        int y0, x0;
        corner(sy[q], sx[q], H, W, y0, x0, fy, fx);
        load_window(x + ((size_t)n * Cin + c) * HW, H, W, y0, x0, v);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int t = 0; t < 4; ++t) v[u][t] = 0.0f;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          taps_s[((a * 3 + b) * CC + warp) * BP + lane] = tap(v, a, b, fy, fx);
    }
    for (int idx = threadIdx.x; idx < DW_CO * BP; idx += THREADS) {
      const int cl = idx / BP;
      const int ql = idx - cl * BP;
      const long long q = tile * BP + ql;
      const int co = co0 + cl;
      float val = 0.0f;
      if (q < NP && co < Cout) {
        const int n = (int)(q / HW);
        val = to_f32(g[((size_t)n * Cout + co) * HW + (q - (long long)n * HW)]);
      }
      g_s[ql * (DW_CO + 1) + cl] = val;
    }
    __syncthreads();
#pragma unroll 4
    for (int ql = 0; ql < BP; ++ql) {
      const float g0 = g_s[ql * (DW_CO + 1) + lane];
      const float g1 = g_s[ql * (DW_CO + 1) + 32 + lane];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float tv = taps_s[(t * CC + warp) * BP + ql];
        acc[t][0] = fmaf(tv, g0, acc[t][0]);
        acc[t][1] = fmaf(tv, g1, acc[t][1]);
      }
    }
    __syncthreads();
  }
  if (c >= Cin) return;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = co0 + 32 * j + lane;
      if (co < Cout)
        partial[(((size_t)blockIdx.z * 9 + t) * Cin + c) * Cout + co] =
            acc[t][j];
    }
}

// dw[i] = sum over the S partials in order (deterministic).
__global__ void deform_dw_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ dw, int S,
                                        int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
  for (int z = 0; z < S; ++z) s += partial[(size_t)z * count + i];
  dw[i] = s;
}

template <typename T, int JT>
int launch_fwd(const void* x, const float* sy, const float* sx,
               const void* w9, void* out, int n, int cin, int h, int w,
               int cout, cudaStream_t stream) {
  const int smem = (KC * FP + KC * JT * WARPS) * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        deform_fwd_kernel<T, JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((h * w + FP - 1) / FP, n);
  deform_fwd_kernel<T, JT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), sy, sx, static_cast<const T*>(w9),
      static_cast<T*>(out), cin, h, w, cout);
  return (int)cudaGetLastError();
}

// the smallest instantiated JT >= ceil(cout / WARPS)
template <typename T>
int fwd(const void* x, const float* sy, const float* sx, const void* w9,
        void* out, int n, int cin, int h, int w, int cout, cudaStream_t s) {
  const int jt = (cout + WARPS - 1) / WARPS;
  if (jt <= 1) return launch_fwd<T, 1>(x, sy, sx, w9, out, n, cin, h, w, cout, s);
  if (jt <= 2) return launch_fwd<T, 2>(x, sy, sx, w9, out, n, cin, h, w, cout, s);
  if (jt <= 4) return launch_fwd<T, 4>(x, sy, sx, w9, out, n, cin, h, w, cout, s);
  if (jt <= 8) return launch_fwd<T, 8>(x, sy, sx, w9, out, n, cin, h, w, cout, s);
  if (jt <= 12) return launch_fwd<T, 12>(x, sy, sx, w9, out, n, cin, h, w, cout, s);
  if (jt <= 16) return launch_fwd<T, 16>(x, sy, sx, w9, out, n, cin, h, w, cout, s);
  if (jt <= 25) return launch_fwd<T, 25>(x, sy, sx, w9, out, n, cin, h, w, cout, s);
  return launch_fwd<T, 32>(x, sy, sx, w9, out, n, cin, h, w, cout, s);
}

template <typename T>
int bwd(const void* x, const float* sy, const float* sx, const void* w9,
        const void* g, float* dx, float* dsy, float* dsx, float* dw,
        float* partial, int n, int cin, int h, int w, int cout, int splits,
        cudaStream_t stream) {
  const int hw = h * w;
  if (dx != nullptr || dsy != nullptr) {
    const int cs = (cout + 3) & ~3;
    const int smem = (cs * BP + KC * cs + 2 * WARPS * BP) * (int)sizeof(float);
    static bool configured = false;
    if (!configured) {
      const int most = (MAX_COUT * BP + KC * MAX_COUT + 2 * WARPS * BP) *
                       (int)sizeof(float);
      const cudaError_t e = cudaFuncSetAttribute(
          deform_bwd_data_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    dim3 grid((hw + BP - 1) / BP, n);
    deform_bwd_data_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x), sy, sx, static_cast<const T*>(w9),
        static_cast<const T*>(g), dx, dsy, dsx, cin, h, w, cout);
    const int e = (int)cudaGetLastError();
    if (e) return e;
  }
  if (dw != nullptr) {
    const long long tiles = ((long long)n * hw + BP - 1) / BP;
    const int tps = (int)((tiles + splits - 1) / splits);
    dim3 grid((cin + CC - 1) / CC, (cout + DW_CO - 1) / DW_CO, splits);
    deform_bwd_weight_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), sy, sx, static_cast<const T*>(g), partial,
        n, cin, h, w, cout, tps);
    int e = (int)cudaGetLastError();
    if (e) return e;
    const int count = 9 * cin * cout;
    deform_dw_reduce_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
        partial, dw, splits, count);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  return 0;
}

bool bad_shape(int n, int cin, int h, int w, int cout) {
  return n <= 0 || n > 65535 || cin <= 0 || h <= 0 || w <= 0 || cout <= 0 ||
         cout > MAX_COUT ||
         (long long)n * (cin > cout ? cin : cout) * h * w >= (1LL << 31);
}

}  // namespace

// x: (N, Cin, H, W), w9: (9, Cin, Cout), both dtype 0 = f32 or 1 = bf16;
// sy, sx: (N, H, W) f32; out: (N, Cout, H, W) in x's dtype. All contiguous.
// Returns cudaGetLastError() after the launch (0 on success); nothing is
// synchronised or allocated here.
extern "C" int mfn_deform_fwd(const void* x, const void* sy, const void* sx,
                              const void* w9, void* out, int n, int cin,
                              int h, int w, int cout, int dtype,
                              void* stream) {
  if (bad_shape(n, cin, h, w, cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fy = static_cast<const float*>(sy);
  const float* fx = static_cast<const float*>(sx);
  switch (dtype) {
    case 0:
      return fwd<float>(x, fy, fx, w9, out, n, cin, h, w, cout, s);
    case 1:
      return fwd<__nv_bfloat16>(x, fy, fx, w9, out, n, cin, h, w, cout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The number S of pixel-range splits of the dweight kernel for this shape on
// a card of `sms` multiprocessors (about four blocks a multiprocessor);
// the caller allocates the f32 partial buffer (S, 9, Cin, Cout).
extern "C" int mfn_deform_dw_splits(int n, int cin, int h, int w, int cout,
                                    int sms) {
  const long long tiles = ((long long)n * h * w + BP - 1) / BP;
  const long long blocks =
      (long long)((cin + CC - 1) / CC) * ((cout + DW_CO - 1) / DW_CO);
  long long s = (4LL * (sms > 0 ? sms : 132) + blocks - 1) / blocks;
  if (s > tiles) s = tiles;
  if (s < 1) s = 1;
  return (int)s;
}

// Inputs as mfn_deform_fwd plus g: (N, Cout, H, W) in x's dtype. Outputs
// are f32 and optional (null when not asked for): dx (N, Cin, H, W), zeroed
// by the caller; dsy and dsx (N, H, W), both or neither; dw (9, Cin, Cout)
// with `partial` (splits, 9, Cin, Cout) as its scratch, splits from
// mfn_deform_dw_splits.
extern "C" int mfn_deform_bwd(const void* x, const void* sy, const void* sx,
                              const void* w9, const void* g, void* dx,
                              void* dsy, void* dsx, void* dw, void* partial,
                              int n, int cin, int h, int w, int cout,
                              int splits, int dtype, void* stream) {
  if (bad_shape(n, cin, h, w, cout) || (dsy == nullptr) != (dsx == nullptr) ||
      (dw != nullptr && (partial == nullptr || splits < 1 || splits > 65535)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fy = static_cast<const float*>(sy);
  const float* fx = static_cast<const float*>(sx);
  float* ddx = static_cast<float*>(dx);
  float* dy_ = static_cast<float*>(dsy);
  float* dx_ = static_cast<float*>(dsx);
  float* ddw = static_cast<float*>(dw);
  float* part = static_cast<float*>(partial);
  switch (dtype) {
    case 0:
      return bwd<float>(x, fy, fx, w9, g, ddx, dy_, dx_, ddw, part, n, cin, h,
                        w, cout, splits, s);
    case 1:
      return bwd<__nv_bfloat16>(x, fy, fx, w9, g, ddx, dy_, dx_, ddw, part, n,
                                cin, h, w, cout, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mfn_deform_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
