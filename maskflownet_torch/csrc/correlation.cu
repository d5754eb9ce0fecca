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
// LeakyReLU(leaky) applied to the f32 accumulator before the single
// cast-and-store, or the identity.
//
// Replaces both TPU forward kernels of maskflownet_tpu/ops/pallas/
// correlation.py: _corr_fwd_kernel (NHWC, C on the lanes) and
// _hm_fwd_kernel (H-major, W on the lanes). They compute this one function
// in two layouts; the split exists for the TPU's (8, 128) lane tiling
// (maskflownet_tpu/ops/correlation.py:51-60) and has no reason on Hopper.
//
// What bounds it on an H100: bytes. Per pixel it reads 2*C input values
// and writes D*D = 81 outputs (md = 4) -- the cost volume is the largest
// activation of the network -- against 2*C*81 flops: under 81/s flops per
// byte for s-byte I/O (~18 for bf16 at C = 32, ~34 at C = 196), far below
// the bf16 tensor-core ridge (~295 flops/byte). This version does its
// arithmetic as f32 FMAs on the CUDA cores, whose ridge (~20 flops/byte)
// the deep levels reach, so there the arithmetic is as costly as the
// bytes; moving the channel reduction onto tensor cores is later work. The
// design touches device memory as little as the function allows:
//   * one block per (n, TH x TW output tile); the f1 tile and the f2 halo
//     tile (TH+2md) x (TW+2md) of CC channels are staged in shared memory
//     (as f32) once and every staged f2 value serves all D*D taps of up to
//     D*D output pixels, so f1 and f2 are read from device memory about
//     once (plus the halo);
//   * the channel reduction loops over C in chunks of CC, so any C fits
//     (C = 196 at level 6); products and sums stay in f32 registers, one
//     accumulator per displacement (D*D per thread);
//   * each output value is written exactly once, after the epilogue; a
//     warp writes 32 consecutive x of one displacement plane, so the
//     stores are coalesced along W.
// This is the simple first version: no TMA, no wgmma, one output pixel
// per thread, and one shared-memory load per FMA, which caps the inner
// loop at a quarter of the SM's FMA rate.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;   // output rows per block
constexpr int TW = 32;  // output columns per block: one warp per row
constexpr int CC = 8;   // channels staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

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
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

template <typename T, int MD>
__global__ void __launch_bounds__(TH * TW)
    corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                    T* __restrict__ out, int C, int H, int W, float inv_c,
                    float leaky, int use_leaky) {
  constexpr int D = 2 * MD + 1;
  constexpr int SH = TH + 2 * MD;
  constexpr int SW = TW + 2 * MD;
  __shared__ float s1[CC][TH][TW];
  __shared__ float s2[CC][SH][SW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = y < H && x < W;
  const size_t plane = (size_t)H * W;
  const T* f1n = f1 + (size_t)blockIdx.z * C * plane;
  const T* f2n = f2 + (size_t)blockIdx.z * C * plane;

  float acc[D * D];
#pragma unroll
  for (int t = 0; t < D * D; ++t) acc[t] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nc = min(CC, C - c0);
#pragma unroll
    for (int cc = 0; cc < CC; ++cc)
      s1[cc][ty][tx] = (cc < nc && inside)
                           ? to_f32(f1n[(c0 + cc) * plane + (size_t)y * W + x])
                           : 0.f;
    for (int i = tid; i < CC * SH * SW; i += TH * TW) {
      const int cc = i / (SH * SW);
      const int r = (i / SW) % SH;
      const int col = i % SW;
      const int gy = y0 - MD + r, gx = x0 - MD + col;
      float v = 0.f;
      if (cc < nc && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f32(f2n[(c0 + cc) * plane + (size_t)gy * W + gx]);
      s2[cc][r][col] = v;
    }
    __syncthreads();
    for (int cc = 0; cc < nc; ++cc) {
      const float a = s1[cc][ty][tx];
#pragma unroll
      for (int dy = 0; dy < D; ++dy)
#pragma unroll
        for (int dx = 0; dx < D; ++dx)
          acc[dy * D + dx] =
              fmaf(a, s2[cc][ty + dy][tx + dx], acc[dy * D + dx]);
    }
    __syncthreads();
  }

  if (!inside) return;
  T* o = out + (size_t)blockIdx.z * D * D * plane + (size_t)y * W + x;
#pragma unroll
  for (int t = 0; t < D * D; ++t) {
    float v = acc[t] * inv_c;
    if (use_leaky) v = v >= 0.f ? v : leaky * v;
    o[t * plane] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* f1, const void* f2, void* out, int n, int c, int h,
           int w, int md, float leaky, int use_leaky, cudaStream_t stream) {
  const dim3 block(TW, TH);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  const float inv_c = (float)(1.0 / c);
  const T* a = static_cast<const T*>(f1);
  const T* b = static_cast<const T*>(f2);
  T* o = static_cast<T*>(out);
  switch (md) {
    case 1:
      corr_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(a, b, o, c, h, w,
                                                        inv_c, leaky, use_leaky);
      break;
    case 2:
      corr_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(a, b, o, c, h, w,
                                                        inv_c, leaky, use_leaky);
      break;
    case 3:
      corr_fwd_kernel<T, 3><<<grid, block, 0, stream>>>(a, b, o, c, h, w,
                                                        inv_c, leaky, use_leaky);
      break;
    case 4:
      corr_fwd_kernel<T, 4><<<grid, block, 0, stream>>>(a, b, o, c, h, w,
                                                        inv_c, leaky, use_leaky);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
// atomics.
//
// corr_bwd_f1_kernel replaces _corr_bwd_f1_kernel (NHWC) and
// _hm_bwd_f1_kernel (H-major); corr_bwd_f2_kernel replaces
// _corr_bwd_f2_kernel and _hm_bwd_f2_kernel (maskflownet_tpu/ops/pallas/
// correlation.py). As for the forward, the two TPU layout families exist for
// the (8, 128) lane tiling; here one NCHW body serves every level.
//
// What bounds them on an H100: bytes. Each reads g (D*D values a pixel),
// out (D*D, with the LeakyReLU) and one feature map (C), and writes one
// gradient (C), against 2*C*D*D flops a pixel: at most ~C/2 flops a byte in
// bf16, below the ridge of either the tensor cores or the CUDA cores at the
// fine levels. What the design does about it:
//   * the TPU kernels carry the sum over a sequential dy grid axis in a
//     revisited output block; blocks on the H100 run in no order, so the
//     whole displacement loop lives inside one block;
//   * unlike the forward, the sum runs over displacements, not channels, so
//     a block owns a chunk of BCC channels outright: grid (W tiles, H
//     tiles, N * ceil(C / BCC)), no reduction across blocks, each thread
//     keeps BCC f32 accumulators (not D*D), and the channel chunks give the
//     coarse levels blocks to fill the card (200 at level 6, batch 8, where
//     the forward launches 8);
//   * the feature halo (TH+2md) x (TW+2md) of the block's BCC channels is
//     staged in shared memory (as f32) once and serves every tap;
//   * the leaky rescale is fused into the read of g: g and out are read
//     together and only g' is kept. In df1 a pixel's g' serves only that
//     pixel, so it goes to registers, one dy row of D taps at a time; in
//     df2 a pixel gathers g' of its neighbours, so one dy row of taps over
//     the tile plus its dx halo is staged in shared memory;
//   * each df value is written once, after the f32 sum over all D*D taps,
//     cast on store, a warp writing 32 consecutive x (coalesced along W).
// g and out are read once per channel chunk (ceil(C / BCC) times), mostly
// from L2. This is the simple first version: no TMA, no wgmma.
// ---------------------------------------------------------------------------

constexpr int BCC = 8;  // channels owned by one backward block

// g' at flat index i: the cotangent rescaled by the LeakyReLU's derivative,
// read off the sign of the saved output (out == nullptr: the identity).
template <typename T>
__device__ __forceinline__ float grad_in(const T* __restrict__ g,
                                         const T* __restrict__ out, size_t i,
                                         float leaky) {
  const float v = to_f32(g[i]);
  return (out == nullptr || to_f32(out[i]) >= 0.f) ? v : leaky * v;
}

// Stage channels [c0, c0 + BCC) of the (TH+2MD) x (TW+2MD) halo around the
// block's tile, zero outside the image and past C.
template <typename T, int MD>
__device__ __forceinline__ void stage_halo(
    float (&s)[BCC][TH + 2 * MD][TW + 2 * MD], const T* __restrict__ fn,
    int nc, int H, int W, int y0, int x0, int tid) {
  constexpr int SH = TH + 2 * MD, SW = TW + 2 * MD;
  const size_t plane = (size_t)H * W;
  for (int i = tid; i < BCC * SH * SW; i += TH * TW) {
    const int cc = i / (SH * SW);
    const int r = (i / SW) % SH;
    const int col = i % SW;
    const int gy = y0 - MD + r, gx = x0 - MD + col;
    float v = 0.f;
    if (cc < nc && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_f32(fn[cc * plane + (size_t)gy * W + gx]);
    s[cc][r][col] = v;
  }
}

template <typename T, int MD>
__global__ void __launch_bounds__(TH * TW)
    corr_bwd_f1_kernel(const T* __restrict__ g, const T* __restrict__ out,
                       const T* __restrict__ f2, T* __restrict__ df1, int C,
                       int H, int W, int chunks, float inv_c, float leaky) {
  constexpr int D = 2 * MD + 1;
  __shared__ float s2[BCC][TH + 2 * MD][TW + 2 * MD];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int x = x0 + tx, y = y0 + ty;
  const int n = blockIdx.z / chunks, c0 = (blockIdx.z % chunks) * BCC;
  const int nc = min(BCC, C - c0);
  const size_t plane = (size_t)H * W;

  stage_halo<T, MD>(s2, f2 + ((size_t)n * C + c0) * plane, nc, H, W, y0, x0,
                    ty * TW + tx);
  __syncthreads();
  if (y >= H || x >= W) return;

  float acc[BCC];
#pragma unroll
  for (int cc = 0; cc < BCC; ++cc) acc[cc] = 0.f;
  const size_t pix = (size_t)n * D * D * plane + (size_t)y * W + x;
#pragma unroll
  for (int dy = 0; dy < D; ++dy) {
    float gv[D];
#pragma unroll
    for (int dx = 0; dx < D; ++dx)
      gv[dx] = grad_in(g, out, pix + (dy * D + dx) * plane, leaky);
#pragma unroll
    for (int cc = 0; cc < BCC; ++cc)
#pragma unroll
      for (int dx = 0; dx < D; ++dx)
        acc[cc] = fmaf(gv[dx], s2[cc][ty + dy][tx + dx], acc[cc]);
  }
  T* o = df1 + ((size_t)n * C + c0) * plane + (size_t)y * W + x;
#pragma unroll
  for (int cc = 0; cc < BCC; ++cc)
    if (cc < nc) o[cc * plane] = from_f32<T>(acc[cc] * inv_c);
}

template <typename T, int MD>
__global__ void __launch_bounds__(TH * TW)
    corr_bwd_f2_kernel(const T* __restrict__ g, const T* __restrict__ out,
                       const T* __restrict__ f1, T* __restrict__ df2, int C,
                       int H, int W, int chunks, float inv_c, float leaky) {
  constexpr int D = 2 * MD + 1;
  constexpr int SW = TW + 2 * MD;
  // f1 halo: s1[cc][r][col] = f1[c0+cc, y0-MD+r, x0-MD+col]
  __shared__ float s1[BCC][TH + 2 * MD][SW];
  // one tap row dy: sg[dx][r][col] = g'[dy*D+dx, y0-(dy-MD)+r, x0-MD+col]
  __shared__ float sg[D][TH][SW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int x = x0 + tx, y = y0 + ty;
  const int n = blockIdx.z / chunks, c0 = (blockIdx.z % chunks) * BCC;
  const int nc = min(BCC, C - c0);
  const size_t plane = (size_t)H * W;
  const size_t gn = (size_t)n * D * D * plane;

  stage_halo<T, MD>(s1, f1 + ((size_t)n * C + c0) * plane, nc, H, W, y0, x0,
                    tid);
  float acc[BCC];
#pragma unroll
  for (int cc = 0; cc < BCC; ++cc) acc[cc] = 0.f;

  for (int dy = 0; dy < D; ++dy) {
    __syncthreads();  // the last row's reads are done (and s1 is staged)
    for (int i = tid; i < D * TH * SW; i += TH * TW) {
      const int dx = i / (TH * SW);
      const int r = (i / SW) % TH;
      const int col = i % SW;
      const int gy = y0 - (dy - MD) + r, gx = x0 - MD + col;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = grad_in(g, out,
                    gn + (dy * D + dx) * plane + (size_t)gy * W + gx, leaky);
      sg[dx][r][col] = v;
    }
    __syncthreads();
    // source pixel (y - (dy-MD), x - (dx-MD)): row ty of sg, row
    // ty + 2MD - dy of s1, column tx + 2MD - dx of both
#pragma unroll
    for (int dx = 0; dx < D; ++dx) {
      const float gv = sg[dx][ty][tx + 2 * MD - dx];
#pragma unroll
      for (int cc = 0; cc < BCC; ++cc)
        acc[cc] = fmaf(gv, s1[cc][ty + 2 * MD - dy][tx + 2 * MD - dx],
                       acc[cc]);
    }
  }
  if (y >= H || x >= W) return;
  T* o = df2 + ((size_t)n * C + c0) * plane + (size_t)y * W + x;
#pragma unroll
  for (int cc = 0; cc < BCC; ++cc)
    if (cc < nc) o[cc * plane] = from_f32<T>(acc[cc] * inv_c);
}

// which: 1 = df1 (f is f2), 2 = df2 (f is f1).
template <typename T, int MD>
void launch_bwd_md(int which, const T* g, const T* out, const T* f, T* df,
                   int n, int c, int h, int w, float leaky,
                   cudaStream_t stream) {
  const int chunks = (c + BCC - 1) / BCC;
  const dim3 block(TW, TH);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n * chunks);
  const float inv_c = (float)(1.0 / c);
  if (which == 1)
    corr_bwd_f1_kernel<T, MD><<<grid, block, 0, stream>>>(
        g, out, f, df, c, h, w, chunks, inv_c, leaky);
  else
    corr_bwd_f2_kernel<T, MD><<<grid, block, 0, stream>>>(
        g, out, f, df, c, h, w, chunks, inv_c, leaky);
}

template <typename T>
int launch_bwd(int which, const void* g, const void* out, const void* f,
               void* df, int n, int c, int h, int w, int md, float leaky,
               cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  const T* ot = static_cast<const T*>(out);
  const T* ft = static_cast<const T*>(f);
  T* dt = static_cast<T*>(df);
  switch (md) {
    case 1:
      launch_bwd_md<T, 1>(which, gt, ot, ft, dt, n, c, h, w, leaky, stream);
      break;
    case 2:
      launch_bwd_md<T, 2>(which, gt, ot, ft, dt, n, c, h, w, leaky, stream);
      break;
    case 3:
      launch_bwd_md<T, 3>(which, gt, ot, ft, dt, n, c, h, w, leaky, stream);
      break;
    case 4:
      launch_bwd_md<T, 4>(which, gt, ot, ft, dt, n, c, h, w, leaky, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int bwd_entry(int which, const void* g, const void* out, const void* f,
              void* df, int n, int c, int h, int w, int md, int dtype,
              float leaky, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 ||
      (long long)n * ((c + BCC - 1) / BCC) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(which, g, out, f, df, n, c, h, w, md, leaky, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(which, g, out, f, df, n, c, h, w, md,
                                       leaky, s);
    case 2:
      return launch_bwd<__half>(which, g, out, f, df, n, c, h, w, md, leaky,
                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16. Returns cudaGetLastError() after the
// launch (0 on success); nothing is synchronised or allocated here.
extern "C" int mfn_corr_fwd(const void* f1, const void* f2, void* out, int n,
                            int c, int h, int w, int md, int dtype,
                            float leaky, int use_leaky, void* stream) {
  if (n <= 0 || n > 65535 || c <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(f1, f2, out, n, c, h, w, md, leaky, use_leaky, s);
    case 1:
      return launch<__nv_bfloat16>(f1, f2, out, n, c, h, w, md, leaky,
                                   use_leaky, s);
    case 2:
      return launch<__half>(f1, f2, out, n, c, h, w, md, leaky, use_leaky, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// g, out: (N, D*D, H, W); f2 / f1 and the result: (N, C, H, W); one dtype
// (0 = f32, 1 = bf16, 2 = f16). out == NULL: no LeakyReLU (leaky unread).
// Return as mfn_corr_fwd.
extern "C" int mfn_corr_bwd_f1(const void* g, const void* out, const void* f2,
                               void* df1, int n, int c, int h, int w, int md,
                               int dtype, float leaky, void* stream) {
  return bwd_entry(1, g, out, f2, df1, n, c, h, w, md, dtype, leaky, stream);
}

extern "C" int mfn_corr_bwd_f2(const void* g, const void* out, const void* f1,
                               void* df2, int n, int c, int h, int w, int md,
                               int dtype, float leaky, void* stream) {
  return bwd_entry(2, g, out, f1, df2, n, c, h, w, md, dtype, leaky, stream);
}

extern "C" const char* mfn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
