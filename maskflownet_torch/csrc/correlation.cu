// FlowNet-C correlation cost volume, forward, with the fused LeakyReLU
// epilogue -- the Hopper (sm_90a) kernel of maskflownet_torch.
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

extern "C" const char* mfn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
