// Bilinear resampling at absolute source coordinates -- the Hopper (sm_90a)
// kernel of maskflownet_torch's device-side geometric augmentation.
//
//   out[n, c, y, x] = sum over the 4 corners (iy, ix) of (sy, sx) of
//                     w(iy, ix) * img[n, c, iy, ix]
//
// with (sy, sx) = (sy[n, y, x], sx[n, y, x]), the usual bilinear weights
// (1 - fy or fy) * (1 - fx or fx) of the fractions fy = sy - floor(sy),
// fx = sx - floor(sx), and corners outside the image contributing zero.
// img is NCHW f32 or bf16, sy/sx are (N, Ho, Wo) f32, out is (N, C, Ho, Wo)
// f32; weights, products and sums are f32.
//
// Replaces maskflownet_tpu/ops/pallas/affine.py::_kernel (called by
// windowed_sample). That kernel stages a bounded source window per output
// tile in VMEM, interpolates rows with a one-hot matmul on the MXU and holds
// its last precise_ch channels to ~f32 with a bf16 hi/lo split. Window,
// one-hot and split are devices of the TPU: here every thread reads its four
// corners straight from global memory (through L1/L2), so no window bound is
// needed, and every channel is sampled in f32, more exactly than the TPU
// kernel samples its bf16 image channels.
//
// What bounds it on an H100: bytes. Per output pixel it reads two f32
// coordinates and 4*C source values and writes C values, against ~8*C
// flops: far below every ridge. The design keeps the traffic near one read
// of the source and one write of the output:
//   * one thread per output pixel, looping over the C channel planes, so
//     the coordinates, weights and corner offsets are computed once per
//     pixel and reused for every channel;
//   * consecutive threads take consecutive output x: their stores are
//     coalesced, and since an affine map is smooth their corner reads fall
//     on neighbouring source pixels, which one cache line serves;
//   * out-of-image corners get a zero weight and an index clamped into the
//     image, so every load is in bounds and no branch diverges per channel.
// This is the simple first version: no shared-memory staging, no vector
// loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    affine_sample_kernel(const T* __restrict__ img,
                         const float* __restrict__ sy,
                         const float* __restrict__ sx, float* __restrict__ out,
                         int C, int H, int W, int P) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;  // output pixel y*Wo + x
  const int n = blockIdx.y;
  if (p >= P) return;
  const long long q = (long long)n * P + p;
  const float y = sy[q];
  const float x = sx[q];
  // fractions from the unclamped floor, as the plain version takes them;
  // the integer corner is clamped to [-2, H] first, so a far-away (or
  // non-finite) coordinate converts to an int safely and reads zeros
  const float y0f = floorf(y);
  const float x0f = floorf(x);
  const float fy = y - y0f;
  const float fx = x - x0f;
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)H);
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)W);
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const float w00 = (vy0 && vx0) ? (1.0f - fy) * (1.0f - fx) : 0.0f;
  const float w01 = (vy0 && vx1) ? (1.0f - fy) * fx : 0.0f;
  const float w10 = (vy1 && vx0) ? fy * (1.0f - fx) : 0.0f;
  const float w11 = (vy1 && vx1) ? fy * fx : 0.0f;
  const int ya = min(max(y0, 0), H - 1), yb = min(max(y0 + 1, 0), H - 1);
  const int xa = min(max(x0, 0), W - 1), xb = min(max(x0 + 1, 0), W - 1);
  const int o00 = ya * W + xa, o01 = ya * W + xb;
  const int o10 = yb * W + xa, o11 = yb * W + xb;
  const long long plane = (long long)H * W;
  const T* src = img + (long long)n * C * plane;
  float* dst = out + (long long)n * C * P + p;
  for (int c = 0; c < C; ++c) {
    float v = to_f32(src[o00]) * w00;
    v += to_f32(src[o01]) * w01;
    v += to_f32(src[o10]) * w10;
    v += to_f32(src[o11]) * w11;
    dst[(long long)c * P] = v;
    src += plane;
  }
}

template <typename T>
int launch(const void* img, const float* sy, const float* sx, float* out,
           int n, int c, int h, int w, int p, cudaStream_t stream) {
  dim3 grid((p + BLOCK - 1) / BLOCK, n);
  affine_sample_kernel<T><<<grid, BLOCK, 0, stream>>>(
      static_cast<const T*>(img), sy, sx, out, c, h, w, p);
  return (int)cudaGetLastError();
}

}  // namespace

// img: (N, C, H, W) contiguous, dtype 0 = f32, 1 = bf16; sy, sx: (N, Ho, Wo)
// contiguous f32; out: (N, C, Ho, Wo) contiguous f32. Returns
// cudaGetLastError() after the launch (0 on success); nothing is
// synchronised or allocated here.
extern "C" int mfn_affine_sample(const void* img, const void* sy,
                                 const void* sx, void* out, int n, int c,
                                 int h, int w, int ho, int wo, int dtype,
                                 void* stream) {
  if (n <= 0 || n > 65535 || c <= 0 || h <= 0 || w <= 0 || ho <= 0 ||
      wo <= 0 || (long long)h * w >= (1LL << 31) ||
      (long long)ho * wo >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fy = static_cast<const float*>(sy);
  const float* fx = static_cast<const float*>(sx);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      return launch<float>(img, fy, fx, o, n, c, h, w, ho * wo, s);
    case 1:
      return launch<__nv_bfloat16>(img, fy, fx, o, n, c, h, w, ho * wo, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mfn_affine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
