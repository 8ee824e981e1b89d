// Layer norm forward over the rows of x [N, F], float32 or bfloat16, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/fluid/ops/pallas_kernels/layer_norm.py:_ln_kernel
// (launched by _ln_pallas) and computes the same function as the plain
// version
//   paddle_tpu_torch/kernels/layer_norm.py:layer_norm_reference
// per row: x, scale and bias widened to float32 on load, mean, the biased
// variance of (x - mean), rstd = 1/sqrt(var + eps), y = (x - mean) * rstd
// * scale + bias in float32, rounded once to x's type (to nearest even for
// bfloat16, as _ln_kernel's astype). It writes y [N, F] and the float32
// row statistics mean [N] and rstd [N] (the backward and the op's
// Variance output are built from them).
//
// What bounds it on this card: bytes. It does ~8 flops per element and
// moves 8 bytes (float32) or 4 (bfloat16) per element (x read, y
// written), far below the H100's ~20 f32 flops per byte of HBM
// bandwidth, so the floor is 2 * N * F * sizeof(T) bytes over 3.35 TB/s.
// The design reads x from device memory once:
//   - one warp per row, four rows per block; lane i reads elements
//     i, i + 32, ... so every load and store is coalesced;
//   - three passes over the row (sum, centred sum of squares, write):
//     the second and third read the row back from L1, not from HBM;
//   - the variance is the centred two-pass form, as in _ln_kernel, and
//     rstd is 1 / sqrtf (IEEE sqrt and division, not the approximate
//     rsqrtf).
// Not done yet (later work): 16-byte loads, the row kept in registers.
//
// The kernel allocates nothing; the caller passes the outputs.
// layer_norm_f32 and layer_norm_bf16 launch on the given stream and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 4;  // rows per block, one a warp
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int N, int F, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;  // the whole warp leaves together
  const T* xr = x + static_cast<int64_t>(row) * F;
  const float f = static_cast<float>(F);

  float s = 0.f;
  for (int i = lane; i < F; i += 32) s += widen(xr[i]);
  const float mean = warp_sum(s) / f;

  float v = 0.f;
  for (int i = lane; i < F; i += 32) {
    const float c = widen(xr[i]) - mean;
    v = fmaf(c, c, v);
  }
  const float var = warp_sum(v) / f;
  const float rstd = 1.0f / sqrtf(var + eps);

  T* yr = y + static_cast<int64_t>(row) * F;
  for (int i = lane; i < F; i += 32)
    narrow(yr + i,
           (widen(xr[i]) - mean) * rstd * widen(scale[i]) + widen(bias[i]));
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           void* mean, void* rstd, int N, int F, float eps, void* stream) {
  if (N == 0) return cudaSuccess;
  if (N < 0 || F <= 0) return cudaErrorInvalidValue;
  const int blocks = (N + kWarps - 1) / kWarps;
  layer_norm_kernel<T><<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), N, F, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int layer_norm_f32(const void* x, const void* scale, const void* bias,
                   void* y, void* mean, void* rstd, int N, int F, float eps,
                   void* stream) {
  return launch<float>(x, scale, bias, y, mean, rstd, N, F, eps, stream);
}

// the same with bfloat16 x, scale, bias and y (mean and rstd float32)
int layer_norm_bf16(const void* x, const void* scale, const void* bias,
                    void* y, void* mean, void* rstd, int N, int F, float eps,
                    void* stream) {
  return launch<__nv_bfloat16>(x, scale, bias, y, mean, rstd, N, F, eps,
                               stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
