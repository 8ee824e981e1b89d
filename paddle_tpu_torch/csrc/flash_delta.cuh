// The flash backward's row statistic delta = sum_d dO * O, float32, for
// Hopper (sm_90a): flash_delta, over dO and O [rows, D] in float32 or
// bfloat16 (both one type). flash_attention.cu includes this file: it
// builds into libflash_attention.
//
// It is not a TPU kernel: it stands for the jnp line of
//   paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py:_flash_bwd
// (delta = jnp.sum(do32 * out.astype(jnp.float32), axis=-1)), which XLA
// fuses into one pass, and computes the same function as the plain
// version (paddle_tpu_torch/kernels/flash_attention.py:
// flash_delta_reference): each product in float32 (exact for bfloat16
// operands), the row's sum in float32, in another order than PyTorch's.
//
// What bounds it on this card: bytes. dO and O are read once and delta
// written once (2 D sizeof(T) + 4 bytes a row, one multiply-add an
// element). The design: 16-byte loads; a row is split over L lanes (the
// power of two at or above its D sizeof(T) / 16 chunks, at most 32), each
// lane sums its chunks in order, then the L lanes add by butterfly; a
// warp takes 32 / L rows, a block 8 warps. D sizeof(T) is a multiple of
// 16 (the wrapper zero-pads head_dim, which adds exact zeros). Measured:
// loading two or more rows a lane before summing was not faster.
//
// flash_delta launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace flash_delta_ns {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// the 16-byte chunk's products dO * O added to acc in element order
__device__ __forceinline__ float chunk_dot(const uint4& a, const uint4& b,
                                           float acc, float) {
  const float* x = reinterpret_cast<const float*>(&a);
  const float* y = reinterpret_cast<const float*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc = fmaf(x[i], y[i], acc);
  return acc;
}

__device__ __forceinline__ float chunk_dot(const uint4& a, const uint4& b,
                                           float acc, __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 v = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// L lanes a row, 32 / L rows a warp
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const uint4* __restrict__ dout, const uint4* __restrict__ o,
                   float* __restrict__ delta, int64_t rows, int chunks,
                   int lanes) {
  const int lane = threadIdx.x % 32;
  const int per_warp = 32 / lanes;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWarps +
                       threadIdx.x / 32) * per_warp + lane / lanes;
  const int part = lane % lanes;
  float acc = 0.f;
  if (row < rows) {
    const uint4* a = dout + row * chunks;
    const uint4* b = o + row * chunks;
    for (int c = part; c < chunks; c += lanes)
      acc = chunk_dot(__ldg(a + c), __ldg(b + c), acc, T());
  }
  for (int off = lanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) delta[row] = acc;
}

template <typename T>
cudaError_t launch(const void* dout, const void* o, float* delta,
                   int64_t rows, int D, cudaStream_t stream) {
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  const int64_t per_block = kWarps * (32 / lanes);
  const int64_t blocks = (rows + per_block - 1) / per_block;
  flash_delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(static_cast<const uint4*>(dout),
                                    static_cast<const uint4*>(o), delta, rows,
                                    chunks, lanes);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_delta_ns

extern "C" {

// dout, o: [rows, D] float32 (bf16 = 0) or bfloat16 (bf16 = 1), 16-byte
// aligned, D * sizeof(element) a multiple of 16; delta: [rows] float32
int flash_delta(const void* dout, const void* o, void* delta, int rows,
                int D, int bf16, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if (rows < 0 || D <= 0 || (D * elem) % 16) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(delta);
  const cudaError_t e =
      bf16 ? flash_delta_ns::launch<__nv_bfloat16>(dout, o, out, rows, D, s)
           : flash_delta_ns::launch<float>(dout, o, out, rows, D, s);
  return static_cast<int>(e);
}

}  // extern "C"
