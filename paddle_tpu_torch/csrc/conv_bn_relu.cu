// Fused conv2d + folded batch norm + relu, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py:_gemm_epilogue_kernel
// (launched by _fused_gemm) and computes the same function as the plain
// version
//   paddle_tpu_torch/kernels/conv_bn_relu.py:fused_conv_bn_relu_reference
// over the same layouts: x [N, C, H, W], w [F, C, KH, KW], scale and
// shift [F], y [N, F, OH, OW], all NCHW float32:
//   y[n, f, oh, ow] = act(sum_k P[m, k] * w[f, k] * scale[f] + shift[f])
// with m = (n, oh, ow), k = (c, i, j) in the channel-major patch order,
// P[m, k] = x[n, c, oh*s - p + i, ow*s - p + j] (0 outside the image)
// and act = relu or the identity. The affine and relu are applied to
// the float32 accumulator before the one store, as in the TPU kernel.
//
// What bounds it on this card: operations. A ResNet-50 convolution does
// 2*M*K*F flops on (x + w + y) bytes; at batch 16 that is 30-300 flops
// per byte, far above the H100's ~20 float32 flops per byte of HBM
// bandwidth, so the floor is 2*M*K*F / 67 TFLOP/s (float32 outside the
// tensor cores; TF32 would change the numerics against the reference's
// matmul_precision='highest'). The design:
//   - implicit GEMM: the TPU kernel gets a patch matrix P [M, K] that
//     XLA materialised in HBM; here each block gathers its patch tile
//     straight from x by index math (a zero for a pad position), so P
//     never exists (118 MB at the stem with batch 16);
//   - one block of 256 threads computes a 64 (m) x 64 (f) output tile,
//     looping over K in 16-wide slices staged in shared memory (the
//     patch slice and the weight slice, the latter transposed to
//     [k][f] with one float of padding); each thread keeps a 4 x 4
//     register tile of accumulators, rows m0 + tm + 16*i and columns
//     f0 + tf + 16*j, and runs scalar FMAs;
//   - patch loads: a warp reads 32 consecutive m for one k, i.e.
//     consecutive ow, so stride-1 loads coalesce; weight loads read 16
//     consecutive k of a filter row;
//   - the epilogue writes y straight in NCHW: consecutive m are
//     consecutive (oh, ow), so a warp's stores coalesce along ow and no
//     transpose runs afterwards;
//   - every output element sums k = 0, 1, ..., K-1 as one FMA chain, so
//     its value does not depend on M (on how many images share the
//     batch) or on the tile it lands in;
//   - M, F and K that fit no tile are masked in the kernel (no padding
//     copies).
// Not done yet (later work): tensor cores (TF32 or bf16 wgmma), TMA or
// cp.async double-buffering of the K slices, bf16 operands.
//
// The kernel allocates nothing; the caller passes the output.
// conv_bn_relu_f32 launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBM = 64;        // output rows (m = n, oh, ow) per block
constexpr int kBF = 64;        // output channels per block
constexpr int kBK = 16;        // reduction slice staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kT = 4;          // outputs per thread along m and along f

__global__ void __launch_bounds__(kThreads)
conv_bn_relu_kernel(const float* __restrict__ x,
                    const float* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    float* __restrict__ y,
                    int N, int C, int H, int W, int F, int KH, int KW,
                    int stride, int pad, int OH, int OW, int relu) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBF + 1];

  const int t = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int f0 = blockIdx.y * kBF;
  const int OHW = OH * OW;
  const int M = N * OHW;
  const int KHW = KH * KW;
  const int K = C * KHW;

  // the one patch row this thread stages: m = m0 + t % 64, slice rows
  // t / 64 + 4 * r (r = 0..3)
  const int lm = t % kBM;
  const int lk = t / kBM;
  const int am = m0 + lm;
  const bool am_ok = am < M;
  const float* xb = x;
  int ih0 = 0, iw0 = 0;
  if (am_ok) {
    const int n = am / OHW;
    const int r = am - n * OHW;
    const int oh = r / OW;
    const int ow = r - oh * OW;
    xb = x + static_cast<int64_t>(n) * C * H * W;
    ih0 = oh * stride - pad;
    iw0 = ow * stride - pad;
  }

  const int tm = t % 16;  // this thread's m columns: tm + 16 * i
  const int tf = t / 16;  // this thread's f columns: tf + 16 * j
  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // patch slice: As[kk][mm] = P[m0 + mm, k0 + kk]
#pragma unroll
    for (int r = 0; r < kBK * kBM / kThreads; ++r) {
      const int kk = lk + r * (kThreads / kBM);
      const int k = k0 + kk;
      float v = 0.f;
      if (am_ok && k < K) {
        const int c = k / KHW;
        const int rem = k - c * KHW;
        const int i = rem / KW;
        const int ih = ih0 + i;
        const int iw = iw0 + (rem - i * KW);
        if (static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
            static_cast<unsigned>(iw) < static_cast<unsigned>(W))
          v = xb[(static_cast<int64_t>(c) * H + ih) * W + iw];
      }
      As[kk][lm] = v;
    }
    // weight slice: Bs[kk][ff] = w[f0 + ff, k0 + kk]
#pragma unroll
    for (int r = 0; r < kBK * kBF / kThreads; ++r) {
      const int idx = t + r * kThreads;
      const int kk = idx % kBK;
      const int ff = idx / kBK;
      const int k = k0 + kk;
      const int f = f0 + ff;
      Bs[kk][ff] = (f < F && k < K) ? w[static_cast<int64_t>(f) * K + k]
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kT], b[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) a[i] = As[kk][tm + 16 * i];
#pragma unroll
      for (int j = 0; j < kT; ++j) b[j] = Bs[kk][tf + 16 * j];
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: acc * scale + shift (two roundings, as the reference's
  // separate multiply and add), relu, one store into NCHW
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int m = m0 + tm + 16 * i;
    if (m >= M) continue;
    const int n = m / OHW;
    const int r = m - n * OHW;
    float* yb = y + static_cast<int64_t>(n) * F * OHW + r;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int f = f0 + tf + 16 * j;
      if (f >= F) continue;
      float v = __fadd_rn(__fmul_rn(acc[i][j], scale[f]), shift[f]);
      if (relu) v = fmaxf(v, 0.f);
      yb[static_cast<int64_t>(f) * OHW] = v;
    }
  }
}

}  // namespace

extern "C" {

int conv_bn_relu_f32(const void* x, const void* w, const void* scale,
                     const void* shift, void* y, int N, int C, int H, int W,
                     int F, int KH, int KW, int stride, int pad, int OH,
                     int OW, int relu, void* stream) {
  if (N == 0 || F == 0 || OH == 0 || OW == 0) return cudaSuccess;
  if (N < 0 || C <= 0 || H <= 0 || W <= 0 || F < 0 || KH <= 0 || KW <= 0 ||
      stride <= 0 || pad < 0 || OH < 0 || OW < 0)
    return cudaErrorInvalidValue;
  const int64_t M = static_cast<int64_t>(N) * OH * OW;
  if (M > (int64_t{1} << 31) - kBM) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((F + kBF - 1) / kBF));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  conv_bn_relu_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(y), N, C, H, W, F, KH, KW, stride, pad, OH, OW,
      relu);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
