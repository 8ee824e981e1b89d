// 3xTF32 tensor-core products and cp.async staging for Hopper (sm_90a):
// the helpers that the flash attention kernels (flash_attention.cu) and
// the fused conv GEMM (conv_bn_relu.cu) share.
//
// 3xTF32: each float32 operand x is split into big = tf32(x) and
// small = x - big (see split()), and a*b is summed as a_big*b_big +
// a_big*b_small + a_small*b_big with mma.sync m16n8k8 into float32
// fragments: float32-level accuracy at the tensor cores' TF32 rate / 3
// (a single TF32 product would err ~1000x more). This is the arithmetic
// of PyTorch's float32 memory-efficient attention (CUTLASS's fast-float32
// products).
//
// _build.py hashes every csrc/*.cuh with each .cu, so an edit here
// rebuilds both libraries.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace tf32x3 {

// cp.async: 16 bytes (or 4) from global to shared memory, bypassing the
// registers; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 3xTF32: x = big + small; a*b ~ a_big*b_big + a_big*b_small +
// a_small*b_big runs float32-accurate products on the tensor cores (the
// dropped a_small*b_small is at most 2^-22 of the product). big is x
// rounded to TF32, to nearest with ties away (the result of
// cvt.rna.tf32.f32), by integer arithmetic: cvt runs at a quarter of the
// integer rate on this card and was the kernels' bottleneck. small =
// x - big is exact in float32 and |small| <= 2^-11 |x|; the tensor core
// reads a .tf32 operand's top 19 bits, so small enters the product
// truncated to TF32 (|error| < 2^-10 |small| <= 2^-21 |x|), as in
// CUTLASS's fast-float32 products that PyTorch's float32 attention uses.
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
    small[i] = __float_as_uint(x[i] - __uint_as_float(big[i]));
  }
}

// d += a * b for one m16n8k8 TF32 tile, float32 accumulators. Fragments
// (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]. Not volatile: the compiler may interleave
// independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d_i += a_i * b_i in 3xTF32 for four independent tiles: the small
// terms of all four first, then the big ones, so that no product waits
// on the one issued just before it (an MMA's latency is many cycles).
__device__ __forceinline__ void mma3x4(
    float (&d0)[4], float (&d1)[4], float (&d2)[4], float (&d3)[4],
    const uint32_t (&ab0)[4], const uint32_t (&as0)[4],
    const uint32_t (&ab1)[4], const uint32_t (&as1)[4],
    const uint32_t (&ab2)[4], const uint32_t (&as2)[4],
    const uint32_t (&ab3)[4], const uint32_t (&as3)[4],
    const uint32_t (&bb)[4][2], const uint32_t (&bs)[4][2]) {
  mma_tf32(d0, as0, bb[0]);
  mma_tf32(d1, as1, bb[1]);
  mma_tf32(d2, as2, bb[2]);
  mma_tf32(d3, as3, bb[3]);
  mma_tf32(d0, ab0, bs[0]);
  mma_tf32(d1, ab1, bs[1]);
  mma_tf32(d2, ab2, bs[2]);
  mma_tf32(d3, ab3, bs[3]);
  mma_tf32(d0, ab0, bb[0]);
  mma_tf32(d1, ab1, bb[1]);
  mma_tf32(d2, ab2, bb[2]);
  mma_tf32(d3, ab3, bb[3]);
}

// acc[i] += tile[i] for N accumulator tiles: float32 adds, rounded to
// nearest. The tensor core does not round the sum it writes to nearest,
// so an accumulator that every streamed tile adds into drifts, more the
// longer the reduction; sums collected in fresh fragments and added here
// keep the error on the order of a plain float32 product's.
template <int N>
__device__ __forceinline__ void add_tiles(float (*acc)[4],
                                          const float (&tile)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += tile[i][e];
}

// The A fragment of k-step ks from a 16-row slice of shared memory
// (rows r, r + 8 at stride ld), split into big and small parts.
__device__ __forceinline__ void load_a(const float* rows, int ld, int ks,
                                       int g, int t, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  const float* p = rows + g * ld + 8 * ks + t;
  const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  split(x, ab, as);
}

// The B fragment of B = M^T for an [N][K]-stored M (score products:
// n-tile j, k-step ks): b = M[8j + g][8ks + t], M[8j + g][8ks + t + 4].
__device__ __forceinline__ void load_bt(const float* m, int ld, int j, int ks,
                                        int g, int t, uint32_t (&bb)[2],
                                        uint32_t (&bs)[2]) {
  const float* p = m + (8 * j + g) * ld + 8 * ks + t;
  const float x[2] = {p[0], p[4]};
  split(x, bb, bs);
}

// The B fragment of a [K][N]-stored B whose k index is permuted as the
// accumulator layout leaves it (see acc_as_a): k-step kk, n-tile n:
// b = B[8kk + 2t][8n + g], B[8kk + 2t + 1][8n + g].
__device__ __forceinline__ void load_bp(const float* m, int ld, int kk, int n,
                                        int g, int t, uint32_t (&bb)[2],
                                        uint32_t (&bs)[2]) {
  const float* p = m + (8 * kk + 2 * t) * ld + 8 * n + g;
  const float x[2] = {p[0], p[ld]};
  split(x, bb, bs);
}

// An accumulator tile (P^T, dS^T or dS) as the A fragment of the next
// product, k permuted: A's k = t, t + 4 are the tile's columns 2t, 2t+1.
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&ab)[4],
                                         uint32_t (&as)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split(x, ab, as);
}

}  // namespace tf32x3
