// Flash attention, float32, for Hopper (sm_90a): the forward pass and
// the two kernels of the backward pass.
//
// Replaces the Pallas TPU kernels of
//   paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py
//     _fwd_kernel       (launched by _fwd_pallas)    -> flash_fwd_f32
//     _bwd_dkdv_kernel  (launched by _flash_bwd)     -> flash_bwd_dkdv_f32
//     _bwd_dq_kernel    (launched by _flash_bwd)     -> flash_bwd_dq_f32
// and computes the same functions as the plain versions
//   paddle_tpu_torch/kernels/flash_attention.py:
//     flash_attention_fwd_reference, flash_attention_bwd_reference
// over the same layouts: q [BH, Sq, D], k and v [BH, Sk, D], O and dO
// [BH, Sq, D], lse and delta [BH, Sq], all contiguous. Causal masking
// keeps key t for query row i when t <= i (absolute positions, as the
// TPU kernel's qpos >= kpos, also when Sq != Sk).
//
//   forward   s = scale * q.k, online softmax over key tiles, O = P V /
//             max(l, FLT_MIN), lse = m + log(max(l, FLT_MIN)); masked
//             scores take -1e30 and their probabilities are exactly 0.
//   dK, dV    p = exp(s - lse) recomputed per (query, key) pair and set
//             to 0 (not masked) on padded rows and columns;
//             ds = p (dO.v - delta), dV = P^T dO, dK = scale * dS^T Q.
//   dQ        dQ = scale * dS K.
// delta = rowsum(dO * O) is computed by the caller, as the JAX package
// does outside its pallas_calls.
//
// What bounds them on this card: operations. At the training shapes
// (BH = 128, S = 512, D = 64) each kernel does 4-8 flops per byte of
// q/k/v it must read, and each input tile is reused by every row of the
// block. All kernels keep the S x S score matrix out of device memory,
// read each operand tile once per block, use one block of 4 warps per
// (batch-head, 64 rows) with 16 rows a warp, skip whole causal tiles
// (the forward and dQ stop at the block's last row, dK/dV starts at the
// tile holding its first key), mask the ragged edge inside the kernel
// (no padding of the inputs) and never write rows past the end.
//
// The forward (K2) runs on scalar FMAs: its floor is the f32 flops over
// 67 TFLOP/s. Lane j scores row j of a 32-row K/V tile against the
// warp's 16 query rows; the accumulators (running max and sum, the
// D-wide output rows) sit in registers, lane l holding columns l,
// l + 32, ... Not done yet: tensor cores, cp.async tiles.
//
// The backward kernels (K3a dK/dV, K3b dQ) run their four (three)
// products on the tensor cores in 3xTF32, the arithmetic of PyTorch's
// float32 memory-efficient attention: each operand x is split into
// big = tf32(x) and small = x - big (see split()), and a*b is summed as
// a_big*b_big + a_big*b_small + a_small*b_big with mma.sync m16n8k8 into
// float32 fragments (a single TF32 product would err ~1000x more). Their
// floor is 3x the products' flops over 495 TFLOP/s (TF32 dense) plus the
// exp and ds arithmetic over the f32 peak. The design:
//   - warp w owns 16 rows of the block (keys in K3a, query rows in K3b)
//     as the m16 side of every product; the other operand streams in
//     tiles of BT = 64 rows (32 at head_dim bucket 128), staged with
//     16-byte cp.async into two buffers: tile i + 1 loads while tile i
//     computes, one __syncthreads() a tile;
//   - shared rows have stride D_pad + 4 = 4 (mod 32) floats, so every
//     32-bit fragment load (row g = lane / 4, column t = lane % 4, or
//     row 2t, column g) hits 32 distinct banks; head_dim is zero-padded
//     to its bucket (32, 64, 128) in shared memory only, rows past the
//     end are zero-filled (cp.async with src-size 0) and the store of
//     the head_dim tail is masked;
//   - P (K3a: P^T and dS^T; K3b: dS) goes from the accumulators of the
//     score products into the A operand of the next product without a
//     shuffle or a trip through shared memory: the accumulator holds
//     columns 2t, 2t + 1 where the A fragment wants k = t, t + 4, so
//     that product runs over a permuted k (A's t, t + 4 are the tile's
//     2t, 2t + 1) and its B fragment loads rows 2t and 2t + 1 to match.
//     This costs nothing and keeps shared memory for the tiles (two
//     blocks an SM at head_dim 64);
//   - operands are split when their fragments are loaded. The block's
//     own 16-row A fragments (K/V in K3a, Q/dO in K3b) are reused by
//     all BT / 8 n-tiles of a k-step, so their split is a small share;
//     keeping them pre-split would take 64 more registers a lane or a
//     second copy in shared memory (one block an SM);
//   - every product is issued as three phases over four independent
//     accumulator tiles (small terms first), so no MMA waits on the one
//     just before it;
//   - the tensor core does not round the sum it writes to nearest, so
//     an accumulator that every streamed tile adds into drifts, more
//     the longer the sequence and the larger the output. The products
//     that accumulate over tiles (dV, dK; dQ) collect each tile's sum in
//     fresh fragments and add it to the accumulators with float32 adds,
//     which round to nearest: dQ/dK/dV then err against float64 on the
//     order of the plain float32 version (chip_smoke.py reads both
//     against float64; PERF.md has the readings);
//   - exp, the masks, ds = p (dp - delta) and the final scale stay in
//     float32 on the ALUs: p = 2^(s scale log2(e) - lse log2(e)), one
//     FFMA and one ex2; padded rows and columns get p = 0, and a tile
//     with no edge and no causal diagonal in the warp's rows skips the
//     mask;
//   - no atomics: each output element is written once by one lane, and
//     two launches on the same inputs give bitwise-equal outputs.
// What holds them below that floor (PERF.md has the times): issue
// slots. Each 3-MMA product of a B fragment also costs 2 shared loads
// and 6 integer/float ops to split it, and all four warps split the
// same streamed tile. Not done yet: wgmma (its TF32 B operand comes
// from shared memory, so 3xTF32 needs two swizzled copies of each B
// tile), TMA, 32 rows a warp (each B fragment split once for two MMAs;
// K3a's accumulators would not fit in registers), a persistent grid.
//
// The kernels allocate nothing; the caller passes the outputs. Each C
// entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;       // rows each warp owns
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a block owns (64)
constexpr int kTile = 32;              // forward: streamed rows a tile, 1 a lane
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [r0, r0 + n) of a row-major [S, D] matrix into shared memory
// with row stride ld, times mul; rows at or past S become zeros. D is a
// multiple of 4 and the source is 16-byte aligned: float4 loads.
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const float* __restrict__ src, int r0,
                                      int n, int S, int D, float mul) {
  const int d4 = D / 4;
  for (int i = threadIdx.x; i < n * d4; i += kThreads) {
    const int r = i / d4;
    const int dd = (i % d4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      v = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + r) * D + dd);
    float* o = dst + r * ld + dd;
    o[0] = v.x * mul;
    o[1] = v.y * mul;
    o[2] = v.z * mul;
    o[3] = v.w * mul;
  }
}

// ------------------------------------------- backward: tensor-core tools
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

// Stage rows [r0, r0 + n) of a row-major [S, D] matrix into shared
// memory as n rows of DP floats with row stride ld: rows at or past S
// and columns D..DP-1 are zero-filled. D is a multiple of 4 and the
// source 16-byte aligned.
template <int DP>
__device__ __forceinline__ void stage_async(float* dst, int ld,
                                            const float* __restrict__ src,
                                            int r0, int n, int S, int D) {
  constexpr int kChunks = DP / 4;
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const bool ok = r0 + r < S && c < D;
    cp_async16(dst + r * ld + c,
               ok ? src + static_cast<int64_t>(r0 + r) * D + c : src,
               ok ? 16 : 0);
  }
}

// Entries [r0, r0 + n) of a length-S vector; zeros past S.
__device__ __forceinline__ void stage_vec_async(float* dst,
                                                const float* __restrict__ src,
                                                int r0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = r0 + i < S;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok ? 4 : 0);
  }
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
// nearest (see the head comment).
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
// accumulator layout leaves it (see the head comment): k-step kk,
// n-tile n: b = B[8kk + 2t][8n + g], B[8kk + 2t + 1][8n + g].
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

// ---------------------------------------------------------------- fwd
// grid (BH, ceil(Sq / 64)). NE = accumulator floats per lane per row:
// D <= 32 * NE.
template <int NE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int D,
                 int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                     // [kRows][D], pre-scaled
  float* ks = qs + kRows * D;           // [kTile][D + 1]
  float* vs = ks + kTile * (D + 1);     // [kTile][D]

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;

  stage(qs, D, qb, q0, kRows, Sq, D, scale);

  // the keys this block reads: all of them, or up to its last row
  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;

  int limit[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NE];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + warp * kRowsPerWarp + i;
    // a row past the end sees no key; a causal row sees keys <= qpos
    limit[i] = qpos >= Sq ? -1 : (causal ? min(qpos, Sk - 1) : Sk - 1);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is ready)
    stage(ks, D + 1, kb, t0, kTile, Sk, D, 1.f);
    stage(vs, D, vb, t0, kTile, Sk, D, 1.f);
    __syncthreads();

    // scores: lane j scores key t0 + j against each of the warp's rows
    const int t = t0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* kr = ks + lane * (D + 1);
    const float* qw = qs + warp * kRowsPerWarp * D;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] = fmaf(qw[i * D + d], kd, s[i]);
    }

    // online softmax: one max and one sum reduction per tile and row
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool keep = t <= limit[i];
      const float si = keep ? s[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float alpha = expf(m[i] - m_new);
      p[i] = keep ? expf(si - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= alpha;
    }

    // acc[row][d] += sum_j p[row][j] * V[j][d]; lane owns d = lane + 32e
    const int n_here = min(kTile, n_keys - t0);
    for (int j = 0; j < n_here; ++j) {
      float vd[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = lane + 32 * e;
        vd[e] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[i][e] = fmaf(pj, vd[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + warp * kRowsPerWarp + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], FLT_MIN);
    float* orow = o + (bh * Sq + qpos) * D;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) orow[d] = acc[i][e] / denom;
    }
    if (lane == 0) lse[bh * Sq + qpos] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------- dK dV
// grid (BH, ceil(Sk / 64)): the block owns 64 keys, 16 a warp, and
// streams query tiles of BT rows, double-buffered with cp.async, from
// the first tile a causal key can see. DP: head_dim padded up to its
// bucket (32, 64 or 128); BT: 64, or 32 at DP = 128 (registers).
template <int DP, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int Sq, int Sk, int D, int causal, float scale) {
  constexpr int LD = DP + 4;  // row stride = 4 (mod 32): conflict-free
  constexpr int KS = DP / 8;  // k-steps over head_dim = n-tiles of dK, dV
  constexpr int NT = BT / 8;  // n-tiles of the scores = k-steps of dK, dV
  // n-tiles of dK and dV whose tile sums are held at once: all, but at
  // the 128 bucket the fresh fragments of all 16 would not fit in
  // registers beside the accumulators
  constexpr int NC = DP <= 64 ? KS : 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;                  // [kRows][LD]
  float* vs = ks + kRows * LD;       // [kRows][LD]
  float* qs = vs + kRows * LD;       // [2][BT][LD]
  float* dos = qs + 2 * BT * LD;     // [2][BT][LD]
  float* lses = dos + 2 * BT * LD;   // [2][BT]
  float* deltas = lses + 2 * BT;     // [2][BT]

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* qb = q + bh * Sq * D;
  const float* dob = dout + bh * Sq * D;
  const float* lseb = lse + bh * Sq;
  const float* deltab = delta + bh * Sq;

  // query tiles wholly before this block's first key see none of it
  const int start = causal ? (k0 / BT) * BT : 0;
  const int n_tiles = start < Sq ? (Sq - start + BT - 1) / BT : 0;
  auto stage_tile = [&](int it) {
    const int t0 = start + it * BT;
    const int b = it & 1;
    stage_async<DP>(qs + b * BT * LD, LD, qb, t0, BT, Sq, D);
    stage_async<DP>(dos + b * BT * LD, LD, dob, t0, BT, Sq, D);
    stage_vec_async(lses + b * BT, lseb, t0, BT, Sq);
    stage_vec_async(deltas + b * BT, deltab, t0, BT, Sq);
  };
  stage_async<DP>(ks, LD, k + bh * Sk * D, k0, kRows, Sk, D);
  stage_async<DP>(vs, LD, v + bh * Sk * D, k0, kRows, Sk, D);
  if (n_tiles > 0) stage_tile(0);
  cp_async_commit();

  float acc_k[KS][4], acc_v[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int kw = warp * kRowsPerWarp;  // the warp's first key in the block
  const float scale_log2 = scale * kLog2e;  // p = 2^(s scale log2(e) - ..)
  const float* kwr = ks + kw * LD;
  const float* vwr = vs + kw * LD;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) stage_tile(it + 1);  // overlaps this tile's math
    cp_async_commit();
    const int b = it & 1;
    const int t0 = start + it * BT;
    const float* qt = qs + b * BT * LD;
    const float* dot = dos + b * BT * LD;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BT queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kbig[4], ksml[4], vbig[4], vsml[4];
      load_a(kwr, LD, kk, g, t, kbig, ksml);
      load_a(vwr, LD, kk, g, t, vbig, vsml);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bb[4][2], bs[4][2];
        load_bt(qt, LD, j, kk, g, t, bb[0], bs[0]);
        load_bt(qt, LD, j + 1, kk, g, t, bb[1], bs[1]);
        load_bt(dot, LD, j, kk, g, t, bb[2], bs[2]);
        load_bt(dot, LD, j + 1, kk, g, t, bb[3], bs[3]);
        mma3x4(s[j], s[j + 1], dp[j], dp[j + 1], kbig, ksml, kbig, ksml,
               vbig, vsml, vbig, vsml, bb, bs);
      }
    }

    // P^T and dS^T in place (rows keys, columns queries); padded rows
    // and columns are zeroed, not just masked. A tile with no padded
    // row or column that every key of the warp sees skips the mask.
    auto probs = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          float p = exp2f(s[j][e] * scale_log2 - lses[b * BT + col] * kLog2e);
          if (decltype(masked)::value) {
            const int kpos = k0 + kw + g + (e & 2 ? 8 : 0);
            const int qpos = t0 + col;
            if (!(qpos < Sq && kpos < Sk && (!causal || qpos >= kpos)))
              p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - deltas[b * BT + col]);
        }
    };
    if (t0 + BT <= Sq && k0 + kRows <= Sk &&
        (!causal || t0 >= k0 + kw + kRowsPerWarp - 1))
      probs(std::false_type());
    else
      probs(std::true_type());

    // dV += P^T dO and dK += dS^T Q: k runs over the tile's queries. The
    // tile's sums collect in fresh fragments, NC n-tiles at a time, and
    // join the accumulators by float32 adds (see the head comment).
#pragma unroll
    for (int n0 = 0; n0 < KS; n0 += NC) {
      float tv[NC][4] = {}, tk[NC][4] = {};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t pbig[4], psml[4], dbig[4], dsml[4];
        acc_as_a(s[j], pbig, psml);
        acc_as_a(dp[j], dbig, dsml);
#pragma unroll
        for (int n = 0; n < NC; n += 2) {
          uint32_t bb[4][2], bs[4][2];
          load_bp(dot, LD, j, n0 + n, g, t, bb[0], bs[0]);
          load_bp(dot, LD, j, n0 + n + 1, g, t, bb[1], bs[1]);
          load_bp(qt, LD, j, n0 + n, g, t, bb[2], bs[2]);
          load_bp(qt, LD, j, n0 + n + 1, g, t, bb[3], bs[3]);
          mma3x4(tv[n], tv[n + 1], tk[n], tk[n + 1], pbig, psml, pbig, psml,
                 dbig, dsml, dbig, dsml, bb, bs);
        }
      }
      add_tiles(acc_v + n0, tv);
      add_tiles(acc_k + n0, tk);
    }
  }
  cp_async_wait_all();

  // each output element is written once, by one lane
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + kw + g + 8 * h;
    if (kpos >= Sk) continue;
    float* dkr = dk + (bh * Sk + kpos) * D;
    float* dvr = dv + (bh * Sk + kpos) * D;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int d = 8 * n + 2 * t;  // D is a multiple of 4: d + 1 < D too
      if (d < D) {
        *reinterpret_cast<float2*>(dkr + d) = make_float2(
            acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dvr + d) =
            make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- dQ
// grid (BH, ceil(Sq / 64)): the block owns 64 query rows, 16 a warp,
// and streams key/value tiles of BT rows, double-buffered with
// cp.async, up to its last row when causal.
template <int DP, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, int D,
                    int causal, float scale) {
  constexpr int LD = DP + 4;
  constexpr int KS = DP / 8;  // k-steps over head_dim = n-tiles of dQ
  constexpr int NT = BT / 8;  // n-tiles of the scores = k-steps of dQ
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                  // [kRows][LD]
  float* dos = qs + kRows * LD;      // [kRows][LD]
  float* ks = dos + kRows * LD;      // [2][BT][LD]
  float* vs = ks + 2 * BT * LD;      // [2][BT][LD]

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;

  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_tiles = (n_keys + BT - 1) / BT;
  auto stage_tile = [&](int it) {
    const int b = it & 1;
    stage_async<DP>(ks + b * BT * LD, LD, kb, it * BT, BT, Sk, D);
    stage_async<DP>(vs + b * BT * LD, LD, vb, it * BT, BT, Sk, D);
  };
  stage_async<DP>(qs, LD, q + bh * Sq * D, q0, kRows, Sq, D);
  stage_async<DP>(dos, LD, dout + bh * Sq * D, q0, kRows, Sq, D);
  if (n_tiles > 0) stage_tile(0);
  cp_async_commit();

  // the lane's two query rows: the warp's rows g and g + 8 (lse in
  // log2 units: p = 2^(s * scale * log2(e) - lse * log2(e)))
  const int rw = warp * kRowsPerWarp;
  const float scale_log2 = scale * kLog2e;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + rw + g + 8 * h;
    lse_r[h] = qpos < Sq ? lse[bh * Sq + qpos] * kLog2e : 0.f;
    delta_r[h] = qpos < Sq ? delta[bh * Sq + qpos] : 0.f;
  }
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const float* qw = qs + rw * LD;
  const float* dow = dos + rw * LD;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) stage_tile(it + 1);  // overlaps this tile's math
    cp_async_commit();
    const int b = it & 1;
    const int t0 = it * BT;
    const float* kt = ks + b * BT * LD;
    const float* vt = vs + b * BT * LD;

    // S = Q K^T and dP = dO V^T: the warp's 16 rows x BT keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qbig[4], qsml[4], obig[4], osml[4];
      load_a(qw, LD, kk, g, t, qbig, qsml);
      load_a(dow, LD, kk, g, t, obig, osml);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bb[4][2], bs[4][2];
        load_bt(kt, LD, j, kk, g, t, bb[0], bs[0]);
        load_bt(kt, LD, j + 1, kk, g, t, bb[1], bs[1]);
        load_bt(vt, LD, j, kk, g, t, bb[2], bs[2]);
        load_bt(vt, LD, j + 1, kk, g, t, bb[3], bs[3]);
        mma3x4(s[j], s[j + 1], dp[j], dp[j + 1], qbig, qsml, qbig, qsml,
               obig, osml, obig, osml, bb, bs);
      }
    }

    // dS in place of dP (rows queries, columns keys); a tile with no
    // padded row or column that every row of the warp sees skips the mask
    auto probs = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = exp2f(s[j][e] * scale_log2 - lse_r[h]);
          if (decltype(masked)::value) {
            const int qpos = q0 + rw + g + 8 * h;
            const int kpos = t0 + 8 * j + 2 * t + (e & 1);
            if (!(qpos < Sq && kpos < Sk && (!causal || kpos <= qpos)))
              p = 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_r[h]);
        }
    };
    if (q0 + kRows <= Sq && t0 + BT <= Sk &&
        (!causal || t0 + BT - 1 <= q0 + rw))
      probs(std::false_type());
    else
      probs(std::true_type());

    // dQ += dS K: k runs over the tile's keys; the tile's sum collects in
    // fresh fragments and joins the accumulators by float32 adds
    float tq[KS][4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t dbig[4], dsml[4];
      acc_as_a(dp[j], dbig, dsml);
#pragma unroll
      for (int n = 0; n < KS; n += 4) {
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_bp(kt, LD, j, n + i, g, t, bb[i], bs[i]);
        mma3x4(tq[n], tq[n + 1], tq[n + 2], tq[n + 3], dbig, dsml, dbig,
               dsml, dbig, dsml, dbig, dsml, bb, bs);
      }
    }
    add_tiles(acc, tq);
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + rw + g + 8 * h;
    if (qpos >= Sq) continue;
    float* dqr = dq + (bh * Sq + qpos) * D;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D)
        *reinterpret_cast<float2*>(dqr + d) =
            make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t floats(size_t n) { return sizeof(float) * n; }

template <int NE>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int BH, int Sq, int Sk, int D,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem = floats(static_cast<size_t>(kRows) * D
                             + static_cast<size_t>(kTile) * (D + 1)
                             + static_cast<size_t>(kTile) * D);
  cudaError_t e = allow_smem(flash_fwd_kernel<NE>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  flash_fwd_kernel<NE><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

// Streamed rows per backward tile: 64, or 32 at the 128 bucket, where
// the dK and dV accumulators take 128 registers a lane.
template <int DP>
constexpr int bwd_tile() { return DP <= 64 ? 64 : 32; }

template <int DP>
cudaError_t launch_dkdv(const float* q, const float* k, const float* v,
                        const float* dout, const float* lse,
                        const float* delta, float* dk, float* dv, int BH,
                        int Sq, int Sk, int D, int causal, float scale,
                        cudaStream_t stream) {
  constexpr int BT = bwd_tile<DP>();
  constexpr size_t LD = DP + 4;
  const size_t smem = floats(2 * kRows * LD + 4 * BT * LD + 4 * BT);
  auto kernel = flash_bwd_dkdv_kernel<DP, BT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sk + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dk,
                                           dv, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse,
                      const float* delta, float* dq, int BH, int Sq, int Sk,
                      int D, int causal, float scale, cudaStream_t stream) {
  constexpr int BT = bwd_tile<DP>();
  constexpr size_t LD = DP + 4;
  const size_t smem = floats(2 * kRows * LD + 4 * BT * LD);
  auto kernel = flash_bwd_dq_kernel<DP, BT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq, Sq,
                                           Sk, D, causal, scale);
  return cudaGetLastError();
}

// head_dim: a multiple of 4 (float4 staging), at most 128
bool bad_shape(int BH, int Sq, int Sk, int D) {
  return BH < 0 || Sq < 0 || Sk < 0 || D <= 0 || D > 128 || D % 4 ||
         Sq > 65535 * kRows || Sk > 65535 * kRows;
}

}  // namespace

extern "C" {

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Sq, int Sk, int D, int causal,
                  float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return cudaSuccess;
  auto fq = static_cast<const float*>(q);
  auto fk = static_cast<const float*>(k);
  auto fv = static_cast<const float*>(v);
  auto fo = static_cast<float*>(o);
  auto fl = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D <= 32)
    e = launch_fwd<1>(fq, fk, fv, fo, fl, BH, Sq, Sk, D, causal, scale, st);
  else if (D <= 64)
    e = launch_fwd<2>(fq, fk, fv, fo, fl, BH, Sq, Sk, D, causal, scale, st);
  else
    e = launch_fwd<4>(fq, fk, fv, fo, fl, BH, Sq, Sk, D, causal, scale, st);
  return static_cast<int>(e);
}

int flash_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int Sq, int Sk, int D,
                       int causal, float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  if (BH == 0 || Sk == 0) return cudaSuccess;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<float*>(dk), static_cast<float*>(dv), BH,
                    Sq, Sk, D, causal, scale,
                    static_cast<cudaStream_t>(stream));
  };
  cudaError_t e;
  if (D <= 32)
    e = args(launch_dkdv<32>);
  else if (D <= 64)
    e = args(launch_dkdv<64>);
  else
    e = args(launch_dkdv<128>);
  return static_cast<int>(e);
}

int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int BH, int Sq, int Sk, int D, int causal,
                     float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return cudaSuccess;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<float*>(dq), BH, Sq, Sk, D, causal, scale,
                    static_cast<cudaStream_t>(stream));
  };
  cudaError_t e;
  if (D <= 32)
    e = args(launch_dq<32>);
  else if (D <= 64)
    e = args(launch_dq<64>);
  else
    e = args(launch_dq<128>);
  return static_cast<int>(e);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
