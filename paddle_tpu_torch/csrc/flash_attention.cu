// Flash attention, float32, for Hopper (sm_90a): the forward pass and
// the two kernels of the backward pass. The bfloat16 forms
// (flash_attention_bf16.cuh, included at the end, with its wgmma forward
// and backward in flash_fwd_wgmma.cuh and flash_bwd_wgmma.cuh) and the
// backward's delta pass (flash_delta.cuh) build into the same library.
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
//             scores give probabilities of exactly 0.
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
// block. All three run their products (the forward two, dK/dV four, dQ
// three) on the tensor cores in 3xTF32 (tf32x3.cuh), the arithmetic of
// PyTorch's float32 memory-efficient attention; their floor is 3x the
// products' flops over 495 TFLOP/s (TF32 dense) plus the exp and
// softmax or ds arithmetic over the float32 peak of 67 TFLOP/s. All keep
// the S x S score matrix out of device memory, use one block of 4 warps
// per (batch-head, 64 rows) with 16 rows a warp, skip whole causal tiles
// (the forward and dQ stop at the block's last row, dK/dV starts at the
// tile holding its first key), mask the ragged edge inside the kernel
// (no padding of the inputs) and never write rows past the end. The
// design:
//   - warp w owns 16 rows of the block (query rows in the forward and
//     dQ, keys in dK/dV) as the m16 side of every product; the other
//     operand streams in tiles of BT = 64 rows (32 at head_dim bucket
//     128), staged with 16-byte cp.async into two buffers: tile i + 1
//     loads while tile i computes, one __syncthreads() a tile;
//   - shared rows have stride D_pad + 4 = 4 (mod 32) floats, so every
//     32-bit fragment load (row g = lane / 4, column t = lane % 4, or
//     row 2t, column g) hits 32 distinct banks; head_dim is zero-padded
//     to its bucket (32, 64, 128) in shared memory only, rows past the
//     end are zero-filled (cp.async with src-size 0) and the store of
//     the head_dim tail is masked;
//   - a probability tile (forward: P; dK/dV: P^T and dS^T; dQ: dS) goes
//     from the accumulators of the score products into the A operand of
//     the next product without a shuffle or a trip through shared
//     memory: the accumulator holds columns 2t, 2t + 1 where the A
//     fragment wants k = t, t + 4, so that product runs over a permuted
//     k (A's t, t + 4 are the tile's 2t, 2t + 1) and its B fragment
//     loads rows 2t and 2t + 1 to match. This keeps shared memory for
//     the tiles (two blocks an SM at head_dim 64);
//   - operands are split when their fragments are loaded, but for the
//     forward's own Q fragments: every key tile reuses them, so up to
//     the 64 bucket they stay split in registers (64 a lane at 64); at
//     128 they are split on load. The backward's own A fragments (K/V in
//     dK/dV, Q/dO in dQ) are split on load: keeping them would take 64
//     more registers a lane or a second copy in shared memory;
//   - every product is issued as three phases over four independent
//     accumulator tiles (small terms first), so no MMA waits on the one
//     just before it;
//   - the tensor core does not round the sum it writes to nearest, so
//     an accumulator that every streamed tile adds into drifts, more
//     the longer the sequence and the larger the output. The products
//     that accumulate over tiles (O; dV, dK; dQ) collect each tile's sum
//     in fresh fragments and join the accumulators by float32 adds
//     (forward: O = O alpha + O_tile, one FFMA, as O is rescaled each
//     tile anyway), which round to nearest: the kernels then err
//     against float64 on the order of the plain float32 version
//     (chip_smoke.py reads both against float64; PERF.md has the
//     readings);
//   - exp, the masks, the softmax and ds arithmetic stay in float32 on
//     the ALUs, in the exp2 domain: p = 2^(s scale log2(e) - m), one
//     FFMA and one ex2. The forward keeps its running max m in those
//     units and a row's scores in the 4 lanes of a quad, so the row max
//     takes two shuffles (xor 1, 2) a tile, and the row sum none until
//     the end (each lane sums its own columns; alpha is the quad's).
//     Masked scores become -inf and give p = 0 exactly; padded rows and
//     columns get p = 0 in the backward; a tile with no edge and no
//     causal diagonal in the warp's rows skips the mask, and in the
//     forward a causal tile wholly after the warp's rows is skipped;
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
// head_dim: the tensor-core kernels here take the buckets 32, 64 and
// 128. Above 128 all three run on the tensor cores too, up to 512, in
// 8-warp blocks whose two groups of 4 warps split the work:
// flash_fwd_wide_mma.cuh (the forward: each group half of the score
// chunks and half of O's columns) and flash_bwd_wide_mma.cuh (dK/dV: one
// output a warp; dQ: one half of its columns a group). Above 512 they run
// on CUDA-core kernels (flash_*_wide_kernel in flash_wide.cuh, 4 rows a
// warp, in 256-column slices of the output), as the accumulators of a
// 16-row warp would not fit in registers. Every entry point takes a head_dim
// that is a multiple of 4 (16-byte staging); the wrapper
// (kernels/flash_attention.py:pad_head_dim) zero-pads any other one,
// which is exact, and passes the scale of the true head_dim.
//
// The kernels allocate nothing; the caller passes the outputs. Each C
// entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_bwd_wide_mma.cuh"
#include "flash_fwd_wide_mma.cuh"
#include "flash_wide.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;
using flash_wide::allow_smem;
using flash_wide::floats;
using flash_wide::launch_dkdv_wide;
using flash_wide::launch_dq_wide;
using flash_wide::launch_fwd_wide;

constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;       // rows each warp owns
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a block owns (64)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// ---------------------------------------------------------------- fwd
// grid (BH, ceil(Sq / 64)): the block owns 64 query rows, 16 a warp,
// and streams key/value tiles of BT rows, double-buffered with
// cp.async, up to its last row when causal. DP: head_dim padded up to
// its bucket (32, 64 or 128); BT: 64, or 32 at DP = 128 (registers).
template <int DP, int BT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int D,
                 int causal, float scale) {
  constexpr int LD = DP + 4;
  constexpr int KS = DP / 8;  // k-steps of S = Q K^T = n-tiles of O
  constexpr int NT = BT / 8;  // n-tiles of S = k-steps of O += P V
  constexpr bool kKeepQ = DP <= 64;  // Q's split fragments in registers
  constexpr int QF = kKeepQ ? KS : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                  // [kRows][LD]
  float* ks = qs + kRows * LD;       // [2][BT][LD]
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
  if (n_tiles > 0) stage_tile(0);
  cp_async_commit();

  const int rw = warp * kRowsPerWarp;  // the warp's first row in the block
  const int last = q0 + rw + kRowsPerWarp - 1;  // and its last row
  const float* qw = qs + rw * LD;
  uint32_t qbig[QF][4], qsml[QF][4];
  if constexpr (kKeepQ) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QF; ++kk)
      load_a(qw, LD, kk, g, t, qbig[kk], qsml[kk]);
  }

  // the lane's rows g and g + 8: running max in units of
  // s * scale * log2(e), the lane's share of the running sum, and the
  // output accumulators (columns 8n + 2t, 8n + 2t + 1)
  const float c = scale * kLog2e;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) stage_tile(it + 1);  // overlaps this tile's math
    cp_async_commit();
    const int t0 = it * BT;
    if (causal && t0 > last) continue;  // no row of the warp sees the tile
    const int b = it & 1;
    const float* kt = ks + b * BT * LD;
    const float* vt = vs + b * BT * LD;

    // S = Q K^T: the warp's 16 rows x BT keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (kKeepQ) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qbig[kk][e];
          as[e] = qsml[kk][e];
        }
      } else {
        load_a(qw, LD, kk, g, t, ab, as);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 4) {
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_bt(kt, LD, j + i, kk, g, t, bb[i], bs[i]);
        mma3x4(s[j], s[j + 1], s[j + 2], s[j + 3], ab, as, ab, as, ab, as,
               ab, as, bb, bs);
      }
    }

    // masked scores become -inf (p = 0 exactly below); a tile with no
    // key past Sk and no causal diagonal in the warp's rows skips this
    if (!(t0 + BT <= Sk && (!causal || t0 + BT - 1 <= q0 + rw))) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + rw + g + (e & 2 ? 8 : 0);
          const int kpos = t0 + 8 * j + 2 * t + (e & 1);
          if (!(kpos < Sk && (!causal || kpos <= qpos))) s[j][e] = -INFINITY;
        }
    }

    // online softmax: the row max over the quad's 4 lanes (2 shuffles),
    // then p = 2^(s c - m), one FFMA and one ex2 a score
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * c);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], c, -m[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O = O alpha + P V: the tile's P V in fresh fragments (k runs over
    // the tile's keys, permuted), merged by one float32 FFMA an element
    float to[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) to[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t pbig[4], psml[4];
      acc_as_a(s[j], pbig, psml);
#pragma unroll
      for (int n = 0; n < KS; n += 4) {
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_bp(vt, LD, j, n + i, g, t, bb[i], bs[i]);
        mma3x4(to[n], to[n + 1], to[n + 2], to[n + 3], pbig, psml, pbig,
               psml, pbig, psml, pbig, psml, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], to[n][e]);
  }
  cp_async_wait_all();

  // the row sums over the quad's lanes, then one store an element;
  // lse = (m + log2 l) ln 2 in natural-log units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qpos = q0 + rw + g + 8 * h;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(sum, FLT_MIN);
    float* orow = o + (bh * Sq + qpos) * D;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int d = 8 * n + 2 * t;  // D is a multiple of 4: d + 1 < D too
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) = make_float2(
            acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    }
    if (t == 0) lse[bh * Sq + qpos] = (m[h] + log2f(denom)) * kLn2;
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

// Streamed rows per tile: 64, or 32 at the 128 bucket, where the
// accumulators (dK and dV in the backward; O and its per-tile sum in the
// forward) take 128 registers a lane.
template <int DP>
constexpr int tile_rows() { return DP <= 64 ? 64 : 32; }

template <int DP>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int BH, int Sq, int Sk, int D,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int BT = tile_rows<DP>();
  constexpr size_t LD = DP + 4;
  const size_t smem = floats(kRows * LD + 4 * BT * LD);
  auto kernel = flash_fwd_kernel<DP, BT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, Sq, Sk, D,
                                           causal, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkdv(const float* q, const float* k, const float* v,
                        const float* dout, const float* lse,
                        const float* delta, float* dk, float* dv, int BH,
                        int Sq, int Sk, int D, int causal, float scale,
                        cudaStream_t stream) {
  constexpr int BT = tile_rows<DP>();
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
  constexpr int BT = tile_rows<DP>();
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

}  // namespace

extern "C" {

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Sq, int Sk, int D, int causal,
                  float scale, void* stream) {
  if (flash_wide::bad_shape(BH, Sq, Sk, D, 4))
    return cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return cudaSuccess;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o),
                    static_cast<float*>(lse), BH, Sq, Sk, D, causal, scale,
                    static_cast<cudaStream_t>(stream));
  };
  cudaError_t e;
  if (D <= 32)
    e = args(launch_fwd<32>);
  else if (D <= 64)
    e = args(launch_fwd<64>);
  else if (D <= 128)
    e = args(launch_fwd<128>);
  else if (D <= flash_fwd_wide::kMaxD)
    e = args(flash_fwd_wide::launch_fwd);
  else
    e = args(launch_fwd_wide<float>);
  return static_cast<int>(e);
}

int flash_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int Sq, int Sk, int D,
                       int causal, float scale, void* stream) {
  if (flash_wide::bad_shape(BH, Sq, Sk, D, 4))
    return cudaErrorInvalidValue;
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
  else if (D <= 128)
    e = args(launch_dkdv<128>);
  else if (D <= flash_bwd_wide::kMaxD)
    e = args(flash_bwd_wide::launch_dkdv);
  else
    e = args(launch_dkdv_wide<float>);
  return static_cast<int>(e);
}

int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int BH, int Sq, int Sk, int D, int causal,
                     float scale, void* stream) {
  if (flash_wide::bad_shape(BH, Sq, Sk, D, 4))
    return cudaErrorInvalidValue;
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
  else if (D <= 128)
    e = args(launch_dq<128>);
  else if (D <= flash_bwd_wide::kMaxD)
    e = args(flash_bwd_wide::launch_dq);
  else
    e = args(launch_dq_wide<float>);
  return static_cast<int>(e);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// flash_fwd_bf16, flash_bwd_dkdv_bf16, flash_bwd_dq_bf16: the bfloat16
// forms, in this library
#include "flash_attention_bf16.cuh"
// flash_delta: the backward's delta = rowsum(dO * O), float32 or bfloat16
#include "flash_delta.cuh"
