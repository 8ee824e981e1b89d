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
// head_dim: the tensor-core kernels take the buckets 32, 64 and 128;
// every head_dim above 128 runs on CUDA-core kernels (flash_*_wide_kernel
// below, 4 rows a warp; above 256 in 256-column slices of the output),
// as the accumulators of a 16-row warp would not fit in registers at 256
// columns. Every entry point takes a head_dim
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

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

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


// ------------------------------------------------------ the wide bucket
// head_dim above 128 (a multiple of 4). The tensor-core kernels above keep
// a 16-row warp's accumulators in registers; at 256 columns the output
// alone would take 128 registers a lane (dK and dV 256). These kernels
// run on the CUDA cores instead, 4 rows a warp (16 a block), and stream
// the other operand in tiles of 32 rows, one row a lane while scoring:
// lane j computes the scores of row j against the warp's 4 rows; lane l
// holds output columns l, l + 32, ... (NE = 8 of them, 256 in all).
// Above 256 columns the grid's z axis cuts the output into 256-column
// slices (O in the forward, dK and dV, dQ), one a block: every block
// computes its scores (and dP = dO V^T) over the whole head_dim, in
// 256-column chunks staged through shared memory in the order 0, 256,
// ..., so every slice computes the same softmax (and dS) bit for bit,
// then accumulates its own columns; the forward's slice 0 writes the
// LSE. Up to 256 columns there is one slice and one chunk, and the
// block's own rows stay in shared memory for the whole key loop: the
// kernels' kSliced = false form, whose chunk loop the compiler removes
// (a runtime loop there cost the 256 bucket registers and 60% more
// time on the card, PERF.md PR 8). Tiles
// read by lane-row are padded by one float (no bank conflicts); the
// block's own rows are read as broadcasts. Every sum is a float32 FMA
// chain in a fixed order, so two launches give bitwise-equal outputs.
constexpr int kWideRowsPerWarp = 4;
constexpr int kWideRows = kWarps * kWideRowsPerWarp;  // 16 a block
constexpr int kWideTile = 32;
constexpr int kWideNE = 8;
constexpr int kWideChunk = 32 * kWideNE;              // 256 columns

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

// Rows [r0, r0 + n) and columns [c0, c0 + w) of a row-major [S, D]
// matrix into shared memory with row stride ld (float4 loads: D, c0 and
// w are multiples of 4); rows at or past S are zeros.
__device__ __forceinline__ void stage_cols(float* dst, int ld,
                                           const float* __restrict__ src,
                                           int r0, int n, int S, int D,
                                           int c0, int w) {
  const int w4 = w / 4;
  for (int i = threadIdx.x; i < n * w4; i += kThreads) {
    const int r = i / w4;
    const int dd = (i % w4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      v = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + r) * D + c0 + dd);
    float* o = dst + r * ld + dd;
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
}

__device__ __forceinline__ void stage_entries(float* dst,
                                              const float* __restrict__ src,
                                              int r0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = r0 + i < S ? src[r0 + i] : 0.f;
}

// grid (BH, ceil(Sq / 16), ceil(D / 256))
template <bool kSliced>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int D,
                      int causal, float scale) {
  constexpr int R = kWideRowsPerWarp;
  const int W = min(D, kWideChunk);          // a chunk's columns at most
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                          // [16][chunk]
  float* ks = qs + kWideRows * W;            // [32][chunk + 1]
  float* vs = ks + kWideTile * (W + 1);      // [32][slice]

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kWideRows;
  // the block's output columns
  const int c0 = kSliced ? blockIdx.z * kWideChunk : 0;
  const int cw = kSliced ? min(kWideChunk, D - c0) : D;
  const int n_chunks = kSliced ? (D + kWideChunk - 1) / kWideChunk : 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  if (!kSliced) stage_cols(qs, D, qb, q0, kWideRows, Sq, D, 0, D);

  const int n_keys = causal ? min(Sk, q0 + kWideRows) : Sk;
  const int rw = warp * R;
  int limit[R];
  float m[R], l[R], acc[R][kWideNE];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + rw + i;
    limit[i] = qpos >= Sq ? -1 : (causal ? min(qpos, Sk - 1) : Sk - 1);
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = 0; t0 < n_keys; t0 += kWideTile) {
    const int t = t0 + lane;
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = 0.f;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int d0 = ci * kWideChunk;
      const int dw = kSliced ? min(kWideChunk, D - d0) : D;
      __syncthreads();  // the previous chunk or tile is consumed
      if (kSliced) stage_cols(qs, dw, qb, q0, kWideRows, Sq, D, d0, dw);
      stage_cols(ks, dw + 1, kb, t0, kWideTile, Sk, D, d0, dw);
      if (ci == n_chunks - 1)  // the last chunk: the V slice too
        stage_cols(vs, cw, vb, t0, kWideTile, Sk, D, c0, cw);
      __syncthreads();
      const float* kr = ks + lane * (dw + 1);
      const float* qw = qs + rw * dw;
#pragma unroll 4
      for (int d = 0; d < dw; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < R; ++i) s[i] = fmaf(qw[i * dw + d], kd, s[i]);
      }
    }

    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool keep = t <= limit[i];
      const float si = keep ? s[i] * scale : -1e30f;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float alpha = expf(m[i] - m_new);
      p[i] = keep ? expf(si - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kWideNE; ++e) acc[i][e] *= alpha;
    }

    const int n_here = min(kWideTile, n_keys - t0);
    for (int j = 0; j < n_here; ++j) {
      float vd[kWideNE];
#pragma unroll
      for (int e = 0; e < kWideNE; ++e) {
        const int d = lane + 32 * e;
        vd[e] = d < cw ? vs[j * cw + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int e = 0; e < kWideNE; ++e)
          acc[i][e] = fmaf(pj, vd[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + rw + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], FLT_MIN);
    float* orow = o + (bh * Sq + qpos) * D + c0;
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) {
      const int d = lane + 32 * e;
      if (d < cw) orow[d] = acc[i][e] / denom;
    }
    if (lane == 0 && c0 == 0) lse[bh * Sq + qpos] = m[i] + logf(denom);
  }
}

// grid (BH, ceil(Sk / 16), ceil(D / 256)): the block owns 16 keys and
// streams query tiles of 32 rows, from the first tile a causal key can
// see
template <bool kSliced>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_wide_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int Sq, int Sk, int D, int causal, float scale) {
  constexpr int R = kWideRowsPerWarp;
  const int W = min(D, kWideChunk);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;                          // [16][chunk]
  float* vs = ks + kWideRows * W;            // [16][chunk]
  float* qs = vs + kWideRows * W;            // [32][chunk + 1]
  float* dos = qs + kWideTile * (W + 1);     // [32][chunk + 1]
  float* lses = dos + kWideTile * (W + 1);   // [32]
  float* deltas = lses + kWideTile;          // [32]

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kWideRows;
  const int c0 = kSliced ? blockIdx.z * kWideChunk : 0;
  const int cw = kSliced ? min(kWideChunk, D - c0) : D;
  const int n_chunks = kSliced ? (D + kWideChunk - 1) / kWideChunk : 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + bh * Sq * D;
  const float* dob = dout + bh * Sq * D;
  const float* kbh = k + bh * Sk * D;
  const float* vbh = v + bh * Sk * D;
  if (!kSliced) {
    stage_cols(ks, D, kbh, k0, kWideRows, Sk, D, 0, D);
    stage_cols(vs, D, vbh, k0, kWideRows, Sk, D, 0, D);
  }

  float acc_k[R][kWideNE], acc_v[R][kWideNE];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  const int kw = k0 + warp * R;  // the warp's first key
  const int start = causal ? (k0 / kWideTile) * kWideTile : 0;
  for (int t0 = start; t0 < Sq; t0 += kWideTile) {
    // lane j: query row t0 + j against each of the warp's keys
    const int qpos = t0 + lane;
    float s[R], dp[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = dp[i] = 0.f;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int d0 = ci * kWideChunk;
      const int dw = kSliced ? min(kWideChunk, D - d0) : D;
      __syncthreads();  // the previous chunk or tile is consumed
      if (kSliced) {
        stage_cols(ks, dw, kbh, k0, kWideRows, Sk, D, d0, dw);
        stage_cols(vs, dw, vbh, k0, kWideRows, Sk, D, d0, dw);
      }
      stage_cols(qs, dw + 1, qb, t0, kWideTile, Sq, D, d0, dw);
      stage_cols(dos, dw + 1, dob, t0, kWideTile, Sq, D, d0, dw);
      if (ci == 0) {
        stage_entries(lses, lse + bh * Sq, t0, kWideTile, Sq);
        stage_entries(deltas, delta + bh * Sq, t0, kWideTile, Sq);
      }
      __syncthreads();
      const float* qr = qs + lane * (dw + 1);
      const float* dor = dos + lane * (dw + 1);
      const float* kwr = ks + warp * R * dw;
      const float* vwr = vs + warp * R * dw;
#pragma unroll 4
      for (int d = 0; d < dw; ++d) {
        const float qd = qr[d];
        const float dod = dor[d];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          s[i] = fmaf(qd, kwr[i * dw + d], s[i]);
          dp[i] = fmaf(dod, vwr[i * dw + d], dp[i]);
        }
      }
    }
    const float lse_j = lses[lane];
    const float delta_j = deltas[lane];
    float p[R], ds[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kpos = kw + i;
      // padded rows and columns are zeroed, not just masked
      const bool keep = qpos < Sq && kpos < Sk && (!causal || qpos >= kpos);
      p[i] = keep ? expf(s[i] * scale - lse_j) : 0.f;
      ds[i] = p[i] * (dp[i] - delta_j);
    }

    // the block's columns of the tile's Q and dO rows: the last chunk
    // when there is one, else staged anew
    int ld = D + 1;
    if (kSliced) {
      __syncthreads();
      stage_cols(qs, cw + 1, qb, t0, kWideTile, Sq, D, c0, cw);
      stage_cols(dos, cw + 1, dob, t0, kWideTile, Sq, D, c0, cw);
      __syncthreads();
      ld = cw + 1;
    }
    const int n_here = min(kWideTile, Sq - t0);
    for (int j = 0; j < n_here; ++j) {
      float qd[kWideNE], dod[kWideNE];
#pragma unroll
      for (int e = 0; e < kWideNE; ++e) {
        const int d = lane + 32 * e;
        qd[e] = d < cw ? qs[j * ld + d] : 0.f;
        dod[e] = d < cw ? dos[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
        const float dsj = __shfl_sync(0xffffffffu, ds[i], j);
#pragma unroll
        for (int e = 0; e < kWideNE; ++e) {
          acc_v[i][e] = fmaf(pj, dod[e], acc_v[i][e]);
          acc_k[i][e] = fmaf(dsj, qd[e], acc_k[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = kw + i;
    if (kpos >= Sk) continue;
    float* dkr = dk + (bh * Sk + kpos) * D + c0;
    float* dvr = dv + (bh * Sk + kpos) * D + c0;
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) {
      const int d = lane + 32 * e;
      if (d < cw) {
        dkr[d] = acc_k[i][e] * scale;
        dvr[d] = acc_v[i][e];
      }
    }
  }
}

// grid (BH, ceil(Sq / 16), ceil(D / 256)): the block owns 16 query rows
// and streams key tiles of 32 rows, up to its last row when causal
template <bool kSliced>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int Sq, int Sk, int D,
                         int causal, float scale) {
  constexpr int R = kWideRowsPerWarp;
  const int W = min(D, kWideChunk);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                          // [16][chunk]
  float* dos = qs + kWideRows * W;           // [16][chunk]
  float* ks = dos + kWideRows * W;           // [32][chunk + 1]
  float* vs = ks + kWideTile * (W + 1);      // [32][chunk + 1]
  float* lses = vs + kWideTile * (W + 1);    // [16]
  float* deltas = lses + kWideRows;          // [16]

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kWideRows;
  const int c0 = kSliced ? blockIdx.z * kWideChunk : 0;
  const int cw = kSliced ? min(kWideChunk, D - c0) : D;
  const int n_chunks = kSliced ? (D + kWideChunk - 1) / kWideChunk : 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + bh * Sq * D;
  const float* dob = dout + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  if (!kSliced) {
    stage_cols(qs, D, qb, q0, kWideRows, Sq, D, 0, D);
    stage_cols(dos, D, dob, q0, kWideRows, Sq, D, 0, D);
  }
  stage_entries(lses, lse + bh * Sq, q0, kWideRows, Sq);
  stage_entries(deltas, delta + bh * Sq, q0, kWideRows, Sq);

  const int rw = warp * R;
  float acc[R][kWideNE];
  int limit[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + rw + i;
    limit[i] = qpos >= Sq ? -1 : (causal ? min(qpos, Sk - 1) : Sk - 1);
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) acc[i][e] = 0.f;
  }

  const int n_keys = causal ? min(Sk, q0 + kWideRows) : Sk;
  for (int t0 = 0; t0 < n_keys; t0 += kWideTile) {
    // lane j: key t0 + j against each of the warp's query rows
    const int t = t0 + lane;
    float s[R], dp[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = dp[i] = 0.f;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int d0 = ci * kWideChunk;
      const int dw = kSliced ? min(kWideChunk, D - d0) : D;
      __syncthreads();  // the previous chunk or tile is consumed
      if (kSliced) {
        stage_cols(qs, dw, qb, q0, kWideRows, Sq, D, d0, dw);
        stage_cols(dos, dw, dob, q0, kWideRows, Sq, D, d0, dw);
      }
      stage_cols(ks, dw + 1, kb, t0, kWideTile, Sk, D, d0, dw);
      stage_cols(vs, dw + 1, vb, t0, kWideTile, Sk, D, d0, dw);
      __syncthreads();
      const float* kr = ks + lane * (dw + 1);
      const float* vr = vs + lane * (dw + 1);
      const float* qw = qs + rw * dw;
      const float* dow = dos + rw * dw;
#pragma unroll 4
      for (int d = 0; d < dw; ++d) {
        const float kd = kr[d];
        const float vd = vr[d];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          s[i] = fmaf(qw[i * dw + d], kd, s[i]);
          dp[i] = fmaf(dow[i * dw + d], vd, dp[i]);
        }
      }
    }
    float ds[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool keep = t <= limit[i];
      const float p = keep ? expf(s[i] * scale - lses[rw + i]) : 0.f;
      ds[i] = p * (dp[i] - deltas[rw + i]);
    }

    // the block's columns of the tile's K rows: the last chunk when
    // there is one, else staged anew
    int ld = D + 1;
    if (kSliced) {
      __syncthreads();
      stage_cols(ks, cw + 1, kb, t0, kWideTile, Sk, D, c0, cw);
      __syncthreads();
      ld = cw + 1;
    }
    const int n_here = min(kWideTile, n_keys - t0);
    for (int j = 0; j < n_here; ++j) {
      float kd[kWideNE];
#pragma unroll
      for (int e = 0; e < kWideNE; ++e) {
        const int d = lane + 32 * e;
        kd[e] = d < cw ? ks[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], j);
#pragma unroll
        for (int e = 0; e < kWideNE; ++e)
          acc[i][e] = fmaf(dsj, kd[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + rw + i;
    if (qpos >= Sq) continue;
    float* dqr = dq + (bh * Sq + qpos) * D + c0;
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) {
      const int d = lane + 32 * e;
      if (d < cw) dqr[d] = acc[i][e] * scale;
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

// The wide bucket (head_dim above 128) on the CUDA-core kernels: W, a
// chunk's columns (head_dim up to 256), sizes the shared memory; the
// grid's z axis takes the 256-column output slices.
size_t chunk_cols(int D) {
  return static_cast<size_t>(D < kWideChunk ? D : kWideChunk);
}

dim3 wide_grid(int BH, int S, int D) {
  return dim3(BH, (S + kWideRows - 1) / kWideRows,
              (D + kWideChunk - 1) / kWideChunk);
}

template <bool kSliced>
cudaError_t launch_fwd_wide(const float* q, const float* k, const float* v,
                            float* o, float* lse, int BH, int Sq, int Sk,
                            int D, int causal, float scale,
                            cudaStream_t stream) {
  const size_t W = chunk_cols(D);
  const size_t smem = floats(kWideRows * W + kWideTile * (2 * W + 1));
  auto kernel = flash_fwd_wide_kernel<kSliced>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<wide_grid(BH, Sq, D), kThreads, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

template <bool kSliced>
cudaError_t launch_dkdv_wide(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* delta, float* dk, float* dv,
                             int BH, int Sq, int Sk, int D, int causal,
                             float scale, cudaStream_t stream) {
  const size_t W = chunk_cols(D);
  const size_t smem = floats(2 * kWideRows * W + 2 * kWideTile * (W + 1) +
                             2 * kWideTile);
  auto kernel = flash_bwd_dkdv_wide_kernel<kSliced>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<wide_grid(BH, Sk, D), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

template <bool kSliced>
cudaError_t launch_dq_wide(const float* q, const float* k, const float* v,
                           const float* dout, const float* lse,
                           const float* delta, float* dq, int BH, int Sq,
                           int Sk, int D, int causal, float scale,
                           cudaStream_t stream) {
  const size_t W = chunk_cols(D);
  const size_t smem = floats(2 * kWideRows * W + 2 * kWideTile * (W + 1) +
                             2 * kWideRows);
  auto kernel = flash_bwd_dq_wide_kernel<kSliced>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<wide_grid(BH, Sq, D), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

// head_dim: a multiple of 4 (the wrapper zero-pads it to one); the
// grid's y and z dimensions bound the sequence lengths and head_dim
bool bad_shape(int BH, int Sq, int Sk, int D) {
  return BH < 0 || Sq < 0 || Sk < 0 || D <= 0 || D % 4 ||
         Sq > 65535 * kWideRows || Sk > 65535 * kWideRows ||
         D > 65535 * kWideChunk;
}

}  // namespace

extern "C" {

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Sq, int Sk, int D, int causal,
                  float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
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
  else if (D <= kWideChunk)
    e = args(launch_fwd_wide<false>);
  else
    e = args(launch_fwd_wide<true>);
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
  else if (D <= 128)
    e = args(launch_dkdv<128>);
  else if (D <= kWideChunk)
    e = args(launch_dkdv_wide<false>);
  else
    e = args(launch_dkdv_wide<true>);
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
  else if (D <= 128)
    e = args(launch_dq<128>);
  else if (D <= kWideChunk)
    e = args(launch_dq_wide<false>);
  else
    e = args(launch_dq_wide<true>);
  return static_cast<int>(e);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
