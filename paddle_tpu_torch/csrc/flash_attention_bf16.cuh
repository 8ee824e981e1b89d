// Flash attention, bfloat16, for Hopper (sm_90a): the forward pass and
// the two kernels of the backward pass on bfloat16 q, k, v and dO.
// flash_attention.cu includes this file: both forms build into one
// library (libflash_attention).
//
// Replaces the bfloat16 branch (lowp) of the Pallas TPU kernels of
//   paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py
//     _fwd_kernel       (launched by _fwd_pallas)    -> flash_fwd_bf16
//     _bwd_dkdv_kernel  (launched by _flash_bwd)     -> flash_bwd_dkdv_bf16
//     _bwd_dq_kernel    (launched by _flash_bwd)     -> flash_bwd_dq_bf16
// and computes the same functions as the plain versions on bfloat16
// inputs (paddle_tpu_torch/kernels/flash_attention.py: _fwd_bf16,
// _bwd_bf16), over the layouts of the float32 kernels
// (flash_attention.cu): q [BH, Sq, D], k and v [BH, Sk, D], O and dO
// [BH, Sq, D] bfloat16; lse and delta [BH, Sq] float32. Causal masking
// keeps key t for query row i when t <= i (absolute positions).
//
//   forward   s = scale * q.k from bfloat16 operands with float32 sums;
//             an online softmax over blocks of 128 keys (the JAX
//             kernel's block_k, which layers.ring_attention runs): the
//             running max m and sum l in float32 move once a block,
//             p = exp(s - m_new) enters l unrounded and the product
//             P V rounded to bfloat16; O = acc / max(l, FLT_MIN) rounded
//             once to bfloat16, lse = m + log(max(l, FLT_MIN)) float32.
//   dK, dV    p = exp(s - lse) recomputed, 0 on masked and padded rows
//             and columns; ds = p (dO.v - delta) in float32;
//             dV = bf16(P)^T dO, dK = scale * bf16(dS)^T Q.
//   dQ        dQ = scale * bf16(dS) K.
// Each output is rounded once to bfloat16, to nearest even
// (__float2bfloat16_rn), as XLA's convert does.
//
// What bounds them on this card: operations. At the training shapes
// (BH = 128, S = 512, D = 64) the products run on the tensor cores at the
// bf16 rate (989 TFLOP/s dense), and the exp and softmax or ds arithmetic
// (~5 float32 flops a (query, key) pair) on the float32 ALUs at
// 67 TFLOP/s, which at head_dim 64 takes longer than the products. Up to
// head_dim 64 all three are wgmma kernels fed by TMA
// (flash_fwd_wgmma.cuh, flash_bwd_wgmma.cuh). The design here (head_dim
// 65-128):
//   - one block of 4 warps per (batch-head, 64 rows), 16 rows a warp as
//     the m16 side of every product (query rows in the forward and dQ,
//     keys in dK/dV); products are mma.sync m16n8k16 bf16 with float32
//     accumulators, operands from shared memory by ldmatrix (.trans for
//     the k-major operand of P V, dV, dK and dQ);
//   - the forward streams key tiles of 128, the softmax block: all 128
//     scores of a warp's rows sit in registers (64 a lane) before their
//     max is taken, so the running max moves where the JAX kernel's does.
//     K and V have one buffer each: V of tile i loads (16-byte cp.async)
//     while its scores are computed, K of tile i + 1 while P V runs;
//   - the backward kernels stream tiles of 32 rows (registers),
//     double-buffered with cp.async (Q, dO, lse and delta in dK/dV; K
//     and V in dQ);
//   - a score tile's accumulator layout is the A-fragment layout of the
//     next product (m16n8k16: the lane holds rows g, g + 8 and columns
//     2t, 2t + 1 of each n8 tile; A holds the same rows and columns 2t,
//     2t + 1, 2t + 8, 2t + 9 of each k16 step), so P and dS are rounded
//     to bfloat16 and packed in registers, with no shuffle or trip
//     through shared memory;
//   - head_dim is a multiple of 8 (16-byte rows; the wrapper zero-pads
//     it, which is exact) and zero-padded to its bucket (32, 64, 128) in
//     shared memory only; rows are stored at a stride of bucket + 8
//     halves, 16 bytes (mod 128), so each 8-row phase of an ldmatrix
//     hits 32 distinct banks; rows past the end are zero-filled
//     (cp.async with src-size 0) and never written back;
//   - the tensor core does not round the sum it writes to nearest, so
//     each tile's products collect in fresh fragments and join the
//     accumulators by float32 adds (forward: O = O alpha + O_tile), as in
//     the float32 kernels;
//   - exp, the masks, the softmax and ds arithmetic run in float32 on the
//     ALUs in the exp2 domain (p = 2^(s scale log2(e) - m)); masked
//     scores become -inf and give p = 0 exactly;
//   - no atomics: each output element is written once by one lane, and
//     two launches on the same inputs give bitwise-equal outputs.
// Not done yet (PERF.md has the times): wgmma and TMA at the 128 bucket,
// warp specialisation, a persistent grid; 128-key forward tiles leave
// one or two blocks an SM there.
//
// The shape plan above head_dim 128: the forward, dK/dV and dQ at
// 129-512 run the wgmma + TMA kernels of flash_wide_wgmma.cuh (two
// warpgroups a block; the forward and dK/dV above 256 columns in column
// slices that recompute the scores, dQ's units split between the
// warpgroups); above 512 all three run the CUDA-core kernels of
// flash_wide.cuh, instantiated for bfloat16 (the same function, bf16
// loads widened to float32, P and dS rounded through
// __float2bfloat16_rn).
//
// The kernels allocate nothing; the caller passes the outputs. Each C
// entry point launches on the given stream and returns
// cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_bwd_wgmma.cuh"
#include "flash_fwd_wgmma.cuh"
#include "flash_wide.cuh"
#include "flash_wide_wgmma.cuh"
#include "tf32x3.cuh"

namespace flash_bf16 {
namespace {

using flash_wide::allow_smem;
using tf32x3::add_tiles;
using tf32x3::cp_async4;
using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait_all;

constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;       // rows each warp owns
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a block owns (64)
constexpr int kBlockK = 128;  // the forward's key tile and softmax block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. Plain: r[i] = matrix i's (row lane / 4, columns
// 2 (lane % 4), +1); .trans: its (rows 2 (lane % 4), +1, column lane / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b for one m16n8k16 bf16 tile, float32 accumulators.
// Fragments (g = lane / 4, t = lane % 4), two bf16 a register, the lower
// index in the low half: a = A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]; b = B[2t..][g], B[2t+8..][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values rounded to bfloat16 (to nearest even), lo in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator tiles 2kk and 2kk + 1 (columns 16kk .. 16kk + 15) rounded
// to bfloat16 as the A fragment of k-step kk of the next product.
__device__ __forceinline__ void acc_as_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Stage rows [r0, r0 + n) of a row-major [S, D] bfloat16 matrix into
// shared memory as n rows of DP halves at stride DP + 8: rows at or past
// S and columns D..DP-1 are zero-filled. D is a multiple of 8 and the
// source 16-byte aligned.
template <int DP>
__device__ __forceinline__ void stage_rows(uint16_t* dst,
                                           const uint16_t* __restrict__ src,
                                           int r0, int n, int S, int D) {
  constexpr int LD = DP + 8;
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r0 + r < S && c < D;
    const uint16_t* from = ok ? src + static_cast<int64_t>(r0 + r) * D + c
                              : src;
    cp_async16(reinterpret_cast<float*>(dst + r * LD + c),
               reinterpret_cast<const float*>(from), ok ? 16 : 0);
  }
}

// Entries [r0, r0 + n) of a float32 length-S vector; zeros past S.
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = r0 + i < S;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok ? 4 : 0);
  }
}

// The warp's A fragment of k-step kk from its 16 rows (stride LD halves)
// of a row-major tile: rows g (+8), columns 16kk + 2t (+8).
template <int LD>
__device__ __forceinline__ void load_a(const uint16_t* rows, int kk, int lane,
                                       uint32_t (&a)[4]) {
  const int mi = lane / 8, mr = lane % 8;
  ldmatrix_x4(a, rows + (mr + 8 * (mi & 1)) * LD + 16 * kk + 8 * (mi >> 1));
}

// B fragments of n-tiles j, j + 1 at k-step kk for B = M^T of a
// row-major [N][K] tile M (score products: keys or queries as n, head_dim
// as k): b[0], b[1] of n-tile j; b[2], b[3] of n-tile j + 1.
template <int LD>
__device__ __forceinline__ void load_bt(const uint16_t* m, int j, int kk,
                                        int lane, uint32_t (&b)[4]) {
  const int mi = lane / 8, mr = lane % 8;
  ldmatrix_x4(b, m + (8 * j + mr + 8 * (mi >> 1)) * LD + 16 * kk +
                     8 * (mi & 1));
}

// B fragments of n-tiles n, n + 1 at k-step kk for a row-major [K][N]
// tile B (P V, dV, dK, dQ: keys or queries as k, head_dim as n), by
// ldmatrix .trans.
template <int LD>
__device__ __forceinline__ void load_b(const uint16_t* m, int kk, int n,
                                       int lane, uint32_t (&b)[4]) {
  const int mi = lane / 8, mr = lane % 8;
  ldmatrix_x4_trans(b, m + (16 * kk + mr + 8 * (mi & 1)) * LD + 8 * n +
                           8 * (mi >> 1));
}

// Store the lane's columns 8n + 2t, 8n + 2t + 1 of row `row` (the
// accumulator half h) times `mul`, rounded to bfloat16, below D.
template <int NO>
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (&acc)[NO][4], int h,
                                          int t, int D, float mul) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = 8 * n + 2 * t;  // D is a multiple of 8: d + 1 < D too
    if (d < D)
      *reinterpret_cast<uint32_t*>(row + d) =
          pack_bf16(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

// ---------------------------------------------------------------- fwd
// grid (BH, ceil(Sq / 64)): the block owns 64 query rows, 16 a warp, and
// streams key/value tiles of 128 (the softmax block) up to its last row
// when causal. DP: head_dim padded up to its bucket (128 alone: up to 64
// the forward is flash_fwd_wgmma.cuh's).
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int D,
                      int causal, float scale) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;       // k-steps of S = Q K^T
  constexpr int NO = DP / 8;        // n-tiles of O
  constexpr int NT = kBlockK / 8;   // n-tiles of S (16)
  constexpr int KP = kBlockK / 16;  // k-steps of O += P V (8)
  // n-tiles of O whose tile sums are held at once (registers at 128)
  constexpr int NF = NO < 8 ? NO : 8;
  extern __shared__ float4 smem4[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem4);  // [64][LD]
  uint16_t* ks = qs + kRows * LD;                     // [128][LD]
  uint16_t* vs = ks + kBlockK * LD;                   // [128][LD]

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint16_t* kb = k + bh * Sk * D;
  const uint16_t* vb = v + bh * Sk * D;

  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_tiles = (n_keys + kBlockK - 1) / kBlockK;
  stage_rows<DP>(qs, q + bh * Sq * D, q0, kRows, Sq, D);
  if (n_tiles > 0) stage_rows<DP>(ks, kb, 0, kBlockK, Sk, D);
  cp_async_commit();

  const int rw = warp * kRowsPerWarp;  // the warp's first row in the block
  const int last = q0 + rw + kRowsPerWarp - 1;  // and its last row
  const uint16_t* qw = qs + rw * LD;

  // the lane's rows g and g + 8: running max in units of
  // s * scale * log2(e), the lane's share of the running sum, and the
  // output accumulators (columns 8n + 2t, 8n + 2t + 1)
  const float c = scale * kLog2e;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // K of tile it has landed; every warp is done with V
    stage_rows<DP>(vs, vb, it * kBlockK, kBlockK, Sk, D);  // during S
    cp_async_commit();
    const int t0 = it * kBlockK;
    const bool live = !(causal && t0 > last);  // a row of the warp sees it
    uint32_t pf[KP][4];  // P, rounded to bfloat16, as A fragments
    if (live) {
      // S = Q K^T: the warp's 16 rows x 128 keys
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        load_a<LD>(qw, kk, lane, a);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          load_bt<LD>(ks, j, kk, lane, b);
          mma_bf16(s[j], a, b[0], b[1]);
          mma_bf16(s[j + 1], a, b[2], b[3]);
        }
      }

      // masked scores become -inf (p = 0 exactly below); a tile with no
      // key past Sk and no causal diagonal in the warp's rows skips this
      if (!(t0 + kBlockK <= Sk &&
            (!causal || t0 + kBlockK - 1 <= q0 + rw))) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + rw + g + (e & 2 ? 8 : 0);
            const int kpos = t0 + 8 * j + 2 * t + (e & 1);
            if (!(kpos < Sk && (!causal || kpos <= qpos)))
              s[j][e] = -INFINITY;
          }
      }

      // online softmax over the block: the row max over the quad's 4
      // lanes, then p = 2^(s c - m), one FFMA and one ex2 a score; l
      // takes p unrounded, P V its bfloat16 rounding
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
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        acc_as_a(s[2 * kk], s[2 * kk + 1], pf[kk]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }

    cp_async_wait_all();
    __syncthreads();  // V of tile it has landed; every warp is done with K
    if (it + 1 < n_tiles)  // during P V
      stage_rows<DP>(ks, kb, (it + 1) * kBlockK, kBlockK, Sk, D);
    cp_async_commit();

    if (live) {
      // O += P V: the tile's sums in fresh fragments, NF n-tiles at a
      // time, joined by float32 adds
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NF) {
        float to[NF][4] = {};
#pragma unroll
        for (int kk = 0; kk < KP; ++kk)
#pragma unroll
          for (int n = 0; n < NF; n += 2) {
            uint32_t b[4];
            load_b<LD>(vs, kk, n0 + n, lane, b);
            mma_bf16(to[n], pf[kk], b[0], b[1]);
            mma_bf16(to[n + 1], pf[kk], b[2], b[3]);
          }
        add_tiles(acc + n0, to);
      }
    }
  }
  cp_async_wait_all();

  // the row sums over the quad's lanes, then one store an element pair;
  // lse = (m + log2 l) ln 2 in natural-log units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qpos = q0 + rw + g + 8 * h;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(sum, FLT_MIN);
    // acc / denom, one division an element as the plain version's
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[n][2 * h + e] /= denom;
    store_row(o + (bh * Sq + qpos) * D, acc, h, t, D, 1.f);
    if (t == 0) lse[bh * Sq + qpos] = (m[h] + log2f(denom)) * kLn2;
  }
}

// ---------------------------------------------------------------- dK dV
// grid (BH, ceil(Sk / 64)): the block owns 64 keys, 16 a warp, and
// streams query tiles of BT rows, double-buffered with cp.async, from the
// first tile a causal key can see.
template <int DP, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const uint16_t* __restrict__ q,
                           const uint16_t* __restrict__ k,
                           const uint16_t* __restrict__ v,
                           const uint16_t* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                           int D, int causal, float scale) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;  // k-steps over head_dim
  constexpr int NO = DP / 8;   // n-tiles of dK, dV
  constexpr int NT = BT / 8;   // n-tiles of the scores (queries)
  constexpr int KQ = BT / 16;  // k-steps of dK, dV (queries)
  // n-tiles of dK and dV whose tile sums are held at once: all, but at
  // the 128 bucket 4 (registers)
  constexpr int NC = DP <= 64 ? NO : 4;
  extern __shared__ float4 smem4[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem4);  // [64][LD]
  uint16_t* vs = ks + kRows * LD;                     // [64][LD]
  uint16_t* qs = vs + kRows * LD;                     // [2][BT][LD]
  uint16_t* dos = qs + 2 * BT * LD;                   // [2][BT][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * BT * LD);  // [2][BT]
  float* deltas = lses + 2 * BT;                              // [2][BT]

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint16_t* qb = q + bh * Sq * D;
  const uint16_t* dob = dout + bh * Sq * D;
  const float* lseb = lse + bh * Sq;
  const float* deltab = delta + bh * Sq;

  // query tiles wholly before this block's first key see none of it
  const int start = causal ? (k0 / BT) * BT : 0;
  const int n_tiles = start < Sq ? (Sq - start + BT - 1) / BT : 0;
  auto stage_tile = [&](int it) {
    const int t0 = start + it * BT;
    const int b = it & 1;
    stage_rows<DP>(qs + b * BT * LD, qb, t0, BT, Sq, D);
    stage_rows<DP>(dos + b * BT * LD, dob, t0, BT, Sq, D);
    stage_vec(lses + b * BT, lseb, t0, BT, Sq);
    stage_vec(deltas + b * BT, deltab, t0, BT, Sq);
  };
  stage_rows<DP>(ks, k + bh * Sk * D, k0, kRows, Sk, D);
  stage_rows<DP>(vs, v + bh * Sk * D, k0, kRows, Sk, D);
  if (n_tiles > 0) stage_tile(0);
  cp_async_commit();

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int kw = warp * kRowsPerWarp;  // the warp's first key in the block
  const float scale_log2 = scale * kLog2e;
  const uint16_t* kwr = ks + kw * LD;
  const uint16_t* vwr = vs + kw * LD;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) stage_tile(it + 1);  // overlaps this tile's math
    cp_async_commit();
    const int b = it & 1;
    const int t0 = start + it * BT;
    const uint16_t* qt = qs + b * BT * LD;
    const uint16_t* dot = dos + b * BT * LD;
    const float* lt = lses + b * BT;
    const float* dt = deltas + b * BT;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BT queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(kwr, kk, lane, ka);
      load_a<LD>(vwr, kk, lane, va);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bq[4], bo[4];
        load_bt<LD>(qt, j, kk, lane, bq);
        load_bt<LD>(dot, j, kk, lane, bo);
        mma_bf16(s[j], ka, bq[0], bq[1]);
        mma_bf16(s[j + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[j], va, bo[0], bo[1]);
        mma_bf16(dp[j + 1], va, bo[2], bo[3]);
      }
    }

    // P^T and dS^T in place (rows keys, columns queries); padded rows
    // and columns are zeroed, not just masked. A tile with no padded row
    // or column that every key of the warp sees skips the mask.
    auto probs = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          float p = exp2f(s[j][e] * scale_log2 - lt[col] * kLog2e);
          if (decltype(masked)::value) {
            const int kpos = k0 + kw + g + (e & 2 ? 8 : 0);
            const int qpos = t0 + col;
            if (!(qpos < Sq && kpos < Sk && (!causal || qpos >= kpos)))
              p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dt[col]);
        }
    };
    if (t0 + BT <= Sq && k0 + kRows <= Sk &&
        (!causal || t0 >= k0 + kw + kRowsPerWarp - 1))
      probs(std::false_type());
    else
      probs(std::true_type());
    uint32_t pa[KQ][4], da[KQ][4];  // bf16(P^T), bf16(dS^T) as A fragments
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      acc_as_a(s[2 * kq], s[2 * kq + 1], pa[kq]);
      acc_as_a(dp[2 * kq], dp[2 * kq + 1], da[kq]);
    }

    // dV += P^T dO and dK += dS^T Q: k runs over the tile's queries; the
    // tile's sums collect in fresh fragments, NC n-tiles at a time, and
    // join the accumulators by float32 adds
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NC) {
      float tv[NC][4] = {}, tk[NC][4] = {};
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq)
#pragma unroll
        for (int n = 0; n < NC; n += 2) {
          uint32_t bo[4], bq[4];
          load_b<LD>(dot, kq, n0 + n, lane, bo);
          load_b<LD>(qt, kq, n0 + n, lane, bq);
          mma_bf16(tv[n], pa[kq], bo[0], bo[1]);
          mma_bf16(tv[n + 1], pa[kq], bo[2], bo[3]);
          mma_bf16(tk[n], da[kq], bq[0], bq[1]);
          mma_bf16(tk[n + 1], da[kq], bq[2], bq[3]);
        }
      add_tiles(acc_v + n0, tv);
      add_tiles(acc_k + n0, tk);
    }
  }
  cp_async_wait_all();

  // each output element pair is written once, by one lane
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + kw + g + 8 * h;
    if (kpos >= Sk) continue;
    store_row(dk + (bh * Sk + kpos) * D, acc_k, h, t, D, scale);
    store_row(dv + (bh * Sk + kpos) * D, acc_v, h, t, D, 1.f);
  }
}

// ---------------------------------------------------------------- dQ
// grid (BH, ceil(Sq / 64)): the block owns 64 query rows, 16 a warp, and
// streams key/value tiles of BT rows, double-buffered with cp.async, up
// to its last row when causal.
template <int DP, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                         int D, int causal, float scale) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;  // k-steps over head_dim
  constexpr int NO = DP / 8;   // n-tiles of dQ
  constexpr int NT = BT / 8;   // n-tiles of the scores (keys)
  constexpr int KK = BT / 16;  // k-steps of dQ (keys)
  constexpr int NC = NO < 8 ? NO : 8;
  extern __shared__ float4 smem4[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem4);  // [64][LD]
  uint16_t* dos = qs + kRows * LD;                    // [64][LD]
  uint16_t* ks = dos + kRows * LD;                    // [2][BT][LD]
  uint16_t* vs = ks + 2 * BT * LD;                    // [2][BT][LD]

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint16_t* kb = k + bh * Sk * D;
  const uint16_t* vb = v + bh * Sk * D;

  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_tiles = (n_keys + BT - 1) / BT;
  auto stage_tile = [&](int it) {
    const int b = it & 1;
    stage_rows<DP>(ks + b * BT * LD, kb, it * BT, BT, Sk, D);
    stage_rows<DP>(vs + b * BT * LD, vb, it * BT, BT, Sk, D);
  };
  stage_rows<DP>(qs, q + bh * Sq * D, q0, kRows, Sq, D);
  stage_rows<DP>(dos, dout + bh * Sq * D, q0, kRows, Sq, D);
  if (n_tiles > 0) stage_tile(0);
  cp_async_commit();

  // the lane's two query rows g and g + 8 (lse in log2 units)
  const int rw = warp * kRowsPerWarp;
  const float scale_log2 = scale * kLog2e;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + rw + g + 8 * h;
    lse_r[h] = qpos < Sq ? lse[bh * Sq + qpos] * kLog2e : 0.f;
    delta_r[h] = qpos < Sq ? delta[bh * Sq + qpos] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const uint16_t* qw = qs + rw * LD;
  const uint16_t* dow = dos + rw * LD;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) stage_tile(it + 1);  // overlaps this tile's math
    cp_async_commit();
    const int b = it & 1;
    const int t0 = it * BT;
    const uint16_t* kt = ks + b * BT * LD;
    const uint16_t* vt = vs + b * BT * LD;

    // S = Q K^T and dP = dO V^T: the warp's 16 rows x BT keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<LD>(qw, kk, lane, qa);
      load_a<LD>(dow, kk, lane, oa);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4], bv[4];
        load_bt<LD>(kt, j, kk, lane, bk);
        load_bt<LD>(vt, j, kk, lane, bv);
        mma_bf16(s[j], qa, bk[0], bk[1]);
        mma_bf16(s[j + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[j], oa, bv[0], bv[1]);
        mma_bf16(dp[j + 1], oa, bv[2], bv[3]);
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
    uint32_t da[KK][4];  // bf16(dS) as A fragments
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      acc_as_a(dp[2 * kk], dp[2 * kk + 1], da[kk]);

    // dQ += dS K: k runs over the tile's keys; fresh fragments, NC
    // n-tiles at a time, joined by float32 adds
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NC) {
      float tq[NC][4] = {};
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int n = 0; n < NC; n += 2) {
          uint32_t bk[4];
          load_b<LD>(kt, kk, n0 + n, lane, bk);
          mma_bf16(tq[n], da[kk], bk[0], bk[1]);
          mma_bf16(tq[n + 1], da[kk], bk[2], bk[3]);
        }
      add_tiles(acc + n0, tq);
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + rw + g + 8 * h;
    if (qpos >= Sq) continue;
    store_row(dq + (bh * Sq + qpos) * D, acc, h, t, D, scale);
  }
}

size_t halves(size_t n) { return sizeof(uint16_t) * n; }

// Streamed rows per backward tile (the 128 bucket: the accumulators, dK
// and dV, take 128 registers a lane).
constexpr int kBwdTile = 32;

template <int DP>
cudaError_t launch_fwd(const uint16_t* q, const uint16_t* k,
                       const uint16_t* v, __nv_bfloat16* o, float* lse,
                       int BH, int Sq, int Sk, int D, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t LD = DP + 8;
  const size_t smem = halves((kRows + 2 * kBlockK) * LD);
  auto kernel = flash_fwd_bf16_kernel<DP>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, Sq, Sk, D,
                                           causal, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkdv(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, const uint16_t* dout,
                        const float* lse, const float* delta,
                        __nv_bfloat16* dk, __nv_bfloat16* dv, int BH, int Sq,
                        int Sk, int D, int causal, float scale,
                        cudaStream_t stream) {
  constexpr int BT = kBwdTile;
  constexpr size_t LD = DP + 8;
  const size_t smem = halves((2 * kRows + 4 * BT) * LD) +
                      sizeof(float) * 4 * BT;
  auto kernel = flash_bwd_dkdv_bf16_kernel<DP, BT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sk + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dk,
                                           dv, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const uint16_t* q, const uint16_t* k,
                      const uint16_t* v, const uint16_t* dout,
                      const float* lse, const float* delta,
                      __nv_bfloat16* dq, int BH, int Sq, int Sk, int D,
                      int causal, float scale, cudaStream_t stream) {
  constexpr int BT = kBwdTile;
  constexpr size_t LD = DP + 8;
  const size_t smem = halves((2 * kRows + 4 * BT) * LD);
  auto kernel = flash_bwd_dq_bf16_kernel<DP, BT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq, Sq,
                                           Sk, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_bf16

extern "C" {

// The CUDA-core kernels (above 128 columns: K3b, and K2 and K3a above
// 512) take __nv_bfloat16 pointers.
using Bf = __nv_bfloat16;

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int Sq, int Sk, int D, int causal,
                   float scale, void* stream) {
  if (flash_wide::bad_shape(BH, Sq, Sk, D, 8))
    return cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  auto tc = [&](auto launcher) {
    return launcher(static_cast<const uint16_t*>(q),
                    static_cast<const uint16_t*>(k),
                    static_cast<const uint16_t*>(v), static_cast<Bf*>(o),
                    static_cast<float*>(lse), BH, Sq, Sk, D, causal, scale, s);
  };
  auto wide = [&](auto launcher) {
    return launcher(static_cast<const Bf*>(q), static_cast<const Bf*>(k),
                    static_cast<const Bf*>(v), static_cast<Bf*>(o),
                    static_cast<float*>(lse), BH, Sq, Sk, D, causal, scale, s);
  };
  cudaError_t e;
  if (D <= 64)
    e = flash_wgmma::launch_fwd<flash_wgmma::FwdRing>(
        q, k, v, static_cast<Bf*>(o), static_cast<float*>(lse), BH, Sq, Sk,
        D, causal, scale, s);
  else if (D <= 128)
    e = tc(flash_bf16::launch_fwd<128>);
  else if (D <= flash_wgmma::kWideMaxD)
    e = flash_wgmma::launch_wide_fwd(q, k, v, static_cast<Bf*>(o),
                                     static_cast<float*>(lse), BH, Sq, Sk, D,
                                     causal, scale, s);
  else
    e = wide(flash_wide::launch_fwd_wide<Bf>);
  return static_cast<int>(e);
}

int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int BH, int Sq, int Sk, int D,
                        int causal, float scale, void* stream) {
  if (flash_wide::bad_shape(BH, Sq, Sk, D, 8))
    return cudaErrorInvalidValue;
  if (BH == 0 || Sk == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  auto tc = [&](auto launcher) {
    return launcher(static_cast<const uint16_t*>(q),
                    static_cast<const uint16_t*>(k),
                    static_cast<const uint16_t*>(v),
                    static_cast<const uint16_t*>(dout), l, dl,
                    static_cast<Bf*>(dk), static_cast<Bf*>(dv), BH, Sq, Sk, D,
                    causal, scale, s);
  };
  auto wide = [&](auto launcher) {
    return launcher(static_cast<const Bf*>(q), static_cast<const Bf*>(k),
                    static_cast<const Bf*>(v), static_cast<const Bf*>(dout),
                    l, dl, static_cast<Bf*>(dk), static_cast<Bf*>(dv), BH, Sq,
                    Sk, D, causal, scale, s);
  };
  cudaError_t e;
  if (D <= 64)
    e = flash_wgmma::launch_dkdv<flash_wgmma::DkdvCfg>(
        q, k, v, dout, l, dl, static_cast<Bf*>(dk), static_cast<Bf*>(dv), BH,
        Sq, Sk, D, causal, scale, s);
  else if (D <= 128)
    e = tc(flash_bf16::launch_dkdv<128>);
  else if (D <= flash_wgmma::kWideMaxD)
    e = flash_wgmma::launch_wide_dkdv(q, k, v, dout, l, dl,
                                      static_cast<Bf*>(dk),
                                      static_cast<Bf*>(dv), BH, Sq, Sk, D,
                                      causal, scale, s);
  else
    e = wide(flash_wide::launch_dkdv_wide<Bf>);
  return static_cast<int>(e);
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int Sq, int Sk, int D, int causal,
                      float scale, void* stream) {
  if (flash_wide::bad_shape(BH, Sq, Sk, D, 8))
    return cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  auto tc = [&](auto launcher) {
    return launcher(static_cast<const uint16_t*>(q),
                    static_cast<const uint16_t*>(k),
                    static_cast<const uint16_t*>(v),
                    static_cast<const uint16_t*>(dout), l, dl,
                    static_cast<Bf*>(dq), BH, Sq, Sk, D, causal, scale, s);
  };
  auto wide = [&](auto launcher) {
    return launcher(static_cast<const Bf*>(q), static_cast<const Bf*>(k),
                    static_cast<const Bf*>(v), static_cast<const Bf*>(dout),
                    l, dl, static_cast<Bf*>(dq), BH, Sq, Sk, D, causal,
                    scale, s);
  };
  cudaError_t e;
  if (D <= 64)
    e = flash_wgmma::launch_dq<flash_wgmma::DqCfg>(
        q, k, v, dout, l, dl, static_cast<Bf*>(dq), BH, Sq, Sk, D, causal,
        scale, s);
  else if (D <= 128)
    e = tc(flash_bf16::launch_dq<128>);
  else if (D <= flash_wgmma::kWideMaxD)
    e = flash_wgmma::launch_wide_dq(q, k, v, dout, l, dl,
                                    static_cast<Bf*>(dq), BH, Sq, Sk, D,
                                    causal, scale, s);
  else
    e = wide(flash_wide::launch_dq_wide<Bf>);
  return static_cast<int>(e);
}

}  // extern "C"
