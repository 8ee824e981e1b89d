// Flash attention backward, float32, head_dim 129 to 512, on the tensor
// cores of Hopper (sm_90a): the bodies of flash_bwd_dkdv_f32 (K3a: dK,
// dV) and flash_bwd_dq_f32 (K3b: dQ) that flash_attention.cu routes here
// above its 128 bucket. The shape plan: head_dim up to 128 runs the
// tensor-core kernels of flash_attention.cu, 129-512 these, and above
// 512 the CUDA-core kernels of flash_wide.cuh in 256-column slices
// (whose score recompute grows with every slice; no model of either
// package runs a head_dim above 128).
//
// Replaces, as the CUDA-core kernels before it, the Pallas TPU kernels of
//   paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py
//     _bwd_dkdv_kernel  (launched by _flash_bwd)  -> wide_dkdv_kernel
//     _bwd_dq_kernel    (launched by _flash_bwd)  -> wide_dq_kernel
// and computes the same function as flash_attention_bwd_reference
// (paddle_tpu_torch/kernels/flash_attention.py): p = exp(s scale - lse),
// 0 on padded rows and columns and where causal masking removes the
// pair; dV = P^T dO, dS = p (dP - delta), dK = scale dS^T Q, dQ = scale
// dS K, from the saved LSE and delta.
//
// What bounds them on this card: operations. Each (query, key) pair
// costs 8D (dK/dV) or 6D (dQ) flops of products, taken in 3xTF32 (three
// TF32 products each, tf32x3.cuh) over 495 TFLOP/s, and ~5 float32 flops
// of exp and ds arithmetic over 67 TFLOP/s. The design:
//   - a block is 8 warps and owns 64 rows (keys in K3a, queries in K3b).
//     Warp w takes the block's rows 16 (w % 4) .. + 15, the m16 side of
//     every product. Warps 0-3 (the S group) take the score product S
//     (S^T = K Q^T in K3a, S = Q K^T in K3b), warps 4-7 (the dP group)
//     dP (dP^T = V dO^T, dP = dO V^T). The other side streams in tiles
//     of 64 rows;
//   - each group streams its own operands through its own ring of
//     kStages slots, filled by its 128 threads with 16-byte cp.async
//     kStages - 1 chunks ahead, and synchronised by its own named
//     barrier: the two groups run as two independent half-blocks, so a
//     barrier of one leaves the other's warps issuing (one ring behind
//     __syncthreads(), which stalls all 8 warps of the SM's one block at
//     every chunk, ran markedly slower on the card). A tile is first its
//     score chunks, 64 head_dim
//     columns of the block's own operand (K or V; Q or dO) and of the
//     tile's (Q or dO; K or V), then its output chunks, 64 columns of
//     the tile's B operand (K3a: dO for dV, Q for dK; K3b: K). Nothing
//     stays resident, so one kernel takes head_dim 512 in 223 KB of
//     shared memory (the block's K and V alone would be 128 KB at 256
//     columns); the block's own rows are re-read from L2 every tile;
//   - shared rows have stride 68 = 4 (mod 32) floats, so every fragment
//     load (row g, column t; or rows 2t, 2t + 1, column g) hits 32
//     distinct banks; head_dim is zero-padded to the chunk in shared
//     memory only, and the k-steps past its end are skipped;
//   - a tile's scores (16 x 64 a warp) take 32 registers a lane. The S
//     warp turns its S into P (exp2 domain, masks) and hands it to the
//     dP warp of the same rows through shared memory behind a named
//     barrier of the two warps: in K3a the dP warp forms dS^T = P^T
//     (dP^T - delta); in K3b it forms dS and hands it back, so both
//     warps hold the same floats. P^T, dS^T (K3a) and dS (K3b) then go
//     from the accumulators straight into the A operand of the output
//     product, k permuted as in flash_attention.cu (acc_as_a / load_bp);
//   - register budget (255 a lane at 256 threads, one block an SM): at
//     D = 256, dK and dV of 64 keys are 2 x 64 x 256 floats, 128 a lane
//     over 256 lanes; a 16-row warp holding both would need 256. So K3a
//     gives each warp ONE output (S warps dV, dP warps dK) over the
//     block's column slice: 16 x SW / 32 = SW / 2 floats (SW = 256:
//     128), scores 32, a chunk's fresh sums 16 (32 while scoring),
//     fragments ~24. K3b's groups take dQ's 64-column chunks in turns
//     (group g chunks g, g + 2, ...): D / 4 floats a lane, 128 at 512;
//     ptxas reports 252-255 registers and a few spilled words (PERF.md);
//   - column slices: K3a's grid z cuts dK and dV into nz = ceil(D / 256)
//     slices of SW <= 256 columns (a multiple of 64); every slice's
//     block recomputes the tile's scores over the whole head_dim. Of
//     the 8D flops a pair the scores are 4D (half), so nz = 2 (D = 260
//     .. 512) adds 4D: half again the products, exactly the score
//     products' share. K3b takes all of dQ up to 512 columns in one
//     block: no recompute;
//   - the tensor core does not round the sums it writes to nearest, so
//     each chunk's products (a score chunk's 64 columns; an output
//     chunk's 64 streamed rows) collect in fresh fragments and join the
//     accumulators by float32 adds (flash_attention.cu's drift note);
//   - exp, the masks and the ds arithmetic stay in float32 on the ALUs
//     in the exp2 domain: p = 2^(s scale log2(e) - lse log2(e)). A tile
//     with no padded row or column and no causal diagonal in the warp's
//     rows skips the mask; causal tiles that no row of the block sees
//     are not streamed (K3a starts at the tile of its first key, K3b
//     stops at its last row) and causal K3b blocks start with the last
//     query rows, which see the most keys;
//   - no atomics: each output element is written once by one lane, and
//     two launches on the same inputs give bitwise-equal outputs.
// What holds them below that floor (PERF.md has the times): issue slots,
// as in the 128 bucket (each 3-MMA product of a B fragment costs two
// shared loads and six integer/float ops to split it, and the four warps
// of a group split the same streamed tile), 8 warps an SM, and the
// block's own rows restaged every tile. Not done yet: wgmma (its TF32 B
// operand comes from shared memory, so 3xTF32 needs two swizzled copies
// of each B tile), TMA, keeping the block's own rows resident where they
// fit.
//
// The kernels allocate nothing; the caller passes the outputs.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "flash_wide.cuh"
#include "tf32x3.cuh"

namespace flash_bwd_wide {

using namespace tf32x3;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = kThreads / 2;    // a warp group: 4 warps
constexpr int kRows = 64;               // the block's own rows
constexpr int kTile = 64;               // streamed rows a tile
constexpr int kCol = 64;                // head_dim columns a chunk
constexpr int kLd = kCol + 4;           // 68 = 4 (mod 32)
constexpr int kOp = kRows * kLd;        // one 64 x kCol operand
constexpr int kSlot = 2 * kOp;          // a group's ring slot: two operands
constexpr int kPLd = kTile + 8;         // 72 = 8 (mod 32): float2 rows
constexpr int kStages = 3;
constexpr int kMaxD = 512;              // above: flash_wide.cuh
constexpr int kSlice = 256;             // K3a: columns a slice at most
constexpr float kLog2e = 1.4426950408889634f;
// named barriers (0 is __syncthreads): a group's ring; the S and dP warps
// of rows 16 m .. 16 m + 15: "ready" (the S warp wrote P) and "done" (K3a:
// the dP warp read it; K3b: the dP warp wrote dS)
constexpr int kBarRing = 1;    // + group
constexpr int kBarReady = 3;   // + m
constexpr int kBarDone = 7;    // + m
constexpr int kPair = 64;      // threads of a pair barrier: two warps

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Rows [r0, r0 + 64) and columns [c0, c0 + kCol) of a row-major [S, D]
// matrix into shared memory with row stride kLd, by the calling warp
// group; rows at or past S and columns at or past D are zero-filled (D
// and c0 multiples of 4).
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int r0,
                                      int S, int D, int c0) {
  constexpr int kV = kCol / 4;
  for (int i = threadIdx.x % kGroup; i < kRows * kV; i += kGroup) {
    const int r = i / kV;
    const int c = (i % kV) * 4;
    const bool ok = r0 + r < S && c0 + c < D;
    cp_async16(dst + r * kLd + c,
               ok ? src + static_cast<int64_t>(r0 + r) * D + c0 + c : src,
               ok ? 16 : 0);
  }
}

// Entries [r0, r0 + 64) of a length-S vector, by the calling warp group;
// zeros past S.
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int S) {
  for (int i = threadIdx.x % kGroup; i < kTile; i += kGroup) {
    const bool ok = r0 + i < S;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok ? 4 : 0);
  }
}

// sc += A B^T over one score chunk: A the warp's 16 rows, B the tile's
// 64 rows (n-tiles j: rows 8j .. 8j + 7), both at stride kLd; k-steps at
// or past `cols` (the head_dim's end) are skipped. The chunk's sums
// collect in fresh fragments and join sc by float32 adds.
__device__ __forceinline__ void score_chunk(float (&sc)[kTile / 8][4],
                                            const float* a, const float* b,
                                            int g, int t, int cols) {
  float f[kTile / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < kCol / 8; ++kk) {
    if (8 * kk >= cols) break;
    uint32_t ab[4], as[4];
    load_a(a, kLd, kk, g, t, ab, as);
#pragma unroll
    for (int j = 0; j < kTile / 8; j += 4) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_bt(b, kLd, j + i, kk, g, t, bb[i], bs[i]);
      mma3x4(f[j], f[j + 1], f[j + 2], f[j + 3], ab, as, ab, as, ab, as, ab,
             as, bb, bs);
    }
  }
  add_tiles(sc, f);
}

// acc[0 .. kCol / 8) += X B for one output chunk: X the warp's 16 x 64
// scores (P^T, dS^T or dS) in accumulator layout, B a [64][kLd] chunk of
// the tile's rows; k runs over the tile's 64 rows, permuted (acc_as_a /
// load_bp). Each 4 n-tiles' sums collect in fresh fragments.
__device__ __forceinline__ void out_chunk(float (*acc)[4],
                                          const float (&x)[kTile / 8][4],
                                          const float* b, int g, int t) {
#pragma unroll
  for (int n0 = 0; n0 < kCol / 8; n0 += 4) {
    float f[4][4] = {};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      uint32_t ab[4], as[4];
      acc_as_a(x[j], ab, as);
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_bp(b, kLd, j, n0 + i, g, t, bb[i], bs[i]);
      mma3x4(f[0], f[1], f[2], f[3], ab, as, ab, as, ab, as, ab, as, bb, bs);
    }
    add_tiles(acc + n0, f);
  }
}

// A warp group's ring: chunk i of the group's sequence lands in slot
// i % kStages. Before chunk `done` is read: wait for it, the group's
// barrier (its four warps are done with chunk done - 1, whose slot is
// refilled next), issue chunk done + kStages - 1.
struct Ring {
  float* base;
  int bar, done, total;
  template <typename Issue>
  __device__ __forceinline__ const float* next(Issue&& issue) {
    cp_async_wait<kStages - 2>();
    bar_sync(bar, kGroup);
    const int i = done + kStages - 1;
    if (i < total) issue(i, base + (i % kStages) * kSlot);
    cp_async_commit();
    return base + (done++ % kStages) * kSlot;
  }
  template <typename Issue>
  __device__ __forceinline__ void prologue(Issue&& issue) {
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < total) issue(i, base + i * kSlot);
      cp_async_commit();
    }
  }
};

// ------------------------------------------------------------ K3a dK dV
// grid (BH, ceil(Sk / 64), nz): the block owns 64 keys and the output
// columns [c0, c0 + sw) of dK and dV, and streams query tiles of 64
// rows from the tile of its first key when causal. The S group (warps
// 0-3) scores S^T = K Q^T and accumulates dV; the dP group (4-7) dP^T =
// V dO^T and dK, each through its own ring. NB: kCol-column output
// chunks a slice holds at most (sw <= kCol NB).
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
wide_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Sq, int Sk, int D, int sw,
                 int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* rings = reinterpret_cast<float*>(smem4);  // [2][kStages][kSlot]
  float* pt = rings + 2 * kStages * kSlot;          // [kRows][kPLd]: P^T
  float* vecs = pt + kRows * kPLd;                  // [2][2][kTile]

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int c0 = blockIdx.z * sw;
  const int cw = min(sw, D - c0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m = warp % 4;
  const int rw = 16 * m;           // the warp's first key in the block
  const bool dpw = warp >= 4;      // the dP group: dP^T and dK
  const int grp = dpw ? 1 : 0;
  const float* qb = q + bh * Sq * D;
  const float* dob = dout + bh * Sq * D;
  // the group's score operands (A: the block's keys, B: the tile's
  // queries), the B operand of its output product, its row vector
  const float* own = (dpw ? v : k) + bh * Sk * D;
  const float* other = dpw ? dob : qb;
  const float* outb = dpw ? qb : dob;
  const float* rowv = (dpw ? delta : lse) + bh * Sq;
  float* vec = vecs + grp * 2 * kTile;

  // query tiles wholly before the block's first key see none of it
  const int start = causal ? k0 : 0;
  const int n_tiles = start < Sq ? (Sq - start + kTile - 1) / kTile : 0;
  const int na = (D + kCol - 1) / kCol;   // score chunks a tile
  const int nb = (cw + kCol - 1) / kCol;  // output chunks a tile
  const int per = na + nb;
  auto issue = [&](int i, float* s) {
    const int it = i / per, c = i % per;
    const int t0 = start + it * kTile;
    if (c < na) {
      stage(s, own, k0, Sk, D, c * kCol);
      stage(s + kOp, other, t0, Sq, D, c * kCol);
      if (c == 0) stage_vec(vec + (it & 1) * kTile, rowv, t0, Sq);
    } else {
      stage(s, outb, t0, Sq, D, c0 + (c - na) * kCol);
    }
  };
  Ring ring = {rings + grp * kStages * kSlot, kBarRing + grp, 0,
               n_tiles * per};
  ring.prologue(issue);

  // the warp's output: dV (S group) or dK, its 16 keys x the slice
  float acc[kCol / 8 * NB][4];
#pragma unroll
  for (int n = 0; n < kCol / 8 * NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const float scale_log2 = scale * kLog2e;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = start + it * kTile;
    // S^T = K Q^T (S group) or dP^T = V dO^T: the warp's 16 keys x 64
    // queries, over the whole head_dim
    float sc[kTile / 8][4] = {};
    for (int a = 0; a < na; ++a) {
      const float* s = ring.next(issue);
      score_chunk(sc, s + rw * kLd, s + kOp, g, t, D - a * kCol);
    }
    const float* vv = vec + (it & 1) * kTile;  // lse or delta of the tile
    if (!dpw) {
      // P^T in place, zeroed on padded rows and columns and where causal
      // masking removes the pair; a tile with none of these in the
      // warp's keys skips the mask. Then P^T to shared memory for the dP
      // warp of the same keys, once it has read the last tile's.
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            float p = exp2f(sc[j][e] * scale_log2 - vv[col] * kLog2e);
            if (decltype(masked)::value) {
              const int kpos = k0 + rw + g + (e & 2 ? 8 : 0);
              const int qpos = t0 + col;
              if (!(qpos < Sq && kpos < Sk && (!causal || qpos >= kpos)))
                p = 0.f;
            }
            sc[j][e] = p;
          }
      };
      if (t0 + kTile <= Sq && k0 + kRows <= Sk &&
          (!causal || t0 >= k0 + rw + 15))
        probs(std::false_type());
      else
        probs(std::true_type());
      if (it > 0) bar_sync(kBarDone + m, kPair);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(pt + (rw + g + 8 * h) * kPLd + 8 * j +
                                     2 * t) =
              make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
      __threadfence_block();
      bar_arrive(kBarReady + m, kPair);
    } else {
      // dS^T = P^T (dP^T - delta), P^T from the S warp of these keys
      bar_sync(kBarReady + m, kPair);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + 2 * t;
          const float2 p = *reinterpret_cast<const float2*>(
              pt + (rw + g + 8 * h) * kPLd + col);
          sc[j][2 * h] = p.x * (sc[j][2 * h] - vv[col]);
          sc[j][2 * h + 1] = p.y * (sc[j][2 * h + 1] - vv[col + 1]);
        }
      if (it + 1 < n_tiles) bar_arrive(kBarDone + m, kPair);
    }
    // dV += P^T dO (S group), dK += dS^T Q: kCol columns of the slice a
    // chunk
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        const float* s = ring.next(issue);
        out_chunk(acc + kCol / 8 * b, sc, s, g, t);
      }
    }
  }
  cp_async_wait_all();

  // each output element is written once, by one lane
  float* out = dpw ? dk : dv;
  const float mul = dpw ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + rw + g + 8 * h;
    if (kpos >= Sk) continue;
    float* row = out + (bh * Sk + kpos) * D + c0;
#pragma unroll
    for (int n = 0; n < kCol / 8 * NB; ++n) {
      const int d = 8 * n + 2 * t;  // D is a multiple of 4: d + 1 < D too
      if (d < cw)
        *reinterpret_cast<float2*>(row + d) =
            make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
  }
}

// ------------------------------------------------------------- K3b dQ
// grid (BH, ceil(Sq / 64)): the block owns 64 query rows and all of dQ's
// columns, and streams key tiles of 64 rows up to its last row when
// causal (then the last rows first). The S group (warps 0-3) scores S =
// Q K^T, the dP group (4-7) dP = dO V^T, each through its own ring;
// group g accumulates dQ's output chunks g, g + 2, ... (kCol columns
// each). NB: output chunks a group takes at most.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
wide_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq,
               int Sq, int Sk, int D, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* rings = reinterpret_cast<float*>(smem4);  // [2][kStages][kSlot]
  float* xbuf = rings + 2 * kStages * kSlot;        // [kRows][kPLd]: P, dS

  const int64_t bh = blockIdx.x;
  const int yb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = yb * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m = warp % 4;
  const int rw = 16 * m;           // the warp's first row in the block
  const bool dpw = warp >= 4;      // the dP group
  const int grp = dpw ? 1 : 0;
  const float* own = (dpw ? dout : q) + bh * Sq * D;
  const float* other = (dpw ? v : k) + bh * Sk * D;
  const float* kb = k + bh * Sk * D;

  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  const int na = (D + kCol - 1) / kCol;      // score chunks a tile
  const int nb = (na - grp + 1) / 2;         // the group's output chunks
  const int per = na + nb;
  auto issue = [&](int i, float* s) {
    const int it = i / per, c = i % per;
    const int t0 = it * kTile;
    if (c < na) {
      stage(s, own, q0, Sq, D, c * kCol);
      stage(s + kOp, other, t0, Sk, D, c * kCol);
    } else {
      stage(s, kb, t0, Sk, D, (2 * (c - na) + grp) * kCol);
    }
  };
  Ring ring = {rings + grp * kStages * kSlot, kBarRing + grp, 0,
               n_tiles * per};
  ring.prologue(issue);

  // the lane's rows g and g + 8 of the warp: lse in log2 units, delta
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + rw + g + 8 * h;
    lse_r[h] = qpos < Sq ? lse[bh * Sq + qpos] * kLog2e : 0.f;
    delta_r[h] = qpos < Sq ? delta[bh * Sq + qpos] : 0.f;
  }
  // the warp's dQ: its 16 rows x the group's output chunks
  float acc[kCol / 8 * NB][4];
#pragma unroll
  for (int n = 0; n < kCol / 8 * NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const float scale_log2 = scale * kLog2e;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kTile;
    // S = Q K^T (S group) or dP = dO V^T: the warp's 16 rows x 64 keys
    float sc[kTile / 8][4] = {};
    for (int a = 0; a < na; ++a) {
      const float* s = ring.next(issue);
      score_chunk(sc, s + rw * kLd, s + kOp, g, t, D - a * kCol);
    }
    float* xw = xbuf + rw * kPLd;
    if (!dpw) {
      // P in place, zeroed on padded rows and columns and where causal
      // masking removes the pair (a tile with none in the warp's rows
      // skips the mask), to the dP warp of the same rows; then its dS
      // back
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            float p = exp2f(sc[j][e] * scale_log2 - lse_r[h]);
            if (decltype(masked)::value) {
              const int qpos = q0 + rw + g + 8 * h;
              const int kpos = t0 + 8 * j + 2 * t + (e & 1);
              if (!(qpos < Sq && kpos < Sk && (!causal || kpos <= qpos)))
                p = 0.f;
            }
            sc[j][e] = p;
          }
      };
      if (q0 + kRows <= Sq && t0 + kTile <= Sk &&
          (!causal || t0 + kTile - 1 <= q0 + rw))
        probs(std::false_type());
      else
        probs(std::true_type());
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(xw + (g + 8 * h) * kPLd + 8 * j +
                                     2 * t) =
              make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
      __threadfence_block();
      bar_arrive(kBarReady + m, kPair);
      bar_sync(kBarDone + m, kPair);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 x = *reinterpret_cast<const float2*>(
              xw + (g + 8 * h) * kPLd + 8 * j + 2 * t);
          sc[j][2 * h] = x.x;
          sc[j][2 * h + 1] = x.y;
        }
    } else {
      // dS = P (dP - delta) over P from the S warp, and back to it: both
      // warps then hold the same floats
      bar_sync(kBarReady + m, kPair);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* x = reinterpret_cast<float2*>(xw + (g + 8 * h) * kPLd +
                                                8 * j + 2 * t);
          const float2 p = *x;
          sc[j][2 * h] = p.x * (sc[j][2 * h] - delta_r[h]);
          sc[j][2 * h + 1] = p.y * (sc[j][2 * h + 1] - delta_r[h]);
          *x = make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
        }
      __threadfence_block();
      bar_arrive(kBarDone + m, kPair);
    }
    // dQ += dS K over the group's output chunks
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        const float* s = ring.next(issue);
        out_chunk(acc + kCol / 8 * b, sc, s, g, t);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + rw + g + 8 * h;
    if (qpos >= Sq) continue;
    float* row = dq + (bh * Sq + qpos) * D;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int n = 0; n < kCol / 8; ++n) {
        const int d = kCol * (2 * b + grp) + 8 * n + 2 * t;
        if (d < D)
          *reinterpret_cast<float2*>(row + d) = make_float2(
              acc[kCol / 8 * b + n][2 * h] * scale,
              acc[kCol / 8 * b + n][2 * h + 1] * scale);
      }
  }
}

// ------------------------------------------------------------ launchers

template <int NB>
cudaError_t launch_dkdv_nb(const float* q, const float* k, const float* v,
                           const float* dout, const float* lse,
                           const float* delta, float* dk, float* dv, int BH,
                           int Sq, int Sk, int D, int sw, int nz, int causal,
                           float scale, cudaStream_t stream) {
  const size_t smem = flash_wide::floats(2 * kStages * kSlot + kRows * kPLd +
                                         4 * kTile);
  auto kernel = wide_dkdv_kernel<NB>;
  cudaError_t e = flash_wide::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sk + kRows - 1) / kRows, nz);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, D, sw, causal, scale);
  return cudaGetLastError();
}

// K3a at 128 < D <= 512: nz = ceil(D / 256) slices of sw columns (a
// multiple of kCol), the kernel by the chunks of sw
inline cudaError_t launch_dkdv(const float* q, const float* k,
                               const float* v, const float* dout,
                               const float* lse, const float* delta,
                               float* dk, float* dv, int BH, int Sq, int Sk,
                               int D, int causal, float scale,
                               cudaStream_t stream) {
  if (D > kMaxD) return cudaErrorInvalidValue;
  const int nz = (D + kSlice - 1) / kSlice;
  const int sw = ((D + nz - 1) / nz + kCol - 1) / kCol * kCol;
  constexpr int kFull = kSlice / kCol;
  return sw <= 192
             ? launch_dkdv_nb<192 / kCol>(q, k, v, dout, lse, delta, dk, dv,
                                          BH, Sq, Sk, D, sw, nz, causal,
                                          scale, stream)
             : launch_dkdv_nb<kFull>(q, k, v, dout, lse, delta, dk, dv, BH,
                                     Sq, Sk, D, sw, nz, causal, scale,
                                     stream);
}

template <int NB>
cudaError_t launch_dq_nb(const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* delta, float* dq, int BH, int Sq,
                         int Sk, int D, int causal, float scale,
                         cudaStream_t stream) {
  const size_t smem = flash_wide::floats(2 * kStages * kSlot + kRows * kPLd);
  auto kernel = wide_dq_kernel<NB>;
  cudaError_t e = flash_wide::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

// K3b at 128 < D <= 512: the kernel by the output chunks a group takes
// (half of ceil(D / kCol), rounded up), at head_dim 256, 384 or 512
inline cudaError_t launch_dq(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* delta, float* dq, int BH, int Sq,
                             int Sk, int D, int causal, float scale,
                             cudaStream_t stream) {
  if (D > kMaxD) return cudaErrorInvalidValue;
  if (D <= 256)
    return launch_dq_nb<256 / kCol / 2>(q, k, v, dout, lse, delta, dq, BH,
                                        Sq, Sk, D, causal, scale, stream);
  if (D <= 384)
    return launch_dq_nb<384 / kCol / 2>(q, k, v, dout, lse, delta, dq, BH,
                                        Sq, Sk, D, causal, scale, stream);
  return launch_dq_nb<kMaxD / kCol / 2>(q, k, v, dout, lse, delta, dq, BH,
                                        Sq, Sk, D, causal, scale, stream);
}

}  // namespace flash_bwd_wide
