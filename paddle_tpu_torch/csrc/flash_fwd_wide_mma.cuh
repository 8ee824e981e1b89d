// Flash attention forward, float32, head_dim 129 to 512, on the tensor
// cores of Hopper (sm_90a): the body of flash_fwd_f32 (K2) that
// flash_attention.cu routes here above its 128 bucket. The shape plan:
// head_dim up to 128 runs the tensor-core kernel of flash_attention.cu,
// 129-512 this one, and above 512 the CUDA-core kernel of flash_wide.cuh
// in 256-column slices (no model of either package runs a head_dim above
// 128).
//
// Replaces, as the CUDA-core kernel before it, the Pallas TPU kernel
//   paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py
//     _fwd_kernel  (launched by _fwd_pallas)  -> wide_fwd_kernel
// and computes the same function as flash_attention_fwd_reference
// (paddle_tpu_torch/kernels/flash_attention.py): s = scale q.k, an online
// softmax over key tiles, O = P V / max(l, FLT_MIN), lse = m + log(max(l,
// FLT_MIN)); masked scores give probabilities of exactly 0.
//
// What bounds it on this card: operations. Each (query, key) pair costs
// 4D flops of products, taken in 3xTF32 (three TF32 products each,
// tf32x3.cuh) over 495 TFLOP/s, and ~5 float32 flops of exp and softmax
// arithmetic over 67 TFLOP/s. The design takes flash_bwd_wide_mma.cuh's
// machinery (its rings, staging, pair barriers and fragment helpers):
//   - a block is 8 warps and owns 64 query rows; warp w takes rows 16 (w
//     % 4) .. + 15, the m16 side of every product. Each group of 4 warps
//     streams key tiles of 64 rows through its own cp.async ring behind
//     its own named barrier, as the backward kernels' groups do;
//   - the head_dim is cut into 64-column chunks, and group g takes chunks
//     g, g + 2, ...: its partial scores (Q's and K's columns of the chunk,
//     staged together) and its share of O (V's columns). The warp of
//     group 1 hands its partial S to the warp of group 0 of the same rows
//     through shared memory behind a pair barrier; that warp adds it (S =
//     S_0 + S_1 in float32), masks, moves the running max m and sum l,
//     forms P and hands P and the rescale alpha back. Each group so does
//     half of the score products and half of P V; with the whole score in
//     one group (as the backward's S group) that group would do three
//     quarters of the products while the other waited;
//   - O's chunks stay in registers: D / 4 floats a lane at D = 512, 128,
//     so one block takes the whole head_dim, with no column slices and no
//     score recompute (flash_wide.cuh at 264 and 512 computes every score
//     twice); ptxas: 236, 253 and 254 registers (up to 2, 3 and 4 chunks
//     a group), no spill;
//   - O = O alpha + P V: each tile's P V of a chunk collects in fresh
//     fragments joined by one float32 FFMA an element, and each score
//     chunk's products join S by float32 adds, which round to nearest
//     (flash_attention.cu's drift note);
//   - exp and the softmax run in float32 on the ALUs in the exp2 domain,
//     as flash_attention.cu's forward: m in units of s scale log2(e), a
//     row's scores in a quad's 4 lanes (two shuffles for the max), each
//     lane's share of l summed over the quad at the end. Masked scores
//     become -inf and give p = 0 exactly; a tile with no key past Sk and
//     no causal diagonal in the warp's rows skips the mask; causal blocks
//     stop at the key tile of their last row, and causal grids start
//     with the last rows, which see the most keys;
//   - the row denominators go from group 0 to group 1 once, at the end,
//     behind __syncthreads(); group 0 writes the LSE. Each O element is
//     written once by one lane, with no atomics: two launches give
//     bitwise-equal O and LSE.
// What holds it below that floor (PERF.md has the times): issue slots,
// as in the backward kernels (each 3-MMA product of a B fragment costs
// two shared loads and six integer or float ops to split it), and Q
// restaged every tile (64 x 512 floats would not fit beside the rings).
//
// The kernel allocates nothing; the caller passes the outputs.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "flash_bwd_wide_mma.cuh"
#include "flash_wide.cuh"
#include "tf32x3.cuh"

namespace flash_fwd_wide {

using namespace flash_bwd_wide;

constexpr float kLn2 = 0.6931471805599453f;
// pair barriers of the two warps of rows 16 m .. 16 m + 15: group 1's
// partial scores written; group 0's P and alpha written
constexpr int kBarPartial = kBarReady;  // + m
constexpr int kBarProbs = kBarDone;     // + m

// acc[0 .. kCol / 8) = acc alpha + P B for one output chunk: P the
// warp's 16 x 64 probabilities in accumulator layout, B a [64][kLd] chunk
// of the tile's V rows; k runs over the tile's 64 keys, permuted
// (acc_as_a / load_bp). Each 4 n-tiles' sums collect in fresh fragments,
// merged by one float32 FFMA an element.
__device__ __forceinline__ void out_chunk_scaled(
    float (*acc)[4], const float (&x)[kTile / 8][4], const float* b,
    const float (&alpha)[2], int g, int t) {
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n0 + i][e] = fmaf(acc[n0 + i][e], alpha[e >> 1], f[i][e]);
  }
}

// grid (BH, ceil(Sq / 64)): the block owns 64 query rows and all of O's
// columns, and streams key tiles of 64 rows up to its last row when
// causal (then the last rows first). Group g (warps 4g .. 4g + 3) takes
// the head_dim's chunks g, g + 2, ... through its own ring: a tile is its
// score chunks (Q and K), then its output chunks (V). NB: chunks a group
// takes at most.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
wide_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int Sq, int Sk, int D, int causal,
                float scale) {
  extern __shared__ float4 smem4[];
  float* rings = reinterpret_cast<float*>(smem4);  // [2][kStages][kSlot]
  float* xbuf = rings + 2 * kStages * kSlot;  // [kRows][kPLd]: S_1, then P
  float* alphas = xbuf + kRows * kPLd;        // [kRows]
  float* denoms = alphas + kRows;             // [kRows]

  const int64_t bh = blockIdx.x;
  const int yb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = yb * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m = warp % 4;
  const int rw = 16 * m;  // the warp's first row in the block
  const int grp = warp / 4;
  const float* qb = q + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;

  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  const int na = (D + kCol - 1) / kCol;  // head_dim chunks
  const int nc = (na - grp + 1) / 2;     // the group's chunks
  const int per = 2 * nc;                // ring chunks a tile
  auto issue = [&](int i, float* s) {
    const int c = i % per;
    const int t0 = i / per * kTile;
    if (c < nc) {
      const int c0 = (2 * c + grp) * kCol;
      stage(s, qb, q0, Sq, D, c0);
      stage(s + kOp, kb, t0, Sk, D, c0);
    } else {
      stage(s, vb, t0, Sk, D, (2 * (c - nc) + grp) * kCol);
    }
  };
  Ring ring = {rings + grp * kStages * kSlot, kBarRing + grp, 0,
               n_tiles * per};
  ring.prologue(issue);

  // the lane's rows g and g + 8: the running max in units of s scale
  // log2(e) and the lane's share of the running sum (group 0), and the
  // group's chunks of O (columns 8n + 2t, 8n + 2t + 1 of each)
  const float c2 = scale * kLog2e;
  float mr[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[kCol / 8 * NB][4];
#pragma unroll
  for (int n = 0; n < kCol / 8 * NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* xw = xbuf + rw * kPLd;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kTile;
    // the group's partial S = Q K^T: the warp's 16 rows x 64 keys over
    // its chunks of the head_dim
    float sc[kTile / 8][4] = {};
    for (int a = 0; a < nc; ++a) {
      const float* s = ring.next(issue);
      score_chunk(sc, s + rw * kLd, s + kOp, g, t, D - (2 * a + grp) * kCol);
    }
    float alpha[2];
    if (grp == 0) {
      // S = S_0 + S_1; masked scores become -inf (p = 0 exactly)
      bar_sync(kBarPartial + m, kPair);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 x = *reinterpret_cast<const float2*>(
              xw + (g + 8 * h) * kPLd + 8 * j + 2 * t);
          sc[j][2 * h] += x.x;
          sc[j][2 * h + 1] += x.y;
        }
      if (!(t0 + kTile <= Sk && (!causal || t0 + kTile - 1 <= q0 + rw))) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + rw + g + (e & 2 ? 8 : 0);
            const int kpos = t0 + 8 * j + 2 * t + (e & 1);
            if (!(kpos < Sk && (!causal || kpos <= qpos)))
              sc[j][e] = -INFINITY;
          }
      }
      // online softmax: the row max over the quad's 4 lanes, then p =
      // 2^(s c - m), one FFMA and one ex2 a score
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mr[h], mx * c2);
        alpha[h] = exp2f(mr[h] - m_new);
        mr[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(sc[j][e], c2, -mr[e >> 1]));
          sc[j][e] = p;
          l[e >> 1] += p;
        }
      // P and alpha to the group-1 warp of these rows
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(xw + (g + 8 * h) * kPLd + 8 * j +
                                     2 * t) =
              make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
      if (t == 0) {
        alphas[rw + g] = alpha[0];
        alphas[rw + g + 8] = alpha[1];
      }
      __threadfence_block();
      bar_arrive(kBarProbs + m, kPair);
    } else {
      // the partial to the group-0 warp of these rows; P and alpha back
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(xw + (g + 8 * h) * kPLd + 8 * j +
                                     2 * t) =
              make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
      __threadfence_block();
      bar_arrive(kBarPartial + m, kPair);
      bar_sync(kBarProbs + m, kPair);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 x = *reinterpret_cast<const float2*>(
              xw + (g + 8 * h) * kPLd + 8 * j + 2 * t);
          sc[j][2 * h] = x.x;
          sc[j][2 * h + 1] = x.y;
        }
      alpha[0] = alphas[rw + g];
      alpha[1] = alphas[rw + g + 8];
    }
    // O = O alpha + P V over the group's output chunks
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nc) {
        const float* s = ring.next(issue);
        out_chunk_scaled(acc + kCol / 8 * b, sc, s, alpha, g, t);
      }
    }
  }
  cp_async_wait_all();

  // group 0: the row sums over the quad's lanes, their denominators to
  // both groups; lse = (m + log2 l) ln 2 in natural-log units
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float denom = fmaxf(sum, FLT_MIN);
      const int qpos = q0 + rw + g + 8 * h;
      if (t == 0) {
        denoms[rw + g + 8 * h] = denom;
        if (qpos < Sq) lse[bh * Sq + qpos] = (mr[h] + log2f(denom)) * kLn2;
      }
    }
  }
  __syncthreads();

  // each O element is written once, by one lane: acc / denom, one
  // division an element as the plain version's
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + rw + g + 8 * h;
    if (qpos >= Sq) continue;
    const float denom = denoms[rw + g + 8 * h];
    float* row = o + (bh * Sq + qpos) * D;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nc) {
#pragma unroll
        for (int n = 0; n < kCol / 8; ++n) {
          const int d = kCol * (2 * b + grp) + 8 * n + 2 * t;
          if (d < D)  // D is a multiple of 4: d + 1 < D too
            *reinterpret_cast<float2*>(row + d) =
                make_float2(acc[kCol / 8 * b + n][2 * h] / denom,
                            acc[kCol / 8 * b + n][2 * h + 1] / denom);
        }
      }
    }
  }
}

template <int NB>
cudaError_t launch_fwd_nb(const float* q, const float* k, const float* v,
                          float* o, float* lse, int BH, int Sq, int Sk,
                          int D, int causal, float scale,
                          cudaStream_t stream) {
  const size_t smem = flash_wide::floats(2 * kStages * kSlot + kRows * kPLd +
                                         2 * kRows);
  auto kernel = wide_fwd_kernel<NB>;
  cudaError_t e = flash_wide::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, Sq, Sk, D,
                                           causal, scale);
  return cudaGetLastError();
}

// K2 at 128 < D <= 512: the kernel by the chunks a group takes (half of
// ceil(D / kCol), rounded up), at head_dim 256, 384 or 512
inline cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                              float* o, float* lse, int BH, int Sq, int Sk,
                              int D, int causal, float scale,
                              cudaStream_t stream) {
  if (D > kMaxD) return cudaErrorInvalidValue;
  if (D <= 256)
    return launch_fwd_nb<256 / kCol / 2>(q, k, v, o, lse, BH, Sq, Sk, D,
                                         causal, scale, stream);
  if (D <= 384)
    return launch_fwd_nb<384 / kCol / 2>(q, k, v, o, lse, BH, Sq, Sk, D,
                                         causal, scale, stream);
  return launch_fwd_nb<kMaxD / kCol / 2>(q, k, v, o, lse, BH, Sq, Sk, D,
                                         causal, scale, stream);
}

}  // namespace flash_fwd_wide
