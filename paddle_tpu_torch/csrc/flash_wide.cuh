// Flash attention at head_dim above 128 on the CUDA cores, for Hopper
// (sm_90a): the forward, dK/dV and dQ kernels that flash_attention.cu
// (float32) and flash_attention_bf16.cuh (bfloat16) launch above the
// tensor-core buckets, templated on the element type T of q, k, v, dO
// and the outputs (lse and delta are float32 for both).
//
// Why CUDA cores: the tensor-core kernels keep a 16-row warp's
// accumulators in registers; at 256 columns the output alone would take
// 128 registers a lane (dK and dV 256). These kernels run 4 rows a warp
// (16 a block), and stream the other operand in tiles of 32 rows, one row
// a lane while scoring: lane j computes the scores of row j against the
// warp's 4 rows; lane l holds output columns l, l + 32, ... (NE = 8 of
// them, 256 in all). Above 256 columns the grid's z axis cuts the output
// into 256-column slices (O in the forward, dK and dV, dQ), one a block:
// every block computes its scores (and dP = dO V^T) over the whole
// head_dim, in 256-column chunks staged through shared memory in the
// order 0, 256, ..., so every slice computes the same softmax (and dS) bit
// for bit, then accumulates its own columns; the forward's slice 0 writes
// the LSE. Up to 256 columns there is one slice and one chunk, and the
// block's own rows stay in shared memory for the whole key loop: the
// kernels' kSliced = false form, whose chunk loop the compiler removes (a
// runtime loop there cost the 256 bucket registers and 60% more time on
// the card, PERF.md PR 8). Tiles read by lane-row are padded by one float
// (no bank conflicts); the block's own rows are read as broadcasts. Every
// sum is a float32 FMA chain in a fixed order, so two launches give
// bitwise-equal outputs.
//
// The element type (Elem<T>): rows load 16 bytes at a time and widen to
// float32 in shared memory (head_dim a multiple of 4 float32 or 8
// bfloat16 values; the wrapper zero-pads it). float32 is the TPU
// kernels' float32 function. bfloat16 is their bfloat16 branch: the
// forward's online softmax moves its running max once per 128 keys (the
// JAX kernel's block_k; 4 tiles of 32 scored before the block's max,
// then V restaged tile by tile for P V), P is rounded to bfloat16
// (__float2bfloat16_rn) before P V and dV, dS before dK and dQ, and the
// outputs are rounded once to bfloat16. In float32 a softmax block is
// one tile and V is staged with the tile's last chunk.
//
// _build.py hashes every csrc/*.cuh with each .cu, so an edit here
// rebuilds both libraries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace flash_wide {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWideRowsPerWarp = 4;
constexpr int kWideRows = kWarps * kWideRowsPerWarp;  // 16 a block
constexpr int kWideTile = 32;
constexpr int kWideNE = 8;
constexpr int kWideChunk = 32 * kWideNE;              // 256 columns

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kTilesPerMax = 1;  // the softmax block: one tile
  // 16 bytes of a row, as float32 (a float4 load: with a uint4 load
  // and bit casts the sliced kernels ran slower on the card)
  __device__ static void load16(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  // a probability or dS as the operand of its product
  __device__ static float operand(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kTilesPerMax = 4;  // 128 keys, the JAX block_k
  __device__ static void load16(const __nv_bfloat16* p, float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower index in the low half
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float operand(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

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
// matrix of T into shared memory as float32 with row stride ld (16-byte
// loads: D, c0 and w are multiples of 16 / sizeof(T)); rows at or past S
// are zeros.
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, int ld,
                                           const T* __restrict__ src, int r0,
                                           int n, int S, int D, int c0,
                                           int w) {
  constexpr int V = 16 / sizeof(T);
  const int wv = w / V;
  for (int i = threadIdx.x; i < n * wv; i += kThreads) {
    const int r = i / wv;
    const int dd = (i % wv) * V;
    float x[V];
    if (r0 + r < S) {
      Elem<T>::load16(src + static_cast<int64_t>(r0 + r) * D + c0 + dd, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
    float* o = dst + r * ld + dd;
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = x[e];
  }
}

__device__ __forceinline__ void stage_entries(float* dst,
                                              const float* __restrict__ src,
                                              int r0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = r0 + i < S ? src[r0 + i] : 0.f;
}

// grid (BH, ceil(Sq / 16), ceil(D / 256)); keys in softmax blocks of NB
// tiles of 32
template <typename T, bool kSliced>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int D,
                      int causal, float scale) {
  constexpr int R = kWideRowsPerWarp;
  constexpr int NB = Elem<T>::kTilesPerMax;
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
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
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

  for (int b0 = 0; b0 < n_keys; b0 += NB * kWideTile) {
    // the block's scores: lane j holds key b0 + 32 tb + j of each tile tb
    float s[NB][R];
#pragma unroll
    for (int tb = 0; tb < NB; ++tb) {
#pragma unroll
      for (int i = 0; i < R; ++i) s[tb][i] = 0.f;
      const int t0 = b0 + tb * kWideTile;
      if (t0 >= n_keys) continue;  // past the last key: masked below
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int d0 = ci * kWideChunk;
        const int dw = kSliced ? min(kWideChunk, D - d0) : D;
        __syncthreads();  // the previous chunk or tile is consumed
        if (kSliced) stage_cols(qs, dw, qb, q0, kWideRows, Sq, D, d0, dw);
        stage_cols(ks, dw + 1, kb, t0, kWideTile, Sk, D, d0, dw);
        if (NB == 1 && ci == n_chunks - 1)  // the last chunk: V too
          stage_cols(vs, cw, vb, t0, kWideTile, Sk, D, c0, cw);
        __syncthreads();
        const float* kr = ks + lane * (dw + 1);
        const float* qw = qs + rw * dw;
#pragma unroll 4
        for (int d = 0; d < dw; ++d) {
          const float kd = kr[d];
#pragma unroll
          for (int i = 0; i < R; ++i)
            s[tb][i] = fmaf(qw[i * dw + d], kd, s[tb][i]);
        }
      }
    }

    // online softmax over the block: its max, then p = exp(s - m_new)
    float p[NB][R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float si[NB], mx = -1e30f;
#pragma unroll
      for (int tb = 0; tb < NB; ++tb) {
        const bool keep = b0 + tb * kWideTile + lane <= limit[i];
        si[tb] = keep ? s[tb][i] * scale : -1e30f;
        mx = tb == 0 ? si[0] : fmaxf(mx, si[tb]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int tb = 0; tb < NB; ++tb) {
        const bool keep = b0 + tb * kWideTile + lane <= limit[i];
        p[tb][i] = keep ? expf(si[tb] - m_new) : 0.f;
        sum = tb == 0 ? p[0][i] : sum + p[tb][i];
      }
      l[i] = l[i] * alpha + warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kWideNE; ++e) acc[i][e] *= alpha;
    }

    // O += P V, tile by tile (P rounded as the product's operand)
#pragma unroll
    for (int tb = 0; tb < NB; ++tb) {
      const int t0 = b0 + tb * kWideTile;
      if (t0 >= n_keys) break;
      if (NB > 1) {
        __syncthreads();  // the scores' K tiles and the last V are read
        stage_cols(vs, cw, vb, t0, kWideTile, Sk, D, c0, cw);
        __syncthreads();
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
          const float pj =
              Elem<T>::operand(__shfl_sync(0xffffffffu, p[tb][i], j));
#pragma unroll
          for (int e = 0; e < kWideNE; ++e)
            acc[i][e] = fmaf(pj, vd[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + rw + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], FLT_MIN);
    T* orow = o + (bh * Sq + qpos) * D + c0;
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) {
      const int d = lane + 32 * e;
      if (d < cw) orow[d] = Elem<T>::store(acc[i][e] / denom);
    }
    if (lane == 0 && c0 == 0) lse[bh * Sq + qpos] = m[i] + logf(denom);
  }
}

// grid (BH, ceil(Sk / 16), ceil(D / 256)): the block owns 16 keys and
// streams query tiles of 32 rows, from the first tile a causal key can
// see
template <typename T, bool kSliced>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_wide_kernel(const T* __restrict__ q,
                           const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv,
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
  const T* qb = q + bh * Sq * D;
  const T* dob = dout + bh * Sq * D;
  const T* kbh = k + bh * Sk * D;
  const T* vbh = v + bh * Sk * D;
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
    // P and dS as the operands of dV += P^T dO and dK += dS^T Q
    float p[R], ds[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kpos = kw + i;
      // padded rows and columns are zeroed, not just masked
      const bool keep = qpos < Sq && kpos < Sk && (!causal || qpos >= kpos);
      const float pi = keep ? expf(s[i] * scale - lse_j) : 0.f;
      ds[i] = Elem<T>::operand(pi * (dp[i] - delta_j));
      p[i] = Elem<T>::operand(pi);
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
    T* dkr = dk + (bh * Sk + kpos) * D + c0;
    T* dvr = dv + (bh * Sk + kpos) * D + c0;
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) {
      const int d = lane + 32 * e;
      if (d < cw) {
        dkr[d] = Elem<T>::store(acc_k[i][e] * scale);
        dvr[d] = Elem<T>::store(acc_v[i][e]);
      }
    }
  }
}

// grid (BH, ceil(Sq / 16), ceil(D / 256)): the block owns 16 query rows
// and streams key tiles of 32 rows, up to its last row when causal
template <typename T, bool kSliced>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dq, int Sq, int Sk, int D,
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
  const T* qb = q + bh * Sq * D;
  const T* dob = dout + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
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
    // dS as the operand of dQ += dS K
    float ds[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool keep = t <= limit[i];
      const float p = keep ? expf(s[i] * scale - lses[rw + i]) : 0.f;
      ds[i] = Elem<T>::operand(p * (dp[i] - deltas[rw + i]));
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
    T* dqr = dq + (bh * Sq + qpos) * D + c0;
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) {
      const int d = lane + 32 * e;
      if (d < cw) dqr[d] = Elem<T>::store(acc[i][e] * scale);
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline size_t floats(size_t n) { return sizeof(float) * n; }

// W, a chunk's columns (head_dim up to 256), sizes the shared memory; the
// grid's z axis takes the 256-column output slices.
inline size_t chunk_cols(int D) {
  return static_cast<size_t>(D < kWideChunk ? D : kWideChunk);
}

inline dim3 wide_grid(int BH, int S, int D) {
  return dim3(BH, (S + kWideRows - 1) / kWideRows,
              (D + kWideChunk - 1) / kWideChunk);
}

template <typename T, bool kSliced>
cudaError_t launch_fwd_wide(const T* q, const T* k, const T* v, T* o,
                            float* lse, int BH, int Sq, int Sk, int D,
                            int causal, float scale, cudaStream_t stream) {
  const size_t W = chunk_cols(D);
  const size_t smem = floats(kWideRows * W + kWideTile * (2 * W + 1));
  auto kernel = flash_fwd_wide_kernel<T, kSliced>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<wide_grid(BH, Sq, D), kThreads, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

template <typename T, bool kSliced>
cudaError_t launch_dkdv_wide(const T* q, const T* k, const T* v,
                             const T* dout, const float* lse,
                             const float* delta, T* dk, T* dv, int BH, int Sq,
                             int Sk, int D, int causal, float scale,
                             cudaStream_t stream) {
  const size_t W = chunk_cols(D);
  const size_t smem = floats(2 * kWideRows * W + 2 * kWideTile * (W + 1) +
                             2 * kWideTile);
  auto kernel = flash_bwd_dkdv_wide_kernel<T, kSliced>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<wide_grid(BH, Sk, D), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

template <typename T, bool kSliced>
cudaError_t launch_dq_wide(const T* q, const T* k, const T* v, const T* dout,
                           const float* lse, const float* delta, T* dq,
                           int BH, int Sq, int Sk, int D, int causal,
                           float scale, cudaStream_t stream) {
  const size_t W = chunk_cols(D);
  const size_t smem = floats(2 * kWideRows * W + 2 * kWideTile * (W + 1) +
                             2 * kWideRows);
  auto kernel = flash_bwd_dq_wide_kernel<T, kSliced>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<wide_grid(BH, Sq, D), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

// Sequence lengths and head_dim the grids can take (y and z at most
// 65535 blocks); head_dim a multiple of `align` (16 bytes of T)
inline bool bad_shape(int BH, int Sq, int Sk, int D, int align) {
  return BH < 0 || Sq < 0 || Sk < 0 || D <= 0 || D % align ||
         Sq > 65535 * kWideRows || Sk > 65535 * kWideRows ||
         D > 65535 * kWideChunk;
}

}  // namespace flash_wide
