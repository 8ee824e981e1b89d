// Flash attention backward, bfloat16, head_dim up to 64, for Hopper
// (sm_90a): the bodies of flash_bwd_dkdv_bf16 (dK, dV) and
// flash_bwd_dq_bf16 (dQ) on warpgroup matrix multiplies (wgmma) fed by
// the Tensor Memory Accelerator (TMA). flash_attention_bf16.cuh includes
// this file and routes head_dim <= 64 here; 65-128 keeps its mma.sync
// kernels, above 128 flash_wide.cuh. What they share with the forward
// (flash_fwd_wgmma.cuh) is in flash_wgmma.cuh.
//
// Replaces, as the mma.sync kernels before them, the bfloat16 branch
// (lowp) of the Pallas TPU kernels
//   paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py
//     _bwd_dkdv_kernel  (launched by _flash_bwd)  -> dkdv_kernel
//     _bwd_dq_kernel    (launched by _flash_bwd)  -> dq_kernel
// and computes the same function as the plain version
// (paddle_tpu_torch/kernels/flash_attention.py: _bwd_bf16): p = exp(s -
// lse), 0 where masked or padded; dV = bf16(P)^T dO; dS = p (dP - delta)
// in float32; dK = scale * bf16(dS)^T Q, dQ = scale * bf16(dS) K; each
// gradient rounded once to bfloat16, to nearest even.
//
// What bounds them on this card: operations. At Transformer-base's
// attention (BH = 128, S = 512, D = 64, full) the products want 0.013
// ms (dK/dV) and 0.010 ms (dQ) at the bf16 tensor-core rate and the exp
// and ds arithmetic (~5 float32 flops a pair) 0.005 ms on the ALUs.
// mma.sync (m16n8k16) does not reach the tensor cores' full rate on this
// card; wgmma does. The design:
//   - a block is one warpgroup (128 threads) and owns 64 rows: keys in
//     dK/dV, queries in dQ, the M side of every wgmma m64n64k16; at
//     167 (dK/dV) and 124 (dQ) registers a thread three or four blocks
//     share an SM, and one block's exp runs while another's products do
//     (blocks of two warpgroups, 128 rows, ran slower on the card);
//   - the block's own rows (K and V; Q and dO) arrive once by TMA; the
//     other side (Q and dO with their lse and delta; K and V) streams in
//     tiles of 64 rows through a ring of kStages stages, each behind a
//     full mbarrier (TMA bytes landed) and an empty one (all 128 threads
//     done reading); thread 0 refills a stage as soon as it is empty;
//   - q, k, v and dO are 3-D tensor maps [BH, S, D] with 64 x 64 boxes
//     and 128-byte swizzle: rows past one head's S and columns past D
//     arrive as zeros (head_dim 8..56 is zero-padded to 64 by the
//     hardware, which is exact), never the next head's rows; lse and
//     delta are 1-D maps over [BH * Sq] whose 68-float box starts at the
//     16-byte boundary before the tile's first row;
//   - scores S^T = K Q^T and dP^T = V dO^T (dK/dV), S = Q K^T and
//     dP = dO V^T (dQ): A and B from shared memory, both K-major;
//   - dV += bf16(P^T) dO, dK += bf16(dS^T) Q, dQ += bf16(dS) K: A from
//     registers, since a wgmma accumulator's layout (the warp's 16 rows,
//     columns 8j + 2t, +1) is the A-fragment layout of the next product,
//     so P and dS are rounded and packed in place; B MN-major (wgmma's
//     transpose bit);
//   - the tensor core does not round the sums it writes to nearest: each
//     tile's products (64 rows deep) collect in fresh accumulators
//     (scale-d 0 on the tile's first k-step) and join the running sums by
//     float32 adds, as in the mma.sync kernels, whose outputs these match
//     on the card. Accumulating in place across tiles ran a little
//     faster, but put one dV element 1 bf16 ulp of the max off the plain
//     version at Transformer-base's shape (the mma.sync kernels: 0.5);
//   - exp, masks and the ds arithmetic run in float32 on the ALUs in the
//     exp2 domain, one MUFU.EX2 an element (exp2_ftz), lse and delta
//     read from shared memory by LDS: between a tile's score and product
//     wgmmas these instructions, not the tensor cores, set its pace
//     (exp2f's range fix-up, three more instructions an element, and
//     generic loads cost dK/dV ~10% on the card); causal dQ blocks start
//     with the last query rows, which see the most keys;
//   - no atomics: each output element is written once by one thread, and
//     two launches on the same inputs give bitwise-equal outputs.
// Not done yet: a producer warp with setmaxnreg, a persistent grid,
// overlap of a block's own exp and products (issuing the next tile's
// scores behind this tile's products ran slower: registers), wgmma at
// the 128 bucket (dK and dV alone take 128 of a thread's registers
// there).
//
// The kernels allocate nothing; the caller passes the outputs. The TMA
// descriptors are encoded on the host for each call
// (cuTensorMapEncodeTiled, found through the runtime's driver entry
// points) and passed as __grid_constant__ parameters; a descriptor that
// fails to encode returns an error, and nothing falls back.

#pragma once

#include "flash_wgmma.cuh"

namespace flash_wgmma {
namespace {

constexpr int kTileSteps = kTile / 16;  // k-steps over a tile's rows
// a tile's lse or delta: a box of kTile + 4 floats from the 16-byte
// boundary at or before its first row (a box starts 16-byte aligned),
// kVecStride floats apart in shared memory (128-byte aligned)
constexpr int kVecBox = kTile + 4;
constexpr int kVecStride = 96;

// blocks an SM the registers must leave room for
constexpr int kMinBlocks = 3;

// A kernel's streamed tiles in flight (its ring's stages).
template <int NS>
struct Cfg {
  static constexpr int kStages = NS;
  // the resident rows (two boxes), the ring (two boxes and two row
  // vectors a stage), the barriers, and slack to align to 1024 bytes (the
  // 128-byte swizzle pattern repeats every 8 rows of 128 bytes)
  static constexpr int kSmem =
      1024 + 2 * kBox + NS * (2 * kBox + 8 * kVecStride) + 256;
};

// The shared memory of a block: the resident rows of two tensors, the
// ring of streamed tiles of two tensors and (dK/dV) two row vectors, the
// barriers.
struct Smem {
  uint8_t* res[2];   // [64][64] bf16 each
  uint8_t* ring[2];  // [kStages][64][64] bf16 each
  float* vec[2];     // [kStages][kVecStride] float32 each (lse, delta)
  uint64_t* resident;
  uint64_t* full;
  uint64_t* empty;
};

template <class C>
__device__ __forceinline__ Smem carve(uint8_t* raw) {
  uint8_t* base = align1024(raw);
  Smem m;
  m.res[0] = base;
  m.res[1] = base + kBox;
  m.ring[0] = base + 2 * kBox;
  m.ring[1] = m.ring[0] + C::kStages * kBox;
  m.vec[0] = reinterpret_cast<float*>(m.ring[1] + C::kStages * kBox);
  m.vec[1] = m.vec[0] + C::kStages * kVecStride;
  m.resident =
      reinterpret_cast<uint64_t*>(m.vec[1] + C::kStages * kVecStride);
  m.full = m.resident + 1;
  m.empty = m.full + C::kStages;
  return m;
}

// The streamed side of a block: two tensors of rows, and (dK/dV) the
// lse and delta of those rows as 1-D maps over [BH * Sq].
struct Stream {
  const CUtensorMap* rows[2];
  const CUtensorMap* vecs[2];  // null: none
};

// Thread 0: the tile whose rows start at `row` (of head bh) into stage s,
// with its vector elements bh * S + row ...
template <class C>
__device__ __forceinline__ void load_stage(const Smem& m, const Stream& st,
                                           int bh, int S, int row, int s) {
  mbar_expect_tx(&m.full[s], 2 * kBox + (st.vecs[0] ? 8 * kVecBox : 0));
  tma_load(m.ring[0] + s * kBox, st.rows[0], &m.full[s], 0, row, bh);
  tma_load(m.ring[1] + s * kBox, st.rows[1], &m.full[s], 0, row, bh);
  if (st.vecs[0]) {
    const int at = (bh * S + row) & ~3;
    tma_load_1d(m.vec[0] + s * kVecStride, st.vecs[0], &m.full[s], at);
    tma_load_1d(m.vec[1] + s * kVecStride, st.vecs[1], &m.full[s], at);
  }
}

// Thread 0: barriers, the block's resident rows (two tensors, rows r0 ..
// r0 + 63 of head bh) and the first kStages streamed tiles.
template <class C>
__device__ __forceinline__ void start_loads(const Smem& m,
                                            const CUtensorMap* res0,
                                            const CUtensorMap* res1,
                                            const Stream& st, int bh, int S,
                                            int r0, int first, int n_tiles) {
  if (threadIdx.x == 0) {
    mbar_init(m.resident, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&m.full[s], 1);
      mbar_init(&m.empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(m.resident, 2 * kBox);
    tma_load(m.res[0], res0, m.resident, 0, r0, bh);
    tma_load(m.res[1], res1, m.resident, 0, r0, bh);
    for (int s = 0; s < C::kStages && s < n_tiles; ++s)
      load_stage<C>(m, st, bh, S, first + s * kTile, s);
  }
  __syncwarp();
}

// Every thread: release the stage of tile `it`; thread 0 then refills it
// with tile it + kStages once every thread has released it.
template <class C>
__device__ __forceinline__ void release(const Smem& m, const Stream& st,
                                        int bh, int S, int first, int it,
                                        int n_tiles) {
  const int s = it % C::kStages;
  mbar_arrive(&m.empty[s]);
  if (threadIdx.x == 0 && it + C::kStages < n_tiles) {
    mbar_wait(&m.empty[s], (it / C::kStages) & 1);
    load_stage<C>(m, st, bh, S, first + (it + C::kStages) * kTile, s);
  }
  __syncwarp();
}

template <class C>
__device__ __forceinline__ void wait_full(const Smem& m, int it) {
  mbar_wait(&m.full[it % C::kStages], (it / C::kStages) & 1);
}

// ---------------------------------------------------------------- dK dV
// grid (BH, ceil(Sk / 64)): the block owns 64 keys and streams query
// tiles of 64, with their lse and delta, from the first tile a causal key
// can see (every tile it streams then sees some of its keys). Blocks of
// low keys (most query tiles when causal) come first in the grid.
template <class C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tlse,
            const __grid_constant__ CUtensorMap tdelta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int Sq, int Sk, int D, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem m = carve<C>(smem_raw);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // query tiles wholly before the block's first key see none of it
  const int first = causal ? k0 : 0;
  const int n_tiles = first < Sq ? (Sq - first + kTile - 1) / kTile : 0;
  const Stream src = {{&tq, &tdo}, {&tlse, &tdelta}};
  start_loads<C>(m, &tk, &tv, src, bh, Sq, k0, first, n_tiles);

  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  const float c = scale * kLog2e;
  if (n_tiles > 0) mbar_wait(m.resident, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::kStages;
    const int t0 = first + it * kTile;
    const uint8_t* qt = m.ring[0] + s * kBox;
    const uint8_t* dot = m.ring[1] + s * kBox;
    wait_full<C>(m, it);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
    float st[32], dpt[32];
    wgmma_fence();
    scores(st, m.res[0], qt);
    scores(dpt, m.res[1], dot);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(st);
    fence_acc(dpt);

    // P^T and dS^T in place (rows keys, columns queries); padded rows
    // and columns are zeroed, not just masked. A tile with no padded row
    // or column that every key of the block sees skips the mask. The
    // tile's lse and delta from its first row on (columns past Sq hold
    // whatever follows: their p is zeroed).
    const int shift = (bh * Sq + t0) & 3;
    const float* lt = m.vec[0] + s * kVecStride + shift;
    const float* dt = m.vec[1] + s * kVecStride + shift;
    const bool masked = !(t0 + kTile <= Sq && k0 + kRows <= Sk &&
                          (!causal || t0 >= k0 + kRows - 1));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int col = 8 * j + 2 * t + e;
          float p = exp2_ftz(st[i] * c - lt[col] * kLog2e);
          if (masked) {
            const int kpos = k0 + 16 * warp + g + 8 * h;
            const int qpos = t0 + col;
            if (!(qpos < Sq && kpos < Sk && (!causal || qpos >= kpos)))
              p = 0.f;
          }
          st[i] = p;
          dpt[i] = p * (dpt[i] - dt[col]);
        }
    uint32_t pa[kTileSteps][4], da[kTileSteps][4];
    acc_as_a(st, pa);
    acc_as_a(dpt, da);

    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q over the tile's 64
    // queries, in fresh accumulators joined by float32 adds
    float tile_v[32], tile_k[32];
    wgmma_fence();
    products(tile_v, pa, dot);
    products(tile_k, da, qt);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(tile_v);
    fence_acc(tile_k);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc_v[i] += tile_v[i];
      acc_k[i] += tile_k[i];
    }
    release<C>(m, src, bh, Sq, first, it, n_tiles);
  }

  // each output element pair is written once, by one thread
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + 16 * warp + g + 8 * h;
    if (kpos >= Sk) continue;
    const int64_t row = (static_cast<int64_t>(bh) * Sk + kpos) * D;
    store_half(dk + row, acc_k, h, t, D, scale);
    store_half(dv + row, acc_v, h, t, D, 1.f);
  }
}

// ---------------------------------------------------------------- dQ
// grid (BH, ceil(Sq / 64)): the block owns 64 query rows and streams
// key/value tiles of 64 up to its last row when causal (every tile it
// streams then has a key some row sees). Causal grids start with the
// last rows, which see the most keys.
template <class C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int D,
          int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem m = carve<C>(smem_raw);
  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  const Stream src = {{&tk, &tv}, {nullptr, nullptr}};
  start_loads<C>(m, &tq, &tdo, src, bh, Sk, q0, 0, n_tiles);

  // the thread's rows 16 warp + g (+ 8): lse in log2 units, delta
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + 16 * warp + g + 8 * h;
    const int64_t at = static_cast<int64_t>(bh) * Sq + qpos;
    lse_r[h] = qpos < Sq ? lse[at] * kLog2e : 0.f;
    delta_r[h] = qpos < Sq ? delta[at] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const float c = scale * kLog2e;
  if (n_tiles > 0) mbar_wait(m.resident, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::kStages;
    const int t0 = it * kTile;
    const uint8_t* kt = m.ring[0] + s * kBox;
    wait_full<C>(m, it);

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys
    float sc[32], dp[32];
    wgmma_fence();
    scores(sc, m.res[0], kt);
    scores(dp, m.res[1], m.ring[1] + s * kBox);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(sc);
    fence_acc(dp);

    // dS in place of dP (rows queries, columns keys); a tile with no
    // padded row or column that every row of the block sees skips the
    // mask
    const bool masked = !(q0 + kRows <= Sq && t0 + kTile <= Sk &&
                          (!causal || t0 + kTile - 1 <= q0));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float p = exp2_ftz(sc[i] * c - lse_r[h]);
          if (masked) {
            const int qpos = q0 + 16 * warp + g + 8 * h;
            const int kpos = t0 + 8 * j + 2 * t + e;
            if (!(qpos < Sq && kpos < Sk && (!causal || kpos <= qpos)))
              p = 0.f;
          }
          dp[i] = p * (dp[i] - delta_r[h]);
        }
    uint32_t da[kTileSteps][4];
    acc_as_a(dp, da);

    // dQ += bf16(dS) K over the tile's 64 keys, in a fresh accumulator
    // joined by float32 adds
    float tile[32];
    wgmma_fence();
    products(tile, da, kt);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(tile);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += tile[i];
    release<C>(m, src, bh, Sk, 0, it, n_tiles);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + 16 * warp + g + 8 * h;
    if (qpos >= Sq) continue;
    store_half(dq + (static_cast<int64_t>(bh) * Sq + qpos) * D, acc, h, t,
               D, scale);
  }
}

// ------------------------------------------------------------------ host
// [n] float32 as a 1-D map of kVecBox-element boxes; elements past n
// load as zeros
cudaError_t encode_vec(CUtensorMap* map, const float* p, int64_t n) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t unused[1] = {0};  // a rank-1 map has no stride
  const cuuint32_t box[1] = {kVecBox};
  const cuuint32_t unit[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                        const_cast<float*>(p), dims, unused, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the four maps of q [BH, Sq, D], k and v [BH, Sk, D], dO [BH, Sq, D]
cudaError_t encode_all(CUtensorMap (&maps)[4], const void* q, const void* k,
                       const void* v, const void* dout, int BH, int Sq,
                       int Sk, int D) {
  const void* ptrs[4] = {q, k, v, dout};
  const int rows[4] = {Sq, Sk, Sk, Sq};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = encode_rows(&maps[i], ptrs[i], BH, rows[i], D);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <class C>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, __nv_bfloat16* dk,
                        __nv_bfloat16* dv, int BH, int Sq, int Sk, int D,
                        int causal, float scale, cudaStream_t stream) {
  CUtensorMap maps[4], vecs[2];
  cudaError_t e = encode_all(maps, q, k, v, dout, BH, Sq, Sk, D);
  if (e == cudaSuccess)
    e = encode_vec(&vecs[0], lse, static_cast<int64_t>(BH) * Sq);
  if (e == cudaSuccess)
    e = encode_vec(&vecs[1], delta, static_cast<int64_t>(BH) * Sq);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sk + kRows - 1) / kRows);
  dkdv_kernel<C><<<grid, kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], vecs[0], vecs[1], dk, dv, Sq, Sk,
      D, causal, scale);
  return cudaGetLastError();
}

template <class C>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      __nv_bfloat16* dq, int BH, int Sq, int Sk, int D,
                      int causal, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t e = encode_all(maps, q, k, v, dout, BH, Sq, Sk, D);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  dq_kernel<C><<<grid, kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dq, Sq, Sk, D, causal,
      scale);
  return cudaGetLastError();
}

// the rings the library launches, chosen on the card (PERF.md)
using DkdvCfg = Cfg<3>;
using DqCfg = Cfg<2>;

}  // namespace
}  // namespace flash_wgmma
