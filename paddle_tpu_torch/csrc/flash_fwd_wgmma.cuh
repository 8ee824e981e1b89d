// Flash attention forward, bfloat16, head_dim up to 64, for Hopper
// (sm_90a): the body of flash_fwd_bf16 on warpgroup matrix multiplies
// (wgmma) fed by the Tensor Memory Accelerator (TMA).
// flash_attention_bf16.cuh includes this file and routes head_dim <= 64
// here; 65-128 keeps its mma.sync kernel, 129-512 runs
// flash_wide_wgmma.cuh, above 512 flash_wide.cuh.
//
// Replaces, as the mma.sync kernel before it, the bfloat16 branch (lowp)
// of the Pallas TPU kernel
//   paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py
//     _fwd_kernel  (launched by _fwd_pallas)  -> fwd_kernel
// and computes the same function as the plain version
// (paddle_tpu_torch/kernels/flash_attention.py: _fwd_bf16): s = scale *
// q.k from bfloat16 operands with float32 sums; an online softmax whose
// running max m and sum l (float32) move once a block of 128 keys (the
// JAX kernel's block_k); p = exp(s - m_new) enters l unrounded and P V
// rounded to bfloat16; acc = acc alpha + P V in float32; O = acc /
// max(l, FLT_MIN) rounded once to bfloat16 (to nearest even), lse = m +
// log(max(l, FLT_MIN)) in float32.
//
// What bounds it on this card: operations. At Transformer-base's
// attention (BH = 128, S = 512, D = 64, full) the two products want
// 0.0087 ms at the bf16 tensor-core rate and the softmax arithmetic (~5
// float32 flops a pair) 0.0025 ms on the ALUs: 0.0112 ms together. The
// design:
//   - a block is one warpgroup (128 threads) and owns 64 query rows, the
//     M side of every wgmma; Q arrives once by TMA (one 64 x 64 box);
//   - K and V stream as 128-key tiles, the softmax block, two 64-row
//     boxes each, through a ring of kStages stages, each behind a full
//     mbarrier (TMA bytes landed) and an empty one (all 128 threads done
//     reading); thread 0 refills a stage as soon as it is empty, so the
//     next tiles' K and V load while this one computes;
//   - q, k and v are 3-D tensor maps [BH, S, D] with 128-byte swizzle:
//     rows past one head's S and columns past D arrive as zeros (head_dim
//     8..56 is zero-padded to 64 by the hardware, which is exact), never
//     the next head's rows;
//   - S = Q K^T for the whole block of 128 keys is one chain of SS wgmma
//     m64n128k16 (64 float32 accumulators a thread); masked scores (keys
//     past Sk, causal) become -inf in registers, so p = 0 exactly; the
//     row max is taken over all 128 keys before any exponent, and p =
//     2^(s scale log2(e) - m) is one FFMA and one ex2.approx.ftz;
//   - P, rounded to bfloat16 and packed in place from the score
//     accumulators, is the A operand of RS wgmma m64n64k16 over the
//     block's 128 keys (8 k-steps), V MN-major through the transpose bit;
//   - the tensor core does not round the sums it writes to nearest: the
//     block's P V collects in fresh accumulators (scale-d 0 on the first
//     k-step) and joins acc alpha by float32 adds, as in the mma.sync
//     kernel, whose outputs this one matches (flash_bf16_bwd_vs_old.py);
//   - causal blocks stop at the key tile of their last row, and causal
//     grids start with the last rows, which see the most keys;
//   - no atomics: each output element is written once by one thread, and
//     two launches on the same inputs give bitwise-equal outputs.
// What holds it below its bound (27% of it at Transformer-base's shape;
// PERF.md): a block's products and its softmax run one after the other,
// and only the other blocks on the SM (three fit: 166 registers and 74
// KB of shared memory each) fill the gaps. Issuing the next tile's
// scores behind this tile's P V took 190 registers (two blocks an SM),
// and ptxas serialized the wgmmas: it ran slower. A three-stage ring
// leaves two blocks an SM: slower at S = 512. Not done yet: a producer
// warp with setmaxnreg, two consumer warpgroups in ping-pong, a
// persistent grid.

#pragma once

#include <cfloat>
#include <cmath>

#include "flash_wgmma.cuh"

namespace flash_wgmma {
namespace {

constexpr int kKeys = 128;             // a key tile: the softmax block
constexpr int kKeySteps = kKeys / 16;  // k-steps of P V
constexpr int kFwdMinBlocks = 3;       // blocks an SM the registers allow
constexpr float kLn2 = 0.6931471805599453f;

// The forward's key tiles in flight (its ring's stages).
template <int NS>
struct FwdCfg {
  static constexpr int kStages = NS;
  // Q (one box), the ring (K and V, two boxes each a stage), the
  // barriers, and slack to align to 1024 bytes
  static constexpr int kSmem = 1024 + kBox + NS * 4 * kBox + 256;
};

struct FwdSmem {
  uint8_t* q;  // [64][64] bf16
  uint8_t* k;  // [kStages][128][64] bf16
  uint8_t* v;  // [kStages][128][64] bf16
  uint64_t* resident;
  uint64_t* full;
  uint64_t* empty;
};

template <class C>
__device__ __forceinline__ FwdSmem carve_fwd(uint8_t* raw) {
  uint8_t* base = align1024(raw);
  FwdSmem m;
  m.q = base;
  m.k = base + kBox;
  m.v = m.k + C::kStages * 2 * kBox;
  m.resident = reinterpret_cast<uint64_t*>(m.v + C::kStages * 2 * kBox);
  m.full = m.resident + 1;
  m.empty = m.full + C::kStages;
  return m;
}

// Thread 0: K and V of key tile `it` of head bh (keys 128 it .. 128 it +
// 127, two boxes each) into its stage.
template <class C>
__device__ __forceinline__ void load_keys(const FwdSmem& m,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv, int bh,
                                          int it) {
  const int s = it % C::kStages;
  const int t0 = it * kKeys;
  uint8_t* k = m.k + s * 2 * kBox;
  uint8_t* v = m.v + s * 2 * kBox;
  mbar_expect_tx(&m.full[s], 4 * kBox);
  tma_load(k, tk, &m.full[s], 0, t0, bh);
  tma_load(k + kBox, tk, &m.full[s], 0, t0 + kTile, bh);
  tma_load(v, tv, &m.full[s], 0, t0, bh);
  tma_load(v + kBox, tv, &m.full[s], 0, t0 + kTile, bh);
}

// grid (BH, ceil(Sq / 64)): the block owns 64 query rows and streams
// key/value tiles of 128 up to its last row when causal (every tile it
// streams then has a key each of its rows sees).
template <class C>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
fwd_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
           int Sk, int D, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const FwdSmem m = carve_fwd<C>(smem_raw);
  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;  // the warp's first row in the block
  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

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
    mbar_expect_tx(m.resident, kBox);
    tma_load(m.q, &tq, m.resident, 0, q0, bh);
    for (int it = 0; it < C::kStages && it < n_tiles; ++it)
      load_keys<C>(m, &tk, &tv, bh, it);
  }
  __syncwarp();

  // the thread's rows g and g + 8 of the warp: running max in units of
  // s * scale * log2(e), the thread's share of the running sum, and the
  // output accumulator (columns 8j + 2t, 8j + 2t + 1)
  const float c = scale * kLog2e;
  float mr[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (n_tiles > 0) mbar_wait(m.resident, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::kStages;
    const int t0 = it * kKeys;
    const uint8_t* kt = m.k + s * 2 * kBox;
    const uint8_t* vt = m.v + s * 2 * kBox;
    mbar_wait(&m.full[s], (it / C::kStages) & 1);

    // S = Q K^T: 64 rows x 128 keys
    float sc[64];
    wgmma_fence();
    scores128(sc, m.q, kt);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(sc);

    // masked scores become -inf (p = 0 exactly below); a block with no
    // key past Sk and no causal diagonal in the warp's rows skips this
    if (!(t0 + kKeys <= Sk && (!causal || t0 + kKeys - 1 <= q0 + rw))) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qpos = q0 + rw + g + 8 * h;
            const int kpos = t0 + 8 * j + 2 * t + e;
            if (!(kpos < Sk && (!causal || kpos <= qpos)))
              sc[4 * j + 2 * h + e] = -INFINITY;
          }
    }

    // online softmax over the block: the row max over the quad's 4
    // threads, then p = 2^(s c - m); l takes p unrounded, P V its
    // bfloat16 rounding
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mr[h], mx * c);
      alpha[h] = exp2f(mr[h] - m_new);
      mr[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float p = exp2_ftz(fmaf(sc[i], c, -mr[h]));
          sc[i] = p;
          l[h] += p;
        }
    uint32_t pa[kKeySteps][4];
    acc_as_a(sc, pa);
    // acc alpha, rounded, then + P V, rounded: never one fused
    // multiply-add (the plain version's two roundings)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = __fmul_rn(acc[i], alpha[(i >> 1) & 1]);

    // O += P V over the block's 128 keys, in a fresh accumulator joined
    // by float32 adds
    float tile[32];
    wgmma_fence();
    products(tile, pa, vt);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(tile);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], tile[i]);

    // release the stage; thread 0 refills it with tile it + kStages once
    // every thread has released it
    mbar_arrive(&m.empty[s]);
    if (threadIdx.x == 0 && it + C::kStages < n_tiles) {
      mbar_wait(&m.empty[s], (it / C::kStages) & 1);
      load_keys<C>(m, &tk, &tv, bh, it + C::kStages);
    }
    __syncwarp();
  }

  // the row sums over the quad's threads, then one store an element
  // pair; lse = (m + log2 l) ln 2 in natural-log units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qpos = q0 + rw + g + 8 * h;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(sum, FLT_MIN);
    // acc / denom, one division an element as the plain version's
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[4 * j + 2 * h + e] /= denom;
    const int64_t row = static_cast<int64_t>(bh) * Sq + qpos;
    store_half(o + row * D, acc, h, t, D, 1.f);
    if (t == 0) lse[row] = (mr[h] + log2f(denom)) * kLn2;
  }
}

template <class C>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       __nv_bfloat16* o, float* lse, int BH, int Sq, int Sk,
                       int D, int causal, float scale, cudaStream_t stream) {
  // with no key the kernel loads no K or V, but a map wants a nonempty
  // tensor: q's stands in
  const bool keys = Sk > 0;
  CUtensorMap maps[3];
  cudaError_t e = encode_rows(&maps[0], q, BH, Sq, D);
  if (e == cudaSuccess)
    e = encode_rows(&maps[1], keys ? k : q, BH, keys ? Sk : Sq, D);
  if (e == cudaSuccess)
    e = encode_rows(&maps[2], keys ? v : q, BH, keys ? Sk : Sq, D);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fwd_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  fwd_kernel<C><<<grid, kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], o, lse, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

// the ring the library launches
using FwdRing = FwdCfg<2>;

}  // namespace
}  // namespace flash_wgmma
