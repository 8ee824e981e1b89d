// Flash attention, bfloat16, head_dim 129 to 512, for Hopper (sm_90a):
// the bodies of flash_fwd_bf16 (K2), flash_bwd_dkdv_bf16 (K3a) and
// flash_bwd_dq_bf16 (K3b) on warpgroup matrix multiplies (wgmma) fed by
// the Tensor Memory Accelerator (TMA). flash_attention_bf16.cuh includes
// this file and routes 128 < head_dim <= 512 here; above 512 all three
// keep the CUDA-core kernels of flash_wide.cuh (256-column slices). What
// they share with the kernels up to 64 is in flash_wgmma.cuh (tensor
// maps, 64 x 64 boxes with 128-byte swizzle, mbarriers, the wgmma forms,
// the bfloat16 packing of accumulators).
//
// Replaces, as the CUDA-core kernels before them, the bfloat16 branch
// (lowp) of the Pallas TPU kernels
//   paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py
//     _fwd_kernel       (launched by _fwd_pallas)  -> wgmma_wide_fwd_kernel
//     _bwd_dkdv_kernel  (launched by _flash_bwd)   -> wgmma_wide_dkdv_kernel
//     _bwd_dq_kernel    (launched by _flash_bwd)   -> wgmma_wide_dq_kernel
// and computes the same function as the plain versions
// (paddle_tpu_torch/kernels/flash_attention.py: _fwd_bf16, _bwd_bf16):
// products of bfloat16 operands summed in float32; the forward's running
// max and sum move once a block of 128 keys, P is rounded to bfloat16
// before P V while l adds the unrounded p; dV = bf16(P)^T dO, dS = p (dP
// - delta) in float32, dK = scale bf16(dS)^T Q, dQ = scale bf16(dS) K;
// every output rounded once to bfloat16 (to nearest even), LSE float32.
//
// What bounds them on this card: operations. At [BH = 32, S = 512, D =
// 256] the forward's products want 0.0087 ms at the bf16 tensor-core
// rate, dK/dV's 0.0174 ms and dQ's 0.0130 ms; the exp and softmax or ds
// arithmetic (~5 float32 flops a pair) adds 0.0010 ms on the ALUs. Every
// block also reads the other side's rows from L2 (the keys for 128 query
// rows, the queries for 64 keys, the keys for 64 query rows): ~64 MB
// (forward), ~128 MB (dK/dV) and ~192 MB (dQ) a launch at that shape.
// The design:
//   - head_dim is cut into 64-column units (one TMA box wide); columns
//     past D and rows past S arrive as zeros from the tensor maps, which
//     is exact. A score is one wgmma chain over the head_dim's units in
//     the order 0, 1, ..., one commit group a unit;
//   - output column slices: above 256 columns the grid's z axis cuts the
//     output (O; dK and dV) into nz = ceil(D / 256) slices of at most 4
//     units, balanced (D = 264: 3 + 2 units). Every slice recomputes the
//     scores over the whole head_dim in the same order, so its softmax
//     (forward) or P and dS (K3a) are bit for bit those of the other
//     slices (at D = 264 .. 512 the scores' half of the products is done
//     twice); the forward's slice 0 writes the LSE;
//   - registers: a 64-row warpgroup holding a 64 x 256 float32 output
//     takes 128 registers a thread, the forward's 128-key score block 64
//     more, so a second full-width set of fresh accumulators does not
//     fit. The products accumulate in place, in the output's registers,
//     one commit group a 64-column unit with every group in flight at
//     once. Fresh accumulators a unit joined by float32 adds (the
//     kernels up to 64's way, which the tensor core's truncating sums
//     motivated there) ran slower on the card and spilled the forward
//     at 255 registers, for the same worst error against the plain
//     version and nearly the same share of differing elements (PERF.md);
//     acc alpha is still rounded apart from the sums;
//   - the ring: streamed loads go through one ring of stages of two
//     boxes (16 KB) behind a full mbarrier each. A stage is refilled by
//     the warp that releases it last (a count in shared memory, one
//     atomic a warp): the moment both warpgroups are done with it, and
//     with no warp waiting on another to refill. Refills issued by
//     thread 0 alone ran slower; a producer warp beside the 8 consumer
//     warps capped every thread at 168 registers (three warps on one SM
//     sub-partition; setmaxnreg did not lift ptxas's cap) and spilled.
//     An mbarrier wait that never completes traps (the launch fails and
//     the wrapper raises) instead of holding the card;
//   - the forward (wgmma_wide_fwd_kernel): two warpgroups a block, 64
//     query rows each, Q resident (one box a unit), one stream of K and
//     V for both (half the L2 reads of a warpgroup a block, which ran
//     slower). A key tile is its nq K units
//     of 128 keys x 64 columns (S = Q K^T by SS wgmma m64n128k16, each
//     unit's stage released once its commit group is done), then the
//     slice's V units (P V by RS wgmma m64n64k16 over the tile's 128
//     keys, P packed to bfloat16 in place from the score accumulators,
//     V MN-major). Masks, the row max over all 128 keys and p = 2^(s
//     scale log2(e) - m) run as in flash_fwd_wgmma.cuh. 250 registers,
//     no spill; up to 8 stages beside Q in <= 227 KB, one block an SM;
//   - dK/dV (wgmma_wide_dkdv_kernel): 64 keys a block, one output a
//     warpgroup, after flash_bwd_wide_mma.cuh. Warpgroup 0 forms S^T =
//     K Q^T and P^T and accumulates dV; warpgroup 1 forms dP^T = V dO^T,
//     takes P^T (float32, the same register layout) through shared
//     memory behind two named barriers (full, empty), forms dS^T and
//     accumulates dK. K and V of the block's keys stay resident (nq
//     boxes each; 2 x 32 KB at D = 256). Q and dO stream by TMA in
//     stages of one unit of a 64-query tile (a Q box and a dO box): the
//     tile's nq score units, then the slice's units for the products
//     (dV += bf16(P^T) dO, dK += bf16(dS^T) Q, RS wgmma m64n64k16).
//     Where the slice's units are the tile's last score units (one
//     slice, or the last slice) their stages are held through the
//     products instead of loaded twice. lse and delta are read by each
//     thread for its 16 query columns at the tile's start. 226
//     registers, no spill; 64-128 KB resident, 16 KB for P^T and 5-8
//     stages in <= 227 KB, one block an SM;
//   - dQ (wgmma_wide_dq_kernel): 64 query rows a block, the two
//     warpgroups on the same rows, after flash_bwd_wide_mma.cuh's K3b.
//     Warpgroup 0 forms S = Q K^T and P, warpgroup 1 dP = dO V^T; P goes
//     to warpgroup 1 through shared memory behind a named barrier, dS = P
//     (dP - delta) comes back behind another, so both hold the same
//     floats. S and dP take each unit's product in a fresh accumulator
//     joined by a float32 add, which rounds to nearest: chained in place
//     over the units, the tensor core's truncating sums put more dS on
//     the other side of a bfloat16 rounding boundary (on chip_smoke.py's
//     cases up to 1.15% of dQ differing from the plain version, against
//     0.84%) and ran 4-5% slower (PERF.md). Q and dO stay resident (nq
//     boxes each; 2 x 64 KB at D = 512). K and V stream by TMA in stages
//     of one unit of a 64-key tile (a K box and a V box): the tile's nq
//     score units, then its K units again for the products, two a stage
//     (units 2p and 2p + 1; the last repeated where nq is odd).
//     Warpgroup w accumulates dQ's units w, w + 2, ... (dQ += bf16(dS) K,
//     RS wgmma m64n64k16, K MN-major, in place): at most 4 units, 128
//     registers a thread (214 in all, no spill), so no column slices and
//     no score recompute. Holding the score stages instead of
//     loading K twice would want nq stages beside Q and dO: 8 at D = 512,
//     where 5 fit. The product stages of a tile are held together through
//     the products, so the ring must have at least ceil(nq / 2) stages
//     (the launcher checks it). lse and delta are read once, for the
//     thread's own rows;
//   - causal blocks skip the tiles no row of theirs sees (the forward
//     and dQ stop at the key tile of their last row, K3a starts at the
//     query tile of its first key), and causal forward and dQ grids start
//     with the last rows, which see the most keys;
//   - no atomics on outputs: each output element is written once by one
//     thread, and two launches give bitwise-equal outputs.
// Not done yet: a persistent grid, overlap of a warpgroup's softmax or
// ds with its own products (the warpgroups only overlap each other),
// TMA multicast of K and V across a cluster.
//
// The kernels allocate nothing; the caller passes the outputs. The TMA
// descriptors are encoded on the host for each call; a descriptor that
// fails to encode, a launch that is refused or a kernel fault returns an
// error, and nothing falls back.

#pragma once

#include <cfloat>
#include <cmath>

#include "flash_bwd_wgmma.cuh"
#include "flash_fwd_wgmma.cuh"
#include "flash_wgmma.cuh"

namespace flash_wgmma {
namespace {

constexpr int kWideMaxD = 512;         // head_dims these kernels take
constexpr int kSliceUnits = 4;         // 64-column units of a slice
constexpr int kMaxStages = 8;          // ring stages at most
constexpr int kBlockSmem = 232448;     // shared memory a block may use
constexpr int kWideThreads = 2 * kThreads;  // two warpgroups a block
// named barriers of K3a's P^T hand-off (0 is __syncthreads)
constexpr int kPFull = 1, kPEmpty = 2;

// The column plan of a launch: head_dim in nq 64-column units, the
// output cut into nz slices of `per` units (the last may have fewer).
struct Plan {
  int nq, nz, per;
};

__host__ __device__ inline Plan plan_of(int D) {
  Plan p;
  p.nq = (D + kDP - 1) / kDP;
  p.nz = (D + kSliceUnits * kDP - 1) / (kSliceUnits * kDP);
  p.per = (p.nq + p.nz - 1) / p.nz;
  return p;
}

// a wait that outlasts any real one (~2^26 polls) traps
constexpr uint32_t kMaxPolls = 1u << 26;

__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  int parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (++polls == kMaxPolls) __trap();
  } while (!done);
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// d (+)= A B over one 64-column unit of head_dim (4 k-steps): A the
// warpgroup's 64 rows, B one box (64 rows) or two stacked (128 rows),
// both K-major; kAcc false starts the chain
template <bool kAcc>
__device__ __forceinline__ void unit_scores(float (&d)[32], const uint8_t* a,
                                            const uint8_t* b) {
  wgmma_ss<kAcc>(d, desc_kmajor(a, 0), desc_kmajor(b, 0));
#pragma unroll
  for (int kk = 1; kk < kSteps; ++kk)
    wgmma_ss<true>(d, desc_kmajor(a, kk), desc_kmajor(b, kk));
}

template <bool kAcc>
__device__ __forceinline__ void unit_scores128(float (&d)[64],
                                               const uint8_t* a,
                                               const uint8_t* b) {
  wgmma_ss128<kAcc>(d, desc_kmajor(a, 0), desc_kmajor(b, 0));
#pragma unroll
  for (int kk = 1; kk < kSteps; ++kk)
    wgmma_ss128<true>(d, desc_kmajor(a, kk), desc_kmajor(b, kk));
}

// d += A B over KS k-steps of 16 rows of B, in place: A the bfloat16
// fragments from an accumulator (acc_as_a), B an MN-major [16 KS][64]
// tile
template <int KS>
__device__ __forceinline__ void products_into(float (&d)[32],
                                              const uint32_t (&a)[KS][4],
                                              const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs_mn<true>(d, a[kk], desc_mnmajor(b, kk));
}

// The ring of a block's streamed loads: load L (of `total`, in order)
// lands in stage L % ns, two boxes, behind full[stage] (the TMA bytes).
// A stage is refilled by the warp that releases it last: each warp,
// once its wgmma reading the stage is done, adds one to the stage's
// count in shared memory, and the warp that brings it to `warps` resets
// it and issues load L + ns. So a stage is refilled the moment every
// warp is done with it, and no warp ever waits for another to refill.
// Thread 0 issues the first ns loads. Src::issue(dst, bar, L) starts
// load L.
template <class Src>
struct Ring {
  uint8_t* ring;
  uint64_t* full;
  int* count;
  int ns, total, warps;
  Src src;

  __device__ __forceinline__ uint8_t* stage(int L) const {
    return ring + (L % ns) * 2 * kBox;
  }

  __device__ __forceinline__ void issue(int L) const {
    const int s = L % ns;
    mbar_expect_tx(&full[s], 2 * kBox);
    src.issue(ring + s * 2 * kBox, &full[s], L);
  }

  __device__ __forceinline__ void wait_full(int L) const {
    mbar_wait_or_trap(&full[L % ns], (L / ns) & 1);
  }

  __device__ __forceinline__ void release(int L) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      const int s = L % ns;
      __threadfence_block();
      if (atomicAdd(&count[s], 1) == warps - 1) {
        count[s] = 0;
        __threadfence_block();
        if (L + ns < total) issue(L + ns);
      }
    }
    __syncwarp();
  }
};

// a ring whose barriers and counts start at `at`, set up by thread 0
// (before the block's __syncthreads)
template <class Src>
__device__ __forceinline__ Ring<Src> make_ring(uint8_t* ring, uint8_t* at,
                                               int ns, int total, int warps,
                                               const Src& src) {
  Ring<Src> r;
  r.ring = ring;
  r.full = reinterpret_cast<uint64_t*>(at);
  r.count = reinterpret_cast<int*>(r.full + ns);
  r.ns = ns;
  r.total = total;
  r.warps = warps;
  r.src = src;
  if (threadIdx.x == 0)
    for (int s = 0; s < ns; ++s) {
      mbar_init(&r.full[s], 1);
      r.count[s] = 0;
    }
  return r;
}

// ------------------------------------------------------------- forward
// shared memory: Q (nq boxes a warpgroup), ns stages of 128 keys x 64
// columns (two boxes), the barriers and counts, and slack to align to
// 1024 bytes
__host__ __device__ constexpr int wide_fwd_smem(int nq, int ns) {
  return 1024 + 2 * nq * kBox + ns * 2 * kBox + (1 + ns) * 8 + ns * 4;
}

// load L: key tile L / nl, then its K unit j (j < nq) or the slice's V
// unit j - nq, 128 keys (two boxes)
struct FwdSrc {
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  int bh, nq, nl, v0;

  __device__ __forceinline__ void issue(uint8_t* dst, uint64_t* bar,
                                        int L) const {
    const int j = L % nl;
    const int t0 = (L / nl) * kKeys;
    const CUtensorMap* map = j < nq ? tk : tv;
    const int col = kDP * (j < nq ? j : v0 + j - nq);
    tma_load(dst, map, bar, col, t0, bh);
    tma_load(dst + kBox, map, bar, col, t0 + kTile, bh);
  }
};

// grid (BH, ceil(Sq / 128), nz): warpgroup w owns the block's query rows
// 64 w .. 64 w + 63 and both take the output columns of slice
// blockIdx.z, from one stream of key tiles of 128 up to the block's last
// row when causal.
__global__ void __launch_bounds__(kWideThreads, 1)
wgmma_wide_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int D,
                      int causal, float scale, int ns) {
  extern __shared__ uint8_t smem_raw[];
  const Plan plan = plan_of(D);
  const int nq = plan.nq;
  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int v0 = blockIdx.z * plan.per;
  const int nv = min(plan.per, nq - v0);
  const int wg = threadIdx.x / kThreads;
  const int q0 = (2 * qb + wg) * kRows;  // the warpgroup's rows
  const int warp = threadIdx.x % kThreads / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;  // the warp's first row in the warpgroup
  const int n_keys = causal ? min(Sk, (2 * qb + 2) * kRows) : Sk;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  uint8_t* base = align1024(smem_raw);
  uint8_t* qs = base;  // [2][nq] boxes
  uint8_t* ring = base + 2 * nq * kBox;
  uint64_t* resident = reinterpret_cast<uint64_t*>(ring + ns * 2 * kBox);
  const FwdSrc src = {&tk, &tv, bh, nq, nq + nv, v0};
  const Ring<FwdSrc> r =
      make_ring(ring, reinterpret_cast<uint8_t*>(resident + 1), ns,
                n_tiles * (nq + nv), 8, src);
  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(resident, 2 * nq * kBox);
    for (int w = 0; w < 2; ++w)
      for (int j = 0; j < nq; ++j)
        tma_load(qs + (w * nq + j) * kBox, &tq, resident, kDP * j,
                 (2 * qb + w) * kRows, bh);
    for (int L = 0; L < ns && L < r.total; ++L) r.issue(L);
  }
  __syncwarp();
  const uint8_t* q_own = qs + wg * nq * kBox;

  // the thread's rows g and g + 8 of the warp: running max in units of
  // s * scale * log2(e), the thread's share of the running sum, and the
  // output accumulator, one 64-column unit of the slice a row
  const float c = scale * kLog2e;
  float mr[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[kSliceUnits][32];
#pragma unroll
  for (int u = 0; u < kSliceUnits; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  if (n_tiles > 0) mbar_wait_or_trap(resident, 0);

  int L = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kKeys;

    // S = Q K^T, 64 rows x 128 keys: one chain over the head_dim's
    // units, one commit group a unit; a unit's stage is released once
    // its group is done (while the next unit's group runs)
    float sc[64];
    for (int j = 0; j < nq; ++j, ++L) {
      r.wait_full(L);
      wgmma_fence();
      if (j == 0)
        unit_scores128<false>(sc, q_own, r.stage(L));
      else
        unit_scores128<true>(sc, q_own + j * kBox, r.stage(L));
      wgmma_commit();
      if (j > 0) {
        wgmma_wait<1>();
        r.release(L - 1);
      }
    }
    wgmma_wait_all();
    r.release(L - 1);
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
    for (int u = 0; u < kSliceUnits; ++u)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[u][i] = __fmul_rn(acc[u][i], alpha[(i >> 1) & 1]);

    // O += P V over the block's 128 keys, one 64-column unit of the
    // slice a commit group, in place: every group in flight at once
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kSliceUnits; ++u) {
      if (u < nv) {
        r.wait_full(L + u);
        products_into(acc[u], pa, r.stage(L + u));
        wgmma_commit();
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < kSliceUnits; ++u) fence_acc(acc[u]);
    for (int u = 0; u < nv; ++u) r.release(L + u);
    L += nv;
  }

  // the row sums over the quad's threads, then one store an element
  // pair; lse = (m + log2 l) ln 2 in natural-log units, from slice 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qpos = q0 + rw + g + 8 * h;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(sum, FLT_MIN);
    const int64_t row = static_cast<int64_t>(bh) * Sq + qpos;
#pragma unroll
    for (int u = 0; u < kSliceUnits; ++u) {
      if (u < nv) {
        // acc / denom, one division an element as the plain version's
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[u][4 * j + 2 * h + e] /= denom;
        const int col = kDP * (v0 + u);
        store_half(o + row * D + col, acc[u], h, t, D - col, 1.f);
      }
    }
    if (t == 0 && blockIdx.z == 0)
      lse[row] = (mr[h] + log2f(denom)) * kLn2;
  }
}

// --------------------------------------------------------------- dK dV
// shared memory: K and V resident (nq boxes each), ns stages of one unit
// of a query tile (a Q box and a dO box), P^T (64 x 64 float32), the
// barriers and counts, and slack to align to 1024 bytes
constexpr int kPBytes = kRows * kTile * 4;

__host__ __device__ constexpr int wide_dkdv_smem(int nq, int ns) {
  return 1024 + 2 * nq * kBox + ns * 2 * kBox + kPBytes + (1 + ns) * 8 +
         ns * 4;
}

// The block's schedule of streamed loads: query tile L / nl, then its
// score unit j (j < nq) or the slice's product unit j - nq. Where the
// slice's units are the tile's last score units (`held`) there are no
// product loads: those stages stay until the products are done.
struct DkdvSrc {
  const CUtensorMap* tq;
  const CUtensorMap* tdo;
  int bh, first, nq, nv, v0, nl;
  bool held;

  // the load index (within a tile) of product unit u
  __device__ __forceinline__ int product(int u) const {
    return held ? nq - nv + u : nq + u;
  }
  // whether score unit j's stage is kept for the products
  __device__ __forceinline__ bool kept(int j) const {
    return held && j >= nq - nv;
  }
  // load L: unit j of query tile L / nl, its Q box and its dO box
  __device__ __forceinline__ void issue(uint8_t* dst, uint64_t* bar,
                                        int L) const {
    const int j = L % nl;
    const int row = first + (L / nl) * kTile;
    const int col = kDP * (j < nq ? j : v0 + j - nq);
    tma_load(dst, tq, bar, col, row, bh);
    tma_load(dst + kBox, tdo, bar, col, row, bh);
  }
};

// grid (BH, ceil(Sk / 64), nz): the block owns 64 keys and the dK and dV
// columns of slice blockIdx.z, and streams query tiles of 64 from the
// first tile a causal key can see. Warpgroup 0: S^T, P^T, dV; warpgroup
// 1: dP^T, dS^T, dK.
__global__ void __launch_bounds__(kWideThreads, 1)
wgmma_wide_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                       int D, int causal, float scale, int ns) {
  extern __shared__ uint8_t smem_raw[];
  const Plan plan = plan_of(D);
  const int nq = plan.nq;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int v0 = blockIdx.z * plan.per;
  const int nv = min(plan.per, nq - v0);
  // query tiles wholly before the block's first key see none of it
  const int first = causal ? k0 : 0;
  const int n_tiles = first < Sq ? (Sq - first + kTile - 1) / kTile : 0;
  const bool held = v0 + nv == nq;
  const int nl = nq + (held ? 0 : nv);
  const DkdvSrc src = {&tq, &tdo, bh, first, nq, nv, v0, nl, held};

  uint8_t* base = align1024(smem_raw);
  uint8_t* res_k = base;
  uint8_t* res_v = base + nq * kBox;
  uint8_t* ring = res_v + nq * kBox;
  float* pbuf = reinterpret_cast<float*>(ring + ns * 2 * kBox);
  uint64_t* resident = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(pbuf) + kPBytes);
  const Ring<DkdvSrc> r =
      make_ring(ring, reinterpret_cast<uint8_t*>(resident + 1), ns,
                n_tiles * nl, 8, src);
  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(resident, 2 * nq * kBox);
    for (int j = 0; j < nq; ++j) {
      tma_load(res_k + j * kBox, &tk, resident, kDP * j, k0, bh);
      tma_load(res_v + j * kBox, &tv, resident, kDP * j, k0, bh);
    }
    for (int L = 0; L < ns && L < r.total; ++L) r.issue(L);
  }
  __syncwarp();

  const int wg = threadIdx.x / kThreads;
  const int tw = threadIdx.x % kThreads;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int g = lane / 4, t = lane % 4;
  // the score chain's own operand (K for S^T, V for dP^T) and the box of
  // a stage that is its B (Q, dO); the box that is B of the output
  // product (dO for dV, Q for dK)
  const uint8_t* own = wg == 0 ? res_k : res_v;
  const int score_box = wg == 0 ? 0 : 1;
  const int out_box = wg == 0 ? 1 : 0;
  const float* vec = wg == 0 ? lse : delta;
  const float c = scale * kLog2e;
  float acc[kSliceUnits][32];
#pragma unroll
  for (int u = 0; u < kSliceUnits; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  if (n_tiles > 0) mbar_wait_or_trap(resident, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = first + it * kTile;
    const int L0 = it * nl;

    // the tile's lse (S group, in log2 units) or delta (dP group) at the
    // thread's 16 query columns 8j + 2t + e; 0 past Sq
    float rv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qpos = t0 + 8 * j + 2 * t + e;
        const float x =
            qpos < Sq ? vec[static_cast<int64_t>(bh) * Sq + qpos] : 0.f;
        rv[2 * j + e] = wg == 0 ? x * kLog2e : x;
      }

    // S^T = K Q^T or dP^T = V dO^T, 64 keys x 64 queries: one chain
    // over the head_dim's units, one commit group a unit, each unit's
    // stage released once its group is done (unless kept for the
    // products)
    float sc[32];
    for (int j = 0; j < nq; ++j) {
      r.wait_full(L0 + j);
      const uint8_t* b = r.stage(L0 + j) + score_box * kBox;
      wgmma_fence();
      if (j == 0)
        unit_scores<false>(sc, own, b);
      else
        unit_scores<true>(sc, own + j * kBox, b);
      wgmma_commit();
      if (j > 0) {
        wgmma_wait<1>();
        if (!src.kept(j - 1)) r.release(L0 + j - 1);
      }
    }
    wgmma_wait_all();
    if (!src.kept(nq - 1)) r.release(L0 + nq - 1);
    fence_acc(sc);

    // P^T in place (rows keys, columns queries), zero where masked or
    // padded; warpgroup 1 takes it through pbuf (element i of thread tw
    // at i * 128 + tw) and forms dS^T = P^T (dP^T - delta) in place. A
    // tile with no padded row or column that every key of the block sees
    // skips the mask.
    if (wg == 0) {
      const bool masked = !(t0 + kTile <= Sq && k0 + kRows <= Sk &&
                            (!causal || t0 >= k0 + kRows - 1));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = exp2_ftz(sc[i] * c - rv[2 * j + e]);
            if (masked) {
              const int kpos = k0 + 16 * warp + g + 8 * h;
              const int qpos = t0 + 8 * j + 2 * t + e;
              if (!(qpos < Sq && kpos < Sk && (!causal || qpos >= kpos)))
                p = 0.f;
            }
            sc[i] = p;
          }
      if (it > 0) named_sync(kPEmpty, kWideThreads);
#pragma unroll
      for (int i = 0; i < 32; ++i) pbuf[i * kThreads + tw] = sc[i];
      named_arrive(kPFull, kWideThreads);
    } else {
      named_sync(kPFull, kWideThreads);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            sc[i] = pbuf[i * kThreads + tw] * (sc[i] - rv[2 * j + e]);
          }
      if (it + 1 < n_tiles) named_arrive(kPEmpty, kWideThreads);
    }
    uint32_t pa[kTileSteps][4];
    acc_as_a(sc, pa);

    // dV += bf16(P^T) dO or dK += bf16(dS^T) Q over the tile's 64
    // queries, one 64-column unit of the slice a commit group, in place:
    // every group in flight at once
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kSliceUnits; ++u) {
      if (u < nv) {
        const int L = L0 + src.product(u);
        if (!held) r.wait_full(L);
        products_into(acc[u], pa, r.stage(L) + out_box * kBox);
        wgmma_commit();
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < kSliceUnits; ++u) fence_acc(acc[u]);
    for (int u = 0; u < nv; ++u) r.release(L0 + src.product(u));
  }

  // each output element pair is written once, by one thread: dV from
  // warpgroup 0, dK (times scale) from warpgroup 1
  __nv_bfloat16* out = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + 16 * warp + g + 8 * h;
    if (kpos >= Sk) continue;
    const int64_t row = (static_cast<int64_t>(bh) * Sk + kpos) * D;
#pragma unroll
    for (int u = 0; u < kSliceUnits; ++u) {
      if (u < nv) {
        const int col = kDP * (v0 + u);
        store_half(out + row + col, acc[u], h, t, D - col, mul);
      }
    }
  }
}

// ------------------------------------------------------------------ dQ
// named barriers of K3b's hand-off: P written (kPFull), dS written
constexpr int kDsFull = 2;

// The block's schedule of streamed loads: key tile L / nl, then its
// score unit j (j < nq: the K box and the V box of unit j) or its
// product pair p = j - nq (K units 2p and 2p + 1; the second is unit 2p
// again where 2p + 1 = nq, and no warp reads it)
struct DqSrc {
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  int bh, nq, nl;

  __device__ __forceinline__ void issue(uint8_t* dst, uint64_t* bar,
                                        int L) const {
    const int j = L % nl;
    const int t0 = (L / nl) * kTile;
    if (j < nq) {
      tma_load(dst, tk, bar, kDP * j, t0, bh);
      tma_load(dst + kBox, tv, bar, kDP * j, t0, bh);
    } else {
      const int u = 2 * (j - nq);
      tma_load(dst, tk, bar, kDP * u, t0, bh);
      tma_load(dst + kBox, tk, bar, kDP * min(u + 1, nq - 1), t0, bh);
    }
  }
};

// grid (BH, ceil(Sq / 64)): the block owns 64 query rows and all of dQ's
// columns, and streams key tiles of 64 up to its last row when causal
// (then the last rows first). Warpgroup 0: S, P; warpgroup 1: dP, dS;
// warpgroup w accumulates dQ's 64-column units w, w + 2, ...
__global__ void __launch_bounds__(kWideThreads, 1)
wgmma_wide_dq_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int D,
                     int causal, float scale, int ns) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kHalf = kWideMaxD / kDP / 2;  // dQ units a warpgroup, at most
  const int nq = plan_of(D).nq;
  const int np = (nq + 1) / 2;  // product pairs a tile
  const int nl = nq + np;
  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kRows;
  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  const DqSrc src = {&tk, &tv, bh, nq, nl};

  uint8_t* base = align1024(smem_raw);
  uint8_t* res_q = base;
  uint8_t* res_do = base + nq * kBox;
  uint8_t* ring = res_do + nq * kBox;
  float* xbuf = reinterpret_cast<float*>(ring + ns * 2 * kBox);
  uint64_t* resident = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(xbuf) + kPBytes);
  const Ring<DqSrc> r =
      make_ring(ring, reinterpret_cast<uint8_t*>(resident + 1), ns,
                n_tiles * nl, 8, src);
  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(resident, 2 * nq * kBox);
    for (int j = 0; j < nq; ++j) {
      tma_load(res_q + j * kBox, &tq, resident, kDP * j, q0, bh);
      tma_load(res_do + j * kBox, &tdo, resident, kDP * j, q0, bh);
    }
    for (int L = 0; L < ns && L < r.total; ++L) r.issue(L);
  }
  __syncwarp();

  const int wg = threadIdx.x / kThreads;
  const int tw = threadIdx.x % kThreads;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;  // the warp's first row in the block
  // the score chain's own operand (Q for S, dO for dP); its B is box wg
  // of a score stage (K, V), and of a product stage (K units 2p + wg)
  const uint8_t* own = wg == 0 ? res_q : res_do;
  // the thread's rows g and g + 8 of the warp: lse in log2 units, delta
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + rw + g + 8 * h;
    const int64_t at = static_cast<int64_t>(bh) * Sq + qpos;
    lse_r[h] = qpos < Sq ? lse[at] * kLog2e : 0.f;
    delta_r[h] = qpos < Sq ? delta[at] : 0.f;
  }
  const float c = scale * kLog2e;
  float acc[kHalf][32];
#pragma unroll
  for (int u = 0; u < kHalf; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  if (n_tiles > 0) mbar_wait_or_trap(resident, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kTile;
    const int L0 = it * nl;

    // S = Q K^T or dP = dO V^T, 64 rows x 64 keys, over the head_dim's
    // units: each unit's product in a fresh accumulator joined by a
    // float32 add, its stage released once the product is done
    float sc[32];
    for (int j = 0; j < nq; ++j) {
      r.wait_full(L0 + j);
      const uint8_t* b = r.stage(L0 + j) + wg * kBox;
      float f[32];
      wgmma_fence();
      unit_scores<false>(f, own + j * kBox, b);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(f);
      r.release(L0 + j);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = j == 0 ? f[i] : sc[i] + f[i];
    }

    // P in place, zero where masked or padded, to warpgroup 1 through
    // xbuf (element i of thread tw at i * 128 + tw), which forms dS = P
    // (dP - delta) there and hands it back. A tile with no padded row or
    // column and no causal diagonal in the warp's rows skips the mask.
    if (wg == 0) {
      const bool masked = !(q0 + kRows <= Sq && t0 + kTile <= Sk &&
                            (!causal || t0 + kTile - 1 <= q0 + rw));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = exp2_ftz(sc[i] * c - lse_r[h]);
            if (masked) {
              const int qpos = q0 + rw + g + 8 * h;
              const int kpos = t0 + 8 * j + 2 * t + e;
              if (!(qpos < Sq && kpos < Sk && (!causal || kpos <= qpos)))
                p = 0.f;
            }
            xbuf[i * kThreads + tw] = p;
          }
      named_arrive(kPFull, kWideThreads);
      named_sync(kDsFull, kWideThreads);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = xbuf[i * kThreads + tw];
    } else {
      named_sync(kPFull, kWideThreads);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = xbuf[i * kThreads + tw] * (sc[i] - delta_r[(i >> 1) & 1]);
        xbuf[i * kThreads + tw] = sc[i];
      }
      named_arrive(kDsFull, kWideThreads);
    }
    uint32_t da[kTileSteps][4];
    acc_as_a(sc, da);

    // dQ += bf16(dS) K over the tile's 64 keys, the warpgroup's units in
    // place, one commit group a unit, every group in flight at once;
    // every warp waits for each product stage, read or not
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kHalf; ++p) {
      if (p < np) {
        r.wait_full(L0 + nq + p);
        if (2 * p + wg < nq) {
          products_into(acc[p], da, r.stage(L0 + nq + p) + wg * kBox);
          wgmma_commit();
        }
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < kHalf; ++p) fence_acc(acc[p]);
    for (int p = 0; p < np; ++p) r.release(L0 + nq + p);
  }

  // each output element pair is written once, by one thread: dQ times
  // scale, rounded once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + rw + g + 8 * h;
    if (qpos >= Sq) continue;
    const int64_t row = (static_cast<int64_t>(bh) * Sq + qpos) * D;
#pragma unroll
    for (int p = 0; p < kHalf; ++p) {
      const int u = 2 * p + wg;
      if (p < np && u < nq)
        store_half(dq + row + kDP * u, acc[p], h, t, D - kDP * u, scale);
    }
  }
}

// ------------------------------------------------------------------ host
// the most stages that fit in a block's shared memory beside the fixed
// part, at most kMaxStages
template <class F>
int stages_within(F smem) {
  int ns = 0;
  while (ns < kMaxStages && smem(ns + 1) <= kBlockSmem) ++ns;
  return ns;
}

cudaError_t launch_wide_fwd(const void* q, const void* k, const void* v,
                            __nv_bfloat16* o, float* lse, int BH, int Sq,
                            int Sk, int D, int causal, float scale,
                            cudaStream_t stream) {
  const Plan plan = plan_of(D);
  auto smem_of = [&](int ns) { return wide_fwd_smem(plan.nq, ns); };
  const int ns = stages_within(smem_of);
  if (ns < 2) return cudaErrorInvalidValue;
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
    e = cudaFuncSetAttribute(wgmma_wide_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_of(ns));
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + 2 * kRows - 1) / (2 * kRows), plan.nz);
  wgmma_wide_fwd_kernel<<<grid, kWideThreads, smem_of(ns), stream>>>(
      maps[0], maps[1], maps[2], o, lse, Sq, Sk, D, causal, scale, ns);
  return cudaGetLastError();
}

cudaError_t launch_wide_dkdv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, __nv_bfloat16* dk,
                             __nv_bfloat16* dv, int BH, int Sq, int Sk,
                             int D, int causal, float scale,
                             cudaStream_t stream) {
  const Plan plan = plan_of(D);
  auto smem_of = [&](int ns) { return wide_dkdv_smem(plan.nq, ns); };
  // the slice's held stages must all fit in the ring at once
  const int ns = stages_within(smem_of);
  if (ns < plan.per) return cudaErrorInvalidValue;
  // with no query row the kernel loads nothing, but a map wants a
  // nonempty tensor: k's stands in
  const bool rows = Sq > 0;
  CUtensorMap maps[4];
  cudaError_t e = encode_rows(&maps[0], rows ? q : k, BH, rows ? Sq : Sk, D);
  if (e == cudaSuccess) e = encode_rows(&maps[1], k, BH, Sk, D);
  if (e == cudaSuccess) e = encode_rows(&maps[2], v, BH, Sk, D);
  if (e == cudaSuccess)
    e = encode_rows(&maps[3], rows ? dout : k, BH, rows ? Sq : Sk, D);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wgmma_wide_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_of(ns));
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sk + kRows - 1) / kRows, plan.nz);
  wgmma_wide_dkdv_kernel<<<grid, kWideThreads, smem_of(ns), stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dk, dv, Sq, Sk, D,
      causal, scale, ns);
  return cudaGetLastError();
}


cudaError_t launch_wide_dq(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, __nv_bfloat16* dq, int BH,
                           int Sq, int Sk, int D, int causal, float scale,
                           cudaStream_t stream) {
  // dK/dV's layout, with Q and dO resident in the place of K and V
  const int nq = plan_of(D).nq;
  auto smem_of = [&](int ns) { return wide_dkdv_smem(nq, ns); };
  // a tile's product stages are held together: they must all fit in the
  // ring at once
  const int ns = stages_within(smem_of);
  if (ns < 2 || ns < (nq + 1) / 2) return cudaErrorInvalidValue;
  // with no key the kernel loads no K or V, but a map wants a nonempty
  // tensor: q's stands in
  const bool keys = Sk > 0;
  CUtensorMap maps[4];
  cudaError_t e = encode_rows(&maps[0], q, BH, Sq, D);
  if (e == cudaSuccess)
    e = encode_rows(&maps[1], keys ? k : q, BH, keys ? Sk : Sq, D);
  if (e == cudaSuccess)
    e = encode_rows(&maps[2], keys ? v : q, BH, keys ? Sk : Sq, D);
  if (e == cudaSuccess) e = encode_rows(&maps[3], dout, BH, Sq, D);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wgmma_wide_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_of(ns));
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  wgmma_wide_dq_kernel<<<grid, kWideThreads, smem_of(ns), stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dq, Sq, Sk, D, causal,
      scale, ns);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_wgmma
