// K5's bfloat16 form (conv_bn_relu_bf16) on warpgroup matrix multiplies
// (wgmma) for Hopper (sm_90a): the bodies "gather" and "1x1" of the plan
// (paddle_tpu_torch/kernels/conv_bn_relu.py:_plan), every stride-1
// convolution whose K = C * KH * KW is a multiple of 8. conv_bn_relu.cu
// includes this file and keeps its mma.sync body for the rest (the stem,
// K = 147, and the strided 1x1s).
//
// Same function as the mma.sync body: y[n, f, oh, ow] = bf16(act(sum_k
// P[m, k] w[f, k] * scale[f] + shift[f])), k = (c, i, j), the product of
// bfloat16 operands accumulated in float32, the affine as a float32
// multiply then a float32 add (two roundings), relu or the identity, one
// rounding to bfloat16 (to nearest even); x and y NCHW.
//
// A block (288 threads) computes one 64 (m) x kBN (f) output tile over
// one split of K; grid (m tiles, f tiles, splits):
//   - K runs in stages of 64 (four k-steps of 16) through a ring of
//     kStages stages, each behind a full mbarrier (256 threads' patch
//     stores and the weight box's bytes) and an empty one (256 arrivals
//     once the stage's products have completed);
//   - the last warp loads the weight tiles by TMA: w [F, K] as a 2-D map,
//     one 64 (k) x kBN (f) box a stage with 128-byte swizzle (K-major for
//     wgmma), as soon as a slot is empty, up to kStages stages ahead;
//   - the other 256 threads (two warpgroups) gather the patch tile [64
//     k][64 m], MN-major (m contiguous, wgmma's transpose bit for A) with
//     128-byte swizzle: a thread keeps one run of 8 consecutive tile rows
//     for the whole block and writes 8 values of one k as one 16-byte
//     st.shared at the swizzled address (chunk (m / 8) ^ (k % 8) of row
//     k), fenced to the async proxy before its arrival. A stage's loads
//     are issued a stage ahead of its stores, so that they are in flight
//     while the stage before is stored and multiplied;
//       "gather" (any KH x KW and padding): a tile is R = 64 / Wb whole
//       output rows of Wb columns, Wb the least power of two >= OW (8 at
//       least; 64 columns of a row a tile when OW > 64), whose columns
//       past OW are computed and dropped. A run is 8 consecutive columns
//       of one output row, so the values of a k lie in one input row: k
//       decomposes into (c, i, j) by a float reciprocal (exact for K <
//       2^22), one bounds test for the row, a range of valid columns,
//       2-byte loads at immediate offsets, zero outside the image;
//       "1x1" (1x1, no padding): 64 consecutive m a tile; row k is x[n,
//       k, r .. r + 7]: the two aligned 16-byte chunks around it,
//       funnel-shifted, where every run of the warp lies in one image,
//       else 2-byte loads;
//   - both warpgroups then multiply, asynchronously: warpgroup g takes
//     channels g * kBN / 2 .. of the tile, wgmma m64n{kBN / 2}k16,
//     float32 accumulators in registers, accumulated in place over the
//     split's k-steps in k order; a stage's products run while the
//     threads gather the next one;
//   - splits (the plan's S) cut K's stages into S contiguous parts, one
//     a block. With S = 1 the epilogue stages the bfloat16 tile through
//     shared memory as [f][m], so that y is written in 16-byte runs of m
//     for each f where the run is whole, inside one image (one output row
//     for "gather") and aligned (2-byte stores otherwise). With S > 1
//     each block writes its float32 partial to ws[split][f][m]
//     (wrapper-allocated; m padded to a multiple of 4) and
//     split_combine_kernel adds the partials in split order (partial 0 +
//     partial 1 + ...), applies the epilogue and writes y. No atomics:
//     the result does not depend on which block finishes first, and since
//     the plan is a function of the shape alone (never of N or M), every
//     output sums its K products in one order whatever the batch.
//
// The kernels allocate nothing; the weight map is encoded on the host for
// each call, and a failed encode returns an error (nothing falls back).

#pragma once

#include "flash_wgmma.cuh"

namespace conv_wgmma {
namespace {

using flash_wgmma::align1024;
using flash_wgmma::desc_kmajor;
using flash_wgmma::desc_mnmajor;
using flash_wgmma::fence_acc;
using flash_wgmma::fence_proxy_async;
using flash_wgmma::mbar_arrive;
using flash_wgmma::mbar_expect_tx;
using flash_wgmma::mbar_init;
using flash_wgmma::smem_u32;

constexpr int kStageK = 64;    // k of one stage: four k-steps of 16
constexpr int kCompute = 256;  // two warpgroups: products (and gather)
constexpr int kThreads = kCompute + 32;  // and the TMA warp
constexpr int kBM = 64;        // output rows of a tile (wgmma M)
constexpr int kChunks = kBM / 8;  // runs of 8 rows in a tile
constexpr int kUnits = kStageK * kChunks / kCompute;  // a thread's a stage
constexpr int kKStride = kCompute / kChunks;  // k between a thread's units
constexpr int kLDS = kBM + 8;  // halves of a staged output row
constexpr int kRows = 1, kFlat = 2;  // the plan's bodies (0 is mma.sync)

struct Shape {
  int N, C, H, W, F, KH, KW, stride, pad, OH, OW, relu;
  int M, K, T, splits, Mpad;  // T: K's stages of 64
  // "gather" tiles: R output rows of Wb = 2^lwb columns (OW <= 64), or
  // 64 columns of one output row, owtiles tiles a row (OW > 64)
  int lwb, R, owtiles;
};

template <int kBN_, int kBody_>
struct Cfg {
  static constexpr int kBN = kBN_;  // output channels a block
  static constexpr int kBody = kBody_;
  static constexpr int kHalf = kBN / 2;  // channels a warpgroup
  static constexpr int kABytes = kBM * kStageK * 2;  // the patch tile
  static constexpr int kBBytes = kBN * kStageK * 2;  // the weight box
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kFit = 100 * 1024 / kStageBytes;  // two blocks an SM
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kSmem = 1024 + kStages * kStageBytes +
                               2 * kStages * 8 + 2 * kBN * 4;
  static_assert(kStages >= 2, "a ring of at least two stages");
  static_assert(kBN * kLDS * 2 <= kStages * kStageBytes,
                "the staged output tile fits in the ring");
};

// mbar_wait that traps after 2^28 polls (seconds): a pipeline fault ends
// the launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done, polls = 0;
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
    if (++polls == (1u << 28)) __trap();
  } while (!done);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t pack_halves(uint32_t lo, uint32_t hi) {
  return lo | (hi << 16);
}

// 8 consecutive bfloat16 at x + i (every byte of the 16 inside the
// tensor): the aligned 16-byte chunk that holds the first, and the next
// one unless the run starts on a chunk (each chunk then holds a byte of
// the run, so neither leaves the allocation); no branch
__device__ __forceinline__ void load_run(const uint16_t* __restrict__ x,
                                         int i, uint32_t (&v)[8],
                                         uint32_t& off) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x + i);
  const uint4* q = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
  off = static_cast<uint32_t>(a & 15);
  const uint4 lo = __ldg(q);
  const uint4 hi = __ldg(q + (off != 0));
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// the run's 16 bytes from load_run's two chunks
__device__ __forceinline__ uint4 shift_run(const uint32_t (&w)[8],
                                           uint32_t off) {
  const int qd = off >> 2;            // the run's first word
  const uint32_t sh = (off & 2) * 8;  // and its bit offset in it
  uint32_t o[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    o[i] = qd == 0 ? w[i] : qd == 1 ? w[i + 1] : qd == 2 ? w[i + 2]
                                                        : w[i + 3];
  return make_uint4(__funnelshift_r(o[0], o[1], sh),
                    __funnelshift_r(o[1], o[2], sh),
                    __funnelshift_r(o[2], o[3], sh),
                    __funnelshift_r(o[3], o[4], sh));
}

// The flat output row m = n*OH*OW + oh*OW + ow of row r of tile `tile`,
// or -1 where the tile row holds no output (past M, or a "gather" tile's
// columns past OW).
template <class C>
__device__ __forceinline__ int tile_row_m(const Shape& sh, int tile, int r) {
  if constexpr (C::kBody == kFlat) {
    const int m = tile * kBM + r;
    return m < sh.M ? m : -1;
  } else {
    int q, ow;
    if (sh.owtiles == 1) {
      q = tile * sh.R + (r >> sh.lwb);
      ow = r & ((1 << sh.lwb) - 1);
    } else {
      q = tile / sh.owtiles;
      ow = (tile - q * sh.owtiles) * kBM + r;
    }
    return q < sh.N * sh.OH && ow < sh.OW ? q * sh.OW + ow : -1;
  }
}

// The raw values of a thread's units of one stage, loaded and not yet
// packed: 8 halves (zero-extended), or for a 16-byte run ("1x1") the two
// aligned chunks around it and its byte offset in the first (16: zeros).
// Two of these are live a thread: a stage's loads stay in flight while
// the stage before is stored.
struct Raw {
  uint32_t v[kUnits][8];
  uint32_t off[kUnits];
};

// The patch gather of one thread: its run of 8 tile rows (chunk h of the
// tile) at kUnits k of each stage. "gather" (row tiles, stride 1): the 8
// rows are 8 consecutive ow of one output row, so a unit's values lie in
// one input row: one bounds test for the row, a range of valid columns,
// 2-byte loads at immediate offsets. "1x1": x[n, k, r .. r + 7], 16
// bytes at a time where every run of the warp lies in one image.
template <class C>
struct Gather {
  const uint16_t* __restrict__ x;
  int h, kb, HW, KHW;
  float r_khw, r_kw;
  // "gather": x offset of (n, 0, 0, 0), ih of kernel row 0, iw of the
  // run's first column at kernel column 0, the run's valid columns
  int xb, ih0, a0, vcount;
  // "1x1": x offset of (n, 0, r) for each row (-1 past M), and whether
  // the warp loads 16 bytes at a time
  int off[8];
  bool vec;

  __device__ __forceinline__ void init(const uint16_t* __restrict__ xp,
                                       const Shape& sh, int tile, int t) {
    x = xp;
    h = t % kChunks;
    kb = t / kChunks;
    HW = sh.H * sh.W;
    KHW = sh.KH * sh.KW;
    r_khw = 1.f / KHW;
    r_kw = 1.f / sh.KW;
    const int CHW = sh.C * HW;
    if constexpr (C::kBody == kFlat) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int m = tile_row_m<C>(sh, tile, 8 * h + e);
        off[e] = -1;
        if (m >= 0) {
          const int n = m / HW;
          off[e] = n * CHW + (m - n * HW);
        }
      }
      vec = __all_sync(0xffffffffu, off[0] >= 0 && off[7] == off[0] + 7);
    } else {
      const int m = tile_row_m<C>(sh, tile, 8 * h);
      vcount = 0;
      xb = ih0 = a0 = 0;
      if (m >= 0) {
        const int q = m / sh.OW;  // n * OH + oh
        const int ow = m - q * sh.OW;
        const int n = q / sh.OH;
        vcount = min(8, sh.OW - ow);
        xb = n * CHW;
        ih0 = q - n * sh.OH - sh.pad;
        a0 = ow - sh.pad;
      }
    }
  }

  __device__ __forceinline__ void issue(const Shape& sh, int k0, Raw& r) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int k = k0 + kb + u * kKStride;
      const bool live = k < sh.K;
      if constexpr (C::kBody == kFlat) {
        const int koff = k * HW;
        if (vec) {
          // past K: a run at x itself, marked as zeros
          load_run(x, live ? off[0] + koff : 0, r.v[u], r.off[u]);
          if (!live) r.off[u] = 16;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            r.v[u][e] = live && off[e] >= 0 ? __ldg(x + (off[e] + koff)) : 0u;
        }
      } else {
        // k = (c, i, j) by a float reciprocal: exact for K < 2^22
        const int c = static_cast<int>((k + 0.5f) * r_khw);
        const int rem = k - c * KHW;
        const int i = static_cast<int>((rem + 0.5f) * r_kw);
        const int j = rem - i * sh.KW;
        const int ih = ih0 + i;
        const int a = a0 + j;  // iw of the run's first value
        // the run's values e with 0 <= a + e < W, below vcount
        const int lo = max(0, -a), hi = min(vcount, sh.W - a);
        const bool row = live && static_cast<unsigned>(ih) <
                                     static_cast<unsigned>(sh.H);
        const unsigned span = row && hi > lo ? hi - lo : 0u;
        const uint16_t* p = x + (xb + c * HW + ih * sh.W + a);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          r.v[u][e] =
              static_cast<unsigned>(e - lo) < span ? __ldg(p + e) : 0u;
      }
    }
  }

  __device__ __forceinline__ void put(const Raw& r, uint8_t* a) const {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int row = kb + u * kKStride;  // k - k0
      uint4 v;
      if (C::kBody == kFlat && vec)
        v = r.off[u] < 16 ? shift_run(r.v[u], r.off[u])
                          : make_uint4(0, 0, 0, 0);
      else
        v = make_uint4(pack_halves(r.v[u][0], r.v[u][1]),
                       pack_halves(r.v[u][2], r.v[u][3]),
                       pack_halves(r.v[u][4], r.v[u][5]),
                       pack_halves(r.v[u][6], r.v[u][7]));
      *reinterpret_cast<uint4*>(a + row * 128 + ((h ^ (row & 7)) << 4)) = v;
    }
  }
};

// d += A B over one stage (four k-steps): A the patch tile (MN-major),
// B this warpgroup's kHalf rows of the weight box (K-major)
template <class C>
__device__ __forceinline__ void products(float (&acc)[C::kHalf / 2],
                                         const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < kStageK / 16; ++kk) {
    if constexpr (C::kHalf == 64)
      flash_wgmma::wgmma_ta64(acc, desc_mnmajor(a, kk), desc_kmajor(b, kk));
    else
      flash_wgmma::wgmma_ta32(acc, desc_mnmajor(a, kk), desc_kmajor(b, kk));
  }
}

// grid (m tiles, ceil(F / kBN), splits); see the head of the file
template <class C>
__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const __grid_constant__ CUtensorMap tw,
            const uint16_t* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ shift, __nv_bfloat16* __restrict__ y,
            float* __restrict__ ws, const Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  float* sc_s = reinterpret_cast<float*>(empty + C::kStages);
  float* sf_s = sc_s + C::kBN;
  const int tile = blockIdx.x;
  const int f0 = blockIdx.y * C::kBN;
  const int split = blockIdx.z;
  const int s_beg = split * sh.T / sh.splits;
  const int n_it = (split + 1) * sh.T / sh.splits - s_beg;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], kCompute + 1);  // + the TMA warp's expect_tx
      mbar_init(&empty[s], kCompute);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (t < C::kBN && sh.splits == 1) {
    const bool in = f0 + t < sh.F;
    sc_s[t] = in ? __ldg(scale + f0 + t) : 0.f;
    sf_s[t] = in ? __ldg(shift + f0 + t) : 0.f;
  }
  Gather<C> g;
  if (t < kCompute) g.init(x, sh, tile, t);
  __syncthreads();

  if (t >= kCompute) {
    // the TMA warp: every stage's weight box as soon as its slot is
    // free, up to kStages stages ahead of the products
    if (t == kCompute) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % C::kStages;
        if (it >= C::kStages)
          mbar_wait(&empty[s], ((it / C::kStages) + 1) & 1);
        mbar_expect_tx(&full[s], C::kBBytes);
        flash_wgmma::tma_load_2d(ring + s * C::kStageBytes + C::kABytes, &tw,
                                 &full[s], (s_beg + it) * kStageK, f0);
      }
    }
    return;
  }

  // every thread gathers; warpgroup wg multiplies the tile by channels
  // f0 + wg * kHalf .. of the weight box, asynchronously, while the
  // threads gather the next stage
  const int wg = t / 128;
  float acc[C::kHalf / 2];
#pragma unroll
  for (int i = 0; i < C::kHalf / 2; ++i) acc[i] = 0.f;
  Raw cur, nxt;
  if (n_it > 0) g.issue(sh, s_beg * kStageK, cur);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % C::kStages;
    uint8_t* st = ring + s * C::kStageBytes;
    if (it + 1 < n_it) g.issue(sh, (s_beg + it + 1) * kStageK, nxt);
    // stage it - kStages has been multiplied by both warpgroups
    if (it >= C::kStages) mbar_wait(&empty[s], ((it / C::kStages) + 1) & 1);
    g.put(cur, st);
    fence_proxy_async();
    mbar_arrive(&full[s]);
    // the whole patch tile and the weight box of stage it have landed
    mbar_wait(&full[s], (it / C::kStages) & 1);
    flash_wgmma::wgmma_fence();
    products<C>(acc, st, st + C::kABytes + wg * C::kHalf * 128);
    flash_wgmma::wgmma_commit();
    // stage it - 1's products have completed: hand its slot back
    flash_wgmma::wgmma_wait<1>();
    if (it > 0) mbar_arrive(&empty[(it + C::kStages - 1) % C::kStages]);
    cur = nxt;
  }
  flash_wgmma::wgmma_wait<0>();
  fence_acc(acc);

  // thread (warp w of its warpgroup, gq, t4) holds tile rows 16w + gq +
  // 8hh and channels wg * kHalf + 8j + 2t4 + e: acc[4j + 2hh + e]
  const int lane = t % 32, w4 = (t / 32) % 4;
  const int gq = lane / 4, t4 = lane % 4;
  if (sh.splits > 1) {
    // the float32 partial of this split, m contiguous
    float* part = ws + static_cast<int64_t>(split) * sh.F * sh.Mpad;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = tile_row_m<C>(sh, tile, 16 * w4 + gq + 8 * hh);
      if (m < 0) continue;
#pragma unroll
      for (int j = 0; j < C::kHalf / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = f0 + wg * C::kHalf + 8 * j + 2 * t4 + e;
          if (f < sh.F)
            part[static_cast<int64_t>(f) * sh.Mpad + m] =
                acc[4 * j + 2 * hh + e];
        }
    }
    return;
  }

  // every product has completed: the ring holds the staged output tile
  // [f][tile row], bfloat16 after the epilogue (barrier 1: the
  // multiplying threads; the TMA warp has left)
  named_barrier(1, kCompute);
  uint16_t* stg = reinterpret_cast<uint16_t*>(ring);
#pragma unroll
  for (int j = 0; j < C::kHalf / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int fl = wg * C::kHalf + 8 * j + 2 * t4 + e;
      const float sc = sc_s[fl], sf = sf_s[fl];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = __fadd_rn(__fmul_rn(acc[4 * j + 2 * hh + e], sc), sf);
        if (sh.relu) v = fmaxf(v, 0.f);
        const __nv_bfloat16 b = __float2bfloat16_rn(v);
        stg[fl * kLDS + 16 * w4 + gq + 8 * hh] =
            *reinterpret_cast<const uint16_t*>(&b);
      }
    }
  named_barrier(1, kCompute);
  // y in runs of 8 tile rows for each f: 16 bytes where the run is whole,
  // inside one image (one output row for "gather") and aligned
  const int OHW = sh.OH * sh.OW;
  uint16_t* yh = reinterpret_cast<uint16_t*>(y);
#pragma unroll
  for (int u = 0; u < C::kBN * kChunks / kCompute; ++u) {
    const int q = t + kCompute * u;
    const int fl = q / kChunks, h = q % kChunks;
    const int f = f0 + fl;
    const int m = tile_row_m<C>(sh, tile, 8 * h);
    if (f >= sh.F || m < 0) continue;
    int n = m / OHW;
    int r = m - n * OHW;
    const uint16_t* src = stg + fl * kLDS + 8 * h;
    uint16_t* dst = yh + ((static_cast<int64_t>(n) * sh.F + f) * OHW + r);
    const bool whole =
        C::kBody == kFlat ? m + 8 <= sh.M && r + 8 <= OHW
                          : m % sh.OW + 8 <= sh.OW;
    if (whole && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else if (C::kBody == kFlat) {
      for (int e = 0; e < 8 && m + e < sh.M; ++e, ++r) {
        if (r == OHW) {
          r = 0;
          ++n;
        }
        yh[(static_cast<int64_t>(n) * sh.F + f) * OHW + r] = src[e];
      }
    } else {
      const int cnt = min(8, sh.OW - m % sh.OW);
      for (int e = 0; e < cnt; ++e) dst[e] = src[e];
    }
  }
}

// y from the float32 partials ws [splits][F][Mpad]: partial 0 + partial 1
// + ... in split order, then the epilogue; a thread takes 4 m of one f
__global__ void __launch_bounds__(256)
split_combine_kernel(const float* __restrict__ ws,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     __nv_bfloat16* __restrict__ y, int M, int Mpad, int F,
                     int OHW, int splits, int relu) {
  const int quads = Mpad / 4;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (q >= static_cast<int64_t>(F) * quads) return;
  const int f = static_cast<int>(q / quads);
  const int m = static_cast<int>(q - static_cast<int64_t>(f) * quads) * 4;
  const int64_t plane = static_cast<int64_t>(F) * Mpad;
  const float* p = ws + static_cast<int64_t>(f) * Mpad + m;
  float4 a = *reinterpret_cast<const float4*>(p);
  for (int s = 1; s < splits; ++s) {
    const float4 b = *reinterpret_cast<const float4*>(p + s * plane);
    a.x = __fadd_rn(a.x, b.x);
    a.y = __fadd_rn(a.y, b.y);
    a.z = __fadd_rn(a.z, b.z);
    a.w = __fadd_rn(a.w, b.w);
  }
  const float sc = scale[f], sf = shift[f];
  const float v[4] = {a.x, a.y, a.z, a.w};
  uint16_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float z = __fadd_rn(__fmul_rn(v[e], sc), sf);
    if (relu) z = fmaxf(z, 0.f);
    const __nv_bfloat16 b = __float2bfloat16_rn(z);
    o[e] = *reinterpret_cast<const uint16_t*>(&b);
  }
  const int n = m / OHW;
  const int r = m - n * OHW;
  uint16_t* yh = reinterpret_cast<uint16_t*>(y);
  uint16_t* dst = yh + ((static_cast<int64_t>(n) * F + f) * OHW + r);
  if (m + 4 <= M && r + 4 <= OHW &&
      (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_halves(o[0], o[1]), pack_halves(o[2], o[3]));
  } else {
    for (int e = 0; e < 4 && m + e < M; ++e) {
      const int nn = (m + e) / OHW;
      yh[(static_cast<int64_t>(nn) * F + f) * OHW + (m + e - nn * OHW)] =
          o[e];
    }
  }
}

template <class C>
cudaError_t launch_conv(const void* x, const void* w, const float* scale,
                        const float* shift, __nv_bfloat16* y, float* ws,
                        const Shape& sh, int m_tiles, cudaStream_t stream) {
  // w [F, K] as 64 (k) x kBN (f) boxes
  CUtensorMap tw;
  cudaError_t e = flash_wgmma::encode_2d(&tw, w, sh.K, sh.F, kStageK, C::kBN);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(m_tiles),
                  static_cast<unsigned>((sh.F + C::kBN - 1) / C::kBN),
                  static_cast<unsigned>(sh.splits));
  conv_kernel<C><<<grid, kThreads, C::kSmem, stream>>>(
      tw, static_cast<const uint16_t*>(x), scale, shift, y, ws, sh);
  return cudaGetLastError();
}

template <int kBody>
cudaError_t launch_tile(int bn, const void* x, const void* w,
                        const float* scale, const float* shift,
                        __nv_bfloat16* y, float* ws, const Shape& sh,
                        int m_tiles, cudaStream_t stream) {
  if (bn == 64)
    return launch_conv<Cfg<64, kBody>>(x, w, scale, shift, y, ws, sh,
                                       m_tiles, stream);
  if (bn == 128)
    return launch_conv<Cfg<128, kBody>>(x, w, scale, shift, y, ws, sh,
                                        m_tiles, stream);
  return cudaErrorInvalidValue;
}

// The wgmma bodies' entry: checks what they need of the shape and the
// plan (body, splits, bn), then launches. ws: splits x F x Mpad floats
// when splits > 1 (Mpad = M rounded up to a multiple of 4).
cudaError_t launch(int body, int splits, int bn, const void* x,
                   const void* w, const float* scale, const float* shift,
                   __nv_bfloat16* y, float* ws, int N, int C, int H, int W,
                   int F, int KH, int KW, int stride, int pad, int OH, int OW,
                   int relu, cudaStream_t stream) {
  Shape sh{N, C, H, W, F, KH, KW, stride, pad, OH, OW, relu};
  const int64_t M = static_cast<int64_t>(N) * OH * OW;
  const int64_t K = static_cast<int64_t>(C) * KH * KW;
  // int32 offsets into x and over m; a TMA row of K bfloat16 in whole
  // 16-byte units, from a 16-byte aligned w; stride 1 (the "1x1" body
  // also without padding)
  if (static_cast<int64_t>(N) * C * H * W >= (int64_t{1} << 31) ||
      M > (int64_t{1} << 31) - 256 || K % 8 != 0 ||
      stride != 1 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (body == kFlat && (KH != 1 || KW != 1 || pad != 0)))
    return cudaErrorInvalidValue;
  sh.M = static_cast<int>(M);
  sh.K = static_cast<int>(K);
  sh.T = static_cast<int>((K + kStageK - 1) / kStageK);
  sh.splits = splits;
  sh.Mpad = static_cast<int>((M + 3) / 4 * 4);
  if (splits < 1 || splits > sh.T || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if (body == kFlat)
    return launch_tile<kFlat>(bn, x, w, scale, shift, y, ws, sh,
                              static_cast<int>((M + kBM - 1) / kBM), stream);
  if (body != kRows) return cudaErrorInvalidValue;
  // row tiles: Wb = the least power of two >= OW (at least 8) when OW <=
  // 64, R = 64 / Wb output rows a tile; else 64 columns of one row a tile
  const int64_t rows = static_cast<int64_t>(N) * OH;
  int64_t m_tiles;
  sh.lwb = 3;
  while ((1 << sh.lwb) < OW && sh.lwb < 6) ++sh.lwb;
  if (OW <= kBM) {
    sh.R = kBM >> sh.lwb;
    sh.owtiles = 1;
    m_tiles = (rows + sh.R - 1) / sh.R;
  } else {
    sh.R = 1;
    sh.owtiles = (OW + kBM - 1) / kBM;
    m_tiles = rows * sh.owtiles;
  }
  if (m_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  return launch_tile<kRows>(bn, x, w, scale, shift, y, ws, sh,
                            static_cast<int>(m_tiles), stream);
}

cudaError_t launch_combine(const float* ws, const float* scale,
                           const float* shift, __nv_bfloat16* y, int M, int F,
                           int OHW, int splits, int relu,
                           cudaStream_t stream) {
  if (M < 0 || F < 0 || OHW <= 0 || splits < 1 ||
      M > (1 << 30))
    return cudaErrorInvalidValue;
  const int Mpad = (M + 3) / 4 * 4;
  const int64_t threads = static_cast<int64_t>(F) * (Mpad / 4);
  if (threads == 0) return cudaSuccess;
  const int64_t blocks = (threads + 255) / 256;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  split_combine_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      ws, scale, shift, y, M, Mpad, F, OHW, splits, relu);
  return cudaGetLastError();
}

}  // namespace
}  // namespace conv_wgmma
