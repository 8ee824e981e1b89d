// Fused conv2d + folded batch norm + relu for Hopper (sm_90a): float32
// (conv_bn_relu_f32) and bfloat16 operands (conv_bn_relu_bf16, the
// FLAGS['amp'] form, and conv_split_combine_bf16, its split-K combine;
// their design is at the bf16 kernel below and in conv_wgmma.cuh).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py:_gemm_epilogue_kernel
// (launched by _fused_gemm) and computes the same function as the plain
// version
//   paddle_tpu_torch/kernels/conv_bn_relu.py:fused_conv_bn_relu_reference
// over the same layouts: x [N, C, H, W], w [F, C, KH, KW], scale and
// shift [F], y [N, F, OH, OW], all NCHW float32:
//   y[n, f, oh, ow] = act(sum_k P[m, k] * w[f, k] * scale[f] + shift[f])
// with m = (n, oh, ow), k = (c, i, j) in the channel-major patch order,
// P[m, k] = x[n, c, oh*s - p + i, ow*s - p + j] (0 outside the image)
// and act = relu or the identity. The affine and relu are applied to
// the float32 accumulator before the one store, as in the TPU kernel.
//
// What bounds it on this card: operations. A ResNet-50 convolution does
// 2*M*K*F flops on (x + w + y) bytes; at batch 16 that is 30-300 flops
// per byte. The product runs on the tensor cores in 3xTF32 (tf32x3.cuh:
// each operand split into a TF32 big part and the float32 rest, three
// TF32 products summed in float32), float32-level accuracy at a third of
// the TF32 rate, so the floor is 3 * 2*M*K*F / 495 TFLOP/s plus the
// epilogue's 3*M*F flops over the 67 TFLOP/s float32 peak. The design:
//   - implicit GEMM y[m, f] = sum_k P[m, k] w[f, k]: the TPU kernel gets
//     a patch matrix P [M, K] that XLA materialised in HBM; here each
//     block gathers its patch tiles straight from x by index math (a
//     zero for a pad position), so P never exists (118 MB at the stem
//     with batch 16);
//   - a block computes a 64 (m) x 64 (f) output tile with two k-groups
//     of 4 warps: group q sums the K slices q, q + 2, q + 4, ... and
//     group 0 adds group 1's sums at the end. Each warp owns 32 x 32 of
//     the tile (2 m16 x 4 n8 tiles of mma.sync m16n8k8): each split A
//     fragment feeds 4 n-tiles and each split B fragment 2 m-tiles.
//     Small tiles and the second k-group keep enough warps in flight at
//     res4/res5 (M = 784 at batch 16: 13 x 8 blocks for F = 512). A
//     trial on the card (PERF.md) measured 128 x 64 and 128 x 128 tiles
//     and one or four k-groups: slower over a ResNet-50 forward;
//   - K runs in slices of 32 (4 k-steps). A round of two slices (one a
//     group) is staged by cp.async into one of two buffers: round i + 1
//     loads while round i computes, one __syncthreads() a round. Patch
//     slice: for each k of the slice, (c, i, j) is decomposed once by
//     one warp into a small shared table; each thread keeps one m row
//     (n, ih0, iw0) for the whole block and gathers 16 k of it with
//     4-byte cp.async, a warp 32 consecutive m (consecutive ow,
//     coalesced), zero-filled (src-size 0) outside the image and past M
//     or K. Weight slice: 16-byte cp.async along k where K % 4 == 0
//     (4-byte otherwise: the stem's K = 147), zero-filled past F or K;
//   - shared layout: the patch slice k-major [32][64 + 8] (stride = 8
//     mod 32) and the weight slice [64][32 + 4] (stride = 4 mod 32), so
//     every fragment load hits 32 distinct banks and the gather's
//     stores of 32 consecutive m do too;
//   - fixed summation order per output: each slice's products sum in
//     fresh fragments (the tensor core's own summation does not round
//     to nearest), which join the group's accumulators by float32 adds;
//     then group 0 adds group 1's accumulators. The slice width, the
//     k-steps, the groups and the order of the three products are the
//     same for every shape and tile, so an output's value does not
//     depend on M (on how many images share the batch) or on where its
//     row lands in a tile;
//   - the epilogue applies scale, shift (two roundings, as the
//     reference's separate multiply and add) and relu to the float32
//     accumulator and writes y straight in NCHW: a store instruction
//     covers 8 consecutive m (32 bytes) for each of 4 channels, so no
//     transpose runs afterwards;
//   - M, F and K that fit no tile are masked in the kernel (no padding
//     copies).
// What holds it below that floor (PERF.md has the times): issue slots
// (each 3-MMA product also costs the shared loads and integer/float ops
// that split its fragments, and the gather's index math) and, at
// res4/res5, the few warps in flight. Not done yet (later work): wgmma
// (its TF32 operands come from shared memory, so 3xTF32 needs split
// copies of each tile), TMA, larger warp tiles where registers allow
// (fewer fragment splits per MMA).
//
// The kernels allocate nothing; the caller passes the output. Each C
// entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "conv_wgmma.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kBM = 64;        // output rows (m = n, oh, ow) a block
constexpr int kBF = 64;        // output channels a block
constexpr int kBK = 32;        // k slice: 4 k-steps of 8
constexpr int kStages = 2;     // rounds of slices in shared memory at once
constexpr int kWarpsM = 2;     // the warps of one k-group along m
constexpr int kWarpsF = 2;     // and along f
constexpr int kGroups = 2;     // k-groups: slice s goes to group s % 2
constexpr int kGroupThreads = 32 * kWarpsM * kWarpsF;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kMinBlocks = 512 / kThreads;  // an SM's blocks: <= 128 regs
constexpr int kWM = kBM / kWarpsM;  // rows a warp (32)
constexpr int kWF = kBF / kWarpsF;  // channels a warp (32)
constexpr int kMT = kWM / 16;       // m16 tiles a warp
constexpr int kNT = kWF / 8;        // n8 tiles a warp
static_assert(kNT == 4, "mma3x4 issues four n-tiles at once");
constexpr int kLDA = kBM + 8;  // patch slice [kBK][kLDA], k-major
constexpr int kLDB = kBK + 4;  // weight slice [kBF][kLDB]
constexpr int kA = kBK * kLDA;                // floats of a patch slice
constexpr int kB = kBF * kLDB;                // floats of a weight slice
constexpr int kSlice = kA + kB + 2 * kBK;     // + the slice's k table (int2)
constexpr int kGather = kBK * kBM / kGroupThreads;  // patch values a thread
constexpr int kBChunks = kBF * kBK / 4 / kGroupThreads;  // 16-byte loads
constexpr int kBScalar = kBF * kBK / kGroupThreads;      // or 4-byte ones
constexpr int kAcc = kMT * kNT * 4;  // accumulator floats a lane
constexpr int kPastK = 0x4000 << 16;  // table entry past K: i out of range
static_assert(kStages * kGroups * kSlice >= (kGroups - 1) * kBM * kBF,
              "the k-groups' partial sums reuse the slice buffers");

// The A fragment of k-step ks from a k-major slice (A[m][k] at
// a[k * ld + m]), rows m0 .. m0 + 15, split into big and small parts.
__device__ __forceinline__ void load_a_kmajor(const float* a, int ld, int ks,
                                              int m0, int g, int t,
                                              uint32_t (&ab)[4],
                                              uint32_t (&as)[4]) {
  const float* p = a + (8 * ks + t) * ld + m0 + g;
  const float x[4] = {p[0], p[8], p[4 * ld], p[4 * ld + 8]};
  split(x, ab, as);
}

// grid (ceil(M / 64), ceil(F / 64)). Both k-groups of 4 warps compute
// the block's whole 64 x 64 output tile: group q sums the slices s = q,
// q + 2, q + 4, ..., and group 0 adds group 1's sums at the end. A
// round of kGroups slices is staged together, into one of kStages
// buffers.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv_bn_relu_kernel(const float* __restrict__ x,
                    const float* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    float* __restrict__ y,
                    int N, int C, int H, int W, int F, int KH, int KW,
                    int stride, int pad, int OH, int OW, int relu,
                    int w_vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int grp = tid / kGroupThreads;  // the thread's k-group
  const int gt = tid % kGroupThreads;   // and its rank in the group
  const int warp = gt / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kBM;
  const int f0 = blockIdx.y * kBF;
  const int OHW = OH * OW;
  const int M = N * OHW;
  const int KHW = KH * KW;
  const int K = C * KHW;
  const int n_slices = (K + kBK - 1) / kBK;
  const int n_rounds = (n_slices + kGroups - 1) / kGroups;

  // the one patch row this thread gathers: m = m0 + lm, slice columns
  // kk0 + 2r; a row past M gets ih0 far out of range (every load 0)
  const int lm = gt % kBM;
  const int kk0 = gt / kBM;
  int ih0 = -(1 << 29), iw0 = 0;
  int64_t row = 0;  // offset of x[n, 0, ih0, iw0]
  if (m0 + lm < M) {
    const int n = (m0 + lm) / OHW;
    const int r = (m0 + lm) - n * OHW;
    const int oh = r / OW;
    ih0 = oh * stride - pad;
    iw0 = (r - oh * OW) * stride - pad;
    row = static_cast<int64_t>(n) * C * H * W +
          static_cast<int64_t>(ih0) * W + iw0;
  }

  // each group stages the slice of a round that it computes, into its
  // own slice buffer of the round's stage
  auto slice_buf = [&](int round, int q) {
    return smem + ((round % kStages) * kGroups + q) * kSlice;
  };
  // slice s's k table: (c*H + i)*W + j and (i << 16) | j for each k,
  // written by the group's first warp ahead of the barrier that precedes
  // its staging. c = k / KHW and i = rem / KW by a float reciprocal:
  // exact while K < 2^22 (the host checks), as (k + 1/2) / KHW is at
  // least 1 / (2 KHW) from an integer and the float product errs less
  const float r_khw = 1.f / KHW, r_kw = 1.f / KW;
  auto table = [&](int round) {
    const int s = round * kGroups + grp;
    if (gt >= kBK || s >= n_slices) return;
    int2* tab = reinterpret_cast<int2*>(slice_buf(round, grp) + kA + kB);
    const int k = s * kBK + gt;
    int2 e = make_int2(0, kPastK);
    if (k < K) {
      const int c = static_cast<int>((k + 0.5f) * r_khw);
      const int rem = k - c * KHW;
      const int i = static_cast<int>((rem + 0.5f) * r_kw);
      const int j = rem - i * KW;
      e = make_int2((c * H + i) * W + j, (i << 16) | j);
    }
    tab[gt] = e;
  };
  auto stage = [&](int round) {
    const int s = round * kGroups + grp;
    if (s >= n_slices) return;
    float* as = slice_buf(round, grp);
    float* bs = as + kA;
    const int2* tab = reinterpret_cast<const int2*>(bs + kB);
#pragma unroll
    for (int r = 0; r < kGather; ++r) {
      const int kk = kk0 + r * (kGroupThreads / kBM);
      const int2 e = tab[kk];
      const int ih = ih0 + (e.y >> 16);
      const int iw = iw0 + (e.y & 0xffff);
      const bool ok = static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(W);
      cp_async4(as + kk * kLDA + lm, ok ? x + (row + e.x) : x, ok ? 4 : 0);
    }
    const int k0 = s * kBK;
    if (w_vec) {
#pragma unroll
      for (int r = 0; r < kBChunks; ++r) {
        const int q = gt + r * kGroupThreads;
        const int ff = q / (kBK / 4);
        const int c = (q % (kBK / 4)) * 4;
        const bool ok = f0 + ff < F && k0 + c < K;  // K % 4 == 0
        cp_async16(bs + ff * kLDB + c,
                   ok ? w + (static_cast<int64_t>(f0 + ff) * K + k0 + c) : w,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < kBScalar; ++r) {
        const int q = gt + r * kGroupThreads;
        const int ff = q / kBK;
        const int c = q % kBK;
        const bool ok = f0 + ff < F && k0 + c < K;
        cp_async4(bs + ff * kLDB + c,
                  ok ? w + (static_cast<int64_t>(f0 + ff) * K + k0 + c) : w,
                  ok ? 4 : 0);
      }
    }
  };

  // prologue: the tables, then the first kStages - 1 rounds, one
  // cp.async group each
  for (int r = 0; r < kStages - 1 && r < n_rounds; ++r) table(r);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) {
    if (r < n_rounds) stage(r);
    cp_async_commit();
  }

  const int wm = (warp / kWarpsF) * kWM;  // the warp's rows in the block
  const int wf = (warp % kWarpsF) * kWF;  // and its channels
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int it = 0; it < n_rounds; ++it) {
    const int next = it + kStages - 1;
    // next's buffers last held round it - 1, whose tables were read when
    // it was staged, before the previous barrier
    if (next < n_rounds) table(next);
    cp_async_wait<kStages - 2>();
    __syncthreads();  // round it has landed; every warp is done with it - 1
    if (next < n_rounds) stage(next);  // overlaps this round's math
    cp_async_commit();
    if (it * kGroups + grp >= n_slices) continue;  // past the last slice

    const float* as = slice_buf(it, grp);
    const float* bs = as + kA + wf * kLDB;
    // the slice's products in fresh fragments, then float32 adds
    float fr[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) fr[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      uint32_t ab[kMT][4], am[kMT][4], bb[kNT][2], bsm[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        load_a_kmajor(as, kLDA, ks, wm + 16 * i, g, t, ab[i], am[i]);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        load_bt(bs, kLDB, j, ks, g, t, bb[j], bsm[j]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        mma3x4(fr[i][0], fr[i][1], fr[i][2], fr[i][3], ab[i], am[i], ab[i],
               am[i], ab[i], am[i], ab[i], am[i], bb, bsm);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) add_tiles(acc[i], fr[i]);
  }
  cp_async_wait_all();
  __syncthreads();  // every slice is consumed: the buffers are free

  // groups 1.. hand their sums to group 0 through shared memory (lane
  // order: no bank conflict), which adds them in group order: each
  // output's summation order is fixed whatever the shape
  if (grp > 0) {
    float* part =
        smem + ((grp - 1) * (kGroupThreads / 32) + warp) * 32 * kAcc;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[((i * kNT + j) * 4 + e) * 32 + lane] = acc[i][j][e];
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int q = 1; q < kGroups; ++q) {
    const float* p = smem + ((q - 1) * (kGroupThreads / 32) + warp) * 32 *
                                kAcc;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] += p[((i * kNT + j) * 4 + e) * 32 + lane];
  }

  // epilogue: acc * scale + shift (two roundings, as the reference's
  // separate multiply and add), relu, one store into NCHW
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const int n = m / OHW;
      float* yb = y + static_cast<int64_t>(n) * F * OHW + (m - n * OHW);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = f0 + wf + 8 * j + 2 * t + e;
          if (f >= F) continue;
          float v = __fadd_rn(__fmul_rn(acc[i][j][2 * h + e], scale[f]),
                              shift[f]);
          if (relu) v = fmaxf(v, 0.f);
          yb[static_cast<int64_t>(f) * OHW] = v;
        }
    }
}


// ------------------------------------------------------------------ bf16
// conv_bn_relu_bf16: the bfloat16 form of the TPU kernel, which under
// FLAGS['amp'] takes bfloat16 x and w, accumulates the product in float32
// (preferred_element_type), applies the float32 scale/shift and relu to
// the accumulator and stores y in bfloat16 (acc.astype(y_ref.dtype),
// conv_bn_relu.py:54). Same layouts as conv_bn_relu_f32, x, w and y
// bfloat16, scale and shift float32.
//
// What bounds it on this card: at batch 16, bytes for most ResNet-50
// convolutions and operations for the 3x3s (chip_smoke.py's bound: the
// product over 989 TFLOP/s bf16 and the epilogue over 67 TFLOP/s against
// x, w, y over 3.35 TB/s): 2-12 us of work each. A plan, one pure
// function of the shape (C, H, W, F, KH, KW, stride, pad) in the wrapper
// (kernels/conv_bn_relu.py:_plan), picks the body, the split of K and the
// tile; never of N or M, so an image's output is bitwise the same
// whatever batch it is served in. Bodies:
//   - "gather" (stride 1, any KH x KW and padding) and "1x1" (1x1,
//     stride 1, no padding), K a multiple of 8: wgmma m64nNk16 with the
//     weight tiles by TMA from a warp of their own, the patch tiles
//     gathered by 256 threads into swizzled shared memory, K optionally
//     split into S parts whose float32 partials split_combine_kernel adds
//     in split order (conv_wgmma.cuh has the design);
//   - "mma" (the stem, K = 147: no whole 16-byte TMA weight rows; and the
//     strided 1x1 reductions and projections, where it is already faster
//     than cuDNN or level with the wgmma bodies): the mma.sync body
//     below, this kernel's first form.
// The mma.sync body: implicit GEMM, 64 (m) x 64 (f) output tiles, two
// k-groups of 4 warps (group q sums the 32-wide k slices q, q + 2, ...),
// each warp 32 x 32 of the tile (2 m16 x 4 n8 tiles), each slice's two
// k-steps summed in fresh fragments and added to the accumulators in
// float32, group 1's sums added by group 0 at the end; the patch slice
// stored k-major [32][64 + 8] and read with ldmatrix .trans, the weight
// slice [64][32 + 8] with ldmatrix; the gather through registers (2-byte
// loads for round i + 1 issued before round i's products), weights by
// 16-byte cp.async where K % 8 == 0 (2-byte loads at the stem).
// Both bodies apply scale, shift (two roundings) and relu to the float32
// accumulator and round once to bfloat16, to nearest even
// (__float2bfloat16_rn), as XLA's convert does.
// What still holds the wgmma bodies at 2-10% of their bound (PERF.md has
// the times): each stage is a serial chain in every block — the gather's
// index math and 2-byte loads (x is NCHW, so a patch row is 2-byte
// strided for every k), the block-wide wait for the stage's stores, the
// products, the release — and the two blocks an SM do not hide each
// other's chains: on an H100 a batch-1 call took about as long as a
// batch-16 one. A pure TMA patch tile from an NHWC copy of x
// (transposes of x and w a call) ran slower end to end (PERF.md).

namespace bf16k {

constexpr int kLDA = kBM + 8;                 // patch slice [kBK][kLDA]
constexpr int kLDB = kBK + 8;                 // weight slice [kBF][kLDB]
constexpr int kA = kBK * kLDA;                // halves of a patch slice
constexpr int kB = kBF * kLDB;                // halves of a weight slice
constexpr int kSlice = kA + kB + 4 * kBK;     // + the k table (int2)
constexpr int kBChunks = kBF * kBK / 8 / kGroupThreads;  // 16-byte loads
constexpr int kBScalar = kBF * kBK / kGroupThreads;      // or 2-byte ones
static_assert(kSlice * 2 % 16 == 0, "slice buffers stay 16-byte aligned");
static_assert(kStages * kGroups * kSlice * 2 >=
                  (kGroups - 1) * kBM * kBF * 4,
              "the k-groups' partial sums reuse the slice buffers");

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
// Fragments (g = lane / 4, t = lane % 4), two bf16 a register, the
// lower index in the low half: a = A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]; b = B[2t..][g], B[2t+8..][g]; d as in
// mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (ceil(M / 64), ceil(F / 64)); see above. Round r holds slices
// 2r (group 0) and 2r + 1 (group 1) in buffer r % 2.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv_bn_relu_bf16_kernel(const uint16_t* __restrict__ x,
                         const uint16_t* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         __nv_bfloat16* __restrict__ y,
                         int N, int C, int H, int W, int F, int KH, int KW,
                         int stride, int pad, int OH, int OW, int relu,
                         int w_vec) {
  extern __shared__ float4 smem4[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(smem4);

  const int tid = threadIdx.x;
  const int grp = tid / kGroupThreads;
  const int gt = tid % kGroupThreads;
  const int warp = gt / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kBM;
  const int f0 = blockIdx.y * kBF;
  const int OHW = OH * OW;
  const int M = N * OHW;
  const int KHW = KH * KW;
  const int K = C * KHW;
  const int n_slices = (K + kBK - 1) / kBK;
  const int n_rounds = (n_slices + kGroups - 1) / kGroups;

  // the thread's patch row m = m0 + lm and slice columns kk0 + 2r, as in
  // the float32 kernel
  const int lm = gt % kBM;
  const int kk0 = gt / kBM;
  int ih0 = -(1 << 29), iw0 = 0;
  int64_t row = 0;
  if (m0 + lm < M) {
    const int n = (m0 + lm) / OHW;
    const int r = (m0 + lm) - n * OHW;
    const int oh = r / OW;
    ih0 = oh * stride - pad;
    iw0 = (r - oh * OW) * stride - pad;
    row = static_cast<int64_t>(n) * C * H * W +
          static_cast<int64_t>(ih0) * W + iw0;
  }

  auto slice_buf = [&](int round) {
    return smem + ((round % kStages) * kGroups + grp) * kSlice;
  };
  const float r_khw = 1.f / KHW, r_kw = 1.f / KW;
  // the k table of the group's slice of a round, by its first warp
  auto table = [&](int round) {
    const int s = round * kGroups + grp;
    if (gt >= kBK || s >= n_slices) return;
    int2* tab = reinterpret_cast<int2*>(slice_buf(round) + kA + kB);
    const int k = s * kBK + gt;
    int2 e = make_int2(0, kPastK);
    if (k < K) {
      const int c = static_cast<int>((k + 0.5f) * r_khw);
      const int rem = k - c * KHW;
      const int i = static_cast<int>((rem + 0.5f) * r_kw);
      const int j = rem - i * KW;
      e = make_int2((c * H + i) * W + j, (i << 16) | j);
    }
    tab[gt] = e;
  };
  // the thread's patch values of a round's slice, into registers
  uint16_t vals[kGather];
  auto gather = [&](int round) {
    const int s = round * kGroups + grp;
    if (s >= n_slices) return;
    const int2* tab =
        reinterpret_cast<const int2*>(slice_buf(round) + kA + kB);
#pragma unroll
    for (int r = 0; r < kGather; ++r) {
      const int2 e = tab[kk0 + r * (kGroupThreads / kBM)];
      const int ih = ih0 + (e.y >> 16);
      const int iw = iw0 + (e.y & 0xffff);
      const bool ok = static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(W);
      vals[r] = ok ? __ldg(x + (row + e.x)) : uint16_t{0};
    }
  };
  auto put = [&](int round) {
    if (round * kGroups + grp >= n_slices) return;
    uint16_t* as = slice_buf(round);
#pragma unroll
    for (int r = 0; r < kGather; ++r)
      as[(kk0 + r * (kGroupThreads / kBM)) * kLDA + lm] = vals[r];
  };
  // the weight slice: 16-byte cp.async (committed by the caller), or
  // 2-byte loads stored at once
  auto weights = [&](int round) {
    const int s = round * kGroups + grp;
    if (s >= n_slices) return;
    uint16_t* bs = slice_buf(round) + kA;
    const int k0 = s * kBK;
    if (w_vec) {
#pragma unroll
      for (int r = 0; r < kBChunks; ++r) {
        const int q = gt + r * kGroupThreads;
        const int ff = q / (kBK / 8);
        const int c = (q % (kBK / 8)) * 8;
        const bool ok = f0 + ff < F && k0 + c < K;  // K % 8 == 0
        const uint16_t* src =
            ok ? w + (static_cast<int64_t>(f0 + ff) * K + k0 + c) : w;
        tf32x3::cp_async16(reinterpret_cast<float*>(bs + ff * kLDB + c),
                           reinterpret_cast<const float*>(src), ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < kBScalar; ++r) {
        const int q = gt + r * kGroupThreads;
        const int ff = q / kBK;
        const int c = q % kBK;
        const bool ok = f0 + ff < F && k0 + c < K;
        bs[ff * kLDB + c] =
            ok ? __ldg(w + (static_cast<int64_t>(f0 + ff) * K + k0 + c))
               : uint16_t{0};
      }
    }
  };

  // prologue: the tables of rounds 0 and 1, round 0's patches and weights
  table(0);
  if (n_rounds > 1) table(1);
  __syncthreads();
  gather(0);
  put(0);
  weights(0);
  tf32x3::cp_async_commit();

  const int wm = (warp / kWarpsF) * kWM;
  const int wf = (warp % kWarpsF) * kWF;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int mi = lane / 8, mr = lane % 8;

  for (int it = 0; it < n_rounds; ++it) {
    // round it has landed (its cp.async and every thread's stores);
    // every warp is done with round it - 1, whose buffer takes it + 1
    tf32x3::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_rounds) {
      weights(it + 1);
      gather(it + 1);  // loads in flight during this round's products
    }
    tf32x3::cp_async_commit();
    // round it + 2's table into this round's buffer: its own table was
    // read by round it's gather, before the barrier above
    if (it + 2 < n_rounds) table(it + 2);

    if (it * kGroups + grp < n_slices) {
      const uint16_t* as = slice_buf(it);
      const uint16_t* bs = as + kA;
      float fr[kMT][kNT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) fr[i][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t a[kMT][4], b[kNT / 2][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          ldmatrix_x4_trans(
              a[i], as + (16 * ks + 8 * (mi >> 1) + mr) * kLDA + wm +
                        16 * i + 8 * (mi & 1));
#pragma unroll
        for (int jj = 0; jj < kNT / 2; ++jj)
          ldmatrix_x4(b[jj], bs + (wf + 16 * jj + 8 * (mi >> 1) + mr) * kLDB +
                                 16 * ks + 8 * (mi & 1));
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            mma_bf16(fr[i][j], a[i], b[j / 2][2 * (j % 2)],
                     b[j / 2][2 * (j % 2) + 1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) add_tiles(acc[i], fr[i]);
    }
    if (it + 1 < n_rounds) put(it + 1);
  }
  tf32x3::cp_async_wait_all();
  __syncthreads();  // every slice is consumed: the buffers are free

  // group 1 hands its sums to group 0, as in the float32 kernel
  float* fsm = reinterpret_cast<float*>(smem4);
  if (grp > 0) {
    float* part = fsm + ((grp - 1) * (kGroupThreads / 32) + warp) * 32 * kAcc;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[((i * kNT + j) * 4 + e) * 32 + lane] = acc[i][j][e];
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int q = 1; q < kGroups; ++q) {
    const float* p = fsm + ((q - 1) * (kGroupThreads / 32) + warp) * 32 *
                               kAcc;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] += p[((i * kNT + j) * 4 + e) * 32 + lane];
  }

  // epilogue: acc * scale + shift, relu, one rounding to bfloat16
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const int n = m / OHW;
      __nv_bfloat16* yb = y + static_cast<int64_t>(n) * F * OHW + (m - n * OHW);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = f0 + wf + 8 * j + 2 * t + e;
          if (f >= F) continue;
          float v = __fadd_rn(__fmul_rn(acc[i][j][2 * h + e], scale[f]),
                              shift[f]);
          if (relu) v = fmaxf(v, 0.f);
          yb[static_cast<int64_t>(f) * OHW] = __float2bfloat16_rn(v);
        }
    }
}

}  // namespace bf16k

// The shapes both kernels take (the k table's packing, its float
// division, 32-bit offsets) and their grid; false when out of range.
bool conv_grid(int N, int C, int H, int W, int F, int KH, int KW, int stride,
               int pad, int OH, int OW, dim3* grid) {
  if (N < 0 || C <= 0 || H <= 0 || W <= 0 || F < 0 || KH <= 0 || KW <= 0 ||
      stride <= 0 || pad < 0 || OH < 0 || OW < 0)
    return false;
  // the k table packs (i << 16) | j, its past-K entry's i = 0x4000 must
  // land below every image row (H + pad <= 0x4000), and its float
  // division is exact for K < 2^22
  if (KH >= 0x4000 || KW > 0xffff || H + pad > 0x4000 ||
      static_cast<int64_t>(C) * KH * KW >= (1 << 22))
    return false;
  const int64_t M = static_cast<int64_t>(N) * OH * OW;
  if (M > (int64_t{1} << 31) - kBM ||
      static_cast<int64_t>(C) * H * W > (int64_t{1} << 31) - 1)
    return false;
  *grid = dim3(static_cast<unsigned>((M + kBM - 1) / kBM),
               static_cast<unsigned>((F + kBF - 1) / kBF));
  return grid->y <= 65535;
}

}  // namespace

extern "C" {

int conv_bn_relu_f32(const void* x, const void* w, const void* scale,
                     const void* shift, void* y, int N, int C, int H, int W,
                     int F, int KH, int KW, int stride, int pad, int OH,
                     int OW, int relu, void* stream) {
  if (N == 0 || F == 0 || OH == 0 || OW == 0) return cudaSuccess;
  dim3 grid;
  if (!conv_grid(N, C, H, W, F, KH, KW, stride, pad, OH, OW, &grid))
    return cudaErrorInvalidValue;
  const int K = C * KH * KW;
  const int w_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const size_t smem = sizeof(float) * kStages * kGroups * kSlice;
  cudaError_t e = cudaFuncSetAttribute(
      conv_bn_relu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_bn_relu_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(y), N, C, H, W, F, KH, KW, stride, pad, OH, OW,
      relu, w_vec);
  return static_cast<int>(cudaGetLastError());
}

int conv_bn_relu_bf16(const void* x, const void* w, const void* scale,
                      const void* shift, void* y, void* ws, int N, int C,
                      int H, int W, int F, int KH, int KW, int stride, int pad,
                      int OH, int OW, int relu, int body, int splits, int bn,
                      void* stream) {
  if (N == 0 || F == 0 || OH == 0 || OW == 0) return cudaSuccess;
  dim3 grid;
  if (!conv_grid(N, C, H, W, F, KH, KW, stride, pad, OH, OW, &grid))
    return cudaErrorInvalidValue;
  if (body != 0)  // the plan's wgmma bodies
    return static_cast<int>(conv_wgmma::launch(
        body, splits, bn, x, w, static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(ws), N, C, H, W, F, KH, KW, stride, pad, OH, OW,
        relu, static_cast<cudaStream_t>(stream)));
  if (splits != 1 || bn != 64) return cudaErrorInvalidValue;
  const int K = C * KH * KW;
  const int w_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const size_t smem = 2 * kStages * kGroups * bf16k::kSlice;
  cudaError_t e = cudaFuncSetAttribute(
      bf16k::conv_bn_relu_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  bf16k::conv_bn_relu_bf16_kernel<<<grid, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(y), N, C, H, W, F, KH, KW, stride, pad, OH,
      OW, relu, w_vec);
  return static_cast<int>(cudaGetLastError());
}

// y from the float32 partials of a split launch of conv_bn_relu_bf16
// (ws [splits][F][M rounded up to 4]): summed in split order, then the
// epilogue, rounded once to bfloat16.
int conv_split_combine_bf16(const void* ws, const void* scale,
                            const void* shift, void* y, int M, int F,
                            int OHW, int splits, int relu, void* stream) {
  return static_cast<int>(conv_wgmma::launch_combine(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(y), M, F,
      OHW, splits, relu, static_cast<cudaStream_t>(stream)));
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
