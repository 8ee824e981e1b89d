// What the bfloat16 flash kernels on warpgroup matrix multiplies (wgmma)
// fed by the Tensor Memory Accelerator (TMA) share, for Hopper (sm_90a):
// mbarriers, TMA loads of [BH, S, D] rows in 64 x 64 boxes with 128-byte
// swizzle, the shared-memory matrix descriptors, the wgmma forms, the
// exp2 and bfloat16 packing of the probability tiles, the output store
// and the host's tensor-map encoding. flash_bwd_wgmma.cuh (dK/dV, dQ) and
// flash_fwd_wgmma.cuh (the forward) build their kernels from these;
// conv_wgmma.cuh (K5's bfloat16 form) takes the barriers, descriptors and
// encoder, and the forms marked for it below (a 2-D TMA map and load,
// products with an MN-major A, waits that leave groups in flight, the
// proxy fence for tiles written by threads).
//
// Layout facts every kernel relies on:
//   - a block is one warpgroup (128 threads); warp w owns rows 16w ..
//     16w + 15 of the block's 64, the M side of every wgmma;
//   - a wgmma accumulator of N columns holds, for thread (warp w, g =
//     lane / 4, t = lane % 4), d[4j + 2h + e] = D[16w + g + 8h][8j + 2t +
//     e]: the mma.sync m16n8k16 layout of the warp's 16 rows, n-tile by
//     n-tile, and also the A-fragment layout of the next product, so a
//     probability tile is rounded and packed in registers (acc_as_a);
//   - rows of 64 bf16 (128 bytes) arrive by TMA with 128-byte swizzle;
//     boxes of 64 rows stacked in shared memory form one operand of 128
//     rows (8-row groups 1024 bytes apart throughout).
//
// The kernels allocate nothing; the caller passes the outputs. The TMA
// descriptors are encoded on the host for each call
// (cuTensorMapEncodeTiled, found through the runtime's driver entry
// points) and passed as __grid_constant__ parameters; a descriptor that
// fails to encode returns an error, and nothing falls back.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace flash_wgmma {
namespace {

constexpr int kThreads = 128;          // one warpgroup a block
constexpr int kRows = 64;              // rows a block owns (wgmma M)
constexpr int kTile = 64;              // rows of a TMA box
constexpr int kDP = 64;                // head_dim held in shared memory
constexpr int kBox = kTile * kDP * 2;  // bytes of one 64 x 64 TMA box
constexpr int kSteps = kDP / 16;       // k-steps over head_dim
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary in a dynamic shared array (the 128-byte
// swizzle pattern repeats every 8 rows of 128 bytes): an offset from the
// array (not an integer cast), so that the compiler keeps every pointer
// derived from it in the shared state space
__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
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
  } while (!done);
}

// ----------------------------------------------------------------- TMA
// one box of a 3-D map at (column c0, row c1, batch-head c2) into dst;
// its bytes complete on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// one box of a 1-D map at element c0 into dst
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// one box of a 2-D map at (column c0, row c1) into dst (conv_wgmma.cuh)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// make this thread's st.shared writes visible to the async proxy (wgmma
// reads its shared operands through it): after the writes, before the
// mbarrier arrive that publishes them (conv_wgmma.cuh)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units). K-major tiles (rows
// of 64 bf16, k contiguous): stride 1024 between 8-row groups, the
// leading offset unused; a k-step of 16 columns moves the start by 32
// bytes inside the swizzled row. MN-major tiles (rows = k, 64 bf16 of n
// contiguous): 1024 between 8-row groups along k, and one 64-wide atom
// along n (its offset never used: both fields 1024); a k-step of 16 rows
// moves the start by 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile,
                                                int kk) {
  return desc_sw128(tile + 32 * kk, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile,
                                                 int kk) {
  return desc_sw128(tile + 2048 * kk, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
// (conv_wgmma.cuh)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that writes it
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FW_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define FW_D64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"
#define FW_D8(m, d, o)                                                     \
  m(d[o]), m(d[o + 1]), m(d[o + 2]), m(d[o + 3]), m(d[o + 4]),             \
      m(d[o + 5]), m(d[o + 6]), m(d[o + 7])
#define FW_D(m, d) \
  FW_D8(m, d, 0), FW_D8(m, d, 8), FW_D8(m, d, 16), FW_D8(m, d, 24)
#define FW_DD(m, d)                                                        \
  FW_D(m, d), FW_D8(m, d, 32), FW_D8(m, d, 40), FW_D8(m, d, 48),           \
      FW_D8(m, d, 56)
#define FW_IN(x) "+f"(x)
#define FW_OUT(x) "=f"(x)
#define FW_SS ", %32, %33, p, 1, 1, 0, 0;\n"
#define FW_SS128 ", %64, %65, p, 1, 1, 0, 0;\n"
#define FW_RS ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
#define FW_TA ", %32, %33, p, 1, 1, 1, 0;\n"

// d = A B (kAcc false: the old d is not read) or d += A B for one
// 64 x 64 x 16 step, A and B from shared memory, both K-major.
template <bool kAcc>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FW_D32 FW_SS
        "}\n"
        : FW_D(FW_IN, d)
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FW_D32 FW_SS
        "}\n"
        : FW_D(FW_OUT, d)
        : "l"(a), "l"(b), "r"(0));
  }
}

// The same for a 64 x 128 x 16 step (B 128 rows: two 64-row boxes).
template <bool kAcc>
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t a,
                                            uint64_t b) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FW_D64
            FW_SS128 "}\n"
        : FW_DD(FW_IN, d)
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FW_D64
            FW_SS128 "}\n"
        : FW_DD(FW_OUT, d)
        : "l"(a), "l"(b), "r"(0));
  }
}

// d = A B or d += A B for one 64 x 64 x 16 step with A from registers
// (the mma.sync m16n8k16 A fragment of the warp's 16 rows: a[0] =
// A[g][2t..], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3] =
// A[g+8][2t+8..]) and B MN-major in shared memory (wgmma's transpose
// bit).
template <bool kAcc>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FW_D32 FW_RS
        "}\n"
        : FW_D(FW_IN, d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FW_D32 FW_RS
        "}\n"
        : FW_D(FW_OUT, d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
}

// d += A B for one 64 x 64 x 16 step: A MN-major (m contiguous, wgmma's
// transpose bit for A) and B K-major, both from shared memory
// (conv_wgmma.cuh; d accumulates in place)
__device__ __forceinline__ void wgmma_ta64(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FW_D32 FW_TA
      "}\n"
      : FW_D(FW_IN, d)
      : "l"(a), "l"(b), "r"(1));
}

// the same for a 64 x 32 x 16 step with A MN-major
__device__ __forceinline__ void wgmma_ta32(float (&d)[16], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 1, 0;\n"
      "}\n"
      : FW_D8(FW_IN, d, 0), FW_D8(FW_IN, d, 8)
      : "l"(a), "l"(b), "r"(1));
}

#undef FW_D32
#undef FW_D64
#undef FW_D8
#undef FW_D
#undef FW_DD
#undef FW_IN
#undef FW_OUT
#undef FW_SS
#undef FW_SS128
#undef FW_RS
#undef FW_TA

// d = A B over head_dim (kSteps k-steps): A the warpgroup's 64 rows, B a
// box's 64 rows, both K-major [rows][64] tiles
__device__ __forceinline__ void scores(float (&d)[32], const uint8_t* a,
                                       const uint8_t* b) {
  wgmma_ss<false>(d, desc_kmajor(a, 0), desc_kmajor(b, 0));
#pragma unroll
  for (int kk = 1; kk < kSteps; ++kk)
    wgmma_ss<true>(d, desc_kmajor(a, kk), desc_kmajor(b, kk));
}

// The same with B two stacked boxes: 64 rows x 128 columns
__device__ __forceinline__ void scores128(float (&d)[64], const uint8_t* a,
                                          const uint8_t* b) {
  wgmma_ss128<false>(d, desc_kmajor(a, 0), desc_kmajor(b, 0));
#pragma unroll
  for (int kk = 1; kk < kSteps; ++kk)
    wgmma_ss128<true>(d, desc_kmajor(a, kk), desc_kmajor(b, kk));
}

// d = A B over 16 KS rows of B (KS k-steps): A the bfloat16 fragments
// from an accumulator (acc_as_a), B an MN-major [16 KS][64] tile (one
// box a 4 k-steps)
template <int KS>
__device__ __forceinline__ void products(float (&d)[32],
                                         const uint32_t (&a)[KS][4],
                                         const uint8_t* b) {
  wgmma_rs_mn<false>(d, a[0], desc_mnmajor(b, 0));
#pragma unroll
  for (int kk = 1; kk < KS; ++kk)
    wgmma_rs_mn<true>(d, a[kk], desc_mnmajor(b, kk));
}

// 2^x by one MUFU.EX2, a result below 2^-126 flushed to 0: exp2f's
// non-ftz form spends three more instructions on that range, where p
// (at most 2^-126) adds nothing a float32 sum of the tile can hold
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two float32 values rounded to bfloat16 (to nearest even), lo in the
// low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragments of k-steps 0..KS-1 from a 64 x 16 KS accumulator, rounded
// to bfloat16: k-step kk takes columns 16kk .. 16kk + 15 (n-tiles 2kk
// and 2kk + 1)
template <int KS>
__device__ __forceinline__ void acc_as_a(const float (&c)[8 * KS],
                                         uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack2(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack2(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack2(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack2(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Store the thread's row half h of a 64 x 64 accumulator times `mul`,
// rounded to bfloat16, columns below D.
__device__ __forceinline__ void store_half(__nv_bfloat16* row,
                                           const float (&acc)[32], int h,
                                           int t, int D, float mul) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = 8 * j + 2 * t;  // D is a multiple of 8: d + 1 < D too
    if (d < D)
      *reinterpret_cast<uint32_t*>(row + d) =
          pack2(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once (no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [BH, S, D] bfloat16 rows as a 3-D map of 64-column x 64-row boxes with
// 128-byte swizzle; elements outside [BH, S, D] load as zeros
cudaError_t encode_rows(CUtensorMap* map, const void* p, int BH, int S,
                        int D) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {kDP, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a [outer, inner] bfloat16 matrix (inner contiguous; inner * 2 bytes a
// multiple of 16, p 16-byte aligned) as a 2-D map of box_inner x
// box_outer boxes with 128-byte swizzle; elements outside the matrix load
// as zeros (conv_wgmma.cuh's weight tiles)
cudaError_t encode_2d(CUtensorMap* map, const void* p, int inner, int outer,
                      int box_inner, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash_wgmma
