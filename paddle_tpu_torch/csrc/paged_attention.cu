// Ragged paged attention on float32 or bfloat16 pages, for Hopper
// (sm_90a): split-K over the keys (flash-decoding), CUDA-core decode
// paths and 3xTF32 tensor-core chunked-prefill paths, and a merge kernel.
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/fluid/ops/pallas_kernels/paged_attention.py:_paged_kernel
//   (body :168, launched by _paged_attention_pallas, pallas_call :268)
// and computes the same function as the plain version
//   paddle_tpu_torch/kernels/paged_attention.py:paged_attention_reference
// over the same layouts: q [B, C, Hq, D], pools [P, page_size, Hkv, D],
// page tables [B, W], kv_lens and q_lens [B] (int32), out [B, C, Hq, D].
// Query lane j of slot b sees keys at positions <= kv_len - q_len + j
// (and < W * page_size); dead slots (q_len == 0) and dead lanes
// (j >= q_len) give exact zeros; query head h reads kv head h / (Hq /
// Hkv) (GQA); a row's output is its P V over max(l, FLT_MIN). Any
// head_dim: up to 256 in paged_split_kernel below, 257 to 512 in the two
// bodies of paged_wide.cuh, above 512 in paged_wide_kernel.
//
// The work of one (slot b, kv head g): its query rows are the
// (lane c, head of group g) pairs, row r = c * rep + h % rep, the first
// q_len * rep of them live. Its keys are cut into splits of `split`
// keys by absolute position (split s holds keys [s * split, (s + 1) *
// split)): the partition depends on the slot's own key positions and
// the split length only, which the wrapper takes from head_dim alone
// (kernels/paged_attention.py:split_keys), never from B, W, C or the
// card.
//
//   paged_split_kernel  head_dim up to 256, grid (B * Hkv, ceil(C * rep
//     / 64), n_splits).
//     Block (b, g, y, s) computes, for each of its live rows that sees a
//     key of split s, the split's partial (m, l, acc[D]) of the online
//     softmax (m in units of s * scale * log2(e)) and writes it to a
//     scratch the wrapper allocates; a block whose split starts past the
//     last key its rows see exits at once. Two paths, chosen from the
//     slot's own live-row count q_len * rep (never from C, so a decode
//     slot computes the same bits in a C = 1 launch and beside prefill
//     chunks in a C = 64 launch):
//     decode (q_len * rep <= 16; 8 at head_dim > 128): block y = 0 owns
//       every live row, and its 4 warps take disjoint key sub-ranges of
//       each 32-key tile (warp w keys 8w..8w+7), each warp with its own
//       online-softmax state for every live row; 4 lanes score one key
//       (float4 dot products, a 2-shuffle butterfly), a lane owns output
//       columns lane + 32e. The four warps' states are merged in shared
//       memory in the order 0, 1, 2, 3. No warp works on a dead row.
//     chunk (more live rows): 64 rows a block, 16 a warp, on the tensor
//       cores as K2 (flash_attention.cu): S = Q K^T and P V as 3xTF32
//       mma.sync m16n8k8 (tf32x3.cuh), the online softmax on the score
//       fragments in the exp2 domain (masked scores -inf, so p = 0
//       exactly), each tile's P V in fresh fragments merged as
//       O = O alpha + O_tile by float32 FMAs.
//     Both paths gather each 32-key K/V tile through the page table with
//     cp.async (a key's D values of head g are contiguous in the pool,
//     so each key row's copies are coalesced) into a ring of tile
//     buffers (Ring): the next tiles' bytes are in flight while one is
//     scored. The split's page-table reads are done first, all together,
//     into a shared table of key offsets, so no copy waits on a table
//     read. Columns head_dim..bucket are zero-filled in shared memory
//     (buckets 32, 64, 128, 256); keys past the block's last visible key
//     are zero-filled and never read, so padded or invisible pages cost
//     nothing.
//   wide_decode_kernel, wide_chunk_kernel (paged_wide.cuh)  head_dim 257
//     to 512: a decode body for slots of up to 4 live rows (all D
//     columns a block, 8 warps on 8-key stages of a cp.async ring) and a
//     3xTF32 chunk body whose two warp groups split O's columns.
//   paged_wide_kernel  head_dim above 512, grid (B * Hkv, ceil(C * rep /
//     16) * n_slices, n_splits): a block computes one 256-column slice
//     of the output (the y axis carries the slices) for 16 rows, 4 a
//     warp, lane j scoring key j of each 32-key tile, lane l owning the
//     slice's columns l, l + 32, ...; every block computes its scores
//     over the whole head_dim in 256-column chunks (Q rows and K tile
//     staged through shared memory by plain loads, through the split's
//     shared offsets table), in the order 0, 256, ..., so every slice
//     computes the same (m, l) bit for bit; slice 0 writes them. Any
//     q_len * rep; masked keys give p = 0 exactly, as above.
//   paged_merge_kernel  one warp a row and 32 of its columns: merges the
//     row's partials of the splits it sees (weights exp2(m_s - M); M and
//     l by fixed butterflies over the splits, each column in the order
//     s = 0, 1, ...), divides by max(l, FLT_MIN) and writes O; a dead
//     row gets exact zeros. No atomics anywhere, so two launches give
//     bitwise-equal outputs, and a slot's output does not depend on the
//     batch around it.
//
// What bounds it on this card. Decode (one query row per kv head, or a
// few under GQA) does ~2 flops per byte of K/V: bytes-bound, its floor
// is the visible K/V bytes over 3.35 TB/s. The earlier design reached
// 1/17 of that: one block per (slot, kv head) walked 512-1024 keys in
// order with synchronous loads (16 blocks for a one-slot request on 132
// SMs).
// Split-K gives 4 blocks per (slot, kv head) at 1024 keys (256-key
// splits up to head_dim 256), each block keeps tiles in flight while it
// scores one, and two blocks share an SM at head_dim 64. The chunk path
// (C = 64 prefill) does ~64 flops a byte under MHA: operations-bound, on
// the tensor cores at 3x the TF32 rate, with split-K so that even one
// slot fills the card. The merge reads and writes n_splits * rows * D
// floats more: small at decode, at prefill about as many bytes as Q and
// O.
//
// bfloat16 pages (paged_attention_bf16; the Pallas kernel's astype on
// load, :188-190): every kernel is templated on the page element type.
// The K/V tiles are staged in the page's own dtype by cp.async, in the
// widest unit the row's alignment allows (page_copy_bytes: 16 bytes when
// head_dim % 8 == 0, 8 when % 4 == 0, 4 when even; an odd head_dim one
// value by a plain load), and widened to float32 as they are read from
// shared memory: a decode dot reads 4 bf16 as 8 bytes, the chunk path
// widens as it builds its B fragments. Half the bytes a tile: the ring
// and the arithmetic are the f32 form's with every value widened
// exactly, so at head_dim up to 256 the output is bitwise the output of
// widening into float32 tiles; in the chunk path a bf16 value is exact
// in TF32 (its small part is 0), so its products drop the a_big *
// b_small term, a sum of zeros (mma2x4). Q and the output are float32
// or bfloat16 on either page type (q_bf16): Q widens as it is staged,
// the merge rounds O to nearest even as it writes it (the output takes
// Q's dtype). paged_wide_kernel (above 512) loads bf16 rows by plain
// loads.
//
// The kernels allocate nothing; the caller passes the output and the
// scratch. paged_attention_f32 and paged_attention_bf16 launch the
// kernels on the given stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;                  // rows a chunk-path block owns
constexpr int kTile = 32;                  // keys per staged tile
constexpr int kKeysPerWarp = kTile / kWarps;    // decode path: 8
constexpr int kParts = 32 / kKeysPerWarp;       // lanes scoring a key: 4
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// The shared memory of paged_split_kernel at bucket DP on TK pages: Q's
// kRows float32 rows, then the K and V rings of kStages tiles in the
// pages' own dtype, then the split's key offsets.
//   float32 pages: 4 tile buffers up to the 64 bucket (3 tiles in flight
//     while one is scored), 2 above; rows of DP + 4 = 4 (mod 32) floats.
//   bf16 pages: half the bytes a tile. Up to the 64 bucket 3 buffers,
//     so that four blocks share an SM (48 KB each; the registers allow
//     four): on the card more resident blocks beat a deeper ring there
//     (8 buffers, two blocks an SM, were slower at decode; PERF.md).
//     Above, 4 buffers (two blocks an SM at 128, one at 256). Row
//     strides by path, in bf16: the decode path reads 4 columns (8
//     bytes) of 4 keys a half-warp, conflict-free at DP + 16 (8 (mod 32)
//     words a row); the chunk path's fragment loads (rows g, columns t;
//     rows 2t, columns g) at DP + 8 (4 (mod 8) words a row).
template <int DP, typename TK>
struct Ring {
  static constexpr bool kBf16 = sizeof(TK) == 2;
  static constexpr int kStages = kBf16 ? (DP <= 64 ? 3 : 4)
                                       : (DP <= 64 ? 4 : 2);
  static constexpr int kLDQ = DP + 4;  // Q rows, float32
  static constexpr int kLDDec = kBf16 ? DP + 16 : DP + 4;
  static constexpr int kLDChunk = kBf16 ? DP + 8 : DP + 4;
  // bytes a K (or V) tile buffer, at the larger stride
  static constexpr int kTileBytes = kTile * kLDDec * int(sizeof(TK));
  // bytes before the key offsets: Q rows, then the K and V rings
  static constexpr int kBytes = kRows * kLDQ * 4 + 2 * kStages * kTileBytes;
};

// What one block of paged_split_kernel works on. q is float32 or bf16
// (q_bf16); the pools are float32 or bf16 (the kernels' template TK).
struct Work {
  const void* q;
  const void* kp;
  const void* vp;
  bool q_bf16;
  const int* table;       // the slot's row of the page tables
  float* part_ml;         // [n_splits][NR][2]: m, l
  float* part_acc;        // [n_splits][NR][D]
  int64_t NR;             // output rows B * C * Hq
  int C, Hq, Hkv, D, ps, T, split;
  int b, g, rep, q_len, kv_len, n_live, s, s0;
  int vb;                 // bytes a page copy unit (page_copy_bytes)
  float c;                // scale * log2(e)
};

// The last key slot-row r sees (-1: none). Rows are lane-major, so the
// limit never falls as r grows.
__device__ __forceinline__ int row_limit(const Work& w, int r) {
  if (r >= w.n_live) return -1;
  return min(w.kv_len - w.q_len + r / w.rep, w.T - 1);
}

// The output row of slot-row r: (b, lane r / rep, head g * rep + r % rep).
__device__ __forceinline__ int64_t row_id(const Work& w, int r) {
  return (static_cast<int64_t>(w.b) * w.C + r / w.rep) * w.Hq +
         w.g * w.rep + r % w.rep;
}

// The Work of block (b * Hkv + g, y, s) of a launch: the slot's lengths
// and table row, its live rows, split s. vb: bytes a page copy unit
// (page_copy_bytes; 0 where the kernel loads page rows by plain loads).
__device__ __forceinline__ Work make_work(
    const void* q, bool q_bf16, const void* k_pages, const void* v_pages,
    const int* tables, const int* kv_lens, const int* q_lens,
    float* part_ml, float* part_acc, int C, int Hq, int Hkv, int D, int ps,
    int W, int split, int vb, float scale) {
  Work w;
  w.q = q;
  w.q_bf16 = q_bf16;
  w.kp = k_pages;
  w.vp = v_pages;
  w.part_ml = part_ml;
  w.part_acc = part_acc;
  w.C = C;
  w.Hq = Hq;
  w.Hkv = Hkv;
  w.D = D;
  w.ps = ps;
  w.T = W * ps;
  w.split = split;
  w.b = blockIdx.x / Hkv;
  w.g = blockIdx.x % Hkv;
  w.NR = static_cast<int64_t>(gridDim.x / Hkv) * C * Hq;
  w.table = tables + static_cast<int64_t>(w.b) * W;
  w.rep = Hq / Hkv;
  w.q_len = q_lens[w.b];
  w.kv_len = kv_lens[w.b];
  w.n_live = max(0, min(w.q_len, C)) * w.rep;
  w.s = blockIdx.z;
  w.s0 = w.s * split;
  w.vb = vb;
  w.c = scale * kLog2e;
  return w;
}


// One copy unit of a row into float32 shared memory: 4 columns at
// column 4 * part (kVec), else 1 column at column `part`. A null source,
// or columns at or past D, write zeros and read nothing. float32 rows go
// by cp.async (`any` is a valid address for the zero-fill); bf16 rows (Q)
// by a plain 8-byte (or 2-byte) load, widened in registers.
template <bool kVec>
__device__ __forceinline__ void copy_unit(float* dst_row,
                                          const float* src_row, int part,
                                          int D, const float* any) {
  if constexpr (kVec) {
    const int col = 4 * part;
    const bool ok = src_row != nullptr && col < D;
    cp_async16(dst_row + col, ok ? src_row + col : any, ok ? 16 : 0);
  } else {
    const bool ok = src_row != nullptr && part < D;
    cp_async4(dst_row + part, ok ? src_row + part : any, ok ? 4 : 0);
  }
}

template <bool kVec>
__device__ __forceinline__ void copy_unit(float* dst_row,
                                          const bf16* src_row, int part,
                                          int D, const bf16*) {
  if constexpr (kVec) {
    const int col = 4 * part;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src_row != nullptr && col < D) {
      const uint2 u = *reinterpret_cast<const uint2*>(src_row + col);
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      f = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    *reinterpret_cast<float4*>(dst_row + col) = f;
  } else {
    dst_row[part] = src_row != nullptr && part < D
                        ? __bfloat162float(src_row[part])
                        : 0.f;
  }
}

// cp.async of 8 bytes (the 16- and 4-byte forms are tf32x3.cuh's)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

// One copy unit of a bf16 page row into bf16 shared memory, in the
// page's own dtype: vb bytes (16, 8 or 4: vb / 2 columns at column
// unit * vb / 2) by cp.async, or, at an odd head_dim (vb 2), one column
// by a plain load. A null source, or columns at or past D, write zeros
// and read nothing (vb divides the row's bytes, so a unit is all in or
// all out).
__device__ __forceinline__ void copy_raw(bf16* dst_row, const bf16* src_row,
                                         int unit, int D, int vb,
                                         const bf16* any) {
  const int col = unit * (vb >> 1);
  const bool ok = src_row != nullptr && col < D;
  const void* src = ok ? src_row + col : any;
  const int n = ok ? vb : 0;
  if (vb == 16)
    cp_async16(reinterpret_cast<float*>(dst_row + col),
               static_cast<const float*>(src), n);
  else if (vb == 8)
    cp_async8(dst_row + col, src, n);
  else if (vb == 4)
    cp_async4(reinterpret_cast<float*>(dst_row + col),
              static_cast<const float*>(src), n);
  else
    dst_row[col] = ok ? src_row[col] : __float2bfloat16_rn(0.f);
}

// Slot-rows [r0, r0 + n) of q into n shared rows (dead rows: zeros).
template <int DP, bool kVec, typename TQ>
__device__ __forceinline__ void stage_q_as(const Work& w, float* qs, int r0,
                                           int n) {
  constexpr int LD = DP + 4, U = kVec ? DP / 4 : DP;
  const TQ* q = static_cast<const TQ*>(w.q);
  for (int i = threadIdx.x; i < n * U; i += kThreads) {
    const int rr = i / U;
    const int r = r0 + rr;
    const TQ* src = r < w.n_live ? q + row_id(w, r) * w.D : nullptr;
    copy_unit<kVec>(qs + rr * LD, src, i % U, w.D, q);
  }
}

template <int DP, bool kVec>
__device__ __forceinline__ void stage_q(const Work& w, float* qs, int r0,
                                        int n) {
  if (w.q_bf16)
    stage_q_as<DP, kVec, bf16>(w, qs, r0, n);
  else
    stage_q_as<DP, kVec, float>(w, qs, r0, n);
}

// The split's key offsets into the pools (head g's row of key s0 + i),
// -1 past `end`: one page-table read a key, all issued together, so no
// tile's copies wait on a table read (the cp.async asm orders memory).
template <int NT = kThreads>
__device__ __forceinline__ void key_offsets(const Work& w, int64_t* offs,
                                            int end) {
  for (int i = threadIdx.x; i < w.split; i += NT) {
    const int t = w.s0 + i;
    int64_t off = -1;
    if (t < end) {
      const int64_t page = w.table[t / w.ps];
      off = ((page * w.ps + t % w.ps) * w.Hkv + w.g) * w.D;
    }
    offs[i] = off;
  }
}

// Tile `it` of the split (its keys s0 + 32 it ..) into shared rows of K
// and V at stride LD; keys past the last visible one are zeros and are
// not read. float32 pages as float32 (16- or 4-byte cp.async by kVec);
// bf16 pages as bf16 (w.vb bytes a copy).
template <int DP, bool kVec, int LD, typename TK>
__device__ __forceinline__ void stage_kv(const Work& w, TK* ks, TK* vs,
                                         const int64_t* offs, int it) {
  const TK* kp = static_cast<const TK*>(w.kp);
  const TK* vp = static_cast<const TK*>(w.vp);
  if constexpr (sizeof(TK) == 4) {
    constexpr int U = kVec ? DP / 4 : DP;
    for (int i = threadIdx.x; i < kTile * U; i += kThreads) {
      const int key = i / U;
      const int64_t off = offs[it * kTile + key];
      copy_unit<kVec>(ks + key * LD, off >= 0 ? kp + off : nullptr, i % U,
                      w.D, kp);
      copy_unit<kVec>(vs + key * LD, off >= 0 ? vp + off : nullptr, i % U,
                      w.D, kp);
    }
  } else {
    // DP / (vb / 2) units a row: a power of two
    const int ush = __ffs(DP * 2 / w.vb) - 1;
    const int umask = (1 << ush) - 1;
    for (int i = threadIdx.x; i < kTile << ush; i += kThreads) {
      const int key = i >> ush;
      const int64_t off = offs[it * kTile + key];
      copy_raw(ks + key * LD, off >= 0 ? kp + off : nullptr, i & umask, w.D,
               w.vb, kp);
      copy_raw(vs + key * LD, off >= 0 ? vp + off : nullptr, i & umask, w.D,
               w.vb, kp);
    }
  }
}

// The K and V tile buffers of the ring, at byte offsets of Ring<DP, TK>.
template <int DP, typename TK>
__device__ __forceinline__ TK* k_ring(float* smem) {
  return reinterpret_cast<TK*>(reinterpret_cast<char*>(smem) +
                               kRows * Ring<DP, TK>::kLDQ * 4);
}

template <int DP, typename TK>
__device__ __forceinline__ TK* v_ring(float* smem) {
  using R = Ring<DP, TK>;
  return reinterpret_cast<TK*>(reinterpret_cast<char*>(smem) +
                               kRows * R::kLDQ * 4 +
                               R::kStages * R::kTileBytes);
}

// Q's rows and the split's key offsets, then the first kStages - 1
// tiles (one commit group each; Q joins tile 0's).
template <int DP, bool kVec, int LD, typename TK>
__device__ __forceinline__ void prologue(const Work& w, float* smem,
                                         int r0, int nq, int n_keys,
                                         int n_tiles) {
  using R = Ring<DP, TK>;
  TK* kb = k_ring<DP, TK>(smem);
  TK* vb = v_ring<DP, TK>(smem);
  int64_t* offs = reinterpret_cast<int64_t*>(
      reinterpret_cast<char*>(smem) + R::kBytes);
  stage_q<DP, kVec>(w, smem, r0, nq);
  key_offsets(w, offs, w.s0 + n_keys);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < R::kStages - 1; ++p) {
    if (p < n_tiles)
      stage_kv<DP, kVec, LD, TK>(w, kb + p * kTile * LD, vb + p * kTile * LD,
                                 offs, p);
    cp_async_commit();
  }
}

// Top of pipeline step `it`: tile it has landed and every warp is done
// with tile it - 1, whose buffer then takes tile it + kStages - 1.
template <int DP, bool kVec, int LD, typename TK>
__device__ __forceinline__ void advance(const Work& w, float* smem, int it,
                                        int n_tiles) {
  using R = Ring<DP, TK>;
  TK* kb = k_ring<DP, TK>(smem);
  TK* vb = v_ring<DP, TK>(smem);
  const int64_t* offs = reinterpret_cast<const int64_t*>(
      reinterpret_cast<const char*>(smem) + R::kBytes);
  cp_async_wait<R::kStages - 2>();
  __syncthreads();
  const int nt = it + R::kStages - 1;
  if (nt < n_tiles) {
    const int b = nt % R::kStages;
    stage_kv<DP, kVec, LD, TK>(w, kb + b * kTile * LD, vb + b * kTile * LD,
                               offs, nt);
  }
  cp_async_commit();
}

// Four columns of a shared K row as float32 (a bf16 row: 8 bytes,
// widened), and one column of a V row.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// ------------------------------------------------------------- decode
// The slot's MR (>= n_live) rows, n_keys keys of split s from s0. Warp w
// scores keys 8w..8w+7 of each tile: lane = 4 * key + part, part p sums
// columns 4p + 16m .. +3 of the dot product.
template <int DP, bool kVec, int MR, typename TK>
__device__ __forceinline__ void decode_path(const Work& w, float* smem,
                                            int n_keys) {
  using R = Ring<DP, TK>;
  constexpr int LQ = R::kLDQ, LD = R::kLDDec, NE = DP / 32;
  constexpr int NM = DP / (4 * kParts);
  const float* qs = smem;                  // [MR][LQ]
  TK* kb = k_ring<DP, TK>(smem);           // [kStages][kTile][LD]
  TK* vb = v_ring<DP, TK>(smem);           // [kStages][kTile][LD]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  prologue<DP, kVec, LD, TK>(w, smem, 0, MR, n_keys, n_tiles);

  int limit[MR];
  float m[MR], l[MR], acc[MR][NE];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    limit[i] = row_limit(w, i);
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }
  const int kj = warp * kKeysPerWarp + lane / kParts;  // the lane's key
  const int part = lane % kParts;

  for (int it = 0; it < n_tiles; ++it) {
    advance<DP, kVec, LD, TK>(w, smem, it, n_tiles);
    const TK* kt = kb + (it % R::kStages) * kTile * LD;
    const TK* vt = vb + (it % R::kStages) * kTile * LD;
    const int t = w.s0 + it * kTile + kj;

    // the lane's share of q_i . k_t, then the sum over the key's 4 lanes
    float s[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) s[i] = 0.f;
    const TK* kr = kt + kj * LD;
#pragma unroll
    for (int mm = 0; mm < NM; ++mm) {
      const int d = 4 * (part + kParts * mm);
      const float4 kv = load4(kr + d);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + i * LQ + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    // online softmax over the warp's 8 keys (lanes xor 4, 8, 16), in
    // units of s * scale * log2(e); a masked key gives p = 0 exactly
    float p[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      float x = s[i] + __shfl_xor_sync(0xffffffffu, s[i], 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      x = t <= limit[i] ? x * w.c : -INFINITY;
      float mx = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      p[i] = exp2f(x - m_new);
      float ps = p[i] + __shfl_xor_sync(0xffffffffu, p[i], 4);
      ps += __shfl_xor_sync(0xffffffffu, ps, 8);
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      l[i] = fmaf(l[i], alpha, ps);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= alpha;
    }

    // acc_i += sum over the warp's keys of p_i V; lane owns lane + 32e
#pragma unroll
    for (int jj = 0; jj < kKeysPerWarp; ++jj) {
      const TK* vr = vt + (warp * kKeysPerWarp + jj) * LD;
      float vv[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) vv[e] = widen(vr[lane + 32 * e]);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], jj * kParts);
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[i][e] = fmaf(pj, vv[e], acc[i][e]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the tiles: reuse them

  // the warps' states, merged in the order 0..3 into the split's partial
  float* wm = reinterpret_cast<float*>(kb);  // [kWarps][MR]
  float* wl = wm + kWarps * MR;            // [kWarps][MR]
  float* wacc = wl + kWarps * MR;          // [kWarps][MR][DP]
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (lane == 0) {
      wm[warp * MR + i] = m[i];
      wl[warp * MR + i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < NE; ++e)
      wacc[(warp * MR + i) * DP + lane + 32 * e] = acc[i][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < MR * DP; idx += kThreads) {
    const int i = idx / DP, d = idx % DP;
    if (d >= w.D || row_limit(w, i) < w.s0) continue;
    float M = wm[i];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) M = fmaxf(M, wm[v * MR + i]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float wt = exp2f(wm[v * MR + i] - M);
      L = fmaf(wl[v * MR + i], wt, L);
      A = fmaf(wacc[(v * MR + i) * DP + d], wt, A);
    }
    const int64_t at = w.s * w.NR + row_id(w, i);
    w.part_acc[at * w.D + d] = A;
    if (d == 0) {
      w.part_ml[2 * at] = M;
      w.part_ml[2 * at + 1] = L;
    }
  }
}

// -------------------------------------------------------------- chunk
// The products' B operands, four n-tiles at a time. From a float32 tile:
// big and small parts, 3xTF32 (tf32x3.cuh's mma3x4). From a bf16 tile: a
// bf16 value is exact in TF32 (8 significant bits of TF32's 11), so its
// big part is its own bits and its small part is 0, and the product
// a_big * b_small that 3xTF32 would add is a sum of zeros: two products,
// a_small * b_big then a_big * b_big, in mma3x4's order.
__device__ __forceinline__ uint32_t tf32_bits(bf16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

__device__ __forceinline__ void mma2x4(float (&d0)[4], float (&d1)[4],
                                       float (&d2)[4], float (&d3)[4],
                                       const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const uint32_t (&bb)[4][2]) {
  mma_tf32(d0, as, bb[0]);
  mma_tf32(d1, as, bb[1]);
  mma_tf32(d2, as, bb[2]);
  mma_tf32(d3, as, bb[3]);
  mma_tf32(d0, ab, bb[0]);
  mma_tf32(d1, ab, bb[1]);
  mma_tf32(d2, ab, bb[2]);
  mma_tf32(d3, ab, bb[3]);
}

// d[i] += A K^T for the n-tiles i = 0..3 (keys 8i .. 8i + 7) of k-step
// kk: A the warp's Q fragment, K a [kTile][ld] tile.
__device__ __forceinline__ void score4(float (*d)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const float* kt, int ld, int kk,
                                       int g, int t) {
  uint32_t bb[4][2], bs[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) load_bt(kt, ld, i, kk, g, t, bb[i], bs[i]);
  mma3x4(d[0], d[1], d[2], d[3], ab, as, ab, as, ab, as, ab, as, bb, bs);
}

__device__ __forceinline__ void score4(float (*d)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const bf16* kt, int ld, int kk,
                                       int g, int t) {
  uint32_t bb[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bf16* p = kt + (8 * i + g) * ld + 8 * kk + t;
    bb[i][0] = tf32_bits(p[0]);
    bb[i][1] = tf32_bits(p[4]);
  }
  mma2x4(d[0], d[1], d[2], d[3], ab, as, bb);
}

// d[i] += P V for O's n-tiles n + i, i = 0..3, over k-step kk (the
// tile's keys 8 kk .., permuted as acc_as_a leaves P): V a [kTile][ld]
// tile.
__device__ __forceinline__ void pv4(float (*d)[4], const uint32_t (&ab)[4],
                                    const uint32_t (&as)[4], const float* vt,
                                    int ld, int kk, int n, int g, int t) {
  uint32_t bb[4][2], bs[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) load_bp(vt, ld, kk, n + i, g, t, bb[i], bs[i]);
  mma3x4(d[0], d[1], d[2], d[3], ab, as, ab, as, ab, as, ab, as, bb, bs);
}

__device__ __forceinline__ void pv4(float (*d)[4], const uint32_t (&ab)[4],
                                    const uint32_t (&as)[4], const bf16* vt,
                                    int ld, int kk, int n, int g, int t) {
  uint32_t bb[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bf16* p = vt + (8 * kk + 2 * t) * ld + 8 * (n + i) + g;
    bb[i][0] = tf32_bits(p[0]);
    bb[i][1] = tf32_bits(p[ld]);
  }
  mma2x4(d[0], d[1], d[2], d[3], ab, as, bb);
}

// Slot-rows [r0, r0 + 64), 16 a warp (the m16 side of every product),
// n_keys keys of split s from s0, in 32-key tiles.
template <int DP, bool kVec, typename TK>
__device__ __forceinline__ void chunk_path(const Work& w, float* smem,
                                           int r0, int n_keys) {
  using R = Ring<DP, TK>;
  constexpr int LQ = R::kLDQ, LD = R::kLDChunk;
  constexpr int KS = DP / 8;               // k-steps of S = n-tiles of O
  constexpr int NT = kTile / 8;            // n-tiles of S = k-steps of P V
  constexpr int NC = KS < 8 ? KS : 8;      // O's n-tiles a fresh P V holds
  const float* qs = smem;                  // [kRows][LQ]
  TK* kb = k_ring<DP, TK>(smem);           // [kStages][kTile][LD]
  TK* vb = v_ring<DP, TK>(smem);           // [kStages][kTile][LD]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  prologue<DP, kVec, LD, TK>(w, smem, r0, kRows, n_keys, n_tiles);

  const int rw = warp * 16;                // the warp's first row
  const float* qw = qs + rw * LQ;
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lim[h] = row_limit(w, r0 + rw + g + 8 * h);
  // the last key any row of the warp sees
  const int warp_hi = r0 + rw < w.n_live
                          ? row_limit(w, min(r0 + rw + 15, w.n_live - 1))
                          : -1;

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    advance<DP, kVec, LD, TK>(w, smem, it, n_tiles);
    const int t0 = w.s0 + it * kTile;
    if (t0 > warp_hi) continue;  // no row of the warp sees the tile
    const TK* kt = kb + (it % R::kStages) * kTile * LD;
    const TK* vt = vb + (it % R::kStages) * kTile * LD;

    // S = Q K^T: the warp's 16 rows x 32 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4], as[4];
      load_a(qw, LQ, kk, g, t, ab, as);
      score4(s, ab, as, kt, LD, kk, g, t);
    }

    // masked scores -inf; then the online softmax on the fragments: the
    // row max over the quad's 4 lanes, p = 2^(s c - m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (t0 + 8 * j + 2 * t + (e & 1) > lim[e >> 1]) s[j][e] = -INFINITY;
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * w.c);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], w.c, -m[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O = O alpha + P V: each tile's P V in fresh fragments (k over the
    // tile's keys, permuted), NC n-tiles at a time, merged by FMAs
#pragma unroll
    for (int n0 = 0; n0 < KS; n0 += NC) {
      float to[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) to[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t pbig[4], psml[4];
        acc_as_a(s[j], pbig, psml);
#pragma unroll
        for (int n = 0; n < NC; n += 4)
          pv4(to + n, pbig, psml, vt, LD, j, n0 + n, g, t);
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e >> 1], to[n][e]);
    }
  }
  cp_async_wait_all();

  // the split's partial of each row that sees one of its keys: the row
  // sum over the quad's lanes, acc columns 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (lim[h] < w.s0) continue;  // dead, or sees no key of the split
    const int64_t at = w.s * w.NR + row_id(w, r0 + rw + g + 8 * h);
    float* a = w.part_acc + at * w.D;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < w.D) a[d] = acc[n][2 * h];
      if (d + 1 < w.D) a[d + 1] = acc[n][2 * h + 1];
    }
    if (t == 0) {
      w.part_ml[2 * at] = m[h];
      w.part_ml[2 * at + 1] = sum;
    }
  }
}

// grid (B * Hkv, ceil(C * rep / 64), n_splits); see the head comment.
// DP: head_dim's bucket (32, 64, 128, 256); kVec: head_dim % 4 == 0;
// TK: the pools' element type (float or bf16).
template <int DP, bool kVec, typename TK>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const void* __restrict__ q, bool q_bf16,
                   const TK* __restrict__ k_pages,
                   const TK* __restrict__ v_pages,
                   const int* __restrict__ tables,
                   const int* __restrict__ kv_lens,
                   const int* __restrict__ q_lens,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int C, int Hq, int Hkv, int D, int ps, int W, int split,
                   int vb, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Work w = make_work(q, q_bf16, k_pages, v_pages, tables, kv_lens,
                           q_lens, part_ml, part_acc, C, Hq, Hkv, D, ps, W,
                           split, vb, scale);

  // live rows up to which a slot takes the decode path (at 256 columns
  // 16 rows' accumulators would take 128 registers a lane)
  constexpr int kDec = DP <= 128 ? 16 : 8;
  if (w.n_live <= kDec) {
    if (blockIdx.y != 0 || w.n_live == 0) return;
    const int n_keys = min(row_limit(w, w.n_live - 1) + 1 - w.s0, split);
    if (n_keys <= 0) return;  // the split starts past every visible key
    if (w.n_live == 1)
      decode_path<DP, kVec, 1, TK>(w, smem, n_keys);
    else if (w.n_live <= 4)
      decode_path<DP, kVec, 4, TK>(w, smem, n_keys);
    else
      decode_path<DP, kVec, kDec, TK>(w, smem, n_keys);
  } else {
    const int r0 = blockIdx.y * kRows;
    if (r0 >= w.n_live) return;
    const int last = min(r0 + kRows, w.n_live) - 1;
    const int n_keys = min(row_limit(w, last) + 1 - w.s0, split);
    if (n_keys <= 0) return;
    chunk_path<DP, kVec, TK>(w, smem, r0, n_keys);
  }
}

// grid (ceil(NR / 4), ceil(D / 32)), one warp an output row and 32 of
// its columns (lane l column 32 y + l): the row's partials of the splits
// it sees. Lane s takes split s (s + 32, ... beyond 32 splits): the max
// M and the sum of l_s 2^(m_s - M) by fixed butterflies (every warp of a
// row computes the same M and L bit for bit), then each column's sum of
// acc_s 2^(m_s - M) in the order s = 0, 1, ...; dead rows get zeros. The
// order depends on the row's own split count only. The column slices
// give a decode step (a few dozen rows) hundreds of warps, where one
// warp a row walked all of a row's columns and splits alone. out is
// float32, or bf16 (out_bf16: each value rounded to nearest even as it
// is written).
__device__ __forceinline__ void put(void* out, int64_t i, float v,
                                    bool out_bf16) {
  if (out_bf16)
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc,
                   const int* __restrict__ kv_lens,
                   const int* __restrict__ q_lens, void* __restrict__ out,
                   bool out_bf16, int64_t NR, int C, int Hq, int D, int T,
                   int split, int n_splits) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= NR) return;
  const int64_t b = row / (static_cast<int64_t>(C) * Hq);
  const int c = static_cast<int>((row / Hq) % C);
  const int q_len = q_lens[b];
  int ns = 0;
  if (c < q_len) {
    const int limit = min(kv_lens[b] - q_len + c, T - 1);
    if (limit >= 0) ns = min(limit / split + 1, n_splits);
  }
  const int64_t o = row * D;
  const int d0 = blockIdx.y * 32;  // the warp's 32 columns
  if (ns == 0) {
    if (d0 + lane < D) put(out, o + d0 + lane, 0.f, out_bf16);
    return;
  }
  const float* ml = part_ml + 2 * row;
  const int64_t ml_stride = 2 * NR;
  float M = -INFINITY;
  for (int s = lane; s < ns; s += 32) M = fmaxf(M, ml[s * ml_stride]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, x));
  float L = 0.f;
  for (int s = lane; s < ns; s += 32)
    L = fmaf(ml[s * ml_stride + 1], exp2f(ml[s * ml_stride] - M), L);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) L += __shfl_xor_sync(0xffffffffu, L, x);
  const float denom = fmaxf(L, FLT_MIN);
  // lane s's weight 2^(m_s - M), shared by shuffles (up to 32 splits)
  const float w_own = lane < ns ? exp2f(ml[lane * ml_stride] - M) : 0.f;
  const float* a = part_acc + row * D;
  const int64_t a_stride = NR * D;
  const int d = d0 + lane;
  float A = 0.f;
#pragma unroll 4
  for (int s = 0; s < ns; ++s) {
    const float wt = s < 32 ? __shfl_sync(0xffffffffu, w_own, s)
                            : exp2f(ml[s * ml_stride] - M);
    if (d < D) A = fmaf(a[s * a_stride + d], wt, A);
  }
  if (d < D) put(out, o + d, A / denom, out_bf16);
}

template <int DP, bool kVec, typename TK>
cudaError_t launch(const void* q, bool q_bf16, const TK* k, const TK* v,
                   const int* tables, const int* kv_lens, const int* q_lens,
                   float* part_ml, float* part_acc, int B, int C, int Hq,
                   int Hkv, int D, int ps, int W, int split, int n_splits,
                   int vb, float scale, cudaStream_t stream) {
  const size_t smem = Ring<DP, TK>::kBytes +
                      sizeof(int64_t) * static_cast<size_t>(split);
  auto kernel = paged_split_kernel<DP, kVec, TK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int rep = Hq / Hkv;
  dim3 grid(B * Hkv, (C * rep + kRows - 1) / kRows, n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(q, q_bf16, k, v, tables, kv_lens,
                                           q_lens, part_ml, part_acc, C, Hq,
                                           Hkv, D, ps, W, split, vb, scale);
  return cudaGetLastError();
}


// ------------------------------------------------------------- wide
// head_dim above 256; see the head comment.
constexpr int kWideRows = 16;                  // rows a block, 4 a warp
constexpr int kWideRowsPerWarp = kWideRows / kWarps;
constexpr int kWideChunk = 256;                // columns a chunk or slice
constexpr int kWideNE = kWideChunk / 32;

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

template <typename TK>
__global__ void __launch_bounds__(kThreads)
paged_wide_kernel(const void* __restrict__ q, bool q_bf16,
                  const TK* __restrict__ k_pages,
                  const TK* __restrict__ v_pages,
                  const int* __restrict__ tables,
                  const int* __restrict__ kv_lens,
                  const int* __restrict__ q_lens,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int C, int Hq, int Hkv, int D, int ps, int W, int split,
                  float scale, int n_slices) {
  constexpr int R = kWideRowsPerWarp;
  extern __shared__ float4 smem4[];
  const Work w = make_work(q, q_bf16, k_pages, v_pages, tables, kv_lens,
                           q_lens, part_ml, part_acc, C, Hq, Hkv, D, ps, W,
                           split, 0, scale);

  const int slice = blockIdx.y % n_slices;
  const int r0 = (blockIdx.y / n_slices) * kWideRows;
  if (r0 >= w.n_live) return;
  const int n_keys = min(
      row_limit(w, min(r0 + kWideRows, w.n_live) - 1) + 1 - w.s0, split);
  if (n_keys <= 0) return;  // the split starts past every visible key
  const int c0 = slice * kWideChunk;           // the block's columns
  const int cw = min(kWideChunk, D - c0);

  int64_t* offs = reinterpret_cast<int64_t*>(smem4);       // [split]
  float* qs = reinterpret_cast<float*>(offs + split);      // [16][256]
  float* ks = qs + kWideRows * kWideChunk;                 // [32][257]
  float* vs = ks + kTile * (kWideChunk + 1);               // [32][256]
  key_offsets(w, offs, w.s0 + n_keys);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rw = warp * R;                     // the warp's rows in qs
  int lim[R];
  float m[R], l[R], acc[R][kWideNE];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lim[i] = row_limit(w, r0 + rw + i);
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) acc[i][e] = 0.f;
  }

  const int n_tiles = (n_keys + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int64_t* to = offs + it * kTile;
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      const int dw = min(kWideChunk, D - d0);
      __syncthreads();  // the offsets are written; the last chunk is read
      for (int i = threadIdx.x; i < kWideRows * dw; i += kThreads) {
        const int rr = i / dw, d = i % dw;
        const int r = r0 + rr;
        const int64_t at = row_id(w, r) * D + d0 + d;
        qs[rr * dw + d] =
            r >= w.n_live ? 0.f
            : q_bf16      ? widen(static_cast<const bf16*>(q)[at])
                          : static_cast<const float*>(q)[at];
      }
      for (int i = threadIdx.x; i < kTile * dw; i += kThreads) {
        const int key = i / dw, d = i % dw;
        const int64_t off = to[key];
        ks[key * (dw + 1) + d] = off >= 0 ? widen(k_pages[off + d0 + d]) : 0.f;
      }
      if (d0 + kWideChunk >= D) {  // the last chunk: the V slice too
        for (int i = threadIdx.x; i < kTile * cw; i += kThreads) {
          const int key = i / cw, d = i % cw;
          const int64_t off = to[key];
          vs[key * cw + d] = off >= 0 ? widen(v_pages[off + c0 + d]) : 0.f;
        }
      }
      __syncthreads();
      const float* kr = ks + lane * (dw + 1);
      const float* qw = qs + rw * dw;
#pragma unroll 4
      for (int d = 0; d < dw; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < R; ++i) s[i] = fmaf(qw[i * dw + d], kd, s[i]);
      }
    }

    // online softmax in units of s * scale * log2(e); a masked key gives
    // p = 0 exactly
    const int t = w.s0 + it * kTile + lane;
    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float x = t <= lim[i] ? s[i] * w.c : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float alpha = exp2f(m[i] - m_new);
      p[i] = exp2f(x - m_new);
      l[i] = fmaf(l[i], alpha, warp_sum(p[i]));
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kWideNE; ++e) acc[i][e] *= alpha;
    }
    const int n_here = min(kTile, n_keys - it * kTile);
    for (int j = 0; j < n_here; ++j) {
      float vd[kWideNE];
#pragma unroll
      for (int e = 0; e < kWideNE; ++e) {
        const int d = lane + 32 * e;
        vd[e] = d < cw ? vs[j * cw + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int e = 0; e < kWideNE; ++e)
          acc[i][e] = fmaf(pj, vd[e], acc[i][e]);
      }
    }
  }

  // the split's partial of each row that sees one of its keys
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (lim[i] < w.s0) continue;  // dead, or sees no key of the split
    const int64_t at = w.s * w.NR + row_id(w, r0 + rw + i);
    float* a = w.part_acc + at * D + c0;
#pragma unroll
    for (int e = 0; e < kWideNE; ++e) {
      const int d = lane + 32 * e;
      if (d < cw) a[d] = acc[i][e];
    }
    if (slice == 0 && lane == 0) {
      w.part_ml[2 * at] = m[i];
      w.part_ml[2 * at + 1] = l[i];
    }
  }
}

#include "paged_wide.cuh"

template <typename TK>
cudaError_t launch_wide(const void* q, bool q_bf16, const TK* k, const TK* v,
                        const int* tables, const int* kv_lens,
                        const int* q_lens, float* part_ml, float* part_acc,
                        int B, int C, int Hq, int Hkv, int D, int ps, int W,
                        int split, int n_splits, int, float scale,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(int64_t) * static_cast<size_t>(split) +
      sizeof(float) * (kWideRows * kWideChunk + kTile * (2 * kWideChunk + 1));
  cudaError_t e = cudaFuncSetAttribute(
      paged_wide_kernel<TK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int n_slices = (D + kWideChunk - 1) / kWideChunk;
  const int blocks = (C * (Hq / Hkv) + kWideRows - 1) / kWideRows;
  dim3 grid(B * Hkv, blocks * n_slices, n_splits);
  paged_wide_kernel<TK><<<grid, kThreads, smem, stream>>>(
      q, q_bf16, k, v, tables, kv_lens, q_lens, part_ml, part_acc, C, Hq, Hkv, D, ps,
      W, split, scale, n_slices);
  return cudaGetLastError();
}

// Bytes a copy unit of a page row: the widest cp.async the row's
// alignment allows (a row starts at a multiple of D elements): float32
// 16 when D % 4 == 0, else 4; bf16 16 when D % 8 == 0, 8 when D % 4 ==
// 0, 4 when D is even, else 2 (one column by a plain load).
// kernels/paged_attention.py:page_copy_bytes is the same rule (a CPU
// test parses this one and holds the two together), and the wrapper
// checks the pools' alignment against it.
template <typename TK>
int page_copy_bytes(int D) {
  if (sizeof(TK) == 4) return D % 4 == 0 ? 16 : 4;
  return D % 8 == 0 ? 16 : D % 4 == 0 ? 8 : D % 2 == 0 ? 4 : 2;
}

// Checks the arguments, launches the split kernel of D's bucket on TK
// pools, then the merge kernel.
template <typename TK>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* tables, const void* kv_lens, const void* q_lens,
        void* part_ml, void* part_acc, void* out, int B, int C, int Hq,
        int Hkv, int D, int ps, int W, int split, int n_splits, int q_bf16,
        float scale, void* stream) {
  if (B == 0 || C == 0) return cudaSuccess;
  if (B < 0 || C < 0 || D <= 0 || Hkv <= 0 || Hq % Hkv ||
      ps <= 0 || W <= 0 || split <= 0 || split % kTile || split > 1024 ||
      static_cast<int64_t>(W) * ps > (int64_t{1} << 30) ||
      n_splits != (W * ps + split - 1) / split || n_splits > 65535 ||
      (C * (Hq / Hkv) + kRows - 1) / kRows > 65535 ||
      static_cast<int64_t>((C * (Hq / Hkv) + kWideRows - 1) / kWideRows) *
              ((D + kWideChunk - 1) / kWideChunk) > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const bool qb = q_bf16 != 0;
  const int vb = page_copy_bytes<TK>(D);
  if (reinterpret_cast<uintptr_t>(k_pages) % vb ||
      reinterpret_cast<uintptr_t>(v_pages) % vb)
    return cudaErrorInvalidValue;
  auto args = [&](auto launcher) {
    return launcher(q, qb, static_cast<const TK*>(k_pages),
                    static_cast<const TK*>(v_pages),
                    static_cast<const int*>(tables),
                    static_cast<const int*>(kv_lens),
                    static_cast<const int*>(q_lens),
                    static_cast<float*>(part_ml),
                    static_cast<float*>(part_acc), B, C, Hq, Hkv, D, ps, W,
                    split, n_splits, vb, scale, st);
  };
  // the bands above 256 are the wrapper's WIDE_DIMS, which set their
  // split length (a CPU test holds the two together)
  const bool vec = D % 4 == 0;
  cudaError_t e;
  if (D <= 32)
    e = vec ? args(launch<32, true, TK>) : args(launch<32, false, TK>);
  else if (D <= 64)
    e = vec ? args(launch<64, true, TK>) : args(launch<64, false, TK>);
  else if (D <= 128)
    e = vec ? args(launch<128, true, TK>) : args(launch<128, false, TK>);
  else if (D <= 256)
    e = vec ? args(launch<256, true, TK>) : args(launch<256, false, TK>);
  else if (D <= wide::kMaxD)
    e = args(wide::launch<TK>);
  else
    e = args(launch_wide<TK>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t NR = static_cast<int64_t>(B) * C * Hq;
  const dim3 merge_grid(static_cast<unsigned>((NR + kWarps - 1) / kWarps),
                        (D + 31) / 32);
  paged_merge_kernel<<<merge_grid, kThreads, 0, st>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens), out,
      qb, NR, C, Hq, D, W * ps, split, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// part_ml: n_splits * B * C * Hq * 2 floats; part_acc: n_splits * B * C *
// Hq * D floats; n_splits = ceil(W * page_size / split), split a
// multiple of 32 up to 1024. q and out are bf16 when q_bf16, else
// float32; the pools float32 (paged_attention_f32) or bf16
// (paged_attention_bf16).
int paged_attention_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* tables,
                        const void* kv_lens, const void* q_lens,
                        void* part_ml, void* part_acc, void* out, int B,
                        int C, int Hq, int Hkv, int D, int ps, int W,
                        int split, int n_splits, int q_bf16, float scale,
                        void* stream) {
  return run<float>(q, k_pages, v_pages, tables, kv_lens, q_lens, part_ml,
                    part_acc, out, B, C, Hq, Hkv, D, ps, W, split, n_splits,
                    q_bf16, scale, stream);
}

int paged_attention_bf16(const void* q, const void* k_pages,
                         const void* v_pages, const void* tables,
                         const void* kv_lens, const void* q_lens,
                         void* part_ml, void* part_acc, void* out, int B,
                         int C, int Hq, int Hkv, int D, int ps, int W,
                         int split, int n_splits, int q_bf16, float scale,
                         void* stream) {
  return run<bf16>(q, k_pages, v_pages, tables, kv_lens, q_lens, part_ml,
                   part_acc, out, B, C, Hq, Hkv, D, ps, W, split, n_splits,
                   q_bf16, scale, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
