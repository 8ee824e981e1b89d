// Paged attention (K4) at head_dim 257 to 512 on Hopper (sm_90a): the
// two bodies that paged_attention.cu launches there, for float32 or
// bfloat16 pages (TK), before its merge kernel. Part of paged_attention.cu:
// it is included there, inside that file's namespace, after the helpers
// it uses (Work, row_limit, row_id, key_offsets, copy_unit, copy_raw,
// load4, widen, score4, pv4).
//
// Each computes, for its (slot, kv head, split), the split's partial
// (m, l, acc[D]) of every live row that sees one of its keys, as the
// 256-bucket kernels do: m in units of s * scale * log2(e), masked keys
// p = 0 exactly, dead rows never written (the merge gives them exact
// zeros). Which body takes a slot follows from the slot's own live-row
// count q_len * rep, never from C, so a decode slot gives the same bits
// in a C = 1 launch and beside prefill chunks in a C = 64 launch:
//
//   wide_decode_kernel  q_len * rep <= kDecCap (4), grid (B * Hkv, 1,
//     n_splits), 8 warps. Decode reads each K/V byte once and does ~2
//     flops a byte: bytes-bound. So the block computes all D columns of
//     its live rows only (no column slices, no dead rows) and keeps many
//     bytes in flight: the split's keys stream in tiles of 8 keys (K and
//     V rows, one key a warp) through a ring of `stages` tiles in the
//     page's own dtype, filled by cp.async through the split's table of
//     key offsets (16-byte copies when the row allows, see
//     page_copy_bytes). On the card the loads set its pace (without the
//     arithmetic it ran nearly as long; PERF.md) and
//     more blocks an SM beat a deeper ring, so the rings of the blocks an
//     SM holds share ~192 KB: two blocks of the 4-row instance (128
//     registers), three of a 1-row instance for MHA decode launches.
//     Warp w scores key w of each tile: its 32 lanes take 4 columns a
//     float4 (4 bf16 as 8 bytes, widened) per 128 columns, a 5-step
//     butterfly sums the dot (every lane holds the same sum), then an
//     online softmax a key (the rescale only when the max moves) and
//     P V with lane owning columns lane + 32 e. The 8 warps' states
//     merge in shared memory in the order 0, 1, ..., 7.
//   wide_chunk_kernel  more live rows (a prefill chunk, GQA decode above
//     4 rows), grid (B * Hkv, ceil(C * rep / 64), n_splits), 8 warps in
//     two groups of 4 on the same 64 rows (warp w rows 16 (w % 4) ..
//     + 15), as flash_fwd_wide_mma.cuh's K2 does above 128: the head_dim
//     is cut into 64-column chunks and group g takes chunks g, g + 2, ...
//     for its partial scores (Q resident in shared memory, K chunks
//     streamed) and its share of O (V chunks). Group 1's warp hands its
//     partial S to group 0's warp of the same rows through shared memory
//     behind a pair barrier; that warp adds it, masks, moves m and l,
//     forms P and hands P and alpha back. O at 512 columns is 128 floats
//     a lane in either group. The products are 3xTF32 mma.sync m16n8k8
//     (tf32x3.cuh; 2 products when B is a bf16 tile: its small part is
//     0), each 64-column score chunk and each 4 n-tiles of P V summed in
//     fresh fragments and joined by float32 adds or FMAs (the tensor
//     core's sums are not rounded to nearest). Each group streams its K
//     and V chunks (32 keys x 64 columns) through its own cp.async ring
//     behind its own named barrier; the rows' key offsets come from the
//     split's shared table, as in the decode body.
//
// No atomics: every partial element is written once by one lane, so two
// launches give bitwise-equal partials.

namespace wide {

constexpr int kWarpsW = 8;
constexpr int kThreadsW = kWarpsW * 32;
constexpr int kMaxD = 512;         // above: paged_wide_kernel
// decode body
constexpr int kDecCap = 4;         // live rows a slot takes it up to
constexpr int kDTile = 8;          // keys a ring stage: one a warp
constexpr int kNE = kMaxD / 32;    // output columns a lane: lane + 32 e
constexpr int kNM = kMaxD / 128;   // float4 column groups a lane a key
constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
// the rings of the blocks an SM holds share kRingBytes: two blocks of
// the 4-row instance (128 registers a lane), kOneRowBlocks of the 1-row
// instance that MHA decode launches (C * rep == 1) take
constexpr int kRingBytes = 192 * 1024;
constexpr int kOneRowBlocks = 3;
// chunk body
constexpr int kCTile = 32;         // keys a tile
constexpr int kCol = 64;           // head_dim columns a chunk
constexpr int kNB = kMaxD / kCol / 2;  // chunks a group takes at most: 4
constexpr int kXLd = kCTile + 8;   // 40 = 8 (mod 32): float2 rows of S, P
// named barriers (0 is __syncthreads): a group's ring; the two warps of
// rows 16 m .. 16 m + 15: group 1's partial S written, group 0's P and
// alpha written
constexpr int kBarRing = 1;        // + group
constexpr int kBarPartial = 3;     // + m
constexpr int kBarProbs = 7;       // + m
constexpr int kGroupT = 128;       // threads of a group
constexpr int kPairT = 64;         // threads of a pair barrier

// A chunk slot: 32 keys x 64 columns in the page's dtype; rows of 68
// floats (4 mod 32) or 72 bf16 (4 mod 8 words), so every fragment load
// hits distinct banks. Ring depth: 4 slots a group (float32), 8 (bf16).
template <typename TK>
struct Slot {
  static constexpr int kLd = sizeof(TK) == 4 ? kCol + 4 : kCol + 8;
  static constexpr int kElems = kCTile * kLd;
  static constexpr int kStages = sizeof(TK) == 4 ? 4 : 8;
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Wait until at most n of this thread's cp.async groups are in flight
// (n < kMaxStages - 1; the instruction takes an immediate).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// One copy unit of a page row into shared memory in the page's dtype:
// float32 rows by 16-byte (vb 16: 4 columns) or 4-byte cp.async; bf16
// rows by copy_raw. Columns at or past D, or a null row, become zeros.
__device__ __forceinline__ void copy_page(float* dst_row,
                                          const float* src_row, int unit,
                                          int D, int vb, const float* any) {
  if (vb == 16)
    copy_unit<true>(dst_row, src_row, unit, D, any);
  else
    copy_unit<false>(dst_row, src_row, unit, D, any);
}

__device__ __forceinline__ void copy_page(bf16* dst_row, const bf16* src_row,
                                          int unit, int D, int vb,
                                          const bf16* any) {
  copy_raw(dst_row, src_row, unit, D, vb, any);
}

// Slot-rows [r0, r0 + n) of q into float32 shared rows of stride ldq
// (ldq >= D, a multiple of 4), by all threads: columns D..ldq and rows
// past the live ones are zeros.
__device__ __forceinline__ void stage_q_rows(const Work& w, float* qs,
                                             int ldq, int r0, int n) {
  auto rows = [&](auto tq, auto vec) {
    using TQ = decltype(tq);
    constexpr bool kVec = decltype(vec)::value;
    const TQ* q = static_cast<const TQ*>(w.q);
    const int U = kVec ? ldq / 4 : ldq;
    for (int i = threadIdx.x; i < n * U; i += kThreadsW) {
      const int rr = i / U;
      const int r = r0 + rr;
      const TQ* src = r < w.n_live ? q + row_id(w, r) * w.D : nullptr;
      copy_unit<kVec>(qs + rr * ldq, src, i % U, w.D, q);
    }
  };
  const bool vec = w.D % 4 == 0;
  if (w.q_bf16) {
    if (vec) rows(bf16(), std::true_type());
    else rows(bf16(), std::false_type());
  } else {
    if (vec) rows(0.f, std::true_type());
    else rows(0.f, std::false_type());
  }
}

// ------------------------------------------------------------ decode
// The slot's MR (>= n_live) rows over n_keys keys of split s from s0.
// Shared memory: the split's key offsets, Q's QR rows (float32, stride
// ldq; QR the kernel's row cap), then the ring: `stages` tiles of kDTile
// K rows and kDTile V rows at stride ldk; after the keys, the ring holds
// the warps' states.
template <typename TK, int MR, int QR>
__device__ __forceinline__ void decode_body(const Work& w, char* smem,
                                            int n_keys, int stages,
                                            int ldk) {
  const int ldq = (w.D + 3) & ~3;
  int64_t* offs = reinterpret_cast<int64_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + sizeof(int64_t) * w.split);
  TK* ring = reinterpret_cast<TK*>(qs + QR * ldq);
  const int tile = 2 * kDTile * ldk;  // elements a stage: K rows, V rows
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (n_keys + kDTile - 1) / kDTile;
  const TK* kp = static_cast<const TK*>(w.kp);
  const TK* vp = static_cast<const TK*>(w.vp);
  const int U = ldk / (w.vb / static_cast<int>(sizeof(TK)));  // units a row

  // tile it of the split into its ring slot
  auto issue = [&](int it) {
    TK* ks = ring + (it % stages) * tile;
    TK* vs = ks + kDTile * ldk;
    for (int i = threadIdx.x; i < kDTile * U; i += kThreadsW) {
      const int key = i / U, u = i % U;
      const int64_t off = offs[it * kDTile + key];
      copy_page(ks + key * ldk, off >= 0 ? kp + off : nullptr, u, w.D, w.vb,
                kp);
      copy_page(vs + key * ldk, off >= 0 ? vp + off : nullptr, u, w.D, w.vb,
                kp);
    }
  };

  key_offsets<kThreadsW>(w, offs, w.s0 + n_keys);
  stage_q_rows(w, qs, ldq, 0, MR);
  __syncthreads();
  for (int p = 0; p < stages - 1; ++p) {
    if (p < n_tiles) issue(p);
    cp_async_commit();
  }

  int lim[MR];
  float m[MR], l[MR], acc[MR][kNE];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    lim[i] = row_limit(w, i);
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kNE; ++e) acc[i][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    // tile it has landed and every warp is done with tile it - 1, whose
    // slot then takes tile it + stages - 1
    cp_async_wait_n(stages - 2);
    __syncthreads();
    if (it + stages - 1 < n_tiles) issue(it + stages - 1);
    cp_async_commit();
    const int kk = it * kDTile + warp;  // the warp's key in the split
    if (kk >= n_keys) continue;         // past every row's last key
    const TK* kr = ring + (it % stages) * tile + warp * ldk;
    const TK* vr = kr + kDTile * ldk;
    const int t = w.s0 + kk;

    // q_i . k_t: 4 columns a lane per 128, then a butterfly over the
    // warp (every lane ends with the same sum)
    float s[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) s[i] = 0.f;
#pragma unroll
    for (int mm = 0; mm < kNM; ++mm) {
      if (128 * mm >= ldq) break;
      const int d = 4 * (lane + 32 * mm);
      if (d < ldq) {
        const float4 kv = load4(kr + d);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + i * ldq + d);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
    }
    // online softmax a key, in units of s * scale * log2(e); a masked
    // key gives p = 0 exactly; the state rescales only when m moves
    float p[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      const float x = t <= lim[i] ? s[i] * w.c : -INFINITY;
      if (x > m[i]) {
        const float alpha = exp2f(m[i] - x);
        m[i] = x;
        l[i] *= alpha;
#pragma unroll
        for (int e = 0; e < kNE; ++e) acc[i][e] *= alpha;
      }
      p[i] = exp2f(x - m[i]);
      l[i] += p[i];
    }
    // acc_i += p_i v_t; the lane owns columns lane + 32 e
#pragma unroll
    for (int e = 0; e < kNE; ++e) {
      if (32 * e >= w.D) break;
      const int d = lane + 32 * e;
      const float v = d < w.D ? widen(vr[d]) : 0.f;
#pragma unroll
      for (int i = 0; i < MR; ++i) acc[i][e] = fmaf(p[i], v, acc[i][e]);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring: reuse it

  // the warps' states, merged in the order 0..7 into the split's partial
  float* wm = reinterpret_cast<float*>(ring);  // [kWarpsW][MR]
  float* wl = wm + kWarpsW * MR;               // [kWarpsW][MR]
  float* wacc = wl + kWarpsW * MR;             // [kWarpsW][MR][ldq]
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (lane == 0) {
      wm[warp * MR + i] = m[i];
      wl[warp * MR + i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < kNE; ++e) {
      const int d = lane + 32 * e;
      if (d < w.D) wacc[(warp * MR + i) * ldq + d] = acc[i][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < MR * w.D; idx += kThreadsW) {
    const int i = idx / w.D, d = idx % w.D;
    if (row_limit(w, i) < w.s0) continue;  // dead, or sees no key here
    float M = wm[i];
#pragma unroll
    for (int v = 1; v < kWarpsW; ++v) M = fmaxf(M, wm[v * MR + i]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int v = 0; v < kWarpsW; ++v) {
      const float wt = exp2f(wm[v * MR + i] - M);
      L = fmaf(wl[v * MR + i], wt, L);
      A = fmaf(wacc[(v * MR + i) * ldq + d], wt, A);
    }
    const int64_t at = w.s * w.NR + row_id(w, i);
    w.part_acc[at * w.D + d] = A;
    if (d == 0) {
      w.part_ml[2 * at] = M;
      w.part_ml[2 * at + 1] = L;
    }
  }
}

// grid (B * Hkv, 1, n_splits); slots of more than kCap live rows are the
// chunk kernel's. Two instances: kCap = kDecCap (two blocks an SM), and
// kCap = 1 (kOneRowBlocks blocks an SM, fewer registers and a smaller
// ring each) for launches whose slots hold one live row at most (C *
// rep == 1: MHA decode). Both run decode_body<TK, 1, .> on a one-row
// slot: the same arithmetic, so the same bits in either.
template <typename TK, int kCap, int kBlocks>
__global__ void __launch_bounds__(kThreadsW, kBlocks)
wide_decode_kernel(const void* __restrict__ q, bool q_bf16,
                   const TK* __restrict__ k_pages,
                   const TK* __restrict__ v_pages,
                   const int* __restrict__ tables,
                   const int* __restrict__ kv_lens,
                   const int* __restrict__ q_lens,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int C, int Hq, int Hkv, int D, int ps, int W, int split,
                   int vb, int stages, int ldk, float scale) {
  extern __shared__ float4 smem4[];
  const Work w = make_work(q, q_bf16, k_pages, v_pages, tables, kv_lens,
                           q_lens, part_ml, part_acc, C, Hq, Hkv, D, ps, W,
                           split, vb, scale);
  if (w.n_live == 0 || w.n_live > kCap) return;
  const int n_keys = min(row_limit(w, w.n_live - 1) + 1 - w.s0, split);
  if (n_keys <= 0) return;  // the split starts past every visible key
  char* smem = reinterpret_cast<char*>(smem4);
  if constexpr (kCap == 1) {
    decode_body<TK, 1, kCap>(w, smem, n_keys, stages, ldk);
  } else {
    if (w.n_live == 1)
      decode_body<TK, 1, kCap>(w, smem, n_keys, stages, ldk);
    else
      decode_body<TK, kCap, kCap>(w, smem, n_keys, stages, ldk);
  }
}

// ------------------------------------------------------------- chunk
// A group's ring of chunk slots: chunk i of the group's sequence lands in
// slot i % kStages. Before chunk `done` is read: wait for it, the group's
// barrier (its warps are done with chunk done - 1, whose slot is refilled
// next), issue chunk done + kStages - 1.
template <typename TK>
struct ChunkRing {
  TK* base;
  int bar, done, total;
  template <typename Issue>
  __device__ __forceinline__ const TK* next(Issue&& issue) {
    constexpr int S = Slot<TK>::kStages;
    cp_async_wait<S - 2>();
    bar_sync(bar, kGroupT);
    const int i = done + S - 1;
    if (i < total) issue(i, base + (i % S) * Slot<TK>::kElems);
    cp_async_commit();
    return base + (done++ % S) * Slot<TK>::kElems;
  }
  template <typename Issue>
  __device__ __forceinline__ void prologue(Issue&& issue) {
    for (int i = 0; i < Slot<TK>::kStages - 1; ++i) {
      if (i < total) issue(i, base + i * Slot<TK>::kElems);
      cp_async_commit();
    }
  }
};

// sc += A K^T over one 64-column score chunk: A the warp's 16 Q rows at
// stride ldq, K a chunk slot; k-steps at or past `cols` (the head_dim's
// end) are skipped. The chunk's sums collect in fresh fragments.
template <typename TK>
__device__ __forceinline__ void score_chunk(float (&sc)[kCTile / 8][4],
                                            const float* a, int ldq,
                                            const TK* k, int g, int t,
                                            int cols) {
  float f[kCTile / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < kCol / 8; ++kk) {
    if (8 * kk >= cols) break;
    uint32_t ab[4], as[4];
    load_a(a, ldq, kk, g, t, ab, as);
    score4(f, ab, as, k, Slot<TK>::kLd, kk, g, t);
  }
  add_tiles(sc, f);
}

// acc[0 .. 8) = acc alpha + P V for one 64-column output chunk: P the
// warp's 16 x 32 probabilities in accumulator layout, V a chunk slot.
// Each 4 n-tiles' sums collect in fresh fragments, joined by one FFMA.
template <typename TK>
__device__ __forceinline__ void out_chunk(float (*acc)[4],
                                          const float (&x)[kCTile / 8][4],
                                          const TK* v,
                                          const float (&alpha)[2], int g,
                                          int t) {
#pragma unroll
  for (int n0 = 0; n0 < kCol / 8; n0 += 4) {
    float f[4][4] = {};
#pragma unroll
    for (int j = 0; j < kCTile / 8; ++j) {
      uint32_t ab[4], as[4];
      acc_as_a(x[j], ab, as);
      pv4(f, ab, as, v, Slot<TK>::kLd, j, n0, g, t);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n0 + i][e] = fmaf(acc[n0 + i][e], alpha[e >> 1], f[i][e]);
  }
}

// grid (B * Hkv, ceil(C * rep / 64), n_splits): slot-rows [r0, r0 + 64)
// of the slots with more than kDecCap live rows. Shared memory: the
// split's key offsets, Q's 64 rows (float32, stride ldq = 64 na + 4),
// the two groups' rings, the S/P hand-over rows and the alphas.
template <typename TK>
__global__ void __launch_bounds__(kThreadsW, 1)
wide_chunk_kernel(const void* __restrict__ q, bool q_bf16,
                  const TK* __restrict__ k_pages,
                  const TK* __restrict__ v_pages,
                  const int* __restrict__ tables,
                  const int* __restrict__ kv_lens,
                  const int* __restrict__ q_lens,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int C, int Hq, int Hkv, int D, int ps, int W, int split,
                  int vb, float scale) {
  extern __shared__ float4 smem4[];
  const Work w = make_work(q, q_bf16, k_pages, v_pages, tables, kv_lens,
                           q_lens, part_ml, part_acc, C, Hq, Hkv, D, ps, W,
                           split, vb, scale);
  const int r0 = blockIdx.y * kRows;
  if (w.n_live <= kDecCap || r0 >= w.n_live) return;
  const int n_keys = min(
      row_limit(w, min(r0 + kRows, w.n_live) - 1) + 1 - w.s0, split);
  if (n_keys <= 0) return;  // the split starts past every visible key

  constexpr int kS = Slot<TK>::kStages;
  const int na = (D + kCol - 1) / kCol;  // head_dim chunks
  const int ldq = kCol * na + 4;         // 4 (mod 32) floats
  char* smem = reinterpret_cast<char*>(smem4);
  int64_t* offs = reinterpret_cast<int64_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + sizeof(int64_t) * split);
  TK* rings = reinterpret_cast<TK*>(qs + kRows * ldq);  // [2][kS][slot]
  float* xbuf = reinterpret_cast<float*>(rings + 2 * kS * Slot<TK>::kElems);
  float* alphas = xbuf + kRows * kXLd;  // [kRows]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m = warp % 4;
  const int rw = 16 * m;  // the warp's first row in the block
  const int grp = warp / 4;
  const int nc = (na - grp + 1) / 2;  // the group's chunks
  const int per = 2 * nc;             // ring chunks a tile: K's, then V's
  const int n_tiles = (n_keys + kCTile - 1) / kCTile;
  const TK* kp = static_cast<const TK*>(w.kp);
  const TK* vp = static_cast<const TK*>(w.vp);
  const int U = kCol / (vb / static_cast<int>(sizeof(TK)));  // units a row

  // chunk i of the group's sequence: keys [32 it, + 32) of K (c < nc) or
  // V, columns (2 c' + grp) * 64 ..
  auto issue = [&](int i, TK* s) {
    const int it = i / per, c = i % per;
    const TK* src = c < nc ? kp : vp;
    const int c0 = (2 * (c < nc ? c : c - nc) + grp) * kCol;
    for (int j = threadIdx.x % kGroupT; j < kCTile * U; j += kGroupT) {
      const int key = j / U, u = j % U;
      const int64_t off = offs[it * kCTile + key];
      copy_page(s + key * Slot<TK>::kLd,
                off >= 0 && c0 < D ? src + off + c0 : nullptr, u, D - c0, vb,
                kp);
    }
  };

  // Q's rows (read by both groups) and the key offsets, in full before
  // either group's ring starts
  stage_q_rows(w, qs, ldq, r0, kRows);
  key_offsets<kThreadsW>(w, offs, w.s0 + n_keys);
  cp_async_wait_all();
  __syncthreads();
  ChunkRing<TK> ring = {rings + grp * kS * Slot<TK>::kElems, kBarRing + grp,
                        0, n_tiles * per};
  ring.prologue(issue);

  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lim[h] = row_limit(w, r0 + rw + g + 8 * h);
  // the last key any row of the warp (and of its pair) sees
  const int warp_hi = r0 + rw < w.n_live
                          ? row_limit(w, min(r0 + rw + 15, w.n_live - 1))
                          : -1;
  float mr[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[kCol / 8 * kNB][4];
#pragma unroll
  for (int n = 0; n < kCol / 8 * kNB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* xw = xbuf + rw * kXLd;
  const float* qw = qs + rw * ldq;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = w.s0 + it * kCTile;
    if (t0 > warp_hi) {
      // no row of the pair sees the tile: keep the group's ring moving
      for (int a = 0; a < per; ++a) ring.next(issue);
      continue;
    }
    // the group's partial S = Q K^T: the warp's 16 rows x 32 keys over
    // its chunks of the head_dim
    float sc[kCTile / 8][4] = {};
    for (int a = 0; a < nc; ++a) {
      const int c0 = (2 * a + grp) * kCol;
      score_chunk(sc, qw + c0, ldq, ring.next(issue), g, t, D - c0);
    }
    float alpha[2];
    if (grp == 0) {
      // S = S_0 + S_1; masked scores become -inf (p = 0 exactly)
      bar_sync(kBarPartial + m, kPairT);
#pragma unroll
      for (int j = 0; j < kCTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 x = *reinterpret_cast<const float2*>(
              xw + (g + 8 * h) * kXLd + 8 * j + 2 * t);
          sc[j][2 * h] += x.x;
          sc[j][2 * h + 1] += x.y;
        }
#pragma unroll
      for (int j = 0; j < kCTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t0 + 8 * j + 2 * t + (e & 1) > lim[e >> 1])
            sc[j][e] = -INFINITY;
      // online softmax: the row max over the quad's 4 lanes, p =
      // 2^(s c - m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kCTile / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mr[h], mx * w.c);
        alpha[h] = exp2f(mr[h] - m_new);
        mr[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < kCTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(sc[j][e], w.c, -mr[e >> 1]));
          sc[j][e] = p;
          l[e >> 1] += p;
        }
      // P and alpha to the group-1 warp of these rows
#pragma unroll
      for (int j = 0; j < kCTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(xw + (g + 8 * h) * kXLd + 8 * j +
                                     2 * t) =
              make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
      if (t == 0) {
        alphas[rw + g] = alpha[0];
        alphas[rw + g + 8] = alpha[1];
      }
      __threadfence_block();
      bar_arrive(kBarProbs + m, kPairT);
    } else {
      // the partial to the group-0 warp of these rows; P and alpha back
#pragma unroll
      for (int j = 0; j < kCTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(xw + (g + 8 * h) * kXLd + 8 * j +
                                     2 * t) =
              make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
      __threadfence_block();
      bar_arrive(kBarPartial + m, kPairT);
      bar_sync(kBarProbs + m, kPairT);
#pragma unroll
      for (int j = 0; j < kCTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 x = *reinterpret_cast<const float2*>(
              xw + (g + 8 * h) * kXLd + 8 * j + 2 * t);
          sc[j][2 * h] = x.x;
          sc[j][2 * h + 1] = x.y;
        }
      alpha[0] = alphas[rw + g];
      alpha[1] = alphas[rw + g + 8];
    }
    // O = O alpha + P V over the group's output chunks
#pragma unroll
    for (int b = 0; b < kNB; ++b)
      if (b < nc) out_chunk(acc + kCol / 8 * b, sc, ring.next(issue), alpha,
                            g, t);
  }
  cp_async_wait_all();

  // the split's partial of each row that sees one of its keys: group 0
  // writes m and the row sum over the quad's lanes, each group its
  // chunks' columns 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (lim[h] < w.s0) continue;  // dead, or sees no key of the split
    const int64_t at = w.s * w.NR + row_id(w, r0 + rw + g + 8 * h);
    float* a = w.part_acc + at * D;
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
      if (b >= nc) break;
#pragma unroll
      for (int n = 0; n < kCol / 8; ++n) {
        const int d = kCol * (2 * b + grp) + 8 * n + 2 * t;
        if (d < D) a[d] = acc[kCol / 8 * b + n][2 * h];
        if (d + 1 < D) a[d + 1] = acc[kCol / 8 * b + n][2 * h + 1];
      }
    }
    if (grp == 0 && t == 0) {
      w.part_ml[2 * at] = mr[h];
      w.part_ml[2 * at + 1] = sum;
    }
  }
}

// Shared bytes of the two kernels (see each kernel's layout): the decode
// ring's stages for `blocks` blocks an SM, and the bytes of a block.
template <typename TK>
inline int decode_stages(int ldk, int blocks) {
  const int stage = 2 * kDTile * ldk * static_cast<int>(sizeof(TK));
  const int fit = kRingBytes / blocks / stage;
  return fit < kMinStages ? kMinStages : fit > kMaxStages ? kMaxStages : fit;
}

template <typename TK>
inline size_t decode_smem(int D, int split, int stages, int ldk, int cap) {
  const size_t ldq = (D + 3) & ~3;
  const size_t ring = static_cast<size_t>(stages) * 2 * kDTile * ldk *
                      sizeof(TK);
  const size_t states = sizeof(float) * kWarpsW * cap * (2 + ldq);
  return sizeof(int64_t) * split + sizeof(float) * cap * ldq +
         (ring > states ? ring : states);
}

// Launches one instance of the decode kernel.
template <typename TK, int kCap, int kBlocks>
cudaError_t launch_decode(const void* q, bool q_bf16, const TK* k,
                          const TK* v, const int* tables, const int* kv_lens,
                          const int* q_lens, float* part_ml,
                          float* part_acc, int B, int C, int Hq, int Hkv,
                          int D, int ps, int W, int split, int n_splits,
                          int vb, float scale, cudaStream_t stream) {
  const int ldk = sizeof(TK) == 4 ? (D + 3) & ~3 : (D + 7) & ~7;
  const int stages = decode_stages<TK>(ldk, kBlocks);
  const size_t smem = decode_smem<TK>(D, split, stages, ldk, kCap);
  auto kernel = wide_decode_kernel<TK, kCap, kBlocks>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(B * Hkv, 1, n_splits), kThreadsW, smem, stream>>>(
      q, q_bf16, k, v, tables, kv_lens, q_lens, part_ml, part_acc, C, Hq,
      Hkv, D, ps, W, split, vb, stages, ldk, scale);
  return cudaGetLastError();
}

template <typename TK>
inline size_t chunk_smem(int D, int split) {
  const size_t ldq = kCol * ((D + kCol - 1) / kCol) + 4;
  return sizeof(int64_t) * split + sizeof(float) * kRows * ldq +
         sizeof(TK) * 2 * Slot<TK>::kStages * Slot<TK>::kElems +
         sizeof(float) * (kRows * kXLd + kRows);
}

// K4 at 256 < D <= 512: the decode kernel, then the chunk kernel when a
// slot can hold more than kDecCap live rows (C * rep > kDecCap).
template <typename TK>
cudaError_t launch(const void* q, bool q_bf16, const TK* k, const TK* v,
                   const int* tables, const int* kv_lens, const int* q_lens,
                   float* part_ml, float* part_acc, int B, int C, int Hq,
                   int Hkv, int D, int ps, int W, int split, int n_splits,
                   int vb, float scale, cudaStream_t stream) {
  const int rows = C * (Hq / Hkv);  // live rows a slot can hold
  cudaError_t e =
      rows == 1
          ? launch_decode<TK, 1, kOneRowBlocks>(
                q, q_bf16, k, v, tables, kv_lens, q_lens, part_ml, part_acc,
                B, C, Hq, Hkv, D, ps, W, split, n_splits, vb, scale, stream)
          : launch_decode<TK, kDecCap, 2>(
                q, q_bf16, k, v, tables, kv_lens, q_lens, part_ml, part_acc,
                B, C, Hq, Hkv, D, ps, W, split, n_splits, vb, scale, stream);
  if (e != cudaSuccess || rows <= kDecCap) return e;
  const size_t smem_c = chunk_smem<TK>(D, split);
  auto chunk = wide_chunk_kernel<TK>;
  e = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_c));
  if (e != cudaSuccess) return e;
  dim3 grid(B * Hkv, (C * (Hq / Hkv) + kRows - 1) / kRows, n_splits);
  chunk<<<grid, kThreadsW, smem_c, stream>>>(
      q, q_bf16, k, v, tables, kv_lens, q_lens, part_ml, part_acc, C, Hq,
      Hkv, D, ps, W, split, vb, scale);
  return cudaGetLastError();
}

}  // namespace wide
