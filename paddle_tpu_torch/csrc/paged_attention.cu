// Ragged paged attention, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/fluid/ops/pallas_kernels/paged_attention.py:_paged_kernel
// and computes the same function as the plain version
//   paddle_tpu_torch/kernels/paged_attention.py:paged_attention_reference
// over the same layouts: q [B, C, Hq, D], pools [P, page_size, Hkv, D],
// page tables [B, W], kv_lens and q_lens [B] (int32), out [B, C, Hq, D].
// Query lane j of slot b sees keys at positions <= kv_len - q_len + j;
// dead slots (q_len == 0) and dead lanes (j >= q_len) give exact zeros;
// query head h reads kv head h / (Hq / Hkv) (GQA).
//
// What bounds it on this card: the bytes of K and V it reads. A decode
// step does ~2 flops per byte of K/V, far below the H100's ~20 f32
// flops per byte of HBM bandwidth, so the floor is (visible K/V bytes)
// / 3.35 TB/s. The design reads fewer bytes and reads each byte once
// per block:
//   - The TPU kernel walks all W table entries of every slot, garbage
//     padding included. Here a block loops only over the key positions
//     its live query rows can see (ceil to 32-key tiles), so padded and
//     invisible pages are never read.
//   - One block per (slot b, kv head g, tile of 16 query rows). A query
//     row is (chunk lane c, query head of group g); every row of the
//     tile shares the kv head, so a K/V tile staged in shared memory
//     once serves all C x (Hq/Hkv) rows of the group that the tile
//     holds — what GQA buys.
//   - Each 32-key tile is staged with coalesced float4 loads (a key's D
//     floats are contiguous in the pool); K rows are padded by one
//     float so the per-lane dot products read shared memory without
//     bank conflicts.
//   - Each warp owns up to 4 query rows and keeps their running max,
//     running sum and D-wide accumulator in registers (online softmax,
//     one max/sum reduction per 32-key tile). The final normalisation
//     divides by max(l, FLT_MIN), as the reference does.
// Not done yet (later work): cp.async/TMA double-buffering of tiles,
// split-K over long contexts, bf16 pools.
//
// The kernel allocates nothing; the caller passes the output.
// paged_attention_f32 launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;        // query rows each warp owns
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;              // keys per staged tile (1 a lane)
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF

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

// NE = accumulator floats per lane per row: head_dim <= 32 * NE.
template <int NE>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pages,
                       const float* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ kv_lens,
                       const int* __restrict__ q_lens,
                       float* __restrict__ out,
                       int C, int Hq, int Hkv, int D, int ps, int W,
                       float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* vs = smem;                        // [kKeys][D]
  float* ks = vs + kKeys * D;              // [kKeys][D + 1]
  float* qs = ks + kKeys * (D + 1);        // [kRows][D], pre-scaled

  const int b = blockIdx.x / Hkv;
  const int g = blockIdx.x % Hkv;
  const int rep = Hq / Hkv;
  const int n_rows = C * rep;
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kv_len = kv_lens[b];
  const int q_len = q_lens[b];

  // the block's query rows, pre-scaled, into shared memory
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = row0 + i / D;
    float val = 0.f;
    if (r < n_rows) {
      const int c = r / rep;
      const int h = g * rep + r % rep;
      val = q[((static_cast<int64_t>(b) * C + c) * Hq + h) * D + i % D]
            * scale;
    }
    qs[i] = val;
  }

  // keys this block must read: up to the highest position any of its
  // live rows sees (rows are lane-major, so the last live lane decides)
  const int c_first = row0 / rep;
  const int c_last = (min(row0 + kRows, n_rows) - 1) / rep;
  const int c_hi = min(c_last, q_len - 1);
  int n_keys = 0;
  if (row0 < n_rows && c_first < q_len && c_hi >= 0)
    n_keys = kv_len - q_len + c_hi + 1;
  n_keys = max(0, min(n_keys, W * ps));

  // per-row state, in registers
  int limit[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NE];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp + kWarps * i;
    const int c = r / rep;
    // a dead row (past the chunk, or a dead lane) sees no key
    limit[i] = (r < n_rows && c < q_len) ? kv_len - q_len + c : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  const int d4 = D / 4;
  const int64_t head_stride = D;
  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int* table = tables + static_cast<int64_t>(b) * W;

  for (int t0 = 0; t0 < n_keys; t0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and qs is ready)
    for (int i = threadIdx.x; i < kKeys * d4; i += kThreads) {
      const int key = i / d4;
      const int dd = (i % d4) * 4;
      const int t = t0 + key;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (t < n_keys) {
        const int64_t page = table[t / ps];
        const int64_t off = ((page * ps + t % ps) * tok_stride
                             + g * head_stride + dd);
        kv = *reinterpret_cast<const float4*>(k_pages + off);
        vv = *reinterpret_cast<const float4*>(v_pages + off);
      }
      // keys past n_keys stage zeros: p is 0 there, and 0 * 0 keeps
      // the accumulator finite whatever the pool holds
      float* kr = ks + key * (D + 1) + dd;
      kr[0] = kv.x; kr[1] = kv.y; kr[2] = kv.z; kr[3] = kv.w;
      *reinterpret_cast<float4*>(vs + key * D + dd) = vv;
    }
    __syncthreads();

    // scores: lane j scores key t0 + j against each of the warp's rows
    const int t = t0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* kr = ks + lane * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] = fmaf(qs[(warp + kWarps * i) * D + d], kd, s[i]);
    }

    // online softmax: one max and one sum reduction per tile and row
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool keep = t <= limit[i];
      const float si = keep ? s[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float alpha = expf(m[i] - m_new);
      p[i] = keep ? expf(si - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= alpha;
    }

    // acc[row][d] += sum_j p[row][j] * V[j][d]; lane owns d = lane + 32e
    const int n_here = min(kKeys, n_keys - t0);
    for (int j = 0; j < n_here; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        pj[i] = __shfl_sync(0xffffffffu, p[i], j);
      const float* vr = vs + j * D;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = lane + 32 * e;
        const float vd = d < D ? vr[d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          acc[i][e] = fmaf(pj[i], vd, acc[i][e]);
      }
    }
  }

  // emit: live rows normalise, dead rows are exact zeros
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp + kWarps * i;
    if (r >= n_rows) continue;
    const int c = r / rep;
    const int h = g * rep + r % rep;
    float* o = out + ((static_cast<int64_t>(b) * C + c) * Hq + h) * D;
    const float denom = fmaxf(l[i], FLT_MIN);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) o[d] = limit[i] >= 0 ? acc[i][e] / denom : 0.f;
    }
  }
}

template <int NE>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* tables, const int* kv_lens,
                   const int* q_lens, float* out, int B, int C, int Hq,
                   int Hkv, int D, int ps, int W, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kKeys) * D
                       + static_cast<size_t>(kKeys) * (D + 1)
                       + static_cast<size_t>(kRows) * D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<NE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int n_rows = C * (Hq / Hkv);
  dim3 grid(B * Hkv, (n_rows + kRows - 1) / kRows);
  paged_attention_kernel<NE><<<grid, kThreads, smem, stream>>>(
      q, k, v, tables, kv_lens, q_lens, out, C, Hq, Hkv, D, ps, W, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int paged_attention_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* tables,
                        const void* kv_lens, const void* q_lens, void* out,
                        int B, int C, int Hq, int Hkv, int D, int ps, int W,
                        float scale, void* stream) {
  if (B == 0 || C == 0) return cudaSuccess;
  if (D <= 0 || D > 256 || D % 4 || Hkv <= 0 || Hq % Hkv || ps <= 0 ||
      W <= 0)
    return cudaErrorInvalidValue;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const float*>(q),
                    static_cast<const float*>(k_pages),
                    static_cast<const float*>(v_pages),
                    static_cast<const int*>(tables),
                    static_cast<const int*>(kv_lens),
                    static_cast<const int*>(q_lens),
                    static_cast<float*>(out), B, C, Hq, Hkv, D, ps, W,
                    scale, static_cast<cudaStream_t>(stream));
  };
  cudaError_t e;
  if (D <= 32)
    e = args(launch<1>);
  else if (D <= 64)
    e = args(launch<2>);
  else if (D <= 128)
    e = args(launch<4>);
  else
    e = args(launch<8>);
  return static_cast<int>(e);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
