// Flash attention, float32, for Hopper (sm_90a): the forward pass and
// the two kernels of the backward pass.
//
// Replaces the Pallas TPU kernels of
//   paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py
//     _fwd_kernel       (launched by _fwd_pallas)    -> flash_fwd_f32
//     _bwd_dkdv_kernel  (launched by _flash_bwd)     -> flash_bwd_dkdv_f32
//     _bwd_dq_kernel    (launched by _flash_bwd)     -> flash_bwd_dq_f32
// and computes the same functions as the plain versions
//   paddle_tpu_torch/kernels/flash_attention.py:
//     flash_attention_fwd_reference, flash_attention_bwd_reference
// over the same layouts: q [BH, Sq, D], k and v [BH, Sk, D], O and dO
// [BH, Sq, D], lse and delta [BH, Sq], all contiguous. Causal masking
// keeps key t for query row i when t <= i (absolute positions, as the
// TPU kernel's qpos >= kpos, also when Sq != Sk).
//
//   forward   s = scale * q.k, online softmax over key tiles, O = P V /
//             max(l, FLT_MIN), lse = m + log(max(l, FLT_MIN)); masked
//             scores take -1e30 and their probabilities are exactly 0.
//   dK, dV    p = exp(s - lse) recomputed per (query, key) pair and set
//             to 0 (not masked) on padded rows and columns;
//             ds = p (dO.v - delta), dV = P^T dO, dK = scale * dS^T Q.
//   dQ        dQ = scale * dS K.
// delta = rowsum(dO * O) is computed by the caller, as the JAX package
// does outside its pallas_calls.
//
// What bounds them on this card: operations. At the training shapes
// (BH = 128, S = 512, D = 64) each kernel does 4-8 flops per byte of
// q/k/v it must read, and each input tile is reused by every row of the
// block, so the floor is the f32 flops over 67 TFLOP/s (no tensor cores
// in float32). The design keeps the S x S score matrix out of device
// memory and reads each operand tile once per block:
//   - one block of 4 warps per (batch-head, 64 rows): 64 query rows for
//     the forward and dQ, 64 key rows for dK/dV. Each warp owns 16 of
//     them and keeps their accumulators (running max and sum, and the
//     D-wide output rows) in registers; lane l holds output columns
//     l, l + 32, ...;
//   - the other operand streams through shared memory in tiles of 32
//     rows, one row a lane while scoring: lane j computes the 16 scores
//     of its row j against the warp's 16 rows. Tiles read by lane-row
//     are padded by one float so those reads are free of bank
//     conflicts; the block's own rows are read as broadcasts;
//   - causal blocks skip whole tiles: the forward and dQ stop at the
//     block's last row, dK/dV starts at the tile holding its first key;
//   - the ragged edge is masked inside the kernel (no padding of the
//     inputs); rows past the end are never written.
// Not done yet (later work): tensor cores (TF32 or bf16 wgmma), TMA or
// cp.async double-buffered tiles, float4 shared-memory reads.
//
// The kernels allocate nothing; the caller passes the outputs. Each C
// entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;       // rows each warp owns
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a block owns (64)
constexpr int kTile = 32;              // streamed rows per tile, 1 a lane
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

// Copy rows [r0, r0 + n) of a row-major [S, D] matrix into shared memory
// with row stride ld, times mul; rows at or past S become zeros. D is a
// multiple of 4 and the source is 16-byte aligned: float4 loads.
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const float* __restrict__ src, int r0,
                                      int n, int S, int D, float mul) {
  const int d4 = D / 4;
  for (int i = threadIdx.x; i < n * d4; i += kThreads) {
    const int r = i / d4;
    const int dd = (i % d4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      v = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + r) * D + dd);
    float* o = dst + r * ld + dd;
    o[0] = v.x * mul;
    o[1] = v.y * mul;
    o[2] = v.z * mul;
    o[3] = v.w * mul;
  }
}

// Copy n entries [r0, r0 + n) of a length-S vector; zeros past S.
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = r0 + i < S ? src[r0 + i] : 0.f;
}

// ---------------------------------------------------------------- fwd
// grid (BH, ceil(Sq / 64)). NE = accumulator floats per lane per row:
// D <= 32 * NE.
template <int NE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int D,
                 int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                     // [kRows][D], pre-scaled
  float* ks = qs + kRows * D;           // [kTile][D + 1]
  float* vs = ks + kTile * (D + 1);     // [kTile][D]

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;

  stage(qs, D, qb, q0, kRows, Sq, D, scale);

  // the keys this block reads: all of them, or up to its last row
  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;

  int limit[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NE];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + warp * kRowsPerWarp + i;
    // a row past the end sees no key; a causal row sees keys <= qpos
    limit[i] = qpos >= Sq ? -1 : (causal ? min(qpos, Sk - 1) : Sk - 1);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is ready)
    stage(ks, D + 1, kb, t0, kTile, Sk, D, 1.f);
    stage(vs, D, vb, t0, kTile, Sk, D, 1.f);
    __syncthreads();

    // scores: lane j scores key t0 + j against each of the warp's rows
    const int t = t0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* kr = ks + lane * (D + 1);
    const float* qw = qs + warp * kRowsPerWarp * D;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] = fmaf(qw[i * D + d], kd, s[i]);
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
    const int n_here = min(kTile, n_keys - t0);
    for (int j = 0; j < n_here; ++j) {
      float vd[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = lane + 32 * e;
        vd[e] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[i][e] = fmaf(pj, vd[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + warp * kRowsPerWarp + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], FLT_MIN);
    float* orow = o + (bh * Sq + qpos) * D;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) orow[d] = acc[i][e] / denom;
    }
    if (lane == 0) lse[bh * Sq + qpos] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------- dK dV
// grid (BH, ceil(Sk / 64)): the block owns 64 keys and streams query
// tiles of 32 rows, from the first tile a causal key can see.
template <int NE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int Sq, int Sk, int D, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;                       // [kRows][D]
  float* vs = ks + kRows * D;             // [kRows][D]
  float* qs = vs + kRows * D;             // [kTile][D + 1]
  float* dos = qs + kTile * (D + 1);      // [kTile][D + 1]
  float* lses = dos + kTile * (D + 1);    // [kTile]
  float* deltas = lses + kTile;           // [kTile]

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + bh * Sq * D;
  const float* dob = dout + bh * Sq * D;
  const float* lseb = lse + bh * Sq;
  const float* deltab = delta + bh * Sq;

  stage(ks, D, k + bh * Sk * D, k0, kRows, Sk, D, 1.f);
  stage(vs, D, v + bh * Sk * D, k0, kRows, Sk, D, 1.f);

  float acc_k[kRowsPerWarp][NE], acc_v[kRowsPerWarp][NE];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  const int kw = k0 + warp * kRowsPerWarp;  // the warp's first key
  // query tiles wholly before this block's first key see none of it
  const int start = causal ? (k0 / kTile) * kTile : 0;
  for (int t0 = start; t0 < Sq; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and ks/vs ready)
    stage(qs, D + 1, qb, t0, kTile, Sq, D, 1.f);
    stage(dos, D + 1, dob, t0, kTile, Sq, D, 1.f);
    stage_vec(lses, lseb, t0, kTile, Sq);
    stage_vec(deltas, deltab, t0, kTile, Sq);
    __syncthreads();

    // lane j: query row t0 + j against each of the warp's 16 keys
    const int qpos = t0 + lane;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
    const float* qr = qs + lane * (D + 1);
    const float* dor = dos + lane * (D + 1);
    const float* kwr = ks + warp * kRowsPerWarp * D;
    const float* vwr = vs + warp * kRowsPerWarp * D;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
      const float dod = dor[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] = fmaf(qd, kwr[i * D + d], s[i]);
        dp[i] = fmaf(dod, vwr[i * D + d], dp[i]);
      }
    }
    const float lse_j = lses[lane];
    const float delta_j = deltas[lane];
    float p[kRowsPerWarp], ds[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int kpos = kw + i;
      // padded rows and columns are zeroed, not just masked
      const bool keep = qpos < Sq && kpos < Sk && (!causal || qpos >= kpos);
      p[i] = keep ? expf(s[i] * scale - lse_j) : 0.f;
      ds[i] = p[i] * (dp[i] - delta_j);
    }

    // dV[key][d] += sum_j p[j] dO[j][d]; dK[key][d] += sum_j ds[j] Q[j][d]
    const int n_here = min(kTile, Sq - t0);
    for (int j = 0; j < n_here; ++j) {
      float qd[NE], dod[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = lane + 32 * e;
        qd[e] = d < D ? qs[j * (D + 1) + d] : 0.f;
        dod[e] = d < D ? dos[j * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
        const float dsj = __shfl_sync(0xffffffffu, ds[i], j);
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          acc_v[i][e] = fmaf(pj, dod[e], acc_v[i][e]);
          acc_k[i][e] = fmaf(dsj, qd[e], acc_k[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int kpos = kw + i;
    if (kpos >= Sk) continue;
    float* dkr = dk + (bh * Sk + kpos) * D;
    float* dvr = dv + (bh * Sk + kpos) * D;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        dkr[d] = acc_k[i][e] * scale;
        dvr[d] = acc_v[i][e];
      }
    }
  }
}

// ---------------------------------------------------------------- dQ
// grid (BH, ceil(Sq / 64)): the block owns 64 query rows and streams key
// tiles of 32 rows, up to its last row when causal.
template <int NE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, int D,
                    int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                       // [kRows][D]
  float* dos = qs + kRows * D;            // [kRows][D]
  float* ks = dos + kRows * D;            // [kTile][D + 1]
  float* vs = ks + kTile * (D + 1);       // [kTile][D + 1]
  float* lses = vs + kTile * (D + 1);     // [kRows]
  float* deltas = lses + kRows;           // [kRows]

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;

  stage(qs, D, q + bh * Sq * D, q0, kRows, Sq, D, 1.f);
  stage(dos, D, dout + bh * Sq * D, q0, kRows, Sq, D, 1.f);
  stage_vec(lses, lse + bh * Sq, q0, kRows, Sq);
  stage_vec(deltas, delta + bh * Sq, q0, kRows, Sq);

  float acc[kRowsPerWarp][NE];
  int limit[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + warp * kRowsPerWarp + i;
    limit[i] = qpos >= Sq ? -1 : (causal ? min(qpos, Sk - 1) : Sk - 1);
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int rw = warp * kRowsPerWarp;  // the warp's first row in the block
  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs/dos ready)
    stage(ks, D + 1, kb, t0, kTile, Sk, D, 1.f);
    stage(vs, D + 1, vb, t0, kTile, Sk, D, 1.f);
    __syncthreads();

    // lane j: key t0 + j against each of the warp's 16 query rows
    const int t = t0 + lane;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
    const float* kr = ks + lane * (D + 1);
    const float* vr = vs + lane * (D + 1);
    const float* qw = qs + rw * D;
    const float* dow = dos + rw * D;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
      const float vd = vr[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] = fmaf(qw[i * D + d], kd, s[i]);
        dp[i] = fmaf(dow[i * D + d], vd, dp[i]);
      }
    }
    float ds[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool keep = t <= limit[i];
      const float p = keep ? expf(s[i] * scale - lses[rw + i]) : 0.f;
      ds[i] = p * (dp[i] - deltas[rw + i]);
    }

    // dQ[row][d] += sum_j ds[row][j] K[j][d]; lane owns d = lane + 32e
    const int n_here = min(kTile, n_keys - t0);
    for (int j = 0; j < n_here; ++j) {
      float kd[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = lane + 32 * e;
        kd[e] = d < D ? ks[j * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], j);
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[i][e] = fmaf(dsj, kd[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + rw + i;
    if (qpos >= Sq) continue;
    float* dqr = dq + (bh * Sq + qpos) * D;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) dqr[d] = acc[i][e] * scale;
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t floats(size_t n) { return sizeof(float) * n; }

template <int NE>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int BH, int Sq, int Sk, int D,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem = floats(static_cast<size_t>(kRows) * D
                             + static_cast<size_t>(kTile) * (D + 1)
                             + static_cast<size_t>(kTile) * D);
  cudaError_t e = allow_smem(flash_fwd_kernel<NE>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  flash_fwd_kernel<NE><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

template <int NE>
cudaError_t launch_dkdv(const float* q, const float* k, const float* v,
                        const float* dout, const float* lse,
                        const float* delta, float* dk, float* dv, int BH,
                        int Sq, int Sk, int D, int causal, float scale,
                        cudaStream_t stream) {
  const size_t smem = floats(2 * static_cast<size_t>(kRows) * D
                             + 2 * static_cast<size_t>(kTile) * (D + 1)
                             + 2 * static_cast<size_t>(kTile));
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<NE>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sk + kRows - 1) / kRows);
  flash_bwd_dkdv_kernel<NE><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

template <int NE>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse,
                      const float* delta, float* dq, int BH, int Sq, int Sk,
                      int D, int causal, float scale, cudaStream_t stream) {
  const size_t smem = floats(2 * static_cast<size_t>(kRows) * D
                             + 2 * static_cast<size_t>(kTile) * (D + 1)
                             + 2 * static_cast<size_t>(kRows));
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<NE>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<NE><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

// head_dim: a multiple of 4 (float4 staging), at most 128
bool bad_shape(int BH, int Sq, int Sk, int D) {
  return BH < 0 || Sq < 0 || Sk < 0 || D <= 0 || D > 128 || D % 4 ||
         Sq > 65535 * kRows || Sk > 65535 * kRows;
}

}  // namespace

extern "C" {

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Sq, int Sk, int D, int causal,
                  float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return cudaSuccess;
  auto fq = static_cast<const float*>(q);
  auto fk = static_cast<const float*>(k);
  auto fv = static_cast<const float*>(v);
  auto fo = static_cast<float*>(o);
  auto fl = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D <= 32)
    e = launch_fwd<1>(fq, fk, fv, fo, fl, BH, Sq, Sk, D, causal, scale, st);
  else if (D <= 64)
    e = launch_fwd<2>(fq, fk, fv, fo, fl, BH, Sq, Sk, D, causal, scale, st);
  else
    e = launch_fwd<4>(fq, fk, fv, fo, fl, BH, Sq, Sk, D, causal, scale, st);
  return static_cast<int>(e);
}

int flash_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int Sq, int Sk, int D,
                       int causal, float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  if (BH == 0 || Sk == 0) return cudaSuccess;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<float*>(dk), static_cast<float*>(dv), BH,
                    Sq, Sk, D, causal, scale,
                    static_cast<cudaStream_t>(stream));
  };
  cudaError_t e;
  if (D <= 32)
    e = args(launch_dkdv<1>);
  else if (D <= 64)
    e = args(launch_dkdv<2>);
  else
    e = args(launch_dkdv<4>);
  return static_cast<int>(e);
}

int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int BH, int Sq, int Sk, int D, int causal,
                     float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return cudaSuccess;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<float*>(dq), BH, Sq, Sk, D, causal, scale,
                    static_cast<cudaStream_t>(stream));
  };
  cudaError_t e;
  if (D <= 32)
    e = args(launch_dq<1>);
  else if (D <= 64)
    e = args(launch_dq<2>);
  else
    e = args(launch_dq<4>);
  return static_cast<int>(e);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
