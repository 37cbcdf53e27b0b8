// LayerNorm-fused projection-free attention forward, float32 or bfloat16
// operands, for sm_90a.
//
// Replaces the Pallas TPU kernel `_attn_ln_fwd_kernel` of
// dostransformer_tpu/ops/attention.py (launched by `_fused_attention_ln_fwd`,
// public name `fused_attention_ln`). The pre-LN transformer layer applies
// ONE LayerNorm (scale, bias, eps) to its query, key and value inputs and
// feeds the three results to the attention only:
//
//   q = LN(x)   k = LN(x_k)   v = LN(x_v)
//   out[b] = softmax(q[b] k[b]^T * D^-0.5 + bias[b]) v[b]
//
// LN statistics in f32 with the two-pass variance (mean, then mean of
// squared differences); q, k and v are rounded to the operand dtype as the
// plain version rounds them, scores and softmax are f32. No LN output
// reaches device memory.
//
// What bounds it on an H100: as the unfused attention kernel
// (attention.cu), 4 * Lq * Lk * D flops per batch element on the FP32 pipes
// (0.66 GFLOP at the flagship self-attention 16 x 201 x 201 x 256); the
// operands (13.2 MB there) stay in L2. Fusion saves the three LN outputs'
// round trip through device memory and two or three launches.
//
// Design: the attention kernel of attention.cu (one block per 16 query rows
// and batch element, 8 warps, 2 query rows per warp, 32-key tiles staged in
// shared memory, online f32 softmax) with the normalisation applied as each
// row is staged. A block that normalised its own key tiles from scratch
// would redo every key row's two reductions once per query block (13 times
// at 201 queries), so a small first kernel of the same launch computes only
// the per-row statistics (mu, rstd): one warp per row, the row in
// registers, two shuffle reductions, 8 bytes written per row. The main
// kernel then normalises on load with two multiply-adds per element and no
// reduction. Rows that are one tensor get their statistics once: when x_k
// and x_v (or all three) alias, their statistics are shared, and a K tile's
// normalised rows are stored as the V tile without a second load; the
// arithmetic per row is the same either way, so the result does not depend
// on the aliasing. A row whose keys are all masked sees every score at
// -1e30 and averages the normalised values uniformly, as attention.cu does.
// The TPU kernel's column mask and zero-padded scale and bias exist for its
// lane padding and are not reproduced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;       // query rows per warp
constexpr int kTileQ = kWarps * kRows;  // query rows per block
constexpr int kTileK = 32;     // keys per tile (1 per lane)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// elements 4c .. 4c+3 of a row, as floats
__device__ __forceinline__ float4 load4(const float* row, int c) {
  return reinterpret_cast<const float4*>(row)[c];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c) {
  const uint2 raw = reinterpret_cast<const uint2*>(row)[c];
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// a value as the operand dtype holds it
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// LN of 4 elements given the row's statistics: ((x - mu) * rstd) * s + b
template <typename T>
__device__ __forceinline__ float4 normalise(float4 x, float mu, float rstd,
                                            float4 s, float4 b) {
  float4 y;
  y.x = rounded<T>((x.x - mu) * rstd * s.x + b.x);
  y.y = rounded<T>((x.y - mu) * rstd * s.y + b.y);
  y.z = rounded<T>((x.z - mu) * rstd * s.z + b.z);
  y.w = rounded<T>((x.w - mu) * rstd * s.w + b.w);
  return y;
}

// Up to three row sets whose statistics one launch computes.
struct StatsJobs {
  const void* x[3];
  float* stats[3];
  int rows[3];
  int n;
};

// stats[r] = (mean, 1 / sqrt(var + eps)) of row r, two-pass variance; one
// warp per row, D = 32 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
ln_stats_kernel(StatsJobs jobs, float eps) {
  constexpr int D = 32 * NC;
  const int lane = threadIdx.x % 32;
  int r = blockIdx.x * kWarps + threadIdx.x / 32;
  const T* x = nullptr;
  float* stats = nullptr;
  for (int j = 0; j < 3; ++j) {
    if (j >= jobs.n) break;
    if (r < jobs.rows[j]) {
      x = static_cast<const T*>(jobs.x[j]);
      stats = jobs.stats[j];
      break;
    }
    r -= jobs.rows[j];
  }
  if (x == nullptr) return;  // past the last row (no block-wide sync below)
  const T* row = x + (size_t)r * D;
  float v[NC];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    v[c] = to_float(row[lane + 32 * c]);
    sum += v[c];
  }
  const float mu = warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float d = v[c] - mu;
    sq = fmaf(d, d, sq);
  }
  const float var = warp_sum(sq) / (float)D;
  if (lane == 0) {
    stats[2 * (size_t)r] = mu;
    stats[2 * (size_t)r + 1] = 1.f / sqrtf(var + eps);
  }
}

constexpr size_t smem_floats(int d) {
  return (size_t)kTileQ * d + (size_t)kTileK * (d + 4) + (size_t)kTileK * d +
         2 * (size_t)d;
}

// D = 32 * NC feature columns; each lane owns columns lane + 32 * c.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
attn_ln_fwd_kernel(const T* x, const T* xk, const T* xv,  // may alias
                   const float* stats_q, const float* stats_k,
                   const float* stats_v, const float* __restrict__ lns,
                   const float* __restrict__ lnb,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int Lq, int Lk, float scale) {
  constexpr int D = 32 * NC;
  constexpr int D4 = D / 4;
  constexpr int KS = D + 4;  // padded K row stride (floats)
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [kTileQ][D]
  float* k_s = q_s + kTileQ * D;          // [kTileK][KS]
  float* v_s = k_s + kTileK * KS;         // [kTileK][D]
  float* s_s = v_s + kTileK * D;          // [D] LN scale
  float* b_s = s_s + D;                   // [D] LN bias
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool kv_same = xk == xv;  // one tensor: one load serves K and V

  for (int c = threadIdx.x; c < D; c += kThreads) {
    s_s[c] = lns[c];
    b_s[c] = lnb[c];
  }
  __syncthreads();

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = threadIdx.x; idx < kTileQ * D4; idx += kThreads) {
    const int i = idx / D4;
    const int c = idx % D4;
    float4 val = zero4;
    if (q0 + i < Lq) {
      const size_t row = (size_t)b * Lq + q0 + i;
      val = normalise<T>(load4(x + row * D, c), stats_q[2 * row],
                         stats_q[2 * row + 1],
                         reinterpret_cast<const float4*>(s_s)[c],
                         reinterpret_cast<const float4*>(b_s)[c]);
    }
    reinterpret_cast<float4*>(q_s + i * D)[c] = val;
  }

  float m_run[kRows], l_run[kRows], o[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    __syncthreads();  // q_s is loaded / the previous key tile is consumed
    for (int idx = threadIdx.x; idx < kTileK * D4; idx += kThreads) {
      const int j = idx / D4;
      const int c = idx % D4;
      float4 kv = zero4, vv = zero4;
      if (k0 + j < Lk) {
        const size_t row = (size_t)b * Lk + k0 + j;
        const float4 s4 = reinterpret_cast<const float4*>(s_s)[c];
        const float4 b4 = reinterpret_cast<const float4*>(b_s)[c];
        kv = normalise<T>(load4(xk + row * D, c), stats_k[2 * row],
                          stats_k[2 * row + 1], s4, b4);
        vv = kv_same ? kv
                     : normalise<T>(load4(xv + row * D, c), stats_v[2 * row],
                                    stats_v[2 * row + 1], s4, b4);
      }
      reinterpret_cast<float4*>(k_s + j * KS)[c] = kv;
      reinterpret_cast<float4*>(v_s + j * D)[c] = vv;
    }
    __syncthreads();

    const int j = k0 + lane;
    const bool valid = j < Lk;
    const float bj = valid ? bias[(size_t)b * Lk + j] : 0.f;
    // scores of this lane's key against the warp's rows: each K element
    // read from shared memory feeds all kRows rows
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * KS);
    const float4* qrow = reinterpret_cast<const float4*>(q_s + warp * kRows * D);
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D4; ++c) {
      const float4 kk = krow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = qrow[r * D4 + c];
        s[r] = fmaf(a.x, kk.x, s[r]);
        s[r] = fmaf(a.y, kk.y, s[r]);
        s[r] = fmaf(a.z, kk.z, s[r]);
        s[r] = fmaf(a.w, kk.w, s[r]);
      }
    }
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sr = valid ? s[r] * scale + bj : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(sr));
      p[r] = valid ? expf(sr - m_new) : 0.f;
      const float corr = expf(m_run[r] - m_new);  // 0 on the first tile
      l_run[r] = l_run[r] * corr + warp_sum(p[r]);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= corr;
    }
    // o += p V over the tile: each V element read once feeds all rows
    for (int jj = 0; jj < kTileK; ++jj) {
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pj[r] = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = v_s[jj * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) o[r][c] = fmaf(pj[r], vv, o[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i >= Lq) continue;
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(out + ((size_t)b * Lq + i) * D + lane + 32 * c, o[r][c] * inv);
  }
}

template <typename T, int NC>
cudaError_t launch(const void* x, const void* xk, const void* xv,
                   const float* lns, const float* lnb, const float* bias,
                   void* out, float* stats, int B, int Lq, int Lk,
                   float scale, float eps, cudaStream_t st) {
  // statistics once per distinct tensor: q rows first, then k, then v
  const bool k_is_q = xk == x && Lk == Lq;
  const bool v_is_k = xv == xk;
  const bool v_is_q = xv == x && Lk == Lq;
  float* stats_q = stats;
  float* stats_k = k_is_q ? stats_q : stats + 2 * (size_t)B * Lq;
  float* stats_v = v_is_k ? stats_k
                   : v_is_q ? stats_q
                            : stats + 2 * (size_t)B * (Lq + Lk);
  StatsJobs jobs = {};
  int total = 0;
  auto add = [&](const void* p, float* s, int rows) {
    jobs.x[jobs.n] = p;
    jobs.stats[jobs.n] = s;
    jobs.rows[jobs.n] = rows;
    ++jobs.n;
    total += rows;
  };
  add(x, stats_q, B * Lq);
  if (!k_is_q) add(xk, stats_k, B * Lk);
  if (!v_is_k && !v_is_q) add(xv, stats_v, B * Lk);
  ln_stats_kernel<T, NC><<<(total + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      jobs, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = smem_floats(32 * NC) * sizeof(float);
  err = cudaFuncSetAttribute(attn_ln_fwd_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kTileQ - 1) / kTileQ, B);
  attn_ln_fwd_kernel<T, NC><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(xk),
      static_cast<const T*>(xv), stats_q, stats_k, stats_v, lns, lnb, bias,
      static_cast<T*>(out), Lq, Lk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* xk, const void* xv,
                     const float* lns, const float* lnb, const float* bias,
                     void* out, float* stats, int B, int Lq, int Lk, int D,
                     float scale, float eps, cudaStream_t st) {
  switch (D / 32) {
#define DOSTPU_CASE(nc)                                                    \
  case nc:                                                                 \
    return launch<T, nc>(x, xk, xv, lns, lnb, bias, out, stats, B, Lq, Lk, \
                         scale, eps, st);
    DOSTPU_CASE(1) DOSTPU_CASE(2) DOSTPU_CASE(3) DOSTPU_CASE(4)
    DOSTPU_CASE(5) DOSTPU_CASE(6) DOSTPU_CASE(7) DOSTPU_CASE(8)
    DOSTPU_CASE(9) DOSTPU_CASE(10) DOSTPU_CASE(11) DOSTPU_CASE(12)
    DOSTPU_CASE(13) DOSTPU_CASE(14) DOSTPU_CASE(15) DOSTPU_CASE(16)
#undef DOSTPU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// All pointers are device pointers into contiguous, 16-byte aligned tensors:
// x and out [B, Lq, D], xk and xv [B, Lk, D] (float32, or bfloat16 when
// `bf16` is non-zero; xk, xv and x may be one tensor); lns and lnb [D], bias
// [B, Lk] and the scratch `stats` [2 * B * (Lq + 2 * Lk)] float32. D must
// be a multiple of 32 and at most dostpu_attention_max_dim(). Returns the
// CUDA error code of the launches (0 on success).
extern "C" int dostpu_attention_ln_fwd(const void* x, const void* xk,
                                       const void* xv, const float* lns,
                                       const float* lnb, const float* bias,
                                       void* out, float* stats, int B, int Lq,
                                       int Lk, int D, float scale, float eps,
                                       int bf16, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D <= 0 || D % 32 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(x, xk, xv, lns, lnb, bias, out, stats, B,
                                   Lq, Lk, D, scale, eps, st);
  return dispatch<float>(x, xk, xv, lns, lnb, bias, out, stats, B, Lq, Lk, D,
                         scale, eps, st);
}
