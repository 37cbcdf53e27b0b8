// Projection-free attention backward, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_attn_bwd_kernel` of
// dostransformer_tpu/ops/attention.py (launched by `_fused_attention_bwd`
// and `_fused_attention_bwd_nopad`; its oracle is `_softmax_attn_bwd`). With
// s = q k^T * D^-0.5 + bias, p = softmax(s) (f32) and upstream gradient g of
// out = p v:
//
//   dv = p^T g,  dp = g v^T,  ds = p * (dp - rowsum(dp * p)),
//   dq = ds k * D^-0.5,  dk = ds^T q * D^-0.5.
//
// What bounds it on an H100: 8*Lq*Lk*D flops per batch element on the FP32
// pipes (scores twice, dp, dq, dk, dv; the flagship self-attention, 16 x 201
// x 201 x 256, is 1.3 GFLOP); the operands stay in L2. The TPU kernel held
// the whole [Lq, Lk] score tile in VMEM and wrote dq, dk and dv from one grid
// step; a block here has far less shared memory, and a reduction over blocks
// would need atomics, so the work is split by output instead.
//
// Design, two kernels, no atomics (so the gradients are bit-identical from
// run to run):
//   * dq_kernel: one block per (16 query rows, batch element), 8 warps of 2
//     rows, keys streamed in tiles of 32 (one per lane) as in the forward.
//     A first sweep over the key tiles takes each row's max m and sum l of
//     exp(s - m); delta = rowsum(g * o), which equals rowsum(dp * p). A
//     second sweep forms p = exp(s - m) / l, dp and ds and accumulates dq.
//     m, l and delta go to scratch for the second kernel. m and l are kept
//     apart, never as one log-sum-exp: a row whose keys are all masked has
//     m = -1e30, and -1e30 + log(Lk) rounds back to -1e30 in f32, which would
//     give p = 1 instead of 1/Lk on every key.
//   * dkv_kernel: one block per (16 keys, batch element), 8 warps of 2 keys;
//     it loops over all query tiles of 32 (one per lane), recomputes p and
//     ds from the stored m, l and delta, and accumulates dk and dv in
//     registers. Scores are summed in the same order as in dq_kernel, so both
//     kernels see the same p.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 2;       // query rows (dq) or keys (dk, dv) per warp
constexpr int kTileR = kThreads / 32 * kRows;  // rows per block
constexpr int kTileL = 32;     // keys (dq) or queries (dk, dv) per tile

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

// dot of a [D] row in shared memory with kRows rows (row stride D)
template <int D4>
__device__ __forceinline__ void dots(const float4* lane_row,
                                     const float4* rows, float (&out)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D4; ++c) {
    const float4 x = lane_row[c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 a = rows[r * D4 + c];
      out[r] = fmaf(a.x, x.x, out[r]);
      out[r] = fmaf(a.y, x.y, out[r]);
      out[r] = fmaf(a.z, x.z, out[r]);
      out[r] = fmaf(a.w, x.w, out[r]);
    }
  }
}

// rows [n][D] of src (global, row stride D) -> dst (shared, row stride
// stride), zero past `valid` rows
template <int D4>
__device__ __forceinline__ void stage(float* dst, int stride, const float* src,
                                      int n, int valid) {
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = threadIdx.x; idx < n * D4; idx += kThreads) {
    const int i = idx / D4;
    const int c = idx % D4;
    reinterpret_cast<float4*>(dst + i * stride)[c] =
        i < valid ? reinterpret_cast<const float4*>(src + (size_t)i * D4 * 4)[c]
                  : zero4;
  }
}

template <int NC>
constexpr size_t smem_floats() {
  // two [kTileR][D] blocks and two [kTileL][D + 4] tiles, plus 3 x kTileL
  return (size_t)2 * kTileR * 32 * NC + (size_t)2 * kTileL * (32 * NC + 4)
         + 3 * kTileL;
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ bias,
          const float* __restrict__ o, const float* __restrict__ g,
          float* __restrict__ dq, float* __restrict__ m_out,
          float* __restrict__ l_out, float* __restrict__ delta_out, int Lq,
          int Lk, float scale) {
  constexpr int D = 32 * NC;
  constexpr int D4 = D / 4;
  constexpr int KS = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // [kTileR][D]
  float* g_s = q_s + kTileR * D;  // [kTileR][D]
  float* k_s = g_s + kTileR * D;  // [kTileL][KS]
  float* v_s = k_s + kTileL * KS; // [kTileL][KS]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kTileR, Lq - q0);
  const float* kb = k + (size_t)b * Lk * D;
  const float* vb = v + (size_t)b * Lk * D;

  stage<D4>(q_s, D, q + ((size_t)b * Lq + q0) * D, kTileR, nq);
  stage<D4>(g_s, D, g + ((size_t)b * Lq + q0) * D, kTileR, nq);
  const float4* qrow = reinterpret_cast<const float4*>(q_s + warp * kRows * D);
  const float4* grow = reinterpret_cast<const float4*>(g_s + warp * kRows * D);

  // delta = rowsum(g * o)
  float delta[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    float s = 0.f;
    if (i < Lq) {
      for (int c = lane; c < D; c += 32)
        s = fmaf(g[((size_t)b * Lq + i) * D + c], o[((size_t)b * Lq + i) * D + c],
                 s);
    }
    delta[r] = warp_sum(s);
  }

  // sweep 1: row max and sum
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  for (int k0 = 0; k0 < Lk; k0 += kTileL) {
    __syncthreads();
    stage<D4>(k_s, KS, kb + (size_t)k0 * D, kTileL, min(kTileL, Lk - k0));
    __syncthreads();
    const int j = k0 + lane;
    const bool valid = j < Lk;
    const float bj = valid ? bias[(size_t)b * Lk + j] : 0.f;
    float s[kRows];
    dots<D4>(reinterpret_cast<const float4*>(k_s + lane * KS), qrow, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sr = valid ? s[r] * scale + bj : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(sr));
      const float p = valid ? expf(sr - m_new) : 0.f;
      l_run[r] = l_run[r] * expf(m_run[r] - m_new) + warp_sum(p);
      m_run[r] = m_new;
    }
  }

  // sweep 2: p, dp, ds; dq += ds k
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += kTileL) {
    __syncthreads();
    const int nk = min(kTileL, Lk - k0);
    stage<D4>(k_s, KS, kb + (size_t)k0 * D, kTileL, nk);
    stage<D4>(v_s, KS, vb + (size_t)k0 * D, kTileL, nk);
    __syncthreads();
    const int j = k0 + lane;
    const bool valid = j < Lk;
    const float bj = valid ? bias[(size_t)b * Lk + j] : 0.f;
    float s[kRows], dpv[kRows], ds[kRows];
    dots<D4>(reinterpret_cast<const float4*>(k_s + lane * KS), qrow, s);
    dots<D4>(reinterpret_cast<const float4*>(v_s + lane * KS), grow, dpv);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = valid ? expf(s[r] * scale + bj - m_run[r]) / l_run[r]
                            : 0.f;
      ds[r] = p * (dpv[r] - delta[r]);
    }
    for (int jj = 0; jj < nk; ++jj) {
      float dsj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dsj[r] = __shfl_sync(0xffffffffu, ds[r], jj);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = k_s[jj * KS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(dsj[r], kv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i >= Lq) continue;
    const size_t row = (size_t)b * Lq + i;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[row * D + lane + 32 * c] = acc[r][c] * scale;
    if (lane == 0) {
      m_out[row] = m_run[r];
      l_out[row] = l_run[r];
      delta_out[row] = delta[r];
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
           const float* __restrict__ g, const float* __restrict__ m_in,
           const float* __restrict__ l_in, const float* __restrict__ delta_in,
           float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
           float scale) {
  constexpr int D = 32 * NC;
  constexpr int D4 = D / 4;
  constexpr int QS = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;               // [kTileR][D]
  float* v_s = k_s + kTileR * D;   // [kTileR][D]
  float* q_s = v_s + kTileR * D;   // [kTileL][QS]
  float* g_s = q_s + kTileL * QS;  // [kTileL][QS]
  float* m_s = g_s + kTileL * QS;  // [kTileL]
  float* l_s = m_s + kTileL;       // [kTileL]
  float* d_s = l_s + kTileL;       // [kTileL]
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kTileR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = min(kTileR, Lk - j0);

  stage<D4>(k_s, D, k + ((size_t)b * Lk + j0) * D, kTileR, nk);
  stage<D4>(v_s, D, v + ((size_t)b * Lk + j0) * D, kTileR, nk);
  const float4* krow = reinterpret_cast<const float4*>(k_s + warp * kRows * D);
  const float4* vrow = reinterpret_cast<const float4*>(v_s + warp * kRows * D);
  float bj[kRows];
  bool kvalid[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = j0 + warp * kRows + r;
    kvalid[r] = j < Lk;
    bj[r] = kvalid[r] ? bias[(size_t)b * Lk + j] : 0.f;
  }

  float acc_k[kRows][NC], acc_v[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int i0 = 0; i0 < Lq; i0 += kTileL) {
    __syncthreads();
    const int nq = min(kTileL, Lq - i0);
    stage<D4>(q_s, QS, q + ((size_t)b * Lq + i0) * D, kTileL, nq);
    stage<D4>(g_s, QS, g + ((size_t)b * Lq + i0) * D, kTileL, nq);
    if (threadIdx.x < kTileL) {
      const int i = i0 + threadIdx.x;
      const bool ok = i < Lq;
      const size_t row = (size_t)b * Lq + i;
      m_s[threadIdx.x] = ok ? m_in[row] : 0.f;
      l_s[threadIdx.x] = ok ? l_in[row] : 1.f;
      d_s[threadIdx.x] = ok ? delta_in[row] : 0.f;
    }
    __syncthreads();
    // lane = query i0 + lane against the warp's keys
    const bool qvalid = lane < nq;
    float s[kRows], dpv[kRows], p[kRows], ds[kRows];
    dots<D4>(reinterpret_cast<const float4*>(q_s + lane * QS), krow, s);
    dots<D4>(reinterpret_cast<const float4*>(g_s + lane * QS), vrow, dpv);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r] = (qvalid && kvalid[r])
                 ? expf(s[r] * scale + bj[r] - m_s[lane]) / l_s[lane]
                 : 0.f;
      ds[r] = p[r] * (dpv[r] - d_s[lane]);
    }
    for (int ii = 0; ii < nq; ++ii) {
      float pi[kRows], dsi[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pi[r] = __shfl_sync(0xffffffffu, p[r], ii);
        dsi[r] = __shfl_sync(0xffffffffu, ds[r], ii);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float gv = g_s[ii * QS + lane + 32 * c];
        const float qv = q_s[ii * QS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc_v[r][c] = fmaf(pi[r], gv, acc_v[r][c]);
          acc_k[r][c] = fmaf(dsi[r], qv, acc_k[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!kvalid[r]) continue;
    const size_t row = (size_t)b * Lk + j0 + warp * kRows + r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[row * D + lane + 32 * c] = acc_k[r][c] * scale;
      dv[row * D + lane + 32 * c] = acc_v[r][c];
    }
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const float* o, const float* g,
                   float* dq, float* dk, float* dv, float* stats, int B,
                   int Lq, int Lk, float scale, cudaStream_t st) {
  const size_t smem = smem_floats<NC>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const size_t rows = (size_t)B * Lq;
  float* m = stats;
  float* l = stats + rows;
  float* delta = stats + 2 * rows;
  dq_kernel<NC><<<dim3((Lq + kTileR - 1) / kTileR, B), kThreads, smem, st>>>(
      q, k, v, bias, o, g, dq, m, l, delta, Lq, Lk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<NC><<<dim3((Lk + kTileR - 1) / kTileR, B), kThreads, smem, st>>>(
      q, k, v, bias, g, m, l, delta, dk, dv, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers into contiguous, 16-byte aligned float32
// tensors: q/o/g [B, Lq, D], k/v [B, Lk, D], bias [B, Lk]; outputs dq
// [B, Lq, D], dk/dv [B, Lk, D]; stats is scratch of 3 * B * Lq floats (row
// max, row sum, delta). D must be a multiple of 32 and at most
// dostpu_attention_max_dim(). Returns the CUDA error code of the launches.
extern "C" int dostpu_attention_bwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    const float* o, const float* g, float* dq,
                                    float* dk, float* dv, float* stats, int B,
                                    int Lq, int Lk, int D, float scale,
                                    void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D % 32 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / 32) {
#define DOSTPU_CASE(nc) \
  case nc:              \
    return launch<nc>(q, k, v, bias, o, g, dq, dk, dv, stats, B, Lq, Lk, scale, st);
    DOSTPU_CASE(1) DOSTPU_CASE(2) DOSTPU_CASE(3) DOSTPU_CASE(4)
    DOSTPU_CASE(5) DOSTPU_CASE(6) DOSTPU_CASE(7) DOSTPU_CASE(8)
    DOSTPU_CASE(9) DOSTPU_CASE(10) DOSTPU_CASE(11) DOSTPU_CASE(12)
    DOSTPU_CASE(13) DOSTPU_CASE(14) DOSTPU_CASE(15) DOSTPU_CASE(16)
#undef DOSTPU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
