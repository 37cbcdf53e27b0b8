// Fused message-passing edge pipeline, forward, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// dostransformer_tpu/ops/fused_mp.py (launched by `_fused_fwd_call`, public
// name `fused_mp_edge`). Per graph b and edge e:
//
//   mid   = src_proj[b, senders[b, e]] + dst_proj[b, receivers[b, e]]
//           + edge_proj[b, e]                                   [M]
//   act   = PReLU(LayerNorm(mid))      (eps 1e-5, f32 statistics, one slope)
//   e_out = act @ W1^T + b1                                     [H]
//   agg[b, n] = sum over e with receivers[b, e] == n of e_out[b, e] * mask[b, e]
//
// What bounds it on an H100: the W1 product is 2*E*M*H flops per graph
// (0.8 GFLOP per flagship batch of 8) on the FP32 pipes, and the gathers
// read 3 rows of M floats per edge. The TPU kernel gathered and scattered
// with one-hot matmuls on the MXU; here the gathers are plain indexed row
// loads and the scatter is a separate deterministic pass.
//
// Design:
//   * edge_kernel: one block per (graph, tile of 16 edges). One warp per edge
//     row gathers mid into shared memory, takes the LayerNorm statistics in
//     two passes (mean, then centred variance) and writes PReLU(LN(mid)) back
//     in place, so the [E, M] intermediates never reach device memory. The
//     W1 product then runs from shared memory: W1 (torch layout [H, M], read
//     as it lies, through L2) streams in [256 x 32] chunks and each thread
//     keeps a 4-edge x 4-output register tile.
//   * agg_kernel: one block per (node, graph, 256 outputs) walks the graph's
//     edges in index order and sums the rows whose receiver is that node. No
//     float atomics, so the sum is the same on every run.
//   * Indices are bound-checked: an out-of-range sender or receiver adds a
//     zero row to mid (as a one-hot row that matches no node did on the TPU)
//     and reaches no node of agg. Pad edges (index 0, mask 0) still get their
//     e_out row, which the caller's edge residual uses.

#include <cuda_runtime.h>

namespace {

constexpr int kTileE = 16;     // edges per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kTileH = 256;    // W1 rows (outputs) per pass
constexpr int kTileM = 32;     // W1 columns per shared-memory chunk
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
edge_kernel(const float* __restrict__ sp, const float* __restrict__ dp,
            const float* __restrict__ ep, const int* __restrict__ senders,
            const int* __restrict__ receivers,
            const float* __restrict__ ln_scale,
            const float* __restrict__ ln_bias,
            const float* __restrict__ alpha, const float* __restrict__ w1,
            const float* __restrict__ b1, float* __restrict__ e_out, int A,
            int E, int M, int H) {
  extern __shared__ float smem[];
  float* act = smem;                  // [kTileE][M]
  float* w_s = smem + kTileE * M;     // [kTileH][kTileM + 1]
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kTileE;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float slope = alpha[0];

  // 1. gather + LayerNorm + PReLU, one warp per edge row
  for (int i = warp; i < kTileE; i += kThreads / 32) {
    float* row = act + i * M;
    const int e = e0 + i;
    if (e >= E) {
      for (int m = lane; m < M; m += 32) row[m] = 0.f;
      continue;
    }
    const int s = senders[b * E + e];
    const int r = receivers[b * E + e];
    const bool s_ok = s >= 0 && s < A;
    const bool r_ok = r >= 0 && r < A;
    const float* sp_row = sp + ((size_t)b * A + (s_ok ? s : 0)) * M;
    const float* dp_row = dp + ((size_t)b * A + (r_ok ? r : 0)) * M;
    const float* ep_row = ep + ((size_t)b * E + e) * M;
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float v = ((s_ok ? sp_row[m] : 0.f) + (r_ok ? dp_row[m] : 0.f))
                      + ep_row[m];
      row[m] = v;
      sum += v;
    }
    const float mean = warp_sum(sum) / M;
    float sq = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float d = row[m] - mean;
      sq += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) / M + kLnEps);
    for (int m = lane; m < M; m += 32) {
      const float n = (row[m] - mean) * rstd * ln_scale[m] + ln_bias[m];
      row[m] = n > 0.f ? n : slope * n;
    }
  }

  // 2. e_out = act @ W1^T + b1: thread (te, th) owns edges te*4 + k and
  //    outputs h0 + th + 64*j, k, j in [0, 4)
  const int th = threadIdx.x % 64;
  const int te = threadIdx.x / 64;
  for (int h0 = 0; h0 < H; h0 += kTileH) {
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
    for (int m0 = 0; m0 < M; m0 += kTileM) {
      __syncthreads();  // act is complete / the previous chunk is consumed
      for (int idx = threadIdx.x; idx < kTileH * kTileM; idx += kThreads) {
        const int hh = idx / kTileM;
        const int mm = idx % kTileM;
        const int h = h0 + hh;
        const int m = m0 + mm;
        w_s[hh * (kTileM + 1) + mm] =
            (h < H && m < M) ? w1[(size_t)h * M + m] : 0.f;
      }
      __syncthreads();
      const int depth = min(kTileM, M - m0);
      for (int mm = 0; mm < depth; ++mm) {
        float av[4], wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) av[k] = act[(te * 4 + k) * M + m0 + mm];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = w_s[(th + 64 * j) * (kTileM + 1) + mm];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[k][j] = fmaf(av[k], wv[j], acc[k][j]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + te * 4 + k;
      if (e >= E) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = h0 + th + 64 * j;
        if (h < H) e_out[((size_t)b * E + e) * H + h] = acc[k][j] + b1[h];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
agg_kernel(const float* __restrict__ e_out, const int* __restrict__ receivers,
           const float* __restrict__ mask, float* __restrict__ agg, int A,
           int E, int H) {
  __shared__ int r_s[kThreads];
  __shared__ float m_s[kThreads];
  const int node = blockIdx.x;
  const int b = blockIdx.y;
  const int h = blockIdx.z * kThreads + threadIdx.x;
  float acc = 0.f;
  for (int c0 = 0; c0 < E; c0 += kThreads) {
    __syncthreads();
    const int e = c0 + threadIdx.x;
    if (e < E) {
      r_s[threadIdx.x] = receivers[b * E + e];
      m_s[threadIdx.x] = mask[b * E + e];
    }
    __syncthreads();
    const int n = min(kThreads, E - c0);
    if (h < H) {
      for (int i = 0; i < n; ++i) {
        if (r_s[i] == node)
          acc += e_out[((size_t)b * E + c0 + i) * H + h] * m_s[i];
      }
    }
  }
  if (h < H) agg[((size_t)b * A + node) * H + h] = acc;
}

}  // namespace

extern "C" size_t dostpu_fused_mp_edge_smem_bytes(int M) {
  return (size_t)(kTileE * M + kTileH * (kTileM + 1)) * sizeof(float);
}

// All pointers are device pointers into contiguous float32 (int32 for the
// indices) tensors: src_proj/dst_proj [B, A, M], edge_proj [B, E, M],
// senders/receivers/edge_mask [B, E], ln_scale/ln_bias [M], alpha [1],
// w1 [H, M] (torch Linear layout), b1 [H]; outputs e_out [B, E, H] and
// agg [B, A, H]. Returns the CUDA error code of the launches (0 on success).
extern "C" int dostpu_fused_mp_edge_fwd(
    const float* src_proj, const float* dst_proj, const float* edge_proj,
    const int* senders, const int* receivers, const float* edge_mask,
    const float* ln_scale, const float* ln_bias, const float* alpha,
    const float* w1, const float* b1, float* e_out, float* agg, int B, int A,
    int E, int M, int H, void* stream) {
  if (B <= 0 || A <= 0 || E <= 0 || M <= 0 || H <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = dostpu_fused_mp_edge_smem_bytes(M);
  cudaError_t err = cudaFuncSetAttribute(
      edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_e((E + kTileE - 1) / kTileE, B);
  edge_kernel<<<grid_e, kThreads, smem, st>>>(
      src_proj, dst_proj, edge_proj, senders, receivers, ln_scale, ln_bias,
      alpha, w1, b1, e_out, A, E, M, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_a(A, B, (H + kThreads - 1) / kThreads);
  agg_kernel<<<grid_a, kThreads, 0, st>>>(e_out, receivers, edge_mask, agg,
                                          A, E, H);
  return cudaGetLastError();
}
