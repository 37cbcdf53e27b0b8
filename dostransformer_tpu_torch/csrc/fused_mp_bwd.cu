// Fused message-passing edge pipeline, backward, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// dostransformer_tpu/ops/fused_mp.py (launched by `_fused_bwd_call`, the VJP
// of `fused_mp_edge`). With the forward
//
//   mid = sp[senders] + dp[receivers] + ep,  xhat = (mid - mean) * rstd,
//   norm = xhat * ln_scale + ln_bias,  act = PReLU(norm),
//   e_out = act @ W1^T + b1,  agg = sum over edges of mask * e_out -> receivers
//
// and upstream gradients g_eout [B, E, H], g_agg [B, A, H], it recomputes the
// forward intermediates and returns the gradients of sp, dp, ep, ln_scale,
// ln_bias, alpha, W1 and b1:
//
//   g_e   = g_eout + mask * g_agg[receivers]
//   g_act = g_e @ W1,  g_norm = PReLU'(norm) g_act,  g_mid = LN'(g_norm)
//   g_ep  = g_mid,  g_sp / g_dp = g_mid summed onto senders / receivers
//   g_W1  = sum over all B*E edges of g_e^T act  (and b1, LN, alpha alike)
//
// What bounds it on an H100: two products of 2*B*E*M*H flops each (g_e @ W1
// and g_e^T act; 0.8 GFLOP each per flagship batch of 8) on the FP32 pipes.
// The TPU kernel carried the parameter gradients in one VMEM block across its
// sequential grid; blocks on the card run in parallel and in no order, and
// float atomics would make the sums differ from run to run.
//
// Design, four deterministic passes (no float atomics, so the gradients are
// bit-identical from run to run):
//   A edge_bwd_kernel: one block per (tile of 16 edges, graph). Recompute
//     mid -> LN -> PReLU per row (one warp per row) with xhat kept in shared
//     memory and act written to scratch; build g_e in shared memory (and
//     scratch); g_act = g_e @ W1 with W1 ([H, M], read as it lies) streamed
//     in [32 x 256] chunks and a 4 x 4 register tile per thread; PReLU and LN
//     backward per row give g_ep; per-block partial sums of the LN, alpha and
//     b1 gradients go to scratch.
//   B gw1_kernel: g_W1 partials over S chunks of the B*E edges, a tiled
//     [64 x 64] product of g_e^T act from shared memory.
//   C node_bwd_kernel: one block per (node, graph, 256 columns) walks the
//     graph's edges in index order and sums the g_mid rows whose sender
//     (g_sp) or receiver (g_dp) is that node. Every edge scatters, pad edges
//     (index 0, mask 0) included, as the TPU kernel's one-hot products do;
//     an out-of-range index reaches no node.
//   D reduce_kernel: sums the partials in a fixed order.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kTileE = 16;     // edges per block in pass A
constexpr int kThreads = 256;  // 8 warps
constexpr int kTileMo = 256;   // g_act columns per pass
constexpr int kTileHr = 32;    // W1 rows per shared-memory chunk
constexpr int kGemmTile = 64;  // g_W1 output tile (h x m)
constexpr int kGemmK = 16;     // edges per g_W1 shared-memory chunk
constexpr int kGemmEdges = 768;  // edges per g_W1 partial
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t edge_smem_floats(int M, int H) {
  return (size_t)2 * kTileE * M + (size_t)kTileE * H
         + (size_t)kTileHr * kTileMo + kTileE + kThreads / 32;
}

int gemm_splits(int N) {
  const int s = (N + kGemmEdges - 1) / kGemmEdges;
  return s < 1 ? 1 : (s > 64 ? 64 : s);
}

__global__ void __launch_bounds__(kThreads)
edge_bwd_kernel(const float* __restrict__ sp, const float* __restrict__ dp,
                const float* __restrict__ ep, const int* __restrict__ senders,
                const int* __restrict__ receivers,
                const float* __restrict__ mask,
                const float* __restrict__ ln_scale,
                const float* __restrict__ ln_bias,
                const float* __restrict__ alpha, const float* __restrict__ w1,
                const float* __restrict__ g_eout,
                const float* __restrict__ g_agg, float* __restrict__ g_ep,
                float* __restrict__ act_out, float* __restrict__ ge_out,
                float* __restrict__ part_lns, float* __restrict__ part_lnb,
                float* __restrict__ part_b1, float* __restrict__ part_alpha,
                int A, int E, int M, int H) {
  extern __shared__ float smem[];
  float* xhat_s = smem;                     // [kTileE][M]
  float* gact_s = xhat_s + kTileE * M;      // [kTileE][M]: g_act, then g_norm
  float* ge_s = gact_s + kTileE * M;        // [kTileE][H]
  float* w_s = ge_s + kTileE * H;           // [kTileHr][kTileMo]
  float* rstd_s = w_s + kTileHr * kTileMo;  // [kTileE]
  float* alpha_s = rstd_s + kTileE;         // [kThreads / 32]
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kTileE;
  const int blk = b * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float slope = alpha[0];

  // 1. recompute mid -> LN -> PReLU (one warp per row); build g_e
  for (int i = warp; i < kTileE; i += kThreads / 32) {
    float* xrow = xhat_s + i * M;
    float* grow = ge_s + i * H;
    const int e = e0 + i;
    if (e >= E) {  // past the last edge: a zero row contributes nothing
      for (int m = lane; m < M; m += 32) xrow[m] = 0.f;
      for (int h = lane; h < H; h += 32) grow[h] = 0.f;
      if (lane == 0) rstd_s[i] = 0.f;
      continue;
    }
    const size_t be = (size_t)b * E + e;
    const int s = senders[be];
    const int r = receivers[be];
    const bool s_ok = s >= 0 && s < A;
    const bool r_ok = r >= 0 && r < A;
    const float* sp_row = sp + ((size_t)b * A + (s_ok ? s : 0)) * M;
    const float* dp_row = dp + ((size_t)b * A + (r_ok ? r : 0)) * M;
    const float* ep_row = ep + be * M;
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float v = ((s_ok ? sp_row[m] : 0.f) + (r_ok ? dp_row[m] : 0.f))
                      + ep_row[m];
      xrow[m] = v;
      sum += v;
    }
    const float mean = warp_sum(sum) / M;
    float sq = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float d = xrow[m] - mean;
      sq += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) / M + kLnEps);
    for (int m = lane; m < M; m += 32) {
      const float xh = (xrow[m] - mean) * rstd;
      xrow[m] = xh;
      const float n = xh * ln_scale[m] + ln_bias[m];
      act_out[be * M + m] = n > 0.f ? n : slope * n;
    }
    if (lane == 0) rstd_s[i] = rstd;
    const float mk = mask[be];
    const float* ga_row = g_agg + ((size_t)b * A + (r_ok ? r : 0)) * H;
    for (int h = lane; h < H; h += 32) {
      const float v = g_eout[be * H + h] + (r_ok ? mk * ga_row[h] : 0.f);
      grow[h] = v;
      ge_out[be * H + h] = v;
    }
  }

  // 2. g_act = g_e @ W1: thread (te, th) owns edges te*4 + k and columns
  //    m0 + th + 64*j, k, j in [0, 4)
  const int th = threadIdx.x % 64;
  const int te = threadIdx.x / 64;
  for (int m0 = 0; m0 < M; m0 += kTileMo) {
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
    for (int h0 = 0; h0 < H; h0 += kTileHr) {
      __syncthreads();  // g_e is complete / the previous chunk is consumed
      for (int idx = threadIdx.x; idx < kTileHr * kTileMo; idx += kThreads) {
        const int h = h0 + idx / kTileMo;
        const int m = m0 + idx % kTileMo;
        w_s[idx] = (h < H && m < M) ? w1[(size_t)h * M + m] : 0.f;
      }
      __syncthreads();
      const int depth = min(kTileHr, H - h0);
      for (int hh = 0; hh < depth; ++hh) {
        float av[4], wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) av[k] = ge_s[(te * 4 + k) * H + h0 + hh];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = w_s[hh * kTileMo + th + 64 * j];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[k][j] = fmaf(av[k], wv[j], acc[k][j]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + th + 64 * j;
        if (m < M) gact_s[(te * 4 + k) * M + m] = acc[k][j];
      }
  }
  __syncthreads();

  // 3. PReLU and LayerNorm backward, one warp per row; g_norm replaces g_act
  //    in shared memory for the column sums below
  float pa = 0.f;
  for (int i = warp; i < kTileE; i += kThreads / 32) {
    const float* xrow = xhat_s + i * M;
    float* grow = gact_s + i * M;
    float s1 = 0.f, s2 = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float xh = xrow[m];
      const float n = xh * ln_scale[m] + ln_bias[m];
      const float ga = grow[m];
      const bool pos = n > 0.f;
      const float gn = pos ? ga : slope * ga;
      pa += pos ? 0.f : ga * n;
      const float gx = gn * ln_scale[m];
      s1 += gx;
      s2 += gx * xh;
      grow[m] = gn;
    }
    s1 = warp_sum(s1) / M;
    s2 = warp_sum(s2) / M;
    const int e = e0 + i;
    if (e >= E) continue;
    const float rstd = rstd_s[i];
    float* out = g_ep + ((size_t)b * E + e) * M;
    for (int m = lane; m < M; m += 32) {
      const float gx = grow[m] * ln_scale[m];
      out[m] = rstd * (gx - s1 - xrow[m] * s2);
    }
  }
  pa = warp_sum(pa);
  if (lane == 0) alpha_s[warp] = pa;
  __syncthreads();

  // 4. this block's partial sums of the parameter gradients
  for (int m = threadIdx.x; m < M; m += kThreads) {
    float sl = 0.f, sb = 0.f;
    for (int i = 0; i < kTileE; ++i) {
      const float gn = gact_s[i * M + m];
      sl = fmaf(gn, xhat_s[i * M + m], sl);
      sb += gn;
    }
    part_lns[(size_t)blk * M + m] = sl;
    part_lnb[(size_t)blk * M + m] = sb;
  }
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float s = 0.f;
    for (int i = 0; i < kTileE; ++i) s += ge_s[i * H + h];
    part_b1[(size_t)blk * H + h] = s;
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += alpha_s[w];
    part_alpha[blk] = s;
  }
}

// part[s, h, m] = sum over edges n of chunk s of ge[n, h] * act[n, m]
__global__ void __launch_bounds__(kThreads)
gw1_kernel(const float* __restrict__ ge, const float* __restrict__ act,
           float* __restrict__ part, int N, int M, int H, int chunk) {
  __shared__ float a_s[kGemmK][kGemmTile];
  __shared__ float b_s[kGemmK][kGemmTile];
  const int m0 = blockIdx.x * kGemmTile;
  const int h0 = blockIdx.y * kGemmTile;
  const int split = blockIdx.z;
  const int n_begin = split * chunk;
  const int n_end = min(N, n_begin + chunk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n0 = n_begin; n0 < n_end; n0 += kGemmK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kGemmK * kGemmTile; idx += kThreads) {
      const int kk = idx / kGemmTile;
      const int c = idx % kGemmTile;
      const int n = n0 + kk;
      const bool ok = n < n_end;
      a_s[kk][c] = (ok && h0 + c < H) ? ge[(size_t)n * H + h0 + c] : 0.f;
      b_s[kk][c] = (ok && m0 + c < M) ? act[(size_t)n * M + m0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = h0 + ty + 16 * i;
    if (h >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 16 * j;
      if (m < M) part[((size_t)split * H + h) * M + m] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
node_bwd_kernel(const float* __restrict__ g_mid,
                const int* __restrict__ senders,
                const int* __restrict__ receivers, float* __restrict__ g_sp,
                float* __restrict__ g_dp, int A, int E, int M) {
  __shared__ int s_s[kThreads];
  __shared__ int r_s[kThreads];
  const int node = blockIdx.x;
  const int b = blockIdx.y;
  const int m = blockIdx.z * kThreads + threadIdx.x;
  float acc_s = 0.f, acc_r = 0.f;
  for (int c0 = 0; c0 < E; c0 += kThreads) {
    __syncthreads();
    const int e = c0 + threadIdx.x;
    if (e < E) {
      s_s[threadIdx.x] = senders[(size_t)b * E + e];
      r_s[threadIdx.x] = receivers[(size_t)b * E + e];
    }
    __syncthreads();
    const int n = min(kThreads, E - c0);
    if (m < M) {
      for (int i = 0; i < n; ++i) {
        const bool hs = s_s[i] == node;
        const bool hr = r_s[i] == node;
        if (hs || hr) {
          const float v = g_mid[((size_t)b * E + c0 + i) * M + m];
          if (hs) acc_s += v;
          if (hr) acc_r += v;
        }
      }
    }
  }
  if (m < M) {
    g_sp[((size_t)b * A + node) * M + m] = acc_s;
    g_dp[((size_t)b * A + node) * M + m] = acc_r;
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ part_lns,
              const float* __restrict__ part_lnb,
              const float* __restrict__ part_b1,
              const float* __restrict__ part_alpha,
              const float* __restrict__ part_w1, float* __restrict__ g_lns,
              float* __restrict__ g_lnb, float* __restrict__ g_b1,
              float* __restrict__ g_alpha, float* __restrict__ g_w1,
              int nblk, int splits, int M, int H) {
  const size_t hm = (size_t)H * M;
  const size_t total = hm + 2 * (size_t)M + H + 1;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (t < hm) {
      for (int k = 0; k < splits; ++k) s += part_w1[k * hm + t];
      g_w1[t] = s;
    } else if (t < hm + M) {
      const size_t m = t - hm;
      for (int k = 0; k < nblk; ++k) s += part_lns[(size_t)k * M + m];
      g_lns[m] = s;
    } else if (t < hm + 2 * M) {
      const size_t m = t - hm - M;
      for (int k = 0; k < nblk; ++k) s += part_lnb[(size_t)k * M + m];
      g_lnb[m] = s;
    } else if (t < hm + 2 * M + H) {
      const size_t h = t - hm - 2 * M;
      for (int k = 0; k < nblk; ++k) s += part_b1[(size_t)k * H + h];
      g_b1[h] = s;
    } else {
      for (int k = 0; k < nblk; ++k) s += part_alpha[k];
      g_alpha[0] = s;
    }
  }
}

}  // namespace

extern "C" size_t dostpu_fused_mp_edge_bwd_smem_bytes(int M, int H) {
  return edge_smem_floats(M, H) * sizeof(float);
}

// Floats of device scratch the backward needs (the wrapper allocates them):
// act [B*E, M], g_e [B*E, H], and the per-block and per-split partials.
extern "C" size_t dostpu_fused_mp_edge_bwd_scratch_floats(int B, int E, int M,
                                                         int H) {
  const size_t n = (size_t)B * E;
  const size_t nblk = (size_t)B * ((E + kTileE - 1) / kTileE);
  return n * M + n * H + nblk * (2 * (size_t)M + H + 1)
         + (size_t)gemm_splits((int)n) * H * M;
}

// All pointers are device pointers into contiguous float32 (int32 for the
// indices) tensors. Inputs as the forward's (src_proj/dst_proj [B, A, M],
// edge_proj [B, E, M], senders/receivers/edge_mask [B, E], ln_scale/ln_bias
// [M], alpha [1], w1 [H, M]) plus g_eout [B, E, H] and g_agg [B, A, H];
// outputs g_src_proj/g_dst_proj [B, A, M], g_edge_proj [B, E, M],
// g_ln_scale/g_ln_bias [M], g_alpha [1], g_w1 [H, M], g_b1 [H]; scratch of
// dostpu_fused_mp_edge_bwd_scratch_floats floats. Returns the CUDA error code
// of the launches (0 on success).
extern "C" int dostpu_fused_mp_edge_bwd(
    const float* src_proj, const float* dst_proj, const float* edge_proj,
    const int* senders, const int* receivers, const float* edge_mask,
    const float* ln_scale, const float* ln_bias, const float* alpha,
    const float* w1, const float* g_eout, const float* g_agg, float* g_sp,
    float* g_dp, float* g_ep, float* g_lns, float* g_lnb, float* g_alpha,
    float* g_w1, float* g_b1, float* scratch, int B, int A, int E, int M,
    int H, void* stream) {
  if (B <= 0 || A <= 0 || E <= 0 || M <= 0 || H <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = B * E;
  const int tiles = (E + kTileE - 1) / kTileE;
  const int nblk = B * tiles;
  const int splits = gemm_splits(n);
  float* act = scratch;
  float* ge = act + (size_t)n * M;
  float* part_lns = ge + (size_t)n * H;
  float* part_lnb = part_lns + (size_t)nblk * M;
  float* part_b1 = part_lnb + (size_t)nblk * M;
  float* part_alpha = part_b1 + (size_t)nblk * H;
  float* part_w1 = part_alpha + nblk;

  const size_t smem = dostpu_fused_mp_edge_bwd_smem_bytes(M, H);
  cudaError_t err = cudaFuncSetAttribute(
      edge_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  edge_bwd_kernel<<<dim3(tiles, B), kThreads, smem, st>>>(
      src_proj, dst_proj, edge_proj, senders, receivers, edge_mask, ln_scale,
      ln_bias, alpha, w1, g_eout, g_agg, g_ep, act, ge, part_lns, part_lnb,
      part_b1, part_alpha, A, E, M, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int chunk = (n + splits - 1) / splits;
  const dim3 grid_w((M + kGemmTile - 1) / kGemmTile,
                    (H + kGemmTile - 1) / kGemmTile, splits);
  gw1_kernel<<<grid_w, kThreads, 0, st>>>(ge, act, part_w1, n, M, H, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid_n(A, B, (M + kThreads - 1) / kThreads);
  node_bwd_kernel<<<grid_n, kThreads, 0, st>>>(g_ep, senders, receivers, g_sp,
                                               g_dp, A, E, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t total = (size_t)H * M + 2 * (size_t)M + H + 1;
  const int blocks =
      (int)std::min((total + kThreads - 1) / kThreads, (size_t)1024);
  reduce_kernel<<<blocks, kThreads, 0, st>>>(part_lns, part_lnb, part_b1,
                                             part_alpha, part_w1, g_lns, g_lnb,
                                             g_b1, g_alpha, g_w1, nblk, splits,
                                             M, H);
  return cudaGetLastError();
}
