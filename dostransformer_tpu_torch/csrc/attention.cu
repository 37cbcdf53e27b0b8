// Projection-free attention forward, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel` of
// dostransformer_tpu/ops/attention.py (launched by `_fwd_kernel_call` and
// `_fwd_kernel_call_nopad`, public name `fused_attention`):
//
//   out[b] = softmax(q[b] k[b]^T * D^-0.5 + bias[b]) v[b]
//
// one head, no projections, f32 operands, scores and softmax in f32; bias is
// 0 for a key that is attended and -1e30 for a masked one. It also writes
// each row's softmax statistics (max m and sum l of exp(s - m)) when asked,
// for the backward kernel (attention_bwd.cu).
//
// What bounds it on an H100: 4*Lq*Lk*D flops per batch element (the
// flagship self-attention, 16 x 201 x 201 x 256, is 0.66 GFLOP: 10 us on
// the FP32 pipes at their peak), on operands that stay in L2; and the work
// is small: 3,216 query rows are 201 row tiles, so the card is filled by
// latency, not by throughput. The TPU kernel held the whole [Lq, Lk] score
// tile in VMEM and fed the MXU bf16; here keys stream through shared memory
// in tiles of 32 with an online softmax, and the contract is f32.
//
// Design (building blocks in attention_core.cuh):
//   * both products run on the tensor cores as 3xTF32 mma.sync (f32
//     accuracy), not on the FP32 pipes: an FMA inner loop over shared
//     memory is bound by shared-memory instructions, one per 2-3 FMAs;
//   * one block per (16 query rows, batch element), 4 warps. For q k^T the
//     warps split D four ways, each reusing its Q fragment over the tile's
//     four n8 key sub-tiles, and leave partial score tiles in shared memory;
//     for the softmax each warp takes 4 rows (lane = key) and adds the
//     partials in a fixed order; for p v each warp owns D/4 output columns
//     (32 accumulator registers a lane at D = 256);
//   * K/V tiles arrive by cp.async, double-buffered while two blocks still
//     fit an SM, and are staged once when v is the same tensor as k (the
//     transformer layer always passes it so): one staged tile serves both
//     products without bank conflicts (the permuted contraction order of
//     prob_times_rows);
//   * the half of a key tile that lies wholly past Lk is skipped, not
//     computed and masked (201 keys = 6 tiles and 9 keys: half a tile);
//   * a row whose keys are all masked sees every score at exactly -1e30
//     (the bias is added in f32 after the product) and averages V uniformly,
//     as the plain version does; it never produces NaN. m and l are kept
//     apart, not as one log-sum-exp: -1e30 + log(Lk) rounds back to -1e30.

#include "attention_core.cuh"

namespace {

using namespace attn;

// D = 32 * NC. Shared memory: q_s [16][D+4], n_buf tiles of 32 keys
// [32][D+4] (K, then V when it is another tensor), the partial score tiles,
// the permuted p tile, and 16 rescale factors / row sums.
template <int NC>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                float* __restrict__ out, float* __restrict__ stats, int B,
                int Lq, int Lk, float scale, int nbuf) {
  constexpr int D = 32 * NC;
  constexpr int S = D + kPad;
  const bool v_is_k = v == k;
  const int tile_floats = (v_is_k ? 1 : 2) * kTileN * S;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* kv_s = q_s + kTileM * S;
  float* parts = kv_s + nbuf * tile_floats;
  float* p_s = parts + kPartFloats;
  float* corr_s = p_s + kProbFloats;  // [16]
  float* l_s = corr_s + kTileM;       // [16]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = warp * 8 * NC;  // the warp's quarter of D
  const float* kb = k + (size_t)b * Lk * D;
  const float* vb = v + (size_t)b * Lk * D;
  const float* bias_b = bias + (size_t)b * Lk;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  auto stage = [&](int tile, int buf) {
    float* dst = kv_s + buf * tile_floats;
    stage_rows_async<D>(dst, kb, tile * kTileN, kTileN, Lk);
    if (!v_is_k) stage_rows_async<D>(dst + kTileN * S, vb, tile * kTileN,
                                     kTileN, Lk);
  };
  stage_rows_async<D>(q_s, q + (size_t)b * Lq * D, q0, kTileM, Lq);
  stage(0, 0);
  cp_async_commit();

  float m_run[4], l_run[4];  // of the rows 4 warp .. 4 warp + 3
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float o[NC][4];  // rows g, g+8; columns c0 + 8n + 2t, +1
  zero_acc<NC>(o);

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = ring_acquire(it, n_tiles, nbuf, stage);
    const float* k_s = kv_s + buf * tile_floats;
    const float* v_s = v_is_k ? k_s : k_s + kTileN * S;
    const int k0 = it * kTileN;
    const int nk = min(kTileN, Lk - k0);

    partial_tile<NC>(q_s, k_s, S, (nk + 15) / 16, warp, lane, parts);
    __syncthreads();
    softmax_tile<true>(parts, bias_b, k0, Lk, scale, warp, lane, m_run, l_run,
                       p_s, corr_s);
    __syncthreads();
    const float c_lo = corr_s[g], c_hi = corr_s[g + 8];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      o[n][0] *= c_lo; o[n][1] *= c_lo; o[n][2] *= c_hi; o[n][3] *= c_hi;
    }
    prob_times_rows<NC>(p_s, v_s, S, c0, (nk + 15) / 16, lane, o);
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * warp + r;
      l_s[row] = l_run[r];
      if (stats != nullptr && q0 + row < Lq) {
        stats[(size_t)b * Lq + q0 + row] = m_run[r];
        stats[(size_t)(B + b) * Lq + q0 + row] = l_run[r];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    if (q0 + row >= Lq) continue;
    const float inv = 1.f / l_s[row];
    float* at = out + ((size_t)b * Lq + q0 + row) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float2*>(at + 8 * n) =
          make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* out, float* stats, int B, int Lq,
                   int Lk, float scale, cudaStream_t st) {
  constexpr size_t S = 32 * NC + kPad;
  const size_t fixed =
      (kTileM * S + kPartFloats + kProbFloats + 2 * kTileM) * sizeof(float);
  const size_t tile = (v == k ? 1 : 2) * kTileN * S * sizeof(float);
  const int nbuf = pick_buffers(fixed, tile);
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + nbuf * tile;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kTileM - 1) / kTileM, B);
  attn_fwd_kernel<NC><<<grid, kThreads, smem, st>>>(q, k, v, bias, out, stats,
                                                    B, Lq, Lk, scale, nbuf);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dostpu_attention_max_dim() { return 32 * 16; }

// All pointers are device pointers into contiguous, 16-byte aligned float32
// tensors: q [B, Lq, D], k/v [B, Lk, D] (v may be k itself), bias [B, Lk];
// out [B, Lq, D]; stats is null or [2, B, Lq] (row max, then row sum).
// D must be a multiple of 32 and at most dostpu_attention_max_dim().
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dostpu_attention_fwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    float* out, float* stats, int B, int Lq,
                                    int Lk, int D, float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D % 32 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / 32) {
#define DOSTPU_CASE(nc) \
  case nc:              \
    return launch<nc>(q, k, v, bias, out, stats, B, Lq, Lk, scale, st);
    DOSTPU_CASE(1) DOSTPU_CASE(2) DOSTPU_CASE(3) DOSTPU_CASE(4)
    DOSTPU_CASE(5) DOSTPU_CASE(6) DOSTPU_CASE(7) DOSTPU_CASE(8)
    DOSTPU_CASE(9) DOSTPU_CASE(10) DOSTPU_CASE(11) DOSTPU_CASE(12)
    DOSTPU_CASE(13) DOSTPU_CASE(14) DOSTPU_CASE(15) DOSTPU_CASE(16)
#undef DOSTPU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
