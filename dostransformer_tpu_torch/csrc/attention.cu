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
// for the backward kernel (attention_bwd.cu). Any feature width D >= 1.
//
// What bounds it on an H100: 4*Lq*Lk*D flops per batch element (the
// flagship self-attention, 16 x 201 x 201 x 256, is 0.66 GFLOP: 10 us on
// the FP32 pipes at their peak), on operands that stay in L2; and the work
// is small: 3,216 query rows are 201 row tiles, so the card is filled by
// latency, not by throughput. The TPU kernel held the whole [Lq, Lk] score
// tile in VMEM and fed the MXU bf16, padding D to a multiple of 128; here
// keys stream through shared memory in tiles of 32 with an online softmax,
// and the contract is f32.
//
// Design (building blocks in attention_core.cuh):
//   * both products run on the tensor cores as 3xTF32 mma.sync (f32
//     accuracy), not on the FP32 pipes: an FMA inner loop over shared
//     memory is bound by shared-memory instructions, one per 2-3 FMAs;
//   * one block per (16 query rows, batch element), 4 warps. For q k^T the
//     warps split the staged width four ways, each reusing its Q fragment
//     over the tile's four n8 key sub-tiles, and leave partial score tiles
//     in shared memory; for the softmax each warp takes 4 rows (lane = key)
//     and adds the partials in a fixed order; for p v each warp owns a
//     quarter of the output columns (32 accumulator registers a lane at
//     D = 256);
//   * D <= 512 (attn_fwd_kernel): rows are staged at NC = ceil(D / 32)
//     times 32 columns, zeros past D (they add nothing to q k^T, and the
//     columns of p v past D are not stored); rows whose width is a multiple
//     of 4 arrive as 16-byte copies, others as 4-byte ones. K/V tiles
//     arrive by cp.async, double-buffered while two blocks still fit an SM,
//     and are staged once when v is the same tensor as k (the transformer
//     layer always passes it so): one staged tile serves both products
//     without bank conflicts (the permuted contraction order of
//     prob_times_rows);
//   * D > 512 (attn_fwd_sliced_kernel): one block per (16 query rows, batch
//     element, slice of 512 output columns). For each key tile the block
//     streams the chunks of q and k through one staged tile each and adds
//     the partial score tiles chunk by chunk, its own slice last (the k
//     chunk staged for it is then v's slice where v is k); p v takes the
//     slice only. The score product is repeated once per slice (2x at
//     D = 1,024): the price of a grid that splits the columns, with no
//     atomics and a block that fits 227 KB;
//   * the half of a key tile that lies wholly past Lk is skipped, not
//     computed and masked (201 keys = 6 tiles and 9 keys: half a tile);
//   * a row whose keys are all masked sees every score at exactly -1e30
//     (the bias is added in f32 after the product) and averages V uniformly,
//     as the plain version does; it never produces NaN. m and l are kept
//     apart, not as one log-sum-exp: -1e30 + log(Lk) rounds back to -1e30.

#include "attention_core.cuh"

namespace {

using namespace attn;

// Rows staged at W = 32 * NC >= D columns; kFull: D == W, known at compile
// time (the runtime width cost the full widths time). Shared memory: q_s
// [16][W+4],
// n_buf tiles of 32 keys [32][W+4] (K, then V when it is another tensor),
// the partial score tiles, the permuted p tile, and 16 rescale factors /
// row sums.
template <int NC, bool kFull>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                float* __restrict__ out, float* __restrict__ stats, int B,
                int Lq, int Lk, int D_, float scale, int nbuf) {
  constexpr int S = 32 * NC + kPad;
  const int D = kFull ? 32 * NC : D_;
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
  const int c0 = warp * 8 * NC;  // the warp's quarter of the staged width
  const float* kb = k + (size_t)b * Lk * D;
  const float* vb = v + (size_t)b * Lk * D;
  const float* bias_b = bias + (size_t)b * Lk;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  auto stage = [&](int tile, int buf) {
    float* dst = kv_s + buf * tile_floats;
    stage_cols_async<NC>(dst, kb, tile * kTileN, kTileN, Lk, D, 0, D);
    if (!v_is_k)
      stage_cols_async<NC>(dst + kTileN * S, vb, tile * kTileN, kTileN, Lk,
                           D, 0, D);
  };
  stage_cols_async<NC>(q_s, q + (size_t)b * Lq * D, q0, kTileM, Lq, D, 0, D);
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
    float* at = out + ((size_t)b * Lq + q0 + row) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store_pair(at, c0 + 8 * n + 2 * t, D, o[n][2 * half] * inv,
                 o[n][2 * half + 1] * inv);
  }
}

// D > 32 NC: grid (query tiles, B, slices of W = 32 NC columns). Shared
// memory: a q chunk [16][W+4], a k chunk [32][W+4], v's slice [32][W+4]
// when v is another tensor, the partial score tiles, the permuted p tile,
// 16 rescale factors / row sums. The blocks of slice 0 write the
// statistics.
template <int NC>
__global__ void __launch_bounds__(kThreads)
attn_fwd_sliced_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias, float* __restrict__ out,
                       float* __restrict__ stats, int B, int Lq, int Lk,
                       int D, float scale) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  const bool v_is_k = v == k;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                // [16][S]
  float* t_s = a_s + kTileM * S;    // [32][S]
  float* v_s = t_s + kTileN * S;    // [32][S], v is another tensor only
  float* parts = v_s + (v_is_k ? 0 : kTileN * S);
  float* p_s = parts + kPartFloats;
  float* corr_s = p_s + kProbFloats;  // [16]
  float* l_s = corr_s + kTileM;       // [16]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileM;
  const int slice = blockIdx.z;
  const int n_chunks = (D + W - 1) / W;
  const int s0 = slice * W;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = warp * 8 * NC;
  const float* qb = q + (size_t)b * Lq * D;
  const float* kb = k + (size_t)b * Lk * D;
  const float* vb = v + (size_t)b * Lk * D;
  const float* bias_b = bias + (size_t)b * Lk;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float o[NC][4];
  zero_acc<NC>(o);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTileN;
    const int halves = (min(kTileN, Lk - k0) + 15) / 16;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int cc = slice_chunk(ci, slice, n_chunks) * W;
      const int w = min(W, D - cc);
      __syncthreads();  // the previous chunk's (or tile's) reads are done
      stage_cols_async<NC>(a_s, qb, q0, kTileM, Lq, D, cc, w);
      stage_cols_async<NC>(t_s, kb, k0, kTileN, Lk, D, cc, w);
      if (!v_is_k && ci == 0)
        stage_cols_async<NC>(v_s, vb, k0, kTileN, Lk, D, s0, min(W, D - s0));
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      partial_tile<NC>(a_s, t_s, S, halves, warp, lane, parts, ci > 0);
    }
    __syncthreads();
    softmax_tile<true>(parts, bias_b, k0, Lk, scale, warp, lane, m_run, l_run,
                       p_s, corr_s);
    __syncthreads();
    const float c_lo = corr_s[g], c_hi = corr_s[g + 8];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      o[n][0] *= c_lo; o[n][1] *= c_lo; o[n][2] *= c_hi; o[n][3] *= c_hi;
    }
    // the last chunk staged was the slice: where v is k, t_s holds v's
    prob_times_rows<NC>(p_s, v_is_k ? t_s : v_s, S, c0, halves, lane, o);
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * warp + r;
      l_s[row] = l_run[r];
      if (stats != nullptr && slice == 0 && q0 + row < Lq) {
        stats[(size_t)b * Lq + q0 + row] = m_run[r];
        stats[(size_t)(B + b) * Lq + q0 + row] = l_run[r];
      }
    }
  }
  __syncthreads();
  const int ds = min(W, D - s0);  // the slice's width
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    if (q0 + row >= Lq) continue;
    const float inv = 1.f / l_s[row];
    float* at = out + ((size_t)b * Lq + q0 + row) * D + s0;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      if (D % 2 == 0) {  // the pair lies in the slice (ds is even)
        if (col < ds)
          *reinterpret_cast<float2*>(at + col) =
              make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
      } else {
        if (col < ds) at[col] = o[n][2 * half] * inv;
        if (col + 1 < ds) at[col + 1] = o[n][2 * half + 1] * inv;
      }
    }
  }
}

template <int NC, bool kFull>
cudaError_t launch_t(const float* q, const float* k, const float* v,
                     const float* bias, float* out, float* stats, int B,
                     int Lq, int Lk, int D, float scale, cudaStream_t st) {
  constexpr size_t S = 32 * NC + kPad;
  const size_t fixed =
      (kTileM * S + kPartFloats + kProbFloats + 2 * kTileM) * sizeof(float);
  const size_t tile = (v == k ? 1 : 2) * kTileN * S * sizeof(float);
  const int nbuf = pick_buffers(fixed, tile);
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + nbuf * tile;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<NC, kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kTileM - 1) / kTileM, B);
  attn_fwd_kernel<NC, kFull><<<grid, kThreads, smem, st>>>(
      q, k, v, bias, out, stats, B, Lq, Lk, D, scale, nbuf);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* out, float* stats, int B, int Lq,
                   int Lk, int D, float scale, cudaStream_t st) {
  if (D == 32 * NC)
    return launch_t<NC, true>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale,
                              st);
  return launch_t<NC, false>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale,
                             st);
}

cudaError_t launch_sliced(const float* q, const float* k, const float* v,
                          const float* bias, float* out, float* stats, int B,
                          int Lq, int Lk, int D, float scale,
                          cudaStream_t st) {
  constexpr int NC = kSliceMaxNC;
  constexpr size_t S = 32 * NC + kPad;
  const size_t smem = ((v == k ? 1 : 2) * kTileN * S + kTileM * S
                       + kPartFloats + kProbFloats + 2 * kTileM)
                      * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_sliced_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int slices = (D + 32 * NC - 1) / (32 * NC);
  if (slices > 65535) return cudaErrorInvalidValue;
  const dim3 grid((Lq + kTileM - 1) / kTileM, B, slices);
  attn_fwd_sliced_kernel<NC><<<grid, kThreads, smem, st>>>(
      q, k, v, bias, out, stats, B, Lq, Lk, D, scale);
  return cudaGetLastError();
}

}  // namespace

// How the attention kernels (this file, attention_bwd.cu, attention_ln.cu)
// take feature width D >= 1: *nc 32-column groups a staged row holds and
// *slices blocks that share a row's output columns: (ceil(D / 32), 1) up to
// D = 512, else (16, ceil(D / 512)), the sliced kernels.
extern "C" void dostpu_attention_plan(int D, int* nc, int* slices) {
  constexpr int W = 32 * attn::kSliceMaxNC;
  *nc = D <= W ? (D + 31) / 32 : attn::kSliceMaxNC;
  *slices = D <= W ? 1 : (D + W - 1) / W;
}

// All pointers are device pointers into contiguous, 16-byte aligned float32
// tensors: q [B, Lq, D], k/v [B, Lk, D] (v may be k itself), bias [B, Lk];
// out [B, Lq, D]; stats is null or [2, B, Lq] (row max, then row sum).
// Any D >= 1. Returns the CUDA error code of the launch (0 on success).
extern "C" int dostpu_attention_fwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    float* out, float* stats, int B, int Lq,
                                    int Lk, int D, float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nc, slices;
  dostpu_attention_plan(D, &nc, &slices);
  if (slices > 1)
    return launch_sliced(q, k, v, bias, out, stats, B, Lq, Lk, D, scale, st);
  switch (nc) {
#define DOSTPU_CASE(n) \
  case n:              \
    return launch<n>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale, st);
    DOSTPU_CASE(1) DOSTPU_CASE(2) DOSTPU_CASE(3) DOSTPU_CASE(4)
    DOSTPU_CASE(5) DOSTPU_CASE(6) DOSTPU_CASE(7) DOSTPU_CASE(8)
    DOSTPU_CASE(9) DOSTPU_CASE(10) DOSTPU_CASE(11) DOSTPU_CASE(12)
    DOSTPU_CASE(13) DOSTPU_CASE(14) DOSTPU_CASE(15) DOSTPU_CASE(16)
#undef DOSTPU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
