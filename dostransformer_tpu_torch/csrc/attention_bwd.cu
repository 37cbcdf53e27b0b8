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
// What bounds it on an H100: five products of 2*Lq*Lk*D flops per batch
// element (scores, dp, dq, dk, dv; the flagship self-attention, 16 x 201 x
// 201 x 256, is 1.65 GFLOP: 25 us on the FP32 pipes at their peak) on
// operands that stay in L2, and, as in the forward, little parallelism: at
// 32 keys a grid over key tiles alone is 16-32 blocks for 132 SMs. The TPU
// kernel held the whole [Lq, Lk] score tile in VMEM and wrote dq, dk and dv
// from one grid step; a reduction over blocks here would need atomics, so
// the work is split by output instead.
//
// Design (building blocks in attention_core.cuh; every product is 3xTF32
// mma.sync at f32 accuracy, tiles arrive by cp.async), no atomics anywhere,
// so the gradients are bit-identical from run to run:
//   * the row statistics m and l come from the forward kernel (stats_in).
//     When the caller has none (the LayerNorm-fused forward keeps none),
//     stats_kernel recomputes them with the forward's own score and softmax
//     code, so both routes give the same bits;
//   * dq_kernel: one block per (16 query rows, batch element), keys
//     streamed in tiles of 32. delta = rowsum(g * o) (= rowsum(dp * p)) goes
//     to scratch for the second kernel. Per tile: scores and dp as partial
//     tiles (the warps split D), p = exp(s - m) * (1 / l), ds, dq += ds k;
//   * dkv_kernel: one block per (16 keys, chunk of queries, batch element),
//     queries streamed in tiles of 32: the transposed score and dp tiles,
//     p^T and ds^T, dv += p^T g, dk += ds^T q. At 32 or 16 keys the query
//     range is cut into chunks so that the grid fills the card
//     (query_chunks); each chunk writes partial dk/dv to scratch and
//     reduce_kernel adds the chunks in order. With one chunk (the flagship
//     self-attention) the block writes dk/dv itself.
//   The scores are recomputed in both kernels: on tensor cores that is
//   cheaper than writing and re-reading per-tile partial dq.
//   * k and v staged once where they are one tensor, as in the forward.
//   * any D >= 1: up to D = 512 rows are staged at ceil(D / 32) x 32
//     columns, zeros past D, as in the forward; above it the sliced forms
//     (stats_sliced_kernel, dq_sliced_kernel, dkv_sliced_kernel) split the
//     output columns into slices of 512 and stream the chunks of every
//     operand through the same staged tiles for the scores and dp, the
//     block's own slice last, in the forward's chunk order (so the scores
//     repeat the forward's bits for slice 0, whose statistics it wrote).

#include "attention_core.cuh"

namespace {

using namespace attn;

constexpr int kResidentBlocks = 264;  // two on each of an H100's 132 SMs

// rows of m and l for a caller without the forward's: the forward's loop
// without p v
// kFull (the three kernels below): D == 32 NC, known at compile time
template <int NC, bool kFull>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ bias, float* __restrict__ m_out,
             float* __restrict__ l_out, int Lq, int Lk, int D_, float scale,
             int nbuf) {
  constexpr int S = 32 * NC + kPad;
  const int D = kFull ? 32 * NC : D_;
  constexpr int tile_floats = kTileN * S;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTileM * S;
  float* parts = k_s + nbuf * tile_floats;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* kb = k + (size_t)b * Lk * D;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  auto stage = [&](int tile, int buf) {
    stage_cols_async<NC>(k_s + buf * tile_floats, kb, tile * kTileN, kTileN,
                         Lk, D, 0, D);
  };
  stage_cols_async<NC>(q_s, q + (size_t)b * Lq * D, q0, kTileM, Lq, D, 0, D);
  stage(0, 0);
  cp_async_commit();

  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = ring_acquire(it, n_tiles, nbuf, stage);
    const int k0 = it * kTileN;
    const int nk = min(kTileN, Lk - k0);
    partial_tile<NC>(q_s, k_s + buf * tile_floats, S, (nk + 15) / 16, warp,
                     lane, parts);
    __syncthreads();
    softmax_tile<false>(parts, bias + (size_t)b * Lk, k0, Lk, scale, warp,
                        lane, m_run, l_run, nullptr, nullptr);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * warp + r;
      if (i < Lq) {
        m_out[(size_t)b * Lq + i] = m_run[r];
        l_out[(size_t)b * Lq + i] = l_run[r];
      }
    }
  }
}

// stats_kernel above 32 NC columns: the scores chunk by chunk, in the order
// of the forward's slice 0
template <int NC>
__global__ void __launch_bounds__(kThreads)
stats_sliced_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ bias, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Lq, int Lk, int D,
                    float scale) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;
  float* t_s = a_s + kTileM * S;
  float* parts = t_s + kTileN * S;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileM;
  const int n_chunks = (D + W - 1) / W;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + (size_t)b * Lq * D;
  const float* kb = k + (size_t)b * Lk * D;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTileN;
    const int halves = (min(kTileN, Lk - k0) + 15) / 16;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int cc = slice_chunk(ci, 0, n_chunks) * W;
      const int w = min(W, D - cc);
      __syncthreads();
      stage_cols_async<NC>(a_s, qb, q0, kTileM, Lq, D, cc, w);
      stage_cols_async<NC>(t_s, kb, k0, kTileN, Lk, D, cc, w);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      partial_tile<NC>(a_s, t_s, S, halves, warp, lane, parts, ci > 0);
    }
    __syncthreads();
    softmax_tile<false>(parts, bias + (size_t)b * Lk, k0, Lk, scale, warp,
                        lane, m_run, l_run, nullptr, nullptr);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * warp + r;
      if (i < Lq) {
        m_out[(size_t)b * Lq + i] = m_run[r];
        l_out[(size_t)b * Lq + i] = l_run[r];
      }
    }
  }
}

// one element of p and of ds from its summed score s and dp: what the dq
// and dkv kernels share. bj is the key's bias; m, inv_l and delta are the
// query's row max, 1 / row sum and rowsum(g * o).
__device__ __forceinline__ void p_and_ds(float s, float dp, bool valid,
                                         float scale, float bj, float m,
                                         float inv_l, float delta, float& p,
                                         float& ds) {
  p = valid ? expf(fmaf(s, scale, bj) - m) * inv_l : 0.f;
  ds = valid ? p * (dp - delta) : 0.f;
}

// delta = rowsum(g * o) of the block's 16 query rows (to the shared dl_s,
// and to delta_out unless it is null) and the rows' statistics (m_s, and
// 1 / l in il_s): one warp a row, four rows a warp
__device__ __forceinline__ void row_inputs(
    const float* __restrict__ g, const float* __restrict__ o,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    float* __restrict__ delta_out, float* m_s, float* il_s, float* dl_s,
    int b, int q0, int Lq, int D, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r;
    const int i = q0 + row;
    const size_t at = (size_t)b * Lq + i;
    float s = 0.f;
    if (i < Lq)
      for (int c = lane; c < D; c += 32) s = fmaf(g[at * D + c], o[at * D + c], s);
    s = warp_sum(s);
    if (lane == 0) {
      dl_s[row] = s;
      m_s[row] = i < Lq ? m_in[at] : 0.f;
      il_s[row] = i < Lq ? 1.f / l_in[at] : 0.f;
      if (i < Lq && delta_out != nullptr) delta_out[at] = s;
    }
  }
}

// p and ds of the [16 x 32] tile from the summed score and dp partials,
// ds to ds_s in prob_pos order (the query rows' view: lane = key)
__device__ __forceinline__ void ds_tile(const float* s_parts,
                                        const float* dp_parts,
                                        const float* bias_b, int k0, int Lk,
                                        float scale, const float* m_s,
                                        const float* il_s, const float* dl_s,
                                        float* ds_s, int warp, int lane) {
  const bool valid = k0 + lane < Lk;
  const float bj = valid ? bias_b[k0 + lane] : 0.f;
  const int pos = prob_pos(lane);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r;
    float p, ds;
    p_and_ds(sum_partials(s_parts, row, lane),
             sum_partials(dp_parts, row, lane), valid, scale, bj, m_s[row],
             il_s[row], dl_s[row], p, ds);
    ds_s[row * kProbStride + pos] = ds;
  }
}

template <int NC, bool kFull>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ bias,
          const float* __restrict__ o, const float* __restrict__ g,
          const float* __restrict__ m_in, const float* __restrict__ l_in,
          float* __restrict__ dq, float* __restrict__ delta_out, int Lq,
          int Lk, int D_, float scale, int nbuf) {
  constexpr int S = 32 * NC + kPad;
  const int D = kFull ? 32 * NC : D_;
  const bool v_is_k = v == k;
  const int tile_floats = (v_is_k ? 1 : 2) * kTileN * S;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [16][S]
  float* g_s = q_s + kTileM * S;      // [16][S]
  float* kv_s = g_s + kTileM * S;     // nbuf tiles: K, then V if distinct
  float* s_parts = kv_s + nbuf * tile_floats;
  float* dp_parts = s_parts + kPartFloats;
  float* ds_s = dp_parts + kPartFloats;  // permuted [16][36]
  float* m_s = ds_s + kProbFloats;       // [16] row max
  float* il_s = m_s + kTileM;            // [16] 1 / row sum
  float* dl_s = il_s + kTileM;           // [16] delta
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int c0 = warp * 8 * NC;
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
  stage_cols_async<NC>(g_s, g + (size_t)b * Lq * D, q0, kTileM, Lq, D, 0, D);
  stage(0, 0);
  cp_async_commit();
  // delta and the rows' statistics while the copies fly
  row_inputs(g, o, m_in, l_in, delta_out, m_s, il_s, dl_s, b, q0, Lq, D, warp,
             lane);

  float acc[NC][4];
  zero_acc<NC>(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = ring_acquire(it, n_tiles, nbuf, stage);
    const float* k_s = kv_s + buf * tile_floats;
    const float* v_s = v_is_k ? k_s : k_s + kTileN * S;
    const int k0 = it * kTileN;
    const int nk = min(kTileN, Lk - k0);
    partial_tile<NC>(q_s, k_s, S, (nk + 15) / 16, warp, lane, s_parts);
    partial_tile<NC>(g_s, v_s, S, (nk + 15) / 16, warp, lane, dp_parts);
    __syncthreads();
    ds_tile(s_parts, dp_parts, bias_b, k0, Lk, scale, m_s, il_s, dl_s, ds_s,
            warp, lane);
    __syncthreads();
    prob_times_rows<NC>(ds_s, k_s, S, c0, (nk + 15) / 16, lane, acc);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gq + 8 * half;
    if (q0 + row >= Lq) continue;
    float* at = dq + ((size_t)b * Lq + q0 + row) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store_pair(at, c0 + 8 * n + 2 * t, D, acc[n][2 * half] * scale,
                 acc[n][2 * half + 1] * scale);
  }
}

// the columns [c0, c0 + W) of a row of width D from the accumulators of a
// sliced block (the pair at col, col + 1 of the slice; ds the slice's width)
__device__ __forceinline__ void store_slice_pair(float* row, int col, int ds,
                                                 int D, float a, float b) {
  if (D % 2 == 0) {
    if (col < ds) *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
  } else {
    if (col < ds) row[col] = a;
    if (col + 1 < ds) row[col + 1] = b;
  }
}

// dq_kernel above 32 NC columns: grid (query tiles, B, slices). Shared
// memory: q and g chunks [16][W+4] each, a k chunk [32][W+4] (the slice,
// last), a v chunk [32][W+4] when v is another tensor, the score and dp
// partial tiles, the ds tile and the rows' statistics. The blocks of slice
// 0 write delta.
template <int NC>
__global__ void __launch_bounds__(kThreads)
dq_sliced_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ o, const float* __restrict__ g,
                 const float* __restrict__ m_in,
                 const float* __restrict__ l_in, float* __restrict__ dq,
                 float* __restrict__ delta_out, int Lq, int Lk, int D,
                 float scale) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  const bool v_is_k = v == k;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                    // [16][S] q chunk
  float* g_s = a_s + kTileM * S;        // [16][S] g chunk
  float* t_s = g_s + kTileM * S;        // [32][S] k chunk
  float* u_s = t_s + kTileN * S;        // [32][S] v chunk (v another tensor)
  float* s_parts = u_s + (v_is_k ? 0 : kTileN * S);
  float* dp_parts = s_parts + kPartFloats;
  float* ds_s = dp_parts + kPartFloats;
  float* m_s = ds_s + kProbFloats;
  float* il_s = m_s + kTileM;
  float* dl_s = il_s + kTileM;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileM;
  const int slice = blockIdx.z;
  const int n_chunks = (D + W - 1) / W;
  const int s0 = slice * W;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int c0 = warp * 8 * NC;
  const float* qb = q + (size_t)b * Lq * D;
  const float* gb = g + (size_t)b * Lq * D;
  const float* kb = k + (size_t)b * Lk * D;
  const float* vb = v + (size_t)b * Lk * D;
  const float* bias_b = bias + (size_t)b * Lk;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  // every slice's blocks form delta (the same bits); slice 0's write it
  row_inputs(g, o, m_in, l_in, slice == 0 ? delta_out : nullptr, m_s, il_s,
             dl_s, b, q0, Lq, D, warp, lane);

  float acc[NC][4];
  zero_acc<NC>(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTileN;
    const int halves = (min(kTileN, Lk - k0) + 15) / 16;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int cc = slice_chunk(ci, slice, n_chunks) * W;
      const int w = min(W, D - cc);
      __syncthreads();
      stage_cols_async<NC>(a_s, qb, q0, kTileM, Lq, D, cc, w);
      stage_cols_async<NC>(g_s, gb, q0, kTileM, Lq, D, cc, w);
      stage_cols_async<NC>(t_s, kb, k0, kTileN, Lk, D, cc, w);
      if (!v_is_k) stage_cols_async<NC>(u_s, vb, k0, kTileN, Lk, D, cc, w);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      partial_tile<NC>(a_s, t_s, S, halves, warp, lane, s_parts, ci > 0);
      partial_tile<NC>(g_s, v_is_k ? t_s : u_s, S, halves, warp, lane,
                       dp_parts, ci > 0);
    }
    __syncthreads();
    ds_tile(s_parts, dp_parts, bias_b, k0, Lk, scale, m_s, il_s, dl_s, ds_s,
            warp, lane);
    __syncthreads();
    prob_times_rows<NC>(ds_s, t_s, S, c0, halves, lane, acc);  // k's slice
  }

  const int ds = min(W, D - s0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gq + 8 * half;
    if (q0 + row >= Lq) continue;
    float* at = dq + ((size_t)b * Lq + q0 + row) * D + s0;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store_slice_pair(at, c0 + 8 * n + 2 * t, ds, D,
                       acc[n][2 * half] * scale,
                       acc[n][2 * half + 1] * scale);
  }
}

// p^T and ds^T of the [16 keys x 32 queries] tile (rows = the block's keys)
// into pt_s and dst_s, prob_pos order
__device__ __forceinline__ void dkv_tile(const float* s_parts,
                                         const float* dp_parts,
                                         const float* bias_s, const float* m_s,
                                         const float* il_s, const float* dl_s,
                                         float* pt_s, float* dst_s, int nq,
                                         int j0, int Lk, float scale, int warp,
                                         int lane) {
  const int pos = prob_pos(lane);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r;
    const bool valid = lane < nq && j0 + row < Lk;
    float p, ds;
    p_and_ds(sum_partials(s_parts, row, lane),
             sum_partials(dp_parts, row, lane), valid, scale, bias_s[row],
             m_s[lane], il_s[lane], dl_s[lane], p, ds);
    pt_s[row * kProbStride + pos] = p;
    dst_s[row * kProbStride + pos] = ds;
  }
}

// m, 1 / l and delta of the query tile [i0, i0 + 32) (those at or past
// i_end 0) -> m_s, il_s, dl_s, by the block's first 32 threads
__device__ __forceinline__ void query_tile_inputs(
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ delta_in, float* m_s, float* il_s, float* dl_s,
    int b, int Lq, int i0, int i_end) {
  if (threadIdx.x < kTileN) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < i_end;
    const size_t at = (size_t)b * Lq + i;
    m_s[threadIdx.x] = ok ? m_in[at] : 0.f;
    il_s[threadIdx.x] = ok ? 1.f / l_in[at] : 0.f;
    dl_s[threadIdx.x] = ok ? delta_in[at] : 0.f;
  }
}

// grid (key tiles of 16, query chunks, B); chunk_len is a multiple of 32.
// dk_out / dv_out are [chunks][B][Lk][D] (the outputs themselves when there
// is one chunk).
template <int NC, bool kFull>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
           const float* __restrict__ g, const float* __restrict__ m_in,
           const float* __restrict__ l_in, const float* __restrict__ delta_in,
           float* __restrict__ dk_out, float* __restrict__ dv_out, int B,
           int Lq, int Lk, int D_, int chunk_len, float scale, int nbuf) {
  constexpr int S = 32 * NC + kPad;
  const int D = kFull ? 32 * NC : D_;
  constexpr int tile_floats = 2 * kTileN * S;  // a Q tile, then a G tile
  const bool v_is_k = v == k;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                               // [16][S]
  float* v_s = v_is_k ? k_s : k_s + kTileM * S;    // [16][S]
  float* qg_s = k_s + (v_is_k ? 1 : 2) * kTileM * S;
  float* s_parts = qg_s + nbuf * tile_floats;
  float* dp_parts = s_parts + kPartFloats;
  float* pt_s = dp_parts + kPartFloats;   // p^T, permuted [16][36]
  float* dst_s = pt_s + kProbFloats;      // ds^T, permuted [16][36]
  float* m_s = dst_s + kProbFloats;       // [32] of the tile's queries
  float* il_s = m_s + kTileN;             // [32]
  float* dl_s = il_s + kTileN;            // [32]
  float* bias_s = dl_s + kTileN;          // [16] of the block's keys
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * kTileM;
  const int i_begin = blockIdx.y * chunk_len;
  const int i_end = min(Lq, i_begin + chunk_len);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gk = lane >> 2, t = lane & 3;
  const int c0 = warp * 8 * NC;
  const float* qb = q + (size_t)b * Lq * D;
  const float* gb = g + (size_t)b * Lq * D;
  const int n_tiles = (i_end - i_begin + kTileN - 1) / kTileN;

  auto stage = [&](int tile, int buf) {
    float* dst = qg_s + buf * tile_floats;
    stage_cols_async<NC>(dst, qb, i_begin + tile * kTileN, kTileN, Lq, D, 0,
                         D);
    stage_cols_async<NC>(dst + kTileN * S, gb, i_begin + tile * kTileN,
                         kTileN, Lq, D, 0, D);
  };
  stage_cols_async<NC>(k_s, k + (size_t)b * Lk * D, j0, kTileM, Lk, D, 0, D);
  if (!v_is_k)
    stage_cols_async<NC>(v_s, v + (size_t)b * Lk * D, j0, kTileM, Lk, D, 0,
                         D);
  stage(0, 0);
  cp_async_commit();
  if (threadIdx.x < kTileM)
    bias_s[threadIdx.x] = j0 + threadIdx.x < Lk
                              ? bias[(size_t)b * Lk + j0 + threadIdx.x] : 0.f;

  float acc_k[NC][4], acc_v[NC][4];
  zero_acc<NC>(acc_k);
  zero_acc<NC>(acc_v);

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = ring_acquire(it, n_tiles, nbuf, stage);
    const float* q_s = qg_s + buf * tile_floats;
    const float* g_s = q_s + kTileN * S;
    const int i0 = i_begin + it * kTileN;
    const int nq = min(kTileN, i_end - i0);
    // read again only after the next barrier
    query_tile_inputs(m_in, l_in, delta_in, m_s, il_s, dl_s, b, Lq, i0,
                      i_end);
    // rows = the block's keys, columns = the tile's queries
    partial_tile<NC>(k_s, q_s, S, (nq + 15) / 16, warp, lane, s_parts);
    partial_tile<NC>(v_s, g_s, S, (nq + 15) / 16, warp, lane, dp_parts);
    __syncthreads();
    dkv_tile(s_parts, dp_parts, bias_s, m_s, il_s, dl_s, pt_s, dst_s, nq, j0,
             Lk, scale, warp, lane);
    __syncthreads();
    prob_times_rows<NC>(pt_s, g_s, S, c0, (nq + 15) / 16, lane, acc_v);
    prob_times_rows<NC>(dst_s, q_s, S, c0, (nq + 15) / 16, lane, acc_k);
  }

  const size_t chunk_off = (size_t)blockIdx.y * B * Lk * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gk + 8 * half;
    if (j0 + row >= Lk) continue;
    const size_t at = chunk_off + ((size_t)b * Lk + j0 + row) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      store_pair(dk_out + at, col, D, acc_k[n][2 * half] * scale,
                 acc_k[n][2 * half + 1] * scale);
      store_pair(dv_out + at, col, D, acc_v[n][2 * half],
                 acc_v[n][2 * half + 1]);
    }
  }
}

// dkv_kernel above 32 NC columns: grid (key tiles of 16 x slices, query
// chunks, B). Shared memory: k and v chunks of the block's keys [16][W+4]
// (one where v is k), q and g chunks of the query tile [32][W+4] (the
// slice, last), the partial tiles, p^T and ds^T, the statistics.
template <int NC>
__global__ void __launch_bounds__(kThreads)
dkv_sliced_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ g, const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ delta_in,
                  float* __restrict__ dk_out, float* __restrict__ dv_out,
                  int B, int Lq, int Lk, int D, int chunk_len, float scale) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  const bool v_is_k = v == k;
  extern __shared__ __align__(16) float smem[];
  float* kc_s = smem;                                  // [16][S]
  float* vc_s = v_is_k ? kc_s : kc_s + kTileM * S;     // [16][S]
  float* qc_s = kc_s + (v_is_k ? 1 : 2) * kTileM * S;  // [32][S]
  float* gc_s = qc_s + kTileN * S;                     // [32][S]
  float* s_parts = gc_s + kTileN * S;
  float* dp_parts = s_parts + kPartFloats;
  float* pt_s = dp_parts + kPartFloats;
  float* dst_s = pt_s + kProbFloats;
  float* m_s = dst_s + kProbFloats;
  float* il_s = m_s + kTileN;
  float* dl_s = il_s + kTileN;
  float* bias_s = dl_s + kTileN;
  const int n_chunks = (D + W - 1) / W;
  const int slice = blockIdx.x % n_chunks;
  const int s0 = slice * W;
  const int b = blockIdx.z;
  const int j0 = (blockIdx.x / n_chunks) * kTileM;
  const int i_begin = blockIdx.y * chunk_len;
  const int i_end = min(Lq, i_begin + chunk_len);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gk = lane >> 2, t = lane & 3;
  const int c0 = warp * 8 * NC;
  const float* qb = q + (size_t)b * Lq * D;
  const float* gb = g + (size_t)b * Lq * D;
  const float* kb = k + (size_t)b * Lk * D;
  const float* vb = v + (size_t)b * Lk * D;
  const int n_tiles = (i_end - i_begin + kTileN - 1) / kTileN;
  if (threadIdx.x < kTileM)
    bias_s[threadIdx.x] = j0 + threadIdx.x < Lk
                              ? bias[(size_t)b * Lk + j0 + threadIdx.x] : 0.f;

  float acc_k[NC][4], acc_v[NC][4];
  zero_acc<NC>(acc_k);
  zero_acc<NC>(acc_v);

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = i_begin + it * kTileN;
    const int nq = min(kTileN, i_end - i0);
    const int halves = (nq + 15) / 16;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int cc = slice_chunk(ci, slice, n_chunks) * W;
      const int w = min(W, D - cc);
      __syncthreads();
      if (ci == 0)  // read again only after the next barrier
        query_tile_inputs(m_in, l_in, delta_in, m_s, il_s, dl_s, b, Lq, i0,
                          i_end);
      stage_cols_async<NC>(kc_s, kb, j0, kTileM, Lk, D, cc, w);
      if (!v_is_k) stage_cols_async<NC>(vc_s, vb, j0, kTileM, Lk, D, cc, w);
      stage_cols_async<NC>(qc_s, qb, i0, kTileN, i_end, D, cc, w);
      stage_cols_async<NC>(gc_s, gb, i0, kTileN, i_end, D, cc, w);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      partial_tile<NC>(kc_s, qc_s, S, halves, warp, lane, s_parts, ci > 0);
      partial_tile<NC>(vc_s, gc_s, S, halves, warp, lane, dp_parts, ci > 0);
    }
    __syncthreads();
    dkv_tile(s_parts, dp_parts, bias_s, m_s, il_s, dl_s, pt_s, dst_s, nq, j0,
             Lk, scale, warp, lane);
    __syncthreads();
    // the last chunks staged were the slice's
    prob_times_rows<NC>(pt_s, gc_s, S, c0, halves, lane, acc_v);
    prob_times_rows<NC>(dst_s, qc_s, S, c0, halves, lane, acc_k);
  }

  const int ds = min(W, D - s0);
  const size_t chunk_off = (size_t)blockIdx.y * B * Lk * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gk + 8 * half;
    if (j0 + row >= Lk) continue;
    const size_t at = chunk_off + ((size_t)b * Lk + j0 + row) * D + s0;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      store_slice_pair(dk_out + at, col, ds, D, acc_k[n][2 * half] * scale,
                       acc_k[n][2 * half + 1] * scale);
      store_slice_pair(dv_out + at, col, ds, D, acc_v[n][2 * half],
                       acc_v[n][2 * half + 1]);
    }
  }
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// dk, dv [n V each: float4 where B Lk D % 4 == 0, else float] = the chunks'
// partials added in chunk order
template <typename V>
__global__ void __launch_bounds__(256)
reduce_kernel(const V* __restrict__ dk_part, const V* __restrict__ dv_part,
              V* __restrict__ dk, V* __restrict__ dv, size_t n, int chunks) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n) return;
  const bool is_v = idx >= n;
  const size_t at = is_v ? idx - n : idx;
  const V* src = is_v ? dv_part : dk_part;
  V sum = src[at];
  for (int c = 1; c < chunks; ++c) add_to(sum, src[(size_t)c * n + at]);
  (is_v ? dv : dk)[at] = sum;
}

struct Chunks {
  int count;  // query chunks of the dkv kernel
  int len;    // queries per chunk, a multiple of 32
};

// The number of query chunks that finishes the dkv kernel soonest: waves of
// kResidentBlocks blocks times the tiles a block walks, plus, where chunks
// must be added up, reduce_kernel's launch and its reads. A function of the
// shape alone, so the order of every sum is too. (At the flagship
// self-attention one chunk wins: 208 blocks of 7 tiles are one wave, and two
// chunks of 4 tiles would be two.) Above 512 columns every key tile is
// `slices` blocks.
Chunks query_chunks(int B, int Lq, int Lk, int slices) {
  const int q_tiles = (Lq + kTileN - 1) / kTileN;
  const long key_blocks = (long)((Lk + kTileM - 1) / kTileM) * B * slices;
  Chunks best = {1, q_tiles * kTileN};
  long best_cost = -1;
  for (int want = 1; want <= q_tiles; ++want) {
    const int per_chunk = (q_tiles + want - 1) / want;
    const int count = (q_tiles + per_chunk - 1) / per_chunk;
    const long waves =
        (key_blocks * count + kResidentBlocks - 1) / kResidentBlocks;
    // in eighths of the time one block spends on one tile
    const long cost = 8 * waves * per_chunk + (count > 1 ? 8 + count : 0);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best.count = count;
      best.len = per_chunk * kTileN;
    }
  }
  return best;
}

int slices_of(int D) {
  constexpr int W = 32 * kSliceMaxNC;
  return D <= W ? 1 : (D + W - 1) / W;
}

// m, l and delta of every query row, rounded up so that what follows them
// in the scratch stays 16-byte aligned
size_t stat_floats(size_t rows) { return (3 * rows + 3) / 4 * 4; }

size_t scratch_floats(int B, int Lq, int Lk, int D) {
  const Chunks c = query_chunks(B, Lq, Lk, slices_of(D));
  const size_t partials =
      c.count > 1 ? (size_t)2 * c.count * B * Lk * D : 0;
  return stat_floats((size_t)B * Lq) + partials;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the chunks' partial dk and dv added in chunk order, where there are
// several chunks
cudaError_t reduce_chunks(const Chunks& chunks, const float* partials,
                          float* dk, float* dv, size_t n, cudaStream_t st) {
  if (chunks.count == 1) return cudaSuccess;
  if (n % 4 == 0) {  // the partials' halves are then 16-byte aligned too
    const size_t n4 = n / 4;
    reduce_kernel<float4><<<(unsigned)((2 * n4 + 255) / 256), 256, 0, st>>>(
        reinterpret_cast<const float4*>(partials),
        reinterpret_cast<const float4*>(partials + chunks.count * n),
        reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv), n4,
        chunks.count);
  } else {
    reduce_kernel<float><<<(unsigned)((2 * n + 255) / 256), 256, 0, st>>>(
        partials, partials + chunks.count * n, dk, dv, n, chunks.count);
  }
  return cudaGetLastError();
}

template <int NC, bool kFull>
cudaError_t launch_t(const float* q, const float* k, const float* v,
                     const float* bias, const float* o, const float* g,
                     float* dq, float* dk, float* dv, const float* stats_in,
                     float* scratch, int B, int Lq, int Lk, int D, float scale,
                     cudaStream_t st) {
  constexpr size_t S = 32 * NC + kPad;
  constexpr size_t F = sizeof(float);
  const size_t rows = (size_t)B * Lq;
  const int kv = v == k ? 1 : 2;
  const dim3 q_grid((Lq + kTileM - 1) / kTileM, B);
  cudaError_t err;

  // scratch: m, l (used when the caller brings none), delta, dk/dv partials
  float* delta = scratch + 2 * rows;
  float* partials = scratch + stat_floats(rows);
  const float* m = stats_in;
  const float* l = stats_in == nullptr ? nullptr : stats_in + rows;
  if (stats_in == nullptr) {
    const size_t fixed = (kTileM * S + kPartFloats) * F;
    const size_t tile = kTileN * S * F;
    const int nbuf = pick_buffers(fixed, tile);
    if (nbuf == 0) return cudaErrorInvalidValue;
    const size_t smem = fixed + nbuf * tile;
    if ((err = allow_smem(stats_kernel<NC, kFull>, smem)) != cudaSuccess)
      return err;
    stats_kernel<NC, kFull><<<q_grid, kThreads, smem, st>>>(
        q, k, bias, scratch, scratch + rows, Lq, Lk, D, scale, nbuf);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    m = scratch;
    l = scratch + rows;
  }
  {
    const size_t fixed = (2 * kTileM * S + 2 * kPartFloats + kProbFloats
                          + 3 * kTileM) * F;
    const size_t tile = kv * kTileN * S * F;
    const int nbuf = pick_buffers(fixed, tile);
    if (nbuf == 0) return cudaErrorInvalidValue;
    const size_t smem = fixed + nbuf * tile;
    if ((err = allow_smem(dq_kernel<NC, kFull>, smem)) != cudaSuccess)
      return err;
    dq_kernel<NC, kFull><<<q_grid, kThreads, smem, st>>>(
        q, k, v, bias, o, g, m, l, dq, delta, Lq, Lk, D, scale, nbuf);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const Chunks chunks = query_chunks(B, Lq, Lk, 1);
  if (chunks.count > 65535) return cudaErrorInvalidValue;
  const size_t fixed = (kv * kTileM * S + 2 * kPartFloats + 2 * kProbFloats
                        + 3 * kTileN + kTileM) * F;
  const size_t tile = 2 * kTileN * S * F;
  const int nbuf = pick_buffers(fixed, tile);
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + nbuf * tile;
  if ((err = allow_smem(dkv_kernel<NC, kFull>, smem)) != cudaSuccess)
    return err;
  const bool direct = chunks.count == 1;
  const size_t n = (size_t)B * Lk * D;
  const dim3 grid((Lk + kTileM - 1) / kTileM, chunks.count, B);
  dkv_kernel<NC, kFull><<<grid, kThreads, smem, st>>>(
      q, k, v, bias, g, m, l, delta, direct ? dk : partials,
      direct ? dv : partials + chunks.count * n, B, Lq, Lk, D, chunks.len,
      scale, nbuf);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_chunks(chunks, partials, dk, dv, n, st);
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const float* o, const float* g,
                   float* dq, float* dk, float* dv, const float* stats_in,
                   float* scratch, int B, int Lq, int Lk, int D, float scale,
                   cudaStream_t st) {
  if (D == 32 * NC)
    return launch_t<NC, true>(q, k, v, bias, o, g, dq, dk, dv, stats_in,
                              scratch, B, Lq, Lk, D, scale, st);
  return launch_t<NC, false>(q, k, v, bias, o, g, dq, dk, dv, stats_in,
                             scratch, B, Lq, Lk, D, scale, st);
}

// the sliced kernels: D > 512
cudaError_t launch_sliced(const float* q, const float* k, const float* v,
                          const float* bias, const float* o, const float* g,
                          float* dq, float* dk, float* dv,
                          const float* stats_in, float* scratch, int B,
                          int Lq, int Lk, int D, float scale,
                          cudaStream_t st) {
  constexpr int NC = kSliceMaxNC;
  constexpr size_t S = 32 * NC + kPad;
  constexpr size_t F = sizeof(float);
  const size_t rows = (size_t)B * Lq;
  const int kv = v == k ? 1 : 2;
  const int slices = slices_of(D);
  if (slices > 65535) return cudaErrorInvalidValue;
  cudaError_t err;

  float* delta = scratch + 2 * rows;
  float* partials = scratch + stat_floats(rows);
  const float* m = stats_in;
  const float* l = stats_in == nullptr ? nullptr : stats_in + rows;
  if (stats_in == nullptr) {
    const size_t smem = ((kTileM + kTileN) * S + kPartFloats) * F;
    if ((err = allow_smem(stats_sliced_kernel<NC>, smem)) != cudaSuccess)
      return err;
    stats_sliced_kernel<NC>
        <<<dim3((Lq + kTileM - 1) / kTileM, B), kThreads, smem, st>>>(
            q, k, bias, scratch, scratch + rows, Lq, Lk, D, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    m = scratch;
    l = scratch + rows;
  }
  {
    const size_t smem = ((2 * kTileM + kv * kTileN) * S + 2 * kPartFloats
                         + kProbFloats + 3 * kTileM) * F;
    if (smem > kSmemMax) return cudaErrorInvalidValue;
    if ((err = allow_smem(dq_sliced_kernel<NC>, smem)) != cudaSuccess)
      return err;
    dq_sliced_kernel<NC>
        <<<dim3((Lq + kTileM - 1) / kTileM, B, slices), kThreads, smem, st>>>(
            q, k, v, bias, o, g, m, l, dq, delta, Lq, Lk, D, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const Chunks chunks = query_chunks(B, Lq, Lk, slices);
  if (chunks.count > 65535) return cudaErrorInvalidValue;
  const size_t smem = ((kv * kTileM + 2 * kTileN) * S + 2 * kPartFloats
                       + 2 * kProbFloats + 3 * kTileN + kTileM) * F;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if ((err = allow_smem(dkv_sliced_kernel<NC>, smem)) != cudaSuccess)
    return err;
  const bool direct = chunks.count == 1;
  const size_t n = (size_t)B * Lk * D;
  const long key_blocks = (long)((Lk + kTileM - 1) / kTileM) * slices;
  if (key_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  dkv_sliced_kernel<NC>
      <<<dim3((unsigned)key_blocks, chunks.count, B), kThreads, smem, st>>>(
          q, k, v, bias, g, m, l, delta, direct ? dk : partials,
          direct ? dv : partials + chunks.count * n, B, Lq, Lk, D, chunks.len,
          scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_chunks(chunks, partials, dk, dv, n, st);
}

}  // namespace

// floats of scratch dostpu_attention_bwd needs at this shape
extern "C" size_t dostpu_attention_bwd_scratch_floats(int B, int Lq, int Lk,
                                                      int D) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || D <= 0) return 0;
  return scratch_floats(B, Lq, Lk, D);
}

// All pointers are device pointers into contiguous, 16-byte aligned float32
// tensors: q/o/g [B, Lq, D], k/v [B, Lk, D] (v may be k itself), bias
// [B, Lk]; outputs dq [B, Lq, D], dk/dv [B, Lk, D]; stats_in is the
// forward's [2, B, Lq] (row max, then row sum) or null; scratch holds
// dostpu_attention_bwd_scratch_floats(B, Lq, Lk, D) floats. Any D >= 1.
// Returns the CUDA error code of the launches.
extern "C" int dostpu_attention_bwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    const float* o, const float* g, float* dq,
                                    float* dk, float* dv,
                                    const float* stats_in, float* scratch,
                                    int B, int Lq, int Lk, int D, float scale,
                                    void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slices_of(D) > 1)
    return launch_sliced(q, k, v, bias, o, g, dq, dk, dv, stats_in, scratch,
                         B, Lq, Lk, D, scale, st);
  switch ((D + 31) / 32) {
#define DOSTPU_CASE(nc)                                                      \
  case nc:                                                                   \
    return launch<nc>(q, k, v, bias, o, g, dq, dk, dv, stats_in, scratch, B, \
                      Lq, Lk, D, scale, st);
    DOSTPU_CASE(1) DOSTPU_CASE(2) DOSTPU_CASE(3) DOSTPU_CASE(4)
    DOSTPU_CASE(5) DOSTPU_CASE(6) DOSTPU_CASE(7) DOSTPU_CASE(8)
    DOSTPU_CASE(9) DOSTPU_CASE(10) DOSTPU_CASE(11) DOSTPU_CASE(12)
    DOSTPU_CASE(13) DOSTPU_CASE(14) DOSTPU_CASE(15) DOSTPU_CASE(16)
#undef DOSTPU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
