// Projection-free attention backward, float32 or bfloat16 operands, for
// sm_90a.
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
// The forms of the forward (attention.cu), chosen by the same rule
// (attention_rows.cuh form_of); no atomics anywhere, so the gradients are
// bit-identical from run to run, and with or without the forward's row
// statistics m and l (a caller without them, the LayerNorm-fused layer,
// gets them recomputed by the forward's own score and softmax code):
//   * online (D <= 512: f32, and bf16 over at most 32 keys; 3xTF32
//     mma.sync, tiles by cp.async; the bf16 form's tiles widened
//     in place, single-pass exact TF32 products, and the dq kernel's keys
//     walked twice, the first pass for delta = rowsum(dp p32)):
//     stats_kernel (only without the forward's statistics);
//     dq_kernel, one block per (16 query rows, batch element), keys streamed
//     in tiles of 32, delta = rowsum(g * o) (= rowsum(dp * p)) to scratch,
//     per tile the scores and dp as partial tiles (the warps split D), p =
//     exp(s - m) * (1 / l), ds, dq += ds k; dkv_kernel, one block per (16
//     keys, chunk of queries, batch element), queries streamed in tiles of
//     32: the transposed score and dp tiles, p^T and ds^T, dv += p^T g, dk
//     += ds^T q. Where keys are few the query range is cut into chunks so
//     that the grid fills the card (query_chunks); each chunk writes
//     partial dk/dv to scratch and reduce_kernel adds the chunks in order.
//     k and v are staged once where they are one tensor.
//   * rows (the forward's rows calls; attention_rows.cuh):
//     dq_rows_kernel holds its rows' s and dp over every key, formed once
//     over the full D; p32 = exp(s - m) / l (m and l recomputed there, by the
//     forward's code, when the caller has none), delta = rowsum(dp p32)
//     from the held rows in the same pass, ds held, dq = (ds k) scale slice
//     by slice. dkv_rows_kernel holds the transposed tile of its 16 keys
//     over a chunk of at most 256 queries (s^T and dp^T once over D), then
//     dv = p^T g and dk = (ds^T q) scale slice by slice; query chunks as in
//     the online form. bf16 products on the bf16 tensor cores (f32 sums),
//     f32 ones 3xTF32; one or two 16-row groups a block, as in the forward.
//   * sliced (the forward's sliced calls): stats_sliced_kernel,
//     dq_sliced_kernel, dkv_sliced_kernel split the output columns into
//     slices of 512 and stream the chunks of every operand through the same
//     staged tiles for the scores and dp, the block's own slice last, in the
//     forward's chunk order; bf16 tiles widened in place, single-pass exact
//     TF32 products, and the dq kernel's keys walked twice (the first pass
//     for delta = rowsum(dp p32): a bf16 o has been rounded twice).
// The bf16 forms round where the TPU kernel `_attn_bwd_kernel` rounds: s
// and dp accumulate in f32 from the bf16 values; p32 = exp(s - m) / l in
// f32 from the forward's f32 statistics when given; dv = bf16(p32)^T g, ds
// = p32 (dp - rowsum(dp p32)) in f32 then rounded to bf16, dq =
// bf16((bf16(ds) k) scale) and dk = bf16((bf16(ds)^T q) scale), each output
// rounded once after the scale; the query chunks' partial dk and dv are
// added in f32 in chunk order and rounded once. o is not read in bf16, nor
// in the rows form.

#include "attention_rows.cuh"

namespace {

using namespace attn;

constexpr int kResidentBlocks = 264;  // two on each of an H100's 132 SMs

// the calling warp's partial tile of a product of staged rows: 3xTF32 for
// f32 operands, one exact pass for widened bf16 ones
template <bool kSplit, int NC>
__device__ __forceinline__ void partial_tile_t(const float* a_s,
                                               const float* t_s, int stride,
                                               int halves, int warp, int lane,
                                               float* parts,
                                               bool add = false) {
  if constexpr (kSplit)
    partial_tile<NC>(a_s, t_s, stride, halves, warp, lane, parts, add);
  else
    partial_tile_exact<NC>(a_s, t_s, stride, halves, warp, lane, parts, add);
}

template <bool kSplit, int NC>
__device__ __forceinline__ void prob_times_rows_t(const float* p_s,
                                                  const float* t_s, int stride,
                                                  int c0, int halves, int lane,
                                                  float (&acc)[NC][4]) {
  if constexpr (kSplit)
    prob_times_rows<NC>(p_s, t_s, stride, c0, halves, lane, acc);
  else
    prob_times_rows_exact<NC>(p_s, t_s, stride, c0, halves, lane, acc);
}

// rows of m and l for a caller without the forward's: the forward's loop
// without p v (bf16: its first pass, to the same bits)
// kFull (the three kernels below): D == 32 NC, known at compile time
// T (the three kernels below): float, or bf16 staged raw and widened
template <typename T, int NC, bool kFull>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const float* __restrict__ bias, float* __restrict__ m_out,
             float* __restrict__ l_out, int Lq, int Lk, int D_, float scale,
             int nbuf) {
  constexpr int S = 32 * NC + kPad;
  constexpr bool kSplit = sizeof(T) == 4;
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
  const T* kb = k + (size_t)b * Lk * D;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  auto stage = [&](int tile, int buf) {
    stage_rows<T, NC>(k_s + buf * tile_floats, kb, tile * kTileN, kTileN, Lk,
                      D, 0, D);
  };
  stage_rows<T, NC>(q_s, q + (size_t)b * Lq * D, q0, kTileM, Lq, D, 0, D);
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
    const int halves = (nk + 15) / 16;
    if constexpr (!kSplit) {  // the tile has landed raw
      if (it == 0)
        widen_rows<NC>(q_s, kTileM, min(kTileM, Lq - q0), D, warp, lane);
      widen_rows<NC>(k_s + buf * tile_floats, 16 * halves, nk, D, warp, lane);
      __syncthreads();
    }
    partial_tile_t<kSplit, NC>(q_s, k_s + buf * tile_floats, S, halves, warp,
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
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
stats_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ bias, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Lq, int Lk, int D,
                    float scale) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;
  float* t_s = a_s + kTileM * S;
  float* parts = t_s + kTileN * S;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileM;
  const int n_chunks = (D + W - 1) / W;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kTileM, Lq - q0);
  const T* qb = q + (size_t)b * Lq * D;
  const T* kb = k + (size_t)b * Lk * D;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTileN;
    const int nk = min(kTileN, Lk - k0);
    const int halves = (nk + 15) / 16;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int cc = slice_chunk(ci, 0, n_chunks) * W;
      const int w = min(W, D - cc);
      __syncthreads();
      stage_rows<T, NC>(a_s, qb, q0, kTileM, Lq, D, cc, w);
      stage_rows<T, NC>(t_s, kb, k0, kTileN, Lk, D, cc, w);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if constexpr (!kSplit) {
        widen_rows<NC>(a_s, kTileM, nq, w, warp, lane);
        widen_rows<NC>(t_s, 16 * halves, nk, w, warp, lane);
        __syncthreads();
      }
      partial_tile_t<kSplit, NC>(a_s, t_s, S, halves, warp, lane, parts,
                                 ci > 0);
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
// and dkv kernels share. bj is the key's bias; m, il and delta are the
// query's row max, 1 / row sum (f32 form) or row sum (bf16 form: p is
// divided by it) and rowsum(dp * p).
template <bool kSplit>
__device__ __forceinline__ void p_and_ds(float s, float dp, bool valid,
                                         float scale, float bj, float m,
                                         float il, float delta, float& p,
                                         float& ds) {
  if constexpr (kSplit)
    p = valid ? expf(fmaf(s, scale, bj) - m) * il : 0.f;
  else
    p = valid ? expf(fmaf(s, scale, bj) - m) / il : 0.f;
  ds = valid ? p * (dp - delta) : 0.f;
}

// a probability or ds as the second product's operand: f32 as it is, bf16
// rounded (the TPU kernel's casts of p and ds to the operand dtype)
template <bool kSplit>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kSplit)
    return v;
  else
    return rounded<__nv_bfloat16>(v);
}

// the rows' statistics of the block's 16 query rows (m_s; 1 / l, or l in
// the bf16 form, in il_s) and, in the f32 form, delta = rowsum(g * o) (to
// the shared dl_s, and to delta_out unless it is null): one warp a row,
// four rows a warp. (The bf16 form forms delta from dp and p: dq_kernel.)
template <typename T>
__device__ __forceinline__ void row_inputs(
    const T* __restrict__ g, const float* __restrict__ o,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    float* __restrict__ delta_out, float* m_s, float* il_s, float* dl_s,
    int b, int q0, int Lq, int D, int warp, int lane) {
  constexpr bool kSplit = sizeof(T) == 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r;
    const int i = q0 + row;
    const size_t at = (size_t)b * Lq + i;
    float s = 0.f;
    if constexpr (kSplit) {
      if (i < Lq)
        for (int c = lane; c < D; c += 32)
          s = fmaf(g[at * D + c], o[at * D + c], s);
      s = warp_sum(s);
    }
    if (lane == 0) {
      m_s[row] = i < Lq ? m_in[at] : 0.f;
      if (kSplit) {
        dl_s[row] = s;
        il_s[row] = i < Lq ? 1.f / l_in[at] : 0.f;
        if (i < Lq && delta_out != nullptr) delta_out[at] = s;
      } else {
        il_s[row] = i < Lq ? l_in[at] : 1.f;
      }
    }
  }
}

// p and ds of the [16 x 32] tile from the summed score and dp partials,
// ds (rounded to bf16 in the bf16 form) to ds_s in prob_pos order (the
// query rows' view: lane = key)
template <bool kSplit>
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
    p_and_ds<kSplit>(sum_partials(s_parts, row, lane),
                     sum_partials(dp_parts, row, lane), valid, scale, bj,
                     m_s[row], il_s[row], dl_s[row], p, ds);
    ds_s[row * kProbStride + pos] = operand<kSplit>(ds);
  }
}

// the bf16 dq kernels' first pass, one key tile: each lane adds p32 * dp of
// its key to its share of the calling warp's rows' delta
__device__ __forceinline__ void delta_tile(const float* s_parts,
                                           const float* dp_parts,
                                           const float* bias_b, int k0,
                                           int Lk, float scale,
                                           const float* m_s,
                                           const float* il_s, int warp,
                                           int lane, float (&dsum)[4]) {
  const bool valid = k0 + lane < Lk;
  const float bj = valid ? bias_b[k0 + lane] : 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r;
    float p, ds;
    const float dp = sum_partials(dp_parts, row, lane);
    p_and_ds<false>(sum_partials(s_parts, row, lane), dp, valid, scale, bj,
                    m_s[row], il_s[row], 0.f, p, ds);
    dsum[r] = fmaf(p, dp, dsum[r]);
  }
}

// the end of the first pass: the lanes' shares added across the warp, the
// rows' delta to dl_s and (unless null) delta_out
__device__ __forceinline__ void finish_delta(const float (&dsum)[4],
                                             float* dl_s,
                                             float* __restrict__ delta_out,
                                             int b, int q0, int Lq, int warp,
                                             int lane) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r;
    const float s = warp_sum(dsum[r]);
    if (lane == 0) {
      dl_s[row] = s;
      if (q0 + row < Lq && delta_out != nullptr)
        delta_out[(size_t)b * Lq + q0 + row] = s;
    }
  }
}

template <typename T, int NC, bool kFull>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ bias,
          const float* __restrict__ o, const T* __restrict__ g,
          const float* __restrict__ m_in, const float* __restrict__ l_in,
          T* __restrict__ dq, float* __restrict__ delta_out, int Lq, int Lk,
          int D_, float scale, int nbuf) {
  constexpr int S = 32 * NC + kPad;
  constexpr bool kSplit = sizeof(T) == 4;
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
  float* il_s = m_s + kTileM;            // [16] 1 / row sum (bf16: row sum)
  float* dl_s = il_s + kTileM;           // [16] delta
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int c0 = warp * 8 * NC;
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
  const float* bias_b = bias + (size_t)b * Lk;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  // iteration it stages key tile it % n_tiles
  auto stage = [&](int it, int buf) {
    float* dst = kv_s + buf * tile_floats;
    const int r0 = (it % n_tiles) * kTileN;
    stage_rows<T, NC>(dst, kb, r0, kTileN, Lk, D, 0, D);
    if (!v_is_k)
      stage_rows<T, NC>(dst + kTileN * S, vb, r0, kTileN, Lk, D, 0, D);
  };
  stage_rows<T, NC>(q_s, q + (size_t)b * Lq * D, q0, kTileM, Lq, D, 0, D);
  stage_rows<T, NC>(g_s, g + (size_t)b * Lq * D, q0, kTileM, Lq, D, 0, D);
  stage(0, 0);
  cp_async_commit();
  // the rows' statistics (f32: and delta) while the copies fly
  row_inputs(g, o, m_in, l_in, delta_out, m_s, il_s, dl_s, b, q0, Lq, D, warp,
             lane);

  float acc[NC][4];
  zero_acc<NC>(acc);
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};  // bf16: the lanes' shares of delta
  // f32: one pass; bf16: the key tiles twice, the first for delta only
  const int n_iter = (kSplit ? 1 : 2) * n_tiles;
  for (int it = 0; it < n_iter; ++it) {
    const int buf = ring_acquire(it, n_iter, nbuf, stage);
    float* k_s = kv_s + buf * tile_floats;
    float* v_s = v_is_k ? k_s : k_s + kTileN * S;
    const int k0 = (it % n_tiles) * kTileN;
    const int nk = min(kTileN, Lk - k0);
    const int halves = (nk + 15) / 16;
    if constexpr (!kSplit) {  // the tile has landed raw: widen it
      if (it == 0) {
        widen_rows<NC>(q_s, kTileM, min(kTileM, Lq - q0), D, warp, lane);
        widen_rows<NC>(g_s, kTileM, min(kTileM, Lq - q0), D, warp, lane);
      }
      widen_rows<NC>(k_s, 16 * halves, nk, D, warp, lane);
      if (!v_is_k) widen_rows<NC>(v_s, 16 * halves, nk, D, warp, lane);
      __syncthreads();
    }
    partial_tile_t<kSplit, NC>(q_s, k_s, S, halves, warp, lane, s_parts);
    partial_tile_t<kSplit, NC>(g_s, v_s, S, halves, warp, lane, dp_parts);
    __syncthreads();
    if (!kSplit && it < n_tiles) {  // bf16, first pass
      delta_tile(s_parts, dp_parts, bias_b, k0, Lk, scale, m_s, il_s, warp,
                 lane, dsum);
      if (it == n_tiles - 1)
        finish_delta(dsum, dl_s, delta_out, b, q0, Lq, warp, lane);
      continue;
    }
    ds_tile<kSplit>(s_parts, dp_parts, bias_b, k0, Lk, scale, m_s, il_s, dl_s,
                    ds_s, warp, lane);
    __syncthreads();
    prob_times_rows_t<kSplit, NC>(ds_s, k_s, S, c0, halves, lane, acc);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gq + 8 * half;
    if (q0 + row >= Lq) continue;
    T* at = dq + ((size_t)b * Lq + q0 + row) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store_pair_t(at, c0 + 8 * n + 2 * t, D, D, acc[n][2 * half] * scale,
                   acc[n][2 * half + 1] * scale);
  }
}

// dq_kernel above 32 NC columns: grid (query tiles, B, slices). Shared
// memory: q and g chunks [16][W+4] each, a k chunk [32][W+4] (the slice,
// last), a v chunk [32][W+4] when v is another tensor, the score and dp
// partial tiles, the ds tile and the rows' statistics. The blocks of slice
// 0 write delta.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
dq_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ o, const T* __restrict__ g,
                 const float* __restrict__ m_in,
                 const float* __restrict__ l_in, T* __restrict__ dq,
                 float* __restrict__ delta_out, int Lq, int Lk, int D,
                 float scale) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  constexpr bool kSplit = sizeof(T) == 4;
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
  const int nq = min(kTileM, Lq - q0);
  const T* qb = q + (size_t)b * Lq * D;
  const T* gb = g + (size_t)b * Lq * D;
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
  const float* bias_b = bias + (size_t)b * Lk;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;
  float* delta_to = slice == 0 ? delta_out : nullptr;

  // every slice's blocks form delta (f32: the same bits); slice 0's write it
  row_inputs(g, o, m_in, l_in, delta_to, m_s, il_s, dl_s, b, q0, Lq, D, warp,
             lane);

  float acc[NC][4];
  zero_acc<NC>(acc);
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};
  // f32: one pass; bf16: the key tiles twice, the first for delta only
  const int n_iter = (kSplit ? 1 : 2) * n_tiles;
  for (int it = 0; it < n_iter; ++it) {
    const int k0 = (it % n_tiles) * kTileN;
    const int nk = min(kTileN, Lk - k0);
    const int halves = (nk + 15) / 16;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int cc = slice_chunk(ci, slice, n_chunks) * W;
      const int w = min(W, D - cc);
      __syncthreads();
      stage_rows<T, NC>(a_s, qb, q0, kTileM, Lq, D, cc, w);
      stage_rows<T, NC>(g_s, gb, q0, kTileM, Lq, D, cc, w);
      stage_rows<T, NC>(t_s, kb, k0, kTileN, Lk, D, cc, w);
      if (!v_is_k) stage_rows<T, NC>(u_s, vb, k0, kTileN, Lk, D, cc, w);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if constexpr (!kSplit) {
        widen_rows<NC>(a_s, kTileM, nq, w, warp, lane);
        widen_rows<NC>(g_s, kTileM, nq, w, warp, lane);
        widen_rows<NC>(t_s, 16 * halves, nk, w, warp, lane);
        if (!v_is_k) widen_rows<NC>(u_s, 16 * halves, nk, w, warp, lane);
        __syncthreads();
      }
      partial_tile_t<kSplit, NC>(a_s, t_s, S, halves, warp, lane, s_parts,
                                 ci > 0);
      partial_tile_t<kSplit, NC>(g_s, v_is_k ? t_s : u_s, S, halves, warp,
                                 lane, dp_parts, ci > 0);
    }
    __syncthreads();
    if (!kSplit && it < n_tiles) {  // bf16, first pass
      delta_tile(s_parts, dp_parts, bias_b, k0, Lk, scale, m_s, il_s, warp,
                 lane, dsum);
      if (it == n_tiles - 1)
        finish_delta(dsum, dl_s, delta_to, b, q0, Lq, warp, lane);
      continue;
    }
    ds_tile<kSplit>(s_parts, dp_parts, bias_b, k0, Lk, scale, m_s, il_s, dl_s,
                    ds_s, warp, lane);
    __syncthreads();
    prob_times_rows_t<kSplit, NC>(ds_s, t_s, S, c0, halves, lane,
                                  acc);  // k's slice
  }

  const int ds = min(W, D - s0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gq + 8 * half;
    if (q0 + row >= Lq) continue;
    T* at = dq + ((size_t)b * Lq + q0 + row) * D + s0;
#pragma unroll
    for (int n = 0; n < NC; ++n)  // a pair lies in the slice where D is even
      store_pair_t(at, c0 + 8 * n + 2 * t, ds, D, acc[n][2 * half] * scale,
                   acc[n][2 * half + 1] * scale);
  }
}

// p^T and ds^T of the [16 keys x 32 queries] tile (rows = the block's keys)
// into pt_s and dst_s, prob_pos order (rounded to bf16 in the bf16 form)
template <bool kSplit>
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
    p_and_ds<kSplit>(sum_partials(s_parts, row, lane),
                     sum_partials(dp_parts, row, lane), valid, scale,
                     bias_s[row], m_s[lane], il_s[lane], dl_s[lane], p, ds);
    pt_s[row * kProbStride + pos] = operand<kSplit>(p);
    dst_s[row * kProbStride + pos] = operand<kSplit>(ds);
  }
}

// m, 1 / l (bf16: l) and delta of the query tile [i0, i0 + 32) (those at
// or past i_end 0, and l 1) -> m_s, il_s, dl_s, by the block's first 32
// threads
template <bool kSplit>
__device__ __forceinline__ void query_tile_inputs(
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ delta_in, float* m_s, float* il_s, float* dl_s,
    int b, int Lq, int i0, int i_end) {
  if (threadIdx.x < kTileN) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < i_end;
    const size_t at = (size_t)b * Lq + i;
    m_s[threadIdx.x] = ok ? m_in[at] : 0.f;
    if constexpr (kSplit)
      il_s[threadIdx.x] = ok ? 1.f / l_in[at] : 0.f;
    else
      il_s[threadIdx.x] = ok ? l_in[at] : 1.f;
    dl_s[threadIdx.x] = ok ? delta_in[at] : 0.f;
  }
}

// dk and dv at row `at` of the outputs (dk_part null: one query chunk, the
// outputs themselves, rounded once) or of this chunk's f32 partials
template <typename T>
__device__ __forceinline__ void store_dkv(T* dk, T* dv, float* dk_part,
                                          float* dv_part, size_t at, int col,
                                          int lim, int D, float k0, float k1,
                                          float v0, float v1) {
  if (dk_part != nullptr) {
    store_pair_t(dk_part + at, col, lim, D, k0, k1);
    store_pair_t(dv_part + at, col, lim, D, v0, v1);
  } else {
    store_pair_t(dk + at, col, lim, D, k0, k1);
    store_pair_t(dv + at, col, lim, D, v0, v1);
  }
}

// grid (key tiles of 16, query chunks, B); chunk_len is a multiple of 32.
// With one chunk the block writes dk and dv (dk_part and dv_part null);
// with several, dk_part / dv_part are [chunks][B][Lk][D] f32 partials.
template <typename T, int NC, bool kFull>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ bias,
           const T* __restrict__ g, const float* __restrict__ m_in,
           const float* __restrict__ l_in, const float* __restrict__ delta_in,
           T* __restrict__ dk, T* __restrict__ dv,
           float* __restrict__ dk_part, float* __restrict__ dv_part, int B,
           int Lq, int Lk, int D_, int chunk_len, float scale, int nbuf) {
  constexpr int S = 32 * NC + kPad;
  constexpr bool kSplit = sizeof(T) == 4;
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
  const T* qb = q + (size_t)b * Lq * D;
  const T* gb = g + (size_t)b * Lq * D;
  const int n_tiles = (i_end - i_begin + kTileN - 1) / kTileN;

  auto stage = [&](int tile, int buf) {
    float* dst = qg_s + buf * tile_floats;
    stage_rows<T, NC>(dst, qb, i_begin + tile * kTileN, kTileN, Lq, D, 0, D);
    stage_rows<T, NC>(dst + kTileN * S, gb, i_begin + tile * kTileN, kTileN,
                      Lq, D, 0, D);
  };
  stage_rows<T, NC>(k_s, k + (size_t)b * Lk * D, j0, kTileM, Lk, D, 0, D);
  if (!v_is_k)
    stage_rows<T, NC>(v_s, v + (size_t)b * Lk * D, j0, kTileM, Lk, D, 0, D);
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
    float* q_s = qg_s + buf * tile_floats;
    float* g_s = q_s + kTileN * S;
    const int i0 = i_begin + it * kTileN;
    const int nq = min(kTileN, i_end - i0);
    const int halves = (nq + 15) / 16;
    // read again only after the next barrier
    query_tile_inputs<kSplit>(m_in, l_in, delta_in, m_s, il_s, dl_s, b, Lq,
                              i0, i_end);
    if constexpr (!kSplit) {  // the tiles have landed raw: widen them
      if (it == 0) {
        widen_rows<NC>(k_s, kTileM, min(kTileM, Lk - j0), D, warp, lane);
        if (!v_is_k)
          widen_rows<NC>(v_s, kTileM, min(kTileM, Lk - j0), D, warp, lane);
      }
      widen_rows<NC>(q_s, 16 * halves, nq, D, warp, lane);
      widen_rows<NC>(g_s, 16 * halves, nq, D, warp, lane);
      __syncthreads();
    }
    // rows = the block's keys, columns = the tile's queries
    partial_tile_t<kSplit, NC>(k_s, q_s, S, halves, warp, lane, s_parts);
    partial_tile_t<kSplit, NC>(v_s, g_s, S, halves, warp, lane, dp_parts);
    __syncthreads();
    dkv_tile<kSplit>(s_parts, dp_parts, bias_s, m_s, il_s, dl_s, pt_s, dst_s,
                     nq, j0, Lk, scale, warp, lane);
    __syncthreads();
    prob_times_rows_t<kSplit, NC>(pt_s, g_s, S, c0, halves, lane, acc_v);
    prob_times_rows_t<kSplit, NC>(dst_s, q_s, S, c0, halves, lane, acc_k);
  }

  const size_t chunk_off =
      dk_part != nullptr ? (size_t)blockIdx.y * B * Lk * D : 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gk + 8 * half;
    if (j0 + row >= Lk) continue;
    const size_t at = chunk_off + ((size_t)b * Lk + j0 + row) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store_dkv(dk, dv, dk_part, dv_part, at, c0 + 8 * n + 2 * t, D, D,
                acc_k[n][2 * half] * scale, acc_k[n][2 * half + 1] * scale,
                acc_v[n][2 * half], acc_v[n][2 * half + 1]);
  }
}

// dkv_kernel above 32 NC columns: grid (key tiles of 16 x slices, query
// chunks, B). Shared memory: k and v chunks of the block's keys [16][W+4]
// (one where v is k), q and g chunks of the query tile [32][W+4] (the
// slice, last), the partial tiles, p^T and ds^T, the statistics.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
dkv_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bias,
                  const T* __restrict__ g, const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ delta_in, T* __restrict__ dk,
                  T* __restrict__ dv, float* __restrict__ dk_part,
                  float* __restrict__ dv_part, int B, int Lq, int Lk, int D,
                  int chunk_len, float scale) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  constexpr bool kSplit = sizeof(T) == 4;
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
  const int nk = min(kTileM, Lk - j0);
  const int i_begin = blockIdx.y * chunk_len;
  const int i_end = min(Lq, i_begin + chunk_len);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gk = lane >> 2, t = lane & 3;
  const int c0 = warp * 8 * NC;
  const T* qb = q + (size_t)b * Lq * D;
  const T* gb = g + (size_t)b * Lq * D;
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
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
        query_tile_inputs<kSplit>(m_in, l_in, delta_in, m_s, il_s, dl_s, b,
                                  Lq, i0, i_end);
      stage_rows<T, NC>(kc_s, kb, j0, kTileM, Lk, D, cc, w);
      if (!v_is_k) stage_rows<T, NC>(vc_s, vb, j0, kTileM, Lk, D, cc, w);
      stage_rows<T, NC>(qc_s, qb, i0, kTileN, i_end, D, cc, w);
      stage_rows<T, NC>(gc_s, gb, i0, kTileN, i_end, D, cc, w);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if constexpr (!kSplit) {
        widen_rows<NC>(kc_s, kTileM, nk, w, warp, lane);
        if (!v_is_k) widen_rows<NC>(vc_s, kTileM, nk, w, warp, lane);
        widen_rows<NC>(qc_s, 16 * halves, nq, w, warp, lane);
        widen_rows<NC>(gc_s, 16 * halves, nq, w, warp, lane);
        __syncthreads();
      }
      partial_tile_t<kSplit, NC>(kc_s, qc_s, S, halves, warp, lane, s_parts,
                                 ci > 0);
      partial_tile_t<kSplit, NC>(vc_s, gc_s, S, halves, warp, lane, dp_parts,
                                 ci > 0);
    }
    __syncthreads();
    dkv_tile<kSplit>(s_parts, dp_parts, bias_s, m_s, il_s, dl_s, pt_s, dst_s,
                     nq, j0, Lk, scale, warp, lane);
    __syncthreads();
    // the last chunks staged were the slice's
    prob_times_rows_t<kSplit, NC>(pt_s, gc_s, S, c0, halves, lane, acc_v);
    prob_times_rows_t<kSplit, NC>(dst_s, qc_s, S, c0, halves, lane, acc_k);
  }

  const int ds = min(W, D - s0);
  const size_t chunk_off =
      dk_part != nullptr ? (size_t)blockIdx.y * B * Lk * D : 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gk + 8 * half;
    if (j0 + row >= Lk) continue;
    const size_t at = chunk_off + ((size_t)b * Lk + j0 + row) * D + s0;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store_dkv(dk, dv, dk_part, dv_part, at, c0 + 8 * n + 2 * t, ds, D,
                acc_k[n][2 * half] * scale, acc_k[n][2 * half + 1] * scale,
                acc_v[n][2 * half], acc_v[n][2 * half + 1]);
  }
}

// ----- the rows form (attention_rows.cuh): Lk <= 256 -----

// the rows' sums of x * y (the order of row_sum) -> out_s[16]
__device__ __forceinline__ void row_dot(const float (&x)[rows::kNT][4],
                                        const float (&y)[rows::kNT][4],
                                        int nt, int warp, int lane,
                                        float* red, float* out_s) {
  float xy[rows::kNT][4];
#pragma unroll
  for (int i = 0; i < rows::kNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) xy[i][e] = x[i][e] * y[i][e];
  rows::row_sum(xy, nt, warp, lane, red, out_s);
}

// dq and the rows' delta (and, without the forward's statistics, m and l):
// grid (query tiles of 16 G, B), G = `groups` 16-row groups of 4 warps.
// Phase 1 forms s = q k^T and dp = g v^T over the full D (q, g chunks of
// every group's rows, k, v chunks of every key, `cols` columns wide; k
// staged once where v is k); phase 2 takes m and l (the forward's, or
// recomputed by the forward's own code: softmax_rows), p32 = exp(s - m) /
// l, delta = rowsum(dp p32) from the held rows, ds = p32 (dp - delta) held
// (bf16: rounded); phase 3 dq = (ds k) scale slice by slice. m, l (when
// recomputed) and delta go to the scratch for dkv_rows_kernel.
template <typename T>
__global__ void __launch_bounds__(rows::kMaxThreads, 1)
dq_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               const T* __restrict__ g, const float* __restrict__ m_in,
               const float* __restrict__ l_in, T* __restrict__ dq,
               float* __restrict__ m_out, float* __restrict__ l_out,
               float* __restrict__ delta_out, int Lq, int Lk, int D, int nc,
               int cols, int groups, int tr, float scale, int nbuf,
               int buf_bytes) {
  using namespace rows;
  const int TR = tr;  // rows of a phase-3 tile
  extern __shared__ __align__(16) float smem_f[];  // one type a file
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const int grp = threadIdx.x / kThreads;
  const int warp = threadIdx.x % kThreads / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  T* held = reinterpret_cast<T*>(smem + grp * held_bytes<T>(Lk));  // ds
  float* red = reinterpret_cast<float*>(smem + groups * held_bytes<T>(Lk));
  float* m_s = red + kMaxGroups * kWarps * kTileM;  // [groups][16] row max
  float* l_s = m_s + kMaxGroups * kTileM;           // [groups][16] row sum
  float* dl_s = l_s + kMaxGroups * kTileM;          // [groups][16] delta
  float* bias_s = dl_s + kMaxGroups * kTileM;       // [kMaxL]
  unsigned char* ring = reinterpret_cast<unsigned char*>(bias_s + kMaxL);
  red += grp * kWarps * kTileM;
  m_s += grp * kTileM;
  l_s += grp * kTileM;
  dl_s += grp * kTileM;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTileM * groups;
  const int q0 = r0 + kTileM * grp;
  const int lt = threadIdx.x % kThreads;
  const bool v_is_k = v == k;
  const T* qb = q + (size_t)b * Lq * D;
  const T* gb = g + (size_t)b * Lq * D;
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
  const int ls = held_stride(Lk);
  const int nt = tiles8(Lk);
  const int cs = cols + Op<T>::kPad;
  const int us = tile_stride<T>(nc);
  const int W = 32 * nc;
  const int n1 = (D + cols - 1) / cols;
  const int tiles = (Lk + TR - 1) / TR;
  const int n_slices = (D + W - 1) / W;
  const bool reuse = reuses_chunk(D, cols, nc);  // ds k from the chunk's k
  const int n_iter = n1 + (reuse ? 0 : n_slices * tiles);
  const int rows_a = kTileM * groups;
  const int rows_t = staged_rows(Lk);
  // a chunk: q, g [16 G], k, v (where distinct) [rows_t]
  const size_t at_g = (size_t)rows_a * cs;
  const size_t at_k = 2 * at_g;
  const size_t at_v = at_k + (v_is_k ? 0 : (size_t)rows_t * cs);

  // the chunks, then k's tiles
  auto stage = [&](int it, int buf) {
    T* dst = reinterpret_cast<T*>(ring + (size_t)buf * buf_bytes);
    if (it < n1) {
      const int c0 = it * cols, w = min(cols, D - c0);
      stage_zero(dst, cs, qb, r0, rows_a, Lq, D, c0, w, cols);
      stage_zero(dst + at_g, cs, gb, r0, rows_a, Lq, D, c0, w, cols);
      stage_zero(dst + at_k, cs, kb, 0, rows_t, Lk, D, c0, w, cols);
      if (!v_is_k)
        stage_zero(dst + at_v, cs, vb, 0, rows_t, Lk, D, c0, w, cols);
    } else {
      const int r = it - n1, s0 = (r / tiles) * W, kt = r % tiles;
      stage_zero(dst, us, kb, kt * TR, TR, Lk, D, s0, min(W, D - s0), W);
    }
  };
  ring_start(n_iter, nbuf, stage);
  for (int i = threadIdx.x; i < Lk; i += blockDim.x)
    bias_s[i] = bias[(size_t)b * Lk + i];
  const bool recompute = m_in == nullptr;
  if (!recompute && lt < kTileM) {
    const int i = q0 + lt;
    m_s[lt] = i < Lq ? m_in[(size_t)b * Lq + i] : 0.f;
    l_s[lt] = i < Lq ? l_in[(size_t)b * Lq + i] : 1.f;
  }

  // 1: the scores and dp
  float s[kNT][4], dp[kNT][4];
  zero(s);
  zero(dp);
  for (int it = 0; it < n1; ++it) {
    const int buf = ring_next(it, n_iter, nbuf, stage);
    const T* a_s = reinterpret_cast<const T*>(ring + (size_t)buf * buf_bytes);
    const int subs = (min(cols, D - it * cols) + Op<T>::kChunk - 1)
                     / Op<T>::kChunk;
    const size_t mine = (size_t)kTileM * grp * cs;
    scores_chunk(a_s + mine, a_s + at_k, cs, subs, nt, warp, lane, s);
    scores_chunk(a_s + at_g + mine, a_s + at_v, cs, subs, nt, warp, lane, dp);
  }

  // 2: p32, delta from the held rows, ds
  bias_scores(s, nt, Lk, bias_s, scale, warp, lane);
  if (recompute) {
    softmax_rows(s, nt, warp, lane, red, m_s, l_s);  // the forward's bits
  } else {
    const float m[2] = {m_s[gq], m_s[gq + 8]};
#pragma unroll
    for (int i = 0; i < kNT; ++i)
      if (warp + 4 * i < nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = expf(s[i][e] - m[e >> 1]);
  }
  const float l[2] = {l_s[gq], l_s[gq + 8]};
#pragma unroll
  for (int i = 0; i < kNT; ++i)
    if (warp + 4 * i < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = s[i][e] / l[e >> 1];  // p32
  row_dot(s, dp, nt, warp, lane, red, dl_s);
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int j = warp + 4 * i;
    if (j < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gq + 8 * (e >> 1);
        put_held(held, ls, row, 8 * j + 2 * t + (e & 1),
                 s[i][e] * (dp[i][e] - dl_s[row]));
      }
  }
  zero_held_tail(held, ls, Lk, nt, warp, lane);
  if (lt < kTileM && q0 + lt < Lq) {
    const size_t at = (size_t)b * Lq + q0 + lt;
    delta_out[at] = dl_s[lt];
    if (recompute) {
      m_out[at] = m_s[lt];
      l_out[at] = l_s[lt];
    }
  }

  // 3: dq = (ds k) scale, slice by slice
  const int c0 = warp * 8 * nc;
  const float rs[2] = {scale, scale};
  if (reuse) __syncthreads();  // the held ds (no ring barrier comes)
  for (int sl = 0; sl < n_slices; ++sl) {
    float acc[kMaxNC][4];
    zero(acc);
    for (int kt = 0; kt < tiles; ++kt) {
      const T* u = reinterpret_cast<const T*>(ring) + at_k + kt * TR * cs
                   + sl * W;  // the slice's columns
      if (!reuse)
        u = reinterpret_cast<const T*>(
            ring + (size_t)ring_next(n1 + sl * tiles + kt, n_iter, nbuf,
                                     stage) * buf_bytes);
      product_tile(held, ls, kt * TR, min(TR, Lk - kt * TR), u,
                   reuse ? cs : us, c0, nc, lane, acc);
    }
    store_slice(dq + (size_t)b * Lq * D, q0, Lq, D, sl * W,
                min(W, D - sl * W), c0, nc, rs, lane, acc);
  }
}

// dk and dv: grid (key tiles of 16 G, query chunks, B), G = `groups`
// 16-key groups of 4 warps; chunk_len <= 256 is a multiple of 32. Phase 1
// forms s^T = k q^T and dp^T = v g^T over the full D for the block's keys
// against the chunk's queries (chunks `cols` columns wide); phase 2 holds
// p^T = exp(s^T - m) / l and ds^T = p^T (dp^T - delta) (bf16: rounded),
// from the rows' m, l and delta; phase 3 dv = p^T g, then dk = (ds^T q)
// scale, slice by slice. With one chunk the block writes dk and dv (dk_part
// and dv_part null); with several, dk_part / dv_part are [chunks][B][Lk][D]
// f32 partials.
template <typename T>
__global__ void __launch_bounds__(rows::kMaxThreads, 1)
dkv_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                const T* __restrict__ g, const float* __restrict__ m_in,
                const float* __restrict__ l_in,
                const float* __restrict__ delta_in, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dk_part,
                float* __restrict__ dv_part, int B, int Lq, int Lk, int D,
                int nc, int cols, int groups, int chunk_len, int tr,
                float scale, int nbuf, int buf_bytes) {
  using namespace rows;
  const int TR = tr;  // rows of a phase-3 tile
  extern __shared__ __align__(16) float smem_f[];  // one type a file
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const int grp = threadIdx.x / kThreads;
  const int warp = threadIdx.x % kThreads / 32;
  const int lane = threadIdx.x % 32;
  const int gk = lane >> 2, t = lane & 3;
  const size_t hb = held_bytes<T>(chunk_len);
  T* pt = reinterpret_cast<T*>(smem + grp * hb);              // p^T
  T* dst = reinterpret_cast<T*>(smem + (groups + grp) * hb);  // ds^T
  // m, l and delta of the chunk's queries [kMaxL] each
  float* m_s = reinterpret_cast<float*>(smem + 2 * groups * hb);
  float* l_s = m_s + kMaxL;
  float* dl_s = l_s + kMaxL;
  float* kbias_s = dl_s + kMaxL;  // [groups][16] of the block's keys
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(kbias_s + kMaxGroups * kTileM);
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * kTileM * groups;  // the block's first key
  const int j0 = r0 + kTileM * grp;              // the group's
  const int i_begin = blockIdx.y * chunk_len;
  const int i_end = min(Lq, i_begin + chunk_len);
  const int L = i_end - i_begin;
  const bool v_is_k = v == k;
  const T* qb = q + (size_t)b * Lq * D;
  const T* gb = g + (size_t)b * Lq * D;
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
  const int ls = held_stride(chunk_len);
  const int nt = tiles8(L);
  const int cs = cols + Op<T>::kPad;
  const int us = tile_stride<T>(nc);
  const int W = 32 * nc;
  const int n1 = (D + cols - 1) / cols;
  const int tiles = (L + TR - 1) / TR;
  const int n_slices = (D + W - 1) / W;
  const int n_out = n_slices * tiles;  // phase-3 tiles of one output
  const bool reuse = reuses_chunk(D, cols, nc);  // from the chunk's q, g
  const int n_iter = n1 + (reuse ? 0 : 2 * n_out);
  const int rows_a = kTileM * groups;
  const int rows_t = staged_rows(chunk_len);
  // a chunk: k [16 G], v [16 G] where distinct, q, g [rows_t]
  const size_t at_v = v_is_k ? 0 : (size_t)rows_a * cs;
  const size_t at_q = at_v + (size_t)rows_a * cs;
  const size_t at_g = at_q + (size_t)rows_t * cs;

  // the chunks; then g's tiles (dv), then q's (dk)
  auto stage = [&](int it, int buf) {
    T* to = reinterpret_cast<T*>(ring + (size_t)buf * buf_bytes);
    if (it < n1) {
      const int c0 = it * cols, w = min(cols, D - c0);
      stage_zero(to, cs, kb, r0, rows_a, Lk, D, c0, w, cols);
      if (!v_is_k)
        stage_zero(to + at_v, cs, vb, r0, rows_a, Lk, D, c0, w, cols);
      stage_zero(to + at_q, cs, qb, i_begin, rows_t, i_end, D, c0, w, cols);
      stage_zero(to + at_g, cs, gb, i_begin, rows_t, i_end, D, c0, w, cols);
    } else {
      const int r = it - n1, which = r / n_out, rr = r % n_out;
      const int s0 = (rr / tiles) * W, kt = rr % tiles;
      stage_zero(to, us, which == 0 ? gb : qb, i_begin + kt * TR, TR, i_end,
                 D, s0, min(W, D - s0), W);
    }
  };
  ring_start(n_iter, nbuf, stage);
  for (int i = threadIdx.x; i < 8 * nt; i += blockDim.x) {
    const bool ok = i < L;
    const size_t at = (size_t)b * Lq + i_begin + i;
    m_s[i] = ok ? m_in[at] : 0.f;
    l_s[i] = ok ? l_in[at] : 1.f;
    dl_s[i] = ok ? delta_in[at] : 0.f;
  }
  if (threadIdx.x < rows_a)
    kbias_s[threadIdx.x] = r0 + threadIdx.x < Lk
                               ? bias[(size_t)b * Lk + r0 + threadIdx.x] : 0.f;

  // 1: s^T and dp^T
  float st[kNT][4], dpt[kNT][4];
  zero(st);
  zero(dpt);
  for (int it = 0; it < n1; ++it) {
    const int buf = ring_next(it, n_iter, nbuf, stage);
    const T* a_s = reinterpret_cast<const T*>(ring + (size_t)buf * buf_bytes);
    const int subs = (min(cols, D - it * cols) + Op<T>::kChunk - 1)
                     / Op<T>::kChunk;
    const size_t mine = (size_t)kTileM * grp * cs;
    scores_chunk(a_s + mine, a_s + at_q, cs, subs, nt, warp, lane, st);
    scores_chunk(a_s + at_v + mine, a_s + at_g, cs, subs, nt, warp, lane,
                 dpt);
  }

  // 2: p^T and ds^T (rows = the group's keys, columns = the chunk's
  // queries)
  const float* kbias = kbias_s + kTileM * grp;
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int j = warp + 4 * i;
    if (j < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gk + 8 * (e >> 1);
        const int col = 8 * j + 2 * t + (e & 1);
        const bool valid = j0 + row < Lk && col < L;
        const float p =
            valid ? expf(fmaf(st[i][e], scale, kbias[row]) - m_s[col])
                        / l_s[col]
                  : 0.f;
        put_held(pt, ls, row, col, p);
        put_held(dst, ls, row, col, valid ? p * (dpt[i][e] - dl_s[col]) : 0.f);
      }
  }
  zero_held_tail(pt, ls, L, nt, warp, lane);
  zero_held_tail(dst, ls, L, nt, warp, lane);

  // 3: dv = p^T g, then dk = (ds^T q) scale, slice by slice
  const int c0 = warp * 8 * nc;
  const size_t part_off = (size_t)blockIdx.y * B * Lk * D;
  if (reuse) __syncthreads();  // the held p^T, ds^T (no ring barrier comes)
  for (int which = 0; which < 2; ++which) {
    const float rs[2] = {which ? scale : 1.f, which ? scale : 1.f};
    const T* held = which ? dst : pt;
    for (int sl = 0; sl < n_slices; ++sl) {
      float acc[kMaxNC][4];
      zero(acc);
      for (int kt = 0; kt < tiles; ++kt) {
        const T* u = reinterpret_cast<const T*>(ring) + (which ? at_q : at_g)
                     + kt * TR * cs + sl * W;  // the slice's columns
        if (!reuse)
          u = reinterpret_cast<const T*>(
              ring + (size_t)ring_next(n1 + which * n_out + sl * tiles + kt,
                                       n_iter, nbuf, stage) * buf_bytes);
        product_tile(held, ls, kt * TR, min(TR, L - kt * TR), u,
                     reuse ? cs : us, c0, nc, lane, acc);
      }
      const int s0 = sl * W, w = min(W, D - s0);
      if (dk_part != nullptr)
        store_slice((which ? dk_part : dv_part) + part_off + (size_t)b * Lk * D,
                    j0, Lk, D, s0, w, c0, nc, rs, lane, acc);
      else
        store_slice((which ? dk : dv) + (size_t)b * Lk * D, j0, Lk, D, s0, w,
                    c0, nc, rs, lane, acc);
    }
  }
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// a sum as the output holds it: f32 as it is, bf16 rounded once
__device__ __forceinline__ float out_sum(float*, float v) { return v; }
__device__ __forceinline__ float4 out_sum(float4*, float4 v) { return v; }
__device__ __forceinline__ __nv_bfloat16 out_sum(__nv_bfloat16*, float v) {
  return __float2bfloat16(v);
}

// dk, dv [n V each: float4 where B Lk D % 4 == 0, else float; O the
// outputs' element, V itself or bf16 for the bf16 form] = the chunks' f32
// partials added in chunk order, rounded once
template <typename V, typename O>
__global__ void __launch_bounds__(256)
reduce_kernel(const V* __restrict__ dk_part, const V* __restrict__ dv_part,
              O* __restrict__ dk, O* __restrict__ dv, size_t n, int chunks) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n) return;
  const bool is_v = idx >= n;
  const size_t at = is_v ? idx - n : idx;
  const V* src = is_v ? dv_part : dk_part;
  V sum = src[at];
  for (int c = 1; c < chunks; ++c) add_to(sum, src[(size_t)c * n + at]);
  O* dst = is_v ? dv : dk;
  dst[at] = out_sum(dst, sum);
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
// chunks of 4 tiles would be two.) In the sliced form every key tile is
// `slices` blocks; the rows form holds at most max_tiles query tiles a
// chunk.
Chunks query_chunks(int B, int Lq, int Lk, int slices, int max_tiles) {
  const int q_tiles = (Lq + kTileN - 1) / kTileN;
  const long key_blocks = (long)((Lk + kTileM - 1) / kTileM) * B * slices;
  Chunks best = {0, 0};
  long best_cost = -1;
  for (int want = 1; want <= q_tiles; ++want) {
    const int per_chunk = (q_tiles + want - 1) / want;
    if (per_chunk > max_tiles) continue;
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

// the dkv kernels' query chunks in a form: the rows form holds a chunk's
// every query (at most 256)
Chunks form_chunks(int form, int B, int Lq, int Lk, int D) {
  if (form >= kFormRows)
    return query_chunks(B, Lq, Lk, 1, rows::kMaxL / kTileN);
  return query_chunks(B, Lq, Lk, form == kFormSliced ? slices_of(D) : 1,
                      1 << 30);
}

// m, l and delta of every query row, rounded up so that what follows them
// in the scratch stays 16-byte aligned
size_t stat_floats(size_t rows) { return (3 * rows + 3) / 4 * 4; }

size_t scratch_floats(int form, int B, int Lq, int Lk, int D) {
  const Chunks c = form_chunks(form, B, Lq, Lk, D);
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
    reduce_kernel<float4, float4>
        <<<(unsigned)((2 * n4 + 255) / 256), 256, 0, st>>>(
        reinterpret_cast<const float4*>(partials),
        reinterpret_cast<const float4*>(partials + chunks.count * n),
        reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv), n4,
        chunks.count);
  } else {
    reduce_kernel<float, float>
        <<<(unsigned)((2 * n + 255) / 256), 256, 0, st>>>(
            partials, partials + chunks.count * n, dk, dv, n, chunks.count);
  }
  return cudaGetLastError();
}

cudaError_t reduce_chunks(const Chunks& chunks, const float* partials,
                          __nv_bfloat16* dk, __nv_bfloat16* dv, size_t n,
                          cudaStream_t st) {
  if (chunks.count == 1) return cudaSuccess;
  reduce_kernel<float, __nv_bfloat16>
      <<<(unsigned)((2 * n + 255) / 256), 256, 0, st>>>(
          partials, partials + chunks.count * n, dk, dv, n, chunks.count);
  return cudaGetLastError();
}

template <typename T, int NC, bool kFull>
cudaError_t launch_t(const T* q, const T* k, const T* v, const float* bias,
                     const float* o, const T* g, T* dq, T* dk, T* dv,
                     const float* stats_in, float* scratch, int B, int Lq,
                     int Lk, int D, float scale, cudaStream_t st) {
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
    if ((err = allow_smem(stats_kernel<T, NC, kFull>, smem)) != cudaSuccess)
      return err;
    stats_kernel<T, NC, kFull><<<q_grid, kThreads, smem, st>>>(
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
    if ((err = allow_smem(dq_kernel<T, NC, kFull>, smem)) != cudaSuccess)
      return err;
    dq_kernel<T, NC, kFull><<<q_grid, kThreads, smem, st>>>(
        q, k, v, bias, o, g, m, l, dq, delta, Lq, Lk, D, scale, nbuf);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const Chunks chunks = form_chunks(kFormOnline, B, Lq, Lk, D);
  if (chunks.count > 65535) return cudaErrorInvalidValue;
  const size_t fixed = (kv * kTileM * S + 2 * kPartFloats + 2 * kProbFloats
                        + 3 * kTileN + kTileM) * F;
  const size_t tile = 2 * kTileN * S * F;
  const int nbuf = pick_buffers(fixed, tile);
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + nbuf * tile;
  if ((err = allow_smem(dkv_kernel<T, NC, kFull>, smem)) != cudaSuccess)
    return err;
  const bool direct = chunks.count == 1;
  const size_t n = (size_t)B * Lk * D;
  const dim3 grid((Lk + kTileM - 1) / kTileM, chunks.count, B);
  dkv_kernel<T, NC, kFull><<<grid, kThreads, smem, st>>>(
      q, k, v, bias, g, m, l, delta, dk, dv, direct ? nullptr : partials,
      direct ? nullptr : partials + chunks.count * n, B, Lq, Lk, D,
      chunks.len, scale, nbuf);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_chunks(chunks, partials, dk, dv, n, st);
}

template <typename T, int NC>
cudaError_t launch(const T* q, const T* k, const T* v, const float* bias,
                   const float* o, const T* g, T* dq, T* dk, T* dv,
                   const float* stats_in, float* scratch, int B, int Lq,
                   int Lk, int D, float scale, cudaStream_t st) {
  if (D == 32 * NC)
    return launch_t<T, NC, true>(q, k, v, bias, o, g, dq, dk, dv, stats_in,
                                 scratch, B, Lq, Lk, D, scale, st);
  return launch_t<T, NC, false>(q, k, v, bias, o, g, dq, dk, dv, stats_in,
                                scratch, B, Lq, Lk, D, scale, st);
}

// the online form: D <= 512 (f32; bf16 with few keys)
template <typename T>
cudaError_t launch_online(const T* q, const T* k, const T* v,
                          const float* bias, const float* o, const T* g,
                          T* dq, T* dk, T* dv, const float* stats_in,
                          float* scratch, int B, int Lq, int Lk, int D,
                          float scale, cudaStream_t st) {
  // f32: delta = rowsum(g o)
  if (sizeof(T) == 4 && o == nullptr) return cudaErrorInvalidValue;
  switch ((D + 31) / 32) {
#define DOSTPU_CASE(nc)                                                       \
  case nc:                                                                    \
    return launch<T, nc>(q, k, v, bias, o, g, dq, dk, dv, stats_in, scratch, \
                         B, Lq, Lk, D, scale, st);
    DOSTPU_CASE(1) DOSTPU_CASE(2) DOSTPU_CASE(3) DOSTPU_CASE(4)
    DOSTPU_CASE(5) DOSTPU_CASE(6) DOSTPU_CASE(7) DOSTPU_CASE(8)
    DOSTPU_CASE(9) DOSTPU_CASE(10) DOSTPU_CASE(11) DOSTPU_CASE(12)
    DOSTPU_CASE(13) DOSTPU_CASE(14) DOSTPU_CASE(15) DOSTPU_CASE(16)
#undef DOSTPU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// the sliced kernels: any D, past the rows form's keys
template <typename T>
cudaError_t launch_sliced(const T* q, const T* k, const T* v,
                          const float* bias, const float* o, const T* g,
                          T* dq, T* dk, T* dv, const float* stats_in,
                          float* scratch, int B, int Lq, int Lk, int D,
                          float scale, cudaStream_t st) {
  constexpr int NC = kSliceMaxNC;
  constexpr size_t S = 32 * NC + kPad;
  constexpr size_t F = sizeof(float);
  const size_t rows = (size_t)B * Lq;
  const int kv = v == k ? 1 : 2;
  const int slices = slices_of(D);
  if (slices > 65535) return cudaErrorInvalidValue;
  if (sizeof(T) == 4 && o == nullptr) return cudaErrorInvalidValue;
  cudaError_t err;

  float* delta = scratch + 2 * rows;
  float* partials = scratch + stat_floats(rows);
  const float* m = stats_in;
  const float* l = stats_in == nullptr ? nullptr : stats_in + rows;
  if (stats_in == nullptr) {
    const size_t smem = ((kTileM + kTileN) * S + kPartFloats) * F;
    if ((err = allow_smem(stats_sliced_kernel<T, NC>, smem)) != cudaSuccess)
      return err;
    stats_sliced_kernel<T, NC>
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
    if ((err = allow_smem(dq_sliced_kernel<T, NC>, smem)) != cudaSuccess)
      return err;
    dq_sliced_kernel<T, NC>
        <<<dim3((Lq + kTileM - 1) / kTileM, B, slices), kThreads, smem, st>>>(
            q, k, v, bias, o, g, m, l, dq, delta, Lq, Lk, D, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const Chunks chunks = form_chunks(kFormSliced, B, Lq, Lk, D);
  if (chunks.count > 65535) return cudaErrorInvalidValue;
  const size_t smem = ((kv * kTileM + 2 * kTileN) * S + 2 * kPartFloats
                       + 2 * kProbFloats + 3 * kTileN + kTileM) * F;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if ((err = allow_smem(dkv_sliced_kernel<T, NC>, smem)) != cudaSuccess)
    return err;
  const bool direct = chunks.count == 1;
  const size_t n = (size_t)B * Lk * D;
  const long key_blocks = (long)((Lk + kTileM - 1) / kTileM) * slices;
  if (key_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  dkv_sliced_kernel<T, NC>
      <<<dim3((unsigned)key_blocks, chunks.count, B), kThreads, smem, st>>>(
          q, k, v, bias, g, m, l, delta, dk, dv, direct ? nullptr : partials,
          direct ? nullptr : partials + chunks.count * n, B, Lq, Lk, D,
          chunks.len, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_chunks(chunks, partials, dk, dv, n, st);
}

// the rows form: Lk <= 256 (f32 slices always 512 columns, as the
// forward's); `groups` 16-row groups a block, 0 for the rule's
template <typename T>
cudaError_t launch_rows(const T* q, const T* k, const T* v,
                        const float* bias, const T* g, T* dq, T* dk, T* dv,
                        const float* stats_in, float* scratch, int B, int Lq,
                        int Lk, int D, float scale, int groups,
                        cudaStream_t st) {
  using namespace rows;
  constexpr size_t F = sizeof(float);
  if (Lk > kMaxL || groups < 0 || groups > kMaxGroups)
    return cudaErrorInvalidValue;
  const size_t n_rows = (size_t)B * Lq;
  const int kv = v == k ? 1 : 2;
  const int nc = sizeof(T) == 4 ? kMaxNC : slice_groups(D);
  cudaError_t err;

  // scratch: m, l (written by dq_rows_kernel when the caller brings none),
  // delta, dk/dv partials
  float* m = scratch;
  float* l = scratch + n_rows;
  float* delta = scratch + 2 * n_rows;
  float* partials = scratch + stat_floats(n_rows);
  {
    const int gr = groups ? groups : row_groups(B, Lq, Lk, 128);
    const int rows_a = kTileM * gr;
    const dim3 grid((Lq + rows_a - 1) / rows_a, B);
    const int staged = 2 * kTileM * gr + kv * staged_rows(Lk);
    const int cols = chunk_cols<T>(D, staged, chunk_budget<T>(grid));
    const int tr = tile_rows<T>(grid);
    const bool reuse = reuses_chunk(D, cols, nc);
    const size_t buf = reuse ? chunk_bytes<T>(staged, cols)
                             : std::max(chunk_bytes<T>(staged, cols),
                                        tile_bytes<T>(nc, tr));
    const size_t fixed = gr * held_bytes<T>(Lk)
                         + (kMaxGroups * (kWarps + 3) * kTileM + kMaxL) * F;
    const int nbuf = reuse ? (fixed + buf <= kSmemMax)
                           : ring_buffers(fixed, buf, resident(grid));
    if (nbuf == 0) return cudaErrorInvalidValue;
    const size_t smem = fixed + nbuf * buf;
    if ((err = allow_smem(dq_rows_kernel<T>, smem)) != cudaSuccess)
      return err;
    dq_rows_kernel<T><<<grid, kThreads * gr, smem, st>>>(
            q, k, v, bias, g, stats_in,
            stats_in == nullptr ? nullptr : stats_in + n_rows, dq, m, l,
            delta, Lq, Lk, D, nc, cols, gr, tr, scale, nbuf, (int)buf);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const float* m_use = stats_in == nullptr ? m : stats_in;
  const float* l_use = stats_in == nullptr ? l : stats_in + n_rows;
  const Chunks chunks = form_chunks(kFormRows, B, Lq, Lk, D);
  if (chunks.count > 65535) return cudaErrorInvalidValue;
  const int L = chunks.len;
  const int gr = groups ? groups : row_groups(B, Lk, L, 128);
  const int rows_a = kTileM * gr;
  const dim3 grid((Lk + rows_a - 1) / rows_a, chunks.count, B);
  const int staged = kv * kTileM * gr + 2 * staged_rows(L);
  const int cols = chunk_cols<T>(D, staged, chunk_budget<T>(grid));
  const int tr = tile_rows<T>(grid);
  const bool reuse = reuses_chunk(D, cols, nc);
  const size_t buf = reuse ? chunk_bytes<T>(staged, cols)
                           : std::max(chunk_bytes<T>(staged, cols),
                                      tile_bytes<T>(nc, tr));
  const size_t fixed = 2 * gr * held_bytes<T>(L)
                       + (3 * kMaxL + kMaxGroups * kTileM) * F;
  const int nbuf = reuse ? (fixed + buf <= kSmemMax)
                         : ring_buffers(fixed, buf, resident(grid));
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + nbuf * buf;
  if ((err = allow_smem(dkv_rows_kernel<T>, smem)) != cudaSuccess) return err;
  const bool direct = chunks.count == 1;
  const size_t n = (size_t)B * Lk * D;
  dkv_rows_kernel<T><<<grid, kThreads * gr, smem, st>>>(
      q, k, v, bias, g, m_use, l_use, delta, dk, dv,
      direct ? nullptr : partials,
      direct ? nullptr : partials + chunks.count * n, B, Lq, Lk, D, nc, cols,
      gr, L, tr, scale, nbuf, (int)buf);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_chunks(chunks, partials, dk, dv, n, st);
}

template <typename T>
int dispatch(const void* q_, const void* k_, const void* v_,
             const float* bias, const float* o, const void* g_, void* dq_,
             void* dk_, void* dv_, const float* stats_in, float* scratch,
             int B, int Lq, int Lk, int D, float scale, int form,
             cudaStream_t st) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* g = static_cast<const T*>(g_);
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  if (form >= kFormRows)  // kFormRows + g: g row groups forced
    return launch_rows<T>(q, k, v, bias, g, dq, dk, dv, stats_in, scratch, B,
                          Lq, Lk, D, scale, form - kFormRows, st);
  if (form == kFormSliced)
    return launch_sliced<T>(q, k, v, bias, o, g, dq, dk, dv, stats_in,
                            scratch, B, Lq, Lk, D, scale, st);
  if (form == kFormOnline)
    return launch_online<T>(q, k, v, bias, o, g, dq, dk, dv, stats_in,
                            scratch, B, Lq, Lk, D, scale, st);
  return cudaErrorInvalidValue;
}

// the form of a call (-1: the plan's); the rows form's row-group codes
// (kFormRows + g) take its scratch
int form_or_plan(int form, int D, int Lk, int bf16) {
  return form < 0 ? rows::form_of(D, Lk, bf16 != 0) : form;
}

}  // namespace

// floats of scratch dostpu_attention_bwd needs at this shape, operand type
// (bf16 non-zero: bfloat16) and form (-1: the plan's)
extern "C" size_t dostpu_attention_bwd_scratch_floats(int B, int Lq, int Lk,
                                                      int D, int bf16,
                                                      int form) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || D <= 0) return 0;
  return scratch_floats(form_or_plan(form, D, Lk, bf16), B, Lq, Lk, D);
}

// All pointers are device pointers into contiguous, 16-byte aligned
// tensors: q/o/g [B, Lq, D], k/v [B, Lk, D] (v may be k itself) and the
// outputs dq [B, Lq, D], dk/dv [B, Lk, D]: q, k, v, g, dq, dk and dv float32,
// or bfloat16 when `bf16` is non-zero; o (read by the f32 online and sliced
// forms only, may be null otherwise), bias [B, Lk], stats_in (the forward's
// [2, B, Lq]: row max, then row sum, or null) and scratch
// (dostpu_attention_bwd_scratch_floats(B, Lq, Lk, D, bf16, form) floats)
// float32 in both forms. Any D >= 1. `form` as dostpu_attention_fwd's (-1:
// the plan's; 2 + g: the rows form with g 16-row groups a block). Returns
// the CUDA error code of the launches.
extern "C" int dostpu_attention_bwd(const void* q, const void* k,
                                    const void* v, const float* bias,
                                    const float* o, const void* g, void* dq,
                                    void* dk, void* dv,
                                    const float* stats_in, float* scratch,
                                    int B, int Lq, int Lk, int D, float scale,
                                    int bf16, int form, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D <= 0
      || form > attn::kFormRows + attn::rows::kMaxGroups)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  form = form_or_plan(form, D, Lk, bf16);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, bias, o, g, dq, dk, dv, stats_in,
                                   scratch, B, Lq, Lk, D, scale, form, st);
  return dispatch<float>(q, k, v, bias, o, g, dq, dk, dv, stats_in, scratch,
                         B, Lq, Lk, D, scale, form, st);
}
