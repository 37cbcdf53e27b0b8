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

#include "attention_core.cuh"

namespace {

using namespace attn;

constexpr int kResidentBlocks = 264;  // two on each of an H100's 132 SMs

// rows of m and l for a caller without the forward's: the forward's loop
// without p v
template <int NC>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ bias, float* __restrict__ m_out,
             float* __restrict__ l_out, int Lq, int Lk, float scale,
             int nbuf) {
  constexpr int D = 32 * NC;
  constexpr int S = D + kPad;
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
    stage_rows_async<D>(k_s + buf * tile_floats, kb, tile * kTileN, kTileN,
                        Lk);
  };
  stage_rows_async<D>(q_s, q + (size_t)b * Lq * D, q0, kTileM, Lq);
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

// one element of p and of ds from its summed score s and dp: what dq_kernel
// and dkv_kernel share. bj is the key's bias; m, inv_l and delta are the
// query's row max, 1 / row sum and rowsum(g * o).
__device__ __forceinline__ void p_and_ds(float s, float dp, bool valid,
                                         float scale, float bj, float m,
                                         float inv_l, float delta, float& p,
                                         float& ds) {
  p = valid ? expf(fmaf(s, scale, bj) - m) * inv_l : 0.f;
  ds = valid ? p * (dp - delta) : 0.f;
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ bias,
          const float* __restrict__ o, const float* __restrict__ g,
          const float* __restrict__ m_in, const float* __restrict__ l_in,
          float* __restrict__ dq, float* __restrict__ delta_out, int Lq,
          int Lk, float scale, int nbuf) {
  constexpr int D = 32 * NC;
  constexpr int S = D + kPad;
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
    stage_rows_async<D>(dst, kb, tile * kTileN, kTileN, Lk);
    if (!v_is_k) stage_rows_async<D>(dst + kTileN * S, vb, tile * kTileN,
                                     kTileN, Lk);
  };
  stage_rows_async<D>(q_s, q + (size_t)b * Lq * D, q0, kTileM, Lq);
  stage_rows_async<D>(g_s, g + (size_t)b * Lq * D, q0, kTileM, Lq);
  stage(0, 0);
  cp_async_commit();

  // delta = rowsum(g * o), and the rows' statistics, while the copies fly
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
      if (i < Lq) delta_out[at] = s;
    }
  }

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
    {
      const bool valid = k0 + lane < Lk;
      const float bj = valid ? bias_b[k0 + lane] : 0.f;
      const int pos = prob_pos(lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * warp + r;
        float p, ds;
        p_and_ds(sum_partials(s_parts, row, lane),
                 sum_partials(dp_parts, row, lane), valid, scale, bj,
                 m_s[row], il_s[row], dl_s[row], p, ds);
        ds_s[row * kProbStride + pos] = ds;
      }
    }
    __syncthreads();
    prob_times_rows<NC>(ds_s, k_s, S, c0, (nk + 15) / 16, lane, acc);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gq + 8 * half;
    if (q0 + row >= Lq) continue;
    float* at = dq + ((size_t)b * Lq + q0 + row) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float2*>(at + 8 * n) = make_float2(
          acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

// grid (key tiles of 16, query chunks, B); chunk_len is a multiple of 32.
// dk_out / dv_out are [chunks][B][Lk][D] (the outputs themselves when there
// is one chunk).
template <int NC>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
           const float* __restrict__ g, const float* __restrict__ m_in,
           const float* __restrict__ l_in, const float* __restrict__ delta_in,
           float* __restrict__ dk_out, float* __restrict__ dv_out, int B,
           int Lq, int Lk, int chunk_len, float scale, int nbuf) {
  constexpr int D = 32 * NC;
  constexpr int S = D + kPad;
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
    stage_rows_async<D>(dst, qb, i_begin + tile * kTileN, kTileN, Lq);
    stage_rows_async<D>(dst + kTileN * S, gb, i_begin + tile * kTileN, kTileN,
                        Lq);
  };
  stage_rows_async<D>(k_s, k + (size_t)b * Lk * D, j0, kTileM, Lk);
  if (!v_is_k) stage_rows_async<D>(v_s, v + (size_t)b * Lk * D, j0, kTileM, Lk);
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
    if (threadIdx.x < kTileN) {  // read again only after the next barrier
      const int i = i0 + threadIdx.x;
      const bool ok = i < i_end;
      const size_t at = (size_t)b * Lq + i;
      m_s[threadIdx.x] = ok ? m_in[at] : 0.f;
      il_s[threadIdx.x] = ok ? 1.f / l_in[at] : 0.f;
      dl_s[threadIdx.x] = ok ? delta_in[at] : 0.f;
    }
    // rows = the block's keys, columns = the tile's queries
    partial_tile<NC>(k_s, q_s, S, (nq + 15) / 16, warp, lane, s_parts);
    partial_tile<NC>(v_s, g_s, S, (nq + 15) / 16, warp, lane, dp_parts);
    __syncthreads();
    {
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
    __syncthreads();
    prob_times_rows<NC>(pt_s, g_s, S, c0, (nq + 15) / 16, lane, acc_v);
    prob_times_rows<NC>(dst_s, q_s, S, c0, (nq + 15) / 16, lane, acc_k);
  }

  const size_t chunk_off = (size_t)blockIdx.y * B * Lk * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = gk + 8 * half;
    if (j0 + row >= Lk) continue;
    const size_t at =
        chunk_off + ((size_t)b * Lk + j0 + row) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      *reinterpret_cast<float2*>(dk_out + at + 8 * n) = make_float2(
          acc_k[n][2 * half] * scale, acc_k[n][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(dv_out + at + 8 * n) =
          make_float2(acc_v[n][2 * half], acc_v[n][2 * half + 1]);
    }
  }
}

// dk, dv [n4 float4s each] = the chunks' partials added in chunk order
__global__ void __launch_bounds__(256)
reduce_kernel(const float4* __restrict__ dk_part,
              const float4* __restrict__ dv_part, float4* __restrict__ dk,
              float4* __restrict__ dv, size_t n4, int chunks) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n4) return;
  const bool is_v = idx >= n4;
  const size_t at = is_v ? idx - n4 : idx;
  const float4* src = is_v ? dv_part : dk_part;
  float4 sum = src[at];
  for (int c = 1; c < chunks; ++c) {
    const float4 x = src[(size_t)c * n4 + at];
    sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
  }
  (is_v ? dv : dk)[at] = sum;
}

struct Chunks {
  int count;  // query chunks of dkv_kernel
  int len;    // queries per chunk, a multiple of 32
};

// The number of query chunks that finishes dkv_kernel soonest: waves of
// kResidentBlocks blocks times the tiles a block walks, plus, where chunks
// must be added up, reduce_kernel's launch and its reads. A function of the
// shape alone, so the order of every sum is too. (At the flagship
// self-attention one chunk wins: 208 blocks of 7 tiles are one wave, and two
// chunks of 4 tiles would be two.)
Chunks query_chunks(int B, int Lq, int Lk) {
  const int q_tiles = (Lq + kTileN - 1) / kTileN;
  const long key_blocks = (long)((Lk + kTileM - 1) / kTileM) * B;
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

// m, l and delta of every query row, rounded up so that what follows them
// in the scratch stays 16-byte aligned
size_t stat_floats(size_t rows) { return (3 * rows + 3) / 4 * 4; }

size_t scratch_floats(int B, int Lq, int Lk, int D) {
  const Chunks c = query_chunks(B, Lq, Lk);
  const size_t partials =
      c.count > 1 ? (size_t)2 * c.count * B * Lk * D : 0;
  return stat_floats((size_t)B * Lq) + partials;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const float* o, const float* g,
                   float* dq, float* dk, float* dv, const float* stats_in,
                   float* scratch, int B, int Lq, int Lk, float scale,
                   cudaStream_t st) {
  constexpr int D = 32 * NC;
  constexpr size_t S = D + kPad;
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
    if ((err = allow_smem(stats_kernel<NC>, smem)) != cudaSuccess) return err;
    stats_kernel<NC><<<q_grid, kThreads, smem, st>>>(
        q, k, bias, scratch, scratch + rows, Lq, Lk, scale, nbuf);
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
    if ((err = allow_smem(dq_kernel<NC>, smem)) != cudaSuccess) return err;
    dq_kernel<NC><<<q_grid, kThreads, smem, st>>>(
        q, k, v, bias, o, g, m, l, dq, delta, Lq, Lk, scale, nbuf);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const Chunks chunks = query_chunks(B, Lq, Lk);
  if (chunks.count > 65535) return cudaErrorInvalidValue;
  {
    const size_t fixed = (kv * kTileM * S + 2 * kPartFloats + 2 * kProbFloats
                          + 3 * kTileN + kTileM) * F;
    const size_t tile = 2 * kTileN * S * F;
    const int nbuf = pick_buffers(fixed, tile);
    if (nbuf == 0) return cudaErrorInvalidValue;
    const size_t smem = fixed + nbuf * tile;
    if ((err = allow_smem(dkv_kernel<NC>, smem)) != cudaSuccess) return err;
    const bool direct = chunks.count == 1;
    const size_t n = (size_t)B * Lk * D;
    const dim3 grid((Lk + kTileM - 1) / kTileM, chunks.count, B);
    dkv_kernel<NC><<<grid, kThreads, smem, st>>>(
        q, k, v, bias, g, m, l, delta, direct ? dk : partials,
        direct ? dv : partials + chunks.count * n, B, Lq, Lk, chunks.len,
        scale, nbuf);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (!direct) {
      const size_t n4 = n / 4;
      reduce_kernel<<<(unsigned)((2 * n4 + 255) / 256), 256, 0, st>>>(
          reinterpret_cast<const float4*>(partials),
          reinterpret_cast<const float4*>(partials + chunks.count * n),
          reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv), n4,
          chunks.count);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
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
// dostpu_attention_bwd_scratch_floats(B, Lq, Lk, D) floats. D must be a
// multiple of 32 and at most dostpu_attention_max_dim(). Returns the CUDA
// error code of the launches.
extern "C" int dostpu_attention_bwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    const float* o, const float* g, float* dq,
                                    float* dk, float* dv,
                                    const float* stats_in, float* scratch,
                                    int B, int Lq, int Lk, int D, float scale,
                                    void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D % 32 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / 32) {
#define DOSTPU_CASE(nc)                                                      \
  case nc:                                                                   \
    return launch<nc>(q, k, v, bias, o, g, dq, dk, dv, stats_in, scratch, B, \
                      Lq, Lk, scale, st);
    DOSTPU_CASE(1) DOSTPU_CASE(2) DOSTPU_CASE(3) DOSTPU_CASE(4)
    DOSTPU_CASE(5) DOSTPU_CASE(6) DOSTPU_CASE(7) DOSTPU_CASE(8)
    DOSTPU_CASE(9) DOSTPU_CASE(10) DOSTPU_CASE(11) DOSTPU_CASE(12)
    DOSTPU_CASE(13) DOSTPU_CASE(14) DOSTPU_CASE(15) DOSTPU_CASE(16)
#undef DOSTPU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
