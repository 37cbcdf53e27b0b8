// Projection-free attention forward, float32 or bfloat16 operands, for
// sm_90a.
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
// Three forms, chosen by the shape rule of attention_rows.cuh (form_of,
// mirrored by dostpu_attention_plan below and ops/attention.py
// attention_plan), each block 4 warps owning 16 query rows; every product
// on the tensor cores; a row whose keys are all masked sees every score at
// exactly -1e30 (the bias is added in f32 after the product) and averages V
// uniformly, as the plain version does, never NaN (m and l are kept apart,
// not as one log-sum-exp: -1e30 + log(Lk) rounds back to -1e30):
//   * online (D <= 512: f32, and bf16 over at most 32 keys;
//     attn_fwd_kernel): keys stream
//     through shared memory in tiles of 32 with an online softmax; both
//     products 3xTF32 mma.sync (f32 accuracy). bf16 tiles are staged raw and
//     widened to f32 in place, each product one exact TF32 pass, and the
//     keys walked twice (the first pass for the rows' max and sum, so that
//     p is normalised before its rounding to bf16). For q k^T the warps split the
//     staged width four ways, each reusing its Q fragment over the tile's
//     four n8 key sub-tiles, and leave partial score tiles in shared memory;
//     for the softmax each warp takes 4 rows (lane = key) and adds the
//     partials in a fixed order; for p v each warp owns a quarter of the
//     output columns. Rows are staged at NC = ceil(D / 32) times 32 columns,
//     zeros past D; K/V tiles arrive by cp.async, double-buffered while two
//     blocks still fit an SM, and are staged once when v is k (the
//     transformer layer always passes it so). The half of a key tile wholly
//     past Lk is skipped.
//   * rows (Lk <= 256: bf16 at every D but the online form's calls, f32
//     above D = 512 from 96 keys; attn_fwd_rows_kernel on
//     attention_rows.cuh): a block of one or two 16-row groups forms its
//     rows' scores ONCE over the full D (q and k chunks streamed in column
//     order, the scores held in registers), takes the exact row max and
//     sum, keeps p in shared memory (bf16: normalised and rounded to bf16
//     where the TPU kernel rounds it, so one pass over the keys suffices)
//     and walks v slice by slice of output columns (from the staged k rows
//     themselves where one chunk held the whole row and v is k). bf16
//     operands run on the bf16 tensor cores (mma.m16n8k16, f32
//     accumulators) from tiles staged raw; f32 ones 3xTF32. (The sliced
//     form forms the scores once per 512-column slice: twice at D =
//     1,024.)
//   * sliced (D > 512 with keys the rows form does not take;
//     attn_fwd_sliced_kernel): one block per (16 query rows, batch element,
//     slice of 512 output columns); for each key tile the block streams the
//     chunks of q and k through one staged tile each, its own slice last,
//     with an online softmax (bf16: two passes over the keys, tiles widened
//     in place, single-pass exact TF32 products). Every shape has a form.

#include "attention_rows.cuh"

namespace {

using namespace attn;

// The online form (D <= 512). Rows staged at W = 32 * NC >= D columns;
// kFull: D == W, known at compile time (the runtime width cost the full
// widths time). Shared memory: q_s [16][W+4],
// n_buf tiles of 32 keys [32][W+4] (K, then V when it is another tensor),
// the partial score tiles, the permuted p tile, and 16 rescale factors /
// row sums. T: float (3xTF32 products) or bf16 (staged raw, widened in
// place, single-pass products).
template <typename T, int NC, bool kFull>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ out, float* __restrict__ stats, int B,
                int Lq, int Lk, int D_, float scale, int nbuf) {
  constexpr int S = 32 * NC + kPad;
  constexpr bool kSplit = sizeof(T) == 4;  // f32 operands: 3xTF32
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
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
  const float* bias_b = bias + (size_t)b * Lk;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;

  // iteration it stages key tile it % n_tiles; v only where it is used
  auto stage = [&](int it, int buf) {
    float* dst = kv_s + buf * tile_floats;
    const int r0 = (it % n_tiles) * kTileN;
    stage_rows<T, NC>(dst, kb, r0, kTileN, Lk, D, 0, D);
    if (!v_is_k && (kSplit || it >= n_tiles))
      stage_rows<T, NC>(dst + kTileN * S, vb, r0, kTileN, Lk, D, 0, D);
  };
  stage_rows<T, NC>(q_s, q + (size_t)b * Lq * D, q0, kTileM, Lq, D, 0, D);
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

  // f32: one pass, the online softmax; bf16: the key tiles twice, the
  // first pass for the rows' max and sum only (v is not staged)
  const int n_iter = (kSplit ? 1 : 2) * n_tiles;
  for (int it = 0; it < n_iter; ++it) {
    const int buf = ring_acquire(it, n_iter, nbuf, stage);
    float* k_s = kv_s + buf * tile_floats;
    float* v_s = v_is_k ? k_s : k_s + kTileN * S;
    const bool second = it >= n_tiles;  // bf16 only
    const int k0 = (it % n_tiles) * kTileN;
    const int nk = min(kTileN, Lk - k0);
    const int halves = (nk + 15) / 16;

    if constexpr (kSplit) {
      partial_tile<NC>(q_s, k_s, S, halves, warp, lane, parts);
      __syncthreads();
      softmax_tile<true>(parts, bias_b, k0, Lk, scale, warp, lane, m_run,
                         l_run, p_s, corr_s);
      __syncthreads();
      const float c_lo = corr_s[g], c_hi = corr_s[g + 8];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        o[n][0] *= c_lo; o[n][1] *= c_lo; o[n][2] *= c_hi; o[n][3] *= c_hi;
      }
      prob_times_rows<NC>(p_s, v_s, S, c0, halves, lane, o);
    } else {
      // the tile has landed raw: widen it (and, once, the query rows)
      if (it == 0)
        widen_rows<NC>(q_s, kTileM, min(kTileM, Lq - q0), D, warp, lane);
      widen_rows<NC>(k_s, 16 * halves, nk, D, warp, lane);
      if (second && !v_is_k)
        widen_rows<NC>(v_s, 16 * halves, nk, D, warp, lane);
      __syncthreads();
      partial_tile_exact<NC>(q_s, k_s, S, halves, warp, lane, parts);
      __syncthreads();
      if (!second) {
        softmax_tile<false>(parts, bias_b, k0, Lk, scale, warp, lane, m_run,
                            l_run, p_s, corr_s);
        continue;
      }
      normalised_bf16_probs(parts, bias_b, k0, Lk, scale, warp, lane, m_run,
                            l_run, p_s);
      __syncthreads();
      prob_times_rows_exact<NC>(p_s, v_s, S, c0, halves, lane, o);
    }
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
    // bf16: the weights were normalised before the product
    const float inv = kSplit ? 1.f / l_s[row] : 1.f;
    T* at = out + ((size_t)b * Lq + q0 + row) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store_pair_t(at, c0 + 8 * n + 2 * t, D, D, o[n][2 * half] * inv,
                   o[n][2 * half + 1] * inv);
  }
}

// The rows form (attention_rows.cuh): grid (query tiles of 16 G, B), G =
// `groups` 16-row groups of 4 warps. Shared memory: each group's held p
// [16][Lk] (bf16: normalised and rounded; f32: exp(s - m), divided by l at
// the store), each group's reduction scratch and rows' max and sum, the
// bias row, then nbuf ring buffers of buf_bytes: q's chunk of every group's
// rows and k's of every key, `cols` columns wide, in phase 1; a tile of v's
// rows in phase 3.
template <typename T>
__global__ void __launch_bounds__(rows::kMaxThreads, 1)
attn_fwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, float* __restrict__ stats, int B,
                     int Lq, int Lk, int D, int nc, int cols, int groups,
                     int tr, float scale, int nbuf, int buf_bytes) {
  using namespace rows;
  const int TR = tr;  // rows of a phase-3 tile
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) float smem_f[];  // one type a file
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const int grp = threadIdx.x / kThreads;  // the thread's 16-row group
  const int warp = threadIdx.x % kThreads / 32;  // within the group
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  T* held = reinterpret_cast<T*>(smem + grp * held_bytes<T>(Lk));
  float* red = reinterpret_cast<float*>(smem + groups * held_bytes<T>(Lk));
  float* m_s = red + kMaxGroups * kWarps * kTileM;  // [groups][16]
  float* l_s = m_s + kMaxGroups * kTileM;           // [groups][16]
  float* bias_s = l_s + kMaxGroups * kTileM;        // [kMaxL]
  unsigned char* ring = reinterpret_cast<unsigned char*>(bias_s + kMaxL);
  red += grp * kWarps * kTileM;
  m_s += grp * kTileM;
  l_s += grp * kTileM;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTileM * groups;  // the block's first row
  const int q0 = r0 + kTileM * grp;              // the group's
  const T* qb = q + (size_t)b * Lq * D;
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
  const int ls = held_stride(Lk);
  const int nt = tiles8(Lk);
  const int cs = cols + Op<T>::kPad;  // a staged chunk row
  const int us = tile_stride<T>(nc);
  const int W = 32 * nc;
  const int n1 = (D + cols - 1) / cols;    // score chunks
  const int tiles = (Lk + TR - 1) / TR;    // v tiles a slice
  const int n_slices = (D + W - 1) / W;
  // one chunk of the whole row, v = k: p v reads the staged k rows
  const bool reuse = reuses_chunk(D, cols, nc) && v == k;
  const int n_iter = n1 + (reuse ? 0 : n_slices * tiles);
  const int rows_a = kTileM * groups;

  // iteration it stages score chunk it, then the v tiles slice by slice
  auto stage = [&](int it, int buf) {
    T* dst = reinterpret_cast<T*>(ring + (size_t)buf * buf_bytes);
    if (it < n1) {
      const int c0 = it * cols, w = min(cols, D - c0);
      stage_zero(dst, cs, qb, r0, rows_a, Lq, D, c0, w, cols);
      stage_zero(dst + rows_a * cs, cs, kb, 0, staged_rows(Lk), Lk, D, c0, w,
                 cols);
    } else {
      const int r = it - n1, s0 = (r / tiles) * W, kt = r % tiles;
      stage_zero(dst, us, vb, kt * TR, TR, Lk, D, s0, min(W, D - s0), W);
    }
  };
  ring_start(n_iter, nbuf, stage);
  for (int i = threadIdx.x; i < Lk; i += blockDim.x)
    bias_s[i] = bias[(size_t)b * Lk + i];

  // 1: the scores, once over the full D
  float s[kNT][4];
  zero(s);
  for (int it = 0; it < n1; ++it) {
    const int buf = ring_next(it, n_iter, nbuf, stage);
    const T* a_s = reinterpret_cast<const T*>(ring + (size_t)buf * buf_bytes);
    const int subs = (min(cols, D - it * cols) + Op<T>::kChunk - 1)
                     / Op<T>::kChunk;
    scores_chunk(a_s + kTileM * grp * cs, a_s + rows_a * cs, cs, subs, nt,
                 warp, lane, s);
  }

  // 2: the exact softmax of the held rows, p into shared memory
  bias_scores(s, nt, Lk, bias_s, scale, warp, lane);
  softmax_rows(s, nt, warp, lane, red, m_s, l_s);
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int j = warp + 4 * i;
    if (j < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1);
        // bf16: normalised, then rounded, where the TPU kernel rounds
        put_held(held, ls, row, 8 * j + 2 * t + (e & 1),
                 kF32 ? s[i][e] : s[i][e] / l_s[row]);
      }
  }
  zero_held_tail(held, ls, Lk, nt, warp, lane);
  const int lt = threadIdx.x % kThreads;
  if (stats != nullptr && lt < kTileM && q0 + lt < Lq) {
    stats[(size_t)b * Lq + q0 + lt] = m_s[lt];
    stats[(size_t)(B + b) * Lq + q0 + lt] = l_s[lt];
  }

  // 3: p v, slice by slice
  const int c0 = warp * 8 * nc;
  const float rs[2] = {kF32 ? 1.f / l_s[g] : 1.f,
                       kF32 ? 1.f / l_s[g + 8] : 1.f};
  if (reuse) __syncthreads();  // the held p (no ring barrier comes)
  for (int sl = 0; sl < n_slices; ++sl) {
    float o[kMaxNC][4];
    zero(o);
    for (int kt = 0; kt < tiles; ++kt) {
      const T* u = reinterpret_cast<const T*>(ring) + rows_a * cs
                   + kt * TR * cs + sl * W;  // the slice's columns
      if (!reuse)
        u = reinterpret_cast<const T*>(
            ring + (size_t)ring_next(n1 + sl * tiles + kt, n_iter, nbuf,
                                     stage) * buf_bytes);
      product_tile(held, ls, kt * TR, min(TR, Lk - kt * TR), u,
                   reuse ? cs : us, c0, nc, lane, o);
    }
    store_slice(out + (size_t)b * Lq * D, q0, Lq, D, sl * W,
                min(W, D - sl * W), c0, nc, rs, lane, o);
  }
}

// D > 32 NC: grid (query tiles, B, slices of W = 32 NC columns). Shared
// memory: a q chunk [16][W+4], a k chunk [32][W+4], v's slice [32][W+4]
// when v is another tensor, the partial score tiles, the permuted p tile,
// 16 rescale factors / row sums. The blocks of slice 0 write the
// statistics. T as attn_fwd_kernel's.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
attn_fwd_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ bias, T* __restrict__ out,
                       float* __restrict__ stats, int B, int Lq, int Lk,
                       int D, float scale) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  constexpr bool kSplit = sizeof(T) == 4;
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
  const int nq = min(kTileM, Lq - q0);
  const T* qb = q + (size_t)b * Lq * D;
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
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

  // f32: one pass, the online softmax; bf16: the key tiles twice (see
  // attn_fwd_kernel), v's slice staged in the second pass only
  const int n_iter = (kSplit ? 1 : 2) * n_tiles;
  for (int it = 0; it < n_iter; ++it) {
    const bool second = it >= n_tiles;  // bf16 only
    const bool uses_v = kSplit || second;
    const int k0 = (it % n_tiles) * kTileN;
    const int nk = min(kTileN, Lk - k0);
    const int halves = (nk + 15) / 16;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int cc = slice_chunk(ci, slice, n_chunks) * W;
      const int w = min(W, D - cc);
      __syncthreads();  // the previous chunk's (or tile's) reads are done
      stage_rows<T, NC>(a_s, qb, q0, kTileM, Lq, D, cc, w);
      stage_rows<T, NC>(t_s, kb, k0, kTileN, Lk, D, cc, w);
      if (!v_is_k && ci == 0 && uses_v)
        stage_rows<T, NC>(v_s, vb, k0, kTileN, Lk, D, s0, min(W, D - s0));
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if constexpr (kSplit) {
        partial_tile<NC>(a_s, t_s, S, halves, warp, lane, parts, ci > 0);
      } else {
        widen_rows<NC>(a_s, kTileM, nq, w, warp, lane);
        widen_rows<NC>(t_s, 16 * halves, nk, w, warp, lane);
        if (!v_is_k && ci == 0 && uses_v)
          widen_rows<NC>(v_s, 16 * halves, nk, min(W, D - s0), warp, lane);
        __syncthreads();
        partial_tile_exact<NC>(a_s, t_s, S, halves, warp, lane, parts,
                               ci > 0);
      }
    }
    __syncthreads();
    // the last chunk staged was the slice: where v is k, t_s holds v's
    const float* vt = v_is_k ? t_s : v_s;
    if constexpr (kSplit) {
      softmax_tile<true>(parts, bias_b, k0, Lk, scale, warp, lane, m_run,
                         l_run, p_s, corr_s);
      __syncthreads();
      const float c_lo = corr_s[g], c_hi = corr_s[g + 8];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        o[n][0] *= c_lo; o[n][1] *= c_lo; o[n][2] *= c_hi; o[n][3] *= c_hi;
      }
      prob_times_rows<NC>(p_s, vt, S, c0, halves, lane, o);
    } else if (!second) {
      softmax_tile<false>(parts, bias_b, k0, Lk, scale, warp, lane, m_run,
                          l_run, p_s, corr_s);
    } else {
      normalised_bf16_probs(parts, bias_b, k0, Lk, scale, warp, lane, m_run,
                            l_run, p_s);
      __syncthreads();
      prob_times_rows_exact<NC>(p_s, vt, S, c0, halves, lane, o);
    }
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
    const float inv = kSplit ? 1.f / l_s[row] : 1.f;  // bf16: normalised
    T* at = out + ((size_t)b * Lq + q0 + row) * D + s0;
#pragma unroll
    for (int n = 0; n < NC; ++n)  // a pair lies in the slice where D is even
      store_pair_t(at, c0 + 8 * n + 2 * t, ds, D, o[n][2 * half] * inv,
                   o[n][2 * half + 1] * inv);
  }
}

template <typename T, int NC, bool kFull>
cudaError_t launch_t(const T* q, const T* k, const T* v, const float* bias,
                     T* out, float* stats, int B, int Lq, int Lk, int D,
                     float scale, cudaStream_t st) {
  constexpr size_t S = 32 * NC + kPad;
  const size_t fixed =
      (kTileM * S + kPartFloats + kProbFloats + 2 * kTileM) * sizeof(float);
  const size_t tile = (v == k ? 1 : 2) * kTileN * S * sizeof(float);
  const int nbuf = pick_buffers(fixed, tile);
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + nbuf * tile;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, NC, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kTileM - 1) / kTileM, B);
  attn_fwd_kernel<T, NC, kFull><<<grid, kThreads, smem, st>>>(
      q, k, v, bias, out, stats, B, Lq, Lk, D, scale, nbuf);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch(const T* q, const T* k, const T* v, const float* bias,
                   T* out, float* stats, int B, int Lq, int Lk, int D,
                   float scale, cudaStream_t st) {
  if (D == 32 * NC)
    return launch_t<T, NC, true>(q, k, v, bias, out, stats, B, Lq, Lk, D,
                                 scale, st);
  return launch_t<T, NC, false>(q, k, v, bias, out, stats, B, Lq, Lk, D,
                                scale, st);
}

// the online form: D <= 512 (f32; bf16 with few keys)
template <typename T>
cudaError_t launch_online(const T* q, const T* k, const T* v,
                          const float* bias, T* out, float* stats, int B,
                          int Lq, int Lk, int D, float scale,
                          cudaStream_t st) {
  switch ((D + 31) / 32) {
#define DOSTPU_CASE(n)                                                    \
  case n:                                                                 \
    return launch<T, n>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale,  \
                        st);
    DOSTPU_CASE(1) DOSTPU_CASE(2) DOSTPU_CASE(3) DOSTPU_CASE(4)
    DOSTPU_CASE(5) DOSTPU_CASE(6) DOSTPU_CASE(7) DOSTPU_CASE(8)
    DOSTPU_CASE(9) DOSTPU_CASE(10) DOSTPU_CASE(11) DOSTPU_CASE(12)
    DOSTPU_CASE(13) DOSTPU_CASE(14) DOSTPU_CASE(15) DOSTPU_CASE(16)
#undef DOSTPU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_sliced(const T* q, const T* k, const T* v,
                          const float* bias, T* out, float* stats, int B,
                          int Lq, int Lk, int D, float scale,
                          cudaStream_t st) {
  constexpr int NC = kSliceMaxNC;
  constexpr size_t S = 32 * NC + kPad;
  const size_t smem = ((v == k ? 1 : 2) * kTileN * S + kTileM * S
                       + kPartFloats + kProbFloats + 2 * kTileM)
                      * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_sliced_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int slices = (D + 32 * NC - 1) / (32 * NC);
  if (slices > 65535) return cudaErrorInvalidValue;
  const dim3 grid((Lq + kTileM - 1) / kTileM, B, slices);
  attn_fwd_sliced_kernel<T, NC><<<grid, kThreads, smem, st>>>(
      q, k, v, bias, out, stats, B, Lq, Lk, D, scale);
  return cudaGetLastError();
}

// the rows form: Lk <= kMaxL. f32 slices are always 512 columns (the 3xTF32
// product of phase 3 is unrolled at 16 groups a warp); `groups` 16-row
// groups a block, 0 for the rule's (row_groups)
template <typename T>
cudaError_t launch_rows(const T* q, const T* k, const T* v,
                        const float* bias, T* out, float* stats, int B,
                        int Lq, int Lk, int D, float scale, int groups,
                        cudaStream_t st) {
  using namespace rows;
  if (Lk > kMaxL) return cudaErrorInvalidValue;
  if (groups == 0) groups = row_groups(B, Lq, Lk, 64);
  if (groups < 1 || groups > kMaxGroups) return cudaErrorInvalidValue;
  const int nc = sizeof(T) == 4 ? kMaxNC : slice_groups(D);
  const int rows_a = kTileM * groups;
  const dim3 grid((Lq + rows_a - 1) / rows_a, B);
  const int staged = kTileM * groups + staged_rows(Lk);
  const int cols = chunk_cols<T>(D, staged, chunk_budget<T>(grid));
  const int tr = tile_rows<T>(grid);
  const bool reuse = reuses_chunk(D, cols, nc) && v == k;
  const size_t buf = reuse ? chunk_bytes<T>(staged, cols)
                           : std::max(chunk_bytes<T>(staged, cols),
                                      tile_bytes<T>(nc, tr));
  const size_t fixed = groups * held_bytes<T>(Lk)
                       + (kMaxGroups * (kWarps + 2) * kTileM + kMaxL)
                         * sizeof(float);
  const int nbuf = reuse ? (fixed + buf <= kSmemMax)
                         : ring_buffers(fixed, buf, resident(grid));
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + nbuf * buf;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attn_fwd_rows_kernel<T><<<grid, kThreads * groups, smem, st>>>(
      q, k, v, bias, out, stats, B, Lq, Lk, D, nc, cols, groups, tr, scale,
      nbuf, (int)buf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q_, const void* k_, const void* v_,
                     const float* bias, void* out_, float* stats, int B,
                     int Lq, int Lk, int D, float scale, int form,
                     cudaStream_t st) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* out = static_cast<T*>(out_);
  if (form < 0) form = rows::form_of(D, Lk, sizeof(T) == 2);
  if (form >= kFormRows)  // kFormRows + g: g row groups forced
    return launch_rows<T>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale,
                          form - kFormRows, st);
  if (form == kFormSliced)
    return launch_sliced<T>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale,
                            st);
  if (form == kFormOnline)
    return launch_online<T>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale,
                            st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The form of the attention kernels (this file, attention_bwd.cu) for
// feature width D, Lk keys and operand type (bf16 non-zero: bfloat16, else
// float32), the rule of attention_rows.cuh form_of: *form 0 (online), 1
// (sliced) or 2 (rows); *nc 32-column groups a staged row (online) or an
// output slice (sliced, rows) holds and *slices the slices of a row's
// output columns: (ceil(D / 32), 1) up to D = 512, else (16, ceil(D /
// 512)), for every form. attention_ln.cu stages rows by the same nc and
// slices in its own online form.
extern "C" void dostpu_attention_plan(int D, int Lk, int bf16, int* form,
                                      int* nc, int* slices) {
  constexpr int W = 32 * attn::kSliceMaxNC;
  *form = attn::rows::form_of(D, Lk, bf16 != 0);
  *nc = D <= W ? (D + 31) / 32 : attn::kSliceMaxNC;
  *slices = D <= W ? 1 : (D + W - 1) / W;
}

// All pointers are device pointers into contiguous, 16-byte aligned
// tensors: q [B, Lq, D], k/v [B, Lk, D] (v may be k itself) and out
// [B, Lq, D] float32, or bfloat16 when `bf16` is non-zero; bias [B, Lk] and
// stats (null or [2, B, Lq]: row max, then row sum) float32 in both forms.
// Any D >= 1. `form` is -1 for the plan's form (what the wrapper passes), or
// a form forced, to time one form against another on the same call: 0-2
// (the rows form with the rule's row groups), or 2 + g (the rows form with
// g 16-row groups a block); one that does not take the shape returns
// cudaErrorInvalidValue. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int dostpu_attention_fwd(const void* q, const void* k,
                                    const void* v, const float* bias,
                                    void* out, float* stats, int B, int Lq,
                                    int Lk, int D, float scale, int bf16,
                                    int form, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D <= 0
      || form > attn::kFormRows + attn::rows::kMaxGroups)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, bias, out, stats, B, Lq, Lk, D,
                                   scale, form, st);
  return dispatch<float>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale, form,
                         st);
}
