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
//   * bf16 form (q, k, v and out bf16; bias and the statistics f32; every
//     D, both kernels are templates over the operand type): rows are
//     staged raw, the bf16 bytes at the front of each f32 row
//     (stage_raw_async, 16-byte copies where a row's bytes allow), and
//     widened in place once the tile has landed (widen_rows: one pass and
//     one barrier a tile more). A bf16 value is a TF32 value, so each
//     product is ONE exact mma pass (the *_exact shapes of
//     attention_core.cuh, as attention_ln.cu takes them for bf16) instead
//     of three. Scores and softmax are f32 as in the f32 form, and the row
//     max and sum written for the backward are the same f32 statistics.
//     The probabilities are rounded where the TPU kernel rounds them: it
//     normalises p, rounds it to bf16 and then multiplies by v. An online
//     softmax holds p unnormalised, so the bf16 form takes two passes over
//     the key tiles: the first forms the scores for the rows' max and sum
//     only, the second forms them again and multiplies v by
//     bf16(exp(s - m) / l) (normalised_bf16_probs). That is one score
//     product more than the f32 form takes, in exchange for the plain
//     version's rounding points: the two agree within a bf16 ulp of the
//     largest value. (A first design rounded the unnormalised p to TF32 and
//     divided at the end: a bf16 model on the card then stood as far from
//     the same model on the CPU as bf16 stands from f32.)

#include "attention_core.cuh"

namespace {

using namespace attn;

// Rows staged at W = 32 * NC >= D columns; kFull: D == W, known at compile
// time (the runtime width cost the full widths time). Shared memory: q_s
// [16][W+4],
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

template <typename T>
cudaError_t dispatch(const void* q_, const void* k_, const void* v_,
                     const float* bias, void* out_, float* stats, int B,
                     int Lq, int Lk, int D, float scale, cudaStream_t st) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* out = static_cast<T*>(out_);
  if (D > 32 * kSliceMaxNC)
    return launch_sliced<T>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale,
                            st);
  switch ((D + 31) / 32) {
#define DOSTPU_CASE(n)                                                    \
  case n:                                                                 \
    return launch<T, n>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale, st);
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

// How the attention kernels (this file, attention_bwd.cu, attention_ln.cu)
// take feature width D >= 1: *nc 32-column groups a staged row holds and
// *slices blocks that share a row's output columns: (ceil(D / 32), 1) up to
// D = 512, else (16, ceil(D / 512)), the sliced kernels.
extern "C" void dostpu_attention_plan(int D, int* nc, int* slices) {
  constexpr int W = 32 * attn::kSliceMaxNC;
  *nc = D <= W ? (D + 31) / 32 : attn::kSliceMaxNC;
  *slices = D <= W ? 1 : (D + W - 1) / W;
}

// All pointers are device pointers into contiguous, 16-byte aligned
// tensors: q [B, Lq, D], k/v [B, Lk, D] (v may be k itself) and out
// [B, Lq, D] float32, or bfloat16 when `bf16` is non-zero; bias [B, Lk] and
// stats (null or [2, B, Lq]: row max, then row sum) float32 in both forms.
// Any D >= 1. Returns the CUDA error code of the launch (0 on success).
extern "C" int dostpu_attention_fwd(const void* q, const void* k,
                                    const void* v, const float* bias,
                                    void* out, float* stats, int B, int Lq,
                                    int Lk, int D, float scale, int bf16,
                                    void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, bias, out, stats, B, Lq, Lk, D,
                                   scale, st);
  return dispatch<float>(q, k, v, bias, out, stats, B, Lq, Lk, D, scale, st);
}
