// LayerNorm-fused projection-free attention forward, float32 or bfloat16
// operands, for sm_90a.
//
// Replaces the Pallas TPU kernel `_attn_ln_fwd_kernel` of
// dostransformer_tpu/ops/attention.py (launched by `_fused_attention_ln_fwd`,
// public name `fused_attention_ln`). The pre-LN transformer layer applies
// ONE LayerNorm (scale, bias, eps) to its query, key and value inputs and
// feeds the three results to the attention only:
//
//   q = LN(x)   k = LN(x_k)   v = LN(x_v)
//   out[b] = softmax(q[b] k[b]^T * D^-0.5 + bias[b]) v[b]
//
// LN statistics in f32 with the two-pass variance (mean, then mean of
// squared differences); q, k and v are rounded to the operand dtype as the
// plain version rounds them, scores and softmax are f32. No LN output
// reaches device memory.
//
// What bounds it on an H100: as the unfused attention kernel
// (attention.cu), operations: 4 * Lq * Lk * D flops per batch element (0.66
// GFLOP at the flagship self-attention 16 x 201 x 201 x 256), and latency:
// 201 row tiles a batch element are one wave of small blocks. The operands
// stay in L2. Fusion saves the LN outputs' round trip through device memory
// and two or three launches.
//
// Design: the attention kernel of attention.cu on the building blocks of
// attention_core.cuh (one 4-warp block per 16 query rows and batch element,
// both products as mma.sync on the tensor cores, 32-key tiles arriving by
// cp.async through the tile ring, one staged tile serving q k^T and p v
// when x_v is x_k, the online f32 softmax, the half tile past Lk skipped).
// What is new is where the LayerNorm happens. Raw rows arrive
// asynchronously, so they cannot be normalised on load; instead each staged
// tile is normalised IN PLACE in shared memory once it has landed, before
// the products read it: eight lanes take a row (16 bytes a lane a load),
// take its mean and variance by three shuffles each from the registers
// they just loaded, and write the normalised, rounded row back; a warp works
// on its eight rows of a tile at once so that the reduction chains overlap. That is one pass and
// one barrier a tile more than attention.cu, and it makes the hot loops
// exactly that kernel's. The statistics are recomputed per staged tile (a
// key row is visited by every query block of its batch element): the
// reductions are a few hundred cycles a tile, against a launch of their
// own and a scratch buffer. Consequences:
//   * one launch, no scratch memory; the additive key bias is formed in
//     the kernel from the boolean key mask, so the op launches nothing else;
//   * the arithmetic of a row does not depend on which tensor it came
//     from, so x_k = x_v (or all three) as one tensor or as copies gives
//     the same bits;
//   * bf16 operands are staged as 16-byte copies at the front of their f32
//     row and expanded in place by the same pass. A bf16 value is a TF32
//     value, so the split of the 3xTF32 product is skipped: ONE mma pass is
//     exact in q, k and v (the probabilities are rounded to TF32's 10 bits,
//     two more than the plain version's bf16 weights keep);
//   * a row whose keys are all masked sees every score at -1e30 and
//     averages the normalised values uniformly, as attention.cu does.
// Any D >= 1. Up to D = 512 rows are staged at ceil(D / 32) x 32 columns:
// the statistics are taken over the real D, and the LayerNorm's scale and
// bias are held at zero past D, so the padded columns normalise to 0 and add
// nothing to the products (the TPU kernel's column mask and zero-padded
// scale and bias did the same for its lane padding). Raw rows arrive as
// 16-byte copies where their byte width allows it, else 4-byte ones, and
// bf16 rows of odd width value by value. Above D = 512
// (attn_ln_fwd_sliced_kernel) the output columns are cut into slices of 512
// as in attention.cu; a row's statistics, which need all of it, are taken
// from device memory (L2) before its chunks arrive, and each staged chunk
// is normalised in place with them.

#include "attention_core.cuh"

namespace {

using namespace attn;

// The shared LayerNorm of the first n rows of a staged tile of ROWS rows, in
// place: raw T values at the front of each row -> 32 NC floats, the d
// normalised values rounded to T and zeros past d (rows n .. up to the
// next 16 all zeros: a product reads whole 16-row halves). Eight lanes share
// a row (lane l8 of the eight holds the 16-byte vectors l8, l8 + 8, ... of
// it), so a warp works on four rows at a time and a row's two reductions
// are three shuffles each, not five; a warp takes ROWS / 4 consecutive
// rows, all of them at once where the registers allow (their chains
// overlap). Two-pass variance over the d real values, f32. ln_s is the
// LayerNorm's scale [32 NC], then its bias [32 NC], zeros past d, in shared
// memory. kFull: d == 32 NC, no column is masked.
template <typename T, int NC, int ROWS, bool kFull>
__device__ __forceinline__ void normalise_rows(float* tile, int n, int d,
                                               const float* ln_s, float eps,
                                               int warp, int lane) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int VR = W / V;               // vectors of a staged row
  constexpr int NV = (VR + 7) / 8;        // vectors a lane holds of a row
  constexpr int SETS = ROWS / (4 * kWarps);     // 4-row sets a warp takes
  constexpr int SB = NV * V <= 32 ? SETS : 1;   // sets it works on at once
  const int group = lane >> 3, l8 = lane & 7;
  // rows written: up to the next 16 where a staged row past n may hold old
  // values (bf16 rows and rows narrower than 32 NC are zero-filled at the
  // front only), else up to n (whole f32 rows past n are staged as zeros)
  const int n_out = sizeof(T) == 4 && kFull ? n : (n + 15) / 16 * 16;
  auto group_sum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    return v;
  };
  for (int s0 = 0; s0 < SETS; s0 += SB) {
    const int first = 4 * (SETS * warp + s0);  // the same for the whole warp
    if (first >= n_out) break;
    float x[SB][NV][V], mu[SB], rstd[SB];
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const int row = first + 4 * s + group;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vec = l8 + 8 * i;
#pragma unroll
        for (int e = 0; e < V; ++e) x[s][i][e] = 0.f;
        if (row < n && (kFull ? vec < VR : vec * V < d)) {
          unpack(reinterpret_cast<const uint4*>(tile + row * S)[vec], x[s][i]);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if (!kFull && vec * V + e >= d) x[s][i][e] = 0.f;  // past the end
            sum += x[s][i][e];
          }
        }
      }
      mu[s] = sum;
    }
#pragma unroll
    for (int s = 0; s < SB; ++s) mu[s] = group_sum(mu[s]) / (float)d;
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const int row = first + 4 * s + group;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vec = l8 + 8 * i;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (row < n && (kFull ? vec < VR : vec * V + e < d)) {
            x[s][i][e] -= mu[s];  // centred from here on; 0 past d
            sq = fmaf(x[s][i][e], x[s][i][e], sq);
          }
        }
      }
      rstd[s] = sq;
    }
    // every lane's raw values are in registers by now (the sums need them
    // all), so the wider normalised rows may overwrite them
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      // 1 / sqrt(var + eps): the fast reciprocal root and one Newton step
      // (within an ulp of the division, at a tenth of its cost)
      const float var = group_sum(rstd[s]) / (float)d + eps;
      const float r = rsqrtf(var);
      rstd[s] = r * fmaf(-0.5f * var * r, r, 1.5f);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (l8 + 8 * i) * V;
      if (col < W) {
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 sc = *reinterpret_cast<const float4*>(ln_s + col + e);
          const float4 bi =
              *reinterpret_cast<const float4*>(ln_s + W + col + e);
#pragma unroll
          for (int s = 0; s < SB; ++s) {
            const int row = first + 4 * s + group;
            if (row >= n_out) continue;
            float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
            if (row < n) {
              y.x = rounded<T>(x[s][i][e] * rstd[s] * sc.x + bi.x);
              y.y = rounded<T>(x[s][i][e + 1] * rstd[s] * sc.y + bi.y);
              y.z = rounded<T>(x[s][i][e + 2] * rstd[s] * sc.z + bi.z);
              y.w = rounded<T>(x[s][i][e + 3] * rstd[s] * sc.w + bi.w);
            }
            *reinterpret_cast<float4*>(tile + row * S + col + e) = y;
          }
        }
      }
    }
  }
}

// Staged rows of width up to 32 NC (D <= 512); kFull: D == 32 NC, where
// the LayerNorm pass masks no column (the two passes in one kernel took
// 254 registers with bf16 operands, and the masks cost the full widths time,
// so they are two kernels). Shared memory as
// attn_fwd_kernel of attention.cu: q_s [16][W+4], n_buf tiles of 32 keys
// [32][W+4] (x_k, then x_v when it is another tensor), the partial score
// tiles, the permuted p tile, 16 rescale factors / row sums, the
// LayerNorm's scale and bias [2][W] (zeros past D), and the batch element's
// Lk key biases. x, xk and xv may be one tensor; mask is null (every key
// attended) or [B, Lk] bytes, non-zero = attend.
template <typename T, int NC, bool kFull>
__global__ void __launch_bounds__(kThreads)
attn_ln_fwd_kernel(const T* x, const T* xk, const T* xv,
                   const float* __restrict__ lns,
                   const float* __restrict__ lnb,
                   const unsigned char* __restrict__ mask,
                   T* __restrict__ out, int Lq, int Lk, int D_, float scale,
                   float eps, int nbuf) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  constexpr bool kSplit = sizeof(T) == 4;  // f32 operands: 3xTF32
  const int D = kFull ? W : D_;
  const bool v_is_k = xv == xk;
  const int tile_floats = (v_is_k ? 1 : 2) * kTileN * S;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* kv_s = q_s + kTileM * S;
  float* parts = kv_s + nbuf * tile_floats;
  float* p_s = parts + kPartFloats;
  float* corr_s = p_s + kProbFloats;  // [16]
  float* l_s = corr_s + kTileM;       // [16]
  float* ln_s = l_s + kTileM;         // [2][W]: LayerNorm scale, bias
  float* bias_s = ln_s + 2 * W;       // [Lk]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = warp * 8 * NC;  // the warp's quarter of the staged width
  const T* kb = xk + (size_t)b * Lk * D;
  const T* vb = xv + (size_t)b * Lk * D;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;
  for (int c = threadIdx.x; c < W; c += kThreads) {
    ln_s[c] = c < D ? lns[c] : 0.f;
    ln_s[W + c] = c < D ? lnb[c] : 0.f;
  }
  // the additive key bias, formed here from the boolean key mask (both read
  // after the first tile's barrier)
  for (int j = threadIdx.x; j < Lk; j += kThreads)
    bias_s[j] = mask == nullptr || mask[(size_t)b * Lk + j] ? 0.f : -1e30f;

  auto stage = [&](int tile, int buf) {
    float* dst = kv_s + buf * tile_floats;
    stage_raw_async<T, NC>(dst, kb, tile * kTileN, kTileN, Lk, D, 0, D);
    if (!v_is_k)
      stage_raw_async<T, NC>(dst + kTileN * S, vb, tile * kTileN, kTileN, Lk,
                             D, 0, D);
  };
  stage_raw_async<T, NC>(q_s, x + (size_t)b * Lq * D, q0, kTileM, Lq, D, 0,
                         D);
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
    float* k_s = kv_s + buf * tile_floats;
    float* v_s = v_is_k ? k_s : k_s + kTileN * S;
    const int k0 = it * kTileN;
    const int nk = min(kTileN, Lk - k0);
    const int halves = (nk + 15) / 16;

    // the tile has landed raw: normalise it (and, once, the query rows)
    if (it == 0)
      normalise_rows<T, NC, kTileM, kFull>(q_s, min(kTileM, Lq - q0), D, ln_s,
                                           eps, warp, lane);
    normalise_rows<T, NC, kTileN, kFull>(k_s, nk, D, ln_s, eps, warp, lane);
    if (!v_is_k)
      normalise_rows<T, NC, kTileN, kFull>(v_s, nk, D, ln_s, eps, warp, lane);
    __syncthreads();

    if (kSplit)
      partial_tile<NC>(q_s, k_s, S, halves, warp, lane, parts);
    else
      partial_tile_exact<NC>(q_s, k_s, S, halves, warp, lane, parts);
    __syncthreads();
    softmax_tile<true>(parts, bias_s, k0, Lk, scale, warp, lane, m_run, l_run,
                       p_s, corr_s);
    __syncthreads();
    const float c_lo = corr_s[g], c_hi = corr_s[g + 8];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      o[n][0] *= c_lo; o[n][1] *= c_lo; o[n][2] *= c_hi; o[n][3] *= c_hi;
    }
    if (kSplit)
      prob_times_rows<NC>(p_s, v_s, S, c0, halves, lane, o);
    else
      prob_times_rows_exact<NC>(p_s, v_s, S, c0, halves, lane, o);
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) l_s[4 * warp + r] = l_run[r];
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    if (q0 + row >= Lq) continue;
    const float inv = 1.f / l_s[row];
    T* at = out + ((size_t)b * Lq + q0 + row) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store_pair_t(at, c0 + 8 * n + 2 * t, D, D, o[n][2 * half] * inv,
                   o[n][2 * half + 1] * inv);
  }
}

// mean and rstd of rows [r0, r0 + rows) of src ([n_total][d] of T) -> mu_s,
// rs_s (zeros for rows at or past n_total): one warp a row, two passes over
// device memory (mean, then the centred variance), f32
template <typename T>
__device__ __forceinline__ void row_stats(const T* src, int r0, int rows,
                                          int n_total, int d, float eps,
                                          float* mu_s, float* rs_s, int warp,
                                          int lane) {
  for (int r = warp; r < rows; r += kWarps) {
    const int row = r0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < n_total) {
      const T* xr = src + (size_t)row * d;
      float sum = 0.f;
      for (int c = lane; c < d; c += 32) sum += to_float(xr[c]);
      mean = warp_sum(sum) / (float)d;
      float sq = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float dx = to_float(xr[c]) - mean;
        sq = fmaf(dx, dx, sq);
      }
      const float var = warp_sum(sq) / (float)d + eps;
      const float q = rsqrtf(var);
      rstd = q * fmaf(-0.5f * var * q, q, 1.5f);
    }
    if (lane == 0) {
      mu_s[r] = mean;
      rs_s[r] = rstd;
    }
  }
}

// The columns [c0, c0 + w) of the first rows16 rows of a staged tile, raw T
// at the front of each row, normalised in place with the rows' (mean, rstd)
// and the LayerNorm's scale and bias of those columns: 32 NC floats a row,
// zeros past w and in the rows at or past n. One warp a row, 32 NC / 32
// values a lane, all read before any is written.
template <typename T, int NC>
__device__ __forceinline__ void normalise_chunk(
    float* tile, int rows16, int n, const float* mu_s, const float* rs_s,
    const float* __restrict__ lns, const float* __restrict__ lnb, int c0,
    int w, int warp, int lane) {
  constexpr int S = 32 * NC + kPad;
  for (int row = warp; row < rows16; row += kWarps) {
    const T* raw = reinterpret_cast<const T*>(tile + row * S);
    float v[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      v[j] = row < n && col < w ? to_float(raw[col]) : 0.f;
    }
    __syncwarp();
    const float mu = mu_s[row], rs = rs_s[row];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      tile[row * S + col] =
          row < n && col < w
              ? rounded<T>((v[j] - mu) * rs * lns[c0 + col] + lnb[c0 + col])
              : 0.f;
    }
  }
}

// D > 32 NC: grid (query tiles, B, slices of W = 32 NC columns), as
// attn_fwd_sliced_kernel of attention.cu. Shared memory: a q chunk
// [16][W+4], a k chunk [32][W+4], v's slice [32][W+4] when x_v is another
// tensor, the partial score tiles, the permuted p tile, 16 rescale factors /
// row sums, the rows' mean and rstd (16 query rows, 32 keys, 32 values) and
// the Lk key biases.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
attn_ln_fwd_sliced_kernel(const T* x, const T* xk, const T* xv,
                          const float* __restrict__ lns,
                          const float* __restrict__ lnb,
                          const unsigned char* __restrict__ mask,
                          T* __restrict__ out, int Lq, int Lk, int D,
                          float scale, float eps) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  constexpr bool kSplit = sizeof(T) == 4;
  const bool v_is_k = xv == xk;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;
  float* t_s = a_s + kTileM * S;
  float* v_s = t_s + kTileN * S;  // x_v another tensor only
  float* parts = v_s + (v_is_k ? 0 : kTileN * S);
  float* p_s = parts + kPartFloats;
  float* corr_s = p_s + kProbFloats;  // [16]
  float* l_s = corr_s + kTileM;       // [16]
  float* qmu = l_s + kTileM;          // [16] each
  float* qrs = qmu + kTileM;
  float* kmu = qrs + kTileM;          // [32] each
  float* krs = kmu + kTileN;
  float* vmu = krs + kTileN;
  float* vrs = vmu + kTileN;
  float* bias_s = vrs + kTileN;       // [Lk]
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
  const T* qb = x + (size_t)b * Lq * D;
  const T* kb = xk + (size_t)b * Lk * D;
  const T* vb = xv + (size_t)b * Lk * D;
  const int n_tiles = (Lk + kTileN - 1) / kTileN;
  for (int j = threadIdx.x; j < Lk; j += kThreads)
    bias_s[j] = mask == nullptr || mask[(size_t)b * Lk + j] ? 0.f : -1e30f;
  row_stats(qb, q0, kTileM, Lq, D, eps, qmu, qrs, warp, lane);

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
    const int nk = min(kTileN, Lk - k0);
    const int halves = (nk + 15) / 16;
    // the tile's rows' statistics (the previous tile's are read no more)
    row_stats(kb, k0, kTileN, Lk, D, eps, kmu, krs, warp, lane);
    if (!v_is_k) row_stats(vb, k0, kTileN, Lk, D, eps, vmu, vrs, warp, lane);
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int cc = slice_chunk(ci, slice, n_chunks) * W;
      const int w = min(W, D - cc);
      __syncthreads();
      stage_raw_async<T, NC>(a_s, qb, q0, kTileM, Lq, D, cc, w);
      stage_raw_async<T, NC>(t_s, kb, k0, kTileN, Lk, D, cc, w);
      if (!v_is_k && ci == 0)
        stage_raw_async<T, NC>(v_s, vb, k0, kTileN, Lk, D, s0,
                               min(W, D - s0));
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      normalise_chunk<T, NC>(a_s, kTileM, nq, qmu, qrs, lns, lnb, cc, w, warp,
                             lane);
      normalise_chunk<T, NC>(t_s, 16 * halves, nk, kmu, krs, lns, lnb, cc, w,
                             warp, lane);
      if (!v_is_k && ci == 0)
        normalise_chunk<T, NC>(v_s, 16 * halves, nk, vmu, vrs, lns, lnb, s0,
                               min(W, D - s0), warp, lane);
      __syncthreads();
      if (kSplit)
        partial_tile<NC>(a_s, t_s, S, halves, warp, lane, parts, ci > 0);
      else
        partial_tile_exact<NC>(a_s, t_s, S, halves, warp, lane, parts,
                               ci > 0);
    }
    __syncthreads();
    softmax_tile<true>(parts, bias_s, k0, Lk, scale, warp, lane, m_run, l_run,
                       p_s, corr_s);
    __syncthreads();
    const float c_lo = corr_s[g], c_hi = corr_s[g + 8];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      o[n][0] *= c_lo; o[n][1] *= c_lo; o[n][2] *= c_hi; o[n][3] *= c_hi;
    }
    // the last chunk staged was the slice: where x_v is x_k, t_s holds v's
    const float* vt = v_is_k ? t_s : v_s;
    if (kSplit)
      prob_times_rows<NC>(p_s, vt, S, c0, halves, lane, o);
    else
      prob_times_rows_exact<NC>(p_s, vt, S, c0, halves, lane, o);
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) l_s[4 * warp + r] = l_run[r];
  }
  __syncthreads();
  const int ds = min(W, D - s0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    if (q0 + row >= Lq) continue;
    const float inv = 1.f / l_s[row];
    T* at = out + ((size_t)b * Lq + q0 + row) * D + s0;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store_pair_t(at, c0 + 8 * n + 2 * t, ds, D, o[n][2 * half] * inv,
                   o[n][2 * half + 1] * inv);
  }
}

template <typename T, int NC, bool kFull>
cudaError_t launch_t(const void* x, const void* xk, const void* xv,
                     const float* lns, const float* lnb,
                     const unsigned char* mask, void* out, int B, int Lq,
                     int Lk, int D, float scale, float eps, cudaStream_t st) {
  constexpr size_t S = 32 * NC + kPad;
  const size_t fixed =
      (kTileM * S + kPartFloats + kProbFloats + 2 * kTileM + 2 * 32 * NC +
       Lk) * sizeof(float);
  const size_t tile = (xv == xk ? 1 : 2) * kTileN * S * sizeof(float);
  const int nbuf = pick_buffers(fixed, tile);
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + nbuf * tile;
  cudaError_t err = cudaFuncSetAttribute(
      attn_ln_fwd_kernel<T, NC, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kTileM - 1) / kTileM, B);
  attn_ln_fwd_kernel<T, NC, kFull><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(xk),
      static_cast<const T*>(xv), lns, lnb, mask, static_cast<T*>(out), Lq, Lk,
      D, scale, eps, nbuf);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch(const void* x, const void* xk, const void* xv,
                   const float* lns, const float* lnb,
                   const unsigned char* mask, void* out, int B, int Lq, int Lk,
                   int D, float scale, float eps, cudaStream_t st) {
  if (D == 32 * NC)
    return launch_t<T, NC, true>(x, xk, xv, lns, lnb, mask, out, B, Lq, Lk, D,
                                 scale, eps, st);
  return launch_t<T, NC, false>(x, xk, xv, lns, lnb, mask, out, B, Lq, Lk, D,
                                scale, eps, st);
}

template <typename T>
cudaError_t launch_sliced(const void* x, const void* xk, const void* xv,
                          const float* lns, const float* lnb,
                          const unsigned char* mask, void* out, int B, int Lq,
                          int Lk, int D, float scale, float eps,
                          cudaStream_t st) {
  constexpr int NC = kSliceMaxNC;
  constexpr size_t S = 32 * NC + kPad;
  const size_t smem =
      ((kTileM + (xv == xk ? 1 : 2) * kTileN) * S + kPartFloats + kProbFloats
       + 2 * kTileM + 2 * kTileM + 4 * kTileN + Lk) * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_ln_fwd_sliced_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int slices = (D + 32 * NC - 1) / (32 * NC);
  if (slices > 65535) return cudaErrorInvalidValue;
  const dim3 grid((Lq + kTileM - 1) / kTileM, B, slices);
  attn_ln_fwd_sliced_kernel<T, NC><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(xk),
      static_cast<const T*>(xv), lns, lnb, mask, static_cast<T*>(out), Lq, Lk,
      D, scale, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* xk, const void* xv,
                     const float* lns, const float* lnb,
                     const unsigned char* mask, void* out, int B, int Lq,
                     int Lk, int D, float scale, float eps, cudaStream_t st) {
  if (D > 32 * kSliceMaxNC)
    return launch_sliced<T>(x, xk, xv, lns, lnb, mask, out, B, Lq, Lk, D,
                            scale, eps, st);
  switch ((D + 31) / 32) {
#define DOSTPU_CASE(nc)                                                   \
  case nc:                                                                \
    return launch<T, nc>(x, xk, xv, lns, lnb, mask, out, B, Lq, Lk, D,    \
                         scale, eps, st);
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

// All pointers are device pointers into contiguous, 16-byte aligned tensors:
// x and out [B, Lq, D], xk and xv [B, Lk, D] (float32, or bfloat16 when
// `bf16` is non-zero; xk, xv and x may be one tensor); lns and lnb [D]
// float32; mask null (every key attended) or [B, Lk] bytes (bool: non-zero
// = attend, zero = the key takes the bias -1e30), any alignment. Any
// D >= 1. One launch, no scratch memory. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int dostpu_attention_ln_fwd(const void* x, const void* xk,
                                       const void* xv, const float* lns,
                                       const float* lnb,
                                       const unsigned char* mask, void* out,
                                       int B, int Lq, int Lk,
                                       int D, float scale, float eps,
                                       int bf16, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(x, xk, xv, lns, lnb, mask, out, B, Lq, Lk,
                                   D, scale, eps, st);
  return dispatch<float>(x, xk, xv, lns, lnb, mask, out, B, Lq, Lk, D, scale,
                         eps, st);
}
