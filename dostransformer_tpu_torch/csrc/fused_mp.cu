// Fused message-passing edge pipeline, forward, float32 or bfloat16
// operands, for sm_90a.
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
// What bounds it on an H100: operations. The W1 product is 2*E*M*H flops
// per graph (0.8 GFLOP per flagship batch of 8) and the gathers read 3 rows
// of M floats per edge; every block re-reads its share of W1 from L2. The
// TPU kernel gathered and scattered with one-hot matmuls on the MXU; here
// the gathers are plain indexed row loads and the scatter is a separate
// deterministic pass.
//
// Design. Two hand-written forms, chosen by the widths alone
// (dostpu_fused_mp_form): the tensor-core form where M and H are multiples
// of 32 and its smallest tile fits in shared memory (M <= 3,084), the generic
// form at every other width.
//   * edge_tc_kernel (tensor-core form): the B*E edges are one flat list; a
//     block owns TE of them and HB of the H outputs. One warp per edge row
//     gathers mid into shared memory with 16-byte loads, takes the LayerNorm
//     statistics in two passes and writes PReLU(LN(mid)) back in place
//     ([TE][M + 4] floats), so the [E, M] intermediates never reach device
//     memory; blocks that split H repeat this cheap part. The product runs
//     as 3xTF32 mma.sync (f32 accuracy): W1 (torch layout [H, M], read as it
//     lies: its rows are the B fragments' columns) streams in [HB x 64]
//     chunks through a ring of 2 or 3 cp.async buffers (rows padded to 68
//     floats), the first chunks in flight during the gather, one block
//     barrier a chunk (8 k-steps: 32-column chunks cost 5-10% more time).
//     The 8 warps tile the block's outputs WE x (8 / WE) and each keeps
//     MT m16 x NT n8 accumulator tiles; e_out leaves the
//     fragments with b1 added. Two tile shapes, 32 x 256 and 16 x 64; the
//     launcher takes the cheaper under a cost model over the blocks an SM
//     gets, so 128 edges or 3,072 both spread over the 132 SMs, and
//     W1 is read by B*E / TE * H / HB blocks, HB / H of it each.
//     Shared memory a block at M = 512: 32 x 256: 205,312 B; 16 x 64:
//     85,248 B (two blocks an SM). At M = 2,048 only 16 x 64 fits
//     (183,552 B).
//   * edge_kernel (generic form, any M and H): one block per (graph, tile of
//     16 edges), the product as FMA loops from shared memory with W1 in
//     [256 x 32] chunks and a 4-edge x 4-output register tile per thread.
//     Its shared memory is the same at every width (36,032 B), so no width
//     is refused: a block keeps only each row's LayerNorm statistics (two
//     passes over mid gathered from L2) and forms each 32-column chunk of
//     act anew beside its chunk of W1, the gather repeated once per 256
//     outputs. (Keeping the [16][M] rows, as the first design did, passed
//     the 232,448 B a block gets from M = 3,105.)
//   * agg_kernel (both forms): one block per (node, graph, 256 outputs)
//     lists the real edges whose receiver is that node, in edge order (a
//     ballot and a prefix sum per 256 edges); four slices of its threads sum
//     every fourth listed row, four columns a thread, and the slices' sums
//     are added in order. No float atomics, so the sum is the same on
//     every run.
//   * Indices are bound-checked: an out-of-range sender or receiver adds a
//     zero row to mid (as a one-hot row that matches no node did on the TPU)
//     and reaches no node of agg. Pad edges (index 0, mask 0) still get their
//     e_out row, which the caller's edge residual uses.
//   * bf16 form (a bf16 model: src_proj, dst_proj, edge_proj, e_out and agg
//     bf16; LayerNorm scale and bias, the slope, W1 and b1 stay f32, as the
//     TPU kernel takes them uncast): both forms are templates over the
//     operand type, so every width the f32 form runs also runs in bf16. The
//     three rows load as bf16 (16-byte loads of 8 values in the tensor-core
//     form) and are widened to f32 in registers; mid, the LayerNorm, PReLU
//     and the product against the f32 W1 (3xTF32) are the f32 kernel's,
//     on the same shared memory. e_out is rounded to bf16 once at its store,
//     and its unrounded f32 rows also go to a scratch buffer, from which
//     agg_kernel sums agg in f32 and rounds it once: the TPU kernel's two
//     rounding points (its e_out store, its agg buffer's final cast). What
//     bounds it stays the W1 product's operations; the bytes it must move
//     roughly halve.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "fused_mp_core.cuh"

namespace {

constexpr int kTileE = 16;     // edges per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kTileH = 256;    // W1 rows (outputs) per pass
constexpr int kTileM = 32;     // W1 columns per shared-memory chunk
using mp::kLnEps;
using mp::warp_sum;
using mp::widen;

// The generic form's shared memory, a constant: a block keeps no whole row
// of mid, only each row's statistics, a [kTileE x kTileM] tile of act and a
// [kTileH x kTileM] chunk of W1, so every M and H fits.
constexpr int kTileStride = kTileM + 1;  // floats a staged row (no conflicts)
constexpr size_t kGenericSmemFloats =
    (size_t)(kTileE + kTileH) * kTileStride + 2 * kTileE;


// e_out[at] (and e_out[at + 1]): f32 as computed; bf16 rounded once, with
// the f32 values also in e32, the aggregation's source
__device__ __forceinline__ void store_edge(float* e_out, float* /*e32*/,
                                           size_t at, float v) {
  e_out[at] = v;
}
__device__ __forceinline__ void store_edge(__nv_bfloat16* e_out, float* e32,
                                           size_t at, float v) {
  e_out[at] = __float2bfloat16(v);
  e32[at] = v;
}
__device__ __forceinline__ void store_edge_pair(float* e_out, float* /*e32*/,
                                                size_t at, float a, float b) {
  *reinterpret_cast<float2*>(e_out + at) = make_float2(a, b);
}
__device__ __forceinline__ void store_edge_pair(__nv_bfloat16* e_out,
                                                float* e32, size_t at,
                                                float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(e_out + at) = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<float2*>(e32 + at) = make_float2(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_kernel(const T* __restrict__ sp, const T* __restrict__ dp,
            const T* __restrict__ ep, const int* __restrict__ senders,
            const int* __restrict__ receivers,
            const float* __restrict__ ln_scale,
            const float* __restrict__ ln_bias,
            const float* __restrict__ alpha, const float* __restrict__ w1,
            const float* __restrict__ b1, T* __restrict__ e_out,
            float* __restrict__ e32, int A, int E, int M, int H) {
  extern __shared__ float smem[];
  float* a_s = smem;                           // [kTileE][kTileStride]
  float* w_s = a_s + kTileE * kTileStride;     // [kTileH][kTileStride]
  float* mean_s = w_s + kTileH * kTileStride;  // [kTileE]
  float* rstd_s = mean_s + kTileE;             // [kTileE]
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kTileE;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float slope = alpha[0];

  // mid[i, m] of the tile's row i (0 past the last edge or for an index out
  // of range, as a one-hot row that matches no node did on the TPU)
  auto mid = [&](int i, int m) {
    const size_t be = (size_t)b * E + e0 + i;
    const int s = senders[be];
    const int r = receivers[be];
    const float vs =
        s >= 0 && s < A ? widen(sp[((size_t)b * A + s) * M + m]) : 0.f;
    const float vd =
        r >= 0 && r < A ? widen(dp[((size_t)b * A + r) * M + m]) : 0.f;
    return (vs + vd) + widen(ep[be * M + m]);
  };

  // 1. the LayerNorm statistics of each row, one warp a row, in two passes
  //    over mid gathered from L2 (a row of M floats is not kept)
  for (int i = warp; i < kTileE; i += kThreads / 32) {
    if (e0 + i >= E) {
      if (lane == 0) mean_s[i] = rstd_s[i] = 0.f;
      continue;
    }
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) sum += mid(i, m);
    const float mean = warp_sum(sum) / M;
    float sq = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float d = mid(i, m) - mean;
      sq += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) / M + kLnEps);
    if (lane == 0) {
      mean_s[i] = mean;
      rstd_s[i] = rstd;
    }
  }

  // 2. e_out = act @ W1^T + b1: thread (te, th) owns edges te*4 + k and
  //    outputs h0 + th + 64*j, k, j in [0, 4); each kTileM-column chunk of
  //    act = PReLU(LN(mid)) is formed anew beside its chunk of W1
  const int th = threadIdx.x % 64;
  const int te = threadIdx.x / 64;
  for (int h0 = 0; h0 < H; h0 += kTileH) {
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
    for (int m0 = 0; m0 < M; m0 += kTileM) {
      __syncthreads();  // the statistics are complete / the chunk is consumed
      for (int idx = threadIdx.x; idx < kTileH * kTileM; idx += kThreads) {
        const int hh = idx / kTileM;
        const int mm = idx % kTileM;
        const int h = h0 + hh;
        const int m = m0 + mm;
        w_s[hh * kTileStride + mm] =
            (h < H && m < M) ? w1[(size_t)h * M + m] : 0.f;
      }
      for (int idx = threadIdx.x; idx < kTileE * kTileM; idx += kThreads) {
        const int i = idx / kTileM;
        const int m = m0 + idx % kTileM;
        float v = 0.f;
        if (e0 + i < E && m < M) {
          const float n =
              (mid(i, m) - mean_s[i]) * rstd_s[i] * ln_scale[m] + ln_bias[m];
          v = n > 0.f ? n : slope * n;
        }
        a_s[i * kTileStride + idx % kTileM] = v;
      }
      __syncthreads();
      const int depth = min(kTileM, M - m0);
      for (int mm = 0; mm < depth; ++mm) {
        float av[4], wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) av[k] = a_s[(te * 4 + k) * kTileStride + mm];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = w_s[(th + 64 * j) * kTileStride + mm];
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
        if (h < H)
          store_edge(e_out, e32, ((size_t)b * E + e) * H + h,
                     acc[k][j] + b1[h]);
      }
    }
  }
}

// The tensor-core form: TE = WE * MT * 16 edges of the flat list by
// HB = (8 / WE) * NT * 8 outputs a block.
constexpr int kChunkK = 64;             // W1 columns per staged chunk
constexpr int kChunkStride = kChunkK + 4;  // floats per staged W1 row

// acc += act[MT 16 rows, KS 8 columns from c0] . W^T for the warp's NT n8
// column tiles of one staged chunk (wt: the warp's first row of the chunk).
// The chunk's MMAs go to accumulators of their own, which a rounded f32 add
// joins to acc: the tensor core truncates when it adds into an accumulator,
// so long chains drift.
template <int MT, int NT, int KS>
__device__ __forceinline__ void chunk_product(const float* a_base, int AS,
                                              int c0, const float* wt, int g,
                                              int t, float (&acc)[MT][NT][4]) {
  float part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      mp::load_a(a_base + mt * 16 * AS, AS, g, c0 + 8 * ks + t, a_hi[mt],
                 a_lo[mt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* wr = wt + (8 * nt + g) * kChunkStride + 8 * ks + t;
      uint32_t b_hi[2], b_lo[2];
      mp::split_tf32(wr[0], b_hi[0], b_lo[0]);
      mp::split_tf32(wr[4], b_hi[1], b_lo[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {  // the small terms first
        mp::mma_tf32(part[mt][nt], a_lo[mt], b_hi[0], b_hi[1]);
        mp::mma_tf32(part[mt][nt], a_hi[mt], b_lo[0], b_lo[1]);
        mp::mma_tf32(part[mt][nt], a_hi[mt], b_hi[0], b_hi[1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

template <typename T, int WE, int MT, int NT>
__global__ void __launch_bounds__(kThreads)
edge_tc_kernel(const T* __restrict__ sp, const T* __restrict__ dp,
               const T* __restrict__ ep, const int* __restrict__ senders,
               const int* __restrict__ receivers,
               const float* __restrict__ ln_scale,
               const float* __restrict__ ln_bias,
               const float* __restrict__ alpha, const float* __restrict__ w1,
               const float* __restrict__ b1, T* __restrict__ e_out,
               float* __restrict__ e32, int N, int A, int E, int M, int H,
               int stages) {
  constexpr int WH = mp::kWarps / WE;
  constexpr int TE = WE * MT * 16;
  constexpr int HB = WH * NT * 8;
  extern __shared__ __align__(16) float tc_smem[];
  const int AS = M + 4;           // act row stride
  float* act = tc_smem;           // [TE][AS]
  float* w_s = tc_smem + TE * AS;  // [stages][HB][kChunkStride]
  const int n0 = blockIdx.x * TE;
  const int h0 = blockIdx.y * HB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nchunks = (M + kChunkK - 1) / kChunkK;

  // W1[h0 .. h0 + HB, 64 c .. 64 c + 64] -> buffer c % stages; rows at or
  // past H and columns at or past M are zero-filled
  auto stage = [&](int c) {
    float* dst = w_s + (c % stages) * (HB * kChunkStride);
    for (int idx = threadIdx.x; idx < HB * (kChunkK / 4); idx += kThreads) {
      const int hh = idx / (kChunkK / 4);
      const int q = idx % (kChunkK / 4);
      const bool ok = h0 + hh < H && c * kChunkK + 4 * q < M;
      mp::cp_async16(dst + hh * kChunkStride + 4 * q,
                     w1 + (ok ? (size_t)(h0 + hh) * M + c * kChunkK + 4 * q : 0),
                     ok);
    }
  };
  for (int c = 0; c < stages - 1; ++c) {  // in flight during the gather
    if (c < nchunks) stage(c);
    mp::cp_async_commit();
  }

  // 1. gather + LayerNorm + PReLU, one warp per edge row (not unrolled: the
  //    rows' unrolled copies cost pass A of the backward 25%, measured)
  const float slope = alpha[0];
#pragma unroll 1
  for (int i = warp; i < TE; i += mp::kWarps) {
    float* row = act + i * AS;
    if (n0 + i >= N) {  // past the last edge
      for (int m = lane; m < M; m += 32) row[m] = 0.f;
      continue;
    }
    const mp::RowStats st = mp::gather_mid_row(
        sp, dp, ep, senders, receivers, (size_t)(n0 + i), A, E, M, lane, row);
    for (int j = lane; j < M / 4; j += 32) {
      float4 v = mp::ld4(row, j);
      const float4 sc = mp::ld4(ln_scale, j);
      const float4 bi = mp::ld4(ln_bias, j);
      v.x = (v.x - st.mean) * st.rstd * sc.x + bi.x;
      v.y = (v.y - st.mean) * st.rstd * sc.y + bi.y;
      v.z = (v.z - st.mean) * st.rstd * sc.z + bi.z;
      v.w = (v.w - st.mean) * st.rstd * sc.w + bi.w;
      v.x = v.x > 0.f ? v.x : slope * v.x;
      v.y = v.y > 0.f ? v.y : slope * v.y;
      v.z = v.z > 0.f ? v.z : slope * v.z;
      v.w = v.w > 0.f ? v.w : slope * v.w;
      mp::st4(row, j, v);
    }
  }

  // 2. e_out = act @ W1^T + b1: warp (we, wh) owns edge rows
  //    [we MT 16, (we + 1) MT 16) and outputs [wh NT 8, (wh + 1) NT 8)
  const int we = warp / WH;
  const int wh = warp % WH;
  const int g = lane >> 2, t = lane & 3;
  const bool active = h0 + wh * NT * 8 < H;  // the same for a whole warp
  const float* a_base = act + (we * MT * 16) * AS;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    mp::ring_wait(stages);
    __syncthreads();  // chunk c (and, first, act) is complete; c - 1 is consumed
    if (c + stages - 1 < nchunks) stage(c + stages - 1);
    mp::cp_async_commit();
    if (!active) continue;
    const float* wt =
        w_s + (c % stages) * (HB * kChunkStride) + (wh * NT * 8) * kChunkStride;
    if (M - c * kChunkK >= kChunkK)  // M is a multiple of 32: whole or half
      chunk_product<MT, NT, kChunkK / 8>(a_base, AS, c * kChunkK, wt, g, t,
                                         acc);
    else
      chunk_product<MT, NT, kChunkK / 16>(a_base, AS, c * kChunkK, wt, g, t,
                                          acc);
  }
  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int h = h0 + (wh * NT + nt) * 8 + 2 * t;
    if (h >= H) continue;
    const float bx = b1[h], by = b1[h + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int n = n0 + (we * MT + mt) * 16 + g;
      if (n < N)
        store_edge_pair(e_out, e32, (size_t)n * H + h, acc[mt][nt][0] + bx,
                        acc[mt][nt][1] + by);
      if (n + 8 < N)
        store_edge_pair(e_out, e32, (size_t)(n + 8) * H + h,
                        acc[mt][nt][2] + bx, acc[mt][nt][3] + by);
    }
  }
}

// agg[b, node, h] = sum over the edges e with receivers[b, e] == node and
// mask[b, e] != 0 of e_out[b, e, h] * mask[b, e] (an edge with mask 0 adds
// nothing and is not listed), from the f32 e_out (the bf16 form's scratch),
// stored as T. One block per (node, graph, 256 outputs).
template <typename T>
__global__ void __launch_bounds__(kThreads)
agg_kernel(const float* __restrict__ e_out, const int* __restrict__ receivers,
           const float* __restrict__ mask, T* __restrict__ agg, int A,
           int E, int H) {
  __shared__ int list[kThreads];
  __shared__ int counts[mp::kWarps];
  __shared__ float red[mp::kScatterSlices][kThreads];
  const int node = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * kThreads;
  const int lane = threadIdx.x % mp::kScatterLanes;
  const int slice = threadIdx.x / mp::kScatterLanes;
  const size_t base = (size_t)b * E;
  float acc[mp::kScatterSlices] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < E; c0 += kThreads) {
    const int e = c0 + threadIdx.x;
    const bool match =
        e < E && receivers[base + e] == node && mask[base + e] != 0.f;
    const int n = mp::compact_matches(match, e, list, counts);
    mp::sum_listed_rows(e_out, base, list, n, H, h0, lane, slice,
                        [&](size_t row) { return mask[row]; }, acc);
  }
  mp::store_slice_sums(acc, red, agg + ((size_t)b * A + node) * H, H, h0,
                       lane, slice);
}

// the tensor-core form's tile shapes, larger first: edges x outputs a block
// and the model's cost of one multiply-add in it (clocks of an SM)
struct TcTile {
  int te, hb;
  float mac;
};
constexpr int kNumTiles = 2;
constexpr TcTile kTiles[kNumTiles] = {{32, 256, 0.0050f}, {16, 64, 0.0085f}};
constexpr float kGatherCost = 0.4f;  // clocks per gathered element

size_t tile_fixed_bytes(int tile, int M) {
  return (size_t)kTiles[tile].te * (M + 4) * sizeof(float);
}

size_t tile_stage_bytes(int tile) {
  return (size_t)kTiles[tile].hb * kChunkStride * sizeof(float);
}

int tile_stages(int tile, int M) {
  return mp::ring_stages(tile_fixed_bytes(tile, M), tile_stage_bytes(tile));
}

// The tile whose blocks cost an SM the least: an SM gets
// ceil(blocks / 132) of them, each gathers te rows and multiplies them with
// hb rows of W1. The smallest tile when none fits (the caller's
// shared-memory check then names the bytes).
int pick_tile(int N, int M, int H) {
  int best = kNumTiles - 1;
  float best_cost = -1.f;
  for (int i = 0; i < kNumTiles; ++i) {
    if (!tile_stages(i, M)) continue;
    const TcTile& c = kTiles[i];
    const long blocks = (long)mp::ceil_div(N, c.te) * mp::ceil_div(H, c.hb);
    const float per_sm = (float)mp::ceil_div(blocks, mp::kSMs);
    const float cost = per_sm * c.te * (float)M
                       * (kGatherCost + std::min(c.hb, H) * c.mac);
    if (best_cost < 0.f || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

size_t tile_smem_bytes(int tile, int M) {
  const int stages = std::max(2, tile_stages(tile, M));
  return tile_fixed_bytes(tile, M) + stages * tile_stage_bytes(tile);
}

template <typename T, int WE, int MT, int NT>
cudaError_t launch_edge_tc(const T* sp, const T* dp, const T* ep,
                           const int* senders, const int* receivers,
                           const float* ln_scale, const float* ln_bias,
                           const float* alpha, const float* w1,
                           const float* b1, T* e_out, float* e32, int N,
                           int A, int E, int M, int H, int stages,
                           size_t smem, cudaStream_t st) {
  constexpr int TE = WE * MT * 16;
  constexpr int HB = (mp::kWarps / WE) * NT * 8;
  auto kernel = edge_tc_kernel<T, WE, MT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(mp::ceil_div(N, TE), mp::ceil_div(H, HB));
  kernel<<<grid, kThreads, smem, st>>>(sp, dp, ep, senders, receivers,
                                       ln_scale, ln_bias, alpha, w1, b1, e_out,
                                       e32, N, A, E, M, H, stages);
  return cudaGetLastError();
}

bool tc_widths(int M, int H) {
  return M > 0 && H > 0 && M % 32 == 0 && H % 32 == 0;
}

}  // namespace

// Which hand-written form of the forward these widths take: 1 the
// tensor-core form (M and H multiples of 32, and the smallest tile fits in a
// block's shared memory), 0 the generic form.
extern "C" int dostpu_fused_mp_form(int M, int H) {
  return tc_widths(M, H) && tile_stages(kNumTiles - 1, M) > 0 ? 1 : 0;
}

namespace {

// form as the entry points take it -> 0 (generic), 1 + tile (tensor-core),
// or -1 (not a form of these widths)
int resolve_form(int form, int N, int M, int H) {
  if (form < 0) form = dostpu_fused_mp_form(M, H);
  if (form == 0) return 0;
  if (form != 1 || !tc_widths(M, H)) return -1;
  return 1 + pick_tile(N, M, H);
}

}  // namespace

// Shared memory a block of the forward asks for. `form`: -1 the widths' own
// form, 0 the generic form, 1 the tensor-core form (widths that are
// multiples of 32 only) with the tile the cost model picks.
extern "C" size_t dostpu_fused_mp_edge_smem_bytes(int B, int E, int M, int H,
                                                  int form) {
  const int f = resolve_form(form, B * E, M, H);
  if (f <= 0) return kGenericSmemFloats * sizeof(float);
  return tile_smem_bytes(f - 1, M);
}

// edges (*te) x outputs (*hb) of a block's tile at this shape: the
// tensor-core form's tile, or 16 x H for the generic form
extern "C" void dostpu_fused_mp_edge_tile(int B, int E, int M, int H,
                                          int form, int* te, int* hb) {
  const int f = resolve_form(form, B * E, M, H);
  *te = f <= 0 ? kTileE : kTiles[f - 1].te;
  *hb = f <= 0 ? H : kTiles[f - 1].hb;
}

namespace {

// the edge kernel of the form taken, then agg_kernel; e32 is the f32 rows of
// e_out that agg_kernel sums (e_out itself for f32 operands)
template <typename T>
cudaError_t launch_fwd(const T* sp, const T* dp, const T* ep,
                       const int* senders, const int* receivers,
                       const float* edge_mask, const float* ln_scale,
                       const float* ln_bias, const float* alpha,
                       const float* w1, const float* b1, T* e_out, T* agg,
                       float* e32, int B, int A, int E, int M, int H, int f,
                       size_t smem, cudaStream_t st) {
  const int N = B * E;
  cudaError_t err;
  if (f == 0) {
    err = cudaFuncSetAttribute(
        edge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid_e((E + kTileE - 1) / kTileE, B);
    edge_kernel<T><<<grid_e, kThreads, smem, st>>>(
        sp, dp, ep, senders, receivers, ln_scale, ln_bias, alpha, w1, b1,
        e_out, e32, A, E, M, H);
    err = cudaGetLastError();
  } else {
    const int stages = std::max(2, tile_stages(f - 1, M));
#define DOSTPU_LAUNCH_TILE(WE, MT, NT)                                      \
  launch_edge_tc<T, WE, MT, NT>(sp, dp, ep, senders, receivers, ln_scale,   \
                                ln_bias, alpha, w1, b1, e_out, e32, N, A, E, \
                                M, H, stages, smem, st)
    err = f - 1 == 0 ? DOSTPU_LAUNCH_TILE(1, 2, 4)   // 32 x 256
                     : DOSTPU_LAUNCH_TILE(1, 1, 1);  // 16 x 64
#undef DOSTPU_LAUNCH_TILE
  }
  if (err != cudaSuccess) return err;
  const dim3 grid_a(A, B, (H + kThreads - 1) / kThreads);
  agg_kernel<T><<<grid_a, kThreads, 0, st>>>(e32, receivers, edge_mask, agg,
                                             A, E, H);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers into contiguous tensors:
// src_proj/dst_proj [B, A, M], edge_proj [B, E, M], e_out [B, E, H] and
// agg [B, A, H] float32, or bfloat16 when `bf16` is non-zero (16-byte
// aligned); senders/receivers [B, E] int32; edge_mask [B, E], ln_scale/ln_bias
// [M], alpha [1], w1 [H, M] (torch Linear layout), b1 [H] float32 in both
// forms; e32 [B, E, H] float32 scratch for the bf16 form (the unrounded
// e_out that agg sums), null for float32. `form` as
// dostpu_fused_mp_edge_smem_bytes takes it; the shared memory and tiles are
// the same for both dtypes. Returns the CUDA error code of the launches (0 on
// success).
extern "C" int dostpu_fused_mp_edge_fwd(
    const void* src_proj, const void* dst_proj, const void* edge_proj,
    const int* senders, const int* receivers, const float* edge_mask,
    const float* ln_scale, const float* ln_bias, const float* alpha,
    const float* w1, const float* b1, void* e_out, void* agg, float* e32,
    int B, int A, int E, int M, int H, int form, int bf16, void* stream) {
  if (B <= 0 || A <= 0 || E <= 0 || M <= 0 || H <= 0 || B > 65535
      || (long)B * E > 0x7fffffffL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int f = resolve_form(form, B * E, M, H);
  if (f < 0) return cudaErrorInvalidValue;
  const size_t smem = dostpu_fused_mp_edge_smem_bytes(B, E, M, H, form);
  if (bf16) {
    using T = __nv_bfloat16;
    if (e32 == nullptr || (f > 0 && M % 8 != 0)) return cudaErrorInvalidValue;
    return launch_fwd(static_cast<const T*>(src_proj),
                      static_cast<const T*>(dst_proj),
                      static_cast<const T*>(edge_proj), senders, receivers,
                      edge_mask, ln_scale, ln_bias, alpha, w1, b1,
                      static_cast<T*>(e_out), static_cast<T*>(agg), e32, B, A,
                      E, M, H, f, smem, st);
  }
  float* out = static_cast<float*>(e_out);
  return launch_fwd(static_cast<const float*>(src_proj),
                    static_cast<const float*>(dst_proj),
                    static_cast<const float*>(edge_proj), senders, receivers,
                    edge_mask, ln_scale, ln_bias, alpha, w1, b1, out,
                    static_cast<float*>(agg), out, B, A, E, M, H, f, smem,
                    st);
}
