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
// What bounds it on an H100: operations. Two products of 2*B*E*M*H flops
// each (g_e @ W1 and g_e^T act; 0.8 GFLOP each per flagship batch of 8).
// The TPU kernel carried the parameter gradients in one VMEM block across its
// sequential grid; blocks on the card run in parallel and in no order, and
// float atomics would make the sums differ from run to run.
//
// Design, four deterministic passes in three launches (no float atomics,
// partials summed in a fixed order, so the gradients are bit-identical from
// run to run), the first two in two hand-written forms chosen by the widths
// alone (dostpu_fused_mp_bwd_form: the tensor-core form where M and H are
// multiples of 32 and a block of pass A fits in shared memory, e.g. M <= 1,024
// at H = M / 2; the generic form at every other width, so M = 1,088 to 1,216
// with H = M / 2, which only the generic pass A fits, still run):
//   A edge_bwd_tc_kernel (tensor-core form): the B*E edges are one flat
//     list cut into tiles of TE = 16 or 32. A block must stream all of W1
//     through its SM, which bounds a tile's time, so where tiles are few a
//     thread-block cluster of 2 or 4 blocks shares a tile and each takes
//     M / 2 or M / 4 of the columns (and of W1): pick_shape models the cost
//     (phDOS batch 8: 16 edges x 2 blocks = 128 blocks; batch 1: 16 x 4 = 32;
//     eDOS: 32 x 1 = 96). One warp per row recomputes mid -> LN -> PReLU
//     with 16-byte loads, all of a warp's rows in flight together: xhat
//     stays in shared memory, act goes to scratch; g_e is built in shared
//     memory ([TE][H + 4]) and scratch. g_act = g_e @ W1 runs as 3xTF32
//     mma.sync: W1 ([H, M], read as it lies) streams in [32 x 256] tiles
//     (rows padded to 264 floats: the B fragments walk down the rows;
//     16-row tiles, two k-steps a barrier, cost pass A 20% more time)
//     through a ring of 2 to 4 cp.async buffers, in flight during the
//     gather; each of the 8 warps owns 32 of a pass's 256 columns for all
//     TE rows; each tile's MMAs go to accumulators of their own, which a
//     rounded f32 add joins to the sum (the tensor core truncates). PReLU
//     and LN backward per row give g_ep; the two row sums LN' needs come
//     from every block of the cluster through distributed shared memory,
//     added in rank order. Per-block partial sums of the LN, alpha and b1
//     gradients go to scratch. Shared memory a block at M = 512, H = 256:
//     TE = 32 232,064 B (2 ring buffers; the card allows 232,448, which is
//     why g_act's rows are not padded and the row sums reuse the ring),
//     TE = 16 217,408 B (4 buffers); at M = 2,048, H = 1,024 TE = 16 would
//     need 395,584 B, so those widths take the generic form.
//     edge_bwd_kernel (generic form): a block per (16 edges, graph), the
//     product as FMA loops with a 4 x 4 register tile per thread
//     (2 * 16 * M + 16 * H + 8,216 floats of shared memory: 114,784 B
//     at M = 512, H = 256 and 360,544 B at M = 2,048, H = 1,024, which no
//     block gets: the wrapper refuses those widths by name).
//   B gw1_tc_kernel (tensor-core form): g_W1 = g_e^T act as a split-K
//     3xTF32 product: a block owns a [64 x 128] tile of g_W1 and one chunk of
//     the edges, its A fragments read transposed from the staged
//     [64 edges x 64] g_e tile, B fragments from the [64 edges x 128] act
//     tile (rows padded to 72 and 136 floats), three cp.async buffers
//     (159,744 B); the split count gives every SM a block (128 blocks at
//     the flagship widths).
//     gw1_kernel (generic form): [64 x 64] FMA tiles over 768-edge chunks.
//   C + D tail_kernel, one launch with two roles. C: one block per (node,
//     graph, 256 columns) lists the edges whose sender or receiver is that
//     node, in edge order (a ballot and a prefix sum per 256 edges), and
//     sums their g_mid rows into g_sp / g_dp, four slices of its threads
//     taking every fourth row and the slices added in order. Every edge scatters, pad edges
//     (index 0, mask 0) included, as the TPU kernel's one-hot products do;
//     an out-of-range index reaches no node. D: the other blocks sum the
//     partials in a fixed order (8 threads a column over the blocks of
//     pass A, then a fixed tree).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "fused_mp_core.cuh"

namespace {

constexpr int kTileE = 16;     // edges per block in pass A
constexpr int kThreads = 256;  // 8 warps
constexpr int kTileMo = 256;   // g_act columns per pass
constexpr int kTileHr = 32;    // W1 rows per shared-memory chunk
constexpr int kGemmTile = 64;  // g_W1 output tile (h x m)
constexpr int kGemmK = 16;     // edges per g_W1 shared-memory chunk
constexpr int kGemmEdges = 768;  // edges per g_W1 partial
using mp::kLnEps;
using mp::warp_sum;

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

// ---- the tensor-core form -------------------------------------------------

constexpr int kTcRowsW = 32;    // W1 rows (the contraction) per staged tile
constexpr int kTcMaxCluster = 4;  // blocks that may share an edge tile
constexpr int kTcTileH = 64;    // g_W1 tile: rows (h)
constexpr int kTcTileM = 128;   //            columns (m)
constexpr int kTcEdges = 64;    // edges per staged g_W1 chunk
constexpr int kTcStrideG = kTcTileH + 8;  // floats per staged g_e row
constexpr int kTcStrideA = kTcTileM + 8;  // floats per staged act row
constexpr int kTcGemmStages = 3;
constexpr size_t kTcGemmSmem = (size_t)kTcGemmStages * kTcEdges
                               * (kTcStrideG + kTcStrideA) * sizeof(float);
constexpr float kTcGatherCost = 1.0f;  // the cost model's clocks an element
constexpr float kTcMac[2] = {0.0070f, 0.0050f};  // ... a multiply-add, MT 1, 2

// columns of g_act a pass covers: 32 a warp, 16 where four blocks share a tile
int tc_pass_columns(int cluster) { return cluster == 4 ? 128 : 256; }

// floats of pass A's block before the W1 ring: xhat, g_act, g_e, rstd (the
// warps' alpha sums and the row sums the blocks of a cluster hand each other
// take the ring's place once the product is done)
size_t tc_fixed_floats(int mt, int M, int H) {
  const size_t te = 16 * mt;
  return 2 * te * M + te * (H + 4) + te;
}

size_t tc_stage_bytes(int cluster) {
  return (size_t)kTcRowsW * (tc_pass_columns(cluster) + 8) * sizeof(float);
}

// stages of the W1 ring: as many as fit, at most 4, at least 2; 0 when two
// do not fit
int tc_stages(int mt, int cluster, int M, int H) {
  const size_t fixed = tc_fixed_floats(mt, M, H) * sizeof(float);
  for (int stages = 4; stages >= 2; --stages)
    if (fixed + stages * tc_stage_bytes(cluster) <= mp::kSmemMax) return stages;
  return 0;
}

size_t tc_smem_bytes(int mt, int cluster, int M, int H) {
  return tc_fixed_floats(mt, M, H) * sizeof(float)
         + std::max(2, tc_stages(mt, cluster, M, H)) * tc_stage_bytes(cluster);
}

// whether `cluster` blocks can share the columns of a tile of 16 mt edges:
// each takes whole passes; only tiles of 16 edges are shared (the cost model
// never takes 32 edges by two blocks, and 32 by four measured slower than 16
// by four at every shape)
bool tc_shape_ok(int mt, int cluster, int M) {
  if (cluster == 1) return true;
  return mt == 1 && M % (cluster * tc_pass_columns(cluster)) == 0;
}

// Pass A's shape: 16 or 32 edges a tile (MT = 1 or 2) and 1, 2 or 4 blocks
// (a cluster) that split the tile's M columns. Every block streams its share
// of W1 through its SM and repeats the tile's gather; the model takes the
// shape whose blocks cost an SM the least (an SM gets ceil(blocks / 132)).
// False, and (1, 1), when no shape fits in shared memory.
bool pick_shape(int N, int M, int H, int* mt_out, int* cluster_out) {
  *mt_out = 1;
  *cluster_out = 1;
  float best_cost = -1.f;
  for (int mt = 2; mt >= 1; --mt)
    for (int cluster = 1; cluster <= kTcMaxCluster; cluster *= 2) {
      if (!tc_shape_ok(mt, cluster, M) || !tc_stages(mt, cluster, M, H))
        continue;
      const long blocks = (long)mp::ceil_div(N, 16 * mt) * cluster;
      const float per_sm = (float)mp::ceil_div(blocks, mp::kSMs);
      const float cost = per_sm * 16 * mt * (float)M
                         * (kTcGatherCost + H * kTcMac[mt - 1] / cluster);
      if (best_cost < 0.f || cost < best_cost) {
        *mt_out = mt;
        *cluster_out = cluster;
        best_cost = cost;
      }
    }
  return best_cost >= 0.f;
}

bool tc_widths(int M, int H) {
  return M > 0 && H > 0 && M % 32 == 0 && H % 32 == 0;
}

// edges per g_W1 partial: enough splits for a block on every SM (one wave),
// at most 64 of them, whole staged chunks
int tc_gemm_chunk(int N, int M, int H) {
  const int tiles = mp::ceil_div(M, kTcTileM) * mp::ceil_div(H, kTcTileH);
  const int want = std::min(64, std::max(1, mp::kSMs / tiles));
  const int chunk = mp::ceil_div(mp::ceil_div(N, want), kTcEdges) * kTcEdges;
  return std::max(chunk, kTcEdges);
}

// MT m16 row tiles (TE = 16 MT edges) and NT n8 column tiles a warp; the
// blocks of a cluster (1, 2 or 4, the launch's cluster dimension) own
// M / cluster columns each of the same TE edges.
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads)
edge_bwd_tc_kernel(const float* __restrict__ sp, const float* __restrict__ dp,
                   const float* __restrict__ ep,
                   const int* __restrict__ senders,
                   const int* __restrict__ receivers,
                   const float* __restrict__ mask,
                   const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias,
                   const float* __restrict__ alpha,
                   const float* __restrict__ w1,
                   const float* __restrict__ g_eout,
                   const float* __restrict__ g_agg, float* __restrict__ g_ep,
                   float* __restrict__ act_out, float* __restrict__ ge_out,
                   float* __restrict__ part_lns, float* __restrict__ part_lnb,
                   float* __restrict__ part_b1, float* __restrict__ part_alpha,
                   int N, int A, int E, int M, int H, int stages) {
  namespace cg = cooperative_groups;
  constexpr int TE = 16 * MT;
  constexpr int PW = mp::kWarps * NT * 8;  // g_act columns a pass
  constexpr int WS = PW + 8;               // floats per staged W1 row
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) float tc_smem[];
  const int GA = M;      // g_act row stride (no padding: it would not fit)
  const int GS = H + 4;  // g_e row stride (A fragments on 32 banks)
  float* xhat_s = tc_smem;             // [TE][M]
  float* gact_s = xhat_s + TE * M;     // [TE][GA]: g_act, then g_norm
  float* ge_s = gact_s + TE * GA;      // [TE][GS]
  float* rstd_s = ge_s + TE * GS;      // [TE]
  float* w_s = rstd_s + TE;            // [stages][kTcRowsW][WS]
  // after the product the ring is dead and holds:
  float* alpha_s = w_s;                    // [kWarps]
  float* rowsum_s = alpha_s + mp::kWarps;  // [kTcMaxCluster][TE][2]
  const int blk = blockIdx.x / cs;
  const int n0 = blk * TE;
  const int c_begin = cs == 1 ? 0 : rank * (M / cs);  // this block's columns
  const int c_end = cs == 1 ? M : c_begin + M / cs;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float slope = alpha[0];
  const int nk = H / kTcRowsW;
  const int ntile = ((c_end - c_begin + PW - 1) / PW) * nk;

  // tile it = (pass, k): W1[32 k .. 32 k + 32, pass's columns] -> buffer
  // it % stages; columns at or past c_end are zero-filled
  auto stage = [&](int it) {
    const int m0 = c_begin + (it / nk) * PW;
    const int k0 = (it % nk) * kTcRowsW;
    float* dst = w_s + (it % stages) * (kTcRowsW * WS);
    for (int idx = threadIdx.x; idx < kTcRowsW * (PW / 4); idx += kThreads) {
      const int r = idx / (PW / 4);
      const int q = idx % (PW / 4);
      const bool ok = m0 + 4 * q < c_end;
      mp::cp_async16(dst + r * WS + 4 * q,
                     w1 + (size_t)(k0 + r) * M + (ok ? m0 + 4 * q : 0), ok);
    }
  };
  for (int it = 0; it < stages - 1; ++it) {  // in flight during the gather
    if (it < ntile) stage(it);
    mp::cp_async_commit();
  }
  cluster.sync();  // every block of the cluster runs: its memory can be written

  // 1. recompute mid -> LN -> PReLU (one warp per row; every block of a
  //    cluster needs the whole row for its statistics) and build g_e. The
  //    row loops here and in step 3 are not unrolled: unrolled four times
  //    (TE = 32) they cost this kernel 25%, measured.
#pragma unroll 1
  for (int i = warp; i < TE; i += mp::kWarps) {
    float* xrow = xhat_s + i * M;
    float* grow = ge_s + i * GS;
    if (n0 + i >= N) {  // past the last edge: a zero row contributes nothing
      for (int m = lane; m < M; m += 32) xrow[m] = 0.f;
      for (int h = lane; h < H; h += 32) grow[h] = 0.f;
      if (lane == 0) rstd_s[i] = 0.f;
      continue;
    }
    const size_t n = (size_t)(n0 + i);
    const mp::RowStats st = mp::gather_mid_row(sp, dp, ep, senders, receivers,
                                               n, A, E, M, lane, xrow);
    const int r = receivers[n];
    const bool r_ok = r >= 0 && r < A;
    const float mk = r_ok ? mask[n] : 0.f;
    const float* ga_row = g_agg + ((n / E) * A + (r_ok ? r : 0)) * H;
    for (int j = lane; j < H / 4; j += 32) {
      float4 v = mp::ld4(g_eout + n * H, j);
      const float4 ga = mp::ld4(ga_row, j);
      v.x += mk * ga.x;
      v.y += mk * ga.y;
      v.z += mk * ga.z;
      v.w += mk * ga.w;
      mp::st4(grow, j, v);
      if (rank == 0) mp::st4(ge_out + n * H, j, v);
    }
    // this block's columns only: the others' xhat is never read again
    for (int j = c_begin / 4 + lane; j < c_end / 4; j += 32) {
      float4 x = mp::ld4(xrow, j);
      const float4 sc = mp::ld4(ln_scale, j);
      const float4 bi = mp::ld4(ln_bias, j);
      x.x = (x.x - st.mean) * st.rstd;
      x.y = (x.y - st.mean) * st.rstd;
      x.z = (x.z - st.mean) * st.rstd;
      x.w = (x.w - st.mean) * st.rstd;
      mp::st4(xrow, j, x);
      float4 a;
      a.x = x.x * sc.x + bi.x;
      a.y = x.y * sc.y + bi.y;
      a.z = x.z * sc.z + bi.z;
      a.w = x.w * sc.w + bi.w;
      a.x = a.x > 0.f ? a.x : slope * a.x;
      a.y = a.y > 0.f ? a.y : slope * a.y;
      a.z = a.z > 0.f ? a.z : slope * a.z;
      a.w = a.w > 0.f ? a.w : slope * a.w;
      mp::st4(act_out + n * M, j, a);
    }
    if (lane == 0) rstd_s[i] = st.rstd;
  }

  // 2. g_act = g_e @ W1 for this block's columns: every warp owns all TE
  //    rows and 8 NT of a pass's columns
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][NT][4];
  for (int it = 0; it < ntile; ++it) {
    mp::ring_wait(stages);
    __syncthreads();  // tile it (and, first, g_e) is complete; it - 1 consumed
    if (it + stages - 1 < ntile) stage(it + stages - 1);
    mp::cp_async_commit();
    const int k = it % nk;
    const int col = c_begin + (it / nk) * PW + warp * (8 * NT);
    if (col >= c_end) continue;  // the same for a whole warp
    if (k == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
    const float* wt = w_s + (it % stages) * (kTcRowsW * WS) + warp * (8 * NT);
    // the tile's own accumulators: the tensor core truncates when it adds
    // into an accumulator, so long chains drift; acc takes each tile's sum
    // with a rounded f32 add
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTcRowsW / 8; ++ks) {
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mp::load_a(ge_s + mt * 16 * GS, GS, g, k * kTcRowsW + 8 * ks + t,
                   a_hi[mt], a_lo[mt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* wr = wt + (8 * ks + t) * WS + 8 * nt + g;
        uint32_t b_hi[2], b_lo[2];
        mp::split_tf32(wr[0], b_hi[0], b_lo[0]);
        mp::split_tf32(wr[4 * WS], b_hi[1], b_lo[1]);
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
    if (k == nk - 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* at = gact_s + (mt * 16 + g) * GA + col + 8 * nt + 2 * t;
          *reinterpret_cast<float2*>(at) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<float2*>(at + 8 * GA) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
    }
  }
  __syncthreads();
  // the row sums below land in the W1 ring of every block of the cluster:
  // none may still be multiplying from it
  if (cs > 1) cluster.sync();

  // 3. PReLU and LayerNorm backward, one warp per row, over this block's
  //    columns; g_norm replaces g_act in shared memory for the column sums
  //    below. LN' needs two sums over the WHOLE row: every block writes its
  //    columns' share into every block of the cluster (distributed shared
  //    memory), and after the cluster's barrier each adds the shares in
  //    rank order.
  float pa = 0.f;
#pragma unroll 1
  for (int i = warp; i < TE; i += mp::kWarps) {
    const float* xrow = xhat_s + i * M;
    float* grow = gact_s + i * GA;
    float s1 = 0.f, s2 = 0.f;
    for (int j = c_begin / 4 + lane; j < c_end / 4; j += 32) {
      const float4 xh = mp::ld4(xrow, j);
      const float4 sc = mp::ld4(ln_scale, j);
      const float4 bi = mp::ld4(ln_bias, j);
      float4 ga = mp::ld4(grow, j);
      auto element = [&](float x, float scale, float bias, float& g_io) {
        const float nm = x * scale + bias;
        const bool pos = nm > 0.f;
        pa += pos ? 0.f : g_io * nm;
        g_io = pos ? g_io : slope * g_io;  // g_act -> g_norm
        const float gx = g_io * scale;
        s1 += gx;
        s2 += gx * x;
      };
      element(xh.x, sc.x, bi.x, ga.x);
      element(xh.y, sc.y, bi.y, ga.y);
      element(xh.z, sc.z, bi.z, ga.z);
      element(xh.w, sc.w, bi.w, ga.w);
      mp::st4(grow, j, ga);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane < cs) {  // lane p writes block p's copy
      float* to = cluster.map_shared_rank(rowsum_s, lane) + (rank * TE + i) * 2;
      to[0] = s1;
      to[1] = s2;
    }
  }
  cluster.sync();  // no block touches another's memory after this
#pragma unroll 1
  for (int i = warp; i < TE; i += mp::kWarps) {
    if (n0 + i >= N) continue;
    float s1 = 0.f, s2 = 0.f;
    for (int p = 0; p < cs; ++p) {
      s1 += rowsum_s[(p * TE + i) * 2];
      s2 += rowsum_s[(p * TE + i) * 2 + 1];
    }
    s1 /= M;
    s2 /= M;
    const float* xrow = xhat_s + i * M;
    const float* grow = gact_s + i * GA;
    const float rstd = rstd_s[i];
    float* out = g_ep + (size_t)(n0 + i) * M;
    for (int j = c_begin / 4 + lane; j < c_end / 4; j += 32) {
      const float4 xh = mp::ld4(xrow, j);
      const float4 sc = mp::ld4(ln_scale, j);
      const float4 gn = mp::ld4(grow, j);
      float4 o;
      o.x = rstd * (gn.x * sc.x - s1 - xh.x * s2);
      o.y = rstd * (gn.y * sc.y - s1 - xh.y * s2);
      o.z = rstd * (gn.z * sc.z - s1 - xh.z * s2);
      o.w = rstd * (gn.w * sc.w - s1 - xh.w * s2);
      mp::st4(out, j, o);
    }
  }
  pa = warp_sum(pa);
  if (lane == 0) alpha_s[warp] = pa;
  __syncthreads();

  // 4. this block's partial sums of the parameter gradients: its columns of
  //    the tile's LN rows, its share of alpha, and (rank 0) b1
  for (int m = c_begin + threadIdx.x; m < c_end; m += kThreads) {
    float sl = 0.f, sb = 0.f;
    for (int i = 0; i < TE; ++i) {
      const float gn = gact_s[i * GA + m];
      sl = fmaf(gn, xhat_s[i * M + m], sl);
      sb += gn;
    }
    part_lns[(size_t)blk * M + m] = sl;
    part_lnb[(size_t)blk * M + m] = sb;
  }
  if (rank == 0) {
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float s = 0.f;
      for (int i = 0; i < TE; ++i) s += ge_s[i * GS + h];
      part_b1[(size_t)blk * H + h] = s;
    }
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < mp::kWarps; ++w) s += alpha_s[w];
    part_alpha[blockIdx.x] = s;
  }
}

// part[s, h, m] = sum over edges n of chunk s of ge[n, h] * act[n, m], on
// the tensor cores: warp (wh, wm) of 2 x 4 owns a [32 x 32] piece of the
// block's [64 x 128] tile
__global__ void __launch_bounds__(kThreads)
gw1_tc_kernel(const float* __restrict__ ge, const float* __restrict__ act,
              float* __restrict__ part, int N, int M, int H, int chunk) {
  extern __shared__ __align__(16) float tc_smem[];
  constexpr int kStage = kTcEdges * (kTcStrideG + kTcStrideA);
  const int m0 = blockIdx.x * kTcTileM;
  const int h0 = blockIdx.y * kTcTileH;
  const int split = blockIdx.z;
  const int n_begin = split * chunk;
  const int n_end = min(N, n_begin + chunk);
  const int ntile = (n_end - n_begin + kTcEdges - 1) / kTcEdges;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wh = warp / 4, wm = warp % 4;

  // edges [n_begin + 64 it, + 64): their g_e columns [h0, h0 + 64) and act
  // columns [m0, m0 + 128) -> buffer it % 3; zeros past the chunk's end and
  // past H or M
  auto stage = [&](int it) {
    float* g_dst = tc_smem + (it % kTcGemmStages) * kStage;
    float* a_dst = g_dst + kTcEdges * kTcStrideG;
    const int nb = n_begin + it * kTcEdges;
    for (int idx = threadIdx.x; idx < kTcEdges * (kTcTileH / 4);
         idx += kThreads) {
      const int r = idx / (kTcTileH / 4);
      const int q = idx % (kTcTileH / 4);
      const bool ok = nb + r < n_end && h0 + 4 * q < H;
      mp::cp_async16(g_dst + r * kTcStrideG + 4 * q,
                     ge + (ok ? (size_t)(nb + r) * H + h0 + 4 * q : 0), ok);
    }
    for (int idx = threadIdx.x; idx < kTcEdges * (kTcTileM / 4);
         idx += kThreads) {
      const int r = idx / (kTcTileM / 4);
      const int q = idx % (kTcTileM / 4);
      const bool ok = nb + r < n_end && m0 + 4 * q < M;
      mp::cp_async16(a_dst + r * kTcStrideA + 4 * q,
                     act + (ok ? (size_t)(nb + r) * M + m0 + 4 * q : 0), ok);
    }
  };
  for (int it = 0; it < kTcGemmStages - 1; ++it) {
    if (it < ntile) stage(it);
    mp::cp_async_commit();
  }
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int it = 0; it < ntile; ++it) {
    mp::cp_async_wait<kTcGemmStages - 2>();
    __syncthreads();  // tile it is complete; it - 1 is consumed
    if (it + kTcGemmStages - 1 < ntile) stage(it + kTcGemmStages - 1);
    mp::cp_async_commit();
    const float* g_t = tc_smem + (it % kTcGemmStages) * kStage + wh * 32;
    const float* a_t = tc_smem + (it % kTcGemmStages) * kStage
                       + kTcEdges * kTcStrideG + wm * 32;
    float tile[2][4][4];  // this tile's sum; acc takes it with a rounded add
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) tile[mt][nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTcEdges / 8; ++ks) {
      // A = g_e^T: row h, contraction index the edge
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* at = g_t + (8 * ks + t) * kTcStrideG + 16 * mt + g;
        mp::split_tf32(at[0], a_hi[mt][0], a_lo[mt][0]);
        mp::split_tf32(at[8], a_hi[mt][1], a_lo[mt][1]);
        mp::split_tf32(at[4 * kTcStrideG], a_hi[mt][2], a_lo[mt][2]);
        mp::split_tf32(at[4 * kTcStrideG + 8], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* bt = a_t + (8 * ks + t) * kTcStrideA + 8 * nt + g;
        uint32_t b_hi[2], b_lo[2];
        mp::split_tf32(bt[0], b_hi[0], b_lo[0]);
        mp::split_tf32(bt[4 * kTcStrideA], b_hi[1], b_lo[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {  // the small terms first
          mp::mma_tf32(tile[mt][nt], a_lo[mt], b_hi[0], b_hi[1]);
          mp::mma_tf32(tile[mt][nt], a_hi[mt], b_lo[0], b_lo[1]);
          mp::mma_tf32(tile[mt][nt], a_hi[mt], b_hi[0], b_hi[1]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += tile[mt][nt][i];
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int h = h0 + wh * 32 + 16 * mt + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = m0 + wm * 32 + 8 * nt + 2 * t;
      if (m >= M) continue;
      float* at = part + ((size_t)split * H + h) * M + m;
      if (h < H)
        *reinterpret_cast<float2*>(at) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (h + 8 < H)
        *reinterpret_cast<float2*>(at + (size_t)8 * M) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// One launch, two roles by block index. Blocks [0, node_blocks): one per
// (node, graph, 256 columns), lists the edges whose sender or receiver is
// that node in edge order and sums their g_mid rows into g_sp / g_dp (four
// slices of threads take every fourth listed row, four columns a thread;
// fixed order). The
// rest sum the partials in a fixed order: g_W1 over its splits (one thread
// an element), and the LN, b1 and alpha gradients over the blocks of pass A,
// 32 columns a block, 8 threads a column taking every 8th partial and a
// fixed tree over the 8.
__global__ void __launch_bounds__(kThreads)
tail_kernel(const float* __restrict__ g_mid, const int* __restrict__ senders,
            const int* __restrict__ receivers, float* __restrict__ g_sp,
            float* __restrict__ g_dp, int A, int E, int M, int node_blocks,
            const float* __restrict__ part_lns,
            const float* __restrict__ part_lnb,
            const float* __restrict__ part_b1,
            const float* __restrict__ part_alpha,
            const float* __restrict__ part_w1, float* __restrict__ g_lns,
            float* __restrict__ g_lnb, float* __restrict__ g_b1,
            float* __restrict__ g_alpha, float* __restrict__ g_w1, int nblk,
            int nalpha, int splits, int H, int w1_blocks) {
  __shared__ int s_list[kThreads];
  __shared__ int r_list[kThreads];
  __shared__ int s_counts[mp::kWarps];
  __shared__ int r_counts[mp::kWarps];
  __shared__ float red[mp::kScatterSlices][kThreads];
  int bid = blockIdx.x;
  if (bid < node_blocks) {
    const int mz = (M + kThreads - 1) / kThreads;
    const int m0 = (bid % mz) * kThreads;
    const int node = (bid / mz) % A;
    const int b = bid / (mz * A);
    const int lane = threadIdx.x % mp::kScatterLanes;
    const int slice = threadIdx.x / mp::kScatterLanes;
    const size_t base = (size_t)b * E;
    const auto one = [](size_t) { return 1.f; };
    float acc_s[mp::kScatterSlices] = {0.f, 0.f, 0.f, 0.f};
    float acc_r[mp::kScatterSlices] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < E; c0 += kThreads) {
      const int e = c0 + threadIdx.x;
      const bool hs = e < E && senders[base + e] == node;
      const bool hr = e < E && receivers[base + e] == node;
      const int ns = mp::compact_matches(hs, e, s_list, s_counts);
      const int nr = mp::compact_matches(hr, e, r_list, r_counts);
      mp::sum_listed_rows(g_mid, base, s_list, ns, M, m0, lane, slice, one,
                          acc_s);
      mp::sum_listed_rows(g_mid, base, r_list, nr, M, m0, lane, slice, one,
                          acc_r);
    }
    const size_t out = ((size_t)b * A + node) * M;
    mp::store_slice_sums(acc_s, red, g_sp + out, M, m0, lane, slice);
    mp::store_slice_sums(acc_r, red, g_dp + out, M, m0, lane, slice);
    return;
  }
  bid -= node_blocks;
  const size_t hm = (size_t)H * M;
  if (bid < w1_blocks) {
    for (size_t t = (size_t)bid * kThreads + threadIdx.x; t < hm;
         t += (size_t)w1_blocks * kThreads) {
      float s = 0.f;
      for (int k = 0; k < splits; ++k) s += part_w1[k * hm + t];
      g_w1[t] = s;
    }
    return;
  }
  // columns: g_ln_scale [M], g_ln_bias [M], g_b1 [H], g_alpha [1]
  const int lane = threadIdx.x % 32;
  const int slice = threadIdx.x / 32;
  const int col = (bid - w1_blocks) * 32 + lane;
  const float* src = nullptr;
  float* dst = nullptr;
  int stride = 0, count = nblk;
  if (col < M) {
    src = part_lns + col, dst = g_lns + col, stride = M;
  } else if (col < 2 * M) {
    src = part_lnb + col - M, dst = g_lnb + col - M, stride = M;
  } else if (col < 2 * M + H) {
    src = part_b1 + col - 2 * M, dst = g_b1 + col - 2 * M, stride = H;
  } else if (col == 2 * M + H) {
    src = part_alpha, dst = g_alpha, stride = 1, count = nalpha;
  }
  float s = 0.f;
  if (src != nullptr)
    for (int k = slice; k < count; k += mp::kWarps)
      s += src[(size_t)k * stride];
  float* sums = &red[0][0];  // [kWarps][32]
  sums[slice * 32 + lane] = s;
  __syncthreads();
  if (slice == 0 && dst != nullptr) {
    float total = sums[lane];
    for (int w = 1; w < mp::kWarps; ++w) total += sums[w * 32 + lane];
    *dst = total;
  }
}

// what one call launches: the form (0 generic, else the tensor-core form's
// MT and cluster size), the blocks of pass A, the partials of alpha, and the
// g_W1 splits with their edges each
struct Plan {
  int mt, cluster, nblk, nalpha, splits, chunk;
};

}  // namespace

// Which hand-written form of the backward these widths take: 1 the
// tensor-core form (M and H multiples of 32, and some shape of pass A fits
// in a block's shared memory: which shapes fit depends on the widths only),
// 0 the generic form.
extern "C" int dostpu_fused_mp_bwd_form(int M, int H) {
  int mt, cluster;
  return tc_widths(M, H) && pick_shape(1, M, H, &mt, &cluster) ? 1 : 0;
}

namespace {

// `form` as the entry points take it; mt = -1 when it is no form of these
// widths
Plan make_plan(int form, int B, int E, int M, int H) {
  const int N = B * E;
  if (form < 0) form = dostpu_fused_mp_bwd_form(M, H);
  Plan p{0, 1, 0, 0, 0, 0};
  if (form == 0) {
    p.nblk = p.nalpha = B * ((E + kTileE - 1) / kTileE);
    p.splits = gemm_splits(N);
    p.chunk = (N + p.splits - 1) / p.splits;
    return p;
  }
  p.mt = -1;
  if (form != 1 || !tc_widths(M, H)) return p;
  pick_shape(N, M, H, &p.mt, &p.cluster);
  p.nblk = mp::ceil_div(N, 16 * p.mt);
  p.nalpha = p.nblk * p.cluster;
  p.chunk = tc_gemm_chunk(N, M, H);
  p.splits = mp::ceil_div(N, p.chunk);
  return p;
}

template <int MT, int NT>
cudaError_t launch_edge_bwd_tc(
    const float* sp, const float* dp, const float* ep, const int* senders,
    const int* receivers, const float* mask, const float* ln_scale,
    const float* ln_bias, const float* alpha, const float* w1,
    const float* g_eout, const float* g_agg, float* g_ep, float* act,
    float* ge, float* part_lns, float* part_lnb, float* part_b1,
    float* part_alpha, int N, int A, int E, int M, int H, const Plan& plan,
    cudaStream_t st) {
  const size_t smem = tc_smem_bytes(MT, plan.cluster, M, H);
  auto kernel = edge_bwd_tc_kernel<MT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(plan.nblk * plan.cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const int stages = std::max(2, tc_stages(MT, plan.cluster, M, H));
  return cudaLaunchKernelEx(&config, kernel, sp, dp, ep, senders, receivers,
                            mask, ln_scale, ln_bias, alpha, w1, g_eout, g_agg,
                            g_ep, act, ge, part_lns, part_lnb, part_b1,
                            part_alpha, N, A, E, M, H, stages);
}

}  // namespace

// Shared memory a block of pass A asks for. `form`: -1 the widths' own
// form (dostpu_fused_mp_bwd_form), 0 the generic form, 1 the tensor-core
// form (widths that are multiples of 32 only) in the shape the cost model
// picks.
extern "C" size_t dostpu_fused_mp_edge_bwd_smem_bytes(int B, int E, int M,
                                                      int H, int form) {
  const Plan p = make_plan(form, B, E, M, H);
  if (p.mt == 0) return edge_smem_floats(M, H) * sizeof(float);
  if (p.mt < 0) return tc_smem_bytes(1, 1, M, H);
  return tc_smem_bytes(p.mt, p.cluster, M, H);
}

// what a call at this shape launches: the edges of a tile of pass A (*te),
// the blocks of the cluster that shares it (*cluster) and the g_W1 splits
extern "C" void dostpu_fused_mp_edge_bwd_tile(int B, int E, int M, int H,
                                              int form, int* te, int* cluster,
                                              int* splits) {
  const Plan p = make_plan(form, B, E, M, H);
  *te = p.mt <= 0 ? kTileE : 16 * p.mt;
  *cluster = p.cluster;
  *splits = p.splits;
}

// Floats of device scratch the backward needs (the wrapper allocates them):
// act [B*E, M], g_e [B*E, H], and the per-block and per-split partials.
extern "C" size_t dostpu_fused_mp_edge_bwd_scratch_floats(int B, int E, int M,
                                                         int H, int form) {
  const Plan p = make_plan(form, B, E, M, H);
  const size_t n = (size_t)B * E;
  return n * M + n * H + (size_t)p.nblk * (2 * (size_t)M + H) + p.nalpha + 4
         + (size_t)p.splits * H * M;
}

// All pointers are device pointers into contiguous float32 (int32 for the
// indices) tensors. Inputs as the forward's (src_proj/dst_proj [B, A, M],
// edge_proj [B, E, M], senders/receivers/edge_mask [B, E], ln_scale/ln_bias
// [M], alpha [1], w1 [H, M]) plus g_eout [B, E, H] and g_agg [B, A, H];
// outputs g_src_proj/g_dst_proj [B, A, M], g_edge_proj [B, E, M],
// g_ln_scale/g_ln_bias [M], g_alpha [1], g_w1 [H, M], g_b1 [H]; scratch of
// dostpu_fused_mp_edge_bwd_scratch_floats floats (same form). Returns the
// CUDA error code of the launches (0 on success).
extern "C" int dostpu_fused_mp_edge_bwd(
    const float* src_proj, const float* dst_proj, const float* edge_proj,
    const int* senders, const int* receivers, const float* edge_mask,
    const float* ln_scale, const float* ln_bias, const float* alpha,
    const float* w1, const float* g_eout, const float* g_agg, float* g_sp,
    float* g_dp, float* g_ep, float* g_lns, float* g_lnb, float* g_alpha,
    float* g_w1, float* g_b1, float* scratch, int B, int A, int E, int M,
    int H, int form, void* stream) {
  if (B <= 0 || A <= 0 || E <= 0 || M <= 0 || H <= 0 || B > 65535
      || (long)B * E > 0x7fffffffL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan plan = make_plan(form, B, E, M, H);
  if (plan.mt < 0) return cudaErrorInvalidValue;
  const int n = B * E;
  float* act = scratch;
  float* ge = act + (size_t)n * M;
  float* part_lns = ge + (size_t)n * H;
  float* part_lnb = part_lns + (size_t)plan.nblk * M;
  float* part_b1 = part_lnb + (size_t)plan.nblk * M;
  float* part_alpha = part_b1 + (size_t)plan.nblk * H;
  float* part_w1 = part_alpha + plan.nalpha;
  // the partials of g_W1 are written as float2: keep them 16-byte aligned
  part_w1 += (4 - (part_w1 - scratch) % 4) % 4;

  cudaError_t err;
  if (plan.mt == 0) {
    const size_t smem = edge_smem_floats(M, H) * sizeof(float);
    err = cudaFuncSetAttribute(
        edge_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    edge_bwd_kernel<<<dim3(plan.nblk / B, B), kThreads, smem, st>>>(
        src_proj, dst_proj, edge_proj, senders, receivers, edge_mask,
        ln_scale, ln_bias, alpha, w1, g_eout, g_agg, g_ep, act, ge, part_lns,
        part_lnb, part_b1, part_alpha, A, E, M, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid_w((M + kGemmTile - 1) / kGemmTile,
                      (H + kGemmTile - 1) / kGemmTile, plan.splits);
    gw1_kernel<<<grid_w, kThreads, 0, st>>>(ge, act, part_w1, n, M, H,
                                            plan.chunk);
  } else {
#define DOSTPU_LAUNCH_EDGE(MT, NT)                                            \
  launch_edge_bwd_tc<MT, NT>(src_proj, dst_proj, edge_proj, senders,         \
                             receivers, edge_mask, ln_scale, ln_bias, alpha, \
                             w1, g_eout, g_agg, g_ep, act, ge, part_lns,     \
                             part_lnb, part_b1, part_alpha, n, A, E, M, H,   \
                             plan, st)
    if (plan.cluster == 4)  // 16 edges, 128 columns a pass: 16 a warp
      err = DOSTPU_LAUNCH_EDGE(1, 2);
    else
      err = plan.mt == 2 ? DOSTPU_LAUNCH_EDGE(2, 4) : DOSTPU_LAUNCH_EDGE(1, 4);
#undef DOSTPU_LAUNCH_EDGE
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        gw1_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kTcGemmSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid_w(mp::ceil_div(M, kTcTileM), mp::ceil_div(H, kTcTileH),
                      plan.splits);
    gw1_tc_kernel<<<grid_w, kThreads, kTcGemmSmem, st>>>(ge, act, part_w1, n,
                                                         M, H, plan.chunk);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int node_blocks = B * A * ((M + kThreads - 1) / kThreads);
  const int w1_blocks = (int)std::min(
      ((size_t)H * M + kThreads - 1) / kThreads, (size_t)512);
  const int small_blocks = (2 * M + H + 1 + 31) / 32;
  tail_kernel<<<node_blocks + w1_blocks + small_blocks, kThreads, 0, st>>>(
      g_ep, senders, receivers, g_sp, g_dp, A, E, M, node_blocks, part_lns,
      part_lnb, part_b1, part_alpha, part_w1, g_lns, g_lnb, g_b1, g_alpha,
      g_w1, plan.nblk, plan.nalpha, plan.splits, H, w1_blocks);
  return cudaGetLastError();
}
