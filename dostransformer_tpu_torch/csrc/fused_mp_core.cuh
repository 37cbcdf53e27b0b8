// Building blocks the fused message-passing kernels share (fused_mp.cu,
// fused_mp_bwd.cu). Nothing here launches. The tensor-core products come
// from attention_core.cuh: 3xTF32 mma.sync.m16n8k8 with f32 accumulators
// (mma_tf32) and cp.async 16-byte copies; the operand split is this file's.
//
// Fragment reads and bank conflicts (g = lane / 4, t = lane % 4). A staged
// tile is read in one of two ways:
//   * (row g, column t): the fragment's rows are the tile's rows. Row
//     strides = 4 mod 32 floats put the 32 lanes on 32 banks (4 g + t).
//   * (row t, column g): the contraction index walks down the tile's rows.
//     Row strides = 8 mod 32 floats do the same (8 t + g).
// Each tile below is padded to the stride its reads need.

#pragma once

#include "attention_core.cuh"

namespace mp {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::mma_tf32;
using attn::warp_sum;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;
constexpr int kSMs = 132;
// most shared memory a block may ask for, and the most that lets two
// blocks share an SM (228 KB an SM, 1 KB reserved per block)
constexpr size_t kSmemMax = 227 * 1024;
constexpr size_t kSmemTwoBlocks = 113 * 1024;

// at most N of the calling thread's cp.async groups still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// every thread: the oldest group of a ring of `stages` (2 to 4) has landed
__device__ __forceinline__ void ring_wait(int stages) {
  if (stages == 4)
    cp_async_wait<2>();
  else if (stages == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// stages of a tile ring beside `fixed` bytes: 3 when two blocks still share
// an SM with them, else 2 under the same condition, else as many as fit one
// block; 0 when even two do not fit
inline int ring_stages(size_t fixed, size_t per_stage) {
  if (fixed + 3 * per_stage <= kSmemTwoBlocks) return 3;
  if (fixed + 2 * per_stage <= kSmemTwoBlocks) return 2;
  if (fixed + 3 * per_stage <= kSmemMax) return 3;
  return fixed + 2 * per_stage <= kSmemMax ? 2 : 0;
}

__device__ __forceinline__ float4 ld4(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}

__device__ __forceinline__ void st4(float* p, int i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}

// x = hi + lo for the 3xTF32 products, in two operations: hi is x cut to
// TF32's 10 mantissa bits and lo = x - hi, exact in f32. The tensor core
// reads only the top 19 bits of an operand, so lo goes in as it is and loses
// at most its last 3 bits: |x - (hi + lo as read)| < 2^-20 |x|, towards zero.
// (attention_core.cuh rounds both parts to nearest in four operations; these
// kernels split an operand per 1.5 MMAs, and the rounded split cost the
// forward 5% and the backward 3% more time at the eDOS shape for an error of
// 1.0e-6 instead of 1.3e-6 of the largest output, both measured.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the A fragment at rows g, g+8 and columns c, c+4 of a row-major tile
__device__ __forceinline__ void load_a(const float* tile, int stride, int g,
                                       int c, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32(tile[g * stride + c], hi[0], lo[0]);
  split_tf32(tile[(g + 8) * stride + c], hi[1], lo[1]);
  split_tf32(tile[g * stride + c + 4], hi[2], lo[2]);
  split_tf32(tile[(g + 8) * stride + c + 4], hi[3], lo[3]);
}

struct RowStats {
  float mean, rstd;
};

// One warp: mid = sp[sender] + dp[receiver] + ep of flat edge n (graph
// n / E) -> row[0, M) in shared memory (16-byte aligned, M % 4 == 0), with
// its LayerNorm statistics in two passes (mean, then centred variance). An
// out-of-range index adds a zero row.
__device__ __forceinline__ RowStats gather_mid_row(
    const float* __restrict__ sp, const float* __restrict__ dp,
    const float* __restrict__ ep, const int* __restrict__ senders,
    const int* __restrict__ receivers, size_t n, int A, int E, int M,
    int lane, float* row) {
  const size_t b = n / E;
  const int s = senders[n];
  const int r = receivers[n];
  const bool s_ok = s >= 0 && s < A;
  const bool r_ok = r >= 0 && r < A;
  const float* sp_row = sp + (b * A + (s_ok ? s : 0)) * M;
  const float* dp_row = dp + (b * A + (r_ok ? r : 0)) * M;
  const float* ep_row = ep + n * M;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float sum = 0.f;
  for (int i = lane; i < M / 4; i += 32) {
    const float4 a = s_ok ? ld4(sp_row, i) : zero;
    const float4 d = r_ok ? ld4(dp_row, i) : zero;
    float4 v = ld4(ep_row, i);
    v.x = (a.x + d.x) + v.x;
    v.y = (a.y + d.y) + v.y;
    v.z = (a.z + d.z) + v.z;
    v.w = (a.w + d.w) + v.w;
    st4(row, i, v);
    sum += (v.x + v.y) + (v.z + v.w);
  }
  RowStats st;
  st.mean = warp_sum(sum) / M;
  float sq = 0.f;
  for (int i = lane; i < M / 4; i += 32) {
    const float4 v = ld4(row, i);
    const float dx = v.x - st.mean, dy = v.y - st.mean;
    const float dz = v.z - st.mean, dw = v.w - st.mean;
    sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
  }
  st.rstd = 1.f / sqrtf(warp_sum(sq) / M + kLnEps);
  return st;
}

// Every thread of a kThreads block calls this with its own `match`: the
// `value`s of the matching threads land in list[] in thread order (so edge
// order is kept and a sum over the list has a fixed order); returns how
// many. list holds kThreads ints, counts kWarps; both shared.
__device__ __forceinline__ int compact_matches(bool match, int value,
                                               int* list, int* counts) {
  const unsigned ballot = __ballot_sync(0xffffffffu, match);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // the previous list is consumed
  if (lane == 0) counts[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = counts[w];
    base += w < warp ? c : 0;
    total += c;
  }
  if (match) list[base + __popc(ballot & ((1u << lane) - 1u))] = value;
  __syncthreads();
  return total;
}

// The scatter passes (agg_kernel, tail_kernel): a block of kThreads owns
// kThreads columns of one node's row. Its threads form kScatterSlices
// slices of kScatterLanes lanes; a lane owns the columns lane + 64 j of the
// block's 256, and slice s sums the listed rows s, s + 4, ... in order; the
// slices' sums are then added in slice order. A fixed order, a quarter of
// the serial length (pad edges all name node 0, whose list is the longest),
// four independent loads a row in flight per thread.
constexpr int kScatterLanes = 64;
constexpr int kScatterSlices = kThreads / kScatterLanes;  // = columns a lane

// acc[j] += scale(row) * src[row, c0 + lane + 64 j] over this slice's share
// of the n listed rows (row = base + list[i]); columns at or past F skipped
template <typename Scale>
__device__ __forceinline__ void sum_listed_rows(
    const float* __restrict__ src, size_t base, const int* list, int n, int F,
    int c0, int lane, int slice, Scale scale, float (&acc)[kScatterSlices]) {
  for (int i = slice; i < n; i += kScatterSlices) {
    const size_t row = base + list[i];
    const float w = scale(row);
#pragma unroll
    for (int j = 0; j < kScatterSlices; ++j) {
      const int c = c0 + lane + kScatterLanes * j;
      if (c < F) acc[j] += src[row * F + c] * w;
    }
  }
}

// the slices' sums, added in slice order -> dst[c0 + thread] (one column a
// thread); red is shared, [kScatterSlices][kThreads]
__device__ __forceinline__ void store_slice_sums(
    const float (&acc)[kScatterSlices], float (&red)[kScatterSlices][kThreads],
    float* __restrict__ dst, int F, int c0, int lane, int slice) {
#pragma unroll
  for (int j = 0; j < kScatterSlices; ++j)
    red[slice][lane + kScatterLanes * j] = acc[j];
  __syncthreads();
  float total = red[0][threadIdx.x];
#pragma unroll
  for (int s = 1; s < kScatterSlices; ++s) total += red[s][threadIdx.x];
  if (c0 + (int)threadIdx.x < F) dst[c0 + threadIdx.x] = total;
  __syncthreads();  // red may be reused
}

inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

}  // namespace mp
