// Building blocks of the attention kernels for sm_90a (attention.cu,
// attention_bwd.cu, attention_ln.cu): f32 products on the tensor cores, asynchronous tile
// staging, and the online softmax of one key tile. Nothing here launches.
//
// Products. Every product of the kernels is a [16 x K] x [K x N] tile
// product with f32 operands. It runs on the tensor cores as
// mma.sync.m16n8k8 TF32 with the error-compensated split ("3xTF32"):
//   hi = tf32(x) (round to nearest), lo = tf32(x - hi),
//   a*b ~= a_lo*b_hi + a_hi*b_lo + a_hi*b_hi   (f32 accumulators),
// the small terms first. The dropped a_lo*b_lo term is 2^-22 of the product, so the result
// is f32-accurate; a single TF32 pass (2^-11) would not be.
//
// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4):
//   A [16 x 8] row: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B [8 x 8] col:  b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C [16 x 8]:     c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//
// A block is 4 warps and owns 16 rows (one m16 tile); the other operand
// streams through shared memory in tiles of 32 rows. Two product shapes:
//   * rows_dot_partial: C[16 x 32] = A[16 x D] . T[32 x D]^T (scores, dp).
//     The warps split D four ways (each reuses its A fragment over the four
//     n8 tiles, which is what keeps shared-memory reads under the tensor
//     cores' appetite) and leave four partial tiles in shared memory that
//     the softmax step adds in a fixed order. Rows are padded to D + 4
//     floats, so the fragment reads (row g, column t) touch 32 banks.
//   * prob_times_rows: C[16 x D] += P[16 x 32] . T[32 x D] (p v, ds k, ...).
//     Each warp owns D / 4 output columns. Here the B fragment walks down
//     the tile's rows (row t, column g), which with the D + 4 padding would
//     hit every bank twice. The contraction index is free to be permuted,
//     so k-step s = 2h + e takes the tile rows 16h + 2t + e (b0) and
//     16h + 8 + 2t + e (b1): rows two apart are 8 banks apart and the 32
//     lanes touch 32 banks. P is stored in that order (prob_pos), so its A
//     fragments are plain (row g, column 8s + t) reads of a 36-float row.
//     One staged tile therefore serves both shapes without conflicts.
// A 16-row half of the streamed tile that lies wholly past the operand's end
// is skipped in both shapes; rows past the end inside a half are zero-filled
// when staged.
//
// Operands that are TF32 values already (bfloat16 values are: 8 of TF32's 10
// mantissa bits) have lo = 0, so ONE pass is exact in them: the *_exact
// forms of the two product shapes (attention_ln.cu with bf16 operands) skip
// the split and round only the probabilities.
//
// Operands of either dtype (the LN-fused forward, and the bf16 form of the
// attention forward) are staged raw by stage_raw_async, the operand's bytes
// at the front of each f32 row, and expanded in place once they have landed:
// normalised (attention_ln.cu) or widened (widen_rows).
//
// Staging. cp.async copies, zero-filling rows past the end and the columns
// past the row's width up to the staged 32 NC (16-byte copies where rows are
// 16-byte aligned, 4-byte ones otherwise); with two buffers the next tile is
// in flight while the current one is multiplied. The launcher picks two
// buffers when two blocks still fit an SM with them, else one (two resident
// blocks then overlap each other). Rows wider than 512 are cut into chunks
// (the sliced kernels, see slice_chunk).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileM = 16;       // rows a block owns
constexpr int kTileN = 32;       // rows of a streamed tile
constexpr int kPad = 4;          // floats of padding per staged row
constexpr int kPartStride = 40;  // row stride of a partial [16 x 32] tile
constexpr int kProbStride = 36;  // row stride of a permuted [16 x 32] tile
constexpr int kPartFloats = kWarps * kTileM * kPartStride;
constexpr int kProbFloats = kTileM * kProbStride;
// most shared memory a block may ask for, and the most that lets two
// blocks share an SM (228 KB an SM, 1 KB reserved per block)
constexpr size_t kSmemMax = 227 * 1024;
constexpr size_t kSmemTwoBlocks = 112 * 1024;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x rounded to nearest (ties away from zero) at TF32's 10 mantissa bits:
// for finite x the bits of cvt.rna.tf32.f32, formed by an integer add and a
// mask because the conversion unit runs at a quarter of the integer rate
// (both forms measured: the same bits, this one 5-11% faster per kernel)
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi and lo TF32 values (rounded, as the split's error
// bound needs; raw f32 bits would be truncated by the tensor core)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(x);
  // the tensor core ignores an operand's low 13 bits: no mask needed here
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// acc[n] = a_s[16 x 8 NC](columns c0...) . t_s[8n..8n+8 x 8 NC]^T for the
// n8 sub-tiles n < NT of the streamed tile; both operands have row stride
// `stride`. NC k-steps: the calling warp's quarter of D = 32 NC. NT is a
// template argument so that the loop body has no branch and the compiler
// interleaves the sub-tiles' loads and MMAs; each of the three terms has an
// accumulator of its own (one MMA, not three, on each dependent chain).
template <int NC, int NT>
__device__ __forceinline__ void rows_dot_partial(const float* a_s,
                                                 const float* t_s, int stride,
                                                 int c0, int lane,
                                                 float (&acc)[4][4]) {
  const int g = lane >> 2, t = lane & 3;
  float lo_hi[NT][4], hi_lo[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = lo_hi[n][i] = hi_lo[n][i] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < NC; ++ks) {
    const int c = c0 + 8 * ks + t;
    uint32_t a_hi[4], a_lo[4];
    load_a(a_s, stride, g, c, a_hi, a_lo);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* row = t_s + (8 * n + g) * stride + c;
      uint32_t b_hi[2], b_lo[2];
      split_tf32(row[0], b_hi[0], b_lo[0]);
      split_tf32(row[4], b_hi[1], b_lo[1]);
      mma_tf32(lo_hi[n], a_lo, b_hi[0], b_hi[1]);
      mma_tf32(hi_lo[n], a_hi, b_lo[0], b_lo[1]);
      mma_tf32(acc[n], a_hi, b_hi[0], b_hi[1]);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += lo_hi[n][i] + hi_lo[n][i];
}

// the calling warp's partial [16 x 32] tile -> part ([16][kPartStride]),
// or added to what part holds (the sliced kernels: one chunk of D after
// another, in a fixed order)
template <int NT>
__device__ __forceinline__ void store_partial(float* part,
                                              const float (&acc)[4][4],
                                              int lane, bool add = false) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* at = part + g * kPartStride + 8 * n + 2 * t;
    float2 lo = make_float2(acc[n][0], acc[n][1]);
    float2 hi = make_float2(acc[n][2], acc[n][3]);
    if (add) {
      const float2 a = *reinterpret_cast<const float2*>(at);
      const float2 b = *reinterpret_cast<const float2*>(at + 8 * kPartStride);
      lo = make_float2(a.x + lo.x, a.y + lo.y);
      hi = make_float2(b.x + hi.x, b.y + hi.y);
    }
    *reinterpret_cast<float2*>(at) = lo;
    *reinterpret_cast<float2*>(at + 8 * kPartStride) = hi;
  }
}

// the calling warp's partial product of its quarter of the staged width,
// left in (or, with `add`, added to) its partial tile: the 16-row halves of
// the streamed tile that hold rows only
template <int NC>
__device__ __forceinline__ void partial_tile(const float* a_s,
                                             const float* t_s, int stride,
                                             int halves, int warp, int lane,
                                             float* parts, bool add = false) {
  float acc[4][4];
  float* part = parts + warp * kTileM * kPartStride;
  if (halves == 2) {  // the same for every thread of the block
    rows_dot_partial<NC, 4>(a_s, t_s, stride, warp * 8 * NC, lane, acc);
    store_partial<4>(part, acc, lane, add);
  } else {
    rows_dot_partial<NC, 2>(a_s, t_s, stride, warp * 8 * NC, lane, acc);
    store_partial<2>(part, acc, lane, add);
  }
}

// element (row, col) of the [16 x 32] tile: the four warps' partial tiles
// added in warp order
__device__ __forceinline__ float sum_partials(const float* parts, int row,
                                              int col) {
  const float* at = parts + row * kPartStride + col;
  constexpr int kOne = kTileM * kPartStride;
  return ((at[0] + at[kOne]) + at[2 * kOne]) + at[3 * kOne];
}

// where column j (a row of the streamed tile) of a permuted [16 x 32] tile
// is stored: see prob_times_rows
__device__ __forceinline__ int prob_pos(int j) {
  return (j & 16) + 8 * (j & 1) + 4 * ((j >> 3) & 1) + ((j >> 1) & 3);
}

// acc[n] += p_s[16 x 32] . t_s[32 x 8 NC](columns c0...): p_s in prob_pos
// order with row stride kProbStride, t_s with row stride `stride`; the
// first HALVES (1 or 2) 16-row halves of the streamed tile. One accumulator
// takes all three terms, small ones first (the NC sub-tiles are independent
// chains already).
template <int NC, int HALVES>
__device__ __forceinline__ void prob_times_rows_n(const float* p_s,
                                                  const float* t_s, int stride,
                                                  int c0, int lane,
                                                  float (&acc)[NC][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < 2 * HALVES; ++s) {
    uint32_t a_hi[4], a_lo[4];
    load_a(p_s, kProbStride, g, 8 * s + t, a_hi, a_lo);
    const float* row0 =
        t_s + (16 * (s >> 1) + 2 * t + (s & 1)) * stride + c0 + g;
    const float* row1 = row0 + 8 * stride;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      uint32_t b_hi[2], b_lo[2];
      split_tf32(row0[8 * n], b_hi[0], b_lo[0]);
      split_tf32(row1[8 * n], b_hi[1], b_lo[1]);
      mma_tf32(acc[n], a_lo, b_hi[0], b_hi[1]);
      mma_tf32(acc[n], a_hi, b_lo[0], b_lo[1]);
      mma_tf32(acc[n], a_hi, b_hi[0], b_hi[1]);
    }
  }
}

template <int NC>
__device__ __forceinline__ void prob_times_rows(const float* p_s,
                                                const float* t_s, int stride,
                                                int c0, int halves, int lane,
                                                float (&acc)[NC][4]) {
  if (halves == 2)  // the same for every thread of the block
    prob_times_rows_n<NC, 2>(p_s, t_s, stride, c0, lane, acc);
  else
    prob_times_rows_n<NC, 1>(p_s, t_s, stride, c0, lane, acc);
}

// rows_dot_partial for operands that are TF32 values already: one pass
template <int NC, int NT>
__device__ __forceinline__ void rows_dot_partial_exact(
    const float* a_s, const float* t_s, int stride, int c0, int lane,
    float (&acc)[4][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < NC; ++ks) {
    const int c = c0 + 8 * ks + t;
    const uint32_t a[4] = {__float_as_uint(a_s[g * stride + c]),
                           __float_as_uint(a_s[(g + 8) * stride + c]),
                           __float_as_uint(a_s[g * stride + c + 4]),
                           __float_as_uint(a_s[(g + 8) * stride + c + 4])};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* row = t_s + (8 * n + g) * stride + c;
      mma_tf32(acc[n], a, __float_as_uint(row[0]), __float_as_uint(row[4]));
    }
  }
}

// partial_tile for operands that are TF32 values already
template <int NC>
__device__ __forceinline__ void partial_tile_exact(const float* a_s,
                                                   const float* t_s,
                                                   int stride, int halves,
                                                   int warp, int lane,
                                                   float* parts,
                                                   bool add = false) {
  float acc[4][4];
  float* part = parts + warp * kTileM * kPartStride;
  if (halves == 2) {  // the same for every thread of the block
    rows_dot_partial_exact<NC, 4>(a_s, t_s, stride, warp * 8 * NC, lane, acc);
    store_partial<4>(part, acc, lane, add);
  } else {
    rows_dot_partial_exact<NC, 2>(a_s, t_s, stride, warp * 8 * NC, lane, acc);
    store_partial<2>(part, acc, lane, add);
  }
}

// prob_times_rows for a streamed tile of TF32 values: one pass, p_s rounded
// to TF32 (the tensor core would truncate it)
template <int NC, int HALVES>
__device__ __forceinline__ void prob_times_rows_exact_n(
    const float* p_s, const float* t_s, int stride, int c0, int lane,
    float (&acc)[NC][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < 2 * HALVES; ++s) {
    const int c = 8 * s + t;
    const uint32_t a[4] = {round_tf32(p_s[g * kProbStride + c]),
                           round_tf32(p_s[(g + 8) * kProbStride + c]),
                           round_tf32(p_s[g * kProbStride + c + 4]),
                           round_tf32(p_s[(g + 8) * kProbStride + c + 4])};
    const float* row0 =
        t_s + (16 * (s >> 1) + 2 * t + (s & 1)) * stride + c0 + g;
    const float* row1 = row0 + 8 * stride;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      mma_tf32(acc[n], a, __float_as_uint(row0[8 * n]),
               __float_as_uint(row1[8 * n]));
  }
}

template <int NC>
__device__ __forceinline__ void prob_times_rows_exact(
    const float* p_s, const float* t_s, int stride, int c0, int halves,
    int lane, float (&acc)[NC][4]) {
  if (halves == 2)  // the same for every thread of the block
    prob_times_rows_exact_n<NC, 2>(p_s, t_s, stride, c0, lane, acc);
  else
    prob_times_rows_exact_n<NC, 1>(p_s, t_s, stride, c0, lane, acc);
}

template <int NC>
__device__ __forceinline__ void zero_acc(float (&a)[NC][4]) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[n][i] = 0.f;
}

// 16 bytes global -> shared, or 16 bytes of zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared, or 4 bytes of zeros when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows [r0, r0 + rows) of src ([n_total][d] floats, n_total >= 1), columns
// [c0, c0 + w) -> columns [0, w) of dst ([rows][32 NC + kPad]), and zeros in
// columns [w, 32 NC) and in the rows at or past n_total: every column a
// product reads is written, so the zero columns add nothing to q k^T and
// the columns of p v past w are never stored. 16-byte copies where rows are
// 16-byte aligned (d % 4 == 0; c0 is a multiple of 32), else 4-byte ones;
// asynchronous.
template <int NC>
__device__ __forceinline__ void stage_cols_async(float* dst, const float* src,
                                                 int r0, int rows,
                                                 int n_total, int d, int c0,
                                                 int w) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  if (d == W && c0 == 0) {  // whole rows, the width known at compile time
    constexpr int W4 = W / 4;
    for (int idx = threadIdx.x; idx < rows * W4; idx += kThreads) {
      const int i = idx / W4;
      const int c = 4 * (idx % W4);
      const bool ok = r0 + i < n_total;
      cp_async16(dst + i * S + c, src + (size_t)(ok ? r0 + i : 0) * W + c,
                 ok);
    }
  } else if (d % 4 == 0) {
    constexpr int W4 = W / 4;
    for (int idx = threadIdx.x; idx < rows * W4; idx += kThreads) {
      const int i = idx / W4;
      const int c = 4 * (idx % W4);
      const bool ok = r0 + i < n_total && c < w;
      cp_async16(dst + i * S + c,
                 src + (size_t)(ok ? r0 + i : 0) * d + (ok ? c0 + c : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * W; idx += kThreads) {
      const int i = idx / W;
      const int c = idx % W;
      const bool ok = r0 + i < n_total && c < w;
      cp_async4(dst + i * S + c,
                src + (size_t)(ok ? r0 + i : 0) * d + (ok ? c0 + c : 0), ok);
    }
  }
}

// out[col], out[col + 1] of a row of width d (col even): one 8-byte store
// where d is even (the row is then 8-byte aligned), else the elements below
// d one by one
__device__ __forceinline__ void store_pair(float* row, int col, int d,
                                           float a, float b) {
  if (d % 2 == 0) {
    if (col < d) *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
  } else {
    if (col < d) row[col] = a;
    if (col + 1 < d) row[col + 1] = b;
  }
}

// a value as the operand dtype holds it
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes as 4 floats or 8 bf16 values
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

// row[col], row[col + 1] of an output row of width D of which the first
// `lim` columns are this block's (col even): one store where D is even
// (the row is then aligned for it), else element by element
template <typename T>
__device__ __forceinline__ void store_pair_t(T* row, int col, int lim, int D,
                                             float a, float b) {
  if (D % 2 == 0) {
    if (col < lim) store2(row + col, a, b);
  } else {
    if (col < lim) store1(row + col, a);
    if (col + 1 < lim) store1(row + col + 1, b);
  }
}

// rows [r0, r0 + rows) of src ([n_total][d] of T), columns [c0, c0 + w) ->
// the FRONT of the rows of dst ([rows][32 NC + kPad] floats), raw; zeros for
// rows at or past n_total. 16-byte copies where a row's bytes allow it,
// else 4-byte ones (asynchronous), else (bf16 rows of odd width) one value
// at a time, synchronously: visible after the tile ring's barrier as well.
template <typename T, int NC>
__device__ __forceinline__ void stage_raw_async(float* dst, const T* src,
                                                int r0, int rows, int n_total,
                                                int d, int c0, int w) {
  constexpr int W = 32 * NC;
  constexpr int S = W + kPad;
  constexpr int E = (int)sizeof(T);
  const char* base = reinterpret_cast<const char*>(src);
  if (d == W && c0 == 0) {  // whole rows, the width known at compile time
    constexpr int C = W * E / 16;
    for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
      const int i = idx / C;
      const int c = idx % C;
      const bool ok = r0 + i < n_total;
      cp_async16(reinterpret_cast<float*>(
                     reinterpret_cast<char*>(dst + i * S) + 16 * c),
                 reinterpret_cast<const float*>(
                     base + (size_t)(ok ? r0 + i : 0) * W * E + 16 * c),
                 ok);
    }
  } else if ((d * E) % 16 == 0 || (d * E) % 4 == 0) {
    const int unit = (d * E) % 16 == 0 ? 16 : 4;
    const int C = w * E / unit;  // copies a row
    for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
      const int i = idx / C;
      const int c = idx % C;
      const bool ok = r0 + i < n_total;
      const char* from =
          base + ((size_t)(ok ? r0 + i : 0) * d + c0) * E + unit * c;
      char* to = reinterpret_cast<char*>(dst + i * S) + unit * c;
      if (unit == 16)
        cp_async16(reinterpret_cast<float*>(to),
                   reinterpret_cast<const float*>(from), ok);
      else
        cp_async4(to, from, ok);
    }
  } else {
    const uint16_t* from = reinterpret_cast<const uint16_t*>(src);
    for (int idx = threadIdx.x; idx < rows * w; idx += kThreads) {
      const int i = idx / w;
      const int c = idx % w;
      const bool ok = r0 + i < n_total;
      reinterpret_cast<uint16_t*>(dst + i * S)[c] =
          ok ? from[(size_t)(r0 + i) * d + c0 + c] : (uint16_t)0;
    }
  }
}

// columns [c0, c0 + w) of rows [r0, r0 + rows) of src ([n_total][d] of T)
// -> dst: f32 rows as they are (stage_cols_async), bf16 rows raw
// (stage_raw_async; widen_rows widens them once they have landed)
template <typename T, int NC>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int rows, int n_total, int d,
                                           int c0, int w) {
  if constexpr (sizeof(T) == 4)
    stage_cols_async<NC>(dst, src, r0, rows, n_total, d, c0, w);
  else
    stage_raw_async<T, NC>(dst, src, r0, rows, n_total, d, c0, w);
}

// The first rows16 rows of a staged tile whose rows hold raw bf16 values at
// their front (stage_raw_async), widened in place: 32 NC floats a row, the
// w values and zeros past w and in the rows at or past n. One warp a row,
// NC values a lane, all read before any is written. A bf16 value is a TF32
// value, so the widened tiles feed the single-pass *_exact products.
template <int NC>
__device__ __forceinline__ void widen_rows(float* tile, int rows16, int n,
                                           int w, int warp, int lane) {
  constexpr int S = 32 * NC + kPad;
  for (int row = warp; row < rows16; row += kWarps) {
    const __nv_bfloat16* raw =
        reinterpret_cast<const __nv_bfloat16*>(tile + row * S);
    float v[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      v[j] = row < n && col < w ? __bfloat162float(raw[col]) : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NC; ++j) tile[row * S + lane + 32 * j] = v[j];
  }
}

// The sliced kernels (D > 32 NC, NC = 16): the feature dimension is cut
// into n chunks of 32 NC columns (the last one narrower); a block owns the
// output columns of ONE chunk, its slice, and forms the full scores (and
// dp) by streaming every chunk of its operands through the same staged
// tiles, adding the chunks' partial tiles in the order below. Its own slice
// comes last, so the tiles staged for it stay in shared memory for the
// products that need the slice's columns (p v, ds k, p^T g, ds^T q).
constexpr int kSliceMaxNC = 16;

__device__ __forceinline__ int slice_chunk(int ci, int slice, int n) {
  return (slice + 1 + ci) % n;
}

// One key tile of the online softmax, for the calling warp's rows
// 4 warp .. 4 warp + 3 (lane = key k0 + lane): the scores are the partial
// tiles' sum * scale + bias, keys at or past Lk take -inf. Updates the
// running max m and sum l (both the same in every lane) and, with kWriteP,
// writes p = exp(s - m) in prob_pos order and the rescale factor of the
// rows' earlier sums. A row whose keys are all masked sees every score at
// exactly -1e30: m = -1e30, p = 1, l = Lk.
template <bool kWriteP>
__device__ __forceinline__ void softmax_tile(const float* parts,
                                             const float* bias_b, int k0,
                                             int Lk, float scale, int warp,
                                             int lane, float (&m_run)[4],
                                             float (&l_run)[4], float* p_s,
                                             float* corr_s) {
  const bool valid = k0 + lane < Lk;
  const float bj = valid ? bias_b[k0 + lane] : 0.f;
  const int pos = prob_pos(lane);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r;
    const float s = sum_partials(parts, row, lane);
    const float sr = valid ? fmaf(s, scale, bj) : -INFINITY;
    const float m_new = fmaxf(m_run[r], warp_max(sr));
    const float p = valid ? expf(sr - m_new) : 0.f;
    const float corr = expf(m_run[r] - m_new);  // 0 on the first tile
    l_run[r] = fmaf(l_run[r], corr, warp_sum(p));
    m_run[r] = m_new;
    if (kWriteP) {
      p_s[row * kProbStride + pos] = p;
      if (lane == 0) corr_s[row] = corr;
    }
  }
}

// Pass two of the two-pass softmax of the bf16 attention forward: with the
// rows' final max m and sum l (pass one, softmax_tile<false>), the
// calling warp's rows' weights p = exp(s - m) / l, NORMALISED and then
// rounded to bf16, where the TPU kernel rounds them, written in prob_pos
// order (lane = key k0 + lane; keys at or past Lk get 0).
__device__ __forceinline__ void normalised_bf16_probs(
    const float* parts, const float* bias_b, int k0, int Lk, float scale,
    int warp, int lane, const float (&m)[4], const float (&l)[4],
    float* p_s) {
  const bool valid = k0 + lane < Lk;
  const float bj = valid ? bias_b[k0 + lane] : 0.f;
  const int pos = prob_pos(lane);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r;
    const float s = fmaf(sum_partials(parts, row, lane), scale, bj);
    p_s[row * kProbStride + pos] =
        valid ? rounded<__nv_bfloat16>(expf(s - m[r]) / l[r]) : 0.f;
  }
}

// Shared-memory tile ring of a kernel that streams `n_tiles` tiles through
// `nbuf` (1 or 2) buffers. Usage, by every thread of the block:
//   stage(0, buffer 0); commit;            // with the prologue's copies
//   for it: buf = ring_acquire(it, ...);   // tile `it` is ready in buf
// `stage(tile, buffer)` issues the tile's cp.async copies. After
// ring_acquire returns, every thread has finished the previous tile.
template <typename Stage>
__device__ __forceinline__ int ring_acquire(int it, int n_tiles, int nbuf,
                                            Stage stage) {
  if (nbuf == 1 && it > 0) {
    __syncthreads();  // the previous tile is consumed
    stage(it, 0);
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();  // every thread's copies have landed
  if (nbuf == 2 && it + 1 < n_tiles) {
    stage(it + 1, (it + 1) & 1);
    cp_async_commit();
  }
  return nbuf == 2 ? (it & 1) : 0;
}

// two buffers when two blocks then still fit an SM, else one; 0 when even
// one buffer does not fit a block
inline int pick_buffers(size_t fixed_bytes, size_t per_buffer_bytes) {
  if (fixed_bytes + 2 * per_buffer_bytes <= kSmemTwoBlocks) return 2;
  return fixed_bytes + per_buffer_bytes <= kSmemMax ? 1 : 0;
}

}  // namespace attn
