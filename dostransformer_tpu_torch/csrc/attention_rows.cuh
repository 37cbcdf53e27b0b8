// The "rows" form of the attention kernels (attention.cu, attention_bwd.cu):
// building blocks, and the rule that picks a form. Nothing here launches.
//
// A block owns one or two groups of 16 rows (queries in the forward and
// dq; keys in dk/dv), four warps a group, and holds their WHOLE rows of
// scores, L <= kMaxL columns (keys; queries of a chunk in dk/dv), in
// registers while it forms them, then as the second product's operand in
// shared memory. Two groups share every staged tile of the other operand,
// which halves the block's reads of it (L2 traffic: at D = 1,024 every
// 16-row block reads all of K and V). Three phases:
//   1. scores (and dp in the backward) = A[16 x D] . T[L x D]^T, once, over
//      the full D: the chunks of A's rows and of T's L rows stream through
//      the staged tiles in column order (a chunk as wide as kChunkBudget
//      bytes allow: the whole row where L is small), and a group's warps
//      split T's rows (warp w holds the n8 tiles w, w + 4, ...: at most kNT
//      of them); f32 scores add each 32-column sub-chunk's product, formed
//      in an accumulator of its own, to the running sum (a chain of 12
//      mma.sync, not 3 D / 8);
//   2. the softmax (or p and ds) of the held rows: the exact row max and
//      sum, no rescaling. The forward's p is normalised before it is
//      stored (and then rounded to bf16 for bf16 operands); the backward's
//      delta = rowsum(dp * p) comes from the held rows in the same pass;
//   3. out[16 x D] = P[16 x L] . U[L x D], slice by slice of 32 nc output
//      columns (each warp a quarter of a slice), U streamed in tiles of 32
//      rows (f32: 16 where two blocks share an SM). The scores are not
//      formed again for any slice.
// Phases 1 and 3 share one ring of staged tiles (cp.async; the next tile
// lands while the current one is multiplied), so the first tiles of phase 3
// arrive during phase 2.
//
// Products. f32 operands: 3xTF32 mma.m16n8k8 as attention_core.cuh forms
// them (f32 accuracy); phase 3 is its prob_times_rows on half tiles.
// bf16 operands: mma.m16n8k16 with bf16 inputs and f32 accumulators on
// tiles staged raw (no widening), fragments by ldmatrix (.trans for the
// streamed rows of phase 3): a product of bf16 values is exact, the sums
// are f32, as the single exact TF32 pass of the first bf16 design was. The
// rounding points are the TPU kernel's: bf16(normalised p) before p v,
// bf16(ds) before its products, each output once after its scale.
//
// Bank conflicts. A staged bf16 row is 64 columns + 8 (144 bytes) in
// phase 1 and 32 nc + 8 columns in phase 3, the held P row 16 ceil(L/16) + 8
// columns: every ldmatrix row stride is an odd multiple of 16 bytes, so the
// eight rows of a matrix fall in eight distinct 16-byte bank groups. f32
// rows are 32 + 4 and 32 nc + 4 floats, as in attention_core.cuh.

#pragma once

#include <algorithm>

#include "attention_core.cuh"

namespace attn {

// the kernels' forms (ops/attention.py FORMS):
//   online: D <= 512 (attention.cu attn_fwd_kernel: keys streamed, the
//           online softmax); sliced: blocks that each own a slice of 512
//           output columns, keys streamed (any D); rows: this file
constexpr int kFormOnline = 0;
constexpr int kFormSliced = 1;
constexpr int kFormRows = 2;

namespace rows {

constexpr int kMaxL = 256;              // columns of a held row of scores
constexpr int kNT = kMaxL / 8 / kWarps;  // n8 tiles a warp holds: 8
constexpr int kMaxNC = 16;               // 32-column groups of a slice
constexpr int kMaxGroups = 2;            // 16-row groups of a block
constexpr int kMaxThreads = kMaxGroups * kThreads;
// bytes of one staged phase-1 chunk the chunk width grows to (a power of
// two times the base width) where two blocks share an SM, and where a
// block has its SM alone (fewer, larger chunks: a chunk's latency, not its
// bytes, bounds a block then); the bytes a chunk of the whole row may take
constexpr size_t kChunkBudget = 40 * 1024;
constexpr size_t kChunkBudgetAlone = 80 * 1024;
constexpr size_t kWholeBudget = 96 * 1024;

// f32 calls above D = 512 with fewer keys keep the sliced form, which
// measured faster there (16-51 keys); the rows form wins from 100
constexpr int kRowsMinKeysF32 = 96;
// bf16 calls up to D = 512 with at most this many keys keep the online
// form, whose backward measured faster there
// (16-32 keys); the rows form wins from 51
constexpr int kOnlineMaxKeysBF16 = 32;

// The form of a call, by feature width D, key count Lk and operand type:
// measured on the H100 (PERF.md). The rows form holds every key of
// a row, so it takes Lk <= kMaxL: bf16 at every D but D <= 512 with at
// most kOnlineMaxKeysBF16 keys; f32 above D = 512 from kRowsMinKeysF32
// keys. The online form takes f32 up to D = 512 (it measured faster there
// on the same calls) and those bf16 calls; the rest is sliced.
__host__ __device__ inline int form_of(int D, int Lk, bool bf16) {
  const bool wide = D > 32 * kSliceMaxNC;
  if (!wide && (!bf16 || Lk <= kOnlineMaxKeysBF16)) return kFormOnline;
  if (Lk <= kMaxL && (bf16 || Lk >= kRowsMinKeysF32)) return kFormRows;
  return kFormSliced;
}

// 16-row groups a block of the rows form holds (four warps each), by the
// call's shape: two where a block's reads of the other operand's rows
// dominate (at least min_cols of them) and the grid still has a block for
// most SMs, else one. Measured on the H100 (PERF.md): the forward
// gains from 100 keys (min_cols 64), the backward from 201 only (128).
// `rows` is the blocks' row count (Lq for the forward and dq, Lk for
// dk/dv) and `cols` the count of the rows they read (Lk, or the queries of
// a chunk).
__host__ __device__ inline int row_groups(int B, int rows, int cols,
                                          int min_cols) {
  return cols >= min_cols && B * ((rows + 31) / 32) >= 96 ? 2 : 1;
}

// 32-column groups of an output slice; the same plan as the online forms
__host__ __device__ inline int slice_groups(int D) {
  return D <= 32 * kMaxNC ? (D + 31) / 32 : kMaxNC;
}

// what differs between the operand types
template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int kChunk = 32;      // columns of a phase-1 sub-chunk
  static constexpr int kPad = 4;         // elements past a staged row
};
template <>
struct Op<__nv_bfloat16> {
  static constexpr int kChunk = 64;
  static constexpr int kPad = 8;
};

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// n8 tiles that cover L rows
__host__ __device__ inline int tiles8(int L) { return (L + 7) / 8; }

// one group's held operand of phase 3 (P, ds, p^T or ds^T): bf16
// [16][held_stride] where every k16 step of phase 3 reads whole rows; f32
// in the permuted [16][36] tiles of 32 columns that prob_times_rows reads
__host__ __device__ inline int held_stride(int L) {
  return 16 * ((L + 15) / 16) + 8;
}
template <typename T>
__host__ __device__ inline size_t held_bytes(int L) {
  if (sizeof(T) == 2) return align16(kTileM * held_stride(L) * sizeof(T));
  return (size_t)((L + 31) / 32) * kProbFloats * sizeof(float);
}

// a phase-3 tile: `rows` rows of 32 nc columns (and the pad)
template <typename T>
__host__ __device__ inline int tile_stride(int nc) {
  return 32 * nc + Op<T>::kPad;
}
template <typename T>
__host__ __device__ inline size_t tile_bytes(int nc, int rows) {
  return align16((size_t)rows * tile_stride<T>(nc) * sizeof(T));
}

// `rows` staged rows of a phase-1 chunk `cols` wide (and the pad)
template <typename T>
__host__ __device__ inline size_t chunk_bytes(int rows, int cols) {
  return align16((size_t)rows * (cols + Op<T>::kPad) * sizeof(T));
}

// the width of a phase-1 chunk of `rows` staged rows: the whole row (D
// rounded up to the base width) where that chunk fits kWholeBudget, else
// the base width doubled while the chunk stays within kChunkBudget and the
// row. Where L is small (cross-attention's 32 or 16 atom keys) a row of
// D <= 512 is one chunk.
template <typename T>
__host__ __device__ inline int chunk_cols(int D, int rows, size_t budget) {
  constexpr int kBase = Op<T>::kChunk;
  const int most = (D + kBase - 1) / kBase * kBase;
  if (chunk_bytes<T>(rows, most) <= kWholeBudget) return most;
  int cols = kBase;
  while (2 * cols <= most && chunk_bytes<T>(rows, 2 * cols) <= budget)
    cols *= 2;
  return cols;
}

// rows of the other operand a phase-1 chunk stages: L rounded up to the
// k16 steps of phase 3 (zeros past L), so that phase 3 can read them there
__host__ __device__ inline int staged_rows(int L) {
  return 16 * ((L + 15) / 16);
}

// whether phase 3 multiplies by the rows phase 1 staged, instead of
// staging them again: the whole row was one chunk, and every slice's
// columns (32 nc each, the last one past D) lie within it
__host__ __device__ inline bool reuses_chunk(int D, int cols, int nc) {
  return (D + 32 * nc - 1) / (32 * nc) * 32 * nc <= cols;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// rows [r0, r0 + rows) of src ([n][d] of T), columns [c0, c0 + w) -> the
// rows of dst (stride `stride` elements), columns [0, cols), zeros past w
// and in the rows at or past n: every element a product reads is written.
// The widest copy every row's bytes allow: 16 bytes, 4 bytes
// (asynchronous), or (bf16 rows of odd width) one value at a time,
// synchronously, visible after the ring's barrier as well. c0 and cols are
// multiples of 8 elements.
template <typename T>
__device__ __forceinline__ void stage_zero(T* dst, int stride, const T* src,
                                           int r0, int rows, int n, int d,
                                           int c0, int w, int cols) {
  constexpr int E = (int)sizeof(T);
  const int unit = (d * E) % 16 == 0 ? 16 : (d * E) % 4 == 0 ? 4 : E;
  const int per = unit / E;  // elements a copy; w is a multiple of it
  const int units = cols / per;
  // a row's copies: a power of two (the usual widths) splits by shifts
  const bool pow2 = (units & (units - 1)) == 0;
  const int shift = __ffs(units) - 1;
  for (int idx = threadIdx.x; idx < rows * units; idx += blockDim.x) {
    const int i = pow2 ? idx >> shift : idx / units;
    const int c = (pow2 ? idx & (units - 1) : idx % units) * per;
    const bool ok = r0 + i < n && c < w;
    T* to = dst + i * stride + c;
    const T* from = src + (size_t)(ok ? r0 + i : 0) * d + (ok ? c0 + c : 0);
    if (unit == 16)
      cp_async16(reinterpret_cast<float*>(to),
                 reinterpret_cast<const float*>(from), ok);
    else if (unit == 4)
      cp_async4(to, from, ok);
    else
      *reinterpret_cast<uint16_t*>(to) =
          ok ? *reinterpret_cast<const uint16_t*>(from) : (uint16_t)0;
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The rows form's ring of nbuf (1 to kMaxBuffers) staged buffers over
// n_tiles tiles (phase 1's chunks, then phase 3's tiles): ring_start
// stages the first nbuf - 1 tiles, ring_next (every thread, each
// iteration) returns the buffer where tile `it` has landed, after a
// barrier past the previous tile's last reader, and issues tile it + nbuf
// - 1 into the buffer that tile freed. One commit group a tile (empty past
// the end), so tile it is complete when at most nbuf - 2 newer groups are
// in flight: nbuf - 1 tiles ahead of the one multiplied.
constexpr int kMaxBuffers = 4;

template <typename Stage>
__device__ __forceinline__ void ring_start(int n_tiles, int nbuf,
                                           Stage stage) {
  for (int i = 0; i < max(nbuf - 1, 1); ++i) {
    if (i < n_tiles) stage(i, i);
    cp_async_commit();
  }
}

template <typename Stage>
__device__ __forceinline__ int ring_next(int it, int n_tiles, int nbuf,
                                         Stage stage) {
  if (nbuf == 1) {  // no tile ahead: stage, wait, multiply
    if (it > 0) {
      __syncthreads();
      stage(it, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    return 0;
  }
  switch (nbuf) {
    case 2: cp_async_wait<0>(); break;
    case 3: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
  __syncthreads();
  if (it + nbuf - 1 < n_tiles) stage(it + nbuf - 1, (it + nbuf - 1) % nbuf);
  cp_async_commit();
  return it % nbuf;
}

// the blocks that should share an SM for a grid: two where it has more
// blocks than an H100 has SMs (132), else one
inline int resident(dim3 grid) {
  return (long)grid.x * grid.y * grid.z > 132 ? 2 : 1;
}

// the staging of a grid that shares SMs or not: (chunk budget, phase-3 tile
// rows)
template <typename T>
inline size_t chunk_budget(dim3 grid) {
  return resident(grid) > 1 ? kChunkBudget : kChunkBudgetAlone;
}
template <typename T>
inline int tile_rows(dim3 grid) {
  return sizeof(T) == 2 || resident(grid) == 1 ? 32 : 16;
}

// buffers of `bytes` each for a block with `fixed` bytes besides: as many
// (up to kMaxBuffers) as let `resident` blocks share an SM, 0 when even one
// does not fit
inline int ring_buffers(size_t fixed, size_t bytes, int resident) {
  const size_t room = resident > 1 ? kSmemTwoBlocks : kSmemMax;
  for (int n = kMaxBuffers; n >= 2; --n)
    if (fixed + n * bytes <= room) return n;
  return fixed + bytes <= kSmemMax ? 1 : 0;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[n][i] = 0.f;
}

// Phase 1, one staged chunk of `subs` base sub-chunks (row stride
// `stride` elements): acc[i] += a_s[16 x chunk] . t_s[tile j]^T for the
// calling warp's n8 tiles j = warp + 4 i < nt of the staged rows. f32:
// 3xTF32, small terms first, each sub-chunk in an accumulator of its own
// (the tiles are independent chains), then added to acc; bf16: one
// m16n8k16 a k-step into acc, two tiles an ldmatrix. The sequence of
// operations on an element depends on D alone, not on the staged width.
__device__ __forceinline__ void scores_chunk(const float* a_s,
                                             const float* t_s, int stride,
                                             int subs, int nt, int warp,
                                             int lane, float (&acc)[kNT][4]) {
  const int g = lane >> 2, t = lane & 3;
  for (int sc = 0; sc < subs; ++sc) {
    float part[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < Op<float>::kChunk / 8; ++ks) {
      const int c = Op<float>::kChunk * sc + 8 * ks + t;
      uint32_t a_hi[4], a_lo[4];
      load_a(a_s, stride, g, c, a_hi, a_lo);
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int j = warp + 4 * i;
        if (j < nt) {  // the same in every lane of the warp
          const float* row = t_s + (8 * j + g) * stride + c;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(row[0], b_hi[0], b_lo[0]);
          split_tf32(row[4], b_hi[1], b_lo[1]);
          mma_tf32(part[i], a_lo, b_hi[0], b_hi[1]);
          mma_tf32(part[i], a_hi, b_lo[0], b_lo[1]);
          mma_tf32(part[i], a_hi, b_hi[0], b_hi[1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
  }
}

__device__ __forceinline__ void scores_chunk(const __nv_bfloat16* a_s,
                                             const __nv_bfloat16* t_s,
                                             int stride, int subs, int nt,
                                             int warp, int lane,
                                             float (&acc)[kNT][4]) {
  const int ksteps = subs * (Op<__nv_bfloat16>::kChunk / 16);
#pragma unroll 4
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4];  // rows 0-15 x k 0-7 (lanes 0-15), k 8-15 (lanes 16-31)
    ldmatrix_x4(a, a_s + (lane & 15) * stride + 16 * ks + 8 * (lane >> 4));
#pragma unroll
    for (int i = 0; i < kNT; i += 2) {
      const int j0 = warp + 4 * i, j1 = j0 + 4;
      if (j0 < nt) {  // the same in every lane of the warp
        // lanes 0-15 address tile j0, 16-31 tile j1 (j0 again past nt):
        // b0, b1 of j0, then of j1
        const int j = (lane & 16) && j1 < nt ? j1 : j0;
        uint32_t b[4];
        ldmatrix_x4(b, t_s + (8 * j + (lane & 7)) * stride + 16 * ks
                           + 8 * ((lane >> 3) & 1));
        mma_bf16(acc[i], a, b[0], b[1]);
        if (j1 < nt) mma_bf16(acc[i + 1], a, b[2], b[3]);
      }
    }
  }
}

// Phase 3, one staged tile of U (16 or 32 rows from row k0 of the held
// operand's columns): acc[n] += held[16 x tile's rows] . u_s[tile x the
// warp's 8 nc columns from c0], n < nc. `rows` of the tile are real.
__device__ __forceinline__ void product_tile(const float* held, int /*ls*/,
                                             int k0, int rows,
                                             const float* u_s, int us, int c0,
                                             int /*nc*/, int lane,
                                             float (&acc)[kMaxNC][4]) {
  // a held [16][36] tile holds 32 columns; a 16-row tile is one half of it
  const float* p = held + (k0 / 32) * kProbFloats + (k0 & 16);
  if (rows > 16)  // the same in every thread
    prob_times_rows_n<kMaxNC, 2>(p, u_s, us, c0, lane, acc);
  else if (rows > 0)
    prob_times_rows_n<kMaxNC, 1>(p, u_s, us, c0, lane, acc);
}

__device__ __forceinline__ void product_tile(const __nv_bfloat16* held,
                                             int ls, int k0, int rows,
                                             const __nv_bfloat16* u_s, int us,
                                             int c0, int nc, int lane,
                                             float (&acc)[kMaxNC][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (16 * kk >= rows) break;  // the same in every thread
    uint32_t a[4];
    ldmatrix_x4(a, held + (lane & 15) * ls + k0 + 16 * kk + 8 * (lane >> 4));
    const __nv_bfloat16* rows_at =
        u_s + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * us + c0;
#pragma unroll
    for (int n = 0; n < kMaxNC; n += 2) {
      if (n < nc) {  // the same in every thread
        // lanes 16-31 address columns n + 1 (inside the padded row when
        // that is past nc): b0, b1 of tile n, then of n + 1
        const int m = (lane & 16) ? n + 1 : n;
        uint32_t b[4];
        ldmatrix_x4_trans(b, rows_at + 8 * m);
        mma_bf16(acc[n], a, b[0], b[1]);
        if (n + 1 < nc) mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }
}

// the element of the held operand at (row, col): bf16 rounded, or f32 at its
// permuted place
__device__ __forceinline__ void put_held(float* held, int /*ls*/, int row,
                                         int col, float v) {
  held[(col / 32) * kProbFloats + row * kProbStride + prob_pos(col & 31)] = v;
}
__device__ __forceinline__ void put_held(__nv_bfloat16* held, int ls, int row,
                                         int col, float v) {
  held[row * ls + col] = __float2bfloat16(v);
}

// Phase 2's reductions over the held rows of the calling thread's group
// (red [kWarps][16] and the outputs are the group's; every thread of the
// block calls them, for the barriers). The calling thread holds, of its n8
// tiles j = warp + 4 i < nt (warp: within the group), element e of C
// fragment i at row g + 8 (e >> 1), column 8 j + 2 t + (e & 1). A row's
// value is formed by each thread over its elements (i ascending, e
// ascending), then by the row's four lanes (xor 1, then 2), then over the
// warps in order through red: the same order in every kernel, so the
// forward and the backward's recomputation agree bit for bit.
__device__ __forceinline__ void row_max(const float (&s)[kNT][4], int nt,
                                        int warp, int lane, float* red,
                                        float* m_s) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kNT; ++i)
    if (warp + 4 * i < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    if ((lane & 3) == 0) red[warp * kTileM + (lane >> 2) + 8 * h] = mx[h];
  }
  __syncthreads();
  const int lt = threadIdx.x % kThreads;  // the thread within its group
  if (lt < kTileM) {
    const float* r = red + lt;
    m_s[lt] =
        fmaxf(fmaxf(fmaxf(r[0], r[kTileM]), r[2 * kTileM]), r[3 * kTileM]);
  }
  __syncthreads();
}

// x[i][e] summed by rows (the order above) -> out_s[16]
__device__ __forceinline__ void row_sum(const float (&x)[kNT][4], int nt,
                                        int warp, int lane, float* red,
                                        float* out_s) {
  float sm[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kNT; ++i)
    if (warp + 4 * i < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[e >> 1] += x[i][e];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sm[h] += __shfl_xor_sync(0xffffffffu, sm[h], 1);
    sm[h] += __shfl_xor_sync(0xffffffffu, sm[h], 2);
    if ((lane & 3) == 0) red[warp * kTileM + (lane >> 2) + 8 * h] = sm[h];
  }
  __syncthreads();
  const int lt = threadIdx.x % kThreads;
  if (lt < kTileM) {
    const float* r = red + lt;
    out_s[lt] = ((r[0] + r[kTileM]) + r[2 * kTileM]) + r[3 * kTileM];
  }
  __syncthreads();
}

// the biased scores of the held rows: s * scale + bias (bias_s [L], the
// columns' bias), -inf at and past column L
__device__ __forceinline__ void bias_scores(float (&s)[kNT][4], int nt,
                                            int L, const float* bias_s,
                                            float scale, int warp,
                                            int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int j = warp + 4 * i;
    if (j < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        s[i][e] = col < L ? fmaf(s[i][e], scale, bias_s[col]) : -INFINITY;
      }
  }
}

// The row statistics of the held biased scores, and s -> p = exp(s - m):
// m_s and l_s (the rows' max and sum of p). A row whose columns are all
// masked sees every score at exactly -1e30: m = -1e30, p = 1, l = L.
__device__ __forceinline__ void softmax_rows(float (&s)[kNT][4], int nt,
                                             int warp, int lane, float* red,
                                             float* m_s, float* l_s) {
  row_max(s, nt, warp, lane, red, m_s);
  const int g = lane >> 2;
  const float m[2] = {m_s[g], m_s[g + 8]};
#pragma unroll
  for (int i = 0; i < kNT; ++i)
    if (warp + 4 * i < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = expf(s[i][e] - m[e >> 1]);
  row_sum(s, nt, warp, lane, red, l_s);
}

// the held operand's columns [L, ...) of the k16 steps phase 3 reads,
// zero (tiles past nt of the calling warp, up to 2 ceil(L / 16))
template <typename T>
__device__ __forceinline__ void zero_held_tail(T* held, int ls, int L, int nt,
                                               int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int nt2 = 2 * ((L + 15) / 16);
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int j = warp + 4 * i;
    if (j >= nt && j < nt2)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put_held(held, ls, g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1), 0.f);
  }
}

// Phase 3's results of one slice: rows g, g + 8 of the block, the warp's
// columns c0 + 8 n + 2 t (+1) of the slice [s0, s0 + w), times the row's
// scale; into out (row stride D) from row `row0`, rows < n_rows.
template <typename O>
__device__ __forceinline__ void store_slice(O* out, int row0, int n_rows,
                                            int D, int s0, int w, int c0,
                                            int nc, const float (&scale)[2],
                                            int lane,
                                            const float (&acc)[kMaxNC][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (row0 + row >= n_rows) continue;
    O* at = out + (size_t)(row0 + row) * D + s0;
#pragma unroll
    for (int n = 0; n < kMaxNC; ++n)
      if (n < nc)
        store_pair_t(at, c0 + 8 * n + 2 * t, w, D, acc[n][2 * h] * scale[h],
                     acc[n][2 * h + 1] * scale[h]);
  }
}

}  // namespace rows
}  // namespace attn
