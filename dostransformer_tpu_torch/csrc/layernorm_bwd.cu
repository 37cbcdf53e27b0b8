// LayerNorm backward in one launch, float32 or bfloat16 operands, any
// feature width, for sm_90a.
//
// Replaces the Pallas TPU kernel `_ln_bwd_kernel` of
// dostransformer_tpu/nn/layernorm.py (launched by `_ln_bwd_pallas`, reached
// from the VJP of `layer_norm_lp`). From xhat and dy (operand dtype) and
// rstd (f32), all arithmetic in f32:
//
//   g      = dy * scale
//   dx     = rstd * (g - mean_D(g) - xhat * mean_D(g * xhat))
//   dscale = sum_rows(dy * xhat)        dbias = sum_rows(dy)
//
// A second operand form takes the raw x with (mean, rstd) and forms
// xhat = (x - mean) * rstd in the kernel, rounded to the operand dtype as
// the plain version rounds it: the caller that only has x (the LayerNorm-
// fused attention's backward) then writes no xhat to memory.
//
// What bounds it on an H100: bytes from device memory. xhat and dy are read
// and dx is written (3 * rows * D elements; 9.9 MB at 3,216 x 256 f32: 3 us
// at 3.35 TB/s) for ~10 flops per element. At the row counts of a train
// step (128 ... 3,216) that traffic is as short as a launch's latency, so
// what decides the time is the chain of dependent steps behind the loads:
// a reduction over D per row, and a reduction over rows per column that
// crosses blocks. A ticket ("the last block adds the partials") puts two
// fences, an atomic and a second round of loads from device memory behind
// the rows (measured on an H100: 4.8 us over an empty kernel at 128 rows,
// no better than two launches).
//
// Design: the two reductions never meet. One launch holds two kinds of
// blocks, and no block waits for device memory twice:
//   * row blocks: a warp owns ONE row, 16 bytes a lane a load (4 floats or
//     8 bf16, neighbouring lanes on neighbouring addresses), the two row
//     means by warp shuffles, dx straight back as 16-byte stores. Nothing
//     is carried from row to row, so every row of a train step is in
//     flight at once.
//   * column blocks: a block owns a slab of 128 bytes of columns (32
//     floats or 64 bf16; whole cache lines, eight threads a row) and a run
//     of rows, and reads that slab of dy and xhat again (the operands of a
//     train step stay in L2, so device memory is read once). A thread sums
//     over its rows in row order, then lanes by shuffles, warps in warp
//     order through shared memory, and the 1-8 blocks of a thread-block
//     cluster that share a slab in rank order: each pushes its sums into
//     the first block's shared memory, which writes the slab of dscale and
//     dbias. The cluster's first barrier ("every block has started") is
//     split around the loads and costs nothing; one barrier stands between
//     the sums and the result, and a cluster of one block takes none. No
//     scratch memory, no ticket, no fence, no float atomics; every sum has
//     a fixed order, so a second run repeats bit for bit.
// The partition follows from (rows, D, dtype) alone: clusters grow while the
// column blocks still fit one block an SM and a block keeps eight passes of
// rows (a barrier costs as much). Widths that are no multiple of the 16-byte vector, or too wide for a
// lane's registers, take a scalar form of both kinds of block (a row is
// then read twice, the second time from cache).
// The TPU kernel's [nb, L, D] blocks and sublane-broadcast partials are
// tiling rules of that chip and are not reproduced: rows are flat, any
// count >= 1.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;     // most blocks of a cluster (portable)
constexpr int kColumnBlocks = 132; // most column blocks: one an SM
constexpr int kMaxChunks = 8;      // 16-byte vectors a lane holds of a row
constexpr int kSlabThreads = 8;    // threads that share a row of a slab
constexpr int kPassesToSplit = 8;  // passes a block keeps when a slab is split
constexpr int kBatch = 8;          // rows a column thread has in flight
constexpr int kMinBlocks = 2;      // blocks an SM must hold (the registers' cap)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// 16 bytes as 4 floats or 8 bf16 values, and back
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
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// V elements at p: one 16-byte load (V = 4 floats or 8 bf16) or one element
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1)
    v[0] = to_float(*p);
  else
    unpack(*reinterpret_cast<const uint4*>(p), v);
}

// The two halves of the cluster's barrier (release on arrival, acquire on
// leaving); every thread of every block of the cluster executes both, each
// warp converged (the aligned forms ask for that).
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// V elements as they lie in memory (the column blocks keep a batch of rows
// in flight: a register for every 4 bytes, not for every element)
template <typename T, int V>
struct Raw {
  uint4 bits;
  __device__ __forceinline__ void load(const T* p) {
    bits = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void floats(float (&v)[V]) const {
    unpack(bits, v);
  }
};
template <typename T>
struct Raw<T, 1> {
  T bits;
  __device__ __forceinline__ void load(const T* p) { bits = *p; }
  __device__ __forceinline__ void floats(float (&v)[1]) const {
    v[0] = to_float(bits);
  }
};

struct Operands {
  const void* xin;    // xhat, or x when mean is not null
  const float* mean;
  const float* rstd;
  const void* dy;
  const float* scale;
  void* dx;
  float* dscale;
  float* dbias;
  int rows, D;
};

// A column block: dscale and dbias of the slab blockIdx.x / cluster size,
// over the rows of this block's rank in the cluster. The cluster's barrier
// is split: every block arrives when it starts ("my shared memory exists")
// and waits only after its own sums are done, so that barrier hides behind
// the loads; the blocks then push their sums into the first block's shared
// memory, and one more barrier stands between the rows and the result. A
// cluster of one block takes no barrier at all.
template <typename T, int V, bool RAW>
__device__ __forceinline__ void column_block(const Operands& a,
                                             int rows_per_rank) {
  // the slab: 128 bytes of columns in the vector form (eight threads a
  // row), 8 columns in the scalar form (eight threads a row)
  constexpr int TPR = kSlabThreads;      // threads a row
  constexpr int E = TPR * V;
  constexpr int RPP = kThreads / TPR;    // rows a pass
  __shared__ float warp_part[kWarps][2 * E];
  __shared__ float rank_part[kMaxCluster][2 * E];  // used in the first block
  const T* xin = static_cast<const T*>(a.xin);
  const T* dy = static_cast<const T*>(a.dy);
  cg::cluster_group cluster = cg::this_cluster();
  const int nr = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  if (nr > 1) cluster_arrive();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = threadIdx.x % TPR;
  const int col = (blockIdx.x / nr) * E + sub * V;
  const int r_begin = min(a.rows, rank * rows_per_rank);
  const int r_end = min(a.rows, r_begin + rows_per_rank);

  float sx[V], sd[V];  // this thread's sums of dy * xhat and of dy
#pragma unroll
  for (int e = 0; e < V; ++e) sx[e] = sd[e] = 0.f;
  if (col < a.D) {
    // batches of kBatch rows: all of a batch's loads are issued before any
    // is used (a remainder loop would take them one latency at a time)
    for (int r0 = r_begin + threadIdx.x / TPR; r0 < r_end;
         r0 += kBatch * RPP) {
      Raw<T, V> x[kBatch], d[kBatch];
      float mu[kBatch], rs[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = r0 + j * RPP;
        if (r < r_end) {
          x[j].load(xin + (size_t)r * a.D + col);
          d[j].load(dy + (size_t)r * a.D + col);
          mu[j] = RAW ? a.mean[r] : 0.f;
          rs[j] = RAW ? a.rstd[r] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {  // row order
        if (r0 + j * RPP < r_end) {
          float xf[V], df[V];
          x[j].floats(xf);
          d[j].floats(df);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xh =
                RAW ? rounded<T>((xf[e] - mu[j]) * rs[j]) : xf[e];
            sx[e] = fmaf(df[e], xh, sx[e]);
            sd[e] += df[e];
          }
        }
      }
    }
  }
  // the lanes that hold the same columns, then the warps in warp order
#pragma unroll
  for (int o = TPR; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sx[e] += __shfl_xor_sync(0xffffffffu, sx[e], o);
      sd[e] += __shfl_xor_sync(0xffffffffu, sd[e], o);
    }
  if (lane < TPR) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      warp_part[warp][sub * V + e] = sx[e];
      warp_part[warp][E + sub * V + e] = sd[e];
    }
  }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < 2 * E) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
  }
  if (nr > 1) {
    cluster_wait();  // every block of the cluster has started
    if (threadIdx.x < 2 * E)
      cluster.map_shared_rank(&rank_part[0][0], 0)[rank * 2 * E + threadIdx.x] =
          s;
    cluster_arrive();
    cluster_wait();  // the pushed sums have landed in the first block
    if (rank != 0) return;
    if (threadIdx.x < 2 * E) {
      s = 0.f;
      for (int r = 0; r < nr; ++r) s += rank_part[r][threadIdx.x];  // rank order
    }
  }
  if (threadIdx.x < 2 * E) {
    const int c = (blockIdx.x / nr) * E + threadIdx.x % E;
    if (c < a.D) (threadIdx.x < E ? a.dscale : a.dbias)[c] = s;
  }
}

// dx of row r by the calling warp, vector form: lane l holds the 16-byte
// vectors l + 32 i (i < NCH) of the row; D a multiple of V, D <= 32 V NCH.
template <typename T, int NCH, bool RAW>
__device__ __forceinline__ void row_vector(const Operands& a, int r,
                                           int lane) {
  constexpr int V = 16 / (int)sizeof(T);
  const int D = a.D;
  const T* xin = static_cast<const T*>(a.xin) + (size_t)r * D;
  const T* dy = static_cast<const T*>(a.dy) + (size_t)r * D;
  T* dx = static_cast<T*>(a.dx) + (size_t)r * D;
  float xh[NCH][V], g[NCH][V];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int col = (lane + 32 * i) * V;
    if (col < D) {
      load_vec<T, V>(xin + col, xh[i]);
      load_vec<T, V>(dy + col, g[i]);
    }
  }
  const float mu = RAW ? a.mean[r] : 0.f;
  const float rs = a.rstd[r];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int col = (lane + 32 * i) * V;
    if (col < D) {
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 s4 =
            __ldg(reinterpret_cast<const float4*>(a.scale + col + e));
        g[i][e] *= s4.x; g[i][e + 1] *= s4.y;
        g[i][e + 2] *= s4.z; g[i][e + 3] *= s4.w;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (RAW) xh[i][e] = rounded<T>((xh[i][e] - mu) * rs);
        s1 += g[i][e];
        s2 = fmaf(g[i][e], xh[i][e], s2);
      }
    }
  }
  s1 = warp_sum(s1) / (float)D;
  s2 = warp_sum(s2) / (float)D;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int col = (lane + 32 * i) * V;
    if (col < D) {
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = rs * (g[i][e] - s1 - xh[i][e] * s2);
      *reinterpret_cast<uint4*>(dx + col) = pack(o);
    }
  }
}

// dx of row r by the calling warp, scalar form, any D: the row is read for
// its two means and again (from cache) for dx.
template <typename T, bool RAW>
__device__ __forceinline__ void row_scalar(const Operands& a, int r,
                                           int lane) {
  const int D = a.D;
  const T* xin = static_cast<const T*>(a.xin) + (size_t)r * D;
  const T* dy = static_cast<const T*>(a.dy) + (size_t)r * D;
  T* dx = static_cast<T*>(a.dx) + (size_t)r * D;
  const float mu = RAW ? a.mean[r] : 0.f;
  const float rs = a.rstd[r];
  auto xhat_at = [&](int c) {
    const float x = to_float(xin[c]);
    return RAW ? rounded<T>((x - mu) * rs) : x;
  };
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float g = to_float(dy[c]) * a.scale[c];
    s1 += g;
    s2 = fmaf(g, xhat_at(c), s2);
  }
  s1 = warp_sum(s1) / (float)D;
  s2 = warp_sum(s2) / (float)D;
  for (int c = lane; c < D; c += 32) {
    const float g = to_float(dy[c]) * a.scale[c];
    store(dx + c, rs * (g - s1 - xhat_at(c) * s2));
  }
}

// Blocks [0, column_blocks) are column blocks, the rest row blocks of
// kWarps rows each. NCH: vectors a lane holds of a row, 0 for the scalar
// form. RAW: xin is x and xhat is formed from (mean, rstd).
template <typename T, int NCH, bool RAW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ln_bwd_kernel(Operands a, int column_blocks, int rows_per_rank) {
  if ((int)blockIdx.x < column_blocks) {
    column_block<T, NCH == 0 ? 1 : 16 / (int)sizeof(T), RAW>(a, rows_per_rank);
    return;
  }
  const int r = ((int)blockIdx.x - column_blocks) * kWarps + threadIdx.x / 32;
  if (r >= a.rows) return;
  if constexpr (NCH == 0)
    row_scalar<T, RAW>(a, r, threadIdx.x % 32);
  else
    row_vector<T, NCH, RAW>(a, r, threadIdx.x % 32);
}

// 16-byte vectors a lane must hold for width D (1, 2, 4 or 8), or 0 when
// the width takes the scalar form
int vector_chunks(int D, int bf16) {
  const int V = bf16 ? 8 : 4;
  if (D % V != 0) return 0;
  for (int nch = 1; nch <= kMaxChunks; nch *= 2)
    if (D <= 32 * V * nch) return nch;
  return 0;
}

// What the host decides from (rows, D, dtype) alone.
struct Plan {
  int chunks;         // vector_chunks
  int slabs;          // column slabs
  int cluster;        // blocks that share a slab: 1, 2, 4 or 8
  int rows_per_rank;  // rows of one of them
  int grid;           // column blocks + row blocks, rounded up to clusters
};

Plan make_plan(int rows, int D, int bf16) {
  Plan p;
  p.chunks = vector_chunks(D, bf16);
  const int V = p.chunks ? (bf16 ? 8 : 4) : 1;
  const int E = kSlabThreads * V;
  const int rows_a_pass = kThreads / kSlabThreads;
  p.slabs = (D + E - 1) / E;
  p.cluster = 1;
  while (p.cluster < kMaxCluster && p.slabs * 2 * p.cluster <= kColumnBlocks &&
         rows > kPassesToSplit * rows_a_pass * p.cluster)
    p.cluster *= 2;
  p.rows_per_rank = (rows + p.cluster - 1) / p.cluster;
  const int blocks = p.slabs * p.cluster + (rows + kWarps - 1) / kWarps;
  p.grid = (blocks + p.cluster - 1) / p.cluster * p.cluster;
  return p;
}

template <typename T, int NCH, bool RAW>
cudaError_t launch(const Operands& a, const Plan& p, cudaStream_t st) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.grid);
  config.blockDim = dim3(kThreads);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, ln_bwd_kernel<T, NCH, RAW>, a,
                            p.slabs * p.cluster, p.rows_per_rank);
}

template <typename T, bool RAW>
cudaError_t dispatch(const Operands& a, const Plan& p, cudaStream_t st) {
  switch (p.chunks) {
    case 1: return launch<T, 1, RAW>(a, p, st);
    case 2: return launch<T, 2, RAW>(a, p, st);
    case 4: return launch<T, 4, RAW>(a, p, st);
    case 8: return launch<T, 8, RAW>(a, p, st);
    default: return launch<T, 0, RAW>(a, p, st);
  }
}

}  // namespace

// The partition of `rows` rows of width D (bf16 operands when `bf16` is
// non-zero): 1 for the vector form or 0 for the scalar form, the column
// slabs, the blocks of the cluster that shares a slab, the rows of one of
// them, and the blocks of the launch.
extern "C" void dostpu_layer_norm_bwd_plan(int rows, int D, int bf16,
                                           int* vector_form, int* slabs,
                                           int* cluster, int* rows_per_rank,
                                           int* grid) {
  const Plan p = make_plan(rows > 0 ? rows : 1, D > 0 ? D : 1, bf16);
  *vector_form = p.chunks ? 1 : 0;
  *slabs = p.slabs;
  *cluster = p.cluster;
  *rows_per_rank = p.rows_per_rank;
  *grid = p.grid;
}

// All pointers are device pointers into contiguous, 16-byte aligned tensors:
// xin, dy and dx [rows, D] (float32, or bfloat16 when `bf16` is non-zero);
// rstd [rows], scale, dscale and dbias [D] float32. `mean` is null (xin is
// xhat) or [rows] float32 (xin is the raw x; xhat = (x - mean) * rstd is
// formed in the kernel, rounded to the operand dtype). Any rows >= 1 and
// D >= 1. One launch, no scratch memory. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int dostpu_layer_norm_bwd(const void* xin, const float* mean,
                                     const float* rstd, const void* dy,
                                     const float* scale, void* dx,
                                     float* dscale, float* dbias, int rows,
                                     int D, int bf16, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  const Plan p = make_plan(rows, D, bf16);
  const Operands a = {xin, mean, rstd, dy, scale, dx, dscale, dbias, rows, D};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool raw = mean != nullptr;
  if (bf16)
    return raw ? dispatch<__nv_bfloat16, true>(a, p, st)
               : dispatch<__nv_bfloat16, false>(a, p, st);
  return raw ? dispatch<float, true>(a, p, st)
             : dispatch<float, false>(a, p, st);
}
