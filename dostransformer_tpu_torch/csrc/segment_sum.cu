// Batched segment sum, float32 or bfloat16, for sm_90a.
//
// Replaces the Pallas TPU kernel `_segment_sum_kernel` of
// dostransformer_tpu/ops/segment.py (launched by `segment_sum_pallas`),
// batched over graphs as the JAX package's `batched_segment_sum` is:
//
//   out[b, n, f] = sum over e with ids[b, e] == n of data[b, e, f]
//
// for data [B, E, F], ids [B, E] int32 and out [B, N, F]. Ids below 0 or at
// or above N match no segment and are dropped. Sums are exact f32 additions
// in a fixed order: no float atomics, the same bits on every run.
//
// What bounds it on an H100: reading data once (B E F floats) where F is
// wide; on the model's path (phDOS's edges per receiver, F = 1, a few
// hundred edges and a few dozen segments a graph) nothing but the launch.
// The TPU kernel routed rows to segments with one-hot matmuls on the MXU
// and skipped edge tiles outside a node tile's id range; here a block reads
// its graph's ids once and adds each row into the segment it names.
//
// Design: one block per (graph, slice of TF = L V features, range of NS
// segments), 256 threads. L feature lanes (V = 4 floats each, one 16-byte
// load, where F % 4 == 0, else V = 1) x P edge slots of them add edges;
// all 256 stage the graph's ids in shared memory, 2,048 at a time, 8 loads
// a thread in flight together, zero the row blocks and run the tree (at
// F = 1 and 128 edges, 16 threads staging 8 ids each one after the other
// took 2.4 us more than the parent design, measured). Slot p takes edges
// p, p + P, p + 2P, ... in index order, 8 of them a batch (the 8 rows'
// loads in flight together, then the adds), and adds each row
// into a private row block [NS][TF] of its own in shared memory: no two
// threads ever add to one address. A fixed binary tree over the P slots
// then sums the blocks, and the first writes the output. The partition is
// a function of (B, E, F, N) alone (plan): L shrinks until the graphs and
// feature slices make enough blocks for the card, NS holds every segment
// while the row blocks fit 96 KB, and P (a power of two) is as large as the
// row blocks allow and no larger than one batch a slot needs. Every data
// element is read once, by one thread.
//
// bfloat16 data (the phDOS edge count of a bf16 model) takes the same
// partition and the same kernels, instantiated for it: rows load as bf16
// (4 values, 8 bytes, a lane where V = 4) and are widened to f32 in
// registers, every sum is f32 in the same fixed order, and the output is
// rounded to bf16 once. So the bf16 form's output is the f32 form's on the
// widened data, rounded once; counts up to 256 are exact in bf16.
//
// F = 1 (the model's edge count) takes segment_count_kernel instead: a block
// per (segment, graph) whose 256 threads scan the graph's edges (eight in
// flight a thread, each row loaded beside its id: one trip to memory), then
// a fixed tree over the threads: the previous design's partition, with its
// two dependent loads made one. The slot design read 1.0-1.2 us above that
// design there (0.0071-0.0075 against 0.0061-0.0063 ms at the phDOS count on
// an H100), while at F = 256 it is 3x faster and at 2,048 edges 12x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSMs = 132;
constexpr int kIdChunk = 2048;         // ids staged at a time
constexpr int kBatch = 8;              // edges a slot has in flight
constexpr int kBudgetFloats = 24576;   // the slots' row blocks: 96 KB

struct Plan {
  int vec;     // V: floats a lane loads at once (4 or 1)
  int lanes;   // L
  int slots;   // P, a power of two
  int segs;    // NS: segments a block holds
  int slices;  // feature slices of TF = L V
  int seg_blocks;
  int id_chunk;  // ids staged at a time: all of them, up to kIdChunk
  size_t smem;
};

int pow2_floor(long x) {
  int p = 1;
  while ((long)p * 2 <= x) p *= 2;
  return p;
}

int pow2_ceil(long x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

Plan plan(int B, int E, int F, int N) {
  Plan p;
  if (F == 1) {  // segment_count_kernel: a block per segment, 256 edge slots
    p.vec = p.lanes = p.segs = p.slices = 1;
    p.slots = kMaxThreads;
    p.seg_blocks = N;
    p.id_chunk = 0;
    p.smem = 0;
    return p;
  }
  p.vec = F % 4 == 0 ? 4 : 1;
  const int vecs = (F + p.vec - 1) / p.vec;
  p.lanes = std::min(pow2_ceil(vecs), 32);
  while (p.lanes > 1
         && (long)B * ((vecs + p.lanes - 1) / p.lanes) < kSMs)
    p.lanes /= 2;
  const int tf = p.lanes * p.vec;
  p.segs = std::min(N, kBudgetFloats / tf);
  p.slots = std::min({kMaxThreads / p.lanes,
                      pow2_floor(kBudgetFloats / ((long)p.segs * tf)),
                      pow2_ceil(std::max(1, (E + kBatch - 1) / kBatch))});
  p.slices = (vecs + p.lanes - 1) / p.lanes;
  p.seg_blocks = (N + p.segs - 1) / p.segs;
  p.id_chunk = std::max(1, std::min(E, kIdChunk));
  p.smem = ((size_t)p.slots * p.segs * tf + p.id_chunk) * sizeof(float);
  return p;
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& a, const T& b) { a += b; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
};

// V values of a row of In at p, widened to f32
__device__ __forceinline__ float load_row(const float* p, Vec<1>) {
  return *p;
}
__device__ __forceinline__ float4 load_row(const float* p, Vec<4>) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float load_row(const __nv_bfloat16* p, Vec<1>) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float4 load_row(const __nv_bfloat16* p, Vec<4>) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);  // 4 values, 8 bytes
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

// an f32 sum as the output dtype holds it: rounded once
__device__ __forceinline__ void store_sum(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_sum(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// grid (feature slices, B, segment ranges), kMaxThreads threads: the first
// L * P add edges. A slot's first batch of rows is loaded before the ids
// arrive (the rows do not depend on them; only where they go does), so at
// F = 1 the ids and the rows come in one trip to device memory.
template <typename In, int V>
__global__ void __launch_bounds__(kMaxThreads)
segment_sum_kernel(const In* __restrict__ data, const int* __restrict__ ids,
                   In* __restrict__ out, int N, int E, int F, int L, int P,
                   int NS, int id_chunk) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) float smem[];
  const int tf = L * V;
  const int block_f = NS * tf;  // one slot's row block, in floats
  float* priv = smem;           // [P][NS][tf]
  int* ids_s = reinterpret_cast<int*>(smem + (size_t)P * block_f);
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * NS;
  const int ns = min(NS, N - n0);
  const int lane = threadIdx.x % L;
  const int slot = threadIdx.x / L;
  const int f = (blockIdx.x * L + lane) * V;  // this lane's first feature
  const bool adds = slot < P && f < F;
  const int* ids_b = ids + (size_t)b * E;
  const In* data_b = data + (size_t)b * E * F;
  float* mine = priv + (size_t)slot * block_f + lane * V;
  // whole 16-byte vectors where the blocks allow (block_f % 4 == 0)
  const bool wide = block_f % 4 == 0;

  if (wide) {
    for (int i = threadIdx.x; i < P * block_f / 4; i += blockDim.x)
      reinterpret_cast<float4*>(priv)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = threadIdx.x; i < P * block_f; i += blockDim.x) priv[i] = 0.f;
  }
  T val[kBatch];
  auto load_batch = [&](int c0, int ce, int e) {  // edges e, e + P, ...
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int ee = e + u * P;
      val[u] = ee < ce ? load_row(data_b + (size_t)(c0 + ee) * F + f,
                                  Vec<V>())
                       : Vec<V>::zero();
    }
  };
  for (int c0 = 0; c0 < E; c0 += id_chunk) {
    const int ce = min(id_chunk, E - c0);
    if (adds) load_batch(c0, ce, slot);  // in flight while the ids arrive
    if (c0 > 0) __syncthreads();  // the previous chunk's ids are consumed
    for (int i0 = threadIdx.x; i0 < ce; i0 += kBatch * blockDim.x) {
      int v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        v[u] = i < ce ? ids_b[c0 + i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < ce) ids_s[i] = v[u];
      }
    }
    __syncthreads();
    if (!adds) continue;  // the same for the whole of a lane's slots
    for (int e = slot; e < ce; e += P * kBatch) {
      if (e != slot) load_batch(c0, ce, e);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // in edge order
        const int ee = e + u * P;
        const int n = ee < ce ? ids_s[ee] - n0 : -1;
        if (n >= 0 && n < ns)
          Vec<V>::add(*reinterpret_cast<T*>(mine + n * tf), val[u]);
      }
    }
  }
  __syncthreads();
  // the slots' row blocks, added by a fixed binary tree
  for (int s = P / 2; s > 0; s >>= 1) {
    if (wide) {
      float4* p4 = reinterpret_cast<float4*>(priv);
      const int half = s * block_f / 4;
      for (int i = threadIdx.x; i < half; i += blockDim.x)
        Vec<4>::add(p4[i], p4[i + half]);
    } else {
      for (int i = threadIdx.x; i < s * block_f; i += blockDim.x)
        priv[i] += priv[i + s * block_f];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < ns * tf; i += blockDim.x) {
    const int n = i / tf;
    const int c = blockIdx.x * tf + i % tf;
    if (c < F) store_sum(out + ((size_t)b * N + n0 + n) * F + c, priv[i]);
  }
}

// F = 1: grid (N, B), kMaxThreads threads; thread t sums the values of the
// edges t, t + 256, ... whose id is this block's segment, in edge order
template <typename In>
__global__ void __launch_bounds__(kMaxThreads)
segment_count_kernel(const In* __restrict__ data,
                     const int* __restrict__ ids, In* __restrict__ out,
                     int N, int E) {
  __shared__ float part[kMaxThreads];
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int* ids_b = ids + (size_t)b * E;
  const In* data_b = data + (size_t)b * E;
  float acc = 0.f;
  for (int e0 = threadIdx.x; e0 < E; e0 += kBatch * kMaxThreads) {
    int id[kBatch];
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // the row does not wait for its id
      const int e = e0 + u * kMaxThreads;
      id[u] = e < E ? ids_b[e] : -1;
      v[u] = e < E ? load_row(data_b + e, Vec<1>()) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (id[u] == n) acc += v[u];
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kMaxThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) store_sum(out + (size_t)b * N + n, part[0]);
}

template <typename In>
int launch(const In* data, const int* ids, In* out, int B, int E, int F,
           int N, void* stream) {
  if (B <= 0 || E < 0 || F <= 0 || N <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  const Plan p = plan(B, E, F, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 1) {
    segment_count_kernel<In><<<dim3(N, B), kMaxThreads, 0, st>>>(
        data, ids, out, N, E);
    return cudaGetLastError();
  }
  if (p.seg_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(p.slices, B, p.seg_blocks);
  const int threads = kMaxThreads;
  auto kernel =
      p.vec == 4 ? segment_sum_kernel<In, 4> : segment_sum_kernel<In, 1>;
  if (p.smem > 48 * 1024) {  // above the default limit only
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, p.smem, st>>>(data, ids, out, N, E, F, p.lanes,
                                        p.slots, p.segs, p.id_chunk);
  return cudaGetLastError();
}

}  // namespace

// The partition a call at this shape takes: *vec floats a lane loads,
// *lanes feature lanes x *slots edge slots a block, *segs segments a block
extern "C" void dostpu_segment_sum_plan(int B, int E, int F, int N, int* vec,
                                        int* lanes, int* slots, int* segs) {
  const Plan p = plan(B, E, F, N);
  *vec = p.vec;
  *lanes = p.lanes;
  *slots = p.slots;
  *segs = p.segs;
}

// data [B, E, F] float32, ids [B, E] int32, out [B, N, F] float32: device
// pointers into contiguous, 16-byte aligned tensors. E may be 0 (out is
// then all zero). Returns the CUDA error code of the launch (0 on success).
extern "C" int dostpu_segment_sum(const float* data, const int* ids,
                                  float* out, int B, int E, int F, int N,
                                  void* stream) {
  return launch(data, ids, out, B, E, F, N, stream);
}

// The same with data and out bfloat16: f32 sums, rounded once.
extern "C" int dostpu_segment_sum_bf16(const __nv_bfloat16* data,
                                       const int* ids, __nv_bfloat16* out,
                                       int B, int E, int F, int N,
                                       void* stream) {
  return launch(data, ids, out, B, E, F, N, stream);
}
