// Batched segment sum, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_segment_sum_kernel` of
// dostransformer_tpu/ops/segment.py (launched by `segment_sum_pallas`),
// batched over graphs as the JAX package's `batched_segment_sum` is:
//
//   out[b, n, f] = sum over e with ids[b, e] == n of data[b, e, f]
//
// for data [B, E, F], ids [B, E] int32 and out [B, N, F]. Ids below 0 or at
// or above N match no segment and are dropped. Sums are exact f32 additions.
//
// What bounds it on an H100: nothing but launch latency on the model's
// path. There it counts phDOS's edges per receiver (F = 1): a few hundred
// edges and a few dozen segments per graph, so every block reads a few KB.
// At wide F it reads each data row once per segment of its graph from L2.
// The TPU kernel routed rows to segments with one-hot matmuls on the MXU
// and skipped edge tiles outside a node tile's id range; here each block
// compares ids directly, which needs neither.
//
// Design: one block per (segment n, graph b, tile of TF features), TF the
// smallest power of two >= F, at most 256. The block's 256 threads are TF
// feature lanes x P = 256 / TF edge slots: slot p sums edges p, p + P,
// p + 2P, ... in index order, and the P partial sums are then added in a
// fixed binary tree in shared memory. The partition depends only on (E, F),
// so the result is the same bits on every run: no float atomics. At F = 1
// all 256 threads split the edges (consecutive threads read consecutive
// edges); at F >= 256 each thread walks every edge for its own feature, as
// `agg_kernel` in fused_mp.cu does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                   float* __restrict__ out, int N, int E, int F, int tf) {
  __shared__ float part[kThreads];
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % tf;  // feature within the tile
  const int slot = threadIdx.x / tf;  // edge slot
  const int slots = kThreads / tf;
  const int f = blockIdx.z * tf + lane;
  const int* ids_b = ids + (size_t)b * E;
  const float* data_b = data + (size_t)b * E * F;

  float acc = 0.f;
  if (f < F) {
    for (int e = slot; e < E; e += slots)
      if (ids_b[e] == n) acc += data_b[(size_t)e * F + f];
  }
  part[threadIdx.x] = acc;  // threadIdx.x == slot * tf + lane
  __syncthreads();
  for (int s = slots / 2; s > 0; s >>= 1) {
    if (slot < s) part[threadIdx.x] += part[threadIdx.x + s * tf];
    __syncthreads();
  }
  if (slot == 0 && f < F) out[((size_t)b * N + n) * F + f] = part[lane];
}

}  // namespace

// data [B, E, F] float32, ids [B, E] int32, out [B, N, F] float32: device
// pointers into contiguous tensors. E may be 0 (out is then all zero).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dostpu_segment_sum(const float* data, const int* ids,
                                  float* out, int B, int E, int F, int N,
                                  void* stream) {
  if (B <= 0 || E < 0 || F <= 0 || N <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  int tf = 1;
  while (tf < F && tf < kThreads) tf <<= 1;
  const int tiles = (F + tf - 1) / tf;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(N, B, tiles);
  segment_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, ids, out, N, E, F, tf);
  return cudaGetLastError();
}
