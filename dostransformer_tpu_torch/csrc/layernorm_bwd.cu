// Single-pass LayerNorm backward, float32 or bfloat16 operands, for sm_90a.
//
// Replaces the Pallas TPU kernel `_ln_bwd_kernel` of
// dostransformer_tpu/nn/layernorm.py (launched by `_ln_bwd_pallas`, reached
// from the VJP of `layer_norm_lp`). From one read of xhat and dy (operand
// dtype) and rstd (f32), all arithmetic in f32:
//
//   g      = dy * scale
//   dx     = rstd * (g - mean_D(g) - xhat * mean_D(g * xhat))
//   dscale = sum_rows(dy * xhat)        dbias = sum_rows(dy)
//
// What bounds it on an H100: bytes. xhat and dy are read once and dx is
// written once (3 * rows * D elements; 9.9 MB at 3,216 x 256 f32) for ~10
// flops per element, far below the card's flops-per-byte ridge.
//
// Design: a reduction over D per row and a reduction over rows per column
// in the same pass. One warp owns a row at a time: lane l holds columns
// l + 32 c in registers, the two row means are warp shuffles, dx is written
// straight back. The same lane keeps running sums of dy * xhat and dy for
// its columns over all the rows its warp visits (warp w of the grid takes
// rows w, w + W, w + 2W, ...). A block adds its 8 warps' sums in warp order
// through shared memory and writes one [2, D] row of a scratch buffer; a
// second kernel adds the blocks' rows in block order. The partition depends
// only on (rows, D), and there are no float atomics, so a second run
// repeats bit for bit. The TPU kernel's [nb, L, D] blocks and its
// sublane-broadcast partials are tiling rules of that chip and are not
// reproduced: rows are flat, any count >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 264;  // two blocks per SM of an H100

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

int blocks_for(int rows) {
  const int want = (rows + kWarps - 1) / kWarps;
  return want < kMaxBlocks ? want : kMaxBlocks;
}

// D = 32 * NC feature columns; each lane owns columns lane + 32 * c.
// partial is [gridDim.x][2][D]: the block's sums of dy * xhat and of dy.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ xhat, const float* __restrict__ rstd,
              const T* __restrict__ dy, const float* __restrict__ scale,
              T* __restrict__ dx, float* __restrict__ partial, int rows) {
  constexpr int D = 32 * NC;
  __shared__ float part_s[kWarps][2 * D];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float sc[NC], dsc[NC], dbi[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    sc[c] = scale[lane + 32 * c];
    dsc[c] = 0.f;
    dbi[c] = 0.f;
  }

  const int stride = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + warp; r < rows; r += stride) {
    const T* xr = xhat + (size_t)r * D;
    const T* dr = dy + (size_t)r * D;
    float xh[NC], g[NC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      xh[c] = to_float(xr[lane + 32 * c]);
      const float d = to_float(dr[lane + 32 * c]);
      g[c] = d * sc[c];
      s1 += g[c];
      s2 = fmaf(g[c], xh[c], s2);
      dsc[c] = fmaf(d, xh[c], dsc[c]);
      dbi[c] += d;
    }
    s1 = warp_sum(s1) / (float)D;
    s2 = warp_sum(s2) / (float)D;
    const float rs = rstd[r];
    T* out = dx + (size_t)r * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(out + lane + 32 * c, rs * (g[c] - s1 - xh[c] * s2));
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    part_s[warp][lane + 32 * c] = dsc[c];
    part_s[warp][D + lane + 32 * c] = dbi[c];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * D; j += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part_s[w][j];  // warp order
    partial[(size_t)blockIdx.x * 2 * D + j] = s;
  }
}

// dscale[j] and dbias[j]: the blocks' partial rows added in block order.
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ dscale,
                                     float* __restrict__ dbias, int blocks,
                                     int D) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * D) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * 2 * D + j];
  if (j < D)
    dscale[j] = s;
  else
    dbias[j - D] = s;
}

template <typename T, int NC>
cudaError_t launch(const void* xhat, const float* rstd, const void* dy,
                   const float* scale, void* dx, float* dscale, float* dbias,
                   float* partial, int rows, cudaStream_t st) {
  const int blocks = blocks_for(rows);
  ln_bwd_kernel<T, NC><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(xhat), rstd, static_cast<const T*>(dy), scale,
      static_cast<T*>(dx), partial, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int D = 32 * NC;
  ln_bwd_reduce_kernel<<<(2 * D + 127) / 128, 128, 0, st>>>(
      partial, dscale, dbias, blocks, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xhat, const float* rstd, const void* dy,
                     const float* scale, void* dx, float* dscale,
                     float* dbias, float* partial, int rows, int D,
                     cudaStream_t st) {
  switch (D / 32) {
#define DOSTPU_CASE(nc)                                                     \
  case nc:                                                                  \
    return launch<T, nc>(xhat, rstd, dy, scale, dx, dscale, dbias, partial, \
                         rows, st);
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

// Rows of the [blocks, 2, D] float32 scratch buffer the launch needs.
extern "C" int dostpu_layer_norm_bwd_blocks(int rows) {
  return rows > 0 ? blocks_for(rows) : 0;
}

// All pointers are device pointers into contiguous, 16-byte aligned tensors:
// xhat, dy and dx [rows, D] (float32, or bfloat16 when `bf16` is non-zero);
// rstd [rows], scale, dscale and dbias [D] and partial
// [dostpu_layer_norm_bwd_blocks(rows), 2, D] float32. D must be a multiple
// of 32 and at most 512. Returns the CUDA error code of the launches (0 on
// success).
extern "C" int dostpu_layer_norm_bwd(const void* xhat, const float* rstd,
                                     const void* dy, const float* scale,
                                     void* dx, float* dscale, float* dbias,
                                     float* partial, int rows, int D,
                                     int bf16, void* stream) {
  if (rows <= 0 || D <= 0 || D % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(xhat, rstd, dy, scale, dx, dscale, dbias,
                                   partial, rows, D, st);
  return dispatch<float>(xhat, rstd, dy, scale, dx, dscale, dbias, partial,
                         rows, D, st);
}
