// LayerNorm forward with its row statistics, float32 or bfloat16 operands,
// any feature width, for sm_90a.
//
// Replaces no Pallas kernel: in the JAX package XLA fuses the default
// LayerNorm (dostransformer_tpu/nn/layernorm.py `layer_norm`). It was added
// so that the port's default LayerNorm runs its backward on the single-pass
// kernel (csrc/layernorm_bwd.cu, raw-x form), which needs each row's mean
// and rstd. Per row of x [rows, D], all arithmetic in f32:
//
//   mean = sum(x) / D          var = sum((x - mean)^2) / D
//   rstd = 1 / sqrt(var + eps)
//   y    = (x - mean) * rstd * scale + bias      (rounded once to x's dtype)
//
// The variance is taken in two passes over the row held in registers, so
// it has no E[x^2] - E[x]^2 cancellation.
//
// What bounds it on an H100: bytes from device memory. x is read and y
// written once (2 * rows * D elements; 33.6 MB at 16,384 x 256 f32: 10 us
// at 3.35 TB/s) for ~8 flops per element; mean and rstd add 8 bytes a row.
//
// Design: a warp owns ONE row. In the vector form each lane holds NCH
// 16-byte vectors of it (4 floats or 8 bf16; lane l the vectors l + 32 i,
// so neighbouring lanes read neighbouring addresses), loaded once; the two
// sums are warp shuffles, y goes straight back as 16-byte stores, and lane
// 0 writes mean and rstd. Nothing is carried from row to row, so every row
// of a call is in flight at once and a block of 8 warps keeps 8 rows. At
// widths 256 and 512 a lane holds 8 or 16 floats (f32) or 8 or 16 bf16.
// Widths that are no multiple of the vector, or wider than 8 vectors a
// lane, take the scalar form: each lane strides the row three times (the
// second and third times from cache).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;  // 16-byte vectors a lane holds of a row

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

struct Operands {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;
  float* mean;
  float* rstd;
  int rows, D;
  float eps;
};

// Row r by the calling warp, vector form: lane l holds the 16-byte vectors
// l + 32 i (i < NCH) of the row; D a multiple of V, D <= 32 V NCH.
template <typename T, int NCH>
__device__ __forceinline__ void row_vector(const Operands& a, int r,
                                           int lane) {
  constexpr int V = 16 / (int)sizeof(T);
  const int D = a.D;
  const T* x = static_cast<const T*>(a.x) + (size_t)r * D;
  T* y = static_cast<T*>(a.y) + (size_t)r * D;
  float v[NCH][V];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int col = (lane + 32 * i) * V;
    if (col < D) unpack(*reinterpret_cast<const uint4*>(x + col), v[i]);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    if ((lane + 32 * i) * V < D) {
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[i][e];
    }
  const float mu = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    if ((lane + 32 * i) * V < D) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = v[i][e] - mu;
        q = fmaf(c, c, q);
      }
    }
  const float rs = rsqrtf(warp_sum(q) / (float)D + a.eps);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int col = (lane + 32 * i) * V;
    if (col < D) {
      float o[V];
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(a.scale + col + e));
        const float4 b = __ldg(reinterpret_cast<const float4*>(a.bias + col + e));
        o[e] = fmaf((v[i][e] - mu) * rs, g.x, b.x);
        o[e + 1] = fmaf((v[i][e + 1] - mu) * rs, g.y, b.y);
        o[e + 2] = fmaf((v[i][e + 2] - mu) * rs, g.z, b.z);
        o[e + 3] = fmaf((v[i][e + 3] - mu) * rs, g.w, b.w);
      }
      *reinterpret_cast<uint4*>(y + col) = pack(o);
    }
  }
  if (lane == 0) {
    a.mean[r] = mu;
    a.rstd[r] = rs;
  }
}

// Row r by the calling warp, scalar form, any D: the row is read for its
// mean, again (from cache) for its variance and again for y.
template <typename T>
__device__ __forceinline__ void row_scalar(const Operands& a, int r,
                                           int lane) {
  const int D = a.D;
  const T* x = static_cast<const T*>(a.x) + (size_t)r * D;
  T* y = static_cast<T*>(a.y) + (size_t)r * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_float(x[c]);
  const float mu = warp_sum(s) / (float)D;
  float q = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = to_float(x[c]) - mu;
    q = fmaf(d, d, q);
  }
  const float rs = rsqrtf(warp_sum(q) / (float)D + a.eps);
  for (int c = lane; c < D; c += 32)
    store(y + c, fmaf((to_float(x[c]) - mu) * rs, a.scale[c], a.bias[c]));
  if (lane == 0) {
    a.mean[r] = mu;
    a.rstd[r] = rs;
  }
}

// NCH: vectors a lane holds of a row, 0 for the scalar form.
template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads) ln_fwd_kernel(Operands a) {
  const int r = (int)blockIdx.x * kWarps + (int)threadIdx.x / 32;
  if (r >= a.rows) return;
  if constexpr (NCH == 0)
    row_scalar<T>(a, r, threadIdx.x % 32);
  else
    row_vector<T, NCH>(a, r, threadIdx.x % 32);
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

template <typename T>
cudaError_t dispatch(const Operands& a, int chunks, cudaStream_t st) {
  const dim3 grid((a.rows + kWarps - 1) / kWarps);
  switch (chunks) {
    case 1: ln_fwd_kernel<T, 1><<<grid, kThreads, 0, st>>>(a); break;
    case 2: ln_fwd_kernel<T, 2><<<grid, kThreads, 0, st>>>(a); break;
    case 4: ln_fwd_kernel<T, 4><<<grid, kThreads, 0, st>>>(a); break;
    case 8: ln_fwd_kernel<T, 8><<<grid, kThreads, 0, st>>>(a); break;
    default: ln_fwd_kernel<T, 0><<<grid, kThreads, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers into contiguous, 16-byte aligned tensors:
// x and y [rows, D] (float32, or bfloat16 when `bf16` is non-zero); scale
// and bias [D], mean and rstd [rows] float32. Any rows >= 1 and D >= 1. One
// launch, no scratch memory. Returns the CUDA error code of the launch (0
// on success).
extern "C" int dostpu_layer_norm_fwd(const void* x, const float* scale,
                                     const float* bias, void* y, float* mean,
                                     float* rstd, int rows, int D, float eps,
                                     int bf16, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  const Operands a = {x, scale, bias, y, mean, rstd, rows, D, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = vector_chunks(D, bf16);
  return bf16 ? dispatch<__nv_bfloat16>(a, chunks, st)
              : dispatch<float>(a, chunks, st);
}
