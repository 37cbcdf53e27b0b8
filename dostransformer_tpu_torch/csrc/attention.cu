// Projection-free attention forward, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel` of
// dostransformer_tpu/ops/attention.py (launched by `_fwd_kernel_call` and
// `_fwd_kernel_call_nopad`, public name `fused_attention`):
//
//   out[b] = softmax(q[b] k[b]^T * D^-0.5 + bias[b]) v[b]
//
// one head, no projections, scores and softmax in f32; bias is 0 for a key
// that is attended and -1e30 for a masked one.
//
// What bounds it on an H100: 4*Lq*Lk*D flops per batch element on the FP32
// pipes (the flagship self-attention, 16 x 201 x 201 x 256, is 0.66 GFLOP);
// the operands are small and stay in L2. The TPU kernel held the whole
// [Lq, Lk] score tile in VMEM; a block here has far less shared memory, so
// keys stream through in tiles with an online softmax and any Lk works.
//
// Design: one block per (tile of kTileQ query rows, batch element), 8
// warps, kRows query rows per warp. For each tile of 32 keys, K and V are
// staged in shared memory (K rows padded by 4 floats so that the lanes'
// 16-byte loads hit distinct banks); lane j scores key j against the warp's
// query rows, so each K and V element read from shared memory feeds kRows
// rows,
// the row max and sum are warp reductions, and each lane accumulates D/32
// output columns in registers, rescaled when the running max moves. A row
// whose keys are all masked sees every score at -1e30 and averages V
// uniformly, as the plain version does; it never produces NaN.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 2;       // query rows per warp
constexpr int kTileQ = kThreads / 32 * kRows;  // query rows per block
constexpr int kTileK = 32;     // keys per tile (1 per lane)

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

constexpr size_t smem_floats(int d) {
  return (size_t)kTileQ * d + (size_t)kTileK * (d + 4) + (size_t)kTileK * d;
}

// D = 32 * NC feature columns; each lane owns columns lane + 32 * c.
template <int NC>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                float* __restrict__ out, int Lq, int Lk, float scale) {
  constexpr int D = 32 * NC;
  constexpr int D4 = D / 4;
  constexpr int KS = D + 4;  // padded K row stride (floats)
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [kTileQ][D]
  float* k_s = q_s + kTileQ * D;          // [kTileK][KS]
  float* v_s = k_s + kTileK * KS;         // [kTileK][D]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = threadIdx.x; idx < kTileQ * D4; idx += kThreads) {
    const int i = idx / D4;
    const int c = idx % D4;
    float4 val = zero4;
    if (q0 + i < Lq)
      val = reinterpret_cast<const float4*>(q + ((size_t)b * Lq + q0 + i) * D)[c];
    reinterpret_cast<float4*>(q_s + i * D)[c] = val;
  }

  float m_run[kRows], l_run[kRows], o[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    __syncthreads();  // q_s is loaded / the previous key tile is consumed
    for (int idx = threadIdx.x; idx < kTileK * D4; idx += kThreads) {
      const int j = idx / D4;
      const int c = idx % D4;
      float4 kv = zero4, vv = zero4;
      if (k0 + j < Lk) {
        const size_t row = ((size_t)b * Lk + k0 + j) * D;
        kv = reinterpret_cast<const float4*>(k + row)[c];
        vv = reinterpret_cast<const float4*>(v + row)[c];
      }
      reinterpret_cast<float4*>(k_s + j * KS)[c] = kv;
      reinterpret_cast<float4*>(v_s + j * D)[c] = vv;
    }
    __syncthreads();

    const int j = k0 + lane;
    const bool valid = j < Lk;
    const float bj = valid ? bias[(size_t)b * Lk + j] : 0.f;
    // scores of this lane's key against the warp's rows: each K element
    // read from shared memory feeds all kRows rows
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * KS);
    const float4* qrow = reinterpret_cast<const float4*>(q_s + warp * kRows * D);
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D4; ++c) {
      const float4 kk = krow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = qrow[r * D4 + c];
        s[r] = fmaf(a.x, kk.x, s[r]);
        s[r] = fmaf(a.y, kk.y, s[r]);
        s[r] = fmaf(a.z, kk.z, s[r]);
        s[r] = fmaf(a.w, kk.w, s[r]);
      }
    }
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sr = valid ? s[r] * scale + bj : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(sr));
      p[r] = valid ? expf(sr - m_new) : 0.f;
      const float corr = expf(m_run[r] - m_new);  // 0 on the first tile
      l_run[r] = l_run[r] * corr + warp_sum(p[r]);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= corr;
    }
    // o += p V over the tile: each V element read once feeds all rows
    for (int jj = 0; jj < kTileK; ++jj) {
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pj[r] = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = v_s[jj * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) o[r][c] = fmaf(pj[r], vv, o[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i >= Lq) continue;
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[((size_t)b * Lq + i) * D + lane + 32 * c] = o[r][c] * inv;
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* out, int B, int Lq, int Lk,
                   float scale, cudaStream_t st) {
  const size_t smem = smem_floats(32 * NC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kTileQ - 1) / kTileQ, B);
  attn_fwd_kernel<NC><<<grid, kThreads, smem, st>>>(q, k, v, bias, out, Lq,
                                                    Lk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dostpu_attention_max_dim() { return 32 * 16; }

// All pointers are device pointers into contiguous, 16-byte aligned float32
// tensors: q [B, Lq, D], k/v [B, Lk, D], bias [B, Lk]; out [B, Lq, D].
// D must be a multiple of 32 and at most dostpu_attention_max_dim().
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dostpu_attention_fwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    float* out, int B, int Lq, int Lk, int D,
                                    float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || D % 32 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / 32) {
#define DOSTPU_CASE(nc) \
  case nc:              \
    return launch<nc>(q, k, v, bias, out, B, Lq, Lk, scale, st);
    DOSTPU_CASE(1) DOSTPU_CASE(2) DOSTPU_CASE(3) DOSTPU_CASE(4)
    DOSTPU_CASE(5) DOSTPU_CASE(6) DOSTPU_CASE(7) DOSTPU_CASE(8)
    DOSTPU_CASE(9) DOSTPU_CASE(10) DOSTPU_CASE(11) DOSTPU_CASE(12)
    DOSTPU_CASE(13) DOSTPU_CASE(14) DOSTPU_CASE(15) DOSTPU_CASE(16)
#undef DOSTPU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
