// The transformer layer's FFN in float32 on the tensor cores, for sm_90a:
// kernel #8, one templated GEMM for fc1 and fc2, forward and backward.
//
// It replaces no Pallas kernel: in the JAX package XLA runs the FFN
// (dostransformer_tpu/nn/transformer.py, Dense -> relu -> Dense). It was
// added because on the H100 cuBLAS runs these f32 products on the CUDA
// cores (TF32 is off: 67 TFLOP/s at most), where a train step of the eDOS
// model spent about a third of its device time. Computed here, for the
// layer's rows x [M, D], W1 [4D, D], W2 [D, 4D]:
//
//   forward   H  = relu(x W1^T + b1)           Y  = H W2^T + b2
//   backward  dH = (dY W2) * (H > 0)           dX = dH W1
//             dW2 = dY^T H, db2 = sum_rows dY  dW1 = dH^T x, db1 = sum_rows dH
//
// What bounds it on an H100: operations. Forward and backward are 48 D^2
// flops a row against about 16 D floats a row read or written once (x, H
// and Y, dY, dH and dX), ~190 flops a byte at D = 256; the tensor cores'
// f32-accurate rate below (165 TFLOP/s) over 3.35 TB/s is ~50.
//
// f32 accuracy on the TF32 tensor cores (3xTF32, gemm_tf32.cuh): each
// operand is split into TF32 hi + lo and a product is hi*hi + hi*lo +
// lo*hi, summed in f32. No product is made in 1xTF32 or bf16.
//
// Design (one kernel, ffn_gemm_kernel<TN, EPI>; two small helpers; the
// GEMM's body, its reduce and their launchers are gemm_tf32.cuh's, which
// kernel #9 in linear.cu shares):
//   * A block is two warpgroups, one CTA an SM, persistent over work units
//     of C [128 x 128]; each warpgroup owns 64 rows and runs `wgmma`
//     m64n128k8 (TF32 in, f32 out). One thread keeps a ring of 4 stages of
//     32-deep K chunks in flight with TMA (128-byte swizzle) and mbarriers,
//     so the next unit's loads run under the current unit's epilogue.
//   * A (the activation) comes from registers: each thread reads its
//     fragment from the staged raw tile and splits it there, in whatever
//     layout the tile has, so a transposed A costs nothing; the next
//     chunk's fragments are read and split (a second register buffer)
//     while the tensor core runs this chunk's products. tf32 `wgmma` reads
//     its shared-memory operand K-major only:
//       - NT (forward, dX): C = A B^T with B a weight. ffn_split_kernel
//         writes each weight's hi and lo once a call, K-major (transposed
//         for dX), and TMA loads them straight into wgmma's layout.
//       - TN (dW): C = G^T X over the rows, both operands row-major in M.
//         G is A (read transposed from registers); X is split by both
//         warpgroups into K-major hi and lo tiles in one pass over the
//         staged chunk (the transpose is that pass's addressing), three
//         buffers in turn behind a named barrier.
//   * Each 32-deep chunk's wgmma sum (12 products) is added into an f32
//     total by one FADD a value: the tensor core's own f32 accumulation
//     loses accuracy over many products (on the H100 the forward's error
//     against f64 read 3.3e-6 with a whole K of 256 summed there, 4.3e-7
//     with a chunk's, cuBLAS's f32 SGEMM 5.0e-7), so K = 25,728 rows in dW
//     sums like K = 804 chunks in f32.
//   * Epilogues (the bias and mask loads all issued first): + bias and
//     ReLU (fc1 writes H once, f32, for the backward); + bias (fc2); the
//     ReLU mask read from H, its rows fetched into L2 at the unit's start
//     (fc2's dX gives fc1's dY with no threshold pass); plain (dX); the TN
//     unit's partial dW of its rows, and the column sums of G (db,
//     compensated over the chunks) in the units of the first column tile.
//   * dW splits the rows over S units of each output tile (S = the SMs
//     over the tiles); ffn_reduce_kernel then sums the S partials of dW
//     and db in split order. No float atomics: every sum has one order,
//     so a rerun repeats bit for bit.
// The kernel allocates nothing (the wrapper's scratch holds the split
// weights, dH and the partials) and launches on the caller's stream with
// no synchronise, so it can be captured in a CUDA graph. Shapes: any
// M >= 1, D a multiple of 32 (ragged M, N and K tiles are TMA's zero fill
// and the epilogue's guards).

#include "gemm_tf32.cuh"

namespace {

template <bool TN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_b_lo,
                    const Args args) {
  gemm_tf32_body<TN, EPI>(map_a, map_b, map_b_lo, args);
}

// Each weight split once a call into TF32 hi and lo, K-major for the NT
// kernel: w [rows][cols] as it is (forward) or transposed to [cols][rows]
// (dX). One launch splits both weights (blockIdx.y); a block does a 32 x 32
// tile.
struct SplitArgs {
  const float* w[2];
  float* hi[2];
  float* lo[2];
  int rows[2], cols[2];
};

template <bool T>
__global__ void __launch_bounds__(256)
    ffn_split_kernel(const SplitArgs a) {
  __shared__ float tile[32][33];
  const int z = blockIdx.y;
  const int rows = a.rows[z], cols = a.cols[z];
  const int tr = blockIdx.x / (cols / 32), tc = blockIdx.x % (cols / 32);
  const int x = threadIdx.x & 31, y0 = threadIdx.x >> 5;
  for (int y = y0; y < 32; y += 8)
    tile[y][x] = a.w[z][static_cast<size_t>(tr * 32 + y) * cols + tc * 32 + x];
  __syncthreads();
  for (int y = y0; y < 32; y += 8) {
    uint32_t hi, lo;
    size_t at;
    if (T) {
      split_tf32(tile[x][y], hi, lo);
      at = static_cast<size_t>(tc * 32 + y) * rows + tr * 32 + x;
    } else {
      split_tf32(tile[y][x], hi, lo);
      at = static_cast<size_t>(tr * 32 + y) * cols + tc * 32 + x;
    }
    a.hi[z][at] = __uint_as_float(hi);
    a.lo[z][at] = __uint_as_float(lo);
  }
}

__global__ void __launch_bounds__(256)
    ffn_reduce_kernel(const float* __restrict__ part,
                      const float* __restrict__ dbp, float* __restrict__ dw,
                      float* __restrict__ db, int n, int nb, int splits) {
  reduce_partials(part, dbp, dw, db, n, nb, splits);
}

// ---- host side -------------------------------------------------------

template <bool TN, int EPI>
int gemm(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& blo,
         Args args, cudaStream_t stream) {
  static bool sized = false;
  return launch_gemm<TN>(ffn_gemm_kernel<TN, EPI>, sized, a, b, blo, args,
                         stream);
}

int split_weights(const float* w1, const float* w2, float* out, int D,
                  bool transposed, cudaStream_t stream) {
  const int F = 4 * D;
  const size_t n = static_cast<size_t>(F) * D;
  SplitArgs s;
  s.w[0] = w1;
  s.w[1] = w2;
  s.rows[0] = F;
  s.cols[0] = D;  // W1 [4D][D]
  s.rows[1] = D;
  s.cols[1] = F;  // W2 [D][4D]
  s.hi[0] = out;
  s.lo[0] = out + n;
  s.hi[1] = out + 2 * n;
  s.lo[1] = out + 3 * n;
  const dim3 grid(static_cast<unsigned>(n / 1024), 2);
  if (transposed)
    ffn_split_kernel<true><<<grid, 256, 0, stream>>>(s);
  else
    ffn_split_kernel<false><<<grid, 256, 0, stream>>>(s);
  return cudaGetLastError();
}

}  // namespace

// Scratch floats the wrapper allocates for a call at M rows and width D:
// the forward's split weights; the backward's split transposed weights, dH
// [M][4D], and the row splits' partial dW and db.
extern "C" size_t dostpu_ffn_scratch_floats(int M, int D, int backward) {
  const size_t w = 16 * static_cast<size_t>(D) * D;
  if (!backward) return w;
  int splits, rps;
  row_splits(M, ceil_div(D, kBM) * ceil_div(4 * D, kBN), &splits, &rps);
  return w + static_cast<size_t>(M) * 4 * D +
         static_cast<size_t>(splits) * 4 * D * (D + 1);
}

// Forward. Device pointers into contiguous f32 tensors: x [M][D],
// w1 [4D][D], b1 [4D], w2 [D][4D], b2 [D]; writes h = relu(x w1^T + b1)
// [M][4D] and y = h w2^T + b2 [M][D]. M >= 1, D a multiple of 32. Three
// launches on `stream`; returns the first CUDA error (0 on success).
extern "C" int dostpu_ffn_fwd(const float* x, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, float* h, float* y,
                              float* scratch, int M, int D, void* stream) {
  if (M <= 0 || D <= 0 || D % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = 4 * D;
  const size_t n = static_cast<size_t>(F) * D;
  int code = split_weights(w1, w2, scratch, D, false, st);
  if (code != 0) return code;
  CUtensorMap mx, m1h, m1l, mh, m2h, m2l;
  const float* w1h = scratch;
  const float* w2h = scratch + 2 * n;
  if ((code = make_map(&mx, x, D, M, kBM)) ||
      (code = make_map(&m1h, w1h, D, F, kBN)) ||
      (code = make_map(&m1l, w1h + n, D, F, kBN)) ||
      (code = make_map(&mh, h, F, M, kBM)) ||
      (code = make_map(&m2h, w2h, F, D, kBN)) ||
      (code = make_map(&m2l, w2h + n, F, D, kBN)))
    return code;
  Args a1 = {};
  a1.M = M;
  a1.N = F;
  a1.K = D;
  a1.bias = b1;
  a1.out = h;
  code = gemm<false, kBiasRelu>(mx, m1h, m1l, a1, st);
  if (code != 0) return code;
  Args a2 = {};
  a2.M = M;
  a2.N = D;
  a2.K = F;
  a2.bias = b2;
  a2.out = y;
  return gemm<false, kBias>(mh, m2h, m2l, a2, st);
}

// Backward. x [M][D] and h [M][4D] as the forward had them, w1, w2 as
// there, gy = dL/dy [M][D]; writes gx [M][D], gw1 [4D][D], gb1 [4D],
// gw2 [D][4D], gb2 [D]. scratch holds dostpu_ffn_scratch_floats(M, D, 1)
// floats. Seven launches on `stream`; returns the first CUDA error.
extern "C" int dostpu_ffn_bwd(const float* x, const float* h, const float* w1,
                              const float* w2, const float* gy, float* gx,
                              float* gw1, float* gb1, float* gw2, float* gb2,
                              float* scratch, int M, int D, void* stream) {
  if (M <= 0 || D <= 0 || D % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = 4 * D;
  const size_t n = static_cast<size_t>(F) * D;
  int code = split_weights(w1, w2, scratch, D, true, st);
  if (code != 0) return code;
  const float* w1t = scratch;        // W1^T [D][4D], hi then lo
  const float* w2t = scratch + 2 * n;  // W2^T [4D][D]
  float* gh = scratch + 4 * n;       // dH [M][4D]
  float* part = gh + static_cast<size_t>(M) * F;
  int splits, rps;
  row_splits(M, ceil_div(D, kBM) * ceil_div(F, kBN), &splits, &rps);
  float* dbp = part + static_cast<size_t>(splits) * n;
  CUtensorMap mgy, m2h, m2l, mgh, m1h, m1l;
  if ((code = make_map(&mgy, gy, D, M, kBM)) ||
      (code = make_map(&m2h, w2t, D, F, kBN)) ||
      (code = make_map(&m2l, w2t + n, D, F, kBN)) ||
      (code = make_map(&mgh, gh, F, M, kBM)) ||
      (code = make_map(&m1h, w1t, F, D, kBN)) ||
      (code = make_map(&m1l, w1t + n, F, D, kBN)))
    return code;
  Args a = {};
  a.M = M;
  a.N = F;
  a.K = D;
  a.mask = h;
  a.out = gh;
  code = gemm<false, kMask>(mgy, m2h, m2l, a, st);  // dH = (dY W2) * (H > 0)
  if (code != 0) return code;
  code = weight_grad(gemm<true, kPartial>, ffn_reduce_kernel, gy, h, gw2,
                     gb2, part, dbp, M, D, F, st);
  if (code != 0) return code;
  Args b = {};
  b.M = M;
  b.N = D;
  b.K = F;
  b.out = gx;
  code = gemm<false, kPlain>(mgh, m1h, m1l, b, st);  // dX = dH W1
  if (code != 0) return code;
  return weight_grad(gemm<true, kPartial>, ffn_reduce_kernel, gh, x, gw1,
                     gb1, part, dbp, M, F, D, st);
}
