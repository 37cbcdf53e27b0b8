// The model's f32 linears on the tensor cores, for sm_90a: kernel #9, the
// product of one f32 linear, forward and backward. For x [M, K] and a
// weight W [N, K] (possibly a column slice of a wider row-major weight,
// read through its row stride ldw), computed here:
//
//   forward   Y  = x W^T (+ b)
//   backward  dX = dY W      dW = dY^T x      db = sum_rows dY
//
// It replaces no Pallas kernel: in the JAX package XLA runs these products
// (flax Dense). On the H100 cuBLAS runs them in f32 on the CUDA cores (TF32
// is off: 67 TFLOP/s at most); the message-passing processors' projections,
// the encoders and the heads of the eDOS model are most of them.
//
// The GEMM is #8's (ffn.cu, gemm_tf32.cuh): 3xTF32 on `wgmma` m64n128k8,
// two consumer warpgroups, a 4-stage TMA ring, A split in registers, each
// 32-deep chunk's sum promoted into an f32 total, dW over row splits summed
// in a fixed order by linear_reduce_kernel, db in the TN epilogue. What is
// #9's own:
//   * linear_split_kernel splits the weight once a call into K-major TF32
//     hi and lo, [N][K] for the forward and transposed to [K][N] for dX,
//     from any row stride, with ragged edges guarded, so a weight slice
//     (w0[:, :h]) costs no copy of its own;
//   * the epilogues are + bias or plain (forward), plain (dX), partial dW
//     with db (dW); dX and dW are each skipped when the caller needs none.
// What bounds it on an H100: operations at the cell's widths (K = 200-640,
// N = 256-512): 2 K N flops a row against (K + N) floats a row, ~100-140
// flops a byte; the f32-accurate tensor-core rate (165 TFLOP/s) over
// 3.35 TB/s is ~50.
// Nothing is allocated (the wrapper's scratch holds the split weight and
// the partials), every launch is on the caller's stream with no
// synchronise (graph-capturable), and no float atomics: a rerun repeats
// bit for bit. Shapes: any M >= 1; K and N multiples of 4 (the 16-byte row
// strides of TMA's maps of x and dY); ragged M, N and K tiles are TMA's
// zero fill and the epilogue's guards.

#include "gemm_tf32.cuh"

namespace {

template <bool TN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    linear_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_b_lo,
                       const Args args) {
  gemm_tf32_body<TN, EPI>(map_a, map_b, map_b_lo, args);
}

// w [rows][cols] (row stride ld) into TF32 hi and lo, as it is ([rows]
// [cols], T false) or transposed ([cols][rows], T true); a block does a
// 32 x 32 tile, edges guarded
template <bool T>
__global__ void __launch_bounds__(256)
    linear_split_kernel(const float* __restrict__ w, int ld, int rows,
                        int cols, float* __restrict__ hi,
                        float* __restrict__ lo) {
  __shared__ float tile[32][33];
  const int tiles_c = (cols + 31) / 32;
  const int tr = blockIdx.x / tiles_c, tc = blockIdx.x % tiles_c;
  const int x = threadIdx.x & 31, y0 = threadIdx.x >> 5;
  for (int y = y0; y < 32; y += 8) {
    const int r = tr * 32 + y, c = tc * 32 + x;
    tile[y][x] =
        r < rows && c < cols ? w[static_cast<size_t>(r) * ld + c] : 0.f;
  }
  __syncthreads();
  for (int y = y0; y < 32; y += 8) {
    // T: out [c][r] for c = tc 32 + y, r = tr 32 + x, i.e. tile[x][y]
    const int r = tr * 32 + (T ? x : y), c = tc * 32 + (T ? y : x);
    if (r >= rows || c >= cols) continue;
    uint32_t h, l;
    split_tf32(T ? tile[x][y] : tile[y][x], h, l);
    const size_t at = T ? static_cast<size_t>(c) * rows + r
                        : static_cast<size_t>(r) * cols + c;
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

__global__ void __launch_bounds__(256)
    linear_reduce_kernel(const float* __restrict__ part,
                         const float* __restrict__ dbp, float* __restrict__ dw,
                         float* __restrict__ db, int n, int nb, int splits) {
  reduce_partials(part, dbp, dw, db, n, nb, splits);
}

// ---- host side -------------------------------------------------------

template <bool TN, int EPI>
int gemm(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& blo,
         Args args, cudaStream_t stream) {
  static bool sized = false;
  return launch_gemm<TN>(linear_gemm_kernel<TN, EPI>, sized, a, b, blo, args,
                         stream);
}

int split_weight(const float* w, int ld, int rows, int cols, float* hi,
                 float* lo, bool transposed, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>(ceil_div(rows, 32) * ceil_div(cols, 32));
  if (transposed)
    linear_split_kernel<true><<<blocks, 256, 0, stream>>>(w, ld, rows, cols,
                                                          hi, lo);
  else
    linear_split_kernel<false><<<blocks, 256, 0, stream>>>(w, ld, rows, cols,
                                                           hi, lo);
  return cudaGetLastError();
}

bool takes(int M, int N, int K, int ldw) {
  return M > 0 && N > 0 && K > 0 && K % 4 == 0 && N % 4 == 0 && ldw >= K;
}

}  // namespace

// Scratch floats the wrapper allocates for a call at M rows, N outputs and
// K inputs: the forward's split weight; the backward's split transposed
// weight and the row splits' partial dW and db.
extern "C" size_t dostpu_linear_scratch_floats(int M, int N, int K,
                                               int backward) {
  const size_t w = 2 * static_cast<size_t>(N) * K;
  if (!backward) return w;
  int splits, rps;
  row_splits(M, ceil_div(N, kBM) * ceil_div(K, kBN), &splits, &rps);
  return w + static_cast<size_t>(splits) * N * (K + 1);
}

// Forward. x [M][K] contiguous; w [N][K] with row stride ldw >= K (unit
// column stride); bias [N] or null; writes y [M][N] = x w^T (+ bias). Two
// launches on `stream`; returns the first CUDA error (0 on success).
extern "C" int dostpu_linear_fwd(const float* x, const float* w, int ldw,
                                 const float* bias, float* y, float* scratch,
                                 int M, int N, int K, void* stream) {
  if (!takes(M, N, K, ldw)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(N) * K;
  float* whi = scratch;
  int code = split_weight(w, ldw, N, K, whi, whi + n, false, st);
  if (code != 0) return code;
  CUtensorMap mx, mh, ml;
  if ((code = make_map(&mx, x, K, M, kBM)) ||
      (code = make_map(&mh, whi, K, N, kBN)) ||
      (code = make_map(&ml, whi + n, K, N, kBN)))
    return code;
  Args a = {};
  a.M = M;
  a.N = N;
  a.K = K;
  a.bias = bias;
  a.out = y;
  return bias != nullptr ? gemm<false, kBias>(mx, mh, ml, a, st)
                         : gemm<false, kPlain>(mx, mh, ml, a, st);
}

// Backward. x [M][K] and w (ldw) as the forward had them, gy = dL/dy
// [M][N] contiguous; writes gx [M][K] (null: skipped), gw [N][K] and gb
// [N] (gw null: both skipped; gb null: no db). scratch holds
// dostpu_linear_scratch_floats(M, N, K, 1) floats. Up to four launches on
// `stream`; returns the first CUDA error.
extern "C" int dostpu_linear_bwd(const float* x, const float* w, int ldw,
                                 const float* gy, float* gx, float* gw,
                                 float* gb, float* scratch, int M, int N,
                                 int K, void* stream) {
  if (!takes(M, N, K, ldw)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(N) * K;
  int code = 0;
  if (gx != nullptr) {
    float* wt = scratch;  // W^T [K][N], hi then lo
    if ((code = split_weight(w, ldw, N, K, wt, wt + n, true, st))) return code;
    CUtensorMap mgy, mh, ml;
    if ((code = make_map(&mgy, gy, N, M, kBM)) ||
        (code = make_map(&mh, wt, N, K, kBN)) ||
        (code = make_map(&ml, wt + n, N, K, kBN)))
      return code;
    Args a = {};
    a.M = M;
    a.N = K;
    a.K = N;
    a.out = gx;
    if ((code = gemm<false, kPlain>(mgy, mh, ml, a, st))) return code;  // dX
  }
  if (gw == nullptr) return 0;
  float* part = scratch + 2 * n;
  int splits, rps;
  row_splits(M, ceil_div(N, kBM) * ceil_div(K, kBN), &splits, &rps);
  float* dbp = part + static_cast<size_t>(splits) * n;
  return weight_grad(gemm<true, kPartial>, linear_reduce_kernel, gy, x, gw,
                     gb, part, dbp, M, N, K, st);
}
