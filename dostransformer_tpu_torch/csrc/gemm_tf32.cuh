// The 3xTF32 GEMM core shared by kernel #8 (ffn.cu, the transformer FFN)
// and kernel #9 (linear.cu, the model's other f32 linears), for sm_90a.
// Each source defines its own __global__ functions around the bodies here,
// so the profiler and the benchmark tell the two kernels apart by name:
//
//   gemm_tf32_body<TN, EPI>  the persistent GEMM, C = A B^T (NT) or G^T X
//                            over row splits (TN), with its epilogues
//   reduce_partials          the row splits' partial dW and db, summed in
//                            split order
//
// and launches them through the host helpers at the end (launch_gemm,
// weight_grad). The design and its measurements are in ffn.cu's note.
//
// f32 accuracy on the TF32 tensor cores (3xTF32): each operand is split as
// x = hi + lo, both TF32 (hi rounded to nearest, lo = x - hi rounded), and
// a product is hi*hi + hi*lo + lo*hi, summed in f32; the dropped lo*lo is
// under 2^-22 of it. Three products cap the rate at 495 / 3 = 165 TFLOP/s.
// No product is made in 1xTF32 or bf16, and nothing here reads or sets
// PyTorch's allow_tf32.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;  // rows of C a unit: two warpgroups of 64
constexpr int kBN = 128;  // columns of C a unit (the wgmma N)
constexpr int kBK = 32;   // K a chunk: one 128-byte swizzle row of f32
constexpr int kThreads = 256;  // two warpgroups
constexpr int kStages = 4;     // the TMA ring
constexpr int kTile = kBM * kBK * 4;       // a [128][32] f32 tile, 16 KB
constexpr int kSub = 32 * kBK * 4;         // a [32][32] TMA box, 4 KB
static_assert(kBM == kBN, "the tiles of A and B share kTile");

enum Epi { kBiasRelu = 0, kBias = 1, kMask = 2, kPlain = 3, kPartial = 4 };

// Shared memory: kStages stages, then (TN) three split B buffers, then the
// barriers. A stage is NT: A raw [128][32] | B hi [128][32] | B lo;
// TN: A raw 4 x [32 m][32 n] | B raw 4 x [32 m][32 n]. Every tile starts on
// a 1024-byte boundary, which the 128-byte swizzle's addressing assumes.
template <bool TN>
struct Layout {
  static constexpr int kStage = TN ? 2 * kTile : 3 * kTile;
  static constexpr int kSplit = TN ? 3 * 2 * kTile : 0;
  static constexpr int kBarriers = kStages * kStage + kSplit;
  static constexpr int kBytes = kBarriers + 2 * kStages * 8 + 1024;
};

struct Args {
  // NT: C [M][N] = A [M][K] . B [N][K]^T. TN: C [M][N] = G^T X with
  // G [K][M], X [K][N] (K rows, cut into splits of rows_per_split).
  int M, N, K;
  int tiles_n, units, rows_per_split;
  const float* bias;  // [N]: kBiasRelu, kBias
  const float* mask;  // [M][N]: kMask
  float* out;         // C; kPartial: [splits][M][N]
  float* db;          // kPartial: [splits][M]
};

struct Unit {
  int m0, n0, k0, nk, split;
};

template <bool TN>
__device__ __forceinline__ Unit unit_of(const Args& a, int u) {
  Unit w;
  const int tiles = ((a.M + kBM - 1) / kBM) * a.tiles_n;
  const int t = TN ? u % tiles : u;
  w.split = TN ? u / tiles : 0;
  w.m0 = (t / a.tiles_n) * kBM;
  w.n0 = (t % a.tiles_n) * kBN;
  if (TN) {
    w.k0 = w.split * a.rows_per_split;
    const int k1 = min(a.K, w.k0 + a.rows_per_split);
    w.nk = k1 > w.k0 ? (k1 - w.k0 + kBK - 1) / kBK : 0;
  } else {
    w.k0 = 0;
    w.nk = (a.K + kBK - 1) / kBK;
  }
  return w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one 2-D box of the tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// x = hi + lo, both TF32 and rounded to nearest (the tensor core would
// truncate raw f32 bits; the masks make what it reads explicit)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// The descriptor of a K-major [rows][32] f32 tile in 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused; a k8 step
// inside the 128-byte row moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of these registers across
// the wgmma issue and wait (the tensor core reads and writes them
// asynchronously)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x 128] (+)= a[64 x 8] . b[128 x 8]^T: A from registers (the
// m16n8k8 TF32 fragment of each warp's 16 rows), B K-major in shared
// memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ float lds(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

// byte offset of element (row, col) of a [rows][32] f32 tile in 128-byte
// swizzle: the 16-byte chunk index XOR the row's low 3 bits
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// element (row r of C, k) of the transposed operand staged as four
// [32 k][32 r] boxes (r = the box's column)
__device__ __forceinline__ int sw128_t(int r, int k) {
  return (r >> 5) * kSub + sw128(k, r & 31);
}

// The GEMM's body; each source's __global__ wrapper (launch bounds
// kThreads, 1) passes its parameters straight through.
template <bool TN, int EPI>
__device__ __forceinline__ void gemm_tf32_body(const CUtensorMap& map_a,
                                               const CUtensorMap& map_b,
                                               const CUtensorMap& map_b_lo,
                                               const Args& args) {
  using L = Layout<TN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L::kBarriers;
  const uint32_t empty0 = full0 + kStages * 8;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kThreads / 32);  // one a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The loads: one thread keeps the block's next kStages chunks in flight,
  // walking the block's units in the consumers' order (pit: the chunk's
  // index in that order, which picks its stage and phase).
  int pu = blockIdx.x, pc = 0, pit = 0;
  Unit pw = unit_of<TN>(args, pu < args.units ? pu : 0);
  auto produce = [&]() {
    while (pu < args.units && pc >= pw.nk) {
      pu += gridDim.x;
      pc = 0;
      if (pu < args.units) pw = unit_of<TN>(args, pu);
    }
    if (pu >= args.units) return;
    const int st = pit % kStages;
    mbar_wait(empty0 + 8 * st, ((pit / kStages) & 1) ^ 1);
    const uint32_t full = full0 + 8 * st;
    const uint32_t dst = base + st * L::kStage;
    const int k = pw.k0 + pc * kBK;
    mbar_expect_tx(full, L::kStage);
    if (!TN) {
      tma_load(dst, &map_a, k, pw.m0, full);
      tma_load(dst + kTile, &map_b, k, pw.n0, full);
      tma_load(dst + 2 * kTile, &map_b_lo, k, pw.n0, full);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tma_load(dst + j * kSub, &map_a, pw.m0 + 32 * j, k, full);
        tma_load(dst + kTile + j * kSub, &map_b, pw.n0 + 32 * j, k, full);
      }
    }
    ++pc;
    ++pit;
  };
  if (tid == 0)
    for (int i = 0; i < kStages; ++i) produce();

  // warpgroup wg owns rows 64 wg ... of the unit; this thread rows r0 and
  // r0 + 8 (the fragments' rows), columns 8 j + 2 t, + 1
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // the A fragments of the even and odd chunks: the next chunk's are read
  // and split while the tensor core runs this one's
  uint32_t ahi[2][4][4], alo[2][4][4];
  // a stage is free again once every warp has arrived
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  };
  int it = 0;  // the block's chunk count, in the producer's order
  for (int u = blockIdx.x; u < args.units; u += gridDim.x) {
    const Unit w = unit_of<TN>(args, u);
    if (EPI == kMask && w.n0 + 32 * t < args.N) {
      // the epilogue's mask rows into L2 while the products run: this
      // thread's quarter of each of its two rows' 128 columns
      for (int e = 0; e < 2; ++e)
        if (w.m0 + r0 + 8 * e < args.M)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              args.mask + static_cast<size_t>(w.m0 + r0 + 8 * e) * args.N +
              w.n0 + 32 * t));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.f;
    // db: this thread's column sums of G, compensated (Kahan) over chunks
    float db0 = 0.f, db1 = 0.f, dc0 = 0.f, dc1 = 0.f;

    // chunk q: wait for its stage, read and split this thread's A
    // fragments into buffer B (TN: and X's chunk into a K-major split
    // copy); returns the shared address of its B hi tile (lo follows)
    auto fetch = [&](auto tag, int q) -> uint32_t {
      constexpr int B = decltype(tag)::value;
      const int st = q % kStages;
      mbar_wait(full0 + 8 * st, (q / kStages) & 1);
      const uint8_t* stage = smem + st * L::kStage;
      uint32_t b_hi = base + st * L::kStage + kTile;
      if (TN) {
        // X's chunk [32 m][128 n] -> K-major hi and lo [128 n][32 m]
        const int buf = kStages * L::kStage + (q % 3) * 2 * kTile;
        const uint8_t* raw = stage + kTile;
        const int n = tid & 127, half = tid >> 7;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int cc = half + 2 * p;
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(lds(raw + sw128_t(n, 4 * cc + i)), hi[i], lo[i]);
          const int at = n * 128 + (((cc ^ n) & 7) << 4);
          *reinterpret_cast<uint4*>(smem + buf + at) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(smem + buf + kTile + at) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        b_hi = base + buf;
      }
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float x[4];
        if (!TN) {
          x[0] = lds(stage + sw128(r0, 8 * s + t));
          x[1] = lds(stage + sw128(r0 + 8, 8 * s + t));
          x[2] = lds(stage + sw128(r0, 8 * s + t + 4));
          x[3] = lds(stage + sw128(r0 + 8, 8 * s + t + 4));
        } else {
          x[0] = lds(stage + sw128_t(r0, 8 * s + t));
          x[1] = lds(stage + sw128_t(r0 + 8, 8 * s + t));
          x[2] = lds(stage + sw128_t(r0, 8 * s + t + 4));
          x[3] = lds(stage + sw128_t(r0 + 8, 8 * s + t + 4));
          p0 += x[0];
          p0 += x[2];
          p1 += x[1];
          p1 += x[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(x[i], ahi[B][s][i], alo[B][s][i]);
      }
      if (TN) {
        if (EPI == kPartial) {
          const float y0 = p0 - dc0, s0 = db0 + y0;
          dc0 = (s0 - db0) - y0;
          db0 = s0;
          const float y1 = p1 - dc1, s1 = db1 + y1;
          dc1 = (s1 - db1) - y1;
          db1 = s1;
        }
        release(st);  // the raw chunk is read; wgmma reads the split copy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
      }
      return b_hi;
    };

    // chunk c of the unit (the block's chunk `it`) on the tensor core from
    // buffer B, the next chunk fetched meanwhile; the chunk's sum is then
    // added into the f32 total. Returns the next chunk's B address.
    auto mma = [&](auto tag, int c, uint32_t b_hi) -> uint32_t {
      constexpr int B = decltype(tag)::value;
      const uint32_t b_lo = b_hi + kTile;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint64_t dhi = desc_sw128(b_hi + 32 * s);
        const uint64_t dlo = desc_sw128(b_lo + 32 * s);
        wgmma_tf32(acc, alo[B][s], dhi, s > 0);
        wgmma_tf32(acc, ahi[B][s], dlo, 1);
        wgmma_tf32(acc, ahi[B][s], dhi, 1);
      }
      wgmma_commit();
      uint32_t next = 0;
      if (c + 1 < w.nk)
        next = fetch(std::integral_constant<int, 1 - B>{}, it + 1);
      wgmma_wait0();
      fence_regs(acc);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        fence_regs(ahi[B][s]);
        fence_regs(alo[B][s]);
      }
      if (!TN) release(it % kStages);
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
      if (tid == 0) produce();
      ++it;
      return next;
    };

    if (w.nk > 0) {
      uint32_t b = fetch(std::integral_constant<int, 0>{}, it);
      for (int c = 0; c < w.nk; c += 2) {
        b = mma(std::integral_constant<int, 0>{}, c, b);
        if (c + 1 < w.nk) b = mma(std::integral_constant<int, 1>{}, c + 1, b);
      }
    }

    // epilogue: this thread's rows ra and ra + 8, columns 8 j + 2 t
    const int ra = w.m0 + r0;
    float* out = args.out;
    if (EPI == kPartial) {
      out += static_cast<size_t>(w.split) * args.M * args.N;
      if (w.n0 == 0) {
        db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
        db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
        db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
        db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
        float* db = args.db + static_cast<size_t>(w.split) * args.M;
        if (t == 0 && ra < args.M) db[ra] = db0;
        if (t == 0 && ra + 8 < args.M) db[ra + 8] = db1;
      }
    }
    // the bias and mask values of half this thread's columns at a time,
    // all loads issued before the first use (the mainloop's registers are
    // free here; a half keeps the mask's within them)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 bias[8], keep[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = w.n0 + 8 * (8 * half + jj) + 2 * t;
        bias[jj] = make_float2(0.f, 0.f);
        if ((EPI == kBiasRelu || EPI == kBias) && col < args.N)
          bias[jj] = *reinterpret_cast<const float2*>(args.bias + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = ra + 8 * e;
          if (EPI == kMask && col < args.N && row < args.M)
            keep[jj][e] = *reinterpret_cast<const float2*>(
                args.mask + static_cast<size_t>(row) * args.N + col);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * half + jj;
        const int col = w.n0 + 8 * j + 2 * t;
        if (col >= args.N) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = ra + 8 * e;
          if (row >= args.M) continue;
          const size_t at = static_cast<size_t>(row) * args.N + col;
          float2 v = make_float2(total[4 * j + 2 * e] + bias[jj].x,
                                 total[4 * j + 2 * e + 1] + bias[jj].y);
          if (EPI == kBiasRelu) {
            v.x = v.x < 0.f ? 0.f : v.x;
            v.y = v.y < 0.f ? 0.f : v.y;
          }
          if (EPI == kMask) {
            v.x = keep[jj][e].x > 0.f ? v.x : 0.f;
            v.y = keep[jj][e].y > 0.f ? v.y : 0.f;
          }
          *reinterpret_cast<float2*>(out + at) = v;
        }
      }
    }
  }
}

// dw[i] = sum over the splits of part[s][i], db likewise (nb = 0: no db),
// split by split
__device__ __forceinline__ void reduce_partials(const float* __restrict__ part,
                                                const float* __restrict__ dbp,
                                                float* __restrict__ dw,
                                                float* __restrict__ db, int n,
                                                int nb, int splits) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = first; i < n / 4; i += stride) {
    float4 s = reinterpret_cast<const float4*>(part)[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v =
          reinterpret_cast<const float4*>(part + static_cast<size_t>(k) * n)[i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(dw)[i] = s;
  }
  for (int i = first; i < nb; i += stride) {
    float s = dbp[i];
    for (int k = 1; k < splits; ++k) s += dbp[static_cast<size_t>(k) * nb + i];
    db[i] = s;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major f32 [outer][inner] tensor in boxes of [box_outer][32], in
// 128-byte swizzle; reads past its edges fill zeros
int make_map(CUtensorMap* map, const float* ptr, int inner, int outer,
             int box_outer) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// the current device's SMs, read once a device
int sm_count() {
  static int known[64] = {};
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && known[dev] > 0) return known[dev];
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  n = n > 0 ? n : 1;
  if (dev >= 0 && dev < 64) known[dev] = n;
  return n;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the row splits of a dW product of `tiles` output tiles over `rows` rows:
// as many as keep one unit an SM, each a whole number of 32-row chunks
void row_splits(int rows, int tiles, int* splits, int* rows_per_split) {
  int s = sm_count() / tiles;
  s = s < 1 ? 1 : s;
  const int chunks = ceil_div(rows, kBK);
  s = s > chunks ? chunks : s;
  const int rps = ceil_div(chunks, s) * kBK;
  *rows_per_split = rps;
  *splits = ceil_div(rows, rps);
}

// Launch `kernel` (a source's gemm_tf32_body<TN, EPI> wrapper) over the
// units of `args`, one block an SM at most; `sized` is the caller's flag
// that the kernel's shared-memory limit is set.
template <bool TN, typename Kernel>
int launch_gemm(Kernel kernel, bool& sized, const CUtensorMap& a,
                const CUtensorMap& b, const CUtensorMap& blo, Args args,
                cudaStream_t stream) {
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<TN>::kBytes);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  args.tiles_n = ceil_div(args.N, kBN);
  int units = ceil_div(args.M, kBM) * args.tiles_n;
  if (TN) units *= ceil_div(args.K, args.rows_per_split);
  args.units = units;
  const int sms = sm_count();
  const int grid = units < sms ? units : sms;
  kernel<<<grid, kThreads, Layout<TN>::kBytes, stream>>>(a, b, blo, args);
  return cudaGetLastError();
}

// the dW product of G [rows][n1] and X [rows][n2] into dw [n1][n2] and db
// [n1] (db null: none): the partials of the row splits (`tn`, the source's
// TN kPartial launcher), then their sum (`reduce`, its reduce kernel)
template <typename TnGemm, typename Reduce>
int weight_grad(TnGemm tn, Reduce reduce, const float* g, const float* x,
                float* dw, float* db, float* part, float* dbp, int rows,
                int n1, int n2, cudaStream_t stream) {
  CUtensorMap ma, mb;
  int code = make_map(&ma, g, n1, rows, 32);
  if (code == 0) code = make_map(&mb, x, n2, rows, 32);
  if (code != 0) return code;
  int splits, rps;
  row_splits(rows, ceil_div(n1, kBM) * ceil_div(n2, kBN), &splits, &rps);
  Args args = {};
  args.M = n1;
  args.N = n2;
  args.K = rows;
  args.rows_per_split = rps;
  args.out = part;
  args.db = dbp;
  code = tn(ma, mb, mb, args, stream);
  if (code != 0) return code;
  const int n = n1 * n2;
  int blocks = ceil_div(n / 4, 256);
  blocks = blocks > 4 * sm_count() ? 4 * sm_count() : blocks;
  reduce<<<blocks, 256, 0, stream>>>(part, dbp, dw, db, n,
                                     db != nullptr ? n1 : 0, splits);
  return cudaGetLastError();
}

}  // namespace
