// Native host-side runtime: the periodic neighbour search.
//
// The port's own copy of the neighbour search of
// dostransformer_tpu/native/src/dostpu_native.cc (ABI version 3). Its batch
// packers are not copied: the JAX package measured them at 0.74-0.89x the
// NumPy loop that data/graph.py collate keeps. The
// reference delegates this to native code in its dependencies: ASE's C
// neighbor_list / pymatgen's get_all_neighbors. The algorithm mirrors the
// NumPy version in data/neighbors.py exactly, so both paths give the same
// bits; the NumPy version stays behind the same call site, taken only when
// DOSTPU_NO_NATIVE=1 asks for it.
//
// Built at first use by dostransformer_tpu_torch/native/build.py
// (g++ -O3 -shared -fPIC -std=c++17) and bound with ctypes
// (dostransformer_tpu_torch/native/__init__.py).

#include <cmath>
#include <cstdint>

namespace {

// 3x3 inverse; rows of `cell` are lattice vectors. Returns false if singular.
bool invert3x3(const double* m, double* inv) {
  const double a = m[0], b = m[1], c = m[2];
  const double d = m[3], e = m[4], f = m[5];
  const double g = m[6], h = m[7], i = m[8];
  const double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  if (std::fabs(det) < 1e-300) return false;
  const double r = 1.0 / det;
  inv[0] = (e * i - f * h) * r;
  inv[1] = (c * h - b * i) * r;
  inv[2] = (b * f - c * e) * r;
  inv[3] = (f * g - d * i) * r;
  inv[4] = (a * i - c * g) * r;
  inv[5] = (c * d - a * f) * r;
  inv[6] = (d * h - e * g) * r;
  inv[7] = (b * g - a * h) * r;
  inv[8] = (a * e - b * d) * r;
  return true;
}

}  // namespace

extern "C" {

// Periodic neighbor search, ASE neighbor_list("ijS") semantics (pairs with
// |pos[j] + S@cell - pos[i]| < cutoff; self_interaction keeps (i,i,S=0)).
//
// Two-phase contract: call with src == nullptr to get the edge count, then
// with buffers of that size. Returns the edge count, or -1 on error.
int64_t dostpu_neighbor_list(const double* positions, int64_t n,
                             const double* cell,  // row-major 3x3
                             double cutoff, int self_interaction,
                             const uint8_t* pbc,  // [3] booleans
                             int64_t capacity, int64_t* src, int64_t* dst,
                             int64_t* shifts /* [capacity, 3] */) {
  double inv[9];
  if (!invert3x3(cell, inv)) return -1;

  // images needed per axis: ceil(cutoff * |column i of inv(cell)|)
  int64_t nmax[3];
  for (int i = 0; i < 3; ++i) {
    const double norm = std::sqrt(inv[0 + i] * inv[0 + i] +
                                  inv[3 + i] * inv[3 + i] +
                                  inv[6 + i] * inv[6 + i]);
    nmax[i] = pbc[i] ? static_cast<int64_t>(std::ceil(cutoff * norm)) : 0;
  }

  const double cutoff2 = cutoff * cutoff;
  int64_t count = 0;
  const bool fill = src != nullptr;

  for (int64_t sx = -nmax[0]; sx <= nmax[0]; ++sx) {
    for (int64_t sy = -nmax[1]; sy <= nmax[1]; ++sy) {
      for (int64_t sz = -nmax[2]; sz <= nmax[2]; ++sz) {
        const bool zero_shift = (sx == 0 && sy == 0 && sz == 0);
        const double ox = sx * cell[0] + sy * cell[3] + sz * cell[6];
        const double oy = sx * cell[1] + sy * cell[4] + sz * cell[7];
        const double oz = sx * cell[2] + sy * cell[5] + sz * cell[8];
        for (int64_t i = 0; i < n; ++i) {
          const double pix = positions[3 * i], piy = positions[3 * i + 1],
                       piz = positions[3 * i + 2];
          for (int64_t j = 0; j < n; ++j) {
            if (zero_shift && i == j && !self_interaction) continue;
            const double dx = positions[3 * j] + ox - pix;
            const double dy = positions[3 * j + 1] + oy - piy;
            const double dz = positions[3 * j + 2] + oz - piz;
            const double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < cutoff2) {
              if (fill) {
                if (count >= capacity) return -2;  // caller under-allocated
                src[count] = i;
                dst[count] = j;
                shifts[3 * count] = sx;
                shifts[3 * count + 1] = sy;
                shifts[3 * count + 2] = sz;
              }
              ++count;
            }
          }
        }
      }
    }
  }
  return count;
}

// The neighbour search's signature is that of the JAX package's ABI
// version 3.
int64_t dostpu_abi_version() { return 3; }

}  // extern "C"
