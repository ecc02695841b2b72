// Device code shared by the board kernels (analysis.cu, flood.cu): the
// per-thread cell geometry and the chain/region labelling fixpoint.
//
// Layout: one thread block per board, one thread per cell of the n x n
// buffer (n <= 19, so at most 361 cells, rounded up to whole warps).
// ops/build.py rebuilds a library when this header is newer than it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXNN = 384;        // 19*19 = 361 cells, rounded up to warps
constexpr int BIG = 0x3fffffff;   // "no label" / "no cell"

struct Geo {
  int t, n, nn, y, x;
  bool cell;            // thread owns a cell of the n x n buffer
  int nb[4];            // up, down, left, right (-1 off the buffer)
  int dg[4];            // up-left, up-right, down-left, down-right
};

__device__ __forceinline__ Geo make_geo(int n) {
  Geo g;
  g.t = threadIdx.x;
  g.n = n;
  g.nn = n * n;
  g.cell = g.t < g.nn;
  g.y = g.t / n;
  g.x = g.t % n;
  bool up = g.cell && g.y > 0, dn = g.cell && g.y < n - 1;
  bool lf = g.cell && g.x > 0, rt = g.cell && g.x < n - 1;
  g.nb[0] = up ? g.t - n : -1;
  g.nb[1] = dn ? g.t + n : -1;
  g.nb[2] = lf ? g.t - 1 : -1;
  g.nb[3] = rt ? g.t + 1 : -1;
  g.dg[0] = (up && lf) ? g.t - n - 1 : -1;
  g.dg[1] = (up && rt) ? g.t - n + 1 : -1;
  g.dg[2] = (dn && lf) ? g.t + n - 1 : -1;
  g.dg[3] = (dn && rt) ? g.t + n + 1 : -1;
  return g;
}

// Label the 4-connected components of cells whose class `cls` is non-zero,
// connecting only neighbours of equal class (a 0/1 mask is one class);
// label = min flat index, BIG off-component. In-place relaxation with pointer jumping: values only
// decrease and always name a cell of the same component, so any
// interleaving converges, and a pass with no write is a true fixpoint.
// Every thread of the block must call it; it ends on a barrier.
__device__ void label_by_class(const Geo& g, const volatile uint8_t* cls,
                               volatile int* lbl) {
  uint8_t c = g.cell ? cls[g.t] : 0;
  if (g.cell) lbl[g.t] = c ? g.t : BIG;
  bool changed = true;
  while (__syncthreads_or(changed)) {
    changed = false;
    if (c) {
      int l = lbl[g.t];
      int best = l;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        int q = g.nb[d];
        if (q >= 0 && cls[q] == c) best = min(best, lbl[q]);
      }
      best = min(best, lbl[best]);
      if (best < l) {
        lbl[g.t] = best;
        changed = true;
      }
    }
  }
}

inline int threads_for(int n) { return ((n * n + 31) / 32) * 32; }

}  // namespace
