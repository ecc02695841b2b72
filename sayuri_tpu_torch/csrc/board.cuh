// Device code shared by the board kernels (analysis.cu, flood.cu) and the
// ladder kernels (ladder.cu): the per-thread cell geometry and the
// union-find chain/region labelling of the block-per-board kernels, and the
// row fill of the warp-per-board ones.
//
// Block-per-board layout: one thread block per board, one thread per cell
// of the n x n buffer (n <= 19, so at most 361 cells, rounded up to whole
// warps). Warp-per-board layout (flood_kernel, and a ladder lane in
// ladder.cu): one warp per board, lane r holding row r as a bitmask.
// ops/build.py rebuilds a library when this header is newer than it.
//
// What bounds a board kernel on this card is one board's serial chain of
// phases (a block-wide barrier each), and the longest dependent chain of
// shared-memory steps in each phase, not bytes or arithmetic. The
// union-find labelling below (uf_seed, uf_hook, uf_flatten) takes two
// barriers whatever the board, so no board kernel has a barrier loop whose
// trip count depends on the board.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXNN = 384;        // 19*19 = 361 cells, rounded up to warps
constexpr int BIG = 0x3fffffff;   // "no label" / "no cell"
constexpr unsigned ALL = 0xffffffffu;   // every lane of a warp

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

// ---------------------------------------------------------------------------
// Union-find labelling with a fixed barrier count (a shared-memory block
// union-find in the style of Playne and Hawick). The parent array `p` only
// ever points to a smaller flat index of the same component, so the root
// of each component is its smallest cell: the label every caller wants.
//
//   phase 0 (the caller's): cls[t] = class; uf_seed(); then a barrier
//   phase 1: uf_hook();                                   then a barrier
//   phase 2: root = uf_flatten() (p[t] = root on return)
//
// In phase 2 a thread knows its own root at once and may aggregate into
// it; p[q] of another cell is its root after the next barrier. Every
// thread of the block calls all three (warp-wide votes).
//
// On this card a step of a loop whose trip count depends on the data costs
// several unrolled steps, and lanes of a warp that leave a loop at
// different times slow the block down long after the loop: a first version
// with a per-lane hook loop and a per-lane flatten loop was slower than
// the relaxation it replaced (PERF.md, section 6). So the seed finds each
// cell's run start inside its warp with one shuffle and one
// ballot, the hook joins only what crosses a warp or a row, and the hook's
// and flatten's loops are warp-uniform.
// ---------------------------------------------------------------------------

// p[t] = the start of this cell's run of equal class within its row and
// its warp (BIG when c == 0). Every thread of the block calls it, with
// its own cell's class: warp-wide shuffle and ballot.
__device__ __forceinline__ void uf_seed(const Geo& g, uint8_t c, volatile int* p) {
  const int lane = g.t & 31;
  const unsigned cw = __shfl_up_sync(0xffffffffu, (unsigned)c, 1);
  const bool link = g.cell && c && g.x > 0 && lane > 0 && cw == c;
  const unsigned linked = __ballot_sync(0xffffffffu, link);
  const unsigned upto = lane == 31 ? 0xffffffffu : (2u << lane) - 1;
  const int start = 31 - __clz((int)(~linked & upto));
  if (g.cell) p[g.t] = c ? g.t - lane + start : BIG;
}

// Joins what the seed left apart: a run that crosses into this warp (at
// its lane 0), and the first cell of each stretch of vertical contact to
// its north neighbour (contacts further east along the same two runs add
// nothing); at most two unions a cell. A union climbs from both cells one
// parent step a round; once both are roots it links the larger to the
// smaller with atomicMin. When the larger one was no longer a root
// (another lane linked it first), atomicMin still kept the smaller parent,
// and the union goes on from the parent it found, so no link is lost. The
// rounds run while any lane of the warp has a union left (a warp-uniform
// loop with a predicated body): lanes that leave a loop at different times
// cost far more on this card than the rounds they wait through.
__device__ __forceinline__ void uf_hook(const Geo& g, const volatile uint8_t* cls,
                                        volatile int* p) {
  const int t = g.t;
  const uint8_t c = g.cell ? cls[t] : 0;
  const bool west = c && g.x > 0 && cls[t - 1] == c;
  const int u = g.nb[0];
  const bool north = c && u >= 0 && cls[u] == c && !(west && cls[u - 1] == c);
  const bool across = west && (t & 31) == 0;
  int a = t, b = across ? t - 1 : (north ? u : -1);
  bool second = across && north;
  while (__any_sync(0xffffffffu, b >= 0)) {
    const bool act = b >= 0;
    const int pa = act ? p[a] : 0, pb = act ? p[b] : 0;
    const bool same = act && a == b;
    const bool climb = act && !same && (pa != a || pb != b);
    const bool link = act && !same && !climb;
    const int hi = max(a, b), lo = min(a, b);
    int old = hi;
    if (link) old = atomicMin((int*)&p[hi], lo);
    const bool done = same || (link && old == hi);
    a = climb ? pa : (link ? old : a);
    b = done ? -1 : (climb ? pb : (link ? lo : b));
    if (b < 0 && second) {
      a = t;
      b = u;
      second = false;
    }
  }
}

// The root of this thread's cell (BIG when it is not labelled), written
// back into p: parent steps while any lane of the warp is below its root.
__device__ __forceinline__ int uf_flatten(const Geo& g, bool labelled, volatile int* p) {
  const bool lab = g.cell && labelled;
  int x = lab ? p[g.t] : 0;
  while (__any_sync(0xffffffffu, lab && p[x] != x))
    if (lab) x = p[x];
  if (!lab) return BIG;
  p[g.t] = x;
  return x;
}

// The runs of `a` in this row that hold a bit of `x` (x within a; ra is a
// reversed): a carry from each bit of x runs east through its run
// ((a + x) ^ a), and the same on the reversed row runs west.
__device__ __forceinline__ unsigned close_row(unsigned x, unsigned a, unsigned ra) {
  const unsigned east = (((a + x) ^ a) & a) | x;
  const unsigned rx = __brev(x);
  return east | __brev((((ra + rx) ^ ra) & ra) | rx);
}

inline int threads_for(int n) { return ((n * n + 31) / 32) * 32; }

}  // namespace
