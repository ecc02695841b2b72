// Board step + analysis kernels for Hopper (sm_90a), plain C interface.
//
// Replaces four Pallas TPU kernels of sayuri_tpu/ops/analysis.py:
//   step_analysis_kernel  <- _step_analysis_kernel (entry step_and_analyze_tpu)
//   board_analysis_kernel <- _analysis_kernel      (entry board_analysis_tpu)
//   ladder_prep_kernel    <- _ladder_prep_kernel   (entry ladder_prep_tpu)
//   step_legal_kernel     <- _step_legal_kernel    (entry step_and_legal_tpu)
// The first two share one __device__ routine, analyze_board(), as the
// Pallas pair shares _analyze_board. The light step kernel plays, labels
// and counts liberties in one labelling of its own (see it below).
//
// What bounds them on this card: not bytes (a board is 361 bytes in and a
// few KB out) but the latency of one board's serial chain of phases. At the
// search batch (B=256, about two blocks on each of the 132 SMs) the card
// is half empty and a launch lasts about one board's chain. A phase costs
// its barrier and its longest dependent chain of shared-memory steps, and
// a step inside a loop whose trip count depends on the data costs several
// times an unrolled one (PERF.md, section 6). The design:
//   - one thread block per board and one thread per cell, the whole board
//     and every scratch map in shared memory;
//   - every labelling of the four kernels is the union-find labelling of
//     board.cuh: two barriers whatever the board, where a min-label
//     relaxation took one a pass and tens of passes on a long chain;
//   - work that the TPU kernel does in separate passes shares phases:
//     one labelling gives the chains of both colours and the empty regions
//     (class = 1 + cell value), whose roots collect the liberty counts and
//     the two reach flags, in place of two reach floods; the two colours'
//     Benson regions, Benson iterations and pass-dead regions run in the
//     same phases, each colour with its own arrays;
//   - flags that a whole region raises at its root are plain byte stores
//     (same-address atomics from a region would serialise); counts stay
//     shared-memory atomics. Any empty cell of a region serves as its
//     candidate source (the vital set does not depend on which), so no
//     atomic minimum either;
//   - integer labels (min flat index) instead of the TPU kernel's float
//     encodings and k-th-minimum propagations.
// The inner-region eye refinement stays per colour, and only runs when a
// candidate eye needs it (a block-wide flag); its slots come from per-warp
// ballots, not a serial scan of the board.
//
// Semantics follow sayuri_tpu/game/board.py and game/analysis.py cell for
// cell, including liberty counts capped at 5 and the inner-region eye
// refinement with at most INNER_SLOTS regions per board (overflow falls
// back to the unrefined eye).

#include "board.cuh"

namespace {

constexpr int NUM_LIBS = 5;
constexpr int INNER_SLOTS = 6;

// Shared scratch for one board (44,256 bytes). Residency is set by the 56
// registers a thread, not by this struct: three blocks of 384 threads an
// SM, 396 boards on the card, more than the search's B=256. Per-root
// arrays are indexed by the root's flat cell index; [k] is the colour (0
// black, 1 white) whose Benson / pass-dead analysis an array serves. Flags
// that many cells raise at one root are plain byte stores, not atomics:
// same-address atomics from a whole region serialise.
struct Smem {
  int8_t st[MAXNN];          // stones 0/1/2
  uint8_t msk[MAXNN];        // on-board
  uint8_t cls[MAXNN];        // play: opponent stones; analysis: 1 + stone
  uint8_t oth[2][MAXNN];     // not own: Benson regions
  uint8_t o2[2][MAXNN];      // not a blocker: pass-dead regions
  uint8_t blk[2][MAXNN];     // blockers (pass-alive chains, vital regions)
  uint8_t eye[2][MAXNN];
  uint8_t reach[2][MAXNN];   // empty-region root: next to a black / white stone
  uint8_t bad[2][MAXNN];     // region root: an empty cell with no own neighbour
  uint8_t nonvital[2][4][MAXNN];  // region root: slot d is not vital
  uint8_t alive[2][MAXNN];   // chain root: still alive in the Benson loop
  uint8_t unus[2][2][MAXNN]; // [parity][k] region root: not usable
  uint8_t pot[2][MAXNN];     // region root: potentially vital
  uint8_t eadj[2][MAXNN];    // pass-dead root: two of its eyes are adjacent
  uint8_t fl[MAXNN];         // refinement: flood class
  uint8_t fx[MAXNN];         // refinement: blocker maps for corner counts
  int lbl_s[MAXNN];          // chains and empty regions; play: captures
  int lbl_r[2][MAXNN];       // Benson regions
  int lbl_r2[2][MAXNN];      // pass-dead regions
  int lbl_f[MAXNN];          // refinement floods
  int haslib[MAXNN];         // play: chain root has a liberty
  int libcnt[MAXNN];         // chain root: liberties
  int ecount[2][MAXNN];      // pass-dead root: eyes
  int rb[2][MAXNN];          // region root: one of its empty cells; then
                             // refinement scratch
  int cnt[2][2][MAXNN];      // [parity][k] chain root: vital regions
  int16_t cand[2][4][MAXNN]; // region root: candidate vital chain per slot
  unsigned needw[MAXNN / 32];
  int slots[INNER_SLOTS];
  int capv, ncap, flags, nslots;
  unsigned hw[2];
};

// The light step kernel's scratch: one labelling of the played board and
// one liberty count per chain root, 4.2 KB.
struct SmemStep {
  int8_t st[MAXNN];          // the played board, then the child
  uint8_t msk[MAXNN];
  uint8_t cls[MAXNN];        // stone colour on the played board, else 0
  uint8_t haslib[MAXNN];     // opponent chain root: has a liberty
  int lbl[MAXNN];            // chains of both colours on the played board
  int libcnt[MAXNN];         // surviving chain root: liberties in the child
  int capv, ncap;
  unsigned hw[2];
};

__device__ __forceinline__ int nbr_count(const Geo& g, const volatile uint8_t* m) {
  int c = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) c += (g.nb[d] >= 0 && m[g.nb[d]]) ? 1 : 0;
  return c;
}

__device__ __forceinline__ int diag_count(const Geo& g, const volatile uint8_t* m) {
  int c = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) c += (g.dg[d] >= 0 && m[g.dg[d]]) ? 1 : 0;
  return c;
}

// This thread's result of flooding `allowed` from `seed` (read for this
// thread's cell) over 4-connected cells. Three barriers; the caller passes
// a barrier before the next call (`hit` is read after the last one).
__device__ bool flood(const Geo& g, Smem& s, bool seed, bool allowed,
                      volatile int* hit) {
  if (g.cell) {
    s.fl[g.t] = allowed;
    hit[g.t] = 0;
  }
  uf_seed(g, allowed, s.lbl_f);
  __syncthreads();
  uf_hook(g, s.fl, s.lbl_f);
  __syncthreads();
  const int r = uf_flatten(g, allowed, s.lbl_f);
  if (seed && allowed) hit[r] = 1;
  __syncthreads();
  return allowed && hit[r];
}

// What the pass-dead step knows of one cell for one colour.
struct EyeCell {
  bool m, o2, blocker, edge, interior, pre, cand_eye;
  int corner_c, r2;
};

// Inner-region refinement of colour k's eyes (false-eye life,
// two-headed dragons): every thread of the block calls it; returns the
// refined is_eye of this thread's cell. Ends on a barrier.
__device__ bool refine_eyes(const Geo& g, Smem& s, int k, const EyeCell& e,
                            bool is_eye) {
  const int t = g.t;
  volatile int* hit = s.rb[0];
  volatile int* need = s.rb[1];
  volatile uint8_t* fx = s.fx;
  const bool bor = flood(g, s, e.blocker && e.edge, e.blocker, hit);
  if (g.cell) {
    fx[t] = e.blocker && !bor;
    need[t] = 0;
  }
  __syncthreads();
  const int corner_maybe = diag_count(g, fx);
  const bool resc = e.pre && (e.interior ? e.corner_c - corner_maybe <= 1
                                         : e.corner_c == corner_maybe);
  if (resc) need[e.r2] = 1;
  __syncthreads();
  // the first INNER_SLOTS regions in cell order: a cell's rank among the
  // flagged ones from per-warp ballots
  const bool flagged = g.cell && need[t];
  const unsigned w = __ballot_sync(0xffffffffu, flagged);
  if ((t & 31) == 0) s.needw[t >> 5] = w;
  __syncthreads();
  int rank = __popc(w & ((1u << (t & 31)) - 1)), total = 0;
#pragma unroll
  for (int i = 0; i < MAXNN / 32; ++i) {
    const int c = i < (int)(blockDim.x >> 5) ? __popc(s.needw[i]) : 0;
    if (i < (t >> 5)) rank += c;
    total += c;
  }
  if (flagged && rank < INNER_SLOTS) s.slots[rank] = t;
  __syncthreads();
  const int nslots = min(total, INNER_SLOTS);
  for (int j = 0; j < nslots; ++j) {
    const bool in_region = e.o2 && e.r2 == s.slots[j];
    const bool allowed = e.m && !in_region;
    const bool out = flood(g, s, allowed && e.edge, allowed, hit);
    // inner = allowed & ~outer; corner test on blockers outside `inner`
    if (g.cell) fx[t] = s.blk[k][t] && !(allowed && !out);
    __syncthreads();
    const int cc = diag_count(g, fx);
    const bool ok2 = e.interior ? cc <= 1 : cc == 0;
    if (e.cand_eye && in_region && ok2) is_eye = true;
  }
  __syncthreads();
  return is_eye;
}

// ---------------------------------------------------------------------------
// Analysis of a board with side to move `tm` and ko vertex `ko`
// (ops/analysis.py _analyze_board semantics): this thread's cell holds `v`
// and is on the board when `m`; the routine writes both into s.st / s.msk
// itself, so it needs no barrier before it, only that no other thread
// still reads s.cls or the labels. Writes this thread's cell of every
// output. Eleven barriers, three more for each extra Benson iteration.
// ---------------------------------------------------------------------------
__device__ void analyze_board(const Geo& g, Smem& s, int8_t v, bool m, int tm,
                              int ko, bool* legal, int* libs, int* own_out,
                              bool* safe, int* sown) {
  const int t = g.t;
  const bool empty = m && v == 0;
  const bool stone = m && v != 0;
  bool own[2], other[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    own[k] = m && v == k + 1;
    other[k] = m && !own[k];
  }

  // ---- A: seeds (chains of both colours and empty regions in one class
  // map; each colour's Benson regions) and per-root flags cleared
  if (g.cell) {
    s.st[t] = v;
    s.msk[t] = m;
    s.cls[t] = m ? (uint8_t)(v + 1) : 0;
    s.libcnt[t] = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      s.oth[k][t] = other[k];
      s.reach[k][t] = 0;
      s.bad[k][t] = 0;
      s.rb[k][t] = BIG;
      s.alive[k][t] = 1;
      s.unus[0][k][t] = 0;
      s.cnt[0][k][t] = 0;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        s.cand[k][d][t] = -1;
        s.nonvital[k][d][t] = 0;
      }
    }
  }
  uf_seed(g, m ? (uint8_t)(v + 1) : 0, s.lbl_s);
  uf_seed(g, other[0], s.lbl_r[0]);
  uf_seed(g, other[1], s.lbl_r[1]);
  __syncthreads();
  // ---- B: hook all three labellings
  uf_hook(g, s.cls, s.lbl_s);
  uf_hook(g, s.oth[0], s.lbl_r[0]);
  uf_hook(g, s.oth[1], s.lbl_r[1]);
  __syncthreads();
  // ---- C: roots; flags each empty cell raises at its own roots
  const int my_s = uf_flatten(g, m, s.lbl_s);
  int my_r[2];
  my_r[0] = uf_flatten(g, other[0], s.lbl_r[0]);
  my_r[1] = uf_flatten(g, other[1], s.lbl_r[1]);
  int8_t nc[4];   // neighbour stones, -1 off the board
  bool nb_own[2] = {false, false};
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int q = g.nb[d];
    nc[d] = (q >= 0 && s.msk[q]) ? s.st[q] : -1;
    if (nc[d] > 0) nb_own[nc[d] - 1] = true;
  }
  if (empty) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (nb_own[k]) s.reach[k][my_s] = 1;
      else s.bad[k][my_r[k]] = 1;      // region not potential
      s.rb[k][my_r[k]] = t;            // one of its empty cells
    }
  }
  __syncthreads();
  // ---- D: liberties (each empty cell adds one to each distinct adjacent
  // chain); the empty cell that won rb hands its adjacent own chains to
  // the region root as candidates
  int na[4];      // the distinct chains next to an empty cell, by slot
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    int l = (empty && nc[d] > 0) ? s.lbl_s[g.nb[d]] : -1;
    for (int e = 0; e < d; ++e)
      if (na[e] == l) l = -1;
    na[d] = l;
    if (l >= 0) atomicAdd(&s.libcnt[l], 1);
  }
  int a[2][4];   // own chains of colour k next to this empty cell, by slot
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int d = 0; d < 4; ++d) a[k][d] = nc[d] == k + 1 ? na[d] : -1;
    if (empty && s.rb[k][my_r[k]] == t)
#pragma unroll
      for (int d = 0; d < 4; ++d) s.cand[k][d][my_r[k]] = (int16_t)a[k][d];
  }
  __syncthreads();
  // ---- E: liberties, legality, reach ownership; slot d of a region is
  // not vital if some empty cell of the region is not next to its chain
  const int my_libs = stone ? min(s.libcnt[my_s], NUM_LIBS) : 0;
  bool ok = false;
  const int8_t own_c = (int8_t)(tm + 1), opp_c = (int8_t)(2 - tm);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (nc[d] < 0) continue;
    if (nc[d] == 0) {
      ok = true;
    } else {
      const int lq = min(s.libcnt[s.lbl_s[g.nb[d]]], NUM_LIBS);
      if (nc[d] == own_c && lq >= 2) ok = true;
      if (nc[d] == opp_c && lq == 1) ok = true;
    }
  }
  const bool is_legal = empty && t != ko && ok;
  const bool reach_b = empty && s.reach[0][my_s], reach_w = empty && s.reach[1][my_s];
  const int own_area = (v == 1 && m ? 1 : 0) - (v == 2 && m ? 1 : 0) +
                       (reach_b && !reach_w ? 1 : 0) - (reach_w && !reach_b ? 1 : 0);
  if (empty) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int c = s.cand[k][d][my_r[k]];
        const bool member = c >= 0 && (a[k][0] == c || a[k][1] == c ||
                                       a[k][2] == c || a[k][3] == c);
        if (!member) s.nonvital[k][d][my_r[k]] = 1;
      }
    }
  }
  __syncthreads();
  // ---- F: vital slots per region root; the first Benson count (every
  // chain alive, so no region is unusable)
  int vital[2] = {0, 0};
  bool rroot[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    rroot[k] = other[k] && my_r[k] == t;
    if (!rroot[k]) continue;
    const bool potential = !s.bad[k][t];
    s.pot[k][t] = potential;
    if (!potential) continue;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      if (s.cand[k][d][t] >= 0 && !s.nonvital[k][d][t]) {
        vital[k] |= 1 << d;
        atomicAdd(&s.cnt[0][k][s.cand[k][d][t]], 1);
      }
  }
  __syncthreads();
  // ---- G: Benson iteration, both colours until both converge. Counts
  // and unusable flags alternate between two buffers, so that the
  // buffer of the next iteration is cleared while this one is read.
  int p = 0;
  for (;;) {
    bool changed = false;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (own[k] && my_s == t && s.alive[k][t] && s.cnt[p][k][t] < 2) {
        s.alive[k][t] = 0;
        changed = true;
      }
    if (g.cell) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        s.unus[p ^ 1][k][t] = 0;
        s.cnt[p ^ 1][k][t] = 0;
      }
    }
    if (!__syncthreads_or(changed)) break;
    p ^= 1;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!other[k]) continue;
      bool dead_adj = false;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (nc[d] == k + 1 && !s.alive[k][s.lbl_s[g.nb[d]]]) dead_adj = true;
      if (dead_adj) s.unus[p][k][my_r[k]] = 1;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (rroot[k] && !s.unus[p][k][t]) {
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if ((vital[k] >> d) & 1) atomicAdd(&s.cnt[p][k][s.cand[k][d][t]], 1);
      }
    __syncthreads();
  }
  // `unus[p]` is consistent with the final alive set: the last pass made
  // no change
  // ---- H: blockers; pass-dead region seeds
  bool alive_cell[2], vcell[2], blocker[2], o2[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    alive_cell[k] = own[k] && s.alive[k][my_s];
    vcell[k] = other[k] && s.pot[k][my_r[k]] && !s.unus[p][k][my_r[k]];
    blocker[k] = alive_cell[k] || vcell[k];
    o2[k] = m && !blocker[k];
    if (g.cell) {
      s.blk[k][t] = blocker[k];
      s.o2[k][t] = o2[k];
      s.ecount[k][t] = 0;
      s.eadj[k][t] = 0;
    }
    uf_seed(g, o2[k], s.lbl_r2[k]);
  }
  if (t == 0) s.flags = 0;
  __syncthreads();
  // ---- I
  uf_hook(g, s.o2[0], s.lbl_r2[0]);
  uf_hook(g, s.o2[1], s.lbl_r2[1]);
  __syncthreads();
  // ---- J: eyes of each pass-dead region
  const bool interior = diag_count(g, s.msk) == 4;
  // edge: on-board cell with a side neighbour off the board
  bool edge = false;
  if (m) {
#pragma unroll
    for (int d = 0; d < 4; ++d)
      if (nc[d] < 0) edge = true;
  }
  EyeCell e[2];
  bool is_eye[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r2 = uf_flatten(g, o2[k], s.lbl_r2[k]);
    const int corner_c = diag_count(g, s.blk[k]);
    const bool corner_ok = interior ? corner_c <= 1 : corner_c == 0;
    const bool cand_eye = o2[k] && v != 2 - k && nbr_count(g, s.blk[k]) == 0;
    e[k] = EyeCell{m, o2[k], blocker[k], edge, interior, cand_eye && !corner_ok,
                   cand_eye, corner_c, r2};
    is_eye[k] = cand_eye && corner_ok;
    if (e[k].pre) atomicOr(&s.flags, 1 << k);
    if (g.cell) s.eye[k][t] = is_eye[k];
    if (is_eye[k]) atomicAdd(&s.ecount[k][r2], 1);
  }
  __syncthreads();
  // ---- K: the refinement where a candidate eye needs it (rare), then
  // two adjacent eyes count as one
  const int flags = s.flags;
  if (flags) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if ((flags >> k) & 1) is_eye[k] = refine_eyes(g, s, k, e[k], is_eye[k]);
    if (g.cell) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        s.eye[k][t] = is_eye[k];
        s.ecount[k][t] = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (is_eye[k]) atomicAdd(&s.ecount[k][e[k].r2], 1);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!is_eye[k]) continue;
    bool adj = false;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int q = g.nb[d];
      if (q >= 0 && s.eye[k][q] && s.o2[k][q] && s.lbl_r2[k][q] == e[k].r2) adj = true;
    }
    if (adj) s.eadj[k][e[k].r2] = 1;
  }
  __syncthreads();
  // ---- L: pass-dead regions; outputs
  bool pa[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    bool pass_dead = false;
    if (o2[k]) {
      const int c = s.ecount[k][e[k].r2];
      pass_dead = c - ((c == 2 && s.eadj[k][e[k].r2]) ? 1 : 0) < 2;
    }
    pa[k] = alive_cell[k] || vcell[k] || pass_dead;
  }
  if (g.cell) {
    legal[t] = is_legal;
    libs[t] = my_libs;
    own_out[t] = own_area;
    safe[t] = pa[0] || pa[1];
    sown[t] = pa[1] ? -1 : (pa[0] ? 1 : own_area);
  }
}

// ---------------------------------------------------------------------------
// Play `action` for `tm` on board `b` of `stones` (board.py play_move
// semantics: place, remove opponent chains left without a liberty, simple
// ko) and hash the child (XOR of the per-cell Zobrist keys). A pass
// (action outside [0, nn)) leaves the board as loaded. Writes the child's
// stones, capture count, ko and hash words of board `b`; leaves the child
// in s.st / s.msk and returns its ko vertex. Four barriers, the first one
// after the load; none at the end (s.cls, s.lbl_s and s.haslib are free
// again, s.st and s.msk are read until the caller's next barrier).
// ---------------------------------------------------------------------------
__device__ int play_and_hash(const Geo& g, Smem& s, const int8_t* __restrict__ stones,
                             int size, int tm, int v,
                             const int* __restrict__ zob, long b,
                             int8_t* new_stones, int* ncap_out, int* ko_out,
                             int* hash_out) {
  const int t = g.t;
  const long off = b * g.nn;
  const bool is_pass = v >= g.nn || v < 0;
  const int8_t own_c = (int8_t)(tm + 1), opp_c = (int8_t)(2 - tm);
  const bool m = g.cell && g.y < size && g.x < size;
  int8_t c0 = g.cell ? stones[off + t] : 0;
  if (!is_pass && t == v && m) c0 = own_c;
  const bool opp = m && c0 == opp_c;
  if (g.cell) {
    s.st[t] = c0;
    s.msk[t] = m;
    s.cls[t] = opp;
    s.haslib[t] = 0;
  }
  uf_seed(g, opp, s.lbl_s);
  if (t == 0) {
    s.capv = BIG;
    s.ncap = 0;
    s.hw[0] = 0;
    s.hw[1] = 0;
  }
  __syncthreads();
  uf_hook(g, s.cls, s.lbl_s);
  __syncthreads();
  // opponent chains: does each have a liberty?
  const int root = uf_flatten(g, opp, s.lbl_s);
  if (opp) {
    bool lib = false;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int q = g.nb[d];
      if (q >= 0 && s.msk[q] && s.st[q] == 0) lib = true;
    }
    if (lib) s.haslib[root] = 1;
  }
  __syncthreads();
  // captures, and the hash of the child
  const bool captured = !is_pass && opp && !s.haslib[root];
  const int8_t c1 = captured ? 0 : c0;
  if (captured) {
    atomicAdd(&s.ncap, 1);
    atomicMin(&s.capv, t);
    s.st[t] = 0;
  }
  unsigned w0 = 0, w1 = 0;
  if (c1 == 1) {
    w0 = (unsigned)zob[0 * g.nn + t];
    w1 = (unsigned)zob[1 * g.nn + t];
  } else if (c1 == 2) {
    w0 = (unsigned)zob[2 * g.nn + t];
    w1 = (unsigned)zob[3 * g.nn + t];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    w0 ^= __shfl_xor_sync(0xffffffffu, w0, o);
    w1 ^= __shfl_xor_sync(0xffffffffu, w1, o);
  }
  if ((t & 31) == 0) {
    atomicXor(&s.hw[0], w0);
    atomicXor(&s.hw[1], w1);
  }
  __syncthreads();
  // simple ko: one stone captured by a stone with no own neighbour and a
  // single liberty; every thread reads the move's neighbours itself
  int ko2 = -1;
  const int n_cap = s.ncap;
  if (!is_pass && n_cap == 1) {
    const int vy = v / g.n, vx = v % g.n;
    int own_nb = 0, lib_nb = 0;
    const int nbv[4] = {vy > 0 ? v - g.n : -1, vy < g.n - 1 ? v + g.n : -1,
                        vx > 0 ? v - 1 : -1, vx < g.n - 1 ? v + 1 : -1};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int q = nbv[d];
      if (q < 0 || !s.msk[q]) continue;
      own_nb += s.st[q] == own_c;
      lib_nb += s.st[q] == 0;
    }
    if (own_nb == 0 && lib_nb == 1) ko2 = s.capv;
  }
  if (g.cell) new_stones[off + t] = c1;
  if (t == 0) {
    ncap_out[b] = n_cap;
    ko_out[b] = ko2;
    hash_out[2 * b] = (int)s.hw[0];
    hash_out[2 * b + 1] = (int)s.hw[1];
  }
  return ko2;
}

__global__ void __launch_bounds__(MAXNN)
board_analysis_kernel(const int8_t* __restrict__ stones,
                      const int* __restrict__ size, const int* __restrict__ ko,
                      const int* __restrict__ to_move, bool* legal, int* libs,
                      int* own, bool* safe, int* sown, int n) {
  __shared__ Smem s;
  const Geo g = make_geo(n);
  const long b = blockIdx.x;
  const long off = b * g.nn;
  const int sz = size[b];
  const int8_t v = g.cell ? stones[off + g.t] : 0;
  analyze_board(g, s, v, g.cell && g.y < sz && g.x < sz, to_move[b], ko[b],
                legal + off, libs + off, own + off, safe + off, sown + off);
}

__global__ void __launch_bounds__(MAXNN)
step_analysis_kernel(const int8_t* __restrict__ stones,
                     const int* __restrict__ size, const int* __restrict__ ko,
                     const int* __restrict__ to_move,
                     const int* __restrict__ action,
                     const int* __restrict__ zob, int8_t* new_stones,
                     int* ncap_out, int* ko_out, int* hash_out, bool* legal,
                     int* libs, int* own, bool* safe, int* sown, int n) {
  __shared__ Smem s;
  const Geo g = make_geo(n);
  const long b = blockIdx.x;
  const long off = b * g.nn;
  const int tm = to_move[b];
  const int ko2 = play_and_hash(g, s, stones, size[b], tm, action[b], zob, b,
                                new_stones, ncap_out, ko_out, hash_out);
  // ---- analysis of the child, side to move flipped ----
  analyze_board(g, s, g.cell ? s.st[g.t] : 0, g.cell && s.msk[g.t], 1 - tm,
                ko2, legal + off, libs + off, own + off, safe + off, sown + off);
}

// ---------------------------------------------------------------------------
// Light env step (the raw env-stepping path: env-steps bench, rollouts,
// opening randomization): play the move, hash the child, and only the
// child's legality for the side to move after the move. Legality needs
// each chain's "has a liberty" and "has a second liberty"; here both come
// from the exact liberty count per chain root, where the TPU kernel
// propagates a min and a negated min over float labels.
//
// What bounds it on this card: one board's serial chain of phases, paid
// once a wave; at the env-steps batch (B=4096) the launch runs about six
// waves of 660 resident boards. The design: a capture removes whole chains
// and never joins or splits another one, so ONE union-find labelling of
// the played board (class = stone colour, both colours at once; the move's
// stone already in place) gives both the opponent chains whose liberties
// decide the captures and, minus the captured ones, the child's chains.
// Four barriers whatever the board (load, hook, roots, captures and
// liberties), where the relaxation it replaced took one a pass. A 4.2 KB
// shared struct: residency is set by the 384 threads a block, five blocks
// an SM.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAXNN)
step_legal_kernel(const int8_t* __restrict__ stones,
                  const int* __restrict__ size, const int* __restrict__ ko,
                  const int* __restrict__ to_move,
                  const int* __restrict__ action,
                  const int* __restrict__ zob, int8_t* new_stones,
                  int* ncap_out, int* ko_out, int* hash_out, bool* legal,
                  int n) {
  __shared__ SmemStep s;
  const Geo g = make_geo(n);
  const int t = g.t;
  const long b = blockIdx.x;
  const long off = b * g.nn;
  const int tm = to_move[b];
  const int v = action[b];
  const int sz = size[b];
  const bool is_pass = v >= g.nn || v < 0;
  const int8_t own_c = (int8_t)(tm + 1), opp_c = (int8_t)(2 - tm);
  const bool m = g.cell && g.y < sz && g.x < sz;
  int8_t c0 = g.cell ? stones[off + t] : 0;
  if (!is_pass && t == v && m) c0 = own_c;
  const uint8_t c = m ? (uint8_t)c0 : 0;

  // ---- 1: the played board; seeds of one labelling of both colours
  if (g.cell) {
    s.st[t] = c0;
    s.msk[t] = m;
    s.cls[t] = c;
    s.haslib[t] = 0;
    s.libcnt[t] = 0;
  }
  uf_seed(g, c, s.lbl);
  if (t == 0) {
    s.capv = BIG;
    s.ncap = 0;
    s.hw[0] = 0;
    s.hw[1] = 0;
  }
  __syncthreads();
  // ---- 2
  uf_hook(g, s.cls, s.lbl);
  __syncthreads();
  // ---- 3: roots; an opponent chain with an empty neighbour has a liberty
  const int root = uf_flatten(g, c != 0, s.lbl);
  int8_t nc[4];   // neighbours on the played board, -1 off the board
  bool lib = false;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int q = g.nb[d];
    nc[d] = (q >= 0 && s.msk[q]) ? s.st[q] : -1;
    lib |= nc[d] == 0;
  }
  const bool opp = c != 0 && c0 == opp_c;
  if (opp && lib) s.haslib[root] = 1;
  __syncthreads();
  // ---- 4: captures, the child and its hash; every empty cell of the
  // child is one liberty of each distinct adjacent chain that survives
  const bool captured = !is_pass && opp && !s.haslib[root];
  const int8_t c1 = captured ? 0 : c0;
  if (captured) {
    atomicAdd(&s.ncap, 1);
    atomicMin(&s.capv, t);
    s.st[t] = 0;
  }
  int nr[4];      // root of the surviving neighbour chain, else -1
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    int r = -1;
    if (nc[d] > 0) {
      r = s.lbl[g.nb[d]];
      if (!is_pass && nc[d] == opp_c && !s.haslib[r]) r = -1;
    }
    nr[d] = r;
  }
  if (m && c1 == 0) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      bool dup = nr[d] < 0;
      for (int e = 0; e < d; ++e) dup |= nr[e] == nr[d];
      if (!dup) atomicAdd(&s.libcnt[nr[d]], 1);
    }
  }
  unsigned w0 = 0, w1 = 0;
  if (c1 != 0) {
    const int k = 2 * (c1 - 1);
    w0 = (unsigned)zob[k * g.nn + t];
    w1 = (unsigned)zob[(k + 1) * g.nn + t];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    w0 ^= __shfl_xor_sync(0xffffffffu, w0, o);
    w1 ^= __shfl_xor_sync(0xffffffffu, w1, o);
  }
  if ((t & 31) == 0) {
    atomicXor(&s.hw[0], w0);
    atomicXor(&s.hw[1], w1);
  }
  if (g.cell) new_stones[off + t] = c1;
  __syncthreads();
  // ---- 5: simple ko (one stone captured by a stone with no own neighbour
  // and a single liberty; every thread reads the move's neighbours itself),
  // then legality for the side to move in the child (1 - tm): empty, not
  // ko, and an empty neighbour, an own chain with >= 2 liberties or an
  // opponent chain in atari next to it
  int ko2 = -1;
  const int n_cap = s.ncap;
  if (!is_pass && n_cap == 1) {
    const int vy = v / g.n, vx = v % g.n;
    int own_nb = 0, lib_nb = 0;
    const int nbv[4] = {vy > 0 ? v - g.n : -1, vy < g.n - 1 ? v + g.n : -1,
                        vx > 0 ? v - 1 : -1, vx < g.n - 1 ? v + 1 : -1};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int q = nbv[d];
      if (q < 0 || !s.msk[q]) continue;
      own_nb += s.st[q] == own_c;
      lib_nb += s.st[q] == 0;
    }
    if (own_nb == 0 && lib_nb == 1) ko2 = s.capv;
  }
  bool ok = false;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (nc[d] < 0) continue;
    if (nr[d] < 0) {
      ok = true;   // empty in the child (empty before, or captured)
    } else {
      const int lq = s.libcnt[nr[d]];
      if (nc[d] == opp_c && lq >= 2) ok = true;   // own chain of 1 - tm
      if (nc[d] == own_c && lq == 1) ok = true;   // the mover's, in atari
    }
  }
  if (g.cell) legal[off + t] = m && c1 == 0 && t != ko2 && ok;
  if (t == 0) {
    ncap_out[b] = n_cap;
    ko_out[b] = ko2;
    hash_out[2 * b] = (int)s.hw[0];
    hash_out[2 * b + 1] = (int)s.hw[1];
  }
}

// ---------------------------------------------------------------------------
// Ladder candidate prep (game/ladder.py reads it): chain labels, liberties
// capped at 3, each chain's first and second liberty vertex, and the
// single-vertex legality of both colours. One block per board: at the
// search's B=256 the launch is one wave, so its time is one board's chain
// of phases. Three barriers on every board (load, hook, roots and
// liberties):
//   - one union-find labelling of both colours (class = colour; board.cuh),
//     whose roots are each chain's smallest flat index, the labels output;
//   - in the roots' phase, one liberty pass of shared-memory atomics:
//     every empty cell climbs to the roots of its neighbour chains itself
//     (a warp-uniform loop, as uf_flatten's; parents only point down to a
//     smaller cell of the same chain and flatten only writes roots, so no
//     barrier is needed first), adds one to each distinct one and offers
//     itself as a liberty vertex. Liberties are exact distinct counts
//     capped afterwards, where the TPU kernel propagates k-th liberties
//     over float labels. The first liberty is an atomicMin; the second
//     needs no pass of its own: of the
//     value an atomicMin replaces and the one it offers, the larger is a
//     candidate for the second, the smallest vertex is never one, and the
//     second smallest always is (it either meets the smallest already
//     there or is replaced by it), so an atomicMin of the candidates gives
//     the second liberty.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAXNN)
ladder_prep_kernel(const int8_t* __restrict__ stones,
                   const int* __restrict__ size, const int* __restrict__ ko,
                   int* labels, int* nlibs, int* lib1, int* lib2,
                   bool* legal_black, bool* legal_white, int n) {
  __shared__ uint8_t cls[MAXNN];   // stone colour on the board, else 0
  __shared__ uint8_t msk[MAXNN];
  __shared__ int lbl[MAXNN], cnt[MAXNN], l1[MAXNN], l2[MAXNN];
  const Geo g = make_geo(n);
  const int t = g.t;
  const long b = blockIdx.x;
  const long off = b * g.nn;
  const int sz = size[b];
  const bool m = g.cell && g.y < sz && g.x < sz;
  const int8_t v = g.cell ? stones[off + t] : 0;
  const uint8_t c = m ? (uint8_t)v : 0;
  // ---- 1: the board; seeds of one labelling of both colours
  if (g.cell) {
    cls[t] = c;
    msk[t] = m;
    cnt[t] = 0;
    l1[t] = g.nn;
    l2[t] = g.nn;
  }
  uf_seed(g, c, lbl);
  __syncthreads();
  // ---- 2
  uf_hook(g, cls, lbl);
  __syncthreads();
  // ---- 3: roots; every empty cell climbs to its neighbour chains' roots
  // and is one liberty of each distinct one
  const int root = uf_flatten(g, c != 0, lbl);
  const bool empty = m && v == 0;
  int adj[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int q = g.nb[d];
    adj[d] = (empty && q >= 0 && cls[q]) ? lbl[q] : -1;
  }
  while (true) {
    bool climb = false;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      if (adj[d] >= 0) {
        const int up = lbl[adj[d]];
        climb |= up != adj[d];
        adj[d] = up;
      }
    if (!__any_sync(ALL, climb)) break;
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    int l = adj[d];
    for (int e = 0; e < d; ++e)
      if (adj[e] == l) l = -1;
    adj[d] = l;
    if (l >= 0) {
      atomicAdd(&cnt[l], 1);
      const int old = atomicMin(&l1[l], t);
      atomicMin(&l2[l], max(old, t));
    }
  }
  __syncthreads();
  if (!g.cell) return;
  labels[off + t] = c ? root : -1;
  nlibs[off + t] = c ? min(cnt[root], 3) : 0;
  lib1[off + t] = c ? l1[root] : g.nn;
  lib2[off + t] = c ? l2[root] : g.nn;
  // legal for a colour: empty, not ko, and an empty neighbour, an own
  // neighbour chain with >= 2 liberties or an opponent one in atari
  bool nb_empty = false, ok_b = false, ok_w = false;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int q = g.nb[d];
    if (q < 0 || !msk[q]) continue;
    const uint8_t cq = cls[q];
    if (cq == 0) {
      nb_empty = true;
      continue;
    }
    const int lq = cnt[lbl[q]];
    if (cq == 1) {
      ok_b |= lq >= 2;
      ok_w |= lq == 1;
    } else {
      ok_w |= lq >= 2;
      ok_b |= lq == 1;
    }
  }
  const bool base = empty && t != ko[b];
  legal_black[off + t] = base && (nb_empty || ok_b);
  legal_white[off + t] = base && (nb_empty || ok_w);
}

}  // namespace

extern "C" int launch_board_analysis(const void* stones, const void* size,
                                     const void* ko, const void* to_move,
                                     void* legal, void* libs, void* own,
                                     void* safe, void* sown, int batch, int n,
                                     void* stream) {
  if (n < 2 || n * n > MAXNN || batch <= 0) return (int)cudaErrorInvalidValue;
  board_analysis_kernel<<<batch, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const int8_t*)stones, (const int*)size, (const int*)ko,
      (const int*)to_move, (bool*)legal, (int*)libs, (int*)own, (bool*)safe,
      (int*)sown, n);
  return (int)cudaGetLastError();
}

extern "C" int launch_step_analysis(const void* stones, const void* size,
                                    const void* ko, const void* to_move,
                                    const void* action, const void* zob,
                                    void* new_stones, void* ncap, void* new_ko,
                                    void* hash, void* legal, void* libs,
                                    void* own, void* safe, void* sown,
                                    int batch, int n, void* stream) {
  if (n < 2 || n * n > MAXNN || batch <= 0) return (int)cudaErrorInvalidValue;
  step_analysis_kernel<<<batch, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const int8_t*)stones, (const int*)size, (const int*)ko,
      (const int*)to_move, (const int*)action, (const int*)zob,
      (int8_t*)new_stones, (int*)ncap, (int*)new_ko, (int*)hash, (bool*)legal,
      (int*)libs, (int*)own, (bool*)safe, (int*)sown, n);
  return (int)cudaGetLastError();
}

extern "C" int launch_step_legal(const void* stones, const void* size,
                                 const void* ko, const void* to_move,
                                 const void* action, const void* zob,
                                 void* new_stones, void* ncap, void* new_ko,
                                 void* hash, void* legal, int batch, int n,
                                 void* stream) {
  if (n < 2 || n * n > MAXNN || batch <= 0) return (int)cudaErrorInvalidValue;
  step_legal_kernel<<<batch, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const int8_t*)stones, (const int*)size, (const int*)ko,
      (const int*)to_move, (const int*)action, (const int*)zob,
      (int8_t*)new_stones, (int*)ncap, (int*)new_ko, (int*)hash, (bool*)legal,
      n);
  return (int)cudaGetLastError();
}

extern "C" int launch_ladder_prep(const void* stones, const void* size,
                                  const void* ko, void* labels, void* nlibs,
                                  void* lib1, void* lib2, void* legal_black,
                                  void* legal_white, int batch, int n,
                                  void* stream) {
  if (n < 2 || n * n > MAXNN || batch <= 0) return (int)cudaErrorInvalidValue;
  ladder_prep_kernel<<<batch, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const int8_t*)stones, (const int*)size, (const int*)ko, (int*)labels,
      (int*)nlibs, (int*)lib1, (int*)lib2, (bool*)legal_black,
      (bool*)legal_white, n);
  return (int)cudaGetLastError();
}
