// Exact ladder chases for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels of sayuri_tpu/ops/ladder_kernel.py:
//   greedy_kernel <- _greedy_kernel (entry run_greedy, body _greedy_machine)
//   chase_kernel  <- _chase_kernel  (entry run_chases, body _dfs_machine)
// Both share one __device__ ply routine, step_select(), as the Pallas pair
// shares _step_select. A lane is one chase: a candidate chain (the prey) and
// the hunter's first move, on 32 row bitboards.
//
// What bounds it on this card: not bytes (a lane reads 264 bytes and writes
// 8) but one lane's serial plies. All lanes of a launch are resident at
// once, so a launch lasts as long as its longest lane: a chain of dependent
// plies (over a thousand on the longest lanes of a midgame batch), each a
// chain of dependent warp-wide steps (chain floods, popcounts, lowest
// vertices). The design answers that with:
//   - one warp per lane, thread r holding row r of the own (prey colour),
//     opponent and prey boards: a neighbour step is two shifts and a row
//     exchange through the warp's shared rows (one __syncwarp for up to
//     eight boards), a popcount or a lowest vertex one warp reduction; no
//     block barrier on the hot path.
//   - a short ply. The floods that do not depend on each other advance
//     together in one loop, one exchange and one vote a step (floods<K>),
//     and the last one still growing goes on alone: the pending move's
//     capture floods (with the prey's own flood after a prey move); then
//     one flood a neighbour of each prey liberty that the selections
//     query, in the colour of its stone (a vote picks it: 8 on a hunter
//     ply, 4 and the first capture peel on a prey ply). A flood step
//     closes each row's runs in one go (close_row), so the loop counts
//     vertical growth steps, not cells. The counts a ply needs are packed
//     three to a reduction and issued back to back; a ply that the prey's
//     liberty count decides stops there; a hunter move only ever removes
//     whole prey-colour chains, so the prey needs no flood on a prey ply;
//     the fork stack keeps the prey's rows, so a resume needs none either.
//     On the CPU shim the longest lane of a midgame batch runs about 8x
//     fewer warp-wide operations than with one flood after another, and
//     on the card it takes half the time (PERF.md).
//   - per-lane loops: a lane stops at its own terminal instead of waiting,
//     as the TPU's lockstep lanes did, for the slowest lane of its chunk.
//     The lockstep iteration caps become per-lane caps, which is the same
//     thing: every active lane advanced one step per lockstep iteration.
//   - the fork stack's board rows live in per-thread local arrays indexed by
//     the stack pointer (local memory is sized by resident threads, not by
//     launched lanes); its scalars sit in shared memory, one stack per warp.
//   - lanes that are not valid exit at once, so the grid covers every lane
//     and the caller needs no host-side compaction.
// A lane's AND-OR tree stays on one warp in depth-first order: where a limit
// binds, its result depends on that order.
//
// Semantics follow sayuri_tpu/ops/ladder_kernel.py step for step, including
// its per-lane limits: node_cap descents, max_forks frames, MAX_ALTS stored
// alternatives; hitting a limit reads as PREY_GOOD.

#include "board.cuh"   // close_row, ALL

namespace {

constexpr int ROWS = 32;
constexpr int MAX_FORKS = 56;
constexpr int MAX_ALTS = 4;
constexpr int BIGI = 1000000000;
constexpr int UNDECIDED = 0, PREY_GOOD = 1, HUNTER_GOOD = 2;
constexpr int WARPS = 4;          // lanes per block, one warp each
constexpr int KMAX = 8;           // boards a vertical exchange carries
constexpr int SLOTS = ROWS + 2;   // a board's rows in xs, a zero row each side
constexpr int XS_WORDS = 2 * KMAX * SLOTS;   // a warp's exchange rows

// This thread's view of its lane.
struct Row {
  int r;              // the row this thread holds
  int n;              // buffer width: flat vertex = row * n + column
  unsigned inv_n;     // 2^32 / n rounded up: row of v = umulhi(v, inv_n)
  unsigned colmask;   // columns < the lane's board size
  unsigned* xs;       // the warp's exchange rows: [2][KMAX][SLOTS]
  int buf;            // the half of xs the next exchange writes
};

// Zeroes the rows past both edges of every board of the warp's xs (row
// slots 0 and SLOTS - 1; no exchange writes them). Every lane calls it.
__device__ __forceinline__ void clear_edges(const Row& g) {
  static_assert(2 * 2 * KMAX <= 32, "clear_edges: one slot a lane");
  const int board = g.r >> 1;   // [2][KMAX] boards, two edge slots each
  if (board < 2 * KMAX) g.xs[board * SLOTS + (g.r & 1) * (SLOTS - 1)] = 0u;
}

// The rows above and below this thread's of K boards (zero past the edge),
// through the warp's shared rows: K stores, one __syncwarp, 2K loads. The
// two halves of xs alternate, so a store never meets a load of the
// exchange before (that one ended before the __syncwarp all lanes passed
// since). Every lane of the warp calls it.
template <int K>
__device__ __forceinline__ void exchange(Row& g, const unsigned (&v)[K],
                                         unsigned (&up)[K], unsigned (&dn)[K]) {
  static_assert(K <= KMAX, "exchange: too many boards");
  unsigned* b = g.xs + g.buf * (KMAX * SLOTS) + g.r;
  g.buf ^= 1;
#pragma unroll
  for (int k = 0; k < K; ++k) b[k * SLOTS + 1] = v[k];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    up[k] = b[k * SLOTS];
    dn[k] = b[k * SLOTS + 2];
  }
}

// OR of the east and west neighbours within the row
__device__ __forceinline__ unsigned side_nbr(const Row& g, unsigned b) {
  return ((b << 1) & g.colmask) | (b >> 1);
}

// Grow K seeds x[k], each within allowed[k], until none of them grows. The
// K floods advance together: one exchange and one vote a step for all of
// them, so the caller pays the longest flood once, not the sum. A step
// closes the rows horizontally, so the loop runs once per vertical growth
// step. On return nb[k] holds the neighbours of x[k] (from the last step's
// exchange, taken when nothing grew).
template <int K>
__device__ __forceinline__ void floods(Row& g, unsigned (&x)[K],
                                       const unsigned (&allowed)[K],
                                       unsigned (&nb)[K]) {
  unsigned ra[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ra[k] = __brev(allowed[k]);
    x[k] = close_row(x[k] & allowed[k], allowed[k], ra[k]);
  }
  while (true) {
    unsigned up[K], grew = 0u;
    exchange(g, x, up, nb);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      nb[k] |= up[k];
      const unsigned add = nb[k] & allowed[k] & ~x[k];
      grew |= (add ? 1u : 0u) << k;
      x[k] = add ? close_row(x[k] | add, allowed[k], ra[k]) : x[k];
    }
    grew = K == 1 ? (unsigned)__any_sync(ALL, grew) : __reduce_or_sync(ALL, grew);
    if (!grew) break;
    if (K > 1 && !(grew & (grew - 1u))) {
      // one flood still grows (a long chain beside short ones): it goes on
      // alone, one board a step instead of K
      const int j = __ffs(grew) - 1;
      unsigned xj[1], uj[1], nj[1], aj = 0u, rj = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k == j) {
          xj[0] = x[k];
          aj = allowed[k];
          rj = ra[k];
        }
      do {
        exchange(g, xj, uj, nj);
        nj[0] |= uj[0];
        const unsigned add = nj[0] & aj & ~xj[0];
        xj[0] = add ? close_row(xj[0] | add, aj, rj) : xj[0];
        grew = add;
      } while (__any_sync(ALL, grew));
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k == j) {
          x[k] = xj[0];
          nb[k] = nj[0];
        }
      break;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) nb[k] |= side_nbr(g, x[k]);
}

// Exact warp totals of N per-thread counts (each at most one row's 32 bits,
// each total at most 1023): three 10-bit fields a reduction, the
// reductions independent of each other.
template <int N>
__device__ __forceinline__ void totals(int (&c)[N]) {
  constexpr int W = (N + 2) / 3;
  unsigned w[W];
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) w[k / 3] |= (unsigned)c[k] << (10 * (k % 3));
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = __reduce_add_sync(ALL, w[i]);
#pragma unroll
  for (int k = 0; k < N; ++k) c[k] = (int)((w[k / 3] >> (10 * (k % 3))) & 1023u);
}

// smallest flat vertex set on the board, BIGI when it is empty
__device__ __forceinline__ int lowest(const Row& g, unsigned b) {
  unsigned v = b ? (unsigned)(g.r * g.n + __ffs(b) - 1) : (unsigned)BIGI;
  return (int)__reduce_min_sync(ALL, v);
}

// largest flat vertex set on the board, -1 when it is empty
__device__ __forceinline__ int highest(const Row& g, unsigned b) {
  int v = b ? g.r * g.n + 31 - __clz(b) : -1;
  return __reduce_max_sync(ALL, v);
}

// The one-hot board of vertex v (*bit) and its 4 neighbour cells (E, W, S,
// N), one bit each; v < 0 or v >= n*n gives empty boards. Each row compares
// its index with v's: no exchange.
__device__ __forceinline__ void vertex_seeds(const Row& g, int v, unsigned* bit,
                                             unsigned* s) {
  int rv = -2;
  unsigned b = 0u;
  if (v >= 0 && v < g.n * g.n) {
    rv = (int)__umulhi((unsigned)v, g.inv_n);
    b = 1u << (v - rv * g.n);
  }
  const unsigned here = g.r == rv ? b : 0u;
  *bit = here;
  s[0] = (here << 1) & g.colmask;
  s[1] = here >> 1;
  s[2] = g.r == rv + 1 ? b : 0u;
  s[3] = g.r == rv - 1 ? b : 0u;
}

// Liberty/atari facts of the <= 4 own and <= 4 opp chains next to a vertex
// (_chain_queries, GetLadderLiberties semantics).
struct Query {
  int conn, maxconn, ncaps, potential, p;
  bool own_safe, own_atari, opp_safe;
};

// One query's seeds: the vertex's 4 neighbour cells and their union.
struct QuerySeeds {
  unsigned seed[4];
  unsigned all;
};

__device__ __forceinline__ QuerySeeds query_seeds(const Row& g, int v) {
  QuerySeeds q;
  unsigned bit;
  vertex_seeds(g, v, &bit, q.seed);
  q.all = q.seed[0] | q.seed[1] | q.seed[2] | q.seed[3];
  return q;
}

// This thread's colour bits of a query (QUERY_BITS): bit d, the neighbour
// cell of direction d is an own stone; bit 4 + d, an opponent stone; bit
// 8 + d, a stone of the prey.
constexpr int QUERY_BITS = 12;

__device__ __forceinline__ unsigned query_colours(const QuerySeeds& q, unsigned own,
                                                  unsigned opp, unsigned prey) {
  unsigned c = 0u;
#pragma unroll
  for (int d = 0; d < 4; ++d)
    c |= ((q.seed[d] & own) ? 1u : 0u) << d | ((q.seed[d] & opp) ? 1u : 0u) << (4 + d) |
         ((q.seed[d] & prey) ? 1u : 0u) << (8 + d);
  return c;
}

// One flood a direction, within the colour of its stone (`cols`: the
// warp's colour bits); an empty cell gives an empty flood, a prey stone
// the prey itself (a whole chain: it does not grow).
__device__ __forceinline__ void query_floods(const QuerySeeds& q, unsigned cols,
                                             unsigned own, unsigned opp,
                                             unsigned prey, unsigned* x,
                                             unsigned* allowed) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const bool mine = cols >> d & 1u;
    allowed[d] = mine ? own : opp;
    x[d] = (cols >> (8 + d) & 1u) ? prey
           : (mine || (cols >> (4 + d) & 1u)) ? q.seed[d] : 0u;
  }
}

// This thread's counts of one query: the liberties (4) and stones (4) of
// each direction's chain, the vertex's empty neighbours, and a direction's
// seed lying in the chain of an earlier direction (bit d; chains are equal
// or disjoint, so a direction counts iff its seed is in no earlier chain).
constexpr int QUERY_COUNTS = 10;

__device__ __forceinline__ void query_counts(const QuerySeeds& q, const unsigned* x,
                                             const unsigned* nb, unsigned empty,
                                             int* c) {
  unsigned prev = 0u;
  int dup = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    c[d] = __popc(nb[d] & empty);
    c[4 + d] = __popc(x[d]);
    dup |= ((q.seed[d] & prev) ? 1 : 0) << d;
    prev |= x[d];
  }
  c[8] = __popc(q.all & empty);
  c[9] = dup;
}

// The facts from the warp's colour bits and totals.
__device__ __forceinline__ Query query_facts(unsigned cols, const int* c) {
  Query q = {0, 0, 0, 0, c[8], false, false, false};
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (c[9] >> d & 1) continue;   // a chain met in an earlier direction
    const int libs = c[d];
    if (cols >> d & 1u) {
      q.conn += libs - 1;
      q.maxconn = max(q.maxconn, libs - 1);
      q.own_safe |= libs >= 2;
      q.own_atari |= libs == 1;
    } else if (cols >> (4 + d) & 1u) {
      if (libs == 1) {
        q.ncaps += 1;
        q.potential += c[4 + d];
      }
      q.opp_safe |= libs >= 2;
    }
  }
  return q;
}

struct Sel {
  unsigned own1, opp1, prey1;
  int ko1;
  bool selector_prey;
  int term;
  int first_v;
  int k;                 // number of valid selections
  int alts[MAX_ALTS];    // the valid selections after the first
};

// One ply (_step_select): apply the pending move, then the next side's
// selections and terminal test (PreySelections / HunterSelections). `prey`
// is a whole chain of `own` (or empty). The selections are only set where
// the ply is not terminal (no caller reads them otherwise).
__device__ Sel step_select(Row& g, unsigned full, unsigned own, unsigned opp,
                           unsigned prey, int ko, int pend_v, bool pend_prey) {
  Sel s;
  s.first_v = -1;
  s.k = 0;
#pragma unroll
  for (int a = 0; a < MAX_ALTS; ++a) s.alts[a] = -1;
  s.selector_prey = !pend_prey;   // the prey answers a hunter move
  const bool has_move = pend_v >= 0;
  const unsigned empty = full & ~own & ~opp;

  // ---- the pending move (_place_stone) and the prey. The prey is a whole
  // chain and is never flooded again: the floods of this step stop at it.
  //   x[0..3]: the `other` chains next to the move, the prey left out; a
  //            chain whose only liberty was the move's cell is captured
  //   x[4]:    a prey move's chain without the prey (it joins the prey if
  //            the move touches it); on a prey ply the prey and the hunter
  //            chains next to it
  //   x[5]:    the prey itself, for its neighbours
  unsigned mbit, ms[4];
  vertex_seeds(g, has_move ? pend_v : -1, &mbit, ms);
  const unsigned ms_all = ms[0] | ms[1] | ms[2] | ms[3];
  const unsigned mover = pend_prey ? own : opp, other = pend_prey ? opp : own;
  const unsigned mover2 = mover | mbit;
  const unsigned rest = other & ~prey;
  unsigned x[6] = {ms[0] & rest, ms[1] & rest, ms[2] & rest, ms[3] & rest,
                   pend_prey ? mbit : prey, prey};
  unsigned nb[6];
  floods(g, x, {rest, rest, rest, rest, pend_prey ? mover2 & ~prey : prey | opp | mbit,
                prey}, nb);
  // one reduction: min(row count, 2) summed is 1 exactly when a chain has
  // one liberty (6 bits a direction); the prey's liberties other than the
  // move's cell (5 bits: zero or not); the move touching the prey
  unsigned f = 0u;
#pragma unroll
  for (int d = 0; d < 4; ++d) f |= (unsigned)min(__popc(nb[d] & empty), 2) << (6 * d);
  f |= (unsigned)min(__popc(nb[5] & empty & ~mbit), 1) << 24;
  f |= (mbit & nb[5] ? 1u : 0u) << 29;
  f = __reduce_add_sync(ALL, f);
  const bool touches_prey = f >> 29 & 1u;
  unsigned captured = 0u;
#pragma unroll
  for (int d = 0; d < 4; ++d)
    if ((f >> (6 * d) & 63u) == 1u) captured |= x[d];
  // a hunter move takes the prey when it fills the prey's last liberty
  const bool prey_taken = !pend_prey && touches_prey && (f >> 24 & 31u) == 0u;
  if (prey_taken) captured |= prey;
  const unsigned other2 = other & ~captured;
  s.own1 = pend_prey ? mover2 : other2;
  s.opp1 = pend_prey ? other2 : mover2;
  const unsigned empty1 = full & ~s.own1 & ~s.opp1;

  // ---- the prey's liberties, and the simple-ko test of the move: the
  // stones captured, own stones and empty cells next to it, and the prey's
  // liberties, in one reduction (10 + 3 + 3 + 10 bits)
  int l1, l2 = BIGI, v0 = BIGI;
  unsigned a = 0u;   // prey ply: hunter stones next to the prey to peel
  unsigned prey_libs;
  const unsigned cnt_move = (unsigned)__popc(captured) |
                            (unsigned)__popc(ms_all & mover) << 10 |
                            (unsigned)__popc(ms_all & empty1) << 13;
  unsigned cnt;
  if (pend_prey) {
    // a prey move joins the prey when it touches it, else leaves it alone
    s.prey1 = touches_prey ? prey | x[4] : prey;
    prey_libs = (touches_prey ? nb[5] | nb[4] : nb[5]) & empty1;
    cnt = __reduce_add_sync(ALL, cnt_move | (unsigned)__popc(prey_libs) << 16);
    l1 = lowest(g, prey_libs);
    l2 = highest(g, prey_libs);
  } else {
    // a hunter move removes whole prey-colour chains: the prey is intact
    // or gone. Hunter chains next to the prey that hold a stone with two
    // empty neighbours have two liberties and are not peeled.
    s.prey1 = prey_taken ? 0u : prey;
    const unsigned np = prey_taken ? 0u : nb[5];
    const unsigned near = x[4] & ~prey;   // the hunter chains next to the prey
    unsigned v[1] = {empty1}, up[1], dn[1];
    exchange(g, v, up, dn);
    const unsigned e_e = (empty1 << 1) & g.colmask, e_w = empty1 >> 1;
    const unsigned e_s = up[0], e_n = dn[0];
    const unsigned two = (e_e & e_w) | (e_e & e_s) | (e_e & e_n) |
                         (e_w & e_s) | (e_w & e_n) | (e_s & e_n);
    unsigned na[1] = {two & near}, nna[1];
    floods(g, na, {near}, nna);
    prey_libs = np & empty1;
    a = np & s.opp1 & ~na[0];
    cnt = __reduce_add_sync(ALL, cnt_move | (unsigned)__popc(prey_libs) << 16);
    l1 = lowest(g, prey_libs);
    v0 = lowest(g, a);
  }
  const int kov = lowest(g, captured);
  const int ncap = cnt & 1023u, own_nb = cnt >> 10 & 7u, mlibs = cnt >> 13 & 7u;
  const int nlibs = cnt >> 16;
  s.ko1 = has_move ? ((ncap == 1 && own_nb == 0 && mlibs == 1) ? kov : -1) : ko;

  bool ok[5] = {false, false, false, false, false};
  int vals[5] = {0, 0, 0, 0, 0};
  if (s.selector_prey) {
    // ---- PreySelections (board.cc:519-573) ----
    if (nlibs >= 2 || (has_move && s.ko1 >= 0)) {
      s.term = PREY_GOOD;
      return s;
    }
    // the chains next to the prey's liberty, and the first capture peel:
    // <= 4 hunter chains next to the prey, in lowest vertex order
    const QuerySeeds q = query_seeds(g, l1);
    const unsigned cols =
        __reduce_or_sync(ALL, query_colours(q, s.own1, s.opp1, s.prey1));
    unsigned qx[5], al[5], qnb[5], unused[4];
    query_floods(q, cols, s.own1, s.opp1, s.prey1, qx, al);
    vertex_seeds(g, v0, &qx[4], unused);
    al[4] = s.opp1;
    floods(g, qx, al, qnb);
    unsigned lm = qnb[4] & empty1;
    int c[QUERY_COUNTS + 1];
    query_counts(q, qx, qnb, empty1, c);
    c[QUERY_COUNTS] = __popc(lm);
    totals(c);
    int lm_low = lowest(g, lm);
    const Query q1 = query_facts(cols, c);
    const int p1 = q1.p;
    const bool escape = nlibs == 1 && l1 != s.ko1 &&
                        (p1 > 0 || q1.own_safe || q1.ncaps > 0);
    int cap[4] = {BIGI, BIGI, BIGI, BIGI};
    if (v0 < BIGI) {
      if (c[QUERY_COUNTS] == 1) cap[0] = lm_low;
      a &= ~qx[4];
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        const int v = lowest(g, a);
        if (v >= BIGI) break;   // nothing left to peel
        unsigned px[1], pnb[1];
        vertex_seeds(g, v, &px[0], unused);
        floods(g, px, {s.opp1}, pnb);
        lm = pnb[0] & empty1;
        const int nlm = (int)__reduce_add_sync(ALL, (unsigned)__popc(lm));
        lm_low = lowest(g, lm);
        if (nlm == 1) cap[i] = lm_low;
        a &= ~px[0];
      }
    }
    ok[0] = escape;
    vals[0] = escape ? l1 : BIGI;
    int kp = escape ? 1 : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool dup = cap[i] == l1;
#pragma unroll
      for (int j = 0; j < i; ++j) dup |= cap[i] == cap[j];
      ok[i + 1] = cap[i] < BIGI && cap[i] != s.ko1 && !dup;
      vals[i + 1] = cap[i];
      kp += ok[i + 1] ? 1 : 0;
    }
    const int lower = q1.ncaps + max(p1, q1.maxconn);
    const int upper = p1 + q1.potential + q1.conn;
    if (kp == 0) s.term = HUNTER_GOOD;
    else if (escape && lower >= 3) s.term = PREY_GOOD;
    else if (escape && kp == 1 && upper == 1) s.term = HUNTER_GOOD;
    else s.term = UNDECIDED;
  } else {
    // ---- HunterSelections (board.cc:575-644) ----
    if (nlibs >= 3 || nlibs <= 1) {
      s.term = nlibs >= 3 ? PREY_GOOD : HUNTER_GOOD;
      return s;
    }
    // two liberties: l1 the lower, l2 the higher; the chains next to both
    const QuerySeeds q[2] = {query_seeds(g, l1), query_seeds(g, l2)};
    const unsigned cols = __reduce_or_sync(
        ALL, query_colours(q[0], s.own1, s.opp1, s.prey1) |
                 query_colours(q[1], s.own1, s.opp1, s.prey1) << QUERY_BITS);
    unsigned qx[8], al[8], qnb[8];
    query_floods(q[0], cols, s.own1, s.opp1, s.prey1, qx, al);
    query_floods(q[1], cols >> QUERY_BITS, s.own1, s.opp1, s.prey1, qx + 4, al + 4);
    floods(g, qx, al, qnb);
    unsigned l2bit, unused[4];
    vertex_seeds(g, l2, &l2bit, unused);
    int c[2 * QUERY_COUNTS + 1];
    query_counts(q[0], qx, qnb, empty1, c);
    query_counts(q[1], qx + 4, qnb + 4, empty1, c + QUERY_COUNTS);
    c[2 * QUERY_COUNTS] = __popc(q[0].all & l2bit);
    totals(c);
    const Query q1 = query_facts(cols, c);
    const Query q2 = query_facts(cols >> QUERY_BITS, c + QUERY_COUNTS);
    const int p1 = q1.p, p2 = q2.p;
    const bool adjacent = c[2 * QUERY_COUNTS] > 0;
    const bool legal1 = l1 < BIGI && l1 != s.ko1 &&
                        (p1 > 0 || q1.opp_safe || q1.own_atari);
    const bool legal2 = l2 < BIGI && l2 != s.ko1 &&
                        (p2 > 0 || q2.opp_safe || q2.own_atari);
    const bool both_open = !adjacent && p1 >= 3 && p2 >= 3;
    ok[0] = ((adjacent && l1 < BIGI) || (!adjacent && legal1 && p2 < 3)) && !both_open;
    ok[1] = ((adjacent && l2 < BIGI) || (!adjacent && legal2 && p1 < 3)) && !both_open;
    vals[0] = l1;
    vals[1] = l2;
    const int kh = (ok[0] ? 1 : 0) + (ok[1] ? 1 : 0);
    if (both_open || kh == 0) s.term = PREY_GOOD;
    else s.term = UNDECIDED;
  }
  // the first valid slot, then the rest in slot order (unrolled: no
  // array indexed at run time, so nothing goes to local memory)
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (!ok[i]) continue;
    if (s.k == 0) s.first_v = vals[i];
#pragma unroll
    for (int a = 0; a < MAX_ALTS; ++a)
      if (s.k == a + 1) s.alts[a] = vals[i];
    ++s.k;
  }
  return s;
}

// Loads this thread's rows of the lane and floods the prey from its
// vertex; returns the on-board row mask. `xs` is the warp's exchange rows.
__device__ __forceinline__ unsigned load_lane(Row& g, int lane, int n, unsigned* xs,
                                              const int* own_w, const int* opp_w,
                                              const int* size, int prey_v,
                                              unsigned* own, unsigned* opp,
                                              unsigned* prey) {
  g.r = threadIdx.x % 32;
  g.n = n;
  g.inv_n = (unsigned)((0x100000000ull + n - 1) / n);
  g.xs = xs;
  g.buf = 0;
  clear_edges(g);
  const int sz = size[lane];
  g.colmask = (1u << sz) - 1u;
  const unsigned full = g.r < sz ? g.colmask : 0u;
  *own = (unsigned)own_w[(long)lane * ROWS + g.r] & full;
  *opp = (unsigned)opp_w[(long)lane * ROWS + g.r] & full;
  unsigned x[1], nb[1], unused[4];
  vertex_seeds(g, prey_v, &x[0], unused);
  floods(g, x, {*own}, nb);
  *prey = x[0];
  return full;
}

__global__ void __launch_bounds__(WARPS * 32)
greedy_kernel(const int* __restrict__ own_w, const int* __restrict__ opp_w,
              const int* __restrict__ size, const int* __restrict__ ko,
              const int* __restrict__ prey_v, const int* __restrict__ first_v,
              const int* __restrict__ valid, int* result, int* forked, int L,
              int n, int node_cap) {
  __shared__ unsigned xs[WARPS][XS_WORDS];
  const int lane = blockIdx.x * WARPS + threadIdx.x / 32;
  if (lane >= L) return;
  const bool lead = threadIdx.x % 32 == 0;
  if (valid[lane] <= 0) {
    if (lead) {
      result[lane] = PREY_GOOD;
      forked[lane] = 0;
    }
    return;
  }
  Row g;
  unsigned own, opp, prey;
  const unsigned full = load_lane(g, lane, n, xs[threadIdx.x / 32], own_w, opp_w,
                                  size, prey_v[lane], &own, &opp, &prey);
  int k = ko[lane], pend_v = first_v[lane];
  bool pend_prey = false;
  int res = UNDECIDED, fk = 0;
  // follow the first selection; the step that ends the lane sets the
  // result and leaves the boards alone
  for (int it = 0, nodes = 0; it < node_cap + 8; ++it) {
    ++nodes;
    const Sel s = step_select(g, full, own, opp, prey, k, pend_v, pend_prey);
    const bool freeze = nodes >= node_cap;
    if (freeze || s.term != UNDECIDED) {
      res = freeze ? PREY_GOOD : s.term;
      break;
    }
    if (s.k >= 2) fk = 1;
    own = s.own1;
    opp = s.opp1;
    prey = s.prey1;
    k = s.ko1;
    pend_v = s.first_v;
    pend_prey = s.selector_prey;
  }
  if (lead) {
    result[lane] = res == UNDECIDED ? PREY_GOOD : res;
    forked[lane] = fk;
  }
}

// scalars of one fork-stack frame
struct Frame {
  int ko, cnt, idx, side;
  int alts[MAX_ALTS];
};

__global__ void __launch_bounds__(WARPS * 32)
chase_kernel(const int* __restrict__ own_w, const int* __restrict__ opp_w,
             const int* __restrict__ size, const int* __restrict__ ko,
             const int* __restrict__ prey_v, const int* __restrict__ first_v,
             const int* __restrict__ valid, int* result, int L, int n,
             int node_cap, int max_forks) {
  __shared__ Frame frames[WARPS][MAX_FORKS];
  __shared__ unsigned xs[WARPS][XS_WORDS];
  const int lane = blockIdx.x * WARPS + threadIdx.x / 32;
  if (lane >= L) return;
  const bool lead = threadIdx.x % 32 == 0;
  if (valid[lane] <= 0) {
    if (lead) result[lane] = PREY_GOOD;
    return;
  }
  Frame* st = frames[threadIdx.x / 32];
  // this thread's rows of each frame: the boards and the prey's chain
  unsigned st_own[MAX_FORKS], st_opp[MAX_FORKS], st_prey[MAX_FORKS];

  Row g;
  unsigned own, opp, prey;
  const unsigned full = load_lane(g, lane, n, xs[threadIdx.x / 32], own_w, opp_w,
                                  size, prey_v[lane], &own, &opp, &prey);
  int k = ko[lane], pend_v = first_v[lane];
  bool pend_prey = false, descend = true;
  int ret = UNDECIDED, res = UNDECIDED, sp = 0, nodes = 0;
  for (int it = 0; it < 2 * node_cap + 16; ++it) {
    if (descend) {
      // apply the pending move and select; push a frame at a fork
      ++nodes;
      const Sel s = step_select(g, full, own, opp, prey, k, pend_v, pend_prey);
      const bool is_term = s.term != UNDECIDED;
      const bool push = !is_term && s.k >= 2;
      if (nodes >= node_cap || (push && sp >= max_forks)) {
        res = PREY_GOOD;   // budget or stack exhausted
        break;
      }
      if (push) {
        st_own[sp] = s.own1;
        st_opp[sp] = s.opp1;
        st_prey[sp] = s.prey1;
        if (lead) {
          st[sp].ko = s.ko1;
          st[sp].cnt = s.k - 1;
          st[sp].idx = 0;
          st[sp].side = s.selector_prey;
          for (int a = 0; a < MAX_ALTS; ++a) st[sp].alts[a] = s.alts[a];
        }
        __syncwarp();
        ++sp;
      }
      own = s.own1;
      opp = s.opp1;
      prey = s.prey1;
      k = s.ko1;
      if (is_term) {
        descend = false;
        ret = s.term;
      } else {
        pend_v = s.first_v;
        pend_prey = s.selector_prey;
      }
    } else {
      // propagate a subtree result: the frame's side has won, or its
      // alternatives are spent (pop), or try its next alternative from the
      // frame's boards and prey
      if (sp <= 0) {
        res = ret;
        break;
      }
      const int top = sp - 1;
      const bool side = st[top].side != 0;
      const int cnt = st[top].cnt, idx = st[top].idx;
      if ((side ? ret == PREY_GOOD : ret == HUNTER_GOOD) || idx >= cnt) {
        sp = top;
      } else {
        own = st_own[top];
        opp = st_opp[top];
        prey = st_prey[top];
        k = st[top].ko;
        pend_v = st[top].alts[idx];
        pend_prey = side;
        __syncwarp();
        if (lead) st[top].idx = idx + 1;
        __syncwarp();
        descend = true;
      }
    }
  }
  if (lead) result[lane] = res == UNDECIDED ? PREY_GOOD : res;
}

inline int lane_blocks(int L) { return (L + WARPS - 1) / WARPS; }

}  // namespace

extern "C" int launch_greedy(const void* own, const void* opp, const void* size,
                             const void* ko, const void* prey_v,
                             const void* first_v, const void* valid,
                             void* result, void* forked, int L, int n,
                             int node_cap, void* stream) {
  if (n < 2 || n >= ROWS || L <= 0) return (int)cudaErrorInvalidValue;
  greedy_kernel<<<lane_blocks(L), WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)own, (const int*)opp, (const int*)size, (const int*)ko,
      (const int*)prey_v, (const int*)first_v, (const int*)valid, (int*)result,
      (int*)forked, L, n, node_cap);
  return (int)cudaGetLastError();
}

extern "C" int launch_chases(const void* own, const void* opp, const void* size,
                             const void* ko, const void* prey_v,
                             const void* first_v, const void* valid,
                             void* result, int L, int n, int node_cap,
                             int max_forks, void* stream) {
  if (n < 2 || n >= ROWS || L <= 0 || max_forks < 0 || max_forks > MAX_FORKS)
    return (int)cudaErrorInvalidValue;
  chase_kernel<<<lane_blocks(L), WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)own, (const int*)opp, (const int*)size, (const int*)ko,
      (const int*)prey_v, (const int*)first_v, (const int*)valid, (int*)result,
      L, n, node_cap, max_forks);
  return (int)cudaGetLastError();
}
