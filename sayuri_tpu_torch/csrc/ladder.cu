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
// 8) but the latency of serial plies. A chase is a chain of dependent plies;
// a ply runs a few dozen chain floods, and a flood is a loop of dependent
// neighbour steps until the chain stops growing. The design answers that
// with:
//   - one warp per lane, thread r holding row r of the own (prey colour),
//     opponent and prey boards. A neighbour step is two shifts and two
//     shuffles, a flood iteration ends on one __all_sync, and a popcount or
//     a lowest vertex is one warp reduction: no shared memory and no block
//     barrier on the hot path.
//   - per-lane loops: a lane stops at its own terminal instead of waiting,
//     as the TPU's lockstep lanes did, for the slowest lane of its chunk.
//     The lockstep iteration caps become per-lane caps, which is the same
//     thing: every active lane advanced one step per lockstep iteration.
//   - only the selecting side's selections are computed at each ply.
//   - the fork stack's board rows live in per-thread local arrays indexed by
//     the stack pointer (local memory is sized by resident threads, not by
//     launched lanes); its scalars sit in shared memory, one stack per warp.
//   - lanes that are not valid exit at once, so the grid covers every lane
//     and the caller needs no host-side compaction.
//
// Semantics follow sayuri_tpu/ops/ladder_kernel.py step for step, including
// its per-lane limits: node_cap descents, max_forks frames, MAX_ALTS stored
// alternatives; hitting a limit reads as PREY_GOOD.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;
constexpr int MAX_FORKS = 56;
constexpr int MAX_ALTS = 4;
constexpr int BIGI = 1000000000;
constexpr int UNDECIDED = 0, PREY_GOOD = 1, HUNTER_GOOD = 2;
constexpr unsigned ALL = 0xffffffffu;
constexpr int WARPS = 4;          // lanes per block, one warp each

// This thread's view of its lane.
struct Row {
  int r;              // the row this thread holds
  int n;              // buffer width: flat vertex = row * n + column
  unsigned colmask;   // columns < the lane's board size
};

// row r <- row r-1 / row r+1, zero past the edge
__device__ __forceinline__ unsigned from_above(const Row& g, unsigned b) {
  unsigned v = __shfl_up_sync(ALL, b, 1);
  return g.r == 0 ? 0u : v;
}

__device__ __forceinline__ unsigned from_below(const Row& g, unsigned b) {
  unsigned v = __shfl_down_sync(ALL, b, 1);
  return g.r == ROWS - 1 ? 0u : v;
}

// OR of the 4 neighbours (the cell itself excluded)
__device__ __forceinline__ unsigned nbr(const Row& g, unsigned b) {
  return ((b << 1) & g.colmask) | (b >> 1) | from_above(g, b) | from_below(g, b);
}

__device__ __forceinline__ int wpop(unsigned b) {
  return (int)__reduce_add_sync(ALL, (unsigned)__popc(b));
}

__device__ __forceinline__ bool wany(unsigned b) { return __any_sync(ALL, b != 0u); }

// smallest flat vertex set on the board, BIGI when it is empty
__device__ __forceinline__ int lowest(const Row& g, unsigned b) {
  unsigned v = b ? (unsigned)(g.r * g.n + __ffs(b) - 1) : (unsigned)BIGI;
  return (int)__reduce_min_sync(ALL, v);
}

// one-hot board of vertex v; v < 0 or v >= n*n gives the empty board
__device__ __forceinline__ unsigned vbit(const Row& g, int v) {
  if (v < 0 || v >= g.n * g.n) return 0u;
  int r = v / g.n;
  return g.r == r ? 1u << (v - r * g.n) : 0u;
}

// grow seed within allowed until the warp's board stops growing
__device__ unsigned flood(const Row& g, unsigned seed, unsigned allowed) {
  unsigned x = seed & allowed;
  while (true) {
    unsigned x2 = (x | nbr(g, x)) & allowed;
    if (__all_sync(ALL, x2 == x)) return x;
    x = x2;
  }
}

// the 4 single-bit neighbours of a one-hot board (E, W, S, N)
__device__ __forceinline__ void dir_seeds(const Row& g, unsigned bit, unsigned* s) {
  s[0] = (bit << 1) & g.colmask;
  s[1] = bit >> 1;
  s[2] = from_above(g, bit);
  s[3] = from_below(g, bit);
}

// Liberty/atari facts of the <= 4 own and <= 4 opp chains next to a vertex
// (_chain_queries, GetLadderLiberties semantics).
struct Query {
  int conn, maxconn, ncaps, potential;
  bool own_safe, own_atari, opp_safe;
};

__device__ Query chain_queries(const Row& g, unsigned vb, unsigned own,
                               unsigned opp, unsigned empty) {
  Query q = {0, 0, 0, 0, false, false, false};
  unsigned seeds[4];
  dir_seeds(g, vb, seeds);
  unsigned own_prev = 0u, opp_prev = 0u;
  for (int d = 0; d < 4; ++d) {
    // a chain already met in an earlier direction adds nothing
    unsigned so = seeds[d] & own;
    if (wany(so) && !wany(so & own_prev)) {
      unsigned ch = flood(g, so, own);
      int libs = wpop(nbr(g, ch) & empty);
      q.conn += libs - 1;
      q.maxconn = max(q.maxconn, libs - 1);
      q.own_safe |= libs >= 2;
      q.own_atari |= libs == 1;
      own_prev |= ch;
    }
    unsigned sp = seeds[d] & opp;
    if (wany(sp) && !wany(sp & opp_prev)) {
      unsigned ch = flood(g, sp, opp);
      int libs = wpop(nbr(g, ch) & empty);
      if (libs == 1) {
        q.ncaps += 1;
        q.potential += wpop(ch);
      }
      q.opp_safe |= libs >= 2;
      opp_prev |= ch;
    }
  }
  return q;
}

// union of the `stones` chains next to `bit` with exactly one liberty
__device__ unsigned atari_union(const Row& g, unsigned bit, unsigned stones,
                                unsigned empty) {
  unsigned seeds[4];
  dir_seeds(g, bit, seeds);
  unsigned prev = 0u, uni = 0u;
  for (int d = 0; d < 4; ++d) {
    unsigned s = seeds[d] & stones;
    if (wany(s) && !wany(s & prev)) {
      unsigned ch = flood(g, s, stones);
      if (wpop(nbr(g, ch) & empty) == 1) uni |= ch;
      prev |= ch;
    }
  }
  return uni;
}

// Play `bit` for the mover (_place_stone): captures, and the simple ko when
// one stone was taken by a lone stone left with exactly one liberty.
__device__ void place_stone(const Row& g, unsigned bit, unsigned mover,
                            unsigned other, unsigned empty, unsigned* mover2,
                            unsigned* other2, int* ko) {
  unsigned captured = atari_union(g, bit, other, empty);
  *mover2 = mover | bit;
  *other2 = other & ~captured;
  unsigned empty2 = (empty & ~bit) | (captured & ~bit);
  int ncap = wpop(captured);
  bool single = wpop(bit & nbr(g, *mover2 & ~bit)) == 0;
  int mlibs = wpop(nbr(g, bit) & empty2);
  *ko = (ncap == 1 && single && mlibs == 1) ? lowest(g, captured) : -1;
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
// selections and terminal test (PreySelections / HunterSelections).
__device__ Sel step_select(const Row& g, unsigned full, unsigned own,
                           unsigned opp, unsigned prey, int ko, int pend_v,
                           bool pend_prey) {
  Sel s;
  const bool has_move = pend_v >= 0;
  s.own1 = own;
  s.opp1 = opp;
  s.ko1 = ko;
  if (has_move) {
    unsigned mover2, other2;
    int ko_new;
    place_stone(g, vbit(g, pend_v), pend_prey ? own : opp, pend_prey ? opp : own,
                full & ~own & ~opp, &mover2, &other2, &ko_new);
    s.own1 = pend_prey ? mover2 : other2;
    s.opp1 = pend_prey ? other2 : mover2;
    s.ko1 = ko_new;
  }
  s.prey1 = flood(g, prey & s.own1, s.own1);
  const unsigned empty1 = full & ~s.own1 & ~s.opp1;
  s.selector_prey = !pend_prey;   // the prey answers a hunter move
  const bool think_ko = has_move && s.selector_prey;

  const unsigned prey_libs = nbr(g, s.prey1) & empty1;
  const int nlibs = wpop(prey_libs);
  const int l1 = lowest(g, prey_libs);
  const unsigned l1bit = vbit(g, l1);
  const int l2 = lowest(g, prey_libs & ~l1bit);
  const unsigned l2bit = vbit(g, l2);
  const Query q1 = chain_queries(g, l1bit, s.own1, s.opp1, empty1);
  const int p1 = wpop(nbr(g, l1bit) & empty1);

  bool ok[5] = {false, false, false, false, false};
  int vals[5] = {0, 0, 0, 0, 0};
  if (s.selector_prey) {
    // ---- PreySelections (board.cc:519-573) ----
    const bool escape = nlibs == 1 && l1 != s.ko1 &&
                        (p1 > 0 || q1.own_safe || q1.ncaps > 0);
    // capture moves: peel <= 4 hunter chains next to the prey in lowest
    // vertex order, after dropping every chain that holds a stone with two
    // empty neighbours (it has >= 2 liberties)
    const unsigned e_e = (empty1 << 1) & g.colmask, e_w = empty1 >> 1;
    const unsigned e_s = from_above(g, empty1), e_n = from_below(g, empty1);
    const unsigned two = (e_e & e_w) | (e_e & e_s) | (e_e & e_n) |
                         (e_w & e_s) | (e_w & e_n) | (e_s & e_n);
    const unsigned not_atari = flood(g, two & s.opp1, s.opp1);
    unsigned a = nbr(g, s.prey1) & s.opp1 & ~not_atari;
    int cap[4] = {BIGI, BIGI, BIGI, BIGI};
    for (int i = 0; i < 4; ++i) {
      const int v0 = lowest(g, a);
      if (v0 >= BIGI) break;   // nothing left to peel
      const unsigned ch = flood(g, vbit(g, v0), s.opp1);
      const unsigned lm = nbr(g, ch) & empty1;
      if (wpop(lm) == 1) cap[i] = lowest(g, lm);
      a &= ~ch;
    }
    ok[0] = escape;
    vals[0] = escape ? l1 : BIGI;
    int kp = escape ? 1 : 0;
    for (int i = 0; i < 4; ++i) {
      bool dup = cap[i] == l1;
      for (int j = 0; j < i; ++j) dup |= cap[i] == cap[j];
      ok[i + 1] = cap[i] < BIGI && cap[i] != s.ko1 && !dup;
      vals[i + 1] = cap[i];
      kp += ok[i + 1] ? 1 : 0;
    }
    const int lower = q1.ncaps + max(p1, q1.maxconn);
    const int upper = p1 + q1.potential + q1.conn;
    if (nlibs >= 2 || (think_ko && s.ko1 >= 0)) s.term = PREY_GOOD;
    else if (kp == 0) s.term = HUNTER_GOOD;
    else if (escape && lower >= 3) s.term = PREY_GOOD;
    else if (escape && kp == 1 && upper == 1) s.term = HUNTER_GOOD;
    else s.term = UNDECIDED;
  } else {
    // ---- HunterSelections (board.cc:575-644) ----
    const Query q2 = chain_queries(g, l2bit, s.own1, s.opp1, empty1);
    const int p2 = wpop(nbr(g, l2bit) & empty1);
    const bool adjacent = wany(nbr(g, l1bit) & l2bit);
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
    if (nlibs >= 3) s.term = PREY_GOOD;
    else if (nlibs <= 1) s.term = HUNTER_GOOD;
    else if (both_open || kh == 0) s.term = PREY_GOOD;
    else s.term = UNDECIDED;
  }
  // the first valid slot, then the rest in slot order
  s.first_v = -1;
  s.k = 0;
  for (int a = 0; a < MAX_ALTS; ++a) s.alts[a] = -1;
  for (int i = 0; i < 5; ++i) {
    if (!ok[i]) continue;
    if (s.k == 0) s.first_v = vals[i];
    else s.alts[s.k - 1] = vals[i];
    ++s.k;
  }
  return s;
}

// Loads this thread's rows of the lane; returns the on-board row mask.
__device__ __forceinline__ unsigned load_lane(Row& g, int lane, int n,
                                              const int* own_w, const int* opp_w,
                                              const int* size, unsigned* own,
                                              unsigned* opp) {
  g.r = threadIdx.x % 32;
  g.n = n;
  const int sz = size[lane];
  g.colmask = (1u << sz) - 1u;
  const unsigned full = g.r < sz ? g.colmask : 0u;
  *own = (unsigned)own_w[(long)lane * ROWS + g.r] & full;
  *opp = (unsigned)opp_w[(long)lane * ROWS + g.r] & full;
  return full;
}

__global__ void __launch_bounds__(WARPS * 32)
greedy_kernel(const int* __restrict__ own_w, const int* __restrict__ opp_w,
              const int* __restrict__ size, const int* __restrict__ ko,
              const int* __restrict__ prey_v, const int* __restrict__ first_v,
              const int* __restrict__ valid, int* result, int* forked, int L,
              int n, int node_cap) {
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
  unsigned own, opp;
  const unsigned full = load_lane(g, lane, n, own_w, opp_w, size, &own, &opp);
  unsigned prey = flood(g, vbit(g, prey_v[lane]), own);
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
  const int lane = blockIdx.x * WARPS + threadIdx.x / 32;
  if (lane >= L) return;
  const bool lead = threadIdx.x % 32 == 0;
  if (valid[lane] <= 0) {
    if (lead) result[lane] = PREY_GOOD;
    return;
  }
  Frame* st = frames[threadIdx.x / 32];
  unsigned st_own[MAX_FORKS], st_opp[MAX_FORKS];   // this thread's rows

  Row g;
  unsigned own, opp;
  const unsigned full = load_lane(g, lane, n, own_w, opp_w, size, &own, &opp);
  const unsigned prey_bit = vbit(g, prey_v[lane]);
  unsigned prey = flood(g, prey_bit, own);
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
      // alternatives are spent (pop), or try its next alternative
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
        prey = flood(g, prey_bit, own);
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
