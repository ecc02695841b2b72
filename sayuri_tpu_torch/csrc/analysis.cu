// Board step + analysis kernels for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels of sayuri_tpu/ops/analysis.py:
//   step_analysis_kernel  <- _step_analysis_kernel (entry step_and_analyze_tpu)
//   board_analysis_kernel <- _analysis_kernel      (entry board_analysis_tpu)
// Both share one __device__ routine, analyze_board(), as the Pallas pair
// shares _analyze_board.
//
// What bounds it on this card: not bytes (a board is 361 bytes in and a few
// KB out) but the latency of serial, data-dependent fixpoint sweeps: chain
// and region labelling, floods and the Benson iteration, each a loop of
// dependent shared-memory passes with a block-wide barrier per pass. The
// design answers that with:
//   - one thread block per board and one thread per cell, the whole board
//     and every scratch map in shared memory, so a sweep is one pass over
//     shared memory plus one __syncthreads_or;
//   - in-place (chaotic) relaxation with pointer jumping for labels, so a
//     sweep propagates a label many cells at once and the loop ends after
//     the first pass in which no thread changed anything;
//   - integer labels (min flat index) and shared-memory atomics for all
//     per-chain / per-region aggregates instead of the TPU kernel's float
//     encodings and k-th-minimum propagations;
//   - many boards in flight (B blocks, several resident per SM) to hide the
//     barrier latency of each one.
//
// Semantics follow sayuri_tpu/game/board.py and game/analysis.py cell for
// cell, including liberty counts capped at 5 and the inner-region eye
// refinement with at most INNER_SLOTS regions per board (overflow falls
// back to the unrefined eye).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXNN = 384;        // 19*19 = 361 cells, rounded up to warps
constexpr int BIG = 0x3fffffff;   // "no label" / "no cell"
constexpr int NUM_LIBS = 5;
constexpr int INNER_SLOTS = 6;

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

// Shared scratch for one board. All per-root arrays are indexed by the
// root's flat cell index.
struct Smem {
  int8_t st[MAXNN];          // stones 0/1/2
  uint8_t msk[MAXNN];        // on-board
  uint8_t fa[MAXNN];         // flag maps (floods, masks)
  uint8_t fb[MAXNN];
  uint8_t fc[MAXNN];
  uint8_t fd[MAXNN];
  uint8_t pa[2][MAXNN];      // pass-alive area per colour
  int lbl_s[MAXNN];          // stone chains (same colour), BIG off-chain
  int lbl_r[MAXNN];          // Benson regions
  int lbl_r2[MAXNN];         // pass-dead regions
  int lbl_f[MAXNN];          // scratch labels (floods)
  int libcnt[MAXNN];         // liberties per chain root
  int nbrA[4][MAXNN];        // deduped own chains next to each empty cell
  int cand[4][MAXNN];        // candidate vital chain per region root / slot
  int ra[MAXNN];             // per-root scratch aggregates
  int rb[MAXNN];
  int rc[MAXNN];
  int rd[MAXNN];
  int slots[INNER_SLOTS];
  int scal[4];
};

// ---------------------------------------------------------------------------
// fixpoint primitives (every thread of the block must call them)
// ---------------------------------------------------------------------------

// Label the 4-connected components of cells whose class `cls` is non-zero,
// connecting only neighbours of equal class (a 0/1 mask is one class);
// label = min flat index, BIG off-component. In-place relaxation with pointer jumping: values only
// decrease and always name a cell of the same component, so any
// interleaving converges, and a pass with no write is a true fixpoint.
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

// out = cells of `allowed` connected within `allowed` to a cell of `seed`.
// seed/allowed are read for this thread's cell; `out` must differ from the
// arrays the caller passes for other purposes.
__device__ void flood(const Geo& g, Smem& s, bool seed, bool allowed,
                      volatile uint8_t* out) {
  volatile int* lbl = s.lbl_f;
  volatile int* hit = s.rd;
  if (g.cell) {
    out[g.t] = allowed;
    hit[g.t] = 0;
  }
  __syncthreads();
  label_by_class(g, out, lbl);
  if (g.cell && seed && allowed) hit[lbl[g.t]] = 1;
  __syncthreads();
  bool r = g.cell && allowed && hit[lbl[g.t]];
  __syncthreads();
  if (g.cell) out[g.t] = r;
  __syncthreads();
}

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

// ---------------------------------------------------------------------------
// Benson pass-alive area of `color` (game/analysis.py pass_alive_area).
// Needs s.st, s.msk and s.lbl_s (same-colour chain labels). Writes s.pa[color].
// ---------------------------------------------------------------------------
__device__ void pass_alive(const Geo& g, Smem& s, int color) {
  const int t = g.t;
  const int8_t own_c = (int8_t)(color + 1), opp_c = (int8_t)(2 - color);
  const bool m = g.cell && s.msk[t];
  const bool own = m && s.st[t] == own_c;
  const bool other = m && !own;
  const bool empty = m && s.st[t] == 0;
  const bool opp = m && s.st[t] == opp_c;
  volatile uint8_t* fa = s.fa;   // own cells
  volatile uint8_t* fb = s.fb;   // other cells
  volatile int* lbl_r = s.lbl_r;
  volatile int* lbl_s = s.lbl_s;
  volatile int* bad = s.ra;      // region: not potential
  volatile int* rempty = s.rb;   // region: min empty cell
  volatile int* nm = s.rc;       // region: bit k = slot k not vital

  if (g.cell) {
    fa[t] = own;
    fb[t] = other;
    bad[t] = 0;
    rempty[t] = BIG;
    nm[t] = 0;
  }
  __syncthreads();
  label_by_class(g, fb, lbl_r);
  const int my_r = other ? lbl_r[t] : -1;
  const int my_c = own ? lbl_s[t] : -1;

  // potential vitality + min empty per region
  if (other) {
    if (empty && nbr_count(g, fa) == 0) atomicOr((int*)&bad[my_r], 1);
    if (empty) atomicMin((int*)&rempty[my_r], t);
  }
  // deduped own chains adjacent to each empty cell (up, down, left, right)
  int a[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    int q = g.nb[d];
    int l = (empty && q >= 0 && fa[q]) ? lbl_s[q] : -1;
    for (int e = 0; e < d; ++e)
      if (a[e] == l) l = -1;
    a[d] = l;
    if (g.cell) s.nbrA[d][t] = l;
  }
  __syncthreads();
  // candidate vital chains per region root
  const bool is_rroot = other && my_r == t;
  if (is_rroot) {
    int re = rempty[t];
#pragma unroll
    for (int k = 0; k < 4; ++k) s.cand[k][t] = re < g.nn ? s.nbrA[k][re] : -1;
  }
  __syncthreads();
  // slot k is not vital if some empty cell of the region is not adjacent to
  // that slot's chain
  if (empty) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int c = s.cand[k][my_r];
      bool member = c >= 0 && (a[0] == c || a[1] == c || a[2] == c || a[3] == c);
      if (!member) atomicOr((int*)&nm[my_r], 1 << k);
    }
  }
  __syncthreads();
  int vital_bits = 0;     // valid at region roots
  bool potential = false;
  if (is_rroot) {
    potential = !bad[t];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (potential && s.cand[k][t] >= 0 && !((nm[t] >> k) & 1))
        vital_bits |= 1 << k;
  }
  __syncthreads();

  // Benson iteration over per-chain alive bits
  volatile int* alive = s.ra;     // chain root: alive
  volatile int* unusable = s.rb;  // region root
  volatile int* count = s.rc;     // chain root
  if (g.cell) alive[t] = 1;
  bool changed = true;
  while (__syncthreads_or(changed)) {
    changed = false;
    if (g.cell) {
      unusable[t] = 0;
      count[t] = 0;
    }
    __syncthreads();
    if (other) {
      bool dead_adj = false;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        int q = g.nb[d];
        if (q >= 0 && fa[q] && !alive[lbl_s[q]]) dead_adj = true;
      }
      if (dead_adj) unusable[my_r] = 1;
    }
    __syncthreads();
    if (is_rroot && !unusable[t]) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if ((vital_bits >> k) & 1) atomicAdd((int*)&count[s.cand[k][t]], 1);
    }
    __syncthreads();
    if (own && my_c == t && alive[t] && count[t] < 2) {
      alive[t] = 0;
      changed = true;
    }
  }
  // `unusable` is consistent with the final alive set: the last pass made
  // no change
  const bool alive_cell = own && alive[my_c];
  __syncthreads();
  // vital regions (potential & usable) per root -> spread to cells
  volatile int* potr = s.rd;
  if (g.cell) potr[t] = 0;
  __syncthreads();
  if (is_rroot) potr[t] = potential && !unusable[t];
  __syncthreads();
  const bool vcell = other && potr[my_r];
  const bool blocker = alive_cell || vcell;
  __syncthreads();

  // pass-dead opponent regions
  volatile uint8_t* fblk = s.fc;   // blockers
  volatile uint8_t* fo2 = s.fd;    // others2
  if (g.cell) {
    fblk[t] = blocker;
    fo2[t] = m && !blocker;
  }
  __syncthreads();
  volatile int* lbl_r2 = s.lbl_r2;
  label_by_class(g, fo2, lbl_r2);
  const bool o2 = m && !blocker;
  const int my_r2 = o2 ? lbl_r2[t] : -1;

  const bool no_c_side = nbr_count(g, fblk) == 0;
  const int corner_c = diag_count(g, fblk);
  const bool interior = diag_count(g, s.msk) == 4;
  const bool corner_ok = interior ? corner_c <= 1 : corner_c == 0;
  const bool cand_eye = o2 && !opp && no_c_side;
  bool is_eye = cand_eye && corner_ok;
  // edge: on-board cell with a side neighbour off the board
  bool edge = false;
  if (m) {
#pragma unroll
    for (int d = 0; d < 4; ++d)
      if (g.nb[d] < 0 || !s.msk[g.nb[d]]) edge = true;
  }

  // inner-region refinement (false-eye life / two-headed dragons)
  const bool pre = cand_eye && !corner_ok;
  if (__syncthreads_or(pre)) {
    volatile uint8_t* fbor = s.fa;   // own flags are no longer needed
    flood(g, s, blocker && edge, blocker, fbor);
    volatile uint8_t* fmaybe = s.fb;
    if (g.cell) fmaybe[t] = blocker && !fbor[t];
    __syncthreads();
    const int corner_maybe = diag_count(g, fmaybe);
    const bool resc = pre && (interior ? corner_c - corner_maybe <= 1
                                       : corner_c == corner_maybe);
    volatile int* need = s.ra;
    if (g.cell) need[t] = 0;
    __syncthreads();
    if (resc) need[my_r2] = 1;
    __syncthreads();
    if (t == 0) {
      int k = 0;
      for (int c = 0; c < g.nn && k < INNER_SLOTS; ++c)
        if (need[c]) s.slots[k++] = c;
      s.scal[0] = k;
    }
    __syncthreads();
    const int nslots = s.scal[0];
    for (int k = 0; k < nslots; ++k) {
      const int root = s.slots[k];
      const bool in_region = o2 && my_r2 == root;
      const bool allowed = m && !in_region;
      volatile uint8_t* fout = s.fa;
      flood(g, s, allowed && edge, allowed, fout);
      // inner = allowed & ~outer; corner test on blockers outside `inner`
      volatile uint8_t* fbi = s.fb;
      if (g.cell) fbi[t] = fblk[t] && !(allowed && !fout[t]);
      __syncthreads();
      const int cc = diag_count(g, fbi);
      const bool ok2 = interior ? cc <= 1 : cc == 0;
      if (cand_eye && in_region && ok2) is_eye = true;
      __syncthreads();
    }
  }

  // eye count per pass-dead region, minus one for two adjacent eyes
  volatile uint8_t* feye = s.fa;
  volatile int* ecount = s.ra;
  volatile int* eadj = s.rb;
  __syncthreads();
  if (g.cell) {
    feye[t] = is_eye;
    ecount[t] = 0;
    eadj[t] = 0;
  }
  __syncthreads();
  if (is_eye) {
    atomicAdd((int*)&ecount[my_r2], 1);
    bool adj = false;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int q = g.nb[d];
      if (q >= 0 && feye[q] && fo2[q] && lbl_r2[q] == my_r2) adj = true;
    }
    if (adj) eadj[my_r2] = 1;
  }
  __syncthreads();
  bool pass_dead = false;
  if (o2) {
    int c = ecount[my_r2];
    int eff = c - ((c == 2 && eadj[my_r2]) ? 1 : 0);
    pass_dead = eff < 2;
  }
  if (g.cell) s.pa[color][t] = alive_cell || vcell || pass_dead;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Analysis of the board in s.st with side to move `tm` and ko vertex `ko`
// (ops/analysis.py _analyze_board semantics). Writes this thread's cell of
// every output.
// ---------------------------------------------------------------------------
__device__ void analyze_board(const Geo& g, Smem& s, int tm, int ko,
                              bool* legal, int* libs, int* own_out,
                              bool* safe, int* sown) {
  const int t = g.t;
  const bool m = g.cell && s.msk[t];
  const int8_t v = g.cell ? s.st[t] : 0;
  const bool empty = m && v == 0;
  const bool black = m && v == 1;
  const bool white = m && v == 2;

  // chain labels of both colours at once (class = stone colour on board)
  volatile uint8_t* cls = s.fa;
  if (g.cell) {
    cls[t] = m ? (uint8_t)v : 0;
    s.libcnt[t] = 0;
  }
  __syncthreads();
  label_by_class(g, cls, s.lbl_s);
  volatile int* lbl = s.lbl_s;

  // exact liberties: every empty cell adds one to each distinct adjacent chain
  if (empty) {
    int seen[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int q = g.nb[d];
      int l = (q >= 0 && cls[q]) ? lbl[q] : -1;
      for (int e = 0; e < d; ++e)
        if (seen[e] == l) l = -1;
      seen[d] = l;
      if (l >= 0) atomicAdd(&s.libcnt[l], 1);
    }
  }
  __syncthreads();
  const int my_libs = (black || white) ? min(s.libcnt[lbl[t]], NUM_LIBS) : 0;

  // legality: empty & not ko & (empty nbr | own chain >= 2 libs | opp in atari)
  bool ok = false;
  const uint8_t own_c = (uint8_t)(tm + 1), opp_c = (uint8_t)(2 - tm);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    int q = g.nb[d];
    if (q < 0 || !s.msk[q]) continue;
    uint8_t c = cls[q];
    if (c == 0) ok = true;
    else {
      int lq = min(s.libcnt[lbl[q]], NUM_LIBS);
      if (c == own_c && lq >= 2) ok = true;
      if (c == opp_c && lq == 1) ok = true;
    }
  }
  const bool is_legal = empty && t != ko && ok;

  // Tromp-Taylor reach ownership: both colours' floods through empties
  volatile uint8_t* fb = s.fb;
  volatile uint8_t* fcb = s.fc;
  if (g.cell) fb[t] = black;
  if (g.cell) fcb[t] = white;
  __syncthreads();
  const bool seed_b = empty && nbr_count(g, fb) > 0;
  const bool seed_w = empty && nbr_count(g, fcb) > 0;
  __syncthreads();
  volatile uint8_t* rb = s.fd;
  flood(g, s, seed_b, empty, rb);
  const bool reach_b = g.cell && rb[t];
  __syncthreads();
  flood(g, s, seed_w, empty, rb);
  const bool reach_w = g.cell && rb[t];
  const int own = (black ? 1 : 0) - (white ? 1 : 0) +
                  ((reach_b && !reach_w) ? 1 : 0) - ((reach_w && !reach_b) ? 1 : 0);
  __syncthreads();

  // Benson for both colours (labels of stone chains stay in s.lbl_s)
  pass_alive(g, s, 0);
  pass_alive(g, s, 1);

  if (g.cell) {
    const bool pb = s.pa[0][t], pw = s.pa[1][t];
    legal[t] = is_legal;
    libs[t] = my_libs;
    own_out[t] = own;
    safe[t] = pb || pw;
    sown[t] = pw ? -1 : (pb ? 1 : own);
  }
}

__device__ __forceinline__ void load_board(const Geo& g, Smem& s,
                                           const int8_t* stones, int size) {
  if (g.cell) {
    s.st[g.t] = stones[g.t];
    s.msk[g.t] = (g.y < size && g.x < size) ? 1 : 0;
  }
  __syncthreads();
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
  load_board(g, s, stones + off, size[b]);
  analyze_board(g, s, to_move[b], ko[b], legal + off, libs + off, own + off,
                safe + off, sown + off);
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
  const int t = g.t;
  const long b = blockIdx.x;
  const long off = b * g.nn;
  load_board(g, s, stones + off, size[b]);

  // ---- play the move (board.py play_move semantics) ----
  const int tm = to_move[b];
  const int v = action[b];
  const bool is_pass = v >= g.nn || v < 0;
  const int8_t own_c = (int8_t)(tm + 1), opp_c = (int8_t)(2 - tm);
  if (!is_pass && t == v && s.msk[t]) s.st[t] = own_c;
  volatile uint8_t* cls = s.fa;
  volatile int* haslib = s.ra;
  volatile int* capv = s.rb;
  if (g.cell) {
    cls[t] = (s.msk[t] && s.st[t] == opp_c) ? 1 : 0;
    haslib[t] = 0;
  }
  if (t == 0) capv[0] = BIG;
  __syncthreads();
  label_by_class(g, cls, s.lbl_s);
  const bool opp1 = g.cell && cls[t];
  if (opp1) {
    bool lib = false;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int q = g.nb[d];
      if (q >= 0 && s.msk[q] && s.st[q] == 0) lib = true;
    }
    if (lib) haslib[s.lbl_s[t]] = 1;
  }
  __syncthreads();
  const bool captured = !is_pass && opp1 && !haslib[s.lbl_s[t]];
  const int n_cap = __syncthreads_count(captured);
  if (captured) {
    atomicMin((int*)&capv[0], t);
    s.st[t] = 0;
  }
  __syncthreads();
  if (!is_pass && t == v) {
    int own_nb = 0, lib_nb = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int q = g.nb[d];
      if (q < 0 || !s.msk[q]) continue;
      own_nb += s.st[q] == own_c;
      lib_nb += s.st[q] == 0;
    }
    s.scal[1] = (n_cap == 1 && own_nb == 0 && lib_nb == 1) ? capv[0] : -1;
  }
  if (is_pass && t == 0) s.scal[1] = -1;
  __syncthreads();
  const int ko2 = s.scal[1];
  // a pass leaves the board as loaded (nothing was placed or captured)

  // ---- Zobrist hash of the child: XOR of the per-cell keys ----
  unsigned w0 = 0, w1 = 0;
  if (g.cell) {
    int8_t c = s.st[t];
    if (c == 1) {
      w0 = (unsigned)zob[0 * g.nn + t];
      w1 = (unsigned)zob[1 * g.nn + t];
    } else if (c == 2) {
      w0 = (unsigned)zob[2 * g.nn + t];
      w1 = (unsigned)zob[3 * g.nn + t];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    w0 ^= __shfl_xor_sync(0xffffffffu, w0, o);
    w1 ^= __shfl_xor_sync(0xffffffffu, w1, o);
  }
  if (t == 0) {
    s.scal[2] = 0;
    s.scal[3] = 0;
  }
  __syncthreads();
  if ((t & 31) == 0) {
    atomicXor((unsigned*)&s.scal[2], w0);
    atomicXor((unsigned*)&s.scal[3], w1);
  }
  __syncthreads();
  if (g.cell) new_stones[off + t] = s.st[t];
  if (t == 0) {
    ncap_out[b] = is_pass ? 0 : n_cap;
    ko_out[b] = ko2;
    hash_out[2 * b] = s.scal[2];
    hash_out[2 * b + 1] = s.scal[3];
  }
  __syncthreads();

  // ---- analysis of the child, side to move flipped ----
  analyze_board(g, s, 1 - tm, ko2, legal + off, libs + off, own + off,
                safe + off, sown + off);
}

inline int threads_for(int n) { return ((n * n + 31) / 32) * 32; }

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
