// CPU stand-in for the CUDA device runtime, so that the board kernels
// (csrc/flood.cu, csrc/analysis.cu) and the ladder kernels (csrc/ladder.cu)
// compile with g++ and run on the host: the CPU tests hold them against
// their plain PyTorch versions, and the barriers each block passes and the
// warp-wide operations each warp runs are counted. nvcc never includes this file
// (ops/build.py only tracks csrc/*.cuh).
//
// Model:
//   - A launch runs its blocks one after another. Each CUDA thread of a
//     block is a fiber on the calling OS thread (ucontext starts it,
//     _setjmp/_longjmp switch between fibers).
//   - A fiber runs until it reaches a block barrier (__syncthreads*) or a
//     warp-wide operation (shuffle, vote, reduction, __syncwarp), and waits
//     there
//     until every live thread of its block (its warp) has arrived. A thread
//     that has returned counts as arrived. Each release of a warp counts
//     as one warp-wide operation of that warp: in a kernel that gives a
//     warp a serial chain of them (a ladder lane), their count stands for
//     its latency, as the barriers a board do for a board kernel.
//   - __shared__ variables are function statics: one copy, shared by the
//     fibers of the running block.
//   - Atomics are plain read-modify-writes, since one fiber runs at a time.
//     With a non-zero schedule seed, a fiber yields before an atomic with
//     probability 1/2 and the next fiber is drawn at random, so that other
//     threads' reads and atomics interleave with its lock-free updates.
//
// Use (ops/host_shim.py does all of it): compile a .cu source cut before
// its extern "C" launchers (they use <<<>>>), with an include directory
// whose cuda_runtime.h includes this file, and run kernels through
// shim::launch(grid, block, body, barriers_out, seed, warp_ops_out).

#pragma once

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <ucontext.h>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};

namespace shim {

enum State { RUN, DONE, BLOCK_OP, WARP_OP };
enum BlockRed { SYNC, OR, AND, COUNT };
enum WarpKind { SHFL_XOR, SHFL_IDX, SHFL_UP, SHFL_DOWN, BALLOT, WSYNC,
                RED_ADD, RED_MIN, RED_MAX, RED_OR };

struct Fiber {
  ucontext_t uc;
  jmp_buf jb;
  bool started;
  int state;
  int kind;             // BlockRed or WarpKind
  long long val;        // predicate or value
  int arg;              // lane mask / source lane
  long long result;
};

struct Sched {
  std::vector<Fiber> fib;
  std::vector<char*> stacks;
  std::function<void()> body;
  jmp_buf jb;
  int cur = -1;
  unsigned long long rng = 0;   // 0: no yields at atomics
};

inline Sched g;
inline dim3 thread_idx, block_idx, block_dim, grid_dim;
constexpr size_t STACK_BYTES = 128 * 1024;

inline unsigned long long next_rand() {
  g.rng ^= g.rng << 13;
  g.rng ^= g.rng >> 7;
  g.rng ^= g.rng << 17;
  return g.rng;
}

[[noreturn]] inline void fail(const char* what) {
  std::fprintf(stderr, "host_shim: %s (block %u)\n", what, block_idx.x);
  std::abort();
}

inline void fiber_main() {
  g.body();
  g.fib[g.cur].state = DONE;
  _longjmp(g.jb, 1);
}

inline void resume(int i) {
  g.cur = i;
  thread_idx.x = (unsigned)i;
  if (!_setjmp(g.jb)) {
    Fiber& f = g.fib[i];
    if (!f.started) {
      f.started = true;
      setcontext(&f.uc);
    }
    _longjmp(f.jb, 1);
  }
}

inline void yield() {
  Fiber& f = g.fib[g.cur];
  if (!_setjmp(f.jb)) _longjmp(g.jb, 1);
}

inline void maybe_yield() {
  if (g.rng && (next_rand() & 1)) yield();
}

inline long long wait(int state, int kind, long long val, int arg) {
  Fiber& f = g.fib[g.cur];
  f.state = state;
  f.kind = kind;
  f.val = val;
  f.arg = arg;
  yield();
  return f.result;
}

inline bool is_shuffle(int kind) {
  return kind == SHFL_XOR || kind == SHFL_IDX || kind == SHFL_UP || kind == SHFL_DOWN;
}

// The reduction `kind` of the values of the lanes w0..w1 waiting at it.
inline long long reduce(int kind, int w0, int w1) {
  long long r = 0;
  bool first = true;
  for (int i = w0; i < w1; ++i) {
    const Fiber& f = g.fib[i];
    if (f.state != WARP_OP) continue;
    const long long v = f.val;
    if (kind == RED_ADD) r += v;
    if (kind == RED_OR) r |= v;
    if (kind == RED_MIN) r = first || v < r ? v : r;
    if (kind == RED_MAX) r = first || v > r ? v : r;
    first = false;
  }
  return r;
}

// Releases the warps whose live lanes all wait at a warp operation;
// warp_ops[w] counts the releases of warp w (when it is not null).
inline bool release_warps(int n, long long* warp_ops) {
  bool any = false;
  for (int w0 = 0; w0 < n; w0 += 32) {
    int w1 = w0 + 32 < n ? w0 + 32 : n;
    int waiting = 0, live = 0, kind = -1;
    for (int i = w0; i < w1; ++i) {
      const Fiber& f = g.fib[i];
      if (f.state == DONE) continue;
      ++live;
      if (f.state == WARP_OP) {
        ++waiting;
        if (kind >= 0 && kind != f.kind) fail("lanes of a warp at different warp operations");
        kind = f.kind;
      }
    }
    if (!live || waiting != live) continue;
    unsigned long long ballot = 0;
    for (int i = w0; i < w1; ++i)
      if (g.fib[i].state == WARP_OP && g.fib[i].val) ballot |= 1ull << (i - w0);
    const long long red = kind >= RED_ADD ? reduce(kind, w0, w1) : 0;
    for (int i = w0; i < w1; ++i) {
      Fiber& f = g.fib[i];
      if (f.state != WARP_OP) continue;
      int src = i;
      if (kind == SHFL_XOR) src = w0 + (((i - w0) ^ f.arg) & 31);
      if (kind == SHFL_IDX) src = w0 + (f.arg & 31);
      if (kind == SHFL_UP && i - w0 >= f.arg) src = i - f.arg;
      if (kind == SHFL_DOWN && i - w0 + f.arg < 32) src = i + f.arg;
      if (is_shuffle(kind) && (src >= w1 || g.fib[src].state != WARP_OP))
        fail("shuffle from a lane that is not there");
      f.result = kind == BALLOT ? (long long)ballot
                 : kind >= RED_ADD ? red : g.fib[src].val;
    }
    for (int i = w0; i < w1; ++i)
      if (g.fib[i].state == WARP_OP) g.fib[i].state = RUN;
    if (warp_ops) ++warp_ops[w0 / 32];
    any = true;
  }
  return any;
}

// Releases the block barrier when every live thread waits at it.
inline bool release_block(int n, long long& barriers) {
  int live = 0, waiting = 0, kind = -1;
  long long count = 0;
  for (int i = 0; i < n; ++i) {
    const Fiber& f = g.fib[i];
    if (f.state == DONE) continue;
    ++live;
    if (f.state != BLOCK_OP) return false;
    ++waiting;
    if (kind >= 0 && kind != f.kind) fail("threads at different kinds of barrier");
    kind = f.kind;
    count += f.val ? 1 : 0;
  }
  if (!live) return false;
  long long r = 0;
  if (kind == OR) r = count > 0;
  if (kind == AND) r = count == waiting;
  if (kind == COUNT) r = count;
  for (int i = 0; i < n; ++i) {
    Fiber& f = g.fib[i];
    if (f.state == BLOCK_OP) {
      f.result = r;
      f.state = RUN;
    }
  }
  ++barriers;
  return true;
}

// Runs `body` as `grid` blocks of `block` threads; barriers[b] = block
// barriers passed by block b (when barriers is not null), warp_ops[b * W +
// w] = warp-wide operations of warp w of block b, W warps a block (when
// warp_ops is not null). A non-zero `seed` draws the order of fibers and
// their yields at atomics.
inline void launch(long long grid, int block, std::function<void()> body,
                   long long* barriers, unsigned long long seed,
                   long long* warp_ops = nullptr) {
  g.body = std::move(body);
  g.fib.assign(block, Fiber{});
  while ((int)g.stacks.size() < block) g.stacks.push_back((char*)std::malloc(STACK_BYTES));
  g.rng = seed ? seed * 0x9E3779B97F4A7C15ull | 1 : 0;
  grid_dim.x = (unsigned)grid;
  block_dim.x = (unsigned)block;
  std::vector<int> runnable;
  for (long long b = 0; b < grid; ++b) {
    block_idx.x = (unsigned)b;
    for (int i = 0; i < block; ++i) {
      Fiber& f = g.fib[i];
      f.started = false;
      f.state = RUN;
      getcontext(&f.uc);
      f.uc.uc_stack.ss_sp = g.stacks[i];
      f.uc.uc_stack.ss_size = STACK_BYTES;
      f.uc.uc_link = nullptr;
      makecontext(&f.uc, fiber_main, 0);
    }
    long long nbar = 0;
    long long* ops = warp_ops ? warp_ops + b * ((block + 31) / 32) : nullptr;
    if (ops)
      for (int w = 0; w < (block + 31) / 32; ++w) ops[w] = 0;
    for (;;) {
      runnable.clear();
      for (int i = 0; i < block; ++i)
        if (g.fib[i].state == RUN) runnable.push_back(i);
      if (g.rng) {
        while (!runnable.empty()) {
          size_t k = next_rand() % runnable.size();
          int i = runnable[k];
          resume(i);
          if (g.fib[i].state != RUN) {
            runnable[k] = runnable.back();
            runnable.pop_back();
          }
        }
      } else {
        for (int i : runnable) resume(i);
      }
      if (release_warps(block, ops)) continue;
      if (release_block(block, nbar)) continue;
      bool done = true;
      for (int i = 0; i < block; ++i) done = done && g.fib[i].state == DONE;
      if (done) break;
      fail("deadlock: threads wait at different barriers");
    }
    if (barriers) barriers[b] = nbar;
  }
}

}  // namespace shim

#define threadIdx (::shim::thread_idx)
#define blockIdx (::shim::block_idx)
#define blockDim (::shim::block_dim)
#define gridDim (::shim::grid_dim)

inline void __syncthreads() { shim::wait(shim::BLOCK_OP, shim::SYNC, 0, 0); }
inline int __syncthreads_or(int p) { return (int)shim::wait(shim::BLOCK_OP, shim::OR, p != 0, 0); }
inline int __syncthreads_and(int p) { return (int)shim::wait(shim::BLOCK_OP, shim::AND, p != 0, 0); }
inline int __syncthreads_count(int p) { return (int)shim::wait(shim::BLOCK_OP, shim::COUNT, p != 0, 0); }
inline void __syncwarp(unsigned = 0xffffffffu) { shim::wait(shim::WARP_OP, shim::WSYNC, 0, 0); }
inline void __threadfence_block() {}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask, int = 32) {
  return (T)shim::wait(shim::WARP_OP, shim::SHFL_XOR, (long long)v, lane_mask);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta, int = 32) {
  return (T)shim::wait(shim::WARP_OP, shim::SHFL_UP, (long long)v, (int)delta);
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, unsigned delta, int = 32) {
  return (T)shim::wait(shim::WARP_OP, shim::SHFL_DOWN, (long long)v, (int)delta);
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int = 32) {
  return (T)shim::wait(shim::WARP_OP, shim::SHFL_IDX, (long long)v, src);
}
inline unsigned __ballot_sync(unsigned, int p) {
  return (unsigned)shim::wait(shim::WARP_OP, shim::BALLOT, p != 0, 0);
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
// the ballot holds only the live lanes: all of them hold p when none fails
inline int __all_sync(unsigned m, int p) { return __ballot_sync(m, !p) == 0; }
template <class T>
inline T __reduce_add_sync(unsigned, T v) {
  return (T)shim::wait(shim::WARP_OP, shim::RED_ADD, (long long)v, 0);
}
template <class T>
inline T __reduce_min_sync(unsigned, T v) {
  return (T)shim::wait(shim::WARP_OP, shim::RED_MIN, (long long)v, 0);
}
template <class T>
inline T __reduce_max_sync(unsigned, T v) {
  return (T)shim::wait(shim::WARP_OP, shim::RED_MAX, (long long)v, 0);
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return (unsigned)shim::wait(shim::WARP_OP, shim::RED_OR, (long long)v, 0);
}

template <class T, class U>
inline T atomicMin(T* p, U v) {
  shim::maybe_yield();
  T o = *p;
  if ((T)v < o) *p = (T)v;
  return o;
}
template <class T, class U>
inline T atomicMax(T* p, U v) {
  shim::maybe_yield();
  T o = *p;
  if ((T)v > o) *p = (T)v;
  return o;
}
template <class T, class U>
inline T atomicAdd(T* p, U v) {
  shim::maybe_yield();
  T o = *p;
  *p = o + (T)v;
  return o;
}
template <class T, class U>
inline T atomicOr(T* p, U v) {
  shim::maybe_yield();
  T o = *p;
  *p = o | (T)v;
  return o;
}
template <class T, class U>
inline T atomicAnd(T* p, U v) {
  shim::maybe_yield();
  T o = *p;
  *p = o & (T)v;
  return o;
}
template <class T, class U>
inline T atomicXor(T* p, U v) {
  shim::maybe_yield();
  T o = *p;
  *p = o ^ (T)v;
  return o;
}
template <class T, class U>
inline T atomicExch(T* p, U v) {
  shim::maybe_yield();
  T o = *p;
  *p = (T)v;
  return o;
}
template <class T, class U, class V>
inline T atomicCAS(T* p, U cmp, V v) {
  shim::maybe_yield();
  T o = *p;
  if (o == (T)cmp) *p = (T)v;
  return o;
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline unsigned max(unsigned a, unsigned b) { return a > b ? a : b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
// g++ in ISO C++ mode does not contract a * b + c into an fma
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
