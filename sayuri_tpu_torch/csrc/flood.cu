// Board fixpoint kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of sayuri_tpu/ops/flood.py:
//   flood_kernel  <- _flood_kernel  (entry flood_tpu)
//   labels_kernel <- _labels_kernel (entry chain_labels_tpu)
// Both take any number of boards: the wrapper (ops/flood.py) collapses the
// leading dimensions into one grid, as the custom_vmap rules collapse any
// vmap nesting into one launch on the TPU.
//
// What bounds them on this card: not bytes (361 bytes in and at most
// 2.9 KB out a board) but one board's serial chain of dependent steps, and
// at the superko mask's 92,416 boards how many boards an SM holds at once.
//   - labels_kernel: one block per board and one thread per cell, the
//     union-find labelling of board.cuh, two barriers whatever the board;
//     each thread writes its own root, known without a third barrier.
//   - flood_kernel: one warp per board, FLOOD_WARPS boards a block, no
//     block barrier and no shared memory. Lane r holds row r of `allowed`
//     and of the flood as bitmasks; a step takes the rows above and below
//     by shuffle and closes each row's runs with a carry (close_row), so
//     the loop runs once per vertical growth step, not once per cell, and
//     ends when a vote finds no row grew. Each input is one 16-byte load a
//     lane, so a board waits for one memory round trip (a byte a lane
//     would take twelve, one after another), turned into a bit stream
//     from which each lane takes its row by two shuffles; the output is
//     stored a byte a lane, coalesced. The launch bounds hold a thread to
//     32 registers, so 64 warps, 64 boards, stay resident an SM, where a
//     block-per-board flood holds five.

#include "board.cuh"

namespace {

// out[cell] = the min flat index of its 4-connected component of `mask`,
// -1 off the mask
__global__ void __launch_bounds__(MAXNN)
labels_kernel(const uint8_t* __restrict__ mask, long long* out, int n) {
  __shared__ uint8_t cls[MAXNN];
  __shared__ int lbl[MAXNN];
  const Geo g = make_geo(n);
  const long off = (long)blockIdx.x * g.nn;
  const bool on = g.cell && mask[off + g.t];
  if (g.cell) cls[g.t] = on ? 1 : 0;
  uf_seed(g, on, lbl);
  __syncthreads();
  uf_hook(g, cls, lbl);
  __syncthreads();
  const int root = uf_flatten(g, on, lbl);
  if (g.cell) out[off + g.t] = on ? root : -1;
}

constexpr int FLOOD_WARPS = 8;             // boards a block, one warp each
constexpr int FLAT_WORDS = (MAXNN + 31) / 32;   // 32-cell words of a board

// bit i set when byte i of v is not 0
__device__ __forceinline__ unsigned nonzero_nibble(unsigned v) {
  const unsigned msb = ((((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u) >> 7;
  return (msb * 0x01020408u) >> 24;
}

// The board of `nn` bytes at p as a bit stream: lane k loads the k-th
// 16-byte-aligned chunk of the span that holds the board (at most 24) and
// returns stream bits 16k .. 16k + 31 (its chunk and the next lane's);
// cell c is stream bit c + *shift. A chunk may take up to 15 bytes on
// either side of the board, in the same aligned 16 bytes as a byte of the
// buffer; no row takes their bits.
__device__ __forceinline__ unsigned load_stream(const uint8_t* p, int nn, int lane,
                                                int* shift) {
  const uintptr_t at = (uintptr_t)p;
  *shift = (int)(at & 15u);
  unsigned bits = 0u;
  if (16 * lane < *shift + nn) {
    const uint4 q = *reinterpret_cast<const uint4*>((at & ~(uintptr_t)15) + 16u * lane);
    bits = nonzero_nibble(q.x) | nonzero_nibble(q.y) << 4 | nonzero_nibble(q.z) << 8 |
           nonzero_nibble(q.w) << 12;
  }
  return bits | __shfl_down_sync(ALL, bits, 1) << 16;
}

// The n bits of the stream from bit pos on (two shuffles: the windows of
// lanes pos / 16 and pos / 16 + 1 cover 48 bits from 16 * (pos / 16))
__device__ __forceinline__ unsigned stream_row(unsigned stream, int pos, unsigned rowmask) {
  const int k = pos >> 4;
  const unsigned lo = __shfl_sync(ALL, stream, k & 31);
  const unsigned hi = __shfl_sync(ALL, stream, (k + 1) & 31);
  const unsigned long long w = lo | (unsigned long long)(hi >> 16) << 32;
  return (unsigned)(w >> (pos & 15)) & rowmask;
}

// out = cells of `allowed` connected within `allowed` to a cell of
// `seed & allowed`
__global__ void __launch_bounds__(FLOOD_WARPS * 32, 64 / FLOOD_WARPS)
flood_kernel(const uint8_t* __restrict__ seed,
             const uint8_t* __restrict__ allowed, bool* __restrict__ out,
             long long boards, int n) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * FLOOD_WARPS + (threadIdx.x >> 5);
  if (b >= boards) return;   // the whole warp
  const int nn = n * n;
  const long long off = b * nn;
  int sa, ss;
  const unsigned sta = load_stream(allowed + off, nn, lane, &sa);
  const unsigned sts = load_stream(seed + off, nn, lane, &ss);
  // this lane's row r: cells r * n .. r * n + n - 1
  const unsigned rowmask = lane < n ? (1u << n) - 1u : 0u;
  const unsigned a = stream_row(sta, sa + lane * n, rowmask);
  const unsigned ra = __brev(a);
  unsigned m = close_row(stream_row(sts, ss + lane * n, rowmask) & a, a, ra);
  while (true) {
    const unsigned up = __shfl_up_sync(ALL, m, 1), dn = __shfl_down_sync(ALL, m, 1);
    const unsigned add = ((lane > 0 ? up : 0u) | dn) & a & ~m;
    if (!__any_sync(ALL, add)) break;
    m = close_row(m | add, a, ra);
  }
  // cell c of the board is bit c - r * n of row r = c / n (inv_n: 2^32 / n
  // rounded up, exact for c < 2^32 / n)
  const unsigned inv_n = 0xffffffffu / (unsigned)n + 1u;
#pragma unroll
  for (int j = 0; j < FLAT_WORDS; ++j) {
    if (32 * j >= nn) break;
    const int c = 32 * j + lane;
    const int r = (int)__umulhi((unsigned)c, inv_n);
    const unsigned row = __shfl_sync(ALL, m, r & 31);
    if (c < nn) out[off + c] = (row >> (c - r * n)) & 1u;
  }
}

}  // namespace

extern "C" int launch_labels(const void* mask, void* out, long long boards,
                             int n, void* stream) {
  if (n < 2 || n * n > MAXNN || boards <= 0 || boards > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  labels_kernel<<<(unsigned)boards, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (long long*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int launch_flood(const void* seed, const void* allowed, void* out,
                            long long boards, int n, void* stream) {
  if (n < 2 || n * n > MAXNN || boards <= 0 || boards > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (boards + FLOOD_WARPS - 1) / FLOOD_WARPS;
  flood_kernel<<<(unsigned)blocks, FLOOD_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seed, (const uint8_t*)allowed, (bool*)out, boards, n);
  return (int)cudaGetLastError();
}
