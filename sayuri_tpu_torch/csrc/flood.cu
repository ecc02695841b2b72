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
// 2.9 KB out a board) but one board's serial chain of block-wide barriers:
// at 512 boards the whole grid is resident (five blocks of 384 threads per
// SM), so a launch takes about one board's latency. Design: one block per
// board and one thread per cell, instead of the TPU kernels' dilation and
// min-propagation rings with a float sum as the convergence test.
//   - labels_kernel: the union-find labelling of board.cuh, two barriers
//     whatever the board; each thread writes its own root, known without a
//     third barrier.
//   - flood_kernel: still label_by_class() (in-place min-label relaxation
//     with pointer jumping, one barrier a pass, ending on the first pass
//     without a write); the flood marks the labels of seeded cells and
//     broadcasts them back.

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

// out = cells of `allowed` connected within `allowed` to a cell of
// `seed & allowed`
__global__ void __launch_bounds__(MAXNN)
flood_kernel(const uint8_t* __restrict__ seed,
             const uint8_t* __restrict__ allowed, bool* out, int n) {
  __shared__ uint8_t cls[MAXNN];
  __shared__ uint8_t hit[MAXNN];
  __shared__ int lbl[MAXNN];
  const Geo g = make_geo(n);
  const int t = g.t;
  const long off = (long)blockIdx.x * g.nn;
  const bool a = g.cell && allowed[off + t];
  const bool sd = g.cell && seed[off + t];
  if (g.cell) {
    cls[t] = a ? 1 : 0;
    hit[t] = 0;
  }
  __syncthreads();
  label_by_class(g, cls, lbl);
  if (a && sd) hit[lbl[t]] = 1;
  __syncthreads();
  if (g.cell) out[off + t] = a && hit[lbl[t]];
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
  flood_kernel<<<(unsigned)boards, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seed, (const uint8_t*)allowed, (bool*)out, n);
  return (int)cudaGetLastError();
}
