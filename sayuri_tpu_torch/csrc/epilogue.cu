// Eval-mode epilogue of the net's conv blocks for Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the JAX package leaves the convs and the
// elementwise work around them to XLA, which fuses that work into the
// conv's output on the TPU. In eager PyTorch the same work is a chain of
// ATen kernels after each cuDNN conv (the conv output times the mask, the
// batch norm's multiply, add and mask, the activation, the squeeze-excite
// scale, the skip add, the cast back to bf16), each a full pass over the
// activations in float32, and several launches a block. This kernel does
// the whole chain in one pass (ops/epilogue.py is its wrapper and holds its
// plain twin):
//
//   y = ((x * m) * scale[c] + bias[c]) * m     scale given: the conv output
//                                              times the board mask m
//                                              [B, H, W], then the folded
//                                              batch norm; else y = x (the
//                                              input is masked already)
//   y = (sigmoid(g[b, c]) * y + beta[b, c]) * m   squeeze-excite (se on)
//   y = y + skip                               skip_mode 1
//   y = act(y)                                 act: every one of the net's
//   y = y + skip                               skip_mode 2 (after act)
//
// then writes y as float32 (out_f32) and/or rounded to bf16 (out_lo).
//
// What bounds it on this card: bytes, at 3.35 TB/s. A b15c192 block tail at
// B = 256 reads 17.7M bf16 conv outputs and float32 skips and writes them
// back as float32 and bf16, 12 bytes an element, against about 2 flops an
// element outside the activation. The design:
//   - NHWC tensors, one thread an 8-channel vector of one pixel: every
//     load and store is 16 bytes (one for 8 bf16, two for 8 float32);
//   - the block size is a multiple of the channel groups (C / 8) and the
//     grid-stride step with it, so each thread keeps one channel group for
//     its whole loop and holds that group's scale and bias in registers;
//     the mask is one 4-byte load a pixel that the pixel's threads share;
//   - every result is computed in float32 with rounded multiplies and adds
//     (__fmul_rn, __fadd_rn: no contraction into an fma), in the order of
//     the ATen chain it replaces, and the activations use the formulas of
//     ATen's kernels, so a result keeps the precision it had;
//   - the squeeze-excite gates are read as the dense layer wrote them; bf16
//     gates (`se_bf16`) have their sigmoid rounded to bf16, as ATen's bf16
//     sigmoid is.
// A channel count that is not a multiple of 8, or a pointer off 16 bytes,
// takes a kernel of one channel a thread that reads the activation at run
// time; the 8-channel kernels have it as a template argument.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#define EPI_THREADS 256
#define EPI_MAX_GROUPS 1024

enum {
  ACT_IDENTITY, ACT_RELU, ACT_ELU, ACT_SELU, ACT_GELU, ACT_MISH, ACT_SWISH,
  ACT_HARDSWISH, NUM_ACTS,
  ACT_ANY = -1  // the activation read at run time (the one-channel kernel)
};

namespace {

__device__ __forceinline__ float bf16_bits_to_f32(unsigned bits) {
  return __uint_as_float(bits << 16);
}

// round to nearest even, as __float2bfloat16_rn and torch's cast do
__device__ __forceinline__ unsigned f32_to_bf16_bits(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == ACT_RELU) return x > 0.0f ? x : 0.0f;
  if (ACT == ACT_ELU) return x > 0.0f ? x : expm1f(x);
  if (ACT == ACT_SELU) {
    const float scale = 1.0507009873554804934193349852946f;
    const float alpha = 1.6732632423543772848170429916717f;
    return x > 0.0f ? x * scale : expm1f(x) * (alpha * scale);
  }
  if (ACT == ACT_GELU) return x * 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
  if (ACT == ACT_MISH) return x * tanhf(log1pf(expf(x)));
  if (ACT == ACT_SWISH) return x / (1.0f + expf(-x));
  // ATen's CUDA kernel multiplies by 1/6 (its CPU kernel divides by 6)
  if (ACT == ACT_HARDSWISH) return x * fminf(fmaxf(x + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f);
  return x;
}

__device__ __forceinline__ float activate_any(int act, float x) {
  switch (act) {
    case ACT_RELU: return activate<ACT_RELU>(x);
    case ACT_ELU: return activate<ACT_ELU>(x);
    case ACT_SELU: return activate<ACT_SELU>(x);
    case ACT_GELU: return activate<ACT_GELU>(x);
    case ACT_MISH: return activate<ACT_MISH>(x);
    case ACT_SWISH: return activate<ACT_SWISH>(x);
    case ACT_HARDSWISH: return activate<ACT_HARDSWISH>(x);
    default: return x;
  }
}

// V consecutive values at element `off` of a bf16 (IN_BF16) or float32
// array, as float32
template <bool IN_BF16, int V>
__device__ __forceinline__ void load_vec(const void* __restrict__ p, long long off,
                                         float* y) {
  if (V == 8 && IN_BF16) {
    const uint4 u = *(const uint4*)((const uint16_t*)p + off);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      y[2 * k] = bf16_bits_to_f32(w[k] & 0xffffu);
      y[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else if (V == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = *(const uint4*)((const float*)p + off + 4 * h);
      y[4 * h] = __uint_as_float(u.x);
      y[4 * h + 1] = __uint_as_float(u.y);
      y[4 * h + 2] = __uint_as_float(u.z);
      y[4 * h + 3] = __uint_as_float(u.w);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      y[v] = IN_BF16 ? bf16_bits_to_f32(((const uint16_t*)p)[off + v])
                     : ((const float*)p)[off + v];
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* __restrict__ p, long long off,
                                          const float* y) {
  if (V == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 u;
      u.x = __float_as_uint(y[4 * h]);
      u.y = __float_as_uint(y[4 * h + 1]);
      u.z = __float_as_uint(y[4 * h + 2]);
      u.w = __float_as_uint(y[4 * h + 3]);
      *(uint4*)(p + off + 4 * h) = u;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[off + v] = y[v];
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(uint16_t* __restrict__ p, long long off,
                                           const float* y) {
  if (V == 8) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = f32_to_bf16_bits(y[2 * k]) | (f32_to_bf16_bits(y[2 * k + 1]) << 16);
    uint4 u;
    u.x = w[0];
    u.y = w[1];
    u.z = w[2];
    u.w = w[3];
    *(uint4*)(p + off) = u;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[off + v] = (uint16_t)f32_to_bf16_bits(y[v]);
  }
}

// One thread an V-channel vector of a pixel; blockDim.x and the grid-stride
// step are multiples of the channel groups C / V (the launcher's geometry),
// so a thread's channels never change. The activation is a template
// argument of the 8-channel kernels; the one-channel kernel (ACT_ANY)
// reads `act`, and nine instances keep the build short.
template <int ACT, int V>
__global__ void __launch_bounds__(EPI_MAX_GROUPS)
epilogue_kernel(const void* __restrict__ x, int in_bf16, int act,
                const float* __restrict__ m,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const void* __restrict__ se, int se_bf16,
                const float* __restrict__ skip, int skip_mode,
                float* __restrict__ out_f32, uint16_t* __restrict__ out_lo,
                long long pixels, int hw, int channels) {
  const int groups = channels / V;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c0 = (int)(first % groups) * V;
  const long long pstep = (long long)gridDim.x * blockDim.x / groups;
  float sc[V], bi[V];
  if (scale != nullptr) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sc[v] = scale[c0 + v];
      bi[v] = bias[c0 + v];
    }
  }
  for (long long p = first / groups; p < pixels; p += pstep) {
    const long long off = p * channels + c0;
    const float mk = m[p];
    float y[V];
    if (in_bf16)
      load_vec<true, V>(x, off, y);
    else
      load_vec<false, V>(x, off, y);
    if (scale != nullptr) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        y[v] = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(y[v], mk), sc[v]), bi[v]), mk);
    }
    if (se != nullptr) {
      const long long row = (p / hw) * 2 * channels + c0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float g, beta;
        if (se_bf16) {
          g = bf16_bits_to_f32(((const uint16_t*)se)[row + v]);
          beta = bf16_bits_to_f32(((const uint16_t*)se)[row + channels + v]);
        } else {
          g = ((const float*)se)[row + v];
          beta = ((const float*)se)[row + channels + v];
        }
        float s = 1.0f / (1.0f + expf(-g));
        if (se_bf16) s = bf16_bits_to_f32(f32_to_bf16_bits(s));
        y[v] = __fmul_rn(__fadd_rn(__fmul_rn(s, y[v]), beta), mk);
      }
    }
    float r[V];
    if (skip_mode != 0) load_vec<false, V>(skip, off, r);
    if (skip_mode == 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) y[v] = __fadd_rn(y[v], r[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      y[v] = ACT == ACT_ANY ? activate_any(act, y[v]) : activate<ACT>(y[v]);
    if (skip_mode == 2) {
#pragma unroll
      for (int v = 0; v < V; ++v) y[v] = __fadd_rn(y[v], r[v]);
    }
    if (out_f32 != nullptr) store_f32<V>(out_f32, off, y);
    if (out_lo != nullptr) store_bf16<V>(out_lo, off, y);
  }
}

// threads a block: a multiple of the channel groups, about EPI_THREADS
__host__ __forceinline__ int epilogue_block(int groups) {
  return groups >= EPI_THREADS ? groups : EPI_THREADS / groups * groups;
}

// blocks: one pass of the threads over the tensor, at most `max_blocks`
__host__ __forceinline__ long long epilogue_grid(long long pixels, int groups,
                                                 int block, long long max_blocks) {
  const long long blocks = (pixels * groups + block - 1) / block;
  return blocks < max_blocks ? blocks : max_blocks;
}

}  // namespace

// the kernel instance of (act, 8-channel vectors), as CALL(ACT, V); shared
// by the launcher and the CPU shim's entry
#define EPI_DISPATCH(act, vec, CALL)                      \
  if (!(vec)) { CALL(ACT_ANY, 1); }                       \
  else switch (act) {                                     \
    case ACT_IDENTITY: CALL(ACT_IDENTITY, 8); break;      \
    case ACT_RELU: CALL(ACT_RELU, 8); break;              \
    case ACT_ELU: CALL(ACT_ELU, 8); break;                \
    case ACT_SELU: CALL(ACT_SELU, 8); break;              \
    case ACT_GELU: CALL(ACT_GELU, 8); break;              \
    case ACT_MISH: CALL(ACT_MISH, 8); break;              \
    case ACT_SWISH: CALL(ACT_SWISH, 8); break;            \
    default: CALL(ACT_HARDSWISH, 8); break;               \
  }

extern "C" int launch_epilogue(const void* x, int in_bf16, const void* m,
                               const void* scale, const void* bias,
                               const void* se, int se_bf16, const void* skip,
                               int skip_mode, int act, void* out_f32,
                               void* out_lo, long long pixels, int hw,
                               int channels, int vec, int max_blocks,
                               void* stream) {
  const int groups = vec ? channels / 8 : channels;
  if (channels <= 0 || (vec && channels % 8 != 0) || groups > EPI_MAX_GROUPS ||
      pixels < 0 || hw <= 0 || act < 0 || act >= NUM_ACTS || skip_mode < 0 ||
      skip_mode > 2 || (skip_mode != 0) != (skip != nullptr) ||
      (scale == nullptr) != (bias == nullptr) || max_blocks <= 0 ||
      (out_f32 == nullptr && out_lo == nullptr))
    return (int)cudaErrorInvalidValue;
  if (pixels == 0) return 0;
  const int block = epilogue_block(groups);
  const long long grid = epilogue_grid(pixels, groups, block, max_blocks);
  cudaStream_t st = (cudaStream_t)stream;
#define EPI_LAUNCH(A, V)                                                      \
  epilogue_kernel<A, V><<<(unsigned)grid, block, 0, st>>>(                    \
      x, in_bf16, act, (const float*)m, (const float*)scale,                  \
      (const float*)bias, se, se_bf16, (const float*)skip, skip_mode,         \
      (float*)out_f32, (uint16_t*)out_lo, pixels, hw, channels);
  EPI_DISPATCH(act, vec, EPI_LAUNCH)
#undef EPI_LAUNCH
  return (int)cudaGetLastError();
}
