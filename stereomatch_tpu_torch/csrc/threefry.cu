// K3: threefry-2x32 draws on Hopper (sm_90a), one launch a draw.
//
// Replaces no TPU kernel: the JAX package draws with jax.random, which XLA
// fuses into a few kernels a call. The port's int64 PyTorch version of the
// same function (random.py: threefry2x32 and the twins of split, fold_in
// and uniform) ran every one of threefry's 20 rounds as separate eager ops,
// about 171 launches a call on tensors of 2 to a few million elements.
// This kernel serves the four draws of random.py with jax.random's bits:
//   - keys: out[i] = threefry(k, (0, base + i)) for i < n, as two int64
//     words a key (split: base 0, n = num; fold_in: base = data, n = 1);
//   - uniform: thread i takes y0 ^ y1 of threefry(k, (i >> 32, i & M))
//     with 64-bit i, puts its top 23 bits into the mantissa of [1, 2),
//     subtracts 1 and stores max(lo, fma(f, hi - lo, lo)) as float32.
// The key's two words are read from device memory by every thread, so a
// draw needs no host copy of the key and no sync. The rounds run in uint32
// registers with __funnelshift_l for the rotations; the scale and shift is
// an explicit __fmaf_rn (XLA fuses jax.random.uniform's into an FMA, and
// the twin rounds it so), never a contraction left to the compiler.
//
// What bounds it: at the main paths' sizes, nothing on the card. A draw
// writes 8 bytes a key or 4 a float once and reads the 16 key bytes; about
// 80 integer operations an element (20 rounds of add, funnel shift and xor,
// the 5 key injections). The refine's draws are 2 to 15,731 elements, so a
// launch's cost is the host's launch; the 3.1M-node initial draw of a
// 2048x1536 frame is microseconds. A grid-stride loop over at most
// kMaxBlocks blocks serves any count.

#include <cstdint>

#include <algorithm>

#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks of 256 an SM fill the H100

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

__device__ __forceinline__ void rounds_a(uint32_t& x0, uint32_t& x1) {
  mix<13>(x0, x1);
  mix<15>(x0, x1);
  mix<26>(x0, x1);
  mix<6>(x0, x1);
}

__device__ __forceinline__ void rounds_b(uint32_t& x0, uint32_t& x1) {
  mix<17>(x0, x1);
  mix<29>(x0, x1);
  mix<16>(x0, x1);
  mix<24>(x0, x1);
}

// Threefry-2x32, 20 rounds: the key schedule of random.py::threefry2x32
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  rounds_a(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  rounds_b(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  rounds_a(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  rounds_b(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  rounds_a(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
}

// kUniform: out is (n,) float32; else (n, 2) int64 keys
template <bool kUniform>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(const int64_t* __restrict__ key, int64_t key_stride, uint32_t base,
                    int64_t n, float lo, float hi, void* __restrict__ out) {
  // the key's words hold uint32 values; only their low 32 bits take part
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[key_stride];
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    if constexpr (kUniform) {
      uint32_t x0 = (uint32_t)((uint64_t)i >> 32), x1 = (uint32_t)i;
      threefry2x32(k0, k1, x0, x1);
      const float f = __fsub_rn(__int_as_float((int)(((x0 ^ x1) >> 9) | 0x3F800000u)), 1.0f);
      static_cast<float*>(out)[i] = fmaxf(lo, __fmaf_rn(f, __fsub_rn(hi, lo), lo));
    } else {
      uint32_t x0 = 0, x1 = base + (uint32_t)i;
      threefry2x32(k0, k1, x0, x1);
      int64_t* o = static_cast<int64_t*>(out) + 2 * i;
      o[0] = (int64_t)x0;
      o[1] = (int64_t)x1;
    }
  }
}

unsigned blocks_for(int64_t n) {
  return (unsigned)std::min<int64_t>((n + kThreads - 1) / kThreads, kMaxBlocks);
}

}  // namespace

void threefry_keys_launch(const int64_t* key, int64_t key_stride, uint32_t base, int64_t n,
                          int64_t* out, cudaStream_t stream) {
  if (n <= 0) return;
  threefry_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(key, key_stride, base, n, 0.f,
                                                                  0.f, out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void threefry_uniform_launch(const int64_t* key, int64_t key_stride, int64_t n, float lo,
                             float hi, float* out, cudaStream_t stream) {
  if (n <= 0) return;
  threefry_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(key, key_stride, 0u, n, lo, hi,
                                                                 out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}
