// JAX's threefry2x32 generator and float32 uniform, bit for bit, shared by
// the kernels that draw (phold_forward, link_send): the partitionable form
// of shadow_tpu/core/rng.py, where fold_in(key, d) is
// threefry2x32(key, (0, d)) and a 32-bit draw from a key is y0 ^ y1 of
// threefry2x32(key, (0, 0)). Built with --fmad=false; the uniform's one
// float subtraction is exact.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rng {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// uniform(fold_in(key, counter)) as jax.random computes it
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint32_t counter) {
  uint32_t a = 0u, b = counter;
  threefry2x32(k0, k1, a, b);
  uint32_t x0 = 0u, x1 = 0u;
  threefry2x32(a, b, x0, x1);
  const uint32_t bits = x0 ^ x1;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace rng
