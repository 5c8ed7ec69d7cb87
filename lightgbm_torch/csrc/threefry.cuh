// jax.random's threefry2x32 stream on the device, shared by sample.cu (B6)
// and rank.cu (B13b).  lightgbm_torch/ops/random.py computes the same bits
// in plain PyTorch, and tests/test_torch_random.py pins it to jax.random:
// the key is two uint32 words, PRNGKey(seed) = (0, seed mod 2^32);
// fold_in(key, d) = threefry2x32(key, (0, d)); with
// jax_threefry_partitionable the word of flat index i is o0 ^ o1 of
// threefry2x32(key, (i >> 32, i & 0xffffffff)), mapped to f32 as
// bitcast((bits >> 9) | 0x3f800000) - 1 (`unit_float`).

#pragma once

#include <stdint.h>

namespace {

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
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
}

__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// the uniform of flat index i (< 2^32) of the stream under (k0, k1)
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(k0, k1, x0, x1);
  return unit_float(x0 ^ x1);
}

}  // namespace
