// B6 (bagging) — the in-bag mask and the per-row (g*w, h*w, w) stack.
//
// Replaces the JAX package's lightgbm_tpu/models/gbdt.py `_bagging_w`
// (:1305) and the `vals = stack([g*w, h*w, w])` that follows it in every
// training path (:1578, :1995, :2632):
//
//     epoch = (it / freq) * freq
//     key   = fold_in(PRNGKey(seed), epoch)
//     u[r]  = uniform(key)[r]                      (jax.random, f32)
//     w[r]  = u[r] < fraction                      (or, for a binary
//             objective with pos/neg fractions: label[r] > 0 ?
//             u[r] < pos_fraction : u[r] < neg_fraction)
//     vals[r] = (g[r] * w[r], h[r] * w[r], w[r])
//
// The stream is jax.random's threefry2x32 under its defaults (see
// lightgbm_torch/ops/random.py, the plain version, which holds the same
// bits): the key is two uint32 words, PRNGKey(seed) = (0, seed mod 2^32);
// fold_in(key, d) = threefry2x32(key, (0, d)); and with
// jax_threefry_partitionable the word of row r is o0 ^ o1 of
// threefry2x32(key, (r >> 32, r & 0xffffffff)), mapped to f32 as
// bitcast((bits >> 9) | 0x3f800000) - 1.
//
// The iteration `it` is read from a device int32, so a captured CUDA
// graph draws a new mask whenever its replay's iteration reaches a new
// refresh epoch: the host never bakes an iteration into the launch.
// Thread 0 of each block derives the key once into shared memory.
//
// Bound on this card: bytes.  g and h read (8 N), the label flags read
// when pos/neg fractions are set (N), vals written (12 N): at N =
// 1,000,000 about 21 MB, about 6 us at 3.35 TB/s.  Two threefry2x32 a row
// would be 20 rounds of integer adds, rotates and xors, about 100
// operations, far from the integer rate.
//
// It is all integer arithmetic, one f32 compare and two f32 multiplies
// (built with -fmad=false), so it equals the plain version bit for bit.

#include <cuda_runtime.h>
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

__global__ void bag_vals(const float* __restrict__ g,
                         const float* __restrict__ h,
                         const uint8_t* __restrict__ positive, long long n,
                         const int32_t* __restrict__ iter, uint32_t seed_k0,
                         uint32_t seed_k1, int freq, float fraction,
                         float pos_fraction, float neg_fraction,
                         float* __restrict__ vals) {
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {
    const int it = *iter;
    uint32_t x0 = 0u, x1 = (uint32_t)((it / freq) * freq);
    threefry2x32(seed_k0, seed_k1, x0, x1);
    key[0] = x0;
    key[1] = x1;
  }
  __syncthreads();
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  uint32_t x0 = (uint32_t)((unsigned long long)r >> 32);
  uint32_t x1 = (uint32_t)((unsigned long long)r & 0xffffffffull);
  threefry2x32(key[0], key[1], x0, x1);
  const uint32_t bits = x0 ^ x1;
  const float u = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  bool in_bag;
  if (positive != nullptr)
    in_bag = positive[r] ? u < pos_fraction : u < neg_fraction;
  else
    in_bag = u < fraction;
  const float w = in_bag ? 1.0f : 0.0f;
  float* v = vals + r * 3;
  v[0] = g[r] * w;
  v[1] = h[r] * w;
  v[2] = w;
}

}  // namespace

// positive: [n] uint8 label flags, or null for one fraction.  iter: a
// device int32, the iteration whose refresh epoch keys the draw.
extern "C" int lgbt_bag_vals(const float* g, const float* h,
                             const uint8_t* positive, long long n,
                             const int32_t* iter, unsigned int seed_k0,
                             unsigned int seed_k1, int freq, float fraction,
                             float pos_fraction, float neg_fraction,
                             float* vals, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  bag_vals<<<(unsigned int)blocks, threads, 0, stream>>>(
      g, h, positive, n, iter, seed_k0, seed_k1, freq, fraction,
      pos_fraction, neg_fraction, vals);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_sample_setup() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, bag_vals);
}
