// B6 — the sampling draws: bagging, GOSS and the growers' per-node draws.
//
// All three draw jax.random's threefry2x32 stream under its defaults
// (threefry.cuh; see lightgbm_torch/ops/random.py, the plain versions,
// which hold the same bits): the key is two uint32 words, PRNGKey(seed) = (0, seed mod 2^32);
// fold_in(key, d) = threefry2x32(key, (0, d)); and with
// jax_threefry_partitionable the word of flat index i is o0 ^ o1 of
// threefry2x32(key, (i >> 32, i & 0xffffffff)), mapped to f32 as
// bitcast((bits >> 9) | 0x3f800000) - 1.  Every iteration number is read
// from a device int32, so a captured CUDA graph draws anew on each replay:
// the host never bakes an iteration into a launch.  Built with
// -fmad=false; every kernel equals its plain version bit for bit.
//
// 1. `bag_vals` (B6 bagging) replaces lightgbm_tpu/models/gbdt.py
//    `_bagging_w` (:1305) and the `vals = stack([g*w, h*w, w])` that
//    follows it in every training path (:1578, :1995, :2632):
//
//     epoch = (it / freq) * freq
//     key   = fold_in(PRNGKey(seed), epoch)
//     u[r]  = uniform(key)[r]                      (jax.random, f32)
//     w[r]  = u[r] < fraction                      (or, for a binary
//             objective with pos/neg fractions: label[r] > 0 ?
//             u[r] < pos_fraction : u[r] < neg_fraction)
//     vals[r] = (g[r] * w[r], h[r] * w[r], w[r])
//
//    Thread 0 of each block derives the key once into shared memory.
//    Bound on this card: bytes.  g and h read (8 N), the label flags read
//    when pos/neg fractions are set (N), vals written (12 N): at N =
//    1,000,000 about 21 MB, about 6 us at 3.35 TB/s.  Two threefry2x32 a
//    row are about 100 integer operations, far from the integer rate.
//
// 2. `goss_vals` (B6-GOSS) replaces lightgbm_tpu/models/gbdt.py
//    `_goss_vals` (:1337) and the stack after it:
//
//     a[r]    = |g[r]| * h[r]
//     thresh  = the top_k-th largest a                 (-sort(-a)[top_k-1])
//     u[r]    = uniform(PRNGKey(seed + it))[r]         (no fold)
//     w[r]    = a[r] >= thresh ? 1 : (u[r] < p_other ? amp : 0)
//     vals[r] = (g[r] * w[r], h[r] * w[r], w[r])
//
//    The threshold is an exact radix select, not a sort: each a maps to a
//    uint32 key in the float's total order (NaN lowest, as the sort puts
//    it), and three passes (digits of 11, 11 and 10 bits from the top)
//    each count the digits of the rows that share the prefix found so
//    far (`goss_hist`: shared-memory counts, warp-aggregated with
//    __match_any_sync, so that the many ties of early iterations do not
//    serialise on one counter, then one global atomic a nonzero digit);
//    one block (`goss_pick`) scans the counts from the top for the digit
//    where the count reaches the rank still to find.  Counts are
//    integers, so the result is exact and independent of launch order.
//    The prefix and the remaining rank live in a device state buffer, so
//    nothing returns to the host and the sequence captures in a graph.
//    `goss_weights` then runs one thread a row.  Ties at the threshold all
//    go to the top set (>=), as in the JAX package.  Bound on this card:
//    bytes.  g and h read by the first pass (8 N) and the keys written
//    (4 N), the keys read by the two later passes (8 N), g and h read and
//    vals written by the weights (20 N): about 40 MB at N = 1,000,000,
//    12 us at 3.35 TB/s.
//
// 3. `node_draws` (B6-node) replaces lightgbm_tpu/grower.py `_bynode_mask`
//    (:495) and `_rand_bins` (:509) as the strict (:835-870) and batched
//    (:1126-1144) growers call them, and the root's (:615-638).  One block
//    a child of the step (2 strict, 2K batched, 1 at the root):
//
//     bn   = fold_in(fold_in(PRNGKey(bynode_seed), rng_iter), id0 + c)
//     u[f] = uniform(bn)[f], +inf where base[f] is off
//     k    = max(1, ceil(f32(|base|) * f32(frac)))      (f32, as JAX)
//     mask[c, f] = base[f] && stable_rank(u)[f] < k     (ties: lower f)
//     et   = fold_in(fold_in(PRNGKey(extra_seed), rng_iter), step)
//     bin[c, f] = min(int(uniform(et, (C, F))[c*F + f]
//                         * f32(max(num_bin[f] - 1, 1))), num_bin[f] - 2)
//
//    It exits at once on the step's `active` flag (0 once the tree is
//    done), as the grower's other kernels do.  Bound on this card: one
//    launch; its bytes (the [F] base and bin counts in, [C, F] masks and
//    bins out) and its threefry rounds and rank comparisons take well
//    under a microsecond.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

__global__ void bag_vals(const float* __restrict__ g,
                         const float* __restrict__ h,
                         const uint8_t* __restrict__ positive, long long n,
                         const int32_t* __restrict__ iter, uint32_t seed_k0,
                         uint32_t seed_k1, int freq, int fold,
                         float fraction, float pos_fraction,
                         float neg_fraction, float* __restrict__ vals) {
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {
    const int it = *iter;
    uint32_t x0 = 0u, x1 = (uint32_t)((it / freq) * freq);
    threefry2x32(seed_k0, seed_k1, x0, x1);
    if (fold >= 0) {
      // fold_in(key, fold): a rank's own stream (data-parallel bagging)
      uint32_t y0 = 0u, y1 = (uint32_t)fold;
      threefry2x32(x0, x1, y0, y1);
      x0 = y0;
      x1 = y1;
    }
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

// --- B6-GOSS ---------------------------------------------------------------

constexpr int kGossThreads = 1024;
constexpr int kGossBlocks = 264;       // two a streaming multiprocessor
constexpr int kGossBins = 2048;
constexpr int kPickThreads = 256;
constexpr uint32_t kNoDigit = 0xffffffffu;

// the select's passes: digits of bits 31..21, 20..10 and 9..0
__device__ __forceinline__ int pass_shift(int pass) {
  return pass == 0 ? 21 : (pass == 1 ? 10 : 0);
}
__device__ __forceinline__ int pass_bins(int pass) {
  return pass == 2 ? 1024 : 2048;
}

// the uint32 key of a in the float's total order, NaN lowest
__device__ __forceinline__ uint32_t order_key(float a) {
  if (a != a) return 0u;
  const uint32_t b = __float_as_uint(a);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// grid-stride over rows; pass 0 computes and stores the keys, later passes
// count only rows whose higher digits equal the state's prefix.
__global__ void goss_hist(const float* __restrict__ g,
                          const float* __restrict__ h, long long n,
                          uint32_t* __restrict__ keys,
                          const uint32_t* __restrict__ state, int pass,
                          uint32_t* __restrict__ hist) {
  __shared__ uint32_t counts[kGossBins];
  const int shift = pass_shift(pass), nbins = pass_bins(pass);
  const int hi_shift = pass == 1 ? 21 : 10;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) counts[i] = 0u;
  const uint32_t want = pass > 0 ? state[0] >> hi_shift : 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp runs the same iterations (the bound is per
  // block), so __match_any_sync sees the whole warp
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long r = base + threadIdx.x;
    uint32_t d = kNoDigit;
    if (r < n) {
      uint32_t k;
      if (pass == 0) {
        k = order_key(fabsf(g[r]) * h[r]);
        keys[r] = k;
      } else {
        k = keys[r];
      }
      if (pass == 0 || (k >> hi_shift) == want)
        d = (k >> shift) & (uint32_t)(nbins - 1);
    }
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    if (d != kNoDigit && lane == __ffs(peers) - 1)
      atomicAdd(&counts[d], (uint32_t)__popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += blockDim.x)
    if (counts[i] != 0u) atomicAdd(&hist[i], counts[i]);
}

// one block of kPickThreads: thread t sums a run of digits from the top,
// a scan over the runs finds the run where the count from the top reaches
// the rank still to find, and its thread finds the digit.  state[0]: the
// key prefix, state[1]: the rank (1-based, from the top) among the rows
// that share it.
__global__ void goss_pick(const uint32_t* __restrict__ hist, int pass,
                          uint32_t top_k, uint32_t* __restrict__ state) {
  __shared__ uint32_t sums[kPickThreads];
  const int nbins = pass_bins(pass), per = nbins / kPickThreads;
  const int t = threadIdx.x, top = nbins - 1 - t * per;
  const uint32_t k_rem = pass == 0 ? top_k : state[1];
  const uint32_t prefix = pass == 0 ? 0u : state[0];
  uint32_t s = 0u;
  for (int j = 0; j < per; ++j) s += hist[top - j];
  sums[t] = s;
  __syncthreads();
  for (int off = 1; off < kPickThreads; off <<= 1) {
    const uint32_t v = t >= off ? sums[t - off] : 0u;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  const uint32_t incl = sums[t], excl = incl - s;
  if (!(excl < k_rem && k_rem <= incl)) return;
  uint32_t acc = excl;
  for (int j = 0; j < per; ++j) {
    const uint32_t c = hist[top - j];
    if (acc + c >= k_rem) {
      state[0] = prefix | ((uint32_t)(top - j) << pass_shift(pass));
      state[1] = k_rem - acc;
      return;
    }
    acc += c;
  }
}

__global__ void goss_weights(const float* __restrict__ g,
                             const float* __restrict__ h, long long n,
                             const uint32_t* __restrict__ state,
                             const int32_t* __restrict__ iter,
                             uint32_t seed_lo, float p_other, float amp,
                             float* __restrict__ vals) {
  __shared__ uint32_t key1;
  __shared__ float thresh;
  if (threadIdx.x == 0) {
    key1 = seed_lo + (uint32_t)(*iter);       // PRNGKey(seed + it)
    thresh = key_value(state[0]);
  }
  __syncthreads();
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  uint32_t x0 = (uint32_t)((unsigned long long)r >> 32);
  uint32_t x1 = (uint32_t)((unsigned long long)r & 0xffffffffull);
  threefry2x32(0u, key1, x0, x1);
  const float u = unit_float(x0 ^ x1);
  const float gr = g[r], hr = h[r];
  const bool is_top = fabsf(gr) * hr >= thresh;
  const bool is_other = !is_top && u < p_other;
  const float w = is_top ? 1.0f : (is_other ? amp : 0.0f);
  float* v = vals + r * 3;
  v[0] = gr * w;
  v[1] = hr * w;
  v[2] = w;
}

// --- B6-node ---------------------------------------------------------------

// grid (C): one block a child; dynamic smem F floats when bynode is on.
// Child c draws from row c of base (base_stride F: the children's allowed
// features under interaction constraints, grower.py :839-854,
// :1113-1134) or from the one row (base_stride 0).
__global__ void node_draws(const uint8_t* __restrict__ base_all,
                           int base_stride,
                           const int32_t* __restrict__ num_bin, int F,
                           const int32_t* __restrict__ rng_iter,
                           const int32_t* __restrict__ active, int bynode,
                           uint32_t bn_k0, uint32_t bn_k1, uint32_t bn_id0,
                           float frac, int extra, uint32_t et_k0,
                           uint32_t et_k1, uint32_t et_step,
                           uint8_t* __restrict__ masks,
                           int32_t* __restrict__ bins) {
  if (active != nullptr && *active == 0) return;
  extern __shared__ float u_s[];
  __shared__ uint32_t bk[2], ek[2];
  __shared__ int nvalid;
  const int c = blockIdx.x, tid = threadIdx.x;
  const uint8_t* base = base_all + (long long)c * base_stride;
  if (tid == 0) {
    const uint32_t it = (uint32_t)(*rng_iter);
    if (bynode) {
      uint32_t a = bn_k0, b = bn_k1;
      fold_in(a, b, it);
      fold_in(a, b, bn_id0 + (uint32_t)c);
      bk[0] = a;
      bk[1] = b;
      int cnt = 0;
      for (int f = 0; f < F; ++f) cnt += base[f] != 0;
      nvalid = cnt;
    }
    if (extra) {
      uint32_t a = et_k0, b = et_k1;
      fold_in(a, b, it);
      fold_in(a, b, et_step);
      ek[0] = a;
      ek[1] = b;
    }
  }
  __syncthreads();
  const long long row = (long long)c * F;
  if (bynode) {
    for (int f = tid; f < F; f += blockDim.x) {
      uint32_t x0 = 0u, x1 = (uint32_t)f;
      threefry2x32(bk[0], bk[1], x0, x1);
      u_s[f] = base[f] ? unit_float(x0 ^ x1) : INFINITY;
    }
    __syncthreads();
    const int k = (int)fmaxf(1.0f, ceilf((float)nvalid * frac));
    for (int f = tid; f < F; f += blockDim.x) {
      const float v = u_s[f];
      int rank = 0;
      for (int j = 0; j < F; ++j) {
        const float o = u_s[j];
        rank += (o < v) || (o == v && j < f);
      }
      masks[row + f] = (base[f] != 0 && rank < k) ? 1 : 0;
    }
  }
  if (extra) {
    for (int f = tid; f < F; f += blockDim.x) {
      const unsigned long long i = (unsigned long long)(row + f);
      uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)(i & 0xffffffffull);
      threefry2x32(ek[0], ek[1], x0, x1);
      const int nb = num_bin[f];
      const float span = (float)(nb - 1 > 1 ? nb - 1 : 1);
      const int r = (int)(unit_float(x0 ^ x1) * span);
      bins[row + f] = r < nb - 2 ? r : nb - 2;
    }
  }
}

}  // namespace

// positive: [n] uint8 label flags, or null for one fraction.  iter: a
// device int32, the iteration whose refresh epoch keys the draw.  fold:
// folded into the epoch's key when >= 0 (a rank's draw), else nothing.
extern "C" int lgbt_bag_vals(const float* g, const float* h,
                             const uint8_t* positive, long long n,
                             const int32_t* iter, unsigned int seed_k0,
                             unsigned int seed_k1, int freq, int fold,
                             float fraction, float pos_fraction,
                             float neg_fraction, float* vals,
                             cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  bag_vals<<<(unsigned int)blocks, threads, 0, stream>>>(
      g, h, positive, n, iter, seed_k0, seed_k1, freq, fold, fraction,
      pos_fraction, neg_fraction, vals);
  return (int)cudaGetLastError();
}

// keys: [n] scratch; hist: [3, 2048] scratch; state: [4] scratch; iter: a
// device int32; top_k: the rank of the threshold (1 <= top_k <= n).
extern "C" int lgbt_goss_vals(const float* g, const float* h, long long n,
                              const int32_t* iter, unsigned int seed_lo,
                              unsigned int top_k, float p_other, float amp,
                              uint32_t* keys, uint32_t* hist,
                              uint32_t* state, float* vals,
                              cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(hist, 0, 3 * kGossBins * sizeof(uint32_t),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  long long want = (n + kGossThreads - 1) / kGossThreads;
  const int blocks = (int)(want < kGossBlocks ? want : kGossBlocks);
  for (int pass = 0; pass < 3; ++pass) {
    goss_hist<<<blocks, kGossThreads, 0, stream>>>(
        g, h, n, keys, state, pass, hist + pass * kGossBins);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    goss_pick<<<1, kPickThreads, 0, stream>>>(hist + pass * kGossBins, pass,
                                               top_k, state);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  goss_weights<<<(unsigned int)((n + threads - 1) / threads), threads, 0,
                 stream>>>(g, h, n, state, iter, seed_lo, p_other, amp,
                           vals);
  return (int)cudaGetLastError();
}

// base: [F] bool (base_stride 0) or [C, F] (base_stride F); masks/bins:
// [C, F]; rng_iter a device int32; active a device int32 or null.  Writes
// only the draws that are on.
extern "C" int lgbt_node_draws(const uint8_t* base, int base_stride,
                               const int32_t* num_bin,
                               int F, int C, const int32_t* rng_iter,
                               const int32_t* active, int bynode,
                               unsigned int bn_k0, unsigned int bn_k1,
                               unsigned int bn_id0, float frac, int extra,
                               unsigned int et_k0, unsigned int et_k1,
                               unsigned int et_step, uint8_t* masks,
                               int32_t* bins, cudaStream_t stream) {
  int threads = ((F + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = bynode ? (size_t)F * sizeof(float) : 0;
  node_draws<<<C, threads, smem, stream>>>(
      base, base_stride, num_bin, F, rng_iter, active, bynode, bn_k0, bn_k1,
      bn_id0, frac, extra, et_k0, et_k1, et_step, masks, bins);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_sample_setup() {
  cudaFuncAttributes attr;
  const void* fns[] = {(const void*)bag_vals, (const void*)goss_hist,
                       (const void*)goss_pick, (const void*)goss_weights,
                       (const void*)node_draws};
  for (const void* fn : fns) {
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
