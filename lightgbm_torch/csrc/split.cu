// B2 — best numerical split of a batch of leaves.
//
// Replaces the numerical part of the JAX package's
// lightgbm_tpu/ops/split.py `find_best_split` (`_numerical_candidates`,
// `leaf_output`, `leaf_gain`), which the strict grower vmaps over the two
// children of a split (grower.py `_best2`) and runs once at the root.  For
// each leaf k and feature f it scans the bins in both missing-value
// directions (0: NA goes right, 1: NA goes left), computes the regularised
// split gain (lambda_l1, lambda_l2, max_delta_step, path_smooth,
// min_gain_to_split) and its validity (min_data_in_leaf,
// min_sum_hessian_in_leaf, threshold range, feature mask, NA direction
// only where the feature has an NA bin), takes the argmax over the
// flattened [2, F, B] gains with the smallest (direction, feature, bin)
// winning ties, as jnp.argmax does, and writes one 12-float record per
// leaf: gain, feature, threshold, default_left, left (g, h, count),
// right (g, h, count), left output, right output.
//
// Bound on this card: one kernel launch.  At the main path the bytes the
// function must move (hist [2, 28, 63, 3] f32 = 42 KB in, two 48-byte
// records out) take 0.013 us at 3.35 TB/s, and its arithmetic (about 40
// f32 operations for each of the 2*2*28*63 candidates) 0.004 us at
// 67 TFLOP/s; chip_smoke.py reports the larger, the byte time, as
// bound_ms.  Both are far below the latency of one launch, which
// chip_smoke.py times beside the kernel (an empty kernel), so one launch
// is the floor this kernel is held against.  Its scratch (gains and prefix
// sums, 70 KB) stays in L2.
//
// `active` (optional, a device int32): the grower's step record flag; when
// it is 0 (the tree is done) both kernels return at once and write nothing.
//
// Per-child operands (B6-node, feature_fraction_bynode and extra_trees;
// ops/split.py `_numerical_candidates` rand_bin :229, grower.py `_best2`
// :524): the feature mask is one [F] row for every leaf (mask_stride 0) or
// one row a leaf (mask_stride F), and `rand_bin` (optional, [K, F] int32)
// leaves one threshold bin a (leaf, feature) valid, in both NA
// directions.  Without them the launches and results are as before.
//
// Design.  `split_gains`: one block per (feature, leaf) loads the [B, 3]
// histogram into shared memory; three threads scan the bins in order, one
// channel each (the same sequential order as the plain version's cumsum on
// the CPU), then one thread per bin evaluates both directions with the
// f32 formulas of ops/split.py and writes the gains and prefix sums to
// scratch.  `split_pick`: one block per leaf takes the argmax and computes
// the winner's sums and leaf outputs.  Compiled with -fmad=false so every
// product and sum rounds as in the op-by-op PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEpsilon = 1e-15f;
constexpr int kRecord = 12;
constexpr int kPickThreads = 256;

struct Params {
  float l1, l2, min_data, min_hess, min_gain, max_delta, path_smooth;
};

__device__ float threshold_l1(float s, float l1) {
  if (l1 <= 0.f) return s;
  const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : s);
  return sg * fmaxf(fabsf(s) - l1, 0.f);
}

__device__ float leaf_output(float g, float h, float count, float parent,
                             const Params& p) {
  const float num = -threshold_l1(g, p.l1);
  float out = num / fmaxf(h + p.l2, kEpsilon);
  if (p.max_delta > 0.f) out = fminf(fmaxf(out, -p.max_delta), p.max_delta);
  if (p.path_smooth > 0.f) {
    const float w = count / (count + p.path_smooth);
    out = out * w + parent * (1.f - w);
  }
  return out;
}

__device__ float leaf_gain(float g, float h, float count, float parent,
                           const Params& p) {
  if (p.max_delta <= 0.f && p.path_smooth <= 0.f) {
    const float t = threshold_l1(g, p.l1);
    return t * t / fmaxf(h + p.l2, kEpsilon);
  }
  const float out = leaf_output(g, h, count, parent, p);
  const float tg = threshold_l1(g, p.l1);
  return -(2.f * tg * out + (h + p.l2) * out * out);
}

// grid (F, K); block >= B threads; smem B*3 floats.
__global__ void split_gains(const float* __restrict__ hist,
                            const float* __restrict__ total,
                            const float* __restrict__ parent_out,
                            const int32_t* __restrict__ num_bin,
                            const int32_t* __restrict__ na_bin,
                            const uint8_t* __restrict__ feature_mask,
                            int mask_stride,
                            const int32_t* __restrict__ rand_bin,
                            int num_features, int num_bins, Params p,
                            const int32_t* __restrict__ active,
                            float* __restrict__ gains,
                            float* __restrict__ cum_out) {
  if (active != nullptr && *active == 0) return;
  extern __shared__ float cum[];
  const int f = blockIdx.x, k = blockIdx.y, b = threadIdx.x;
  const long long base = ((long long)k * num_features + f) * num_bins * 3;
  for (int i = b; i < num_bins * 3; i += blockDim.x) cum[i] = hist[base + i];
  const int nb = na_bin[f];
  const bool has_na = nb >= 0;
  __syncthreads();
  float na_g = 0.f, na_h = 0.f, na_c = 0.f;
  if (has_na && nb < num_bins) {
    na_g = cum[nb * 3 + 0];
    na_h = cum[nb * 3 + 1];
    na_c = cum[nb * 3 + 2];
  }
  __syncthreads();
  if (b < 3) {
    float acc = cum[b];
    for (int j = 1; j < num_bins; ++j) {
      acc += cum[j * 3 + b];
      cum[j * 3 + b] = acc;
    }
  }
  __syncthreads();
  if (b >= num_bins) return;

  const float t0 = total[k * 3 + 0], t1 = total[k * 3 + 1],
              t2 = total[k * 3 + 2];
  const float po = parent_out[k];
  const float shift = leaf_gain(t0, t1, t2, po, p) + p.min_gain;
  const bool in_range =
      b <= num_bin[f] - 2 && feature_mask[k * mask_stride + f] != 0 &&
      (rand_bin == nullptr || b == rand_bin[k * num_features + f]);
  const float c0 = cum[b * 3 + 0], c1 = cum[b * 3 + 1], c2 = cum[b * 3 + 2];
  for (int dir = 0; dir < 2; ++dir) {
    const float lg = dir ? c0 + na_g : c0;
    const float lh = dir ? c1 + na_h : c1;
    const float lc = dir ? c2 + na_c : c2;
    const float rg = t0 - lg, rh = t1 - lh, rc = t2 - lc;
    const float gain = leaf_gain(lg, lh, lc, po, p) +
                       leaf_gain(rg, rh, rc, po, p) - shift;
    const bool valid = in_range && (dir == 0 || has_na) &&
                       lc >= p.min_data && rc >= p.min_data &&
                       lh >= p.min_hess && rh >= p.min_hess &&
                       gain > kEpsilon;
    gains[(((long long)k * 2 + dir) * num_features + f) * num_bins + b] =
        valid ? gain : -INFINITY;
  }
  const long long o = base + (long long)b * 3;
  cum_out[o + 0] = c0;
  cum_out[o + 1] = c1;
  cum_out[o + 2] = c2;
}

// grid (K); block kPickThreads.
__global__ void split_pick(const float* __restrict__ gains,
                           const float* __restrict__ cum,
                           const float* __restrict__ hist,
                           const float* __restrict__ total,
                           const float* __restrict__ parent_out,
                           const int32_t* __restrict__ na_bin,
                           int num_features, int num_bins, Params p,
                           const int32_t* __restrict__ active,
                           float* __restrict__ out) {
  if (active != nullptr && *active == 0) return;
  __shared__ float best_g[kPickThreads];
  __shared__ int best_i[kPickThreads];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int m = 2 * num_features * num_bins;
  const float* g = gains + (long long)k * m;
  float bg = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = tid; i < m; i += kPickThreads) {
    const float v = g[i];
    if (v > bg || (v == bg && i < bi)) {
      bg = v;
      bi = i;
    }
  }
  best_g[tid] = bg;
  best_i[tid] = bi;
  __syncthreads();
  for (int step = kPickThreads / 2; step > 0; step >>= 1) {
    if (tid < step) {
      const float og = best_g[tid + step];
      const int oi = best_i[tid + step];
      if (og > best_g[tid] || (og == best_g[tid] && oi < best_i[tid])) {
        best_g[tid] = og;
        best_i[tid] = oi;
      }
    }
    __syncthreads();
  }
  if (tid != 0) return;
  const int idx = best_i[0];
  const int dir = idx / (num_features * num_bins);
  const int rem = idx % (num_features * num_bins);
  const int f = rem / num_bins, b = rem % num_bins;
  const long long base = ((long long)k * num_features + f) * num_bins * 3;
  float l[3];
  for (int c = 0; c < 3; ++c) l[c] = cum[base + b * 3 + c];
  const int nb = na_bin[f];
  if (dir == 1 && nb >= 0 && nb < num_bins)
    for (int c = 0; c < 3; ++c) l[c] = l[c] + hist[base + nb * 3 + c];
  float r[3];
  for (int c = 0; c < 3; ++c) r[c] = total[k * 3 + c] - l[c];
  const float po = parent_out[k];
  float* rec = out + (long long)k * kRecord;
  rec[0] = best_g[0];
  rec[1] = (float)f;
  rec[2] = (float)b;
  rec[3] = dir == 1 ? 1.f : 0.f;
  for (int c = 0; c < 3; ++c) rec[4 + c] = l[c];
  for (int c = 0; c < 3; ++c) rec[7 + c] = r[c];
  rec[10] = leaf_output(l[0], l[1], l[2], po, p);
  rec[11] = leaf_output(r[0], r[1], r[2], po, p);
}

}  // namespace

// hist [K, F, B, 3], total [K, 3], parent_out [K], num_bin/na_bin [F]
// int32, feature_mask [F] (mask_stride 0) or [K, F] (mask_stride F) uint8,
// rand_bin [K, F] int32 or null; scratch gains [K, 2, F, B] and cum
// [K, F, B, 3]; out [K, 12]; active may be null.  Returns
// cudaGetLastError() after the launches.
extern "C" int lgbt_split(const float* hist, const float* total,
                          const float* parent_out, const int32_t* num_bin,
                          const int32_t* na_bin, const uint8_t* feature_mask,
                          int mask_stride, const int32_t* rand_bin,
                          int num_leaves, int num_features, int num_bins,
                          float l1, float l2, float min_data, float min_hess,
                          float min_gain, float max_delta, float path_smooth,
                          const int32_t* active, float* gains, float* cum,
                          float* out, cudaStream_t stream) {
  const Params p{l1, l2, min_data, min_hess, min_gain, max_delta,
                 path_smooth};
  const int threads = ((num_bins + 31) / 32) * 32;
  split_gains<<<dim3(num_features, num_leaves), threads,
                num_bins * 3 * sizeof(float), stream>>>(
      hist, total, parent_out, num_bin, na_bin, feature_mask, mask_stride,
      rand_bin, num_features, num_bins, p, active, gains, cum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_pick<<<num_leaves, kPickThreads, 0, stream>>>(
      gains, cum, hist, total, parent_out, na_bin, num_features, num_bins, p,
      active, out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_split_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, split_gains);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, split_pick);
}
