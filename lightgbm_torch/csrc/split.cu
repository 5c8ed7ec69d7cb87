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
// Categorical features (`is_cat`, optional, [F] uint8): excluded from
// this numerical scan, as the JAX package's `feature_mask & ~is_cat`;
// B2-cat below scans them and merges its winner into these records.
//
// Per-child operands (B6-node, feature_fraction_bynode and extra_trees;
// ops/split.py `_numerical_candidates` rand_bin :229, grower.py `_best2`
// :524): the feature mask is one [F] row for every leaf (mask_stride 0) or
// one row a leaf (mask_stride F), and `rand_bin` (optional, [K, F] int32)
// leaves one threshold bin a (leaf, feature) valid, in both NA
// directions.  Without them the launches and results are as before.
//
// Split controls (optional, `Cons`; the rest of ops/split.py
// `find_best_split`, :343-485): with `mono` ([F] int8, the monotone
// `basic` method) each valid candidate's two child outputs (leaf_output
// with the child's count, :315-318) are clamped to the leaf's range
// [lo[k], hi[k]]; where either moved, the gain is recomputed from the
// clamped outputs less leaf_gain(total) + min_gain_to_split, without the
// parent output or the count (:334-336); a candidate against the
// feature's direction, or left at or below kEpsilon, is dropped
// (`_monotone_adjust`, :301).  Then every valid gain is scaled by
// factor[depth[k]] on a monotone feature (monotone_penalty, a table of
// the factor by depth that the host computes once) times contri[f]
// (:380-385), and the CEGB penalty slope[f] * total[k, 2] + coupled[f] *
// !cuse[f] is subtracted, a result at or below kEpsilon being invalid
// (:386-392).  `split_pick` clips the winner's outputs to the range
// (:462-485).  B2-cat takes the scale and the penalty, and its winner is
// clipped too; categorical gains never go through the monotone
// adjustment.  Every pointer of `Cons` null: the launches and results are
// as without controls.
//
// The partitioned learner's forms (grower_partitioned.py `_find_leaf`
// :322-362, ops/split.py :301-341 and :462-485): `pen` ([K, F] f32) is
// the leaf's CEGB penalty vector as that learner computes it on the host
// (`CEGBState.penalty_vector`), subtracted in place of slope * count +
// coupled * !cuse; the `mono_bounds` form (monotone `advanced`) gives
// four [K, F, B] f32 bound arrays `lo_l`, `hi_l`, `lo_r`, `hi_r`: each
// candidate (k, f, b) clips its left child's output to [lo_l, hi_l] and
// its right child's to [lo_r, hi_r] at that (feature, threshold bin)
// instead of to the leaf's scalar range, in the clamp, the recompute and
// the winner's clip; a categorical winner's outputs are clipped to the
// tightest bound over all of its feature's bins (lower bound max(lo),
// upper max(min(hi), max(lo))).
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

// GetLeafGainGivenOutput
__device__ float gain_given(float g, float h, float out, const Params& p) {
  const float tg = threshold_l1(g, p.l1);
  return -(2.f * tg * out + (h + p.l2) * out * out);
}

// the split controls' operands (see the header); a null pointer is off
struct Cons {
  const int8_t* mono;      // [F]: monotone basic
  const float* lo;         // [K] leaf output ranges (with mono)
  const float* hi;
  const int32_t* depth;    // [K] leaf depths (with factor)
  const float* factor;     // [n_factor] monotone penalty factor by depth
  int n_factor;
  const float* contri;     // [F]
  const float* slope;      // [F]: CEGB on
  const float* coupled;    // [F]
  const uint8_t* cuse;     // [F] (with coupled)
  const float* pen;        // [K, F] penalty vectors (in place of slope)
  const float* lo_l;       // [K, F, B] mono_bounds (with mono)
  const float* hi_l;
  const float* lo_r;
  const float* hi_r;
};

// a valid gain of leaf k and feature f, scaled and penalised; -inf where
// the penalised gain is at or below kEpsilon
__device__ float scale_penalise(float g, const Cons& c, int k, int f,
                                int num_f, float count) {
  if (c.factor != nullptr || c.contri != nullptr) {
    float s = 1.f;
    if (c.factor != nullptr && c.mono[f] != 0) {
      int d = c.depth[k];
      d = d < 0 ? 0 : (d >= c.n_factor ? c.n_factor - 1 : d);
      s = c.factor[d];
    }
    if (c.contri != nullptr) s = s * c.contri[f];
    g = g * s;
  }
  if (c.pen != nullptr) {
    const float pen = c.pen[k * num_f + f];
    g = g - pen > kEpsilon ? g - pen : -INFINITY;
  } else if (c.slope != nullptr) {
    float pen = c.slope[f] * count;
    if (c.coupled != nullptr)
      pen = pen + c.coupled[f] * (c.cuse[f] != 0 ? 0.f : 1.f);
    g = g - pen > kEpsilon ? g - pen : -INFINITY;
  }
  return g;
}

// the winner's (left, right) output clip of leaf k (with mono): the
// leaf's range, or the mono_bounds at (f, b), or for a categorical winner
// (`cat`) the tightest bound over f's bins
__device__ void clip_outputs(const Cons& c, int k, int f, int b, bool cat,
                             int num_f, int num_bins, float* out_l,
                             float* out_r) {
  if (c.mono == nullptr) return;
  float llo = c.lo[k], lhi = c.hi[k], rlo = c.lo[k], rhi = c.hi[k];
  if (c.lo_l != nullptr) {
    const long long row = ((long long)k * num_f + f) * num_bins;
    if (!cat) {
      llo = c.lo_l[row + b];
      lhi = c.hi_l[row + b];
      rlo = c.lo_r[row + b];
      rhi = c.hi_r[row + b];
    } else {
      float mll = -INFINITY, nhl = INFINITY, mlr = -INFINITY, nhr = INFINITY;
      for (int j = 0; j < num_bins; ++j) {
        mll = fmaxf(mll, c.lo_l[row + j]);
        nhl = fminf(nhl, c.hi_l[row + j]);
        mlr = fmaxf(mlr, c.lo_r[row + j]);
        nhr = fminf(nhr, c.hi_r[row + j]);
      }
      llo = mll;
      lhi = fmaxf(nhl, mll);
      rlo = mlr;
      rhi = fmaxf(nhr, mlr);
    }
  }
  *out_l = fminf(fmaxf(*out_l, llo), lhi);
  *out_r = fminf(fmaxf(*out_r, rlo), rhi);
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
                            const uint8_t* __restrict__ is_cat,
                            int num_features, int num_bins, Params p,
                            Cons cons, const int32_t* __restrict__ active,
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
  // the monotone recompute's shift: leaf_gain(total) without the parent
  // output, which takes the long form with the unsmoothed output whenever
  // max_delta_step or path_smooth is on (ops/split.py leaf_gain with no
  // parent output)
  Params q = p;
  q.path_smooth = 0.f;
  const float shift_np =
      (p.max_delta > 0.f || p.path_smooth > 0.f
           ? gain_given(t0, t1, leaf_output(t0, t1, t2, 0.f, q), p)
           : leaf_gain(t0, t1, t2, 0.f, p)) +
      p.min_gain;
  const float lo = cons.mono != nullptr ? cons.lo[k] : 0.f;
  const float hi = cons.mono != nullptr ? cons.hi[k] : 0.f;
  const int mf = cons.mono != nullptr ? cons.mono[f] : 0;
  const bool in_range =
      b <= num_bin[f] - 2 && feature_mask[k * mask_stride + f] != 0 &&
      (is_cat == nullptr || is_cat[f] == 0) &&
      (rand_bin == nullptr || b == rand_bin[k * num_features + f]);
  const float c0 = cum[b * 3 + 0], c1 = cum[b * 3 + 1], c2 = cum[b * 3 + 2];
  for (int dir = 0; dir < 2; ++dir) {
    const float lg = dir ? c0 + na_g : c0;
    const float lh = dir ? c1 + na_h : c1;
    const float lc = dir ? c2 + na_c : c2;
    const float rg = t0 - lg, rh = t1 - lh, rc = t2 - lc;
    float gain = leaf_gain(lg, lh, lc, po, p) +
                 leaf_gain(rg, rh, rc, po, p) - shift;
    bool valid = in_range && (dir == 0 || has_na) &&
                 lc >= p.min_data && rc >= p.min_data &&
                 lh >= p.min_hess && rh >= p.min_hess && gain > kEpsilon;
    if (valid && cons.mono != nullptr) {
      const float ol = leaf_output(lg, lh, lc, po, p);
      const float orr = leaf_output(rg, rh, rc, po, p);
      float cl, cr;
      if (cons.lo_l != nullptr) {
        const long long o = ((long long)k * num_features + f) * num_bins + b;
        cl = fminf(fmaxf(ol, cons.lo_l[o]), cons.hi_l[o]);
        cr = fminf(fmaxf(orr, cons.lo_r[o]), cons.hi_r[o]);
      } else {
        cl = fminf(fmaxf(ol, lo), hi);
        cr = fminf(fmaxf(orr, lo), hi);
      }
      if (cl != ol || cr != orr)
        gain = gain_given(lg, lh, cl, p) + gain_given(rg, rh, cr, p) -
               shift_np;
      const bool ok = mf > 0 ? cl <= cr : (mf < 0 ? cl >= cr : true);
      valid = ok && gain > kEpsilon;
    }
    if (valid) gain = scale_penalise(gain, cons, k, f, num_features, t2);
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
                           Cons cons, const int32_t* __restrict__ active,
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
  clip_outputs(cons, k, f, b, false, num_features, num_bins, rec + 10,
               rec + 11);
}

// ---------------------------------------------------------------------------
// B2-cat — the categorical scan of a batch of leaves, merged into B2's
// records.
//
// Replaces the JAX package's lightgbm_tpu/ops/split.py
// `_categorical_candidates` (:236-299) and the categorical half of
// `find_best_split` (:394-493): for each leaf k and categorical feature f
// (is_cat[f] and the leaf's feature mask), the bins with count >=
// max(0.5, min_data_per_group - 0.5) are "used"; one-vs-rest candidates
// (mode 0: one used bin left, the rest right) when at most
// max_cat_to_onehot bins are used, else prefixes of the used bins sorted
// by g / (h + cat_smooth) ascending (mode 1) and descending (mode 2), of
// lengths 1 .. min(max_cat_threshold, used - 1).  Unused bins (and bins
// past the feature's own count, which hold nothing) sort last.  The gains
// use lambda_l2 + cat_l2; validity min_data_in_leaf,
// min_sum_hessian_in_leaf and gain > kEpsilon.  The argmax over the
// flattened [3, F, B] gains takes the smallest (mode, feature, position)
// on ties, as jnp.argmax; the numerical record wins on >=.  A categorical
// winner's record has threshold = its prefix position (0 for
// one-vs-rest), default_left 0, leaf outputs with lambda_l2 + cat_l2, and
// a rank row: each bin's place in the winning order (go left iff
// rank <= threshold), or 0 for the chosen bin and B for every other bin
// (one-vs-rest).  A numerical winner's rank row is the identity.
//
// Bound on this card: one launch at the training shapes.  At 2K = 32
// children of 8 features and 256 bins the histograms are 786 KB, 0.23 us
// at 3.35 TB/s; the stable ranks are B compares a bin (O(B^2) for a
// feature, 2.1 M compares for the 32 x 6 categorical features of two
// orders), 0.03 us at 67 TFLOP/s.  chip_smoke.py reports the larger.
//
// Design.  `split_cat_gains`: one block per (feature, leaf), 256 threads,
// loads the [B, 3] histogram into shared memory; thread b computes bin
// b's two keys and its stable rank in each order by counting the keys
// before it (smaller, or equal at a lower bin index: jnp.argsort's stable
// order; the descending order is the stable ascending order of -ratio,
// not the ascending order reversed); six threads scan the sorted sums,
// one per (order, channel), in order, accumulating in f64 and rounding
// each prefix to f32, as the plain version's cumsum (in f64) does, so
// that mirrored subsets (an ascending prefix and the descending prefix of
// the other used bins, equal gains up to rounding) resolve alike in both;
// thread p evaluates position p in the three modes; a block
// reduction keeps the feature's best (gain, flat index), its left sums
// and its rank row in scratch.  `split_cat_pick`: one block per leaf
// takes the best feature, compares it with the numerical record and
// writes the merged record, the is-categorical flag and the rank row.
// -fmad=false and IEEE division make the keys, and so the orders, equal
// to the plain version's bit for bit.

constexpr int kCatThreads = 256;

struct CatParams {
  Params p;            // lambda_l2 here is lambda_l2 + cat_l2
  float cat_smooth, used_min;
  int max_cat_threshold, max_cat_to_onehot;
};

// NaN sorts with +inf, so every order is a permutation
__device__ __forceinline__ float order_key(float v) {
  return isnan(v) ? INFINITY : v;
}

__device__ __forceinline__ bool before(float ka, int a, float kb, int b) {
  return ka < kb || (ka == kb && a < b);
}

__device__ __forceinline__ bool better(float g, int i, float bg, int bi) {
  return g > bg || (g == bg && i < bi);
}

// grid (F, K); block kCatThreads >= B; dynamic smem (15 B + 2 threads)
// words.  fbest [K, F, 4] (gain, left g/h/count), fidx [K, F] (flat index
// of the feature's best candidate), frank [K, F, B].
__global__ void split_cat_gains(const float* __restrict__ hist,
                                const float* __restrict__ total,
                                const float* __restrict__ parent_out,
                                const uint8_t* __restrict__ is_cat,
                                const uint8_t* __restrict__ feature_mask,
                                int mask_stride, int num_features,
                                int num_bins, CatParams cp, Cons cons,
                                const int32_t* __restrict__ active,
                                float* __restrict__ fbest,
                                int32_t* __restrict__ fidx,
                                int32_t* __restrict__ frank) {
  if (active != nullptr && *active == 0) return;
  const int f = blockIdx.x, k = blockIdx.y, t = threadIdx.x;
  const int B = num_bins;
  const long long kf = (long long)k * num_features + f;
  if (is_cat[f] == 0 || feature_mask[k * mask_stride + f] == 0) {
    if (t == 0) {
      fbest[kf * 4] = -INFINITY;
      fidx[kf] = 0x7fffffff;
    }
    return;
  }
  extern __shared__ float sm[];
  float* hs = sm;                                  // [B, 3]
  float* cum = hs + B * 3;                         // [2, B, 3]
  float* key = cum + 2 * B * 3;                    // [2, B]
  int* rank = reinterpret_cast<int*>(key + 2 * B); // [2, B] bin -> place
  int* order = rank + 2 * B;                       // [2, B] place -> bin
  float* red_g = reinterpret_cast<float*>(order + 2 * B);
  int* red_i = reinterpret_cast<int*>(red_g + blockDim.x);

  const long long base = kf * B * 3;
  for (int i = t; i < B * 3; i += blockDim.x) hs[i] = hist[base + i];
  __syncthreads();
  bool used = false;
  if (t < B) {
    used = hs[t * 3 + 2] >= cp.used_min;
    const float ratio = hs[t * 3] / (hs[t * 3 + 1] + cp.cat_smooth);
    key[t] = order_key(used ? ratio : 1e30f);
    key[B + t] = order_key(used ? -ratio : 1e30f);
  }
  const int n_used = __syncthreads_count(used);
  if (t < B) {
    for (int m = 0; m < 2; ++m) {
      const float* km = key + m * B;
      const float kt = km[t];
      int r = 0;
      for (int j = 0; j < B; ++j) r += before(km[j], j, kt, t) ? 1 : 0;
      rank[m * B + t] = r;
      order[m * B + r] = t;
    }
  }
  __syncthreads();
  if (t < 6) {
    const int m = t / 3, c = t % 3;
    const int* om = order + m * B;
    float* cm = cum + m * B * 3;
    double acc = hs[om[0] * 3 + c];
    cm[c] = (float)acc;
    for (int j = 1; j < B; ++j) {
      acc += (double)hs[om[j] * 3 + c];
      cm[j * 3 + c] = (float)acc;
    }
  }
  __syncthreads();

  const Params& p = cp.p;
  const float t0 = total[k * 3 + 0], t1 = total[k * 3 + 1],
              t2 = total[k * 3 + 2];
  const float po = parent_out[k];
  const float shift = leaf_gain(t0, t1, t2, po, p) + p.min_gain;
  const bool few = n_used <= cp.max_cat_to_onehot;
  const int k_max = min(cp.max_cat_threshold, n_used - 1);
  const int fb = num_features * B;
  float bg = -INFINITY;
  int bi = 0x7fffffff;
  if (t < B) {
    for (int mode = 0; mode < 3; ++mode) {
      const float* l;
      bool ok;
      if (mode == 0) {
        l = hs + t * 3;
        ok = few && l[2] >= cp.used_min;
      } else {
        l = cum + ((mode - 1) * B + t) * 3;
        const int bin = order[(mode - 1) * B + t];
        ok = !few && t < k_max && hs[bin * 3 + 2] >= cp.used_min;
      }
      const float lg = l[0], lh = l[1], lc = l[2];
      const float rg = t0 - lg, rh = t1 - lh, rc = t2 - lc;
      float gain = leaf_gain(lg, lh, lc, po, p) +
                   leaf_gain(rg, rh, rc, po, p) - shift;
      ok = ok && lc >= p.min_data && rc >= p.min_data &&
           lh >= p.min_hess && rh >= p.min_hess && gain > kEpsilon;
      if (ok) gain = scale_penalise(gain, cons, k, f, num_features, t2);
      if (ok && gain > bg) {
        bg = gain;
        bi = mode * fb + f * B + t;
      }
    }
  }
  red_g[t] = bg;
  red_i[t] = bi;
  __syncthreads();
  for (int step = blockDim.x / 2; step > 0; step >>= 1) {
    if (t < step && better(red_g[t + step], red_i[t + step], red_g[t],
                           red_i[t])) {
      red_g[t] = red_g[t + step];
      red_i[t] = red_i[t + step];
    }
    __syncthreads();
  }
  const float best = red_g[0];
  const int idx = red_i[0];
  if (t == 0) {
    fbest[kf * 4] = best;
    fidx[kf] = idx;
  }
  if (best == -INFINITY) return;
  const int mode = idx / fb, pos = idx % B;
  if (t < 3)
    fbest[kf * 4 + 1 + t] =
        mode == 0 ? hs[pos * 3 + t] : cum[((mode - 1) * B + pos) * 3 + t];
  int32_t* fr = frank + kf * B;
  for (int b = t; b < B; b += blockDim.x)
    fr[b] = mode == 0 ? (b == pos ? 0 : B) : rank[(mode - 1) * B + b];
}

// grid (K); block kPickThreads.  Merges into out [K, 12] in place; writes
// cat [K] int32 and rank [K, B] int32.
__global__ void split_cat_pick(const float* __restrict__ total,
                               const float* __restrict__ parent_out,
                               int num_features, int num_bins, Params pc,
                               Cons cons, const int32_t* __restrict__ active,
                               const float* __restrict__ fbest,
                               const int32_t* __restrict__ fidx,
                               const int32_t* __restrict__ frank,
                               float* __restrict__ out,
                               int32_t* __restrict__ cat,
                               int32_t* __restrict__ rank) {
  if (active != nullptr && *active == 0) return;
  __shared__ float best_g[kPickThreads];
  __shared__ int best_i[kPickThreads], best_f[kPickThreads];
  __shared__ int s_take;
  const int k = blockIdx.x, tid = threadIdx.x, B = num_bins;
  float bg = -INFINITY;
  int bi = 0x7fffffff, bf = 0;
  for (int f = tid; f < num_features; f += kPickThreads) {
    const long long kf = (long long)k * num_features + f;
    const float g = fbest[kf * 4];
    const int i = fidx[kf];
    if (better(g, i, bg, bi)) {
      bg = g;
      bi = i;
      bf = f;
    }
  }
  best_g[tid] = bg;
  best_i[tid] = bi;
  best_f[tid] = bf;
  __syncthreads();
  for (int step = kPickThreads / 2; step > 0; step >>= 1) {
    if (tid < step && better(best_g[tid + step], best_i[tid + step],
                             best_g[tid], best_i[tid])) {
      best_g[tid] = best_g[tid + step];
      best_i[tid] = best_i[tid + step];
      best_f[tid] = best_f[tid + step];
    }
    __syncthreads();
  }
  const int f = best_f[0];
  if (tid == 0) {
    float* rec = out + (long long)k * kRecord;
    const float cg = best_g[0];
    const bool take_cat = !(rec[0] >= cg);
    if (take_cat) {
      const int idx = best_i[0];
      const int mode = idx / (num_features * B), pos = idx % B;
      const float* l = fbest + ((long long)k * num_features + f) * 4 + 1;
      float r[3];
      for (int c = 0; c < 3; ++c) r[c] = total[k * 3 + c] - l[c];
      const float po = parent_out[k];
      rec[0] = cg;
      rec[1] = (float)f;
      rec[2] = mode == 0 ? 0.f : (float)pos;
      rec[3] = 0.f;
      for (int c = 0; c < 3; ++c) rec[4 + c] = l[c];
      for (int c = 0; c < 3; ++c) rec[7 + c] = r[c];
      rec[10] = leaf_output(l[0], l[1], l[2], po, pc);
      rec[11] = leaf_output(r[0], r[1], r[2], po, pc);
      clip_outputs(cons, k, f, 0, true, num_features, B, rec + 10, rec + 11);
    }
    cat[k] = take_cat ? 1 : 0;
    s_take = take_cat ? 1 : 0;
  }
  __syncthreads();
  const int32_t* fr = frank + ((long long)k * num_features + f) * B;
  for (int b = tid; b < B; b += kPickThreads)
    rank[(long long)k * B + b] = s_take ? fr[b] : b;
}

}  // namespace

// The split controls' pointers, each null when off: mono [F] int8, lo/hi
// [K] f32 (with mono), depth [K] int32 and factor [n_factor] f32, contri
// [F] f32, slope [F] f32, coupled [F] f32, cuse [F] uint8 (with coupled),
// pen [K, F] f32 (in place of slope), lo_l/hi_l/lo_r/hi_r [K, F, B] f32
// (with mono).
// hist [K, F, B, 3], total [K, 3], parent_out [K], num_bin/na_bin [F]
// int32, feature_mask [F] (mask_stride 0) or [K, F] (mask_stride F) uint8,
// rand_bin [K, F] int32 or null, is_cat [F] uint8 or null; the split
// controls (Cons, in its field order); scratch gains [K, 2, F, B] and cum [K, F, B, 3];
// out [K, 12]; active may be null.  Returns cudaGetLastError() after the
// launches.
extern "C" int lgbt_split(const float* hist, const float* total,
                          const float* parent_out, const int32_t* num_bin,
                          const int32_t* na_bin, const uint8_t* feature_mask,
                          int mask_stride, const int32_t* rand_bin,
                          const uint8_t* is_cat, int num_leaves,
                          int num_features, int num_bins,
                          float l1, float l2, float min_data, float min_hess,
                          float min_gain, float max_delta, float path_smooth,
                          const int8_t* mono, const float* lo,
                          const float* hi, const int32_t* depth,
                          const float* factor, int n_factor,
                          const float* contri, const float* slope,
                          const float* coupled, const uint8_t* cuse,
                          const float* pen, const float* lo_l,
                          const float* hi_l, const float* lo_r,
                          const float* hi_r, const int32_t* active,
                          float* gains, float* cum, float* out,
                          cudaStream_t stream) {
  const Params p{l1, l2, min_data, min_hess, min_gain, max_delta,
                 path_smooth};
  const Cons cons{mono,  lo,   hi,   depth, factor, n_factor, contri, slope,
                  coupled, cuse, pen, lo_l, hi_l,   lo_r,     hi_r};
  const int threads = ((num_bins + 31) / 32) * 32;
  split_gains<<<dim3(num_features, num_leaves), threads,
                num_bins * 3 * sizeof(float), stream>>>(
      hist, total, parent_out, num_bin, na_bin, feature_mask, mask_stride,
      rand_bin, is_cat, num_features, num_bins, p, cons, active, gains, cum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_pick<<<num_leaves, kPickThreads, 0, stream>>>(
      gains, cum, hist, total, parent_out, na_bin, num_features, num_bins, p,
      cons, active, out);
  return (int)cudaGetLastError();
}

// B2-cat after B2 on the same leaves: hist [K, F, B, 3] (B <= 256), total
// [K, 3], parent_out [K], is_cat [F] uint8, feature_mask [F] or [K, F]
// uint8 (mask_stride 0 or F); l2 is lambda_l2 + cat_l2; the split
// controls as lgbt_split's; scratch fbest
// [K, F, 4], fidx [K, F], frank [K, F, B]; out [K, 12] (B2's records,
// merged in place), cat [K], rank [K, B]; active may be null.  Returns
// cudaGetLastError() after the launches.
extern "C" int lgbt_split_cat(const float* hist, const float* total,
                              const float* parent_out, const uint8_t* is_cat,
                              const uint8_t* feature_mask, int mask_stride,
                              int num_leaves, int num_features, int num_bins,
                              float l1, float l2, float min_data,
                              float min_hess, float min_gain, float max_delta,
                              float path_smooth, float cat_smooth,
                              float used_min, int max_cat_threshold,
                              int max_cat_to_onehot, const int8_t* mono,
                              const float* lo, const float* hi,
                              const int32_t* depth, const float* factor,
                              int n_factor, const float* contri,
                              const float* slope, const float* coupled,
                              const uint8_t* cuse, const float* pen,
                              const float* lo_l, const float* hi_l,
                              const float* lo_r, const float* hi_r,
                              const int32_t* active, float* fbest,
                              int32_t* fidx, int32_t* frank, float* out,
                              int32_t* cat, int32_t* rank,
                              cudaStream_t stream) {
  if (num_bins > kCatThreads) return (int)cudaErrorInvalidValue;
  const Params pc{l1, l2, min_data, min_hess, min_gain, max_delta,
                  path_smooth};
  const CatParams cp{pc, cat_smooth, used_min, max_cat_threshold,
                     max_cat_to_onehot};
  const Cons cons{mono,  lo,   hi,   depth, factor, n_factor, contri, slope,
                  coupled, cuse, pen, lo_l, hi_l,   lo_r,     hi_r};
  const size_t smem = (size_t)(15 * num_bins + 2 * kCatThreads) * 4;
  split_cat_gains<<<dim3(num_features, num_leaves), kCatThreads, smem,
                    stream>>>(hist, total, parent_out, is_cat, feature_mask,
                              mask_stride, num_features, num_bins, cp, cons,
                              active, fbest, fidx, frank);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_cat_pick<<<num_leaves, kPickThreads, 0, stream>>>(
      total, parent_out, num_features, num_bins, pc, cons, active, fbest,
      fidx, frank, out, cat, rank);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_split_setup() {
  cudaFuncAttributes attr;
  const void* fns[] = {(const void*)split_gains, (const void*)split_pick,
                       (const void*)split_cat_gains,
                       (const void*)split_cat_pick};
  for (const void* fn : fns) {
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
