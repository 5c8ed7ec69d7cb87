// B10 — the serving forest kernels: B10a forest_walk, B10b bin_rows,
// B10c fused_predict.
//
// Replace the JAX package's lightgbm_tpu/predict_device.py
// `_forest_walk` / `traverse_forest_binned` (B10a), `bin_rows_device` /
// `bin_rows_device_full` (B10b) and `fused_forest_predict` (B10c), which
// serve/engine.py runs for Booster.predict's engine route, the host-binned
// serve path and the device-resident fused serve path.
//
// The forest is the engine's structure-of-arrays tables, [T, M] per node
// field (M = padded node slots), uploaded as the engine packed them:
// thresholds uint8/uint16/int32, children int8/int16/int32, split features
// and categorical row indices uint8/uint16/int32, the categorical rank
// table [C, W] uint8 (int32 unpacked), default_left and is_cat as bytes.
// Every gathered value is widened to int32 before it is compared or used
// as an index, as `_forest_walk` does, so packing changes bytes moved and
// never a decision.  The kernels are templated on the binned matrix's,
// the thresholds' and the children's types (read at every level of every
// walk); the split feature, the categorical row index and the rank table
// are read through a width code given at launch (uniform across the grid,
// so the branch costs a few instructions and no divergence), which keeps
// the instantiations at 27 + 9 instead of several hundred.
//
// B10a, one thread per (row, tree), tree fastest: a warp reads one row's
// bins (one sector) and writes 32 consecutive int32 of the [N, T] output.
// A row walks until it reaches a leaf or `steps` levels (the JAX function
// walks exactly `steps` levels, but a finished row keeps its ~leaf, so the
// result is the same).  Bound on this card: bytes — the [N, T] int32
// output (400 MB at N = 200,000, T = 500) dominates the input rows and
// the tables, which stay in L2.
//
// B10b, one thread per (row, feature): numerical, the count of f32 table
// entries strictly below x (the table is padded with +inf, so padding
// never counts, and x = +inf counts every finite entry); NaN -> na_bin[f]
// when >= 0, else zero_bin[f].  Categorical (cat_len[f] > 0): iv = trunc(x)
// (-1 for a non-finite x), pos = count of categories < iv, clipped to
// [0, cat_len - 1], kept only where the category there equals iv, else the
// unseen sentinel cat_len.  Each count is a lower-bound binary search:
// the tables are non-decreasing (sorted f64 values rounded to f32, then
// +inf), so the first index j with !(t[j] < x) is exactly the number of
// entries below x, for every non-NaN x, -0.0 (equal to +0.0 under <) and
// +-inf included.  A linear count over the padded table was 1.30 ms at
// the serving shapes (a warp's 32 threads read 28 features' table rows at
// once, 64 times each).  Bound: bytes (x read, bins written).
//
// B10c, one thread per row: the row's bins by B10b's device function into
// shared memory (a global scratch row when F is too wide for 32 threads'
// worth of shared memory), then every tree in order: walk as B10a,
// gather leaf_value[t, leaf], __fmul_rn by the tree's weight, __fadd_rn to
// class t % k, and at the end __fdiv_rn by avg_denom.  The multiply and
// the add stay two IEEE roundings (no FMA: -fmad=false and the _rn
// intrinsics), as the JAX program's optimization_barrier keeps them and
// as the plain PyTorch version and the engine's host reference compute
// them, so all three agree bit for bit.  Bound: operations — every row
// walks every tree, a few dozen integer operations per level, while the
// bytes are only x in and [N, k] out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// width code of a table read by code: 0 -> 1 byte, 1 -> 2 bytes (unsigned),
// 2 -> int32
__device__ __forceinline__ int load_code(const void* p, int code,
                                         long long i) {
  if (code == 0) return (int)static_cast<const uint8_t*>(p)[i];
  if (code == 1) return (int)static_cast<const uint16_t*>(p)[i];
  return static_cast<const int32_t*>(p)[i];
}

struct Forest {
  const void* split_feature;
  int feat_code;
  const void* threshold;        // TT
  const uint8_t* default_left;
  const void* left_child;       // TC
  const void* right_child;      // TC
  const int32_t* na_bin;
  const uint8_t* is_cat;
  const void* cat_index;
  int ci_code;
  const void* cat_table;
  int ct_code;
  int cat_width;
  int trees;
  int nodes;
  int steps;
};

struct BinTables {
  const float* thresholds;      // [F, bp], +inf padded
  int bp;
  const int32_t* na_bin;        // [F]
  const int32_t* zero_bin;      // [F]
  const float* cat_values;      // [F, cp], +inf padded
  int cp;
  const int32_t* cat_len;       // [F]
};

// the leaf index (~node) of tree t for a row whose bin of feature f is
// bin_of(f)
template <typename TT, typename TC, typename BinOf>
__device__ __forceinline__ int walk_tree(const Forest& fo, int t,
                                         BinOf bin_of) {
  const long long base = (long long)t * fo.nodes;
  const TT* thr = static_cast<const TT*>(fo.threshold);
  const TC* lc = static_cast<const TC*>(fo.left_child);
  const TC* rc = static_cast<const TC*>(fo.right_child);
  int node = 0;
  for (int s = 0; s < fo.steps && node >= 0; ++s) {
    const long long i = base + node;
    const int f = load_code(fo.split_feature, fo.feat_code, i);
    const int v = bin_of(f);
    const bool cat = fo.is_cat[i] != 0;
    const int nb = fo.na_bin[f];
    bool go_left;
    if (!cat && nb >= 0 && v == nb) {
      go_left = fo.default_left[i] != 0;
    } else {
      int rank = v;
      if (cat) {
        const int ci = load_code(fo.cat_index, fo.ci_code, i);
        rank = load_code(fo.cat_table, fo.ct_code,
                         (long long)ci * fo.cat_width + v);
      }
      go_left = rank <= (int)thr[i];
    }
    node = go_left ? (int)lc[i] : (int)rc[i];
  }
  return ~node;
}

// the number of entries of the non-decreasing t[0, len) strictly below x
// (x not NaN): the first index whose entry is not below x
__device__ __forceinline__ int count_below(const float* t, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int bin_value(float x, int f, const BinTables& b) {
  const int cl = b.cp > 0 ? b.cat_len[f] : 0;
  if (cl > 0) {
    // finite: |x| <= FLT_MAX (false for +-inf and NaN)
    const float iv = fabsf(x) <= 3.402823466e+38f ? truncf(x) : -1.0f;
    const float* cv = b.cat_values + (long long)f * b.cp;
    const int pos = count_below(cv, b.cp, iv);
    const int posc = min(max(pos, 0), max(cl - 1, 0));
    return cv[posc] == iv ? posc : cl;
  }
  if (x != x) {  // NaN
    const int nb = b.na_bin[f];
    return nb >= 0 ? nb : b.zero_bin[f];
  }
  return count_below(b.thresholds + (long long)f * b.bp, b.bp, x);
}

template <typename TB, typename TT, typename TC>
__global__ void forest_walk_kernel(const TB* __restrict__ binned, int n,
                                   int nf, Forest fo,
                                   int32_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * fo.trees) return;
  const long long r = idx / fo.trees;
  const int t = (int)(idx - r * fo.trees);
  const TB* row = binned + r * nf;
  out[idx] = walk_tree<TT, TC>(fo, t, [&](int f) { return (int)row[f]; });
}

__global__ void bin_rows_kernel(const float* __restrict__ x, int n, int nf,
                                BinTables b, int32_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * nf) return;
  out[idx] = bin_value(x[idx], (int)(idx % nf), b);
}

template <typename TT, typename TC>
__global__ void fused_kernel(const float* __restrict__ x, int n, int nf,
                             BinTables b, Forest fo,
                             const float* __restrict__ leaf_value,
                             int leaf_slots,
                             const float* __restrict__ tree_weight,
                             float avg_denom, int k, int32_t* scratch,
                             float* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int32_t* bins = scratch != nullptr ? scratch + r * nf
                                     : smem + (long long)threadIdx.x * nf;
  const float* xr = x + r * nf;
  for (int f = 0; f < nf; ++f) bins[f] = bin_value(xr[f], f, b);
  float* o = out + r * k;
  for (int c = 0; c < k; ++c) o[c] = 0.0f;
  float acc = 0.0f;
  for (int t = 0; t < fo.trees; ++t) {
    int leaf = walk_tree<TT, TC>(fo, t, [&](int f) { return (int)bins[f]; });
    // a walk always ends at a leaf (steps >= the forest's depth); the clamp
    // only keeps a malformed table from reading out of bounds
    leaf = min(max(leaf, 0), leaf_slots - 1);
    const float p = __fmul_rn(leaf_value[(long long)t * leaf_slots + leaf],
                              tree_weight[t]);
    if (k == 1) {
      acc = __fadd_rn(acc, p);
    } else {
      const int c = t % k;
      o[c] = __fadd_rn(o[c], p);
    }
  }
  if (k == 1) {
    o[0] = __fdiv_rn(acc, avg_denom);
  } else {
    for (int c = 0; c < k; ++c) o[c] = __fdiv_rn(o[c], avg_denom);
  }
}

// dispatch a width code to a type: unsigned roles (binned, thresholds)
// 0 -> uint8, 1 -> uint16, 2 -> int32; signed roles (children) 0 -> int8,
// 1 -> int16, 2 -> int32
template <typename F>
int with_unsigned(int code, F&& f) {
  switch (code) {
    case 0: return f(uint8_t{});
    case 1: return f(uint16_t{});
    case 2: return f(int32_t{});
  }
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int with_signed(int code, F&& f) {
  switch (code) {
    case 0: return f(int8_t{});
    case 1: return f(int16_t{});
    case 2: return f(int32_t{});
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TB, typename TT, typename TC>
int launch_walk(const void* binned, int n, int nf, const Forest& fo,
                int32_t* out, cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)n * fo.trees;
  const long long blocks = (total + threads - 1) / threads;
  forest_walk_kernel<TB, TT, TC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const TB*>(binned), n, nf, fo, out);
  return (int)cudaGetLastError();
}

template <typename TT, typename TC>
int launch_fused(const float* x, int n, int nf, const BinTables& b,
                 const Forest& fo, const float* leaf_value, int leaf_slots,
                 const float* tree_weight, float avg_denom, int k,
                 int32_t* scratch, int threads, int smem_bytes, float* out,
                 cudaStream_t stream) {
  const long long blocks = ((long long)n + threads - 1) / threads;
  fused_kernel<TT, TC><<<(unsigned)blocks, threads, smem_bytes, stream>>>(
      x, n, nf, b, fo, leaf_value, leaf_slots, tree_weight, avg_denom, k,
      scratch, out);
  return (int)cudaGetLastError();
}

Forest make_forest(const void* split_feature, int feat_code,
                   const void* threshold, const uint8_t* default_left,
                   const void* left_child, const void* right_child,
                   const int32_t* na_bin, const uint8_t* is_cat,
                   const void* cat_index, int ci_code, const void* cat_table,
                   int ct_code, int cat_width, int trees, int nodes,
                   int steps) {
  Forest fo;
  fo.split_feature = split_feature;
  fo.feat_code = feat_code;
  fo.threshold = threshold;
  fo.default_left = default_left;
  fo.left_child = left_child;
  fo.right_child = right_child;
  fo.na_bin = na_bin;
  fo.is_cat = is_cat;
  fo.cat_index = cat_index;
  fo.ci_code = ci_code;
  fo.cat_table = cat_table;
  fo.ct_code = ct_code;
  fo.cat_width = cat_width;
  fo.trees = trees;
  fo.nodes = nodes;
  fo.steps = steps;
  return fo;
}

BinTables make_bins(const float* thresholds, int bp, const int32_t* na_bin,
                    const int32_t* zero_bin, const float* cat_values, int cp,
                    const int32_t* cat_len) {
  BinTables b;
  b.thresholds = thresholds;
  b.bp = bp;
  b.na_bin = na_bin;
  b.zero_bin = zero_bin;
  b.cat_values = cat_values;
  b.cp = cp;
  b.cat_len = cat_len;
  return b;
}

}  // namespace

extern "C" int lgbt_forest_walk(
    const void* binned, int n, int nf, int bin_code,
    const void* split_feature, int feat_code, const void* threshold,
    int thr_code, const uint8_t* default_left, const void* left_child,
    const void* right_child, int child_code, const int32_t* na_bin,
    const uint8_t* is_cat, const void* cat_index, int ci_code,
    const void* cat_table, int ct_code, int cat_width, int trees, int nodes,
    int steps, int32_t* out, cudaStream_t stream) {
  if (feat_code < 0 || feat_code > 2 || ci_code < 0 || ci_code > 2
      || (ct_code != 0 && ct_code != 2))
    return (int)cudaErrorInvalidValue;
  const Forest fo = make_forest(split_feature, feat_code, threshold,
                                default_left, left_child, right_child, na_bin,
                                is_cat, cat_index, ci_code, cat_table, ct_code,
                                cat_width, trees, nodes, steps);
  return with_unsigned(bin_code, [&](auto tb) {
    return with_unsigned(thr_code, [&](auto tt) {
      return with_signed(child_code, [&](auto tc) {
        return launch_walk<decltype(tb), decltype(tt), decltype(tc)>(
            binned, n, nf, fo, out, stream);
      });
    });
  });
}

extern "C" int lgbt_bin_rows(const float* x, int n, int nf,
                             const float* thresholds, int bp,
                             const int32_t* na_bin, const int32_t* zero_bin,
                             const float* cat_values, int cp,
                             const int32_t* cat_len, int32_t* out,
                             cudaStream_t stream) {
  const BinTables b = make_bins(thresholds, bp, na_bin, zero_bin, cat_values,
                                cp, cat_len);
  const int threads = 256;
  const long long total = (long long)n * nf;
  const long long blocks = (total + threads - 1) / threads;
  bin_rows_kernel<<<(unsigned)blocks, threads, 0, stream>>>(x, n, nf, b, out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_fused_predict(
    const float* x, int n, int nf, const float* thresholds, int bp,
    const int32_t* na_bin, const int32_t* zero_bin, const float* cat_values,
    int cp, const int32_t* cat_len, const void* split_feature, int feat_code,
    const void* threshold, int thr_code, const uint8_t* default_left,
    const void* left_child, const void* right_child, int child_code,
    const uint8_t* is_cat, const void* cat_index, int ci_code,
    const void* cat_table, int ct_code, int cat_width, int trees, int nodes,
    int steps, const float* leaf_value, int leaf_slots,
    const float* tree_weight, float avg_denom, int k, int32_t* scratch,
    int threads, int smem_bytes, float* out, cudaStream_t stream) {
  if (feat_code < 0 || feat_code > 2 || ci_code < 0 || ci_code > 2
      || (ct_code != 0 && ct_code != 2) || k < 1)
    return (int)cudaErrorInvalidValue;
  const Forest fo = make_forest(split_feature, feat_code, threshold,
                                default_left, left_child, right_child, na_bin,
                                is_cat, cat_index, ci_code, cat_table, ct_code,
                                cat_width, trees, nodes, steps);
  const BinTables b = make_bins(thresholds, bp, na_bin, zero_bin, cat_values,
                                cp, cat_len);
  return with_unsigned(thr_code, [&](auto tt) {
    return with_signed(child_code, [&](auto tc) {
      return launch_fused<decltype(tt), decltype(tc)>(
          x, n, nf, b, fo, leaf_value, leaf_slots, tree_weight, avg_denom, k,
          scratch, threads, smem_bytes, out, stream);
    });
  });
}

// load the kernels and let every fused instantiation use up to
// `smem_bytes` of dynamic shared memory (the row bins), once, so that no
// launch makes such a call
extern "C" int lgbt_forest_setup(int smem_bytes) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, bin_rows_kernel);
  if (err != 0) return err;
  for (int tc = 0; tc < 3 && err == 0; ++tc) {
    for (int tt = 0; tt < 3 && err == 0; ++tt) {
      err = with_unsigned(tt, [&](auto a) {
        return with_signed(tc, [&](auto c) {
          return (int)cudaFuncSetAttribute(
              fused_kernel<decltype(a), decltype(c)>,
              cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        });
      });
    }
  }
  return err;
}
