// B3s — one split step of the device-resident strict grower.
//
// Replaces the bookkeeping of the JAX package's lightgbm_tpu/grower.py
// `grow_tree` -> `split_step` / `do_split` (:742-906): pick the leaf with
// the largest cached gain (the first on ties, as jnp.argmax), decide
// whether it splits (gain > 0, the tree not done, num_leaves < L), and
// write the split into the tree arrays (Tree::Split, src/io/tree.cpp):
// node i = num_leaves - 1 gets the feature, threshold, default_left and
// gain; the parent's child pointer that named the leaf now names node i;
// node i's children are ~leaf and ~new_leaf; internal value/weight/count
// take the leaf's; both children get their value, weight, count, depth
// and parent; num_leaves grows by one.  A step that cannot split sets the
// tree's `done` flag, which stays set: every later step of the tree is
// inactive and every kernel of that step exits at once (the reference's
// while_loop exit, grower.py:908-915).
//
// It also writes the step record that the rest of the step reads from the
// device, so that no value of the tree ever crosses to the host:
//   rec   int32[8]: leaf, new_leaf, feature, threshold, default_left,
//                   na_bin[feature], smaller child, active (B3, B1, B2)
//   idx   int64[2]: leaf, new_leaf (the rows the torch index ops update;
//                   distinct and in range even when inactive)
//   fstep f32[8]  : the leaf's left/right (g, h, count) sums and its two
//                   child outputs (B2's totals and parent outputs)
//   flags u8[2]   : smaller child is the left one, children may split
//                   further (max_depth)
//
// The tree buffer is int32 words, f32 fields stored by bit pattern, in
// the order of lightgbm_torch/grower.py `TREE_FIELDS` (nn = L - 1):
//   num_leaves[1] done[1] split_feature[nn] threshold_bin[nn]
//   default_left[nn] left_child[nn] right_child[nn] split_gain[nn]
//   internal_value[nn] internal_weight[nn] internal_count[nn]
//   leaf_value[L] leaf_weight[L] leaf_count[L] leaf_depth[L]
//   leaf_parent[L]
//
// Bound on this card: one launch.  The step reads the [L, 12] table
// (1.5 KB at L = 31) and writes a few dozen words.  It is all copies and
// compares, so it equals its plain version (grower.py `grow_step_plain`)
// bit for bit.  Design: one thread does the whole step in order (L is at
// most a few hundred, the argmax is an L-long loop); the launch is the
// cost, which a CUDA graph replay makes a few microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRecord = 12;

__device__ __forceinline__ int32_t as_i(float v) { return __float_as_int(v); }

__global__ void grow_step(const float* __restrict__ table,
                          int32_t* __restrict__ tree,
                          const int32_t* __restrict__ na_bin, int L,
                          int max_depth, int32_t* __restrict__ rec,
                          long long* __restrict__ idx,
                          float* __restrict__ fstep,
                          uint8_t* __restrict__ flags) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const int nn = L - 1;
  int32_t* num_leaves = tree;
  int32_t* done = tree + 1;
  int32_t* split_feature = tree + 2;
  int32_t* threshold_bin = split_feature + nn;
  int32_t* default_left = threshold_bin + nn;
  int32_t* left_child = default_left + nn;
  int32_t* right_child = left_child + nn;
  int32_t* split_gain = right_child + nn;
  int32_t* internal_value = split_gain + nn;
  int32_t* internal_weight = internal_value + nn;
  int32_t* internal_count = internal_weight + nn;
  int32_t* leaf_value = internal_count + nn;
  int32_t* leaf_weight = leaf_value + L;
  int32_t* leaf_count = leaf_weight + L;
  int32_t* leaf_depth = leaf_count + L;
  int32_t* leaf_parent = leaf_depth + L;

  const int nl = *num_leaves;
  int leaf = 0;
  float best = table[0];
  for (int l = 1; l < L; ++l) {
    const float g = table[l * kRecord];
    if (g > best) {
      best = g;
      leaf = l;
    }
  }
  const bool can = *done == 0 && nl < L && best > 0.f;
  const int new_leaf = nl < L ? nl : L - 1;
  idx[0] = leaf;
  idx[1] = new_leaf != leaf ? new_leaf : (leaf + 1) % L;
  rec[0] = leaf;
  rec[1] = new_leaf;
  rec[7] = can ? 1 : 0;
  if (!can) {
    *done = 1;
    for (int c = 2; c < 7; ++c) rec[c] = 0;
    for (int c = 0; c < 8; ++c) fstep[c] = 0.f;
    flags[0] = flags[1] = 0;
    return;
  }
  const float* r = table + leaf * kRecord;
  const int feat = (int)r[1];
  const int thr = (int)r[2];
  const int dleft = r[3] != 0.f ? 1 : 0;
  const float lcount = r[6], rcount = r[9];
  const int i = nl - 1;

  // tree bookkeeping (Tree::Split): re-point the parent at node i
  const int parent = leaf_parent[leaf];
  if (parent >= 0) {
    if (left_child[parent] == ~leaf) left_child[parent] = i;
    if (right_child[parent] == ~leaf) right_child[parent] = i;
  }
  left_child[i] = ~leaf;
  right_child[i] = ~new_leaf;
  split_feature[i] = feat;
  threshold_bin[i] = thr;
  default_left[i] = dleft;
  split_gain[i] = as_i(best);
  internal_value[i] = leaf_value[leaf];
  internal_weight[i] = leaf_weight[leaf];
  internal_count[i] = leaf_count[leaf];
  leaf_value[leaf] = as_i(r[10]);
  leaf_value[new_leaf] = as_i(r[11]);
  leaf_weight[leaf] = as_i(r[5]);
  leaf_weight[new_leaf] = as_i(r[8]);
  leaf_count[leaf] = as_i(lcount);
  leaf_count[new_leaf] = as_i(rcount);
  const int d = leaf_depth[leaf] + 1;
  leaf_depth[leaf] = leaf_depth[new_leaf] = d;
  leaf_parent[leaf] = leaf_parent[new_leaf] = i;
  *num_leaves = nl + 1;

  const bool smaller_left = lcount <= rcount;
  rec[2] = feat;
  rec[3] = thr;
  rec[4] = dleft;
  rec[5] = na_bin[feat];
  rec[6] = smaller_left ? leaf : new_leaf;
  for (int c = 0; c < 8; ++c) fstep[c] = r[4 + c];
  flags[0] = smaller_left ? 1 : 0;
  flags[1] = (max_depth <= 0 || d < max_depth) ? 1 : 0;
}

}  // namespace

extern "C" int lgbt_grow_step(const float* table, int32_t* tree,
                              const int32_t* na_bin, int num_leaves,
                              int max_depth, int32_t* rec, long long* idx,
                              float* fstep, uint8_t* flags,
                              cudaStream_t stream) {
  grow_step<<<1, 32, 0, stream>>>(table, tree, na_bin, num_leaves, max_depth,
                                  rec, idx, fstep, flags);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_grow_step_setup() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, grow_step);
}
