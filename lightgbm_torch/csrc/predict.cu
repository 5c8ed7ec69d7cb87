// B4 — tree score update over binned rows.
//
// Replaces the JAX package's lightgbm_tpu/predict_device.py
// `traverse_tree_binned` and `add_tree_score` (numerical nodes), which
// the trainer runs once per iteration on every validation set
// (models/gbdt.py `_apply_tree`): each row walks up to `steps` levels of
// one tree over its bins (NA bin -> default_left, else bin <= threshold),
// then `score[n] += weight * leaf_value[leaf]`.
//
// Bound on this card: bytes.  The walk reads a few bytes of each row, but
// the row-major [Nv, F] matrix is read in 32-byte sectors that span about
// all of it (Nv*F bytes), and score is read and written (8*Nv bytes).  At
// the main path (Nv = 200,000, F = 28) that is 5.6 + 1.6 = 7.2 MB, about
// 2 us at 3.35 TB/s; the node tables (a few hundred bytes) stay in cache.
//
// The node tables are the grower's device tree arrays as it leaves them
// (int32 each, default_left too) and the leaf values the trainer's f32
// shrinkage wrote on the device: nothing of the tree is uploaded from the
// host.  Inside a captured iteration `steps` is the configuration's worst
// case (utils/shapes.py `traversal_steps`); a row stops at its leaf, so
// surplus steps cost nothing and change no result.
//
// Design: one thread per row, which stops walking at its leaf.  The update
// is written __fadd_rn(score, __fmul_rn(weight, value)) so that nvcc cannot
// contract it into an FMA: the plain PyTorch version (a multiply, then an
// add) then agrees bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tree_score(float* __restrict__ score,
                           const uint8_t* __restrict__ binned, int n,
                           int num_features,
                           const int32_t* __restrict__ split_feature,
                           const int32_t* __restrict__ threshold_bin,
                           const int32_t* __restrict__ default_left,
                           const int32_t* __restrict__ left_child,
                           const int32_t* __restrict__ right_child,
                           const int32_t* __restrict__ na_bin,
                           const float* __restrict__ leaf_value, float weight,
                           int steps) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const uint8_t* row = binned + r * num_features;
  int node = 0;
  for (int s = 0; s < steps && node >= 0; ++s) {
    const int f = split_feature[node];
    const int v = row[f];
    const int nb = na_bin[f];
    const bool go_left = (nb >= 0 && v == nb) ? default_left[node] != 0
                                              : v <= threshold_bin[node];
    node = go_left ? left_child[node] : right_child[node];
  }
  // a walk cut short by too few steps ends at leaf 0, never out of bounds
  const int leaf = node < 0 ? ~node : 0;
  score[r] = __fadd_rn(score[r], __fmul_rn(weight, leaf_value[leaf]));
}

}  // namespace

extern "C" int lgbt_add_tree_score(float* score, const uint8_t* binned, int n,
                                   int num_features,
                                   const int32_t* split_feature,
                                   const int32_t* threshold_bin,
                                   const int32_t* default_left,
                                   const int32_t* left_child,
                                   const int32_t* right_child,
                                   const int32_t* na_bin,
                                   const float* leaf_value, float weight,
                                   int steps, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  tree_score<<<blocks, threads, 0, stream>>>(
      score, binned, n, num_features, split_feature, threshold_bin,
      default_left, left_child, right_child, na_bin, leaf_value, weight,
      steps);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_predict_setup() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, tree_score);
}
