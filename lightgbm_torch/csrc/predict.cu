// B4 — tree score update over binned rows.
//
// Replaces the JAX package's lightgbm_tpu/predict_device.py
// `traverse_tree_binned` (:28-69) and `add_tree_score` (:72), which the
// trainer runs once per iteration on every validation set
// (models/gbdt.py `_apply_tree`): each row walks up to `steps` levels of
// one tree over its bins, then `score[r * stride + col] += weight *
// leaf_value[leaf]`.  The column form serves multiclass models, whose
// scores are [N, K] row-major (stride K) and whose tree t adds into
// column t % K; stride 1 and column 0 are the one-column form, with the
// same launches and bits as before the column existed.  The JAX package
// walks class k's tree into a zero vector and then adds it to
// `vscore[:, k]` (models/gbdt.py:2915-2921): at weight 1 that is
// 0 + 1 * v = v exactly, then score + v, the same f32 result as this
// kernel's single update.
// A numerical node sends the NA bin to default_left and other bins left
// iff bin <= threshold; a categorical node (is_cat_node, optional: null
// for a tree without them) never takes the NA branch and goes left iff
// cat_rank[node, bin] <= threshold (cat_rank [nodes, cat_bins]).
// With EFB maps (the JAX package's `efb_maps`, predict_device.py:49-57:
// group_of_feat, off_of_feat and nbm1 = num_bin - 1, each [F]; null
// without EFB) the rows are the bundled [Nv, G] matrix and a node's bin
// is decoded from its feature's bundle column: v = row[group_of_feat[f]],
// then off_of_feat[f] < 0 ? v : (off <= v < off + nbm1 ? v - off + 1 : 0).
// With sparse k-hot rows (B8c: the JAX package's sparse_data.py
// `traverse_tree_sparse` :178 and `add_tree_score_sparse` :204; flat
// [Nv, K] int32 entries f * stride + b, -1 padding, and default_bin [F])
// a node's bin is the row's entry of its feature, else the default bin.
// The three decodes are `row_bin` (rowbin.cuh), shared with B3/B3-K.  On
// k-hot rows the bound is the entries (4 K Nv bytes) and the score: at
// Nv = 200,000, K = 35 about 29.6 MB, 8.8 us.
//
// Bound on this card: bytes.  The walk reads a few bytes of each row, but
// the row-major [Nv, F] matrix is read in 32-byte sectors that span about
// all of it (Nv*F bytes), and score is read and written (8*Nv bytes; in
// the column form the sectors also carry the other columns, so up to
// 64*Nv bytes move for 8*Nv the function needs).  At
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

//
// B4-M — the member axis of the JAX package's fleet program
// (models/gbdt.py `build_fleet_superepoch` :2184, whose vmapped body walks
// each member's tree over the one shared valid matrix): the per-member
// operands (the score, the node tables, the leaf values and the walk's
// level count) come from a `Members` table passed by value, grid.y is the
// member, and the rows, the NA bins and the EFB maps are shared.  Each
// member's threads do what a solo launch's do, so its bits are the solo
// launch's; a solo launch is the case of one member.  Bound: bytes, the
// shared matrix once plus each member's score read and written (8 B a
// row); a first design whose members read the matrix separately (through
// L2 when their blocks run together).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rowbin.cuh"

namespace {

// members of one launch (the table rides in the parameter space, 4 KB)
constexpr int kMaxMembers = 32;

struct Members {
  float* score[kMaxMembers];
  const int32_t* split_feature[kMaxMembers];
  const int32_t* threshold_bin[kMaxMembers];
  const int32_t* default_left[kMaxMembers];
  const int32_t* left_child[kMaxMembers];
  const int32_t* right_child[kMaxMembers];
  const int32_t* is_cat_node[kMaxMembers];
  const int32_t* cat_rank[kMaxMembers];
  const float* leaf_value[kMaxMembers];
  int steps[kMaxMembers];
};

// members [m0, m0 + count) of a host table of 9 x `members` pointers
// (score, split_feature, threshold_bin, default_left, left_child,
// right_child, is_cat_node, cat_rank, leaf_value) and their level counts
Members members_of(const void* const* ptrs, const int* steps, int members,
                   int m0, int count) {
  Members g{};
  for (int i = 0; i < count; ++i) {
    const int m = m0 + i;
    auto p = [&](int row) { return ptrs[row * members + m]; };
    g.score[i] = static_cast<float*>(const_cast<void*>(p(0)));
    g.split_feature[i] = static_cast<const int32_t*>(p(1));
    g.threshold_bin[i] = static_cast<const int32_t*>(p(2));
    g.default_left[i] = static_cast<const int32_t*>(p(3));
    g.left_child[i] = static_cast<const int32_t*>(p(4));
    g.right_child[i] = static_cast<const int32_t*>(p(5));
    g.is_cat_node[i] = static_cast<const int32_t*>(p(6));
    g.cat_rank[i] = static_cast<const int32_t*>(p(7));
    g.leaf_value[i] = static_cast<const float*>(p(8));
    g.steps[i] = steps[m];
  }
  return g;
}

__global__ void tree_score(int stride, int col, const RowBins rows, int n,
                           const int32_t* __restrict__ na_bin, int cat_bins,
                           float weight,
                           const __grid_constant__ Members mem) {
  const int mi = blockIdx.y;
  float* __restrict__ score = mem.score[mi];
  const int32_t* __restrict__ split_feature = mem.split_feature[mi];
  const int32_t* __restrict__ threshold_bin = mem.threshold_bin[mi];
  const int32_t* __restrict__ default_left = mem.default_left[mi];
  const int32_t* __restrict__ left_child = mem.left_child[mi];
  const int32_t* __restrict__ right_child = mem.right_child[mi];
  const int32_t* __restrict__ is_cat_node = mem.is_cat_node[mi];
  const int32_t* __restrict__ cat_rank = mem.cat_rank[mi];
  const float* __restrict__ leaf_value = mem.leaf_value[mi];
  const int steps = mem.steps[mi];
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int node = 0;
  for (int s = 0; s < steps && node >= 0; ++s) {
    const int f = split_feature[node];
    const int v = row_bin(rows, r, f);
    const int nb = na_bin[f];
    bool go_left;
    if (is_cat_node != nullptr && is_cat_node[node] != 0)
      go_left = cat_rank[(long long)node * cat_bins + v] <= threshold_bin[node];
    else
      go_left = (nb >= 0 && v == nb) ? default_left[node] != 0
                                     : v <= threshold_bin[node];
    node = go_left ? left_child[node] : right_child[node];
  }
  // a walk cut short by too few steps ends at leaf 0, never out of bounds
  const int leaf = node < 0 ? ~node : 0;
  float* s = score + r * stride + col;
  *s = __fadd_rn(*s, __fmul_rn(weight, leaf_value[leaf]));
}

int launch_tree_score(int stride, int col, const RowBins& rows, int n,
                      const int32_t* na_bin, int cat_bins, float weight,
                      const Members& g, int count, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, count);
  tree_score<<<grid, threads, 0, stream>>>(stride, col, rows, n, na_bin,
                                           cat_bins, weight, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lgbt_add_tree_score(float* score, int stride, int col,
                                   const uint8_t* binned, int n,
                                   int num_cols,
                                   const int32_t* split_feature,
                                   const int32_t* threshold_bin,
                                   const int32_t* default_left,
                                   const int32_t* left_child,
                                   const int32_t* right_child,
                                   const int32_t* na_bin,
                                   const int32_t* is_cat_node,
                                   const int32_t* cat_rank, int cat_bins,
                                   const int32_t* group_of_feat,
                                   const int32_t* off_of_feat,
                                   const int32_t* nbm1,
                                   const int32_t* flat, int k,
                                   int bin_stride,
                                   const int32_t* default_bin,
                                   const float* leaf_value, float weight,
                                   int steps, cudaStream_t stream) {
  const RowBins rows{binned, num_cols,   group_of_feat, off_of_feat, nbm1,
                     flat,   k,          bin_stride,    default_bin};
  const void* ptrs[9] = {score,      split_feature, threshold_bin,
                         default_left, left_child,  right_child,
                         is_cat_node, cat_rank,     leaf_value};
  return launch_tree_score(stride, col, rows, n, na_bin, cat_bins, weight,
                           members_of(ptrs, &steps, 1, 0, 1), 1, stream);
}

// The member form (B4-M) over one shared row decode and NA table: `ptrs`
// is a host table of 9 x `members` pointers, each row `members` long
// (score, split_feature, threshold_bin, default_left, left_child,
// right_child, is_cat_node, cat_rank, leaf_value, as the solo form takes
// them), `steps` each member's level count; stride, col, cat_bins and
// weight are the members' one value.  Members go out kMaxMembers to a
// launch.
extern "C" int lgbt_add_tree_score_members(
    int stride, int col, const uint8_t* binned, int n, int num_cols,
    const int32_t* na_bin, int cat_bins, const int32_t* group_of_feat,
    const int32_t* off_of_feat, const int32_t* nbm1, const int32_t* flat,
    int k, int bin_stride, const int32_t* default_bin, float weight,
    const void* const* ptrs, const int* steps, int members,
    cudaStream_t stream) {
  if (members < 1) return (int)cudaErrorInvalidValue;
  const RowBins rows{binned, num_cols,   group_of_feat, off_of_feat, nbm1,
                     flat,   k,          bin_stride,    default_bin};
  for (int m0 = 0; m0 < members; m0 += kMaxMembers) {
    const int count =
        members - m0 < kMaxMembers ? members - m0 : kMaxMembers;
    const int err = launch_tree_score(
        stride, col, rows, n, na_bin, cat_bins, weight,
        members_of(ptrs, steps, members, m0, count), count, stream);
    if (err != 0) return err;
  }
  return 0;
}

extern "C" int lgbt_predict_setup() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, tree_score);
}
