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
//   leaf_parent[L] n_steps[1]
// (n_steps counts the live steps of the tree: the splits here, the live
// super-steps in the batched form below).  With a categorical feature
// (cat_bins = B > 0) two fields follow: is_cat_node[nn] and
// cat_rank[nn, B]; the step then copies the split leaf's is-categorical
// flag and rank row (leaf_cat [rows], leaf_rank [rows, B]: the table's
// companions, the JAX package's `bic`/`brank`) into node i, as the JAX
// step writes `is_cat_node`/`cat_rank` (:903-904), and writes na_bin -1
// into the record of a categorical split (its partition ignores the NA
// bin, :788).  Thread 0 does the bookkeeping; the block copies the rank
// row.
//
// Bound on this card: one launch.  The step reads the [L, 12] table
// (1.5 KB at L = 31) and writes a few dozen words.  It is all copies and
// compares, so it equals its plain version (grower.py `grow_step_plain`)
// bit for bit.  Design: one thread does the whole step in order (L is at
// most a few hundred, the argmax is an L-long loop); the launch is the
// cost, which a CUDA graph replay makes a few microseconds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRecord = 12;
constexpr int kMaxBatch = 256;

// ---------------------------------------------------------------------------
// The split controls' state (optional, `StepCons`; the JAX package's
// grower.py constraint state :126-135 and its updates :819-871,
// :1094-1152).  Each split of a step also does, in the same launch:
//   - monotone ranges (`mono` [F] int8): the leaf's output range [olo,
//     ohi] ([rows] f32; the whole line at the tree's first split, whose
//     leaf is the root) goes to both children, a +1 split capping the
//     left child's high end and raising the right child's low end at
//     mid = 0.5 * (left output + right output) (the already-clipped
//     outputs of the table row), mirrored for -1; categorical splits and
//     features without a constraint pass the range on (`_child_ranges`,
//     :567-577).  The children's ranges and depths also go to clo/chi
//     [C] f32 and cdepth [C] int32, B2's per-child operands;
//   - branch sets (`groups` [G, F] uint8, interaction constraints): the
//     leaf's branch set fallow[leaf] ([rows, F]; empty at the first
//     split) with the split feature goes to both children, and each
//     child's allowed features are the branch set and every group that
//     contains all of it, & feature_mask (`_inter_allowed`, :468-473),
//     into cmask [C, F], B2's and B6-node's per-child mask;
//   - CEGB (`cuse` [F] uint8): the split feature is marked used
//     (:864-868; batched: every valid slot's, :1145-1149), before the
//     children are scanned.
// A batched slot that does not split writes the whole line, depth 0 and
// an empty branch set into its scratch rows and feature_mask into its
// children's masks: their gains are masked, so the values only have to be
// the same in the plain version.  The C children of a step are the K
// leaves, then the K new leaves (K = 1 strict).

struct StepCons {
  const int8_t* mono;      // [F] or null
  float* olo;              // [rows] leaf output ranges (with mono)
  float* ohi;
  float* clo;              // [C] children's ranges (with mono)
  float* chi;
  int32_t* cdepth;         // [C] children's depths (with mono)
  const uint8_t* groups;   // [G, F] or null
  int G, F;
  const uint8_t* fmask;    // [F] feature_mask (with groups)
  uint8_t* fallow;         // [rows, F] branch sets (with groups)
  uint8_t* cmask;          // [C, F] children's allowed masks (with groups)
  uint8_t* cuse;           // [F] used features, or null
};

// a split as the state update reads it
struct SlotSplit {
  int on, leaf, new_leaf, feat, icat, depth;
  float lo, ro;            // the split's child outputs
};

// slot k's ranges and depths (one thread a slot); `first`: the tree's
// first split (the root's state)
__device__ void cons_ranges(const StepCons& c, const SlotSplit& s, int k,
                            int n, bool first) {
  if (c.mono == nullptr) return;
  float l_lo = -INFINITY, l_hi = INFINITY, r_lo = -INFINITY, r_hi = INFINITY;
  int d = 0;
  if (s.on) {
    const float lo_p = first ? -INFINITY : c.olo[s.leaf];
    const float hi_p = first ? INFINITY : c.ohi[s.leaf];
    const int mc = c.mono[s.feat];
    const bool apply = mc != 0 && !s.icat, up = mc > 0;
    const float mid = 0.5f * (s.lo + s.ro);
    l_lo = apply && !up ? fmaxf(lo_p, mid) : lo_p;
    l_hi = apply && up ? fminf(hi_p, mid) : hi_p;
    r_lo = apply && up ? fmaxf(lo_p, mid) : lo_p;
    r_hi = apply && !up ? fminf(hi_p, mid) : hi_p;
    d = s.depth;
  }
  c.olo[s.leaf] = l_lo;
  c.ohi[s.leaf] = l_hi;
  c.olo[s.new_leaf] = r_lo;
  c.ohi[s.new_leaf] = r_hi;
  c.clo[k] = l_lo;
  c.chi[k] = l_hi;
  c.clo[n + k] = r_lo;
  c.chi[n + k] = r_hi;
  c.cdepth[k] = c.cdepth[n + k] = d;
}

// block-wide: the branch sets and allowed masks of n slots' children;
// s_contains: n * G ints of shared memory
__device__ void cons_masks(const StepCons& c, const SlotSplit* sp, int n,
                           bool first, int* s_contains) {
  if (c.groups == nullptr) return;
  const int F = c.F, G = c.G, tid = threadIdx.x, nt = blockDim.x;
  // the children's branch set, staged in the new leaf's row (a fresh or
  // scratch row that no other slot reads)
  for (int j = tid; j < n * F; j += nt) {
    const int k = j / F, f = j % F;
    const SlotSplit& s = sp[k];
    uint8_t b = 0;
    if (s.on)
      b = ((!first && c.fallow[(long long)s.leaf * F + f] != 0) ||
           f == s.feat) ? 1 : 0;
    c.fallow[(long long)s.new_leaf * F + f] = b;
  }
  for (int j = tid; j < n * G; j += nt) s_contains[j] = 1;
  __syncthreads();
  // group g contains the branch unless a branch feature lies outside it
  for (long long j = tid; j < (long long)n * G * F; j += nt) {
    const int k = (int)(j / ((long long)G * F));
    const int g = (int)((j / F) % G), f = (int)(j % F);
    if (c.groups[(long long)g * F + f] == 0 &&
        c.fallow[(long long)sp[k].new_leaf * F + f] != 0)
      s_contains[k * G + g] = 0;
  }
  __syncthreads();
  for (int j = tid; j < n * F; j += nt) {
    const int k = j / F, f = j % F;
    const SlotSplit& s = sp[k];
    const uint8_t br = c.fallow[(long long)s.new_leaf * F + f];
    uint8_t a = c.fmask[f];
    if (s.on) {
      bool any = br != 0;
      for (int g = 0; g < G && !any; ++g)
        any = s_contains[k * G + g] != 0 && c.groups[(long long)g * F + f];
      a = any && c.fmask[f] != 0 ? 1 : 0;
    }
    c.fallow[(long long)s.leaf * F + f] = br;
    c.cmask[(long long)k * F + f] = a;
    c.cmask[(long long)(n + k) * F + f] = a;
  }
}

__device__ __forceinline__ int32_t as_i(float v) { return __float_as_int(v); }

// the bookkeeping of grow_step, one thread; *out_leaf and *out_node are
// set when the step splits and a rank row is to be copied
__device__ void split_node(const float* __restrict__ table,
                           int32_t* __restrict__ tree,
                           const int32_t* __restrict__ na_bin, int L,
                           int max_depth,
                           const int32_t* __restrict__ leaf_cat,
                           int cat_bins, int32_t* __restrict__ rec,
                           long long* __restrict__ idx,
                           float* __restrict__ fstep,
                           uint8_t* __restrict__ flags, int* out_leaf,
                           int* out_node, SlotSplit* sp, int* first) {
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
  int32_t* n_steps = leaf_parent + L;

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
  sp->on = 0;
  *first = nl == 1 ? 1 : 0;
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
  *n_steps += 1;

  bool icat = false;
  if (cat_bins > 0) {
    icat = leaf_cat[leaf] != 0;
    n_steps[1 + i] = icat ? 1 : 0;          // is_cat_node[i]
    *out_leaf = leaf;
    *out_node = i;
  }
  *sp = SlotSplit{1, leaf, new_leaf, feat, icat ? 1 : 0, d, r[10], r[11]};
  const bool smaller_left = lcount <= rcount;
  rec[2] = feat;
  rec[3] = thr;
  rec[4] = dleft;
  rec[5] = icat ? -1 : na_bin[feat];
  rec[6] = smaller_left ? leaf : new_leaf;
  for (int c = 0; c < 8; ++c) fstep[c] = r[4 + c];
  flags[0] = smaller_left ? 1 : 0;
  flags[1] = (max_depth <= 0 || d < max_depth) ? 1 : 0;
}

__global__ void grow_step(const float* __restrict__ table,
                          int32_t* __restrict__ tree,
                          const int32_t* __restrict__ na_bin, int L,
                          int max_depth,
                          const int32_t* __restrict__ leaf_cat,
                          const int32_t* __restrict__ leaf_rank,
                          int cat_bins, StepCons cons,
                          int32_t* __restrict__ rec,
                          long long* __restrict__ idx,
                          float* __restrict__ fstep,
                          uint8_t* __restrict__ flags) {
  extern __shared__ int s_contains[];   // [G]
  __shared__ int s_leaf, s_node, s_first;
  __shared__ SlotSplit s_split;
  const int nn = L - 1;
  int32_t* cat_rank = tree + 2 + 9 * nn + 5 * L + 1 + nn;
  if (threadIdx.x == 0) {
    s_leaf = -1;
    split_node(table, tree, na_bin, L, max_depth, leaf_cat, cat_bins, rec,
               idx, fstep, flags, &s_leaf, &s_node, &s_split, &s_first);
    if (s_split.on) {
      cons_ranges(cons, s_split, 0, 1, s_first != 0);
      if (cons.cuse != nullptr) cons.cuse[s_split.feat] = 1;
    }
  }
  __syncthreads();
  if (s_split.on) cons_masks(cons, &s_split, 1, s_first != 0, s_contains);
  if (cat_bins == 0 || s_leaf < 0) return;
  for (int b = threadIdx.x; b < cat_bins; b += blockDim.x)
    cat_rank[(long long)s_node * cat_bins + b] =
        leaf_rank[(long long)s_leaf * cat_bins + b];
}

// ---------------------------------------------------------------------------
// B3s-K — one super-step of the batched grower.
//
// Replaces the bookkeeping of the JAX package's grower.py
// `grow_tree_batched` -> `super_step` / `do_split` (:999-1028,
// :1158-1210) for K = split_batch:
//   - the top K cached gains over the L real leaves, in lax.top_k's order
//     (larger gain first, the lower leaf index first on ties; a NaN gain
//     ranks as -inf);
//   - valid[k] = gain_k > 0 & k < L - num_leaves & !done, a prefix; when
//     slot 0 is not valid the tree is done and the step is dead.  A
//     super-step that finds the tree already done returns at once: its
//     outputs are those the first dead super-step wrote;
//   - valid slot k splits leaf_k into node num_leaves - 1 + k and new leaf
//     num_leaves + k, with Tree::Split's bookkeeping (the parent's child
//     pointer, children ~leaf/~new_leaf, internal value/weight/count from
//     the leaf, both children's value, weight, count, depth and parent);
//     num_leaves grows by the valid count.
// Each valid slot's writes touch its own leaf, new leaf and node, and at
// most one child pointer of its parent (siblings fix different pointers),
// so thread k does slot k's bookkeeping, reading the leaf's old values
// before it writes; the order of the JAX package's unrolled loop gives
// the same result.  An invalid slot writes nothing into the tree (the JAX
// package writes scratch nodes and leaves past L there, which it slices
// off): its histogram and table rows go to scratch rows past L, leaf
// L + k and new leaf L + K + k (the JAX package uses L + k for both; the
// port keeps the 2K rows of a super-step's updates distinct so that the
// torch index updates are deterministic).
//
// Outputs (the rest of the super-step reads them from the device):
//   recs      int32[K, 8]: leaf, new leaf, feature, threshold,
//                          default_left, na_bin[feature], smaller child,
//                          valid (B3-K)
//   slot_of_leaf int32[L]: k at each valid slot's leaf, else -1 (B3-K)
//   idx2      int64[2K]  : the leaves, then the new leaves (scratch rows
//                          for invalid slots): the hist and table rows
//                          the torch ops update
//   tot2      f32[2K, 3] : left sums, then right sums (B2's totals)
//   po2       f32[2K]    : left outputs, then right outputs (B2's parent
//                          outputs)
//   small_left u8[K]     : the smaller child is the left one
//   keep2     u8[2K]     : the child may split further (valid, max_depth)
//   status    int32[2]   : active (slot 0 valid), valid count
// With a categorical feature (cat_bins = B > 0) each valid slot's node
// takes its leaf's is-categorical flag and rank row (the JAX step's
// `is_cat_node`/`cat_rank` writes, :1206-1207), and a categorical split's
// record has na_bin -1; the block copies the K rank rows after the
// bookkeeping.
//
// Bound on this card: one launch.  It reads L gains (staged in shared
// memory; L^2 / blockDim compares each thread for the ranks) and K table
// rows and writes a few hundred words; all copies and compares, so it equals its plain version
// (grower.py `grow_step_batched_plain`) bit for bit.

__device__ __forceinline__ float rank_key(float g) {
  return g != g ? -__int_as_float(0x7f800000) : g;
}

__global__ void grow_step_batched(const float* __restrict__ table,
                                  int32_t* __restrict__ tree,
                                  const int32_t* __restrict__ na_bin, int L,
                                  int K, int max_depth,
                                  const int32_t* __restrict__ leaf_cat,
                                  const int32_t* __restrict__ leaf_rank,
                                  int cat_bins, StepCons cons,
                                  int32_t* __restrict__ recs,
                                  int32_t* __restrict__ slot_of_leaf,
                                  long long* __restrict__ idx2,
                                  float* __restrict__ tot2,
                                  float* __restrict__ po2,
                                  uint8_t* __restrict__ small_left,
                                  uint8_t* __restrict__ keep2,
                                  int32_t* __restrict__ status) {
  // [K] leaves by rank, then L gains, then K * G containment flags
  extern __shared__ int32_t top[];
  __shared__ SlotSplit s_split[kMaxBatch];
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
  int32_t* n_steps = leaf_parent + L;
  const int tid = threadIdx.x;

  // a tree that was done before this super-step: nothing changes, and the
  // step outputs of the super-step that found it done stay as they are
  if (*done != 0) return;
  // ranks: rank(i) = #{j : key_j > key_i or (key_j == key_i and j < i)},
  // over the L gains staged in shared memory
  float* s_gain = reinterpret_cast<float*>(top + K);
  for (int i = tid; i < L; i += blockDim.x)
    s_gain[i] = rank_key(table[(long long)i * kRecord]);
  __syncthreads();
  for (int i = tid; i < L; i += blockDim.x) {
    const float gi = s_gain[i];
    int rank = 0;
    for (int j = 0; j < L && rank < K; ++j) {
      const float gj = s_gain[j];
      rank += (gj > gi || (gj == gi && j < i)) ? 1 : 0;
    }
    if (rank < K) top[rank] = i;
  }
  for (int i = tid; i < L; i += blockDim.x) slot_of_leaf[i] = -1;
  const int nl = *num_leaves;
  __syncthreads();

  // valid slots are a prefix (gains sorted, the budget a prefix)
  int nvalid = 0;
  while (nvalid < K && nvalid < L - nl &&
           table[(long long)top[nvalid] * kRecord] > 0.f)
      ++nvalid;
  if (tid < K) {
    const int k = tid;
    const bool valid = k < nvalid;
    const float gk = table[(long long)top[k] * kRecord];
    const int leaf = valid ? top[k] : L + k;
    const int new_leaf = valid ? nl + k : L + K + k;
    const float* r = table + (long long)leaf * kRecord;
    int32_t* rec = recs + k * 8;
    idx2[k] = leaf;
    idx2[K + k] = new_leaf;
    for (int c = 0; c < 3; ++c) {
      tot2[k * 3 + c] = r[4 + c];
      tot2[(K + k) * 3 + c] = r[7 + c];
    }
    po2[k] = r[10];
    po2[K + k] = r[11];
    const bool sleft = r[6] <= r[9];
    small_left[k] = sleft ? 1 : 0;
    rec[0] = leaf;
    rec[1] = new_leaf;
    rec[7] = valid ? 1 : 0;
    s_split[k] = SlotSplit{0, leaf, new_leaf, 0, 0, 0, 0.f, 0.f};
    if (!valid) {
      rec[2] = rec[3] = rec[4] = 0;
      rec[5] = -1;
      rec[6] = leaf;
      keep2[k] = keep2[K + k] = 0;
    } else {
      const int feat = (int)r[1];
      const int thr = (int)r[2];
      const int dleft = r[3] != 0.f ? 1 : 0;
      const int node = nl - 1 + k;
      const int parent = leaf_parent[leaf];
      if (parent >= 0) {
        if (left_child[parent] == ~leaf) left_child[parent] = node;
        if (right_child[parent] == ~leaf) right_child[parent] = node;
      }
      left_child[node] = ~leaf;
      right_child[node] = ~new_leaf;
      split_feature[node] = feat;
      threshold_bin[node] = thr;
      default_left[node] = dleft;
      split_gain[node] = as_i(gk);
      internal_value[node] = leaf_value[leaf];
      internal_weight[node] = leaf_weight[leaf];
      internal_count[node] = leaf_count[leaf];
      leaf_value[leaf] = as_i(r[10]);
      leaf_value[new_leaf] = as_i(r[11]);
      leaf_weight[leaf] = as_i(r[5]);
      leaf_weight[new_leaf] = as_i(r[8]);
      leaf_count[leaf] = as_i(r[6]);
      leaf_count[new_leaf] = as_i(r[9]);
      const int d = leaf_depth[leaf] + 1;
      leaf_depth[leaf] = leaf_depth[new_leaf] = d;
      leaf_parent[leaf] = leaf_parent[new_leaf] = node;
      bool icat = false;
      if (cat_bins > 0) {
        icat = leaf_cat[leaf] != 0;
        n_steps[1 + node] = icat ? 1 : 0;   // is_cat_node[node]
      }
      rec[2] = feat;
      rec[3] = thr;
      rec[4] = dleft;
      rec[5] = icat ? -1 : na_bin[feat];
      rec[6] = sleft ? leaf : new_leaf;
      const uint8_t keep = (max_depth <= 0 || d < max_depth) ? 1 : 0;
      keep2[k] = keep2[K + k] = keep;
      slot_of_leaf[leaf] = k;
      s_split[k] = SlotSplit{1, leaf, new_leaf, feat, icat ? 1 : 0, d, r[10],
                             r[11]};
      if (cons.cuse != nullptr) cons.cuse[feat] = 1;
    }
    cons_ranges(cons, s_split[k], k, K, nl == 1);
  }
  __syncthreads();
  cons_masks(cons, s_split, K, nl == 1,
             reinterpret_cast<int*>(top + K) + L);
  if (cat_bins > 0) {
    int32_t* cat_rank = n_steps + 1 + nn;
    for (int j = tid; j < nvalid * cat_bins; j += blockDim.x) {
      const int k = j / cat_bins, b = j % cat_bins;
      cat_rank[(long long)(nl - 1 + k) * cat_bins + b] =
          leaf_rank[(long long)top[k] * cat_bins + b];
    }
  }
  if (tid == 0) {
    status[0] = nvalid > 0 ? 1 : 0;
    status[1] = nvalid;
    if (nvalid > 0) {
      *num_leaves = nl + nvalid;
      *n_steps += 1;
    } else {
      *done = 1;
    }
  }
}

}  // namespace

// The split controls' state (StepCons, each pointer null when off): mono
// [F] int8 with olo/ohi [rows], clo/chi [C] f32 and cdepth [C] int32;
// groups [G, F] uint8 with feature_mask [F], fallow [rows, F] and cmask
// [C, F] uint8; cuse [F] uint8.  G * K must stay within kMaxContains.
constexpr int kMaxContains = 8192;

// leaf_cat [L] and leaf_rank [L, B] may be null (cat_bins 0).
extern "C" int lgbt_grow_step(const float* table, int32_t* tree,
                              const int32_t* na_bin, int num_leaves,
                              int max_depth, const int32_t* leaf_cat,
                              const int32_t* leaf_rank, int cat_bins,
                              const int8_t* mono, float* olo, float* ohi,
                              float* clo, float* chi, int32_t* cdepth,
                              const uint8_t* groups, int G, int F,
                              const uint8_t* fmask, uint8_t* fallow,
                              uint8_t* cmask, uint8_t* cuse, int32_t* rec,
                              long long* idx, float* fstep, uint8_t* flags,
                              cudaStream_t stream) {
  if (groups != nullptr && G > kMaxContains)
    return (int)cudaErrorInvalidValue;
  const StepCons cons{mono, olo, ohi, clo, chi, cdepth, groups, G, F,
                      fmask, fallow, cmask, cuse};
  // a block where the step has per-thread work (the branch sets'
  // containment test, the rank row's copy), else one warp
  const int threads = groups != nullptr || cat_bins > 0 ? 256 : 32;
  const size_t smem = groups != nullptr ? (size_t)G * sizeof(int) : 0;
  grow_step<<<1, threads, smem, stream>>>(table, tree, na_bin, num_leaves,
                                      max_depth, leaf_cat, leaf_rank,
                                      cat_bins, cons, rec, idx, fstep,
                                      flags);
  return (int)cudaGetLastError();
}

// recs [K, 8], slot_of_leaf [L], idx2 [2K], tot2 [2K, 3], po2 [2K],
// small_left [K], keep2 [2K], status [2]; table [L + 2K, 12]; leaf_cat
// [L + 2K] and leaf_rank [L + 2K, B] may be null (cat_bins 0).
extern "C" int lgbt_grow_step_batched(const float* table, int32_t* tree,
                                      const int32_t* na_bin, int num_leaves,
                                      int split_batch, int max_depth,
                                      const int32_t* leaf_cat,
                                      const int32_t* leaf_rank, int cat_bins,
                                      const int8_t* mono, float* olo,
                                      float* ohi, float* clo, float* chi,
                                      int32_t* cdepth, const uint8_t* groups,
                                      int G, int F, const uint8_t* fmask,
                                      uint8_t* fallow, uint8_t* cmask,
                                      uint8_t* cuse,
                                      int32_t* recs, int32_t* slot_of_leaf,
                                      long long* idx2, float* tot2,
                                      float* po2, uint8_t* small_left,
                                      uint8_t* keep2, int32_t* status,
                                      cudaStream_t stream) {
  if (split_batch > kMaxBatch ||
      (groups != nullptr && (long long)G * split_batch > kMaxContains))
    return (int)cudaErrorInvalidValue;
  const StepCons cons{mono, olo, ohi, clo, chi, cdepth, groups, G, F,
                      fmask, fallow, cmask, cuse};
  const int threads = 256;
  const size_t smem = (size_t)split_batch * sizeof(int32_t) +
                      (size_t)num_leaves * sizeof(float) +
                      (groups != nullptr
                           ? (size_t)G * split_batch * sizeof(int) : 0);
  grow_step_batched<<<1, threads, smem, stream>>>(
      table, tree, na_bin, num_leaves, split_batch, max_depth, leaf_cat,
      leaf_rank, cat_bins, cons, recs, slot_of_leaf, idx2, tot2, po2,
      small_left, keep2, status);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_grow_step_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, grow_step);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, grow_step_batched);
}
