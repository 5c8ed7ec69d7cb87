// B3 — row partition of the strict grower.
//
// Replaces the partition step of the JAX package's lightgbm_tpu/grower.py
// `grow_tree` -> `do_split` (the `leaf_of_row` update at :768-792):
//
//     leaf_of_row[n] := new_leaf   where leaf_of_row[n] == leaf and the row
//                                  goes right,
//     go left  <=>  NA bin ? default_left : rank[bin] <= threshold,
//
// with bin = binned[n, feature].  Without a categorical feature every
// split reads one identity rank vector (rank_stride 0).  With one, rank is
// the grower's per-leaf table [R, B] (rank_stride B) and the split reads
// the row of its leaf: the identity for a numerical split, the decision
// rank of the chosen subset for a categorical one (the JAX package's
// `rank_vec = st.brank[leaf]`, :758), whose record has na_bin = -1 (a
// categorical split never takes the NA branch, :788).  It also writes the slot
// vector of the next histogram pass, slot[n] = (leaf_of_row[n] == smaller)
// ? 0 : -1, which the JAX package computes as a separate elementwise pass.
// It updates leaf_of_row in place (the JAX program writes a new array).
//
// The split comes from the device step record that the split-step kernel
// (B3s, grow_step.cu) writes: rec = (leaf, new_leaf, feature, threshold,
// default_left, na_bin, smaller, active), int32.  Nothing of the split is
// passed from the host, so a tree's steps run without a host round trip
// and can be captured in a CUDA graph.  An inactive step (active = 0: the
// tree is done) returns at once and writes nothing; the histogram pass of
// that step reads no slot either.
//
// Bound on this card: bytes.  One thread per row reads one byte of the
// row-major [N, F] matrix, so its 32-byte sectors span about the whole
// matrix (N*F bytes), plus leaf_of_row read and written (8*N bytes) and
// slot written (4*N bytes).  At the main path (N = 1,000,000, F = 28)
// that is 28 + 8 + 4 = 40 MB, about 12 us at 3.35 TB/s.  Reading the
// column only for rows of the split leaf saves sectors as trees deepen.

// With EFB (the JAX package's do_split, :771-785, and batched :1035-1050)
// the matrix is the bundled [N, G] one and the feature's bin is decoded
// from its bundle column before the test: col = binned[n, group_of_feat[
// feature]], and for a bundled feature (off_of_feat[feature] >= 0) bin =
// off <= col < off + num_bin[feature] - 1 ? col - off + 1 : 0; a
// singleton's column is its bin.  The NA test and the rank lookup read the
// decoded bin.  Null maps keep the unbundled path (the column is the
// feature).

// With sparse k-hot rows (B8b; the JAX package's do_split :772-773 and
// batched :1036-1037, which read sparse_data.py `column` and
// `column_per_row`) the rows are the [N, K] int32 entries f * stride + b
// and the feature's bin is the matching entry's, or the feature's default
// bin when the row stores none.  The decode of all three layouts is
// `row_bin` (rowbin.cuh), shared with B4.  A k-hot row is read only for
// the rows of a splitting leaf: at N = 1M, K = 35 the root's split reads
// 140 MB of entries plus 12 bytes a row, about 45 us at 3.35 TB/s.

// B3-K — the batched grower's partition (grower.py `grow_tree_batched`
// :1029-1067): one pass applies the K splits of a super-step.  The row's
// slot is slot_of_leaf[leaf_of_row[r]] (the table the batched split step
// B3s-K writes, -1 for leaves that do not split); for slot k >= 0 the row
// takes record k's split (records of 8 int32 as above: leaf, new leaf,
// feature, threshold, default_left, na_bin, smaller child, valid), and its
// target slot for the K-slot histogram pass (B1-K) is k if it ends in
// slot k's smaller child, else -1.  status[0] == 0 (a dead super-step)
// returns at once and writes nothing.  The rank row of slot k is the row
// of its leaf (recs[k, 0]) in the per-leaf table, as the JAX package's
// `rank_k = st.brank[leaf_sel]` (:1024).  Bound: bytes, as B3 (the matrix's
// sectors, leaf_of_row read and written, the target slots written, and
// slot_of_leaf gathers from L1), about 40 MB at the main path.

// B3-M and B3-K-M — the member axis of the JAX package's fleet program
// (models/gbdt.py `build_fleet_superepoch` :2184): N members that share
// one binned matrix (the row decode `RowBins`, EFB maps included) each
// partition their own rows by their own step record.  The per-member
// operands (the record or records, slot_of_leaf, status, the rank table,
// leaf_of_row and the slot output) come from a `Members` table passed by
// value, and grid.y is the member; each member's threads do what a solo
// launch's do, so its bits are the solo launch's, and a solo launch is
// the case of one member.  A member whose step is dead (active 0, or
// status[0] 0) exits at once.  Bound: bytes, the shared matrix's sectors
// once plus each member's 12 B a row; a first design whose members read
// the matrix separately (through L2 when their blocks run together).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rowbin.cuh"

namespace {

// members of one launch (the table rides in the parameter space, 4 KB)
constexpr int kMaxMembers = 32;

struct Members {
  const int32_t* recs[kMaxMembers];
  const int32_t* slot_of_leaf[kMaxMembers];
  const int32_t* status[kMaxMembers];
  const int32_t* rank[kMaxMembers];
  int32_t* leaf_of_row[kMaxMembers];
  int32_t* slot[kMaxMembers];
};

// members [m0, m0 + count) of a host table of 6 x `members` pointers
// (recs, slot_of_leaf, status, rank, leaf_of_row, slot)
Members members_of(const void* const* ptrs, int members, int m0,
                   int count) {
  Members g{};
  for (int i = 0; i < count; ++i) {
    const int m = m0 + i;
    g.recs[i] = static_cast<const int32_t*>(ptrs[0 * members + m]);
    g.slot_of_leaf[i] = static_cast<const int32_t*>(ptrs[1 * members + m]);
    g.status[i] = static_cast<const int32_t*>(ptrs[2 * members + m]);
    g.rank[i] = static_cast<const int32_t*>(ptrs[3 * members + m]);
    g.leaf_of_row[i] =
        static_cast<int32_t*>(const_cast<void*>(ptrs[4 * members + m]));
    g.slot[i] = static_cast<int32_t*>(const_cast<void*>(ptrs[5 * members + m]));
  }
  return g;
}

__global__ void partition_rows(const RowBins rows, int n,
                               const __grid_constant__ Members mem,
                               int rank_stride) {
  const int mi = blockIdx.y;
  const int32_t* __restrict__ rec = mem.recs[mi];
  if (rec[7] == 0) return;
  const int32_t* __restrict__ rank = mem.rank[mi];
  int32_t* __restrict__ leaf_of_row = mem.leaf_of_row[mi];
  int32_t* __restrict__ slot = mem.slot[mi];
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int leaf = rec[0], new_leaf = rec[1], feature = rec[2];
  const int threshold = rec[3], default_left = rec[4], na_bin = rec[5];
  const int smaller = rec[6];
  int l = leaf_of_row[r];
  if (l == leaf) {
    const int b = row_bin(rows, r, feature);
    const bool is_na = na_bin >= 0 && b == na_bin;
    const bool go_left =
        is_na ? default_left != 0
              : rank[(long long)leaf * rank_stride + b] <= threshold;
    if (!go_left) {
      l = new_leaf;
      leaf_of_row[r] = l;
    }
  }
  slot[r] = l == smaller ? 0 : -1;
}

__global__ void partition_slots(const RowBins rows, int n,
                                const __grid_constant__ Members mem,
                                int rank_stride) {
  const int mi = blockIdx.y;
  if (mem.status[mi][0] == 0) return;
  const int32_t* __restrict__ recs = mem.recs[mi];
  const int32_t* __restrict__ slot_of_leaf = mem.slot_of_leaf[mi];
  const int32_t* __restrict__ rank = mem.rank[mi];
  int32_t* __restrict__ leaf_of_row = mem.leaf_of_row[mi];
  int32_t* __restrict__ tslot = mem.slot[mi];
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int l = leaf_of_row[r];
  const int k = slot_of_leaf[l];
  if (k < 0) {
    tslot[r] = -1;
    return;
  }
  const int32_t* rec = recs + k * 8;
  const int b = row_bin(rows, r, rec[2]);
  const int na_bin = rec[5];
  const bool is_na = na_bin >= 0 && b == na_bin;
  const bool go_left =
      is_na ? rec[4] != 0
            : rank[(long long)rec[0] * rank_stride + b] <= rec[3];
  if (!go_left) {
    l = rec[1];
    leaf_of_row[r] = l;
  }
  tslot[r] = l == rec[6] ? k : -1;
}

int launch_partition(const RowBins& rows, int n, const Members& g,
                     int count, int rank_stride, bool slots,
                     cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, count);
  if (slots)
    partition_slots<<<grid, threads, 0, stream>>>(rows, n, g, rank_stride);
  else
    partition_rows<<<grid, threads, 0, stream>>>(rows, n, g, rank_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// binned [N, num_cols] (null for k-hot rows); rank [B] (rank_stride 0)
// or [R, B] (rank_stride B, indexed by the split's leaf); group_of_feat,
// off_of_feat and nbm1 [F] (all null without EFB); flat [N, k] with
// stride and default_bin [F] (all null or 0 for dense rows).
extern "C" int lgbt_partition(const uint8_t* binned, int n, int num_cols,
                              const int32_t* rec, const int32_t* rank,
                              int rank_stride, const int32_t* group_of_feat,
                              const int32_t* off_of_feat,
                              const int32_t* nbm1, const int32_t* flat,
                              int k, int stride, const int32_t* default_bin,
                              int32_t* leaf_of_row, int32_t* slot,
                              cudaStream_t stream) {
  const RowBins rows{binned, num_cols, group_of_feat, off_of_feat, nbm1,
                     flat,   k,        stride,        default_bin};
  const void* ptrs[6] = {rec, nullptr, nullptr, rank, leaf_of_row, slot};
  return launch_partition(rows, n, members_of(ptrs, 1, 0, 1), 1,
                          rank_stride, false, stream);
}

extern "C" int lgbt_partition_slots(const uint8_t* binned, int n,
                                    int num_cols, const int32_t* recs,
                                    const int32_t* slot_of_leaf,
                                    const int32_t* status,
                                    const int32_t* rank, int rank_stride,
                                    const int32_t* group_of_feat,
                                    const int32_t* off_of_feat,
                                    const int32_t* nbm1,
                                    const int32_t* flat, int k, int stride,
                                    const int32_t* default_bin,
                                    int32_t* leaf_of_row, int32_t* tslot,
                                    cudaStream_t stream) {
  const RowBins rows{binned, num_cols, group_of_feat, off_of_feat, nbm1,
                     flat,   k,        stride,        default_bin};
  const void* ptrs[6] = {recs, slot_of_leaf, status, rank, leaf_of_row,
                         tslot};
  return launch_partition(rows, n, members_of(ptrs, 1, 0, 1), 1,
                          rank_stride, true, stream);
}

// The member forms (B3-M with `slots` 0, B3-K-M with 1) over one shared
// row decode: `ptrs` is a host table of 6 x `members` pointers, each row
// `members` long: the record (B3-M) or records (B3-K-M), slot_of_leaf and
// status (null for B3-M), the rank table, leaf_of_row and the slot
// output, each as the solo form takes it; rank_stride is the members'
// one stride.  Members go out kMaxMembers to a launch.
extern "C" int lgbt_partition_members(
    const uint8_t* binned, int n, int num_cols, const void* const* ptrs,
    int members, int slots, int rank_stride, const int32_t* group_of_feat,
    const int32_t* off_of_feat, const int32_t* nbm1, const int32_t* flat,
    int k, int stride, const int32_t* default_bin, cudaStream_t stream) {
  if (members < 1) return (int)cudaErrorInvalidValue;
  const RowBins rows{binned, num_cols, group_of_feat, off_of_feat, nbm1,
                     flat,   k,        stride,        default_bin};
  for (int m0 = 0; m0 < members; m0 += kMaxMembers) {
    const int count =
        members - m0 < kMaxMembers ? members - m0 : kMaxMembers;
    const int err =
        launch_partition(rows, n, members_of(ptrs, members, m0, count),
                         count, rank_stride, slots != 0, stream);
    if (err != 0) return err;
  }
  return 0;
}

extern "C" int lgbt_partition_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, partition_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, partition_slots);
}
