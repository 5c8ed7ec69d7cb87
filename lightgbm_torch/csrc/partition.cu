// B3 — row partition of the strict grower.
//
// Replaces the partition step of the JAX package's lightgbm_tpu/grower.py
// `grow_tree` -> `do_split` (the `leaf_of_row` update at :768-792):
//
//     leaf_of_row[n] := new_leaf   where leaf_of_row[n] == leaf and the row
//                                  goes right,
//     go left  <=>  NA bin ? default_left : rank_vec[bin] <= threshold,
//
// with bin = binned[n, feature].  Numerical splits pass the identity rank
// vector; categorical splits (ROADMAP A9) will pass their decision rank and
// na_bin = -1, with no change to this kernel.  It also writes the slot
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void partition_rows(const uint8_t* __restrict__ binned, int n,
                               int num_features,
                               const int32_t* __restrict__ rec,
                               const int32_t* __restrict__ rank_vec,
                               int32_t* __restrict__ leaf_of_row,
                               int32_t* __restrict__ slot) {
  if (rec[7] == 0) return;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int leaf = rec[0], new_leaf = rec[1], feature = rec[2];
  const int threshold = rec[3], default_left = rec[4], na_bin = rec[5];
  const int smaller = rec[6];
  int l = leaf_of_row[r];
  if (l == leaf) {
    const int b = binned[r * num_features + feature];
    const bool is_na = na_bin >= 0 && b == na_bin;
    const bool go_left = is_na ? default_left != 0 : rank_vec[b] <= threshold;
    if (!go_left) {
      l = new_leaf;
      leaf_of_row[r] = l;
    }
  }
  slot[r] = l == smaller ? 0 : -1;
}

}  // namespace

extern "C" int lgbt_partition(const uint8_t* binned, int n, int num_features,
                              const int32_t* rec, const int32_t* rank_vec,
                              int32_t* leaf_of_row, int32_t* slot,
                              cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  partition_rows<<<blocks, threads, 0, stream>>>(
      binned, n, num_features, rec, rank_vec, leaf_of_row, slot);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_partition_setup() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, partition_rows);
}
