// The bin of feature f in row r of the trainer's binned rows, in each of
// the three layouts the row partition (B3/B3-K, partition.cu) and the
// tree walk (B4, predict.cu) read:
//
// - dense: the row-major [N, num_cols] uint8 matrix, column f;
// - EFB bundles (group_of_feat non-null; the JAX package's do_split,
//   grower.py:778-785, and predict_device.py:49-57): the bundled [N, G]
//   matrix, v = row[group_of_feat[f]], then off_of_feat[f] < 0 ? v :
//   (off <= v < off + nbm1[f] ? v - off + 1 : 0), nbm1 = num_bin - 1;
// - sparse k-hot rows (flat non-null; B8b/B8c, the JAX package's
//   sparse_data.py `column`/`column_per_row` :86-105): flat[r, j] = f' *
//   stride + b or -1 padding, K entries a row; the bin is the sum of the
//   matching entries' bins (a row stores a feature at most once) if any
//   entry of feature f is stored, else default_bin[f].  Every entry is
//   read: nothing assumes their order.

#ifndef LGBT_ROWBIN_CUH
#define LGBT_ROWBIN_CUH

#include <stdint.h>

struct RowBins {
  const uint8_t* binned;  // dense or bundled rows (null for k-hot rows)
  int num_cols;
  const int32_t* group_of_feat;  // EFB maps, null without bundles
  const int32_t* off_of_feat;
  const int32_t* nbm1;
  const int32_t* flat;  // k-hot rows, null for dense ones
  int k;
  int stride;
  const int32_t* default_bin;
};

__device__ __forceinline__ int row_bin(const RowBins& m, long long r,
                                       int f) {
  if (m.flat != nullptr) {
    const int32_t* e = m.flat + r * m.k;
    const int lo = f * m.stride;
    int sum = 0;
    bool hit = false;
    for (int j = 0; j < m.k; ++j) {
      const int v = e[j];
      if (v >= lo && v < lo + m.stride) {
        sum += v - lo;
        hit = true;
      }
    }
    return hit ? sum : m.default_bin[f];
  }
  const uint8_t* row = m.binned + r * m.num_cols;
  if (m.group_of_feat == nullptr) return row[f];
  const int v = row[m.group_of_feat[f]];
  const int off = m.off_of_feat[f];
  if (off < 0) return v;
  return (v >= off && v < off + m.nbm1[f]) ? v - off + 1 : 0;
}

#endif  // LGBT_ROWBIN_CUH
