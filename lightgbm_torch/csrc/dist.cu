// B16a — the best-split select of the sharded learners.
//
// Replaces the device program around the best-split all-gather of the
// JAX package's sharded learners: `ops/split.py` `gather_best` (:105)
// with `globalize_feature` (:92), called by `parallel/data_parallel.py`
// `select_best` (:274-276) and `parallel/feature_parallel.py`
// `select_best` (:111-117).  After the all-gather every rank holds the S
// ranks' best-split records of C children (the strict grower's pair, 2K
// children of a batched super-step, or the root's one), each naming its
// winner by the rank's local scan slot.  Per child:
//
//   - map each rank's slot to its global feature: through the owner
//     plan's slot map `shard_feat` [S, fmax] (a pad slot, -1, clamps to
//     feature 0, as `jnp.maximum(jnp.take(gfid, f), 0)`), or, with no
//     map, by the offset `slot + s * f_local` (feature-parallel's
//     contiguous slices);
//   - pick the winner among the S records: the largest gain, ties to the
//     lowest global feature id, then to the lowest rank (`jnp.argmin`'s
//     first index); where no gain equals the maximum (NaN) rank 0;
//   - write the winner's record with its global feature, its
//     is-categorical flag and its [B] rank row.
//
// Design: one block a child, thread 0 scans the S records (S is the
// process group's size, a handful) and the block copies the winner's
// record and rank row.  `active` is the grower's step flag: where it is 0
// nothing is written (the records are a dead step's).  Bound: bytes, the
// gathered records and rank rows read once and the winner's written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// split record columns (lightgbm_torch/ops/split.py)
constexpr int kGain = 0;
constexpr int kFeature = 1;

__device__ __forceinline__ int global_feature(const float* rec, int s,
                                              const int32_t* shard_feat,
                                              int fmax, int f_local) {
  int local = (int)rec[kFeature];
  if (shard_feat == nullptr) return local + s * f_local;
  local = local < 0 ? 0 : (local >= fmax ? fmax - 1 : local);
  const int g = shard_feat[s * fmax + local];
  return g < 0 ? 0 : g;
}

__global__ void gather_best_kernel(const float* __restrict__ recs,
                                   const int32_t* __restrict__ cat,
                                   const int32_t* __restrict__ rank, int S,
                                   int C, int R, int B,
                                   const int32_t* __restrict__ shard_feat,
                                   int fmax, int f_local,
                                   const int32_t* __restrict__ active,
                                   float* __restrict__ out_rec,
                                   int32_t* __restrict__ out_cat,
                                   int32_t* __restrict__ out_rank) {
  if (active != nullptr && active[0] == 0) return;
  const int c = blockIdx.x;
  __shared__ int win, gwin;
  if (threadIdx.x == 0) {
    float best = recs[(size_t)c * R + kGain];
    for (int s = 1; s < S; ++s) {
      const float g = recs[((size_t)s * C + c) * R + kGain];
      // jnp.max: NaN wins
      if (g > best || g != g) best = g;
    }
    int w = -1, gw = 1 << 30;
    for (int s = 0; s < S; ++s) {
      const float* r = recs + ((size_t)s * C + c) * R;
      if (r[kGain] == best) {
        const int gf = global_feature(r, s, shard_feat, fmax, f_local);
        if (gf < gw) {
          gw = gf;
          w = s;
        }
      }
    }
    if (w < 0) {
      w = 0;
      gw = global_feature(recs + (size_t)c * R, 0, shard_feat, fmax,
                          f_local);
    }
    win = w;
    gwin = gw;
  }
  __syncthreads();
  const float* src = recs + ((size_t)win * C + c) * R;
  for (int j = threadIdx.x; j < R; j += blockDim.x)
    out_rec[(size_t)c * R + j] = j == kFeature ? (float)gwin : src[j];
  if (cat != nullptr && threadIdx.x == 0)
    out_cat[c] = cat[(size_t)win * C + c];
  if (rank != nullptr) {
    const int32_t* rs = rank + ((size_t)win * C + c) * B;
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      out_rank[(size_t)c * B + b] = rs[b];
  }
}

}  // namespace

// recs [S, C, R] f32 records (R = 12 columns); cat [S, C] int32 and rank
// [S, C, B] int32, or both null; shard_feat [S, fmax] int32 (the owner
// plan) or null (then the offset slot + s * f_local); active [1] int32 or
// null; out_rec [C, R], out_cat [C], out_rank [C, B].
extern "C" int lgbt_gather_best(const float* recs, const int32_t* cat,
                                const int32_t* rank, int S, int C, int R,
                                int B, const int32_t* shard_feat, int fmax,
                                int f_local, const int32_t* active,
                                float* out_rec, int32_t* out_cat,
                                int32_t* out_rank, cudaStream_t stream) {
  if (S < 1 || C < 1 || R < 2) return (int)cudaErrorInvalidValue;
  if (shard_feat != nullptr && fmax < 1) return (int)cudaErrorInvalidValue;
  gather_best_kernel<<<C, kThreads, 0, stream>>>(
      recs, cat, rank, S, C, R, B, shard_feat, fmax, f_local, active,
      out_rec, out_cat, out_rank);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_dist_setup() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, gather_best_kernel);
}
