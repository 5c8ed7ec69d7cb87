// B16b and B16c — the PV-tree vote of the voting-parallel learner.
//
// Replace the device program around the vote's collectives in the JAX
// package's `parallel/voting_parallel.py` (the reference's
// VotingParallelTreeLearner, voting_parallel_tree_learner.cpp:150-181).
//
// B16b `_local_feature_gains` (:55-84), the local `lax.top_k` (:132) and
// the vote one-hot (:133): from this rank's histogram [F, B, 3] (f32, or
// int32 under quantized training with the iteration's scales folded in
// as B7c dequantizes: float(h) * scale[c]), per feature the prefix sums
// over the B bins (in bin order, f32), and for every bin the L1/L2 gain
// tl1(gl)^2 / (hl + l2 + 1e-10) + tl1(gr)^2 / (hr + l2 + 1e-10) of the
// split "bins <= b left", valid where both sides hold at least `md`
// (min_data_in_leaf / S, at least 1, less 0.5) rows and `mh`
// (min_sum_hessian / S) hessian; the feature's gain is the maximum (-inf
// where no bin is valid).  Then the local top-k (ties to the lower
// index, as `lax.top_k`) as a [F] f32 vote vector of ones and zeros, and
// the gains with -inf (and NaN) as 0, the two vectors the ranks
// all-reduce.  Design: one block a feature; thread 0 forms the prefix
// sums in shared memory (so their rounding is the plain version's
// sequential sum), the threads evaluate the bins and reduce the maximum;
// then one block ranks the F gains (each thread counts the features
// ahead of its own) for the vote.  Bound: bytes, the histogram read once.
//
// B16c `vote_reduce` (:137-148), after the votes and gains are
// all-reduced: score = votes * 1e12 + gain_sum (f32), the top 2k of it
// (ties to the lower index), and the histogram rows of every other
// feature zeroed in place, before the histogram all-reduce (f32 or
// int32).  Design: one block a feature ranks its score against all F and
// zeroes its own [B, 3] rows when it is not selected.  Bound: bytes, the
// two vectors and the zeroed rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 1024;

template <typename T>
__device__ __forceinline__ float chan(const T* h, long long i,
                                      const float* scales, int c) {
  return (float)h[i];
}

template <>
__device__ __forceinline__ float chan<int32_t>(const int32_t* h, long long i,
                                               const float* scales, int c) {
  return __fmul_rn((float)h[i], scales[c]);
}

__device__ __forceinline__ float tl1(float g, float l1, int use_l1) {
  if (!use_l1) return g;
  const float s = g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f);
  return s * fmaxf(fabsf(g) - l1, 0.f);
}

template <typename T>
__global__ void vote_gains_kernel(const T* __restrict__ hist,
                                  const float* __restrict__ scales, int F,
                                  int B, float md, float mh, float l1,
                                  int use_l1, float l2,
                                  float* __restrict__ gains) {
  __shared__ float cum[3][kMaxBins];
  __shared__ float red[kThreads];
  const int f = blockIdx.x;
  const T* h = hist + (long long)f * B * 3;
  if (threadIdx.x == 0) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int b = 0; b < B; ++b) {
      s0 = s0 + chan<T>(h, (long long)b * 3, scales, 0);
      s1 = s1 + chan<T>(h, (long long)b * 3 + 1, scales, 1);
      s2 = s2 + chan<T>(h, (long long)b * 3 + 2, scales, 2);
      cum[0][b] = s0;
      cum[1][b] = s1;
      cum[2][b] = s2;
    }
  }
  __syncthreads();
  const float tg = cum[0][B - 1], th = cum[1][B - 1], tc = cum[2][B - 1];
  const float eps = 1e-10f;
  float best = -INFINITY;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float gl = cum[0][b], hl = cum[1][b], cl = cum[2][b];
    const float gr = tg - gl, hr = th - hl, cr = tc - cl;
    const float a = tl1(gl, l1, use_l1), c = tl1(gr, l1, use_l1);
    const float gain = a * a / (hl + l2 + eps) + c * c / (hr + l2 + eps);
    const bool valid = cl >= md && cr >= md && hl >= mh && hr >= mh;
    const float g = valid ? gain : -INFINITY;
    if (g > best || g != g) best = g;
  }
  red[threadIdx.x] = best;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      const float o = red[threadIdx.x + w];
      if (o > red[threadIdx.x] || o != o) red[threadIdx.x] = o;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) gains[f] = red[0];
}

// rank of x[f] among x[0..F): the features with a larger value, or an
// equal one at a lower index (lax.top_k's order)
__device__ __forceinline__ int rank_of(const float* x, int F, int f) {
  const float v = x[f];
  int r = 0;
  for (int j = 0; j < F; ++j) {
    const float u = x[j];
    r += (u > v) || (u == v && j < f);
  }
  return r;
}

__global__ void vote_topk_kernel(const float* __restrict__ gains, int F,
                                 int k, float* __restrict__ votes,
                                 float* __restrict__ finite) {
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    votes[f] = rank_of(gains, F, f) < k ? 1.f : 0.f;
    const float g = gains[f];
    finite[f] = isfinite(g) ? g : 0.f;
  }
}

template <typename T>
__global__ void vote_select_kernel(const float* __restrict__ votes,
                                   const float* __restrict__ gain_sum,
                                   int F, int B, int k2,
                                   T* __restrict__ hist) {
  __shared__ int count[kThreads];
  const int f = blockIdx.x;
  const float v = __fadd_rn(__fmul_rn(votes[f], 1e12f), gain_sum[f]);
  int r = 0;
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    const float u = __fadd_rn(__fmul_rn(votes[j], 1e12f), gain_sum[j]);
    r += (u > v) || (u == v && j < f);
  }
  count[threadIdx.x] = r;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) count[threadIdx.x] += count[threadIdx.x + w];
    __syncthreads();
  }
  if (count[0] < k2) return;
  T* h = hist + (long long)f * B * 3;
  for (int i = threadIdx.x; i < B * 3; i += blockDim.x) h[i] = (T)0;
}

}  // namespace

// hist [F, B, 3]: f32 (scales null) or int32 (scales [3] f32); md, mh, l1,
// l2 the rescaled constraints and regularisers (use_l1 = l1 > 0); gains
// [F] f32 scratch; votes, finite [F] f32 out.  1 <= k <= F, B <= 1024.
extern "C" int lgbt_vote_gains(const void* hist, const float* scales, int F,
                               int B, float md, float mh, float l1, float l2,
                               int k, float* gains, float* votes,
                               float* finite, cudaStream_t stream) {
  if (F < 1 || B < 1 || B > kMaxBins || k < 1 || k > F)
    return (int)cudaErrorInvalidValue;
  const int use_l1 = l1 > 0.f;
  if (scales == nullptr)
    vote_gains_kernel<float><<<F, kThreads, 0, stream>>>(
        static_cast<const float*>(hist), nullptr, F, B, md, mh, l1, use_l1,
        l2, gains);
  else
    vote_gains_kernel<int32_t><<<F, kThreads, 0, stream>>>(
        static_cast<const int32_t*>(hist), scales, F, B, md, mh, l1, use_l1,
        l2, gains);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vote_topk_kernel<<<1, kThreads, 0, stream>>>(gains, F, k, votes, finite);
  return (int)cudaGetLastError();
}

// votes, gain_sum [F] f32 (all-reduced); hist [F, B, 3] f32 (is_int 0) or
// int32 (is_int 1), in place.  1 <= k2 <= F.
extern "C" int lgbt_vote_select(const float* votes, const float* gain_sum,
                                int F, int B, int k2, void* hist, int is_int,
                                cudaStream_t stream) {
  if (F < 1 || B < 1 || k2 < 1 || k2 > F) return (int)cudaErrorInvalidValue;
  if (is_int)
    vote_select_kernel<int32_t><<<F, kThreads, 0, stream>>>(
        votes, gain_sum, F, B, k2, static_cast<int32_t*>(hist));
  else
    vote_select_kernel<float><<<F, kThreads, 0, stream>>>(
        votes, gain_sum, F, B, k2, static_cast<float*>(hist));
  return (int)cudaGetLastError();
}

extern "C" int lgbt_vote_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, vote_gains_kernel<float>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&attr, vote_gains_kernel<int32_t>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&attr, vote_topk_kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&attr, vote_select_kernel<float>);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, vote_select_kernel<int32_t>);
}
