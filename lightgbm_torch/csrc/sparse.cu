// B8a — the histogram of sparse binned storage (the padded k-hot layout).
//
// Replaces the JAX package's lightgbm_tpu/sparse_data.py `histogram`
// (:108-175): the rows' stored entries flat[n, j] = f * stride + b (or -1
// padding) scatter their vals (grad*w, hess*w, w) into cell (slot, f, b),
// and each feature's default bin (the bin of the absent value, never
// stored) then receives the slot's total minus the feature's stored mass
// (the reference's FixHistogram, dataset.cpp:1292).  Three forms, as the
// dense B1/B1-K (csrc/histogram.cu): no slot vector (every row, the root
// pass); a slot vector whose rows >= 0 form one histogram (the strict
// grower's smaller child, num_slots 0 here); and K slots (num_slots K,
// rows in [0, K) each to their slot; the batched grower).  Output [S, F,
// num_bins, 3] f32; an `active` flag of 0 (a dead step) makes every
// kernel return at once (the output is then unspecified).
//
// Deterministic without an order: the sums are 64-bit fixed point.  A
// first kernel takes each channel's largest magnitude M over all rows
// (unsigned max of the f32 bits, an order-free reduction); each value is
// then scaled by 2^e, e = 62 - ceil(log2 M) - ceil(log2 N), and rounded
// to an integer, so no sum of at most N of them reaches 2^63, and the
// integer sums do not depend on the order in which the rows' atomics
// land: every rerun is bitwise equal.  A value's rounding error is at
// most 2^-(e+1) <= N*M*2^-63, so a cell's sum errs by less than
// n*N*M*2^-63 (at N = 1M about 1e-13 of M a row); the fill is an exact
// integer subtraction; each bin is rounded once to f32 at the end.
//
// Kernels: absmax (grid-stride over the [N, 3] vals), scatter (one thread
// an entry: 64-bit global atomics into [S, F, stride, 3], the slots'
// totals gathered per block in shared memory first), finalize (one thread
// a (slot, feature, channel): its stored mass over the stride, the fill,
// the f32 rounding).  The accumulators are cleared on the stream first,
// so the whole pass can be captured in a CUDA graph.
//
// Bound on this card: bytes.  The pass must read flat (4 N K bytes), vals
// (12 N) and the slots (4 N), and write the output; at N = 1M, K = 35 that
// is about 156 MB, 46.6 us at 3.35 TB/s.  The atomics (3 an entry) into
// an L2-resident accumulator are what this design pays beyond that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAbsBlocks = 264;

// the exponent e of a channel's scale 2^e, from its largest magnitude's
// f32 bits: |v| * 2^e < 2^(62 - log2n) for every value, so a sum of at
// most 2^log2n of them stays under 2^62.  An all-zero (or not finite)
// channel takes e = 0.
__device__ __forceinline__ int scale_exp(unsigned int mx_bits, int log2n) {
  const float m = __uint_as_float(mx_bits);
  if (!(m > 0.0f) || !isfinite(m)) return 0;
  int x;
  frexpf(m, &x);  // m < 2^x
  return 62 - x - log2n;
}

__global__ void absmax(const float* __restrict__ vals, long long count,
                       const int32_t* __restrict__ active,
                       unsigned int* __restrict__ mx) {
  if (active != nullptr && active[0] == 0) return;
  unsigned int local[3] = {0u, 0u, 0u};
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += step) {
    const unsigned int b = __float_as_uint(fabsf(vals[i]));
    const int c = (int)(i % 3);
    local[c] = local[c] > b ? local[c] : b;
  }
  for (int c = 0; c < 3; ++c) {
    const unsigned int w = __reduce_max_sync(0xffffffffu, local[c]);
    if ((threadIdx.x & 31) == 0 && w != 0u) atomicMax(mx + c, w);
  }
}

__global__ void scatter(const int32_t* __restrict__ flat, int k, long long n,
                        const float* __restrict__ vals,
                        const int32_t* __restrict__ slot, int num_slots,
                        int slots, long long cells,
                        const int32_t* __restrict__ active,
                        const unsigned int* __restrict__ mx, int log2n,
                        unsigned long long* __restrict__ acc,
                        unsigned long long* __restrict__ tot) {
  if (active != nullptr && active[0] == 0) return;
  extern __shared__ unsigned long long stot[];  // [slots, 3]
  for (int i = threadIdx.x; i < slots * 3; i += blockDim.x) stot[i] = 0ull;
  __syncthreads();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n * k) {
    const long long r = t / k;
    const int j = (int)(t - r * k);
    int s = slot == nullptr ? 0 : slot[r];
    if (num_slots == 0) s = s >= 0 ? 0 : -1;
    if (s >= 0 && s < slots) {
      long long q[3];
      for (int c = 0; c < 3; ++c)
        q[c] = __double2ll_rn(
            ldexp((double)vals[r * 3 + c], scale_exp(mx[c], log2n)));
      const int e = flat[t];
      if (e >= 0 && e < cells) {
        unsigned long long* a = acc + ((long long)s * cells + e) * 3;
        for (int c = 0; c < 3; ++c)
          atomicAdd(a + c, (unsigned long long)q[c]);
      }
      if (j == 0)
        for (int c = 0; c < 3; ++c)
          atomicAdd(stot + s * 3 + c, (unsigned long long)q[c]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slots * 3; i += blockDim.x)
    if (stot[i] != 0ull) atomicAdd(tot + i, stot[i]);
}

__global__ void finalize(const long long* __restrict__ acc,
                         const long long* __restrict__ tot,
                         const int32_t* __restrict__ default_bin,
                         int num_features, int stride, int num_bins,
                         int slots, const int32_t* __restrict__ active,
                         const unsigned int* __restrict__ mx, int log2n,
                         float* __restrict__ out) {
  if (active != nullptr && active[0] == 0) return;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)slots * num_features * 3) return;
  const int c = (int)(t % 3);
  const long long sf = t / 3;               // slot * F + feature
  const int f = (int)(sf % num_features);
  const long long s = sf / num_features;
  const long long* a = acc + sf * stride * 3 + c;
  long long stored = 0;
  for (int b = 0; b < stride; ++b) stored += a[b * 3];
  const long long absent = tot[s * 3 + c] - stored;
  const int db = default_bin[f];
  const int e = scale_exp(mx[c], log2n);
  float* o = out + sf * num_bins * 3 + c;
  for (int b = 0; b < num_bins; ++b) {
    long long v = b < stride ? a[b * 3] : 0;
    if (b == db) v += absent;
    o[b * 3] = (float)ldexp((double)v, -e);
  }
}

}  // namespace

// flat [n, k] int32; vals [n, 3] f32; slot [n] int32 or null; num_slots 0
// for the one-histogram forms (rows with slot >= 0, or every row without a
// slot vector), K for the K-slot form; default_bin [F]; active [1] or
// null; acc [S, F, stride, 3] and tot [S, 3] int64 and mx [3] scratch
// (cleared here); out [S, F, num_bins, 3] f32.
extern "C" int lgbt_sparse_histogram(const int32_t* flat, long long n, int k,
                                     const float* vals, const int32_t* slot,
                                     int num_slots, int num_features,
                                     int stride, int num_bins,
                                     const int32_t* default_bin,
                                     const int32_t* active, long long* acc,
                                     long long* tot, unsigned int* mx,
                                     float* out, cudaStream_t stream) {
  const int slots = num_slots > 0 ? num_slots : 1;
  const long long cells = (long long)num_features * stride;
  cudaError_t err = cudaMemsetAsync(
      acc, 0, sizeof(long long) * slots * cells * 3, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(tot, 0, sizeof(long long) * slots * 3, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(mx, 0, sizeof(unsigned int) * 3, stream);
  if (err != cudaSuccess) return (int)err;
  int log2n = 0;
  while ((1ll << log2n) < n) ++log2n;
  const long long count = 3 * n;
  long long ab = (count + kThreads - 1) / kThreads;
  if (ab > kMaxAbsBlocks) ab = kMaxAbsBlocks;
  absmax<<<(unsigned)ab, kThreads, 0, stream>>>(vals, count, active, mx);
  const long long entries = n * k;
  const long long sb = (entries + kThreads - 1) / kThreads;
  scatter<<<(unsigned)sb, kThreads, sizeof(unsigned long long) * slots * 3,
            stream>>>(flat, k, n, vals, slot, num_slots, slots, cells,
                      active, mx, log2n, (unsigned long long*)acc,
                      (unsigned long long*)tot);
  const long long fin = (long long)slots * num_features * 3;
  finalize<<<(unsigned)((fin + kThreads - 1) / kThreads), kThreads, 0,
             stream>>>(acc, tot, default_bin, num_features, stride,
                       num_bins, slots, active, mx, log2n, out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_sparse_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, absmax);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, scatter);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, finalize);
}
