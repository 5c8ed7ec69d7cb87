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
// Deterministic without an order: the sums are 64-bit fixed point
// (csrc/fixed.cuh, shared with B1-K and B11a).  A first kernel takes each
// channel's largest finite magnitude M over all rows (unsigned max of the
// f32 bits, an order-free reduction); each value is then scaled by 2^e,
// e = 62 - ceil(log2 M) - ceil(log2 N), and rounded to an integer, so no
// sum of at most N of them reaches 2^63, and the integer sums do not
// depend on the order in which the rows' atomics land: every rerun is
// bitwise equal.  A value's rounding error is at most 2^-(e+1) <=
// N*M*2^-63, so a cell's sum errs by less than n*N*M*2^-63 (at N = 1M
// about 1e-13 of M a row); the fill is an exact integer subtraction; each
// bin is rounded once to f32 at the end.  Non-finite values (NaN, +-Inf)
// go to f32 side sums of the cells and the slots' totals instead; the
// fill takes their side total minus the side sum of the feature's stored
// cells, and a cell whose side value is set (non-zero) outputs it: the
// non-finite cells are the plain version's (f64 sums, which propagate
// them the same way), the others unchanged.
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

#include "fixed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAbsBlocks = 264;

using lgbt_fixed::scale_exp;

// The pass's workspace (int64 words, cleared before the pass): acc [S,
// F, stride, 3] and tot [S, 3] int64, their side sums [S, F, stride, 3]
// and [S, 3] f32, and mx [3], the channels' largest finite magnitudes.
struct SparseWs {
  unsigned long long* acc;
  unsigned long long* tot;
  float* side_acc;
  float* side_tot;
  unsigned int* mx;
};

__host__ __device__ __forceinline__ long long sparse_ws_words(int slots,
                                                             long long cells) {
  const long long ints = (long long)slots * cells * 3 + slots * 3;
  return ints + (ints + 1) / 2 + 2;
}

__host__ __device__ __forceinline__ SparseWs sparse_ws(long long* w,
                                                       int slots,
                                                       long long cells) {
  const long long a = (long long)slots * cells * 3, t = (long long)slots * 3;
  float* f = reinterpret_cast<float*>(w + a + t);
  return {reinterpret_cast<unsigned long long*>(w),
          reinterpret_cast<unsigned long long*>(w + a), f, f + a,
          reinterpret_cast<unsigned int*>(w + a + t + (a + t + 1) / 2)};
}

__global__ void absmax(const float* __restrict__ vals, long long count,
                       const int32_t* __restrict__ active,
                       unsigned int* __restrict__ mx) {
  if (active != nullptr && active[0] == 0) return;
  unsigned int local[3] = {0u, 0u, 0u};
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += step) {
    const unsigned int b = lgbt_fixed::finite_abs_bits(vals[i]);
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
                        const int32_t* __restrict__ active, int log2n,
                        SparseWs ws) {
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
      float v[3];
      bool fin[3];
      for (int c = 0; c < 3; ++c) {
        v[c] = vals[r * 3 + c];
        fin[c] = isfinite(v[c]);
        q[c] = fin[c] ? lgbt_fixed::quantize(
                            v[c], lgbt_fixed::pow2(scale_exp(ws.mx[c], log2n)))
                      : 0;
      }
      const int e = flat[t];
      if (e >= 0 && e < cells) {
        const long long cell = ((long long)s * cells + e) * 3;
        for (int c = 0; c < 3; ++c) {
          if (fin[c])
            atomicAdd(ws.acc + cell + c, (unsigned long long)q[c]);
          else
            atomicAdd(ws.side_acc + cell + c, v[c]);
        }
      }
      if (j == 0)
        for (int c = 0; c < 3; ++c) {
          if (fin[c])
            atomicAdd(stot + s * 3 + c, (unsigned long long)q[c]);
          else
            atomicAdd(ws.side_tot + s * 3 + c, v[c]);
        }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slots * 3; i += blockDim.x)
    if (stot[i] != 0ull) atomicAdd(ws.tot + i, stot[i]);
}

__global__ void finalize(SparseWs ws, const int32_t* __restrict__ default_bin,
                         int num_features, int stride, int num_bins,
                         int slots, const int32_t* __restrict__ active,
                         int log2n, float* __restrict__ out) {
  if (active != nullptr && active[0] == 0) return;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)slots * num_features * 3) return;
  const int c = (int)(t % 3);
  const long long sf = t / 3;               // slot * F + feature
  const int f = (int)(sf % num_features);
  const long long s = sf / num_features;
  const long long* a =
      reinterpret_cast<const long long*>(ws.acc) + sf * stride * 3 + c;
  const float* sa = ws.side_acc + sf * stride * 3 + c;
  long long stored = 0;
  float side_stored = 0.0f;
  for (int b = 0; b < stride; ++b) {
    stored += a[b * 3];
    side_stored += sa[b * 3];
  }
  const long long absent = (long long)ws.tot[s * 3 + c] - stored;
  const float side_absent = ws.side_tot[s * 3 + c] - side_stored;
  const int db = default_bin[f];
  const double inv = lgbt_fixed::pow2(-scale_exp(ws.mx[c], log2n));
  float* o = out + sf * num_bins * 3 + c;
  for (int b = 0; b < num_bins; ++b) {
    long long v = b < stride ? a[b * 3] : 0;
    float side = b < stride ? sa[b * 3] : 0.0f;
    if (b == db) {
      v += absent;
      side += side_absent;
    }
    o[b * 3] = lgbt_fixed::cell_value(v, side, inv);
  }
}

}  // namespace

// flat [n, k] int32; vals [n, 3] f32; slot [n] int32 or null; num_slots 0
// for the one-histogram forms (rows with slot >= 0, or every row without a
// slot vector), K for the K-slot form; default_bin [F]; active [1] or
// null; ws int64 [sparse_ws_words(S, F * stride)] scratch (cleared here);
// out [S, F, num_bins, 3] f32.
extern "C" int lgbt_sparse_histogram(const int32_t* flat, long long n, int k,
                                     const float* vals, const int32_t* slot,
                                     int num_slots, int num_features,
                                     int stride, int num_bins,
                                     const int32_t* default_bin,
                                     const int32_t* active, long long* wsp,
                                     float* out, cudaStream_t stream) {
  const int slots = num_slots > 0 ? num_slots : 1;
  const long long cells = (long long)num_features * stride;
  cudaError_t err = cudaMemsetAsync(
      wsp, 0, sizeof(long long) * sparse_ws_words(slots, cells), stream);
  if (err != cudaSuccess) return (int)err;
  const SparseWs ws = sparse_ws(wsp, slots, cells);
  const int log2n = lgbt_fixed::log2_ceil(n);
  const long long count = 3 * n;
  long long ab = (count + kThreads - 1) / kThreads;
  if (ab > kMaxAbsBlocks) ab = kMaxAbsBlocks;
  absmax<<<(unsigned)ab, kThreads, 0, stream>>>(vals, count, active, ws.mx);
  const long long entries = n * k;
  const long long sb = (entries + kThreads - 1) / kThreads;
  scatter<<<(unsigned)sb, kThreads, sizeof(unsigned long long) * slots * 3,
            stream>>>(flat, k, n, vals, slot, num_slots, slots, cells,
                      active, log2n, ws);
  const long long fin = (long long)slots * num_features * 3;
  finalize<<<(unsigned)((fin + kThreads - 1) / kThreads), kThreads, 0,
             stream>>>(ws, default_bin, num_features, stride, num_bins,
                       slots, active, log2n, out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_sparse_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, absmax);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, scatter);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, finalize);
}
