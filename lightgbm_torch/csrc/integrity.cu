// B17 — the computation-integrity layer's device checks.
//
// Replaces three device programs of the JAX package's integrity layer
// (lightgbm_tpu/integrity.py, docs/Fault-Tolerance.md layer 7):
//
// B17a `invariant_flags` (integrity.py:179): the in-graph invariants of a
// freshly grown tree, one flag that rides the checked iteration's one
// fetch.  Over the live internal nodes i < num_leaves - 1: count
// conservation |ic[i] - (count(left[i]) + count(right[i]))| <= 0.5 +
// 1e-3 |ic[i]| (a child < 0 is leaf ~child; indices clipped as
// jnp.take(mode="clip")), and a finite split gain; over the live leaves:
// |sum lc - root| <= 0.5 + 1e-3 |root|, root = ic[0] (lc[0] for a stump).
// Every comparison and slack is f32, as the JAX function computes them;
// the leaf sum is taken in f64 in a fixed order and rounded once to f32
// (the plain version, `integrity.invariant_flags_plain`, sums the same
// way), so kernel and plain version give the same flag.  Writes 1 (ok)
// or 0 to flag[0].
//
// Design: one block of kThreads threads reads the tree buffer (the
// grower's int32 words, f32 fields by bit pattern; the offsets of its
// fields come from the wrapper), each thread a strided share of the
// nodes and leaves; the flag is a block-wide AND, the leaf sum a shared
// memory tree reduction.  Bound: bytes — the tree's node and leaf fields,
// about 24 B a node; a few microseconds of launch at any leaf budget.
//
// B17b, the score re-gather of `verify_score` (integrity.py:361-397):
// the independent re-gather of the score update on check iterations,
// flag[0] = 1 where some row r has lv[leaf_of_row[r]] != delta[r] (an
// index outside [0, L) counts as a mismatch, as jnp.take fills it with
// NaN).  The primary gather stays the trainer's index_select; this
// kernel reads lv [L] f32, leaf_of_row [N] int32 and delta [N] f32 and
// writes nothing unless it finds a mismatch (the wrapper zeroes the
// flag).  Design: a grid-stride loop, one row a thread a turn, a
// block-wide OR and one store by thread 0 of a block that saw a
// mismatch.  Bound: bytes, 8 B a row plus lv.
//
// B17c `feature_totals_residual` (lightgbm_tpu/ops/histogram.py:242):
// max over (f, c) of |sum_b hist[f, b, c] - sum_n vals[n, c]|, the
// histogram's defining invariant, in f64 for an f32 histogram and exact
// (int64) for an int32 one.  Two kernels behind one entry point: row
// blocks (their count a constant of the wrapper, ops/histogram.py
// `_RESIDUAL_BLOCKS`, so the summation order depends on the shapes
// alone) sum their rows' channels into per-block
// partials in a fixed tree order; one block then adds the partials in
// block order, sums each (feature, channel) over its bins in bin order
// and takes the maximum.  Bound: bytes, the histogram plus vals.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 8;

__device__ __forceinline__ float count_of(int c, const float* lc,
                                          const float* ic, int L,
                                          int nnode) {
  if (c < 0) {
    int li = ~c;
    li = li < 0 ? 0 : (li > L - 1 ? L - 1 : li);
    return lc[li];
  }
  const int ni = c > nnode - 1 ? nnode - 1 : c;
  return ic[ni < 0 ? 0 : ni];
}

__global__ void invariant_flags_kernel(const int32_t* __restrict__ tree,
                                       int L, int o_nl, int o_left,
                                       int o_right, int o_gain, int o_ic,
                                       int o_lc, int32_t* __restrict__ flag) {
  __shared__ double part[kThreads];
  const int nl = tree[o_nl];
  const int nnode = L - 1;
  const int32_t* left = tree + o_left;
  const int32_t* right = tree + o_right;
  const float* gain = reinterpret_cast<const float*>(tree + o_gain);
  const float* ic = reinterpret_cast<const float*>(tree + o_ic);
  const float* lc = reinterpret_cast<const float*>(tree + o_lc);
  int ok = 1;
  for (int i = threadIdx.x; i < nnode && i < nl - 1; i += blockDim.x) {
    const float kid = __fadd_rn(count_of(left[i], lc, ic, L, nnode),
                                count_of(right[i], lc, ic, L, nnode));
    const float slack = __fadd_rn(0.5f, __fmul_rn(1e-3f, fabsf(ic[i])));
    if (!(fabsf(__fsub_rn(ic[i], kid)) <= slack)) ok = 0;
    if (!isfinite(gain[i])) ok = 0;
  }
  double s = 0.0;
  for (int j = threadIdx.x; j < L && j < nl; j += blockDim.x) s += lc[j];
  part[threadIdx.x] = s;
  ok = __syncthreads_and(ok);
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float tot = (float)part[0];
    const float root = (nl > 1 && nnode > 0) ? ic[0] : lc[0];
    const float slack = __fadd_rn(0.5f, __fmul_rn(1e-3f, fabsf(root)));
    const int total_ok = fabsf(__fsub_rn(tot, root)) <= slack;
    flag[0] = (ok && total_ok) ? 1 : 0;
  }
}

__global__ void score_check_kernel(const float* __restrict__ lv, int L,
                                   const int32_t* __restrict__ lor,
                                   const float* __restrict__ delta,
                                   long long n, int32_t* __restrict__ flag) {
  int bad = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const int l = lor[r];
    if (l < 0 || l >= L || lv[l] != delta[r]) bad = 1;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) flag[0] = 1;
}

// per-block channel sums of rows [b * rows, (b + 1) * rows): each thread
// a strided share of the block's rows, then a shared-memory tree
template <typename V, typename A>
__global__ void colsum_partial(const V* __restrict__ vals, long long n,
                               int C, long long rows, A* __restrict__ partial) {
  __shared__ A sh[kMaxChannels][kThreads];
  A acc[kMaxChannels];
  for (int c = 0; c < C; ++c) acc[c] = 0;
  const long long lo = (long long)blockIdx.x * rows;
  const long long hi = lo + rows < n ? lo + rows : n;
  for (long long r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    for (int c = 0; c < C; ++c) acc[c] += (A)vals[r * C + c];
  }
  for (int c = 0; c < C; ++c) sh[c][threadIdx.x] = acc[c];
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      for (int c = 0; c < C; ++c) sh[c][threadIdx.x] += sh[c][threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x < C) {
    partial[(long long)blockIdx.x * C + threadIdx.x] = sh[threadIdx.x][0];
  }
}

// a NaN residual wins the maximum, as in the JAX function's jnp.max
__device__ __forceinline__ double nan_max(double a, double b) {
  return isnan(a) ? a : (isnan(b) ? b : fmax(a, b));
}

template <typename H, typename A>
__global__ void residual_final(const H* __restrict__ hist, int F, int B,
                               int C, const A* __restrict__ partial, int G,
                               double* __restrict__ out) {
  __shared__ A col[kMaxChannels];
  __shared__ double best[kThreads];
  if (threadIdx.x < C) {
    A s = 0;
    for (int g = 0; g < G; ++g) s += partial[(long long)g * C + threadIdx.x];
    col[threadIdx.x] = s;
  }
  __syncthreads();
  double m = 0.0;
  for (int p = threadIdx.x; p < F * C; p += blockDim.x) {
    const int f = p / C, c = p % C;
    A s = 0;
    const H* h = hist + (long long)f * B * C + c;
    for (int b = 0; b < B; ++b) s += (A)h[(long long)b * C];
    const A d = s - col[c];
    m = nan_max(m, (double)(d < 0 ? -d : d));
  }
  best[threadIdx.x] = m;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w)
      best[threadIdx.x] = nan_max(best[threadIdx.x], best[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = best[0];
}

template <typename V, typename H, typename A>
int residual_launch(const void* hist, const void* vals, int F, int B, int C,
                    long long n, int G, long long rows, void* partial,
                    double* out, cudaStream_t stream) {
  if (n > 0) {
    colsum_partial<V, A><<<G, kThreads, 0, stream>>>(
        static_cast<const V*>(vals), n, C, rows, static_cast<A*>(partial));
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  residual_final<H, A><<<1, kThreads, 0, stream>>>(
      static_cast<const H*>(hist), F, B, C, static_cast<const A*>(partial),
      n > 0 ? G : 0, out);
  return (int)cudaGetLastError();
}

}  // namespace

// tree: the grower's tree buffer (int32 words); the field offsets (in
// words) of num_leaves, left_child, right_child, split_gain,
// internal_count and leaf_count; L the leaf budget.  flag [1] int32.
extern "C" int lgbt_invariant_flags(const int32_t* tree, int L, int o_nl,
                                    int o_left, int o_right, int o_gain,
                                    int o_ic, int o_lc, int32_t* flag,
                                    cudaStream_t stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  invariant_flags_kernel<<<1, kThreads, 0, stream>>>(
      tree, L, o_nl, o_left, o_right, o_gain, o_ic, o_lc, flag);
  return (int)cudaGetLastError();
}

// lv [L] f32, leaf_of_row [n] int32, delta [n] f32; flag [1] int32, zero
// on entry, set to 1 on a mismatch.  blocks: the grid's block count.
extern "C" int lgbt_score_check(const float* lv, int L, const int32_t* lor,
                                const float* delta, long long n, int blocks,
                                int32_t* flag, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  score_check_kernel<<<blocks, kThreads, 0, stream>>>(lv, L, lor, delta, n,
                                                      flag);
  return (int)cudaGetLastError();
}

// hist [F, B, C] (htype 0 f32, 1 int32), vals [n, C] (vtype 0 f32, 1 int8,
// 2 int16, 3 int32; f32 with an f32 histogram, an integer type with an
// int32 one); G row blocks of `rows` rows; partial [G, C] f64 (f32) or
// int64 (integer) scratch; out [1] f64.  C <= 8.
extern "C" int lgbt_totals_residual(const void* hist, int htype,
                                    const void* vals, int vtype, int F, int B,
                                    int C, long long n, int G, long long rows,
                                    void* partial, double* out,
                                    cudaStream_t stream) {
  if (C < 1 || C > kMaxChannels || F < 0 || B < 0 || G < 1)
    return (int)cudaErrorInvalidValue;
  if (htype == 0 && vtype == 0)
    return residual_launch<float, float, double>(hist, vals, F, B, C, n, G,
                                                 rows, partial, out, stream);
  if (htype == 1 && vtype == 1)
    return residual_launch<int8_t, int32_t, long long>(
        hist, vals, F, B, C, n, G, rows, partial, out, stream);
  if (htype == 1 && vtype == 2)
    return residual_launch<int16_t, int32_t, long long>(
        hist, vals, F, B, C, n, G, rows, partial, out, stream);
  if (htype == 1 && vtype == 3)
    return residual_launch<int32_t, int32_t, long long>(
        hist, vals, F, B, C, n, G, rows, partial, out, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lgbt_integrity_setup() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, invariant_flags_kernel);
}
