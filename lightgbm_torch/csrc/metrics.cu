// B12 — traced evaluation metrics of the fused training loop.
//
// Replaces the JAX package's lightgbm_tpu/metrics.py traced metrics
// (`_t_auc` :402, `_t_binary_logloss` :391, `_t_l2` :427, `_t_rmse` :433,
// `_t_l1` :439), which its super-epoch program evaluates on the device
// after every iteration for the early-stop vote and the reported values
// (`build_traced_eval` :478).  Each is a function (score, label, weight)
// -> one f32 value over a valid set.
//
// B12a, AUC (`lgbt_auc`).  The caller sorts the scores (torch.sort,
// stable: the JAX function calls XLA's sort primitive the same way) and
// passes the order.  Then, in the sorted order, with pos_w = y > 0 ? w : 0
// and neg_w = y <= 0 ? w : 0, P(i) the negative mass before position i,
// and [a, b) the tie group (equal scores) of position i:
//
//     area = sum_i pos_w[i] * (P(a) + 0.5 * (P(b) - P(a)))
//     auc  = tp > 0 && tn > 0 ? area / (tp * tn) : 1
//
// which is the JAX recurrence (negative mass before the group plus half
// the group's own).  Four kernels, every sum in an order fixed by the
// shapes alone, so the value is the same in and out of a CUDA graph and
// from run to run:
//   1. `auc_local`: each block takes 2048 sorted positions, gathers score,
//      label and weight by the order, writes the sorted score and pos_w,
//      and the negative mass before each position within the block (each
//      thread walks 8 positions in order, thread 0 scans the 256 thread
//      sums in order); it also writes the block's sums (the positive mass
//      by a fixed tree over the threads) and its first and last group
//      start;
//   2. `auc_scan` (one thread): block offsets of the negative mass, the
//      totals tn and tp, and for each block the last group start before
//      it and the first after it, all in block order;
//   3. `auc_area`: for each position its group's start a and end b (the
//      group starts found in order within the thread, across threads and
//      across blocks from step 2), and pos_w * (P(a) + 0.5 (P(b) - P(a)));
//      thread sums in order, block sums by a fixed tree over the threads;
//   4. `auc_final` (one thread): the area in block order, then the ratio.
//
// B12b, pointwise metrics (`lgbt_pointwise`, one kernel with a metric
// id): 0 binary_logloss (p = 1 / (1 + exp(-sigmoid * s)) clipped to
// [1e-7, 1 - 1e-7], -(y log p + (1 - y) log(1 - p))), 1 l2 ((y - s)^2),
// 2 rmse (sqrt of the l2 mean), 3 l1 (|y - s|); each the weighted mean
// sum(loss * w) / sum(w).  `pw_partial` sums (loss * w, w) over 2048 rows
// per block (8 rows a thread in order, then a fixed tree over the
// threads), `pw_final` (one thread) sums the blocks in order and divides.
//
// B12c, multi_logloss (`lgbt_multi_logloss`): the JAX package's
// `_t_multi_logloss` (:445), which only the per-iteration path with
// fused_eval=true reaches (multiclass never fuses).  Over [N, K] raw
// scores, row-major: one thread a row takes the row's max, the K
// exponentials exp(s_c - max) summed in class order, p = exp(s_y - max) /
// sum and -log(max(p, 1e-7)) times the row's weight; y is the label
// truncated to an integer, and a label outside [0, K) makes the row's
// loss NaN, so the value is NaN (the JAX gather's fill).  `ml_partial`
// sums (loss * w, w) over 2048 rows a block as `pw_partial` does, and
// `pw_final` sums the blocks in order and divides: deterministic, as
// B12b.  K is a runtime argument.
//
// Bound on this card: bytes.  AUC reads the order (8 bytes a row) and
// gathers score, label and weight (12), B12b reads 12 bytes a row; at the
// main path's 200,000 valid rows that is 4 MB (1.2 us) and 2.4 MB
// (0.7 us) at 3.35 TB/s, far below the launches.  The AUC also writes and
// reads 12 bytes a row of scratch, which stays in L2.  Compiled with
// -fmad=false, so products and sums round where the PyTorch version's do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;
constexpr int kChunk = kThreads * kPer;
constexpr int kNone = 0x7fffffff;

// sum of sh[0..kThreads) by a tree in a fixed order (pairs at distance
// 128, 64, ..., 1); every thread of the block must call it.  The result
// is in sh[0].
__device__ void block_sum(float* sh) {
  for (int step = kThreads / 2; step > 0; step >>= 1) {
    __syncthreads();
    if (threadIdx.x < step) sh[threadIdx.x] += sh[threadIdx.x + step];
  }
  __syncthreads();
}

__global__ void auc_local(const float* __restrict__ score,
                          const float* __restrict__ label,
                          const float* __restrict__ weight,
                          const long long* __restrict__ order, int n,
                          float* __restrict__ s_sorted,
                          float* __restrict__ pos_sorted,
                          float* __restrict__ ploc,
                          float* __restrict__ blk_neg,
                          float* __restrict__ blk_pos,
                          int* __restrict__ blk_first,
                          int* __restrict__ blk_last) {
  __shared__ float sh_neg[kThreads];
  __shared__ float sh_pos[kThreads];
  __shared__ int sh_first[kThreads];
  __shared__ int sh_last[kThreads];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kChunk + (long long)t * kPer;
  float loc[kPer];
  float acc = 0.f, pacc = 0.f;
  int first = kNone, last = -1;
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e;
    loc[e] = acc;
    if (i >= n) continue;
    const long long o = order[i];
    const float s = score[o], y = label[o], w = weight[o];
    const float nw = y <= 0.f ? w : 0.f;
    const float pw = y > 0.f ? w : 0.f;
    s_sorted[i] = s;
    pos_sorted[i] = pw;
    acc += nw;
    pacc += pw;
    if (i == 0 || score[order[i - 1]] != s) {
      if (first == kNone) first = (int)i;
      last = (int)i;
    }
  }
  sh_neg[t] = acc;
  sh_pos[t] = pacc;
  sh_first[t] = first;
  sh_last[t] = last;
  __syncthreads();
  block_sum(sh_pos);
  if (t == 0) {
    float run = 0.f;
    int f = kNone, l = -1;
    for (int u = 0; u < kThreads; ++u) {
      const float v = sh_neg[u];
      sh_neg[u] = run;
      run += v;
      f = min(f, sh_first[u]);
      l = max(l, sh_last[u]);
    }
    blk_neg[blockIdx.x] = run;
    blk_pos[blockIdx.x] = sh_pos[0];
    blk_first[blockIdx.x] = f;
    blk_last[blockIdx.x] = l;
  }
  __syncthreads();
  const float off = sh_neg[t];
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e;
    if (i < n) ploc[i] = off + loc[e];
  }
}

// one thread: block offsets, totals and group-start carries in block order
__global__ void auc_scan(int nblocks, int n, const float* __restrict__ blk_neg,
                         const float* __restrict__ blk_pos,
                         const int* __restrict__ blk_first,
                         const int* __restrict__ blk_last,
                         float* __restrict__ blk_off,
                         int* __restrict__ start_carry,
                         int* __restrict__ end_carry,
                         float* __restrict__ totals) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  float run = 0.f, tp = 0.f;
  int m = -1;
  for (int b = 0; b < nblocks; ++b) {
    blk_off[b] = run;
    run += blk_neg[b];
    tp += blk_pos[b];
    start_carry[b] = m;
    m = max(m, blk_last[b]);
  }
  int e = n;
  for (int b = nblocks - 1; b >= 0; --b) {
    end_carry[b] = e;
    e = min(e, blk_first[b]);
  }
  totals[0] = run;  // tn
  totals[1] = tp;
}

__device__ __forceinline__ float neg_before(int x, int n,
                                            const float* blk_off,
                                            const float* ploc, float tn) {
  return x >= n ? tn : blk_off[x / kChunk] + ploc[x];
}

__global__ void auc_area(int n, const float* __restrict__ s_sorted,
                         const float* __restrict__ pos_sorted,
                         const float* __restrict__ ploc,
                         const float* __restrict__ blk_off,
                         const int* __restrict__ start_carry,
                         const int* __restrict__ end_carry,
                         const float* __restrict__ totals,
                         float* __restrict__ blk_area) {
  __shared__ int sh_start[kThreads];
  __shared__ int sh_end[kThreads];
  __shared__ float sh_area[kThreads];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kChunk + (long long)t * kPer;
  bool bnd[kPer];
  int first = kNone, last = -1;
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e;
    bnd[e] = i < n && (i == 0 || s_sorted[i] != s_sorted[i - 1]);
    if (bnd[e]) {
      if (first == kNone) first = (int)i;
      last = (int)i;
    }
  }
  sh_start[t] = last;
  sh_end[t] = first;
  __syncthreads();
  if (t == 0) {
    int m = start_carry[blockIdx.x];
    for (int u = 0; u < kThreads; ++u) {
      const int v = sh_start[u];
      sh_start[u] = m;
      m = max(m, v);
    }
    int e2 = end_carry[blockIdx.x];
    for (int u = kThreads - 1; u >= 0; --u) {
      const int v = sh_end[u];
      sh_end[u] = e2;
      e2 = min(e2, v);
    }
  }
  __syncthreads();
  const float tn = totals[0];
  int gb[kPer];
  int bb = sh_end[t];
  for (int e = kPer - 1; e >= 0; --e) {
    gb[e] = bb;
    if (bnd[e]) bb = (int)(base + e);
  }
  int a = sh_start[t];
  float acc = 0.f;
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e;
    if (i >= n) break;
    if (bnd[e]) a = (int)i;
    const float pa = neg_before(a, n, blk_off, ploc, tn);
    const float pb = neg_before(gb[e], n, blk_off, ploc, tn);
    acc += pos_sorted[i] * (pa + 0.5f * (pb - pa));
  }
  sh_area[t] = acc;
  block_sum(sh_area);
  if (t == 0) blk_area[blockIdx.x] = sh_area[0];
}

__global__ void auc_final(int nblocks, const float* __restrict__ blk_area,
                          const float* __restrict__ totals,
                          float* __restrict__ out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  float area = 0.f;
  for (int b = 0; b < nblocks; ++b) area += blk_area[b];
  const float tn = totals[0], tp = totals[1];
  out[0] = (tp > 0.f && tn > 0.f) ? area / (tp * tn) : 1.f;
}

__device__ __forceinline__ float point_loss(int metric, float s, float y,
                                            float sigmoid) {
  if (metric == 0) {
    float p = 1.f / (1.f + expf(-sigmoid * s));
    p = fminf(fmaxf(p, 1e-7f), (float)(1.0 - 1e-7));
    return -(y * logf(p) + (1.f - y) * logf(1.f - p));
  }
  const float d = y - s;
  return metric == 3 ? fabsf(d) : d * d;
}

__global__ void pw_partial(const float* __restrict__ score,
                           const float* __restrict__ label,
                           const float* __restrict__ weight, int n,
                           int metric, float sigmoid,
                           float* __restrict__ partial) {
  __shared__ float sh_lw[kThreads];
  __shared__ float sh_w[kThreads];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kChunk + (long long)t * kPer;
  float lw = 0.f, ws = 0.f;
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e;
    if (i >= n) break;
    const float w = weight[i];
    lw += point_loss(metric, score[i], label[i], sigmoid) * w;
    ws += w;
  }
  sh_lw[t] = lw;
  sh_w[t] = ws;
  block_sum(sh_lw);
  block_sum(sh_w);
  if (t == 0) {
    partial[2 * blockIdx.x] = sh_lw[0];
    partial[2 * blockIdx.x + 1] = sh_w[0];
  }
}

__global__ void ml_partial(const float* __restrict__ score,
                           const float* __restrict__ label,
                           const float* __restrict__ weight, int n, int k,
                           float* __restrict__ partial) {
  __shared__ float sh_lw[kThreads];
  __shared__ float sh_w[kThreads];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kChunk + (long long)t * kPer;
  float lw = 0.f, ws = 0.f;
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e;
    if (i >= n) break;
    const float* s = score + i * k;
    float mx = s[0];
    for (int c = 1; c < k; ++c) mx = fmaxf(mx, s[c]);
    float sum = 0.f;
    for (int c = 0; c < k; ++c) sum += expf(s[c] - mx);
    const float y = label[i];
    float loss;
    if (y > -1.f && y < (float)k) {
      const float p = expf(s[(int)y] - mx) / sum;
      loss = -logf(fmaxf(p, 1e-7f));
    } else {
      loss = NAN;  // also a NaN label: both comparisons are false
    }
    const float w = weight[i];
    lw += loss * w;
    ws += w;
  }
  sh_lw[t] = lw;
  sh_w[t] = ws;
  block_sum(sh_lw);
  block_sum(sh_w);
  if (t == 0) {
    partial[2 * blockIdx.x] = sh_lw[0];
    partial[2 * blockIdx.x + 1] = sh_w[0];
  }
}

__global__ void pw_final(int nblocks, int metric,
                         const float* __restrict__ partial,
                         float* __restrict__ out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < nblocks; ++k) {
    a += partial[2 * k];
    b += partial[2 * k + 1];
  }
  const float r = a / b;
  out[0] = metric == 2 ? sqrtf(r) : r;
}

}  // namespace

// order: [n] int64 ascending stable order of score.  Scratch: s_sorted,
// pos_sorted, ploc [n] f32; blk_f [4 * nblocks] f32 (neg, pos, off, area);
// blk_i [4 * nblocks] int32 (first, last, start carry, end carry);
// totals [2] f32.  out [1] f32.
extern "C" int lgbt_auc(const float* score, const float* label,
                        const float* weight, const long long* order, int n,
                        float* s_sorted, float* pos_sorted, float* ploc,
                        float* blk_f, int* blk_i, float* totals, float* out,
                        cudaStream_t stream) {
  const int nb = (n + kChunk - 1) / kChunk;
  float *blk_neg = blk_f, *blk_pos = blk_f + nb, *blk_off = blk_f + 2 * nb,
        *blk_area = blk_f + 3 * nb;
  int *blk_first = blk_i, *blk_last = blk_i + nb, *start = blk_i + 2 * nb,
      *end = blk_i + 3 * nb;
  auc_local<<<nb, kThreads, 0, stream>>>(score, label, weight, order, n,
                                         s_sorted, pos_sorted, ploc, blk_neg,
                                         blk_pos, blk_first, blk_last);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auc_scan<<<1, 32, 0, stream>>>(nb, n, blk_neg, blk_pos, blk_first,
                                 blk_last, blk_off, start, end, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auc_area<<<nb, kThreads, 0, stream>>>(n, s_sorted, pos_sorted, ploc,
                                        blk_off, start, end, totals,
                                        blk_area);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auc_final<<<1, 32, 0, stream>>>(nb, blk_area, totals, out);
  return (int)cudaGetLastError();
}

// partial: [2 * nblocks] f32 scratch; out [1] f32.
extern "C" int lgbt_pointwise(const float* score, const float* label,
                              const float* weight, int n, int metric,
                              float sigmoid, float* partial, float* out,
                              cudaStream_t stream) {
  const int nb = (n + kChunk - 1) / kChunk;
  pw_partial<<<nb, kThreads, 0, stream>>>(score, label, weight, n, metric,
                                          sigmoid, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pw_final<<<1, 32, 0, stream>>>(nb, metric, partial, out);
  return (int)cudaGetLastError();
}

// score [n, k] f32 row-major; partial: [2 * nblocks] f32 scratch; out [1].
extern "C" int lgbt_multi_logloss(const float* score, const float* label,
                                  const float* weight, int n, int k,
                                  float* partial, float* out,
                                  cudaStream_t stream) {
  const int nb = n > 0 ? (n + kChunk - 1) / kChunk : 1;
  ml_partial<<<nb, kThreads, 0, stream>>>(score, label, weight, n, k,
                                          partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pw_final<<<1, 32, 0, stream>>>(nb, 0, partial, out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_metrics_setup() {
  cudaFuncAttributes attr;
  const void* fns[] = {(const void*)auc_local, (const void*)auc_scan,
                       (const void*)auc_area, (const void*)auc_final,
                       (const void*)pw_partial, (const void*)pw_final,
                       (const void*)ml_partial};
  for (const void* f : fns) {
    cudaError_t err = cudaFuncGetAttributes(&attr, f);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
