// B13 — the ranking gradients, one block a query.
//
// The JAX package's lightgbm_tpu/objectives.py pads every query to its
// size bucket (`_pad_queries`, widths 16, 64, 256, 1024, 4096 and the true
// maximum) and builds [Qb, M, M] pairwise tensors a bucket, because XLA
// needs static shapes.  Here each block reads its query's rows straight
// from the boundaries [Q+1]: no padding, no pairwise tensor in memory.
// Built with -fmad=false, so each f32 product and sum rounds as the op by
// op plain versions (lightgbm_torch/ops/rank.py) round it.
//
// 1. `lambdarank_grad` (B13a) replaces `LambdarankNDCG._bucket_gradients`
//    (objectives.py:515-565) and the sum and clamp of `get_gradients`.
//    For a query of m docs with scores s, gains g = label_gain[int(y)]
//    (the index clamped to the table, as JAX clamps a gather):
//
//     rank_i   = #{j: s_j > s_i} + #{j < i: s_j == s_i}
//                (the stable descending argsort; all tied at iteration 0)
//     d_i      = 1 / log2(2 + rank_i),   t_i = rank_i < truncation
//     pair ij  counts when g_i > g_j and (t_i or t_j)
//     delta    = |(g_i - g_j)(d_i - d_j)| * inv_max_dcg[q]
//     p        = 1 / (1 + exp(clip(sigma (s_i - s_j), -50, 50)))
//     lam_ij   = sigma p delta,   hc_ij = sigma^2 p (1 - p) delta
//     grad_i   = -sum_j lam_ij + sum_j lam_ji
//     hess_i   = sum_j hc_ij + sum_j hc_ji
//     lambdarank_norm: both times log2(1 + tot) / tot, tot = sum lam + 1e-9
//     hess_i   = max(hess_i, 1e-9)
//
//    Each thread owns docs i = i0 + tid and sums over j in index order
//    into four accumulators (no atomics), so reruns are bitwise equal and
//    the kernel captures in a CUDA graph.  The other docs' values are
//    staged in shared memory a tile of kTile docs at a time (score, gain,
//    discount, truncation flag): a query of up to kTile docs (every query
//    of MSLR-WEB30K, at most 1,251) is staged once a pass; a larger one
//    loops over tiles from global memory, in the same kernel, so there is
//    no size cap and no fallback.  The ranks go to a global scratch [N]
//    between the rank pass and the lambda pass.
//    Bound on this card: bytes and the pairs' operations.  It reads score
//    and label and writes g and h (16 B a row) plus the boundaries and the
//    per-query 1 / max DCG; the work the function needs is its valid
//    pairs, about 20 f32 operations each (an exp among them).  The rank
//    pass compares all m^2 pairs of a query, which the bound does not
//    count.
//
// 2. `xendcg_grad` (B13b) replaces `RankXENDCG._bucket_gradients`
//    (objectives.py:597-612) and the sum and clamp of `get_gradients`:
//
//     key_q    = fold_in(key_it, q)    key_it = fold_in(PRNGKey(seed), it)
//     gamma_p  = uniform(key_q)[p]     (threefry.cuh: word p of the
//                                       partitionable stream, so it does
//                                       not depend on the bucket width)
//     phi_p    = 2^y_p - gamma_p,      target_p = phi_p / max(sum phi, 1e-9)
//     rho      = softmax(s) over the query (exp(s - max) / sum)
//     grad_p   = rho_p - target_p,     hess_p = max(rho_p (1 - rho_p), 1e-9)
//
//    Three passes over the query's rows with block reductions in a fixed
//    order (max and sum of phi, the exponentials' sum, the outputs); a
//    query of any size.  Bound on this card: bytes (16 B a row); a
//    threefry2x32 a doc is about 100 integer operations, twice.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;

// a block-wide sum or max of one value a thread, in a fixed order
// (halving strides over the threads), returned to every thread
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
      const float a = red[threadIdx.x], b = red[threadIdx.x + s];
      red[threadIdx.x] = kMax ? fmaxf(a, b) : a + b;
    }
    __syncthreads();
  }
  return red[0];
}

__device__ __forceinline__ float gain_of(const float* label_gain, int ng,
                                         float y) {
  const int k = min(max((int)y, 0), ng - 1);
  return label_gain[k];
}

__device__ __forceinline__ float discount_of(int rank) {
  return 1.0f / log2f(2.0f + (float)rank);
}

__global__ void lambdarank_kernel(
    const float* __restrict__ score, const float* __restrict__ label,
    const int32_t* __restrict__ bnd, const float* __restrict__ label_gain,
    int ng, const float* __restrict__ inv_max_dcg, int trunc, int norm,
    float sig, float sig2, int32_t* __restrict__ rank,
    float* __restrict__ g_out, float* __restrict__ h_out) {
  extern __shared__ float sm[];
  __shared__ float red[kThreads];
  float* t_s = sm;
  float* t_g = sm + kTile;
  float* t_d = sm + 2 * kTile;
  int* t_t = reinterpret_cast<int*>(sm + 3 * kTile);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int q = blockIdx.x;
  const long long b0 = bnd[q];
  const int m = (int)(bnd[q + 1] - b0);

  // pass 1: each doc's rank, from the tiles' scores
  for (int i0 = 0; i0 < m; i0 += nt) {
    const int i = i0 + tid;
    const float si = i < m ? score[b0 + i] : 0.f;
    int cnt = 0;
    for (int j0 = 0; j0 < m; j0 += kTile) {
      const int len = min(kTile, m - j0);
      __syncthreads();
      for (int j = tid; j < len; j += nt) t_s[j] = score[b0 + j0 + j];
      __syncthreads();
      if (i < m) {
        for (int j = 0; j < len; ++j) {
          const float sj = t_s[j];
          cnt += (sj > si) || (sj == si && j0 + j < i);
        }
      }
    }
    if (i < m) rank[b0 + i] = cnt;
  }
  __syncthreads();

  // pass 2: the pairs of each doc, against the tiles' (score, gain,
  // discount, truncation flag)
  const float inv = inv_max_dcg[q];
  float my_tot = 0.f;
  for (int i0 = 0; i0 < m; i0 += nt) {
    const int i = i0 + tid;
    float si = 0.f, gi = 0.f, di = 0.f;
    bool ti = false;
    if (i < m) {
      si = score[b0 + i];
      gi = gain_of(label_gain, ng, label[b0 + i]);
      const int ri = rank[b0 + i];
      di = discount_of(ri);
      ti = ri < trunc;
    }
    float lneg = 0.f, lpos = 0.f, hneg = 0.f, hpos = 0.f;
    for (int j0 = 0; j0 < m; j0 += kTile) {
      const int len = min(kTile, m - j0);
      __syncthreads();
      for (int j = tid; j < len; j += nt) {
        const long long r = b0 + j0 + j;
        const int rj = rank[r];
        t_s[j] = score[r];
        t_g[j] = gain_of(label_gain, ng, label[r]);
        t_d[j] = discount_of(rj);
        t_t[j] = rj < trunc;
      }
      __syncthreads();
      if (i >= m) continue;
      for (int j = 0; j < len; ++j) {
        if (!(ti || t_t[j])) continue;
        const float gj = t_g[j];
        if (gi > gj) {                      // pair (i, j): i more relevant
          const float delta = fabsf((gi - gj) * (di - t_d[j])) * inv;
          const float sd = fminf(fmaxf(sig * (si - t_s[j]), -50.f), 50.f);
          const float p = 1.0f / (1.0f + expf(sd));
          lneg += sig * p * delta;
          hneg += sig2 * p * (1.0f - p) * delta;
        } else if (gj > gi) {               // pair (j, i): j more relevant
          const float delta = fabsf((gj - gi) * (t_d[j] - di)) * inv;
          const float sd = fminf(fmaxf(sig * (t_s[j] - si), -50.f), 50.f);
          const float p = 1.0f / (1.0f + expf(sd));
          lpos += sig * p * delta;
          hpos += sig2 * p * (1.0f - p) * delta;
        }
      }
    }
    if (i < m) {
      g_out[b0 + i] = -lneg + lpos;
      h_out[b0 + i] = hneg + hpos;
      my_tot += lneg;
    }
  }

  // lambdarank_norm, then the hessian's floor, on this thread's own docs
  float scale = 1.0f;
  if (norm) {
    const float tot = block_reduce<false>(my_tot, red) + 1e-9f;
    scale = tot > 0.f ? log2f(1.0f + tot) / tot : 1.0f;
  }
  for (int i = tid; i < m; i += nt) {
    const long long r = b0 + i;
    float g = g_out[r], h = h_out[r];
    if (norm) {
      g = g * scale;
      h = h * scale;
    }
    g_out[r] = g;
    h_out[r] = fmaxf(h, 1e-9f);
  }
}

__global__ void xendcg_kernel(const float* __restrict__ score,
                              const float* __restrict__ label,
                              const int32_t* __restrict__ bnd, uint32_t k0,
                              uint32_t k1, float* __restrict__ g_out,
                              float* __restrict__ h_out,
                              float* __restrict__ gamma_out) {
  __shared__ float red[kThreads];
  __shared__ uint32_t kq[2];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int q = blockIdx.x;
  const long long b0 = bnd[q];
  const int m = (int)(bnd[q + 1] - b0);
  if (tid == 0) {
    uint32_t a = k0, b = k1;
    fold_in(a, b, (uint32_t)q);
    kq[0] = a;
    kq[1] = b;
  }
  __syncthreads();
  const uint32_t q0 = kq[0], q1 = kq[1];
  float mx = -INFINITY, sphi = 0.f;
  for (int i = tid; i < m; i += nt) {
    mx = fmaxf(mx, score[b0 + i]);
    sphi += exp2f(label[b0 + i]) - uniform_at(q0, q1, (uint32_t)i);
  }
  mx = block_reduce<true>(mx, red);
  sphi = block_reduce<false>(sphi, red);
  float se = 0.f;
  for (int i = tid; i < m; i += nt) se += expf(score[b0 + i] - mx);
  se = block_reduce<false>(se, red);
  const float denom = fmaxf(sphi, 1e-9f);
  for (int i = tid; i < m; i += nt) {
    const long long r = b0 + i;
    const float u = uniform_at(q0, q1, (uint32_t)i);
    const float target = (exp2f(label[r]) - u) / denom;
    const float rho = expf(score[r] - mx) / se;
    g_out[r] = rho - target;
    h_out[r] = fmaxf(rho * (1.0f - rho), 1e-9f);
    if (gamma_out != nullptr) gamma_out[r] = u;
  }
}

}  // namespace

// B13a over q queries (boundaries [q+1]); rank [N] int32 scratch, g and h
// [N] f32 out.  Returns cudaGetLastError() after the launch.
extern "C" int lgbt_lambdarank(const float* score, const float* label,
                               const int32_t* bnd, const float* label_gain,
                               int ng, const float* inv_max_dcg, int q,
                               int trunc, int norm, float sig, float sig2,
                               int32_t* rank, float* g, float* h,
                               cudaStream_t stream) {
  const size_t smem = (size_t)kTile * 4 * sizeof(float);
  lambdarank_kernel<<<q, kThreads, smem, stream>>>(
      score, label, bnd, label_gain, ng, inv_max_dcg, trunc, norm, sig, sig2,
      rank, g, h);
  return (int)cudaGetLastError();
}

// B13b over q queries under the iteration key (k0, k1); gamma (the draws,
// [N] f32) may be null.
extern "C" int lgbt_xendcg(const float* score, const float* label,
                           const int32_t* bnd, int q, uint32_t k0,
                           uint32_t k1, float* g, float* h, float* gamma,
                           cudaStream_t stream) {
  xendcg_kernel<<<q, kThreads, 0, stream>>>(score, label, bnd, k0, k1, g, h,
                                            gamma);
  return (int)cudaGetLastError();
}

// Once per process, before any launch: load the kernels.
extern "C" int lgbt_rank_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, lambdarank_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, xendcg_kernel);
}
