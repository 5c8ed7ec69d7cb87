// B1 — gradient histogram.
//
// Replaces the JAX package's lightgbm_tpu/ops/histogram.py
// `_compute_histogram_matmul` (entered through `compute_histogram`, and
// from the strict grower's smaller-child pass with `slot=`, grower.py
// `child_hist`).  It computes
//
//     hist[f, b, c] = sum over rows n with slot[n] >= 0 of
//                     [binned[n, f] == b] * vals[n, c]
//
// for binned [N, F] uint8, vals [N, 3] f32 (g*w, h*w, w) and an optional
// slot [N] int32 (no slot = every row).  The TPU program builds a one-hot
// matrix and multiplies it on the MXU because the TPU has no fast scatter;
// none of that (nor its bin padding to 64) is needed here.
//
// Bound on this card: bytes.  One pass reads the binned matrix once
// (N*F bytes), vals (12*N bytes) and slot (4*N bytes) and writes
// F*B*3*4 bytes.  At the main path (N = 1,000,000, F = 28, B = 63) that is
// 28 + 12 + 4 = 44 MB, about 13 us at 3.35 TB/s.  The adds are
// 3*N*F = 84 M f32 operations, far below the f32 rate.
//
// Design.  The JAX package's reruns are bitwise identical (kill+resume,
// fused == per-iteration and the integrity shadow depend on it), and f32
// atomicAdd order changes from run to run, so this kernel sums in an order
// that the shapes alone fix:
//   1. `hist_partial`: each block takes a fixed range of rows.  Each thread
//      owns one (feature, row sub-range) pair and walks its rows in order
//      into a private [B, 3] f32 slice of shared memory (no atomics).  The
//      block then sums the slices of each feature in sub-range order and
//      writes one partial [F, B, 3] to global memory.  Features are tiled
//      over grid.y when F*B does not fit in shared memory.
//   2. `hist_reduce`: one thread per (f, b, c) sums the partials in block
//      order.
// Bins >= num_bins add nothing (the TPU program's one-hot drops them too).
// This is a first, simple design: every pass reads all N rows, and a
// thread's slice accesses hit data-dependent banks.
//
// `active` (optional, a device int32): the grower's step record flag.
// When it is 0 (the tree is done) both kernels return at once and write
// nothing, so a dead step of a captured tree costs two empty launches.
// The kernel's shared-memory limit is raised once, when the library is
// loaded (`lgbt_histogram_setup`), never per launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 3;

__global__ void hist_partial(const uint8_t* __restrict__ binned,
                             const float* __restrict__ vals,
                             const int32_t* __restrict__ slot,
                             int n, int num_features, int num_bins,
                             int rows_per_block, int tile_f, int subranges,
                             const int32_t* __restrict__ active,
                             float* __restrict__ partial) {
  if (active != nullptr && *active == 0) return;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;                 // tile_f * subranges
  const int slice = num_bins * kChannels;
  for (int i = tid; i < nthreads * slice; i += nthreads) smem[i] = 0.f;
  __syncthreads();

  const int f0 = blockIdx.y * tile_f;
  const int fl = tid % tile_f;
  const int s = tid / tile_f;
  const int f = f0 + fl;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row_stop = min(row0 + rows_per_block, (long long)n);
  const int sub = (rows_per_block + subranges - 1) / subranges;
  const long long r_begin = row0 + (long long)s * sub;
  const long long r_end = min(r_begin + sub, row_stop);
  float* mine = smem + tid * slice;
  if (f < num_features) {
    for (long long r = r_begin; r < r_end; ++r) {
      if (slot != nullptr && slot[r] < 0) continue;
      const int b = binned[r * num_features + f];
      if (b >= num_bins) continue;
      const float* v = vals + r * kChannels;
      mine[b * kChannels + 0] += v[0];
      mine[b * kChannels + 1] += v[1];
      mine[b * kChannels + 2] += v[2];
    }
  }
  __syncthreads();

  const int tile_elems = tile_f * slice;
  for (int e = tid; e < tile_elems; e += nthreads) {
    const int flocal = e / slice;
    const int rest = e % slice;
    const int fg = f0 + flocal;
    if (fg >= num_features) continue;
    float acc = smem[flocal * slice + rest];
    for (int ss = 1; ss < subranges; ++ss)
      acc += smem[(ss * tile_f + flocal) * slice + rest];
    partial[((long long)blockIdx.x * num_features + fg) * slice + rest] = acc;
  }
}

__global__ void hist_reduce(const float* __restrict__ partial, int nblocks,
                            int elems, const int32_t* __restrict__ active,
                            float* __restrict__ out) {
  if (active != nullptr && *active == 0) return;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  float acc = partial[e];
  for (int k = 1; k < nblocks; ++k) acc += partial[(long long)k * elems + e];
  out[e] = acc;
}

}  // namespace

// partial: [ceil(n / rows_per_block), F, B, 3] f32 scratch; out: [F, B, 3].
// slot and active may be null.  Returns cudaGetLastError() after the
// launches.
extern "C" int lgbt_histogram(const uint8_t* binned, const float* vals,
                              const int32_t* slot, int n, int num_features,
                              int num_bins, int rows_per_block, int tile_f,
                              int subranges, const int32_t* active,
                              float* partial, float* out,
                              cudaStream_t stream) {
  const int nblocks = (n + rows_per_block - 1) / rows_per_block;
  const int ntiles = (num_features + tile_f - 1) / tile_f;
  const int threads = tile_f * subranges;
  const size_t smem = (size_t)threads * num_bins * kChannels * sizeof(float);
  hist_partial<<<dim3(nblocks, ntiles), threads, smem, stream>>>(
      binned, vals, slot, n, num_features, num_bins, rows_per_block, tile_f,
      subranges, active, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int elems = num_features * num_bins * kChannels;
  hist_reduce<<<(elems + 255) / 256, 256, 0, stream>>>(partial, nblocks,
                                                       elems, active, out);
  return (int)cudaGetLastError();
}

// Once per process, before any launch: let hist_partial use up to
// `smem_bytes` of dynamic shared memory, and load both kernels.
extern "C" int lgbt_histogram_setup(int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, hist_reduce);
}
