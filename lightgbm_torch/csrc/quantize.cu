// B7 — quantized training: the per-channel scales, the int8/int16 packing
// of (g*w, h*w, w), and the dequantization of integer histograms.
//
// Replaces the JAX package's lightgbm_tpu/ops/quantize.py `quant_scales`
// (:98), `quantize_stack` (:109, with its counter hash `counter_uniform`
// :76 and `_fmix32` :66) and lightgbm_tpu/ops/split.py `dequantize_hist`
// (:29), which the masked grower runs once a tree (`_quant_prepare`,
// grower.py:369-397) and before each split scan (`scan_expand`):
//
//   B7a `quant_scales`:  s[c] = max(max_r |v[r, c]|, 1e-30) / qmax
//   B7b `quantize_stack`:
//        k    = fmix32(it ^ (seed * 2654435761))
//        u    = (fmix32(r * 0x9E3779B9 ^ c * 0x85EBCA6B ^ k) >> 8) * 2^-24
//        x    = v[r, c] / s[c]                               (IEEE f32)
//        q    = stochastic ? floor(x + u) : rint(x)          (half to even)
//        out[r, c] = clip(q, -qmax, qmax)                    (int8 or int16)
//   B7c `dequant_hist`:  out[e] = float(h[e]) * s[e % 3]
//
// All arithmetic is uint32 hashing and single IEEE f32 operations
// (__fdiv_rn, __fadd_rn, __fmul_rn, __int2float_rn; the library is built
// with -fmad=false and without fast math), so every kernel equals its
// plain version (lightgbm_torch/ops/quantize.py) bit for bit, and so does
// the JAX package's.  The iteration `it` is read from a device int32 (the
// trainer's `it_cur`), so a captured CUDA graph quantizes each replay with
// its own iteration's stream; B7c reads the grower's step flag `active`
// and exits at once on a dead step, as B1 does.
//
// Design.  B7a: one pass of row blocks, each thread a strided run of rows,
// each block's per-channel max by warp shuffles into [blocks, 3] partials,
// then one block takes the max of the partials and divides.  Max is exact
// and order-free, so the result does not depend on the launch shape.  B7b:
// one thread a row (three channels); B7c: one thread an element.
//
// Bound on this card: bytes.  B7a reads vals (12 N bytes), B7b reads vals
// again and writes 3 N (int8) or 6 N (int16) bytes: at the main path's N =
// 1,000,000 that is 12 + 12 + 3 = 27 MB; the least the pair must move,
// vals read once and the stack written once, is 15 MB, about 4.5 us at
// 3.35 TB/s (the second read of vals mostly hits the 50 MB L2).  B7c reads
// a child pair's int32 histograms and writes them as f32: 2 x 28 x 63 x 3
// x 8 bytes = 85 KB at the main path, well under a microsecond.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 3;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // two blocks an SM of an H100

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__global__ void absmax_partial(const float* __restrict__ vals, int n,
                               float* __restrict__ partial) {
  float m[kChannels] = {0.f, 0.f, 0.f};
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c)
      m[c] = fmaxf(m[c], fabsf(vals[r * kChannels + c]));
  }
  __shared__ float warp_max[kThreads / 32][kChannels];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    float v = m[c];
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) warp_max[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < kChannels) {
    float v = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      v = fmaxf(v, warp_max[w][threadIdx.x]);
    partial[blockIdx.x * kChannels + threadIdx.x] = v;
  }
}

__global__ void scales_final(const float* __restrict__ partial, int nblocks,
                             float qmax, float* __restrict__ out) {
  const int c = threadIdx.x;
  if (c >= kChannels) return;
  float m = 0.f;
  for (int b = 0; b < nblocks; ++b) m = fmaxf(m, partial[b * kChannels + c]);
  out[c] = __fdiv_rn(fmaxf(m, 1e-30f), qmax);
}

template <typename T>
__global__ void quantize_rows(const float* __restrict__ vals,
                              const float* __restrict__ scales, int n,
                              const int32_t* __restrict__ it,
                              uint32_t seed_mul, int stochastic, int qmax,
                              int row_offset, T* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const uint32_t iter = it != nullptr ? (uint32_t)it[0] : 0u;
  const uint32_t k = fmix32(iter ^ seed_mul);
  // the row's global id: its place among this rank's rows plus the rank's
  // first row (0 when one device holds every row)
  const uint32_t row = (uint32_t)(r + row_offset);
  const float lim = (float)qmax;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const float x = __fdiv_rn(vals[r * kChannels + c], scales[c]);
    float q;
    if (stochastic) {
      const uint32_t h =
          fmix32((row * 0x9E3779B9u) ^ ((uint32_t)c * 0x85EBCA6Bu) ^ k);
      // exact: a 24-bit integer times a power of two
      const float u = __fmul_rn((float)(h >> 8), 5.9604644775390625e-08f);
      q = floorf(__fadd_rn(x, u));
    } else {
      q = rintf(x);
    }
    q = fminf(fmaxf(q, -lim), lim);
    out[r * kChannels + c] = (T)(int)q;
  }
}

__global__ void dequant(const int32_t* __restrict__ hist,
                        const float* __restrict__ scales, long long elems,
                        const int32_t* __restrict__ active,
                        float* __restrict__ out) {
  if (active != nullptr && active[0] == 0) return;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  out[e] = __fmul_rn(__int2float_rn(hist[e]), scales[e % kChannels]);
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

// vals [n, 3] f32; partial [min(ceil(n / 256), 264), 3] f32 scratch; out
// [3] f32.  n >= 1.
extern "C" int lgbt_quant_scales(const float* vals, int n, float qmax,
                                 float* partial, float* out,
                                 cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int nblocks = blocks_for(n);
  if (nblocks > kMaxBlocks) nblocks = kMaxBlocks;
  absmax_partial<<<nblocks, kThreads, 0, stream>>>(vals, n, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scales_final<<<1, 32, 0, stream>>>(partial, nblocks, qmax, out);
  return (int)cudaGetLastError();
}

// vals [n, 3] f32, scales [3] f32, it [1] int32 or null (iteration 0);
// row_offset the global id of the first row; out [n, 3] int8 (bits 8) or
// int16 (bits 16).
extern "C" int lgbt_quantize_stack(const float* vals, const float* scales,
                                   int n, const int32_t* it,
                                   unsigned int seed_mul, int stochastic,
                                   int bits, int row_offset, void* out,
                                   cudaStream_t stream) {
  if (n < 1) return 0;
  const int qmax = (1 << (bits - 1)) - 1;
  if (bits == 8) {
    quantize_rows<int8_t><<<blocks_for(n), kThreads, 0, stream>>>(
        vals, scales, n, it, seed_mul, stochastic, qmax, row_offset,
        static_cast<int8_t*>(out));
  } else if (bits == 16) {
    quantize_rows<int16_t><<<blocks_for(n), kThreads, 0, stream>>>(
        vals, scales, n, it, seed_mul, stochastic, qmax, row_offset,
        static_cast<int16_t*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// hist [elems] int32 (trailing axis the 3 channels), scales [3] f32,
// active [1] int32 or null; out [elems] f32.
extern "C" int lgbt_dequant_hist(const int32_t* hist, const float* scales,
                                 long long elems, const int32_t* active,
                                 float* out, cudaStream_t stream) {
  if (elems < 1) return 0;
  dequant<<<blocks_for(elems), kThreads, 0, stream>>>(hist, scales, elems,
                                                      active, out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_quantize_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, absmax_partial);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&attr, quantize_rows<int8_t>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&attr, quantize_rows<int16_t>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&attr, scales_final);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, dequant);
}
