// The order-free 64-bit fixed-point sums of the f32 histograms: B1-K and
// B11a (histogram.cu, segment.cu) and B8a (sparse.cu).
//
// Each channel c of vals [N, 3] f32 is scaled by 2^e_c and rounded to an
// integer, e_c = 62 - ceil(log2 M_c) - ceil(log2 N), M_c the largest
// finite |value| of the channel over all N rows (ceil(log2 M) taken as
// the frexp exponent x, M < 2^x).  No sum of at most N such integers
// reaches 2^62, so the sums are exact in int64 (two's complement, added
// as unsigned) and do not depend on the order in which atomics land: the
// launch shape and the scheduling change no bit.  A value's rounding
// error is at most 2^-(e+1) <= M * N * 2^-63; each cell is rounded once
// to f32 at the end.  The scale depends on vals alone, so every pass over
// the same vals (super-epochs, per-iteration, fused chunks, a fleet
// member and its solo run, the shadow grower) gives the same bits.
//
// Non-finite values (NaN, +-Inf) set no scale and add nothing to the
// integers: they are added apart, with f32 atomics, into a zeroed side
// buffer of the histogram's shape.  A sum of non-finite values alone does
// not depend on the order (all +Inf: +Inf; all -Inf: -Inf; else NaN), so
// the finalize writes the side value wherever it is set (non-zero) and
// the fixed-point sum elsewhere: the non-finite cells equal the plain
// versions' (f32 or f64 sums, which propagate them the same way), and no
// other cell changes.
//
// The scale's input is a table of partial maxima `mxp` [parts, 3] (the
// f32 bits of the largest finite |value| of each channel over one
// block's share of the rows), written by `absmax_parts` with no atomics
// and no clearing, and reduced by every consumer block (`block_exponents`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt_fixed {

constexpr int kChannels = 3;
// threads of an absmax_parts block
constexpr int kAbsThreads = 256;

// ceil(log2 n), 0 for n <= 1
__host__ __device__ inline int log2_ceil(long long n) {
  int l = 0;
  while ((1ll << l) < n) ++l;
  return l;
}

// the f32 bits of |v| when v is finite, else 0
__device__ __forceinline__ unsigned int finite_abs_bits(float v) {
  const unsigned int b = __float_as_uint(v) & 0x7fffffffu;
  return b < 0x7f800000u ? b : 0u;
}

// the exponent e of a channel's scale 2^e from its largest finite
// magnitude's f32 bits; an all-zero channel takes e = 0
__device__ __forceinline__ int scale_exp(unsigned int mx_bits, int log2n) {
  const float m = __uint_as_float(mx_bits);
  if (!(m > 0.0f)) return 0;
  int x;
  frexpf(m, &x);  // m < 2^x
  return 62 - x - log2n;
}

// 2^e as a double (|e| <= 1022; e lies in [-97, 210] here)
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// v * 2^e rounded to the nearest integer (the multiply by a power of two
// is exact in f64)
__device__ __forceinline__ long long quantize(float v, double scale) {
  return __double2ll_rn(__dmul_rn((double)v, scale));
}

// a cell's sum v * 2^-e, rounded once to f32
__device__ __forceinline__ float to_float(long long v, double inv) {
  return (float)__dmul_rn((double)v, inv);
}

// the output of one cell: the side value where a non-finite value landed,
// else the fixed-point sum
__device__ __forceinline__ float cell_value(long long v, float side,
                                            double inv) {
  return side != 0.0f ? side : to_float(v, inv);
}

// Block b of the grid writes the largest finite |value| of each channel
// over its grid-stride share of vals [count / 3, 3] to mxp[b * 3 + c].
// Call with every thread of the block (blockDim.x a multiple of 32, at
// most 1024).
__device__ __forceinline__ void absmax_parts(const float* __restrict__ vals,
                                             long long count, int block,
                                             int blocks,
                                             unsigned int* __restrict__ mxp) {
  __shared__ unsigned int s_mx[32][kChannels];
  unsigned int local[kChannels] = {0u, 0u, 0u};
  const long long step = (long long)blocks * blockDim.x;
  for (long long i = (long long)block * blockDim.x + threadIdx.x; i < count;
       i += step) {
    const unsigned int b = finite_abs_bits(vals[i]);
    const int c = (int)(i % kChannels);
    local[c] = local[c] > b ? local[c] : b;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < kChannels; ++c) {
    const unsigned int w = __reduce_max_sync(0xffffffffu, local[c]);
    if (lane == 0) s_mx[warp][c] = w;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    for (int c = 0; c < kChannels; ++c) {
      const unsigned int w = __reduce_max_sync(
          0xffffffffu, lane < nw ? s_mx[lane][c] : 0u);
      if (lane == 0) mxp[(long long)block * kChannels + c] = w;
    }
  }
}

// The three exponents from the partial maxima mxp [parts, 3], written to
// s_e[0..2] by warp 0 of the block (the caller synchronises after).
__device__ __forceinline__ void block_exponents(
    const unsigned int* __restrict__ mxp, int parts, int log2n, int* s_e) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  unsigned int m[kChannels] = {0u, 0u, 0u};
  for (int i = lane; i < parts; i += 32)
    for (int c = 0; c < kChannels; ++c) {
      const unsigned int b = mxp[i * kChannels + c];
      m[c] = m[c] > b ? m[c] : b;
    }
  for (int c = 0; c < kChannels; ++c) {
    const unsigned int w = __reduce_max_sync(0xffffffffu, m[c]);
    if (lane == 0) s_e[c] = scale_exp(w, log2n);
  }
}

// Add q to the 64-bit counter held as a low word `lo` and a high word
// `hi` in shared memory: the low word's atomic returns its old value, so
// its carry goes to the high word with q's high part.  The pair is the sum
// modulo 2^64 of every q added, in any order (exact: no sum reaches 2^63).
// (The card has no 64-bit shared add: `atomicAdd` on a 64-bit shared word
// compiles to a compare-and-swap loop, `ATOMS.CAST.SPIN.64`, 2x slower
// on the H100.)
__device__ __forceinline__ void add64(unsigned int* lo, unsigned int* hi,
                                      unsigned long long q) {
  const unsigned int l = (unsigned int)q;
  const unsigned int carry = atomicAdd(lo, l) + l < l ? 1u : 0u;
  const unsigned int h = (unsigned int)(q >> 32) + carry;
  if (h != 0u) atomicAdd(hi, h);
}

// A warp adds the rows of one 32-row group into a block's histogram tile
// [nk slots, nf features, B, 3], 64-bit counters held as 32-bit low words
// `lo` and high words `hi` (two arrays) in shared memory.  Lane j holds
// row j of the group: `k` its slot in the tile (ignored unless the row is
// in `m`), `q` its quantized channels, `nonfin` a bit per non-finite
// channel (`raw` its raw values), and `row` the address of its first byte
// of the tile's features (global or shared).  Bit j of `m` marks the rows
// to add.  The lanes go over a row's features, each adding the feature's
// three channels, so a row's bytes are read together and its adds go to
// different counters.  kWidth (32, 16 or 8; nf <= kWidth unless 32): the
// lanes of one row, so a warp takes 32 / kWidth rows at a time.  A
// non-finite channel adds its raw value to the side buffer cell (k0 + k,
// fg0 + f, b) of the [*, F, B, 3] layout with an f32 atomic.
template <int kWidth>
__device__ __forceinline__ void add_group(
    unsigned int* lo, unsigned int* hi, int nf, int num_bins, uint32_t m,
    int lane, int k, const long long* q, unsigned int nonfin,
    const float* raw, const uint8_t* row, float* side, int k0, int fg0,
    int num_features) {
  constexpr int kPer = 32 / kWidth;
  const int sub = lane / kWidth, fl0 = lane % kWidth;
  const int per_k = nf * num_bins * kChannels;
  while (m != 0u) {
    // this lane group's row: the sub-th of the next kPer rows of m
    int jj;
    if (kPer == 1) {
      jj = __ffs(m) - 1;
      m &= m - 1u;
    } else {
      jj = sub < __popc(m) ? (int)__fns(m, 0, sub + 1) : -1;
      for (int r = 0; r < kPer && m != 0u; ++r) m &= m - 1u;
    }
    const int j = jj < 0 ? 0 : jj;
    const int kj = __shfl_sync(0xffffffffu, k, j);
    const long long a0 = __shfl_sync(0xffffffffu, q[0], j);
    const long long a1 = __shfl_sync(0xffffffffu, q[1], j);
    const long long a2 = __shfl_sync(0xffffffffu, q[2], j);
    unsigned int nfj = __shfl_sync(0xffffffffu, nonfin, j);
    const uint8_t* rj = reinterpret_cast<const uint8_t*>(
        __shfl_sync(0xffffffffu, reinterpret_cast<uintptr_t>(row), j));
    if (jj < 0) nfj = 0u;
    if (__any_sync(0xffffffffu, nfj != 0u)) {
      // rare: a row with a non-finite channel (a warp-uniform branch)
      float w[kChannels];
      for (int c = 0; c < kChannels; ++c)
        w[c] = __shfl_sync(0xffffffffu, raw[c], j);
      if (nfj != 0u)
        for (int fl = fl0; fl < nf; fl += kWidth) {
          const int b = rj[fl];
          if (b >= num_bins) continue;
          float* s = side +
                     (((long long)(k0 + kj) * num_features + fg0 + fl) *
                          num_bins + b) * kChannels;
          for (int c = 0; c < kChannels; ++c)
            if (nfj >> c & 1u) atomicAdd(s + c, w[c]);
        }
    }
    if (jj < 0) continue;
    for (int fl = fl0; fl < nf; fl += kWidth) {
      const int b = rj[fl];
      if (b >= num_bins) continue;
      const int cell = kj * per_k + (fl * num_bins + b) * kChannels;
      add64(lo + cell, hi + cell, (unsigned long long)a0);
      add64(lo + cell + 1, hi + cell + 1, (unsigned long long)a1);
      add64(lo + cell + 2, hi + cell + 2, (unsigned long long)a2);
    }
  }
}

// Lane j's row of a group: its channels quantized (0 where non-finite),
// the non-finite bits, and whether it adds anything.
__device__ __forceinline__ bool quantize_row(const float* v, bool in,
                                             const double* scale,
                                             long long* q, float* raw,
                                             unsigned int* nonfin) {
  *nonfin = 0u;
  bool any = false;
  for (int c = 0; c < kChannels; ++c) {
    raw[c] = in ? v[c] : 0.0f;
    q[c] = 0;
    if (!in) continue;
    if (isfinite(raw[c])) {
      q[c] = quantize(raw[c], scale[c]);
      any |= q[c] != 0;
    } else {
      *nonfin |= 1u << c;
      any = true;
    }
  }
  return any;
}

// A block's tile [nk, nf, B, 3] (nk slots from k0, nf features from f0;
// low and high words) into the global accumulator [K, F, B, 3] with one
// 64-bit atomic a non-zero cell.
__device__ __forceinline__ void flush_tile(
    const unsigned int* lo, const unsigned int* hi, int nk, int nf,
    int num_bins, int k0, int f0, int num_features,
    unsigned long long* __restrict__ acc) {
  const int per_f = num_bins * kChannels;
  const int per_k = nf * per_f;
  for (int i = threadIdx.x; i < nk * per_k; i += blockDim.x) {
    const unsigned long long v = ((unsigned long long)hi[i] << 32) + lo[i];
    if (v == 0ull) continue;
    const int kl = i / per_k, r = i - kl * per_k;
    const int fl = r / per_f, rest = r - fl * per_f;
    atomicAdd(acc + ((long long)(k0 + kl) * num_features + f0 + fl) * per_f +
                  rest, v);
  }
}

}  // namespace lgbt_fixed
