// B11 — the partitioned learner's segment programs.
//
// Replaces the three device programs of the JAX package's
// lightgbm_tpu/grower_partitioned.py, the learner whose histogram work
// grows with the smaller child (the reference's DataPartition and
// subtraction shape).  The grower keeps one device permutation `order` of
// the rows, grouped by leaf: leaf l's rows are order[begin_l, begin_l +
// count_l), with begin and count held on the host.
//
// B11a — segment histogram (`_hist_segment` :55-66):
//
//     hist[f, b, c] = sum over i < count of
//                     [binned[order[begin + i], f] == b] * vals[row, c]
//
// on binned [N, F] uint8 (F = the EFB groups on a bundled matrix), vals
// [N, 3] f32.  The TPU program gathers the segment padded to a power of
// two and runs the one-hot matmul; here the kernel reads the segment's
// true count of rows through `order`.  It follows B1's layout
// (histogram.cu `hist_partial`): each block takes a fixed range of
// segment positions, each thread one (feature, position sub-range) pair
// summed in position order into a private f64 [B, 3] slice in shared
// memory, the block's slices summed in sub-range order into a partial
// rounded once to f32, and `seg_reduce` sums the partials in block order
// in f64.  The order of every sum is fixed by the count and the shapes,
// so reruns are bitwise equal.
//   The integer form (quantized training; vals int8 or int16, exact int32
// sums, the JAX package's integer branch of compute_histogram) follows
// `hist_int_partial`: each block keeps an int32 [tile_f, B, 3] histogram
// in shared memory, each warp takes 32 positions at a time, its lanes
// read the rows' ids and channels, a ballot marks the rows with a nonzero
// channel, and the warp adds those rows one at a time, its lanes over the
// row's features, with shared-memory atomics; `seg_reduce_int` sums the
// block partials.  Integer addition is exact, so the launch shape changes
// no bit.
// Bound on this card: bytes.  A pass moves the segment's ids (4 B a
// row), its rows of the matrix (F B a row) and of vals (12 B f32, 3 or
// 6 B packed) and writes the histogram: at the main path's root (1M x 28)
// 44 MB, about 13 us at 3.35 TB/s; a small child of 7,500 rows 0.33 MB,
// 0.1 us, below the latency of one launch.
//
// B11b — stable segment partition (`_partition_segment` :69-100): the
// segment's rows in place, left block first, each block in its former
// order; returns the left count.  A row goes left iff (its bin is the
// feature's NA bin) ? default_left : rank[bin] <= threshold, with bin =
// the matrix's column `col`, or decoded from the EFB group column
// (`goff` >= 0: goff <= v < goff + nbm1 ? v - goff + 1 : 0).  The host
// passes na = -1 for a categorical split, whose rank vector is the
// winner's decision rank (the identity for a numerical split).  Three
// kernel launches and one copy:
//   1. `seg_count`: a block a tile of 1,024 positions counts its left rows;
//   2. `seg_scan`: one block scans the tiles' counts (exclusive prefix)
//      and writes the total, the left count, to a device int32;
//   3. `seg_scatter`: each position's place among the left rows before it
//      (tile prefix + warp prefix + ballot rank in the warp); a left row
//      goes to begin + that place, a right one to begin + left count +
//      (position - that place), in a second order buffer;
// then the segment is copied back over `order`.  The result equals the
// JAX program's order exactly: both are the stable partition.
// Bound on this card: bytes.  The function needs each id (4 B) and its
// column byte read once and each id written once: 9 B a row, at the
// root's split of 1M rows 9 MB, about 2.7 us at 3.35 TB/s.  This design
// moves twice that: the ids and column bytes are read by the count and
// the scatter, and the ids written by the scatter and the copy back.
//
// B11c — leaf of row (`_leaf_of_row` :103-110): leaf_of_row[order[p]] =
// seg_leaf[s], s the last segment with seg_begin[s] <= p (a binary search
// over the host's sorted segment table, the JAX program's searchsorted).
// Bound: bytes, 4 B read and 4 B written a row (8 MB at 1M rows, 2.4 us).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 3;
constexpr int kIntThreads = 1024;
constexpr int kTile = 1024;      // B11b positions a block

__global__ void seg_hist_partial(const uint8_t* __restrict__ binned,
                                 const float* __restrict__ vals,
                                 const int32_t* __restrict__ order,
                                 long long begin, int count,
                                 int num_features, int num_bins,
                                 int rows_per_block, int tile_f,
                                 int subranges, float* __restrict__ partial) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;                 // tile_f * subranges
  const int slice = num_bins * kChannels;
  for (int i = tid; i < nthreads * slice; i += nthreads) smem[i] = 0.0;
  __syncthreads();

  const int f0 = blockIdx.y * tile_f;
  const int fl = tid % tile_f;
  const int s = tid / tile_f;
  const int f = f0 + fl;
  const long long p0 = (long long)blockIdx.x * rows_per_block;
  const long long p_stop = min(p0 + rows_per_block, (long long)count);
  const int sub = (rows_per_block + subranges - 1) / subranges;
  const long long p_begin = p0 + (long long)s * sub;
  const long long p_end = min(p_begin + sub, p_stop);
  double* mine = smem + tid * slice;
  if (f < num_features) {
    for (long long p = p_begin; p < p_end; ++p) {
      const long long r = order[begin + p];
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
    double acc = smem[flocal * slice + rest];
    for (int ss = 1; ss < subranges; ++ss)
      acc += smem[(ss * tile_f + flocal) * slice + rest];
    partial[((long long)blockIdx.x * num_features + fg) * slice + rest] =
        (float)acc;
  }
}

__global__ void seg_reduce(const float* __restrict__ partial, int nblocks,
                           int elems, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  double acc = partial[e];
  for (int k = 1; k < nblocks; ++k) acc += partial[(long long)k * elems + e];
  out[e] = (float)acc;
}

template <typename T>
__global__ void seg_hist_int_partial(const uint8_t* __restrict__ binned,
                                     const T* __restrict__ vals,
                                     const int32_t* __restrict__ order,
                                     long long begin, int count,
                                     int num_features, int num_bins,
                                     int rows_per_block, int tile_f,
                                     int32_t* __restrict__ partial) {
  extern __shared__ int32_t ihist[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int slice = num_bins * kChannels;
  const int f0 = blockIdx.y * tile_f;
  const int nf = min(tile_f, num_features - f0);
  for (int i = tid; i < nf * slice; i += nthreads) ihist[i] = 0;
  __syncthreads();
  const long long p0 = (long long)blockIdx.x * rows_per_block;
  const long long p_stop = min(p0 + rows_per_block, (long long)count);
  for (long long g = p0 + (long long)warp * 32; g < p_stop;
       g += (long long)nwarps * 32) {
    const long long p = g + lane;
    int v0 = 0, v1 = 0, v2 = 0, r = 0;
    if (p < p_stop) {
      r = order[begin + p];
      v0 = vals[(long long)r * kChannels + 0];
      v1 = vals[(long long)r * kChannels + 1];
      v2 = vals[(long long)r * kChannels + 2];
    }
    uint32_t m = __ballot_sync(0xffffffffu, (v0 | v1 | v2) != 0);
    while (m != 0u) {
      const int j = __ffs(m) - 1;
      m &= m - 1u;
      const int rj = __shfl_sync(0xffffffffu, r, j);
      const int a0 = __shfl_sync(0xffffffffu, v0, j);
      const int a1 = __shfl_sync(0xffffffffu, v1, j);
      const int a2 = __shfl_sync(0xffffffffu, v2, j);
      const uint8_t* brow = binned + (long long)rj * num_features + f0;
      for (int fl = lane; fl < nf; fl += 32) {
        const int b = brow[fl];
        if (b >= num_bins) continue;
        int32_t* cell = ihist + (fl * num_bins + b) * kChannels;
        if (a0 != 0) atomicAdd(cell + 0, a0);
        if (a1 != 0) atomicAdd(cell + 1, a1);
        if (a2 != 0) atomicAdd(cell + 2, a2);
      }
    }
  }
  __syncthreads();
  for (int row = warp; row < nf; row += nwarps) {
    int32_t* dst = partial +
                   ((long long)blockIdx.x * num_features + f0 + row) * slice;
    const int32_t* src = ihist + row * slice;
    for (int e = lane; e < slice; e += 32) dst[e] = src[e];
  }
}

// unsigned, so an overflow wraps as the plain version's cast does
__global__ void seg_reduce_int(const int32_t* __restrict__ partial,
                               int nblocks, int elems,
                               int32_t* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  uint32_t acc = 0u;
  for (int k = 0; k < nblocks; ++k)
    acc += (uint32_t)partial[(long long)k * elems + e];
  out[e] = (int32_t)acc;
}

// the split predicate of B11b (see the header)
struct SegSplit {
  int col, na, goff, nbm1, thr, dleft, nrank;
};

__device__ __forceinline__ bool goes_left(const uint8_t* __restrict__ binned,
                                          int num_cols, long long r,
                                          const SegSplit& s,
                                          const int32_t* __restrict__ rank) {
  const int g = binned[r * num_cols + s.col];
  const int v = s.goff < 0
                    ? g
                    : ((g >= s.goff && g < s.goff + s.nbm1) ? g - s.goff + 1
                                                            : 0);
  if (s.na >= 0 && v == s.na) return s.dleft != 0;
  // an index past the rank vector reads its last entry, as jnp's take
  return rank[v < s.nrank ? v : s.nrank - 1] <= s.thr;
}

__global__ void seg_count(const uint8_t* __restrict__ binned, int num_cols,
                          const int32_t* __restrict__ order, long long begin,
                          int count, SegSplit s,
                          const int32_t* __restrict__ rank,
                          int32_t* __restrict__ tile_left) {
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool left =
      i < count && goes_left(binned, num_cols, order[begin + i], s, rank);
  const int n = __syncthreads_count(left);
  if (threadIdx.x == 0) tile_left[blockIdx.x] = n;
}

// one block: exclusive prefix of the tiles' left counts, in place, and
// their total into *left_count
__global__ void seg_scan(int32_t* __restrict__ tile_left, int ntiles,
                         int32_t* __restrict__ left_count) {
  __shared__ int32_t part[1024];
  const int t = threadIdx.x, nt = blockDim.x;
  const int per = (ntiles + nt - 1) / nt;
  const int a = min(t * per, ntiles), b = min(a + per, ntiles);
  int32_t sum = 0;
  for (int i = a; i < b; ++i) sum += tile_left[i];
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    const int32_t v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int32_t run = part[t] - sum;       // exclusive prefix of this chunk
  for (int i = a; i < b; ++i) {
    const int32_t c = tile_left[i];
    tile_left[i] = run;
    run += c;
  }
  if (t == nt - 1) *left_count = part[t];
}

__global__ void seg_scatter(const uint8_t* __restrict__ binned, int num_cols,
                            const int32_t* __restrict__ order,
                            long long begin, int count, SegSplit s,
                            const int32_t* __restrict__ rank,
                            const int32_t* __restrict__ tile_prefix,
                            const int32_t* __restrict__ left_count,
                            int32_t* __restrict__ out) {
  __shared__ int32_t warp_left[kTile / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long i = (long long)blockIdx.x * kTile + t;
  int32_t r = 0;
  bool left = false;
  if (i < count) {
    r = order[begin + i];
    left = goes_left(binned, num_cols, r, s, rank);
  }
  const uint32_t m = __ballot_sync(0xffffffffu, left);
  if (lane == 0) warp_left[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the block's warp counts
    const int nw = blockDim.x >> 5;
    int32_t v = lane < nw ? warp_left[lane] : 0;
    int32_t x = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane < nw) warp_left[lane] = x - v;
  }
  __syncthreads();
  if (i >= count) return;
  const long long before = (long long)tile_prefix[blockIdx.x] +
                           warp_left[warp] +
                           __popc(m & ((1u << lane) - 1u));
  const long long dest = left ? before : (long long)*left_count + i - before;
  out[begin + dest] = r;
}

__global__ void seg_leaf_of_row(const int32_t* __restrict__ order, int n,
                                const int32_t* __restrict__ seg_begin,
                                const int32_t* __restrict__ seg_leaf,
                                int num_segs,
                                int32_t* __restrict__ leaf_of_row) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  // the number of segments that begin at or before p, less one
  int lo = 0, hi = num_segs;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_begin[mid] <= p)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int s = lo - 1;
  leaf_of_row[order[p]] = seg_leaf[s < 0 ? num_segs - 1 : s];
}

}  // namespace

// B11a (f32).  partial: [ceil(count / rows_per_block), F, B, 3] f32
// scratch; out [F, B, 3]; count >= 1.
extern "C" int lgbt_segment_histogram(
    const uint8_t* binned, const float* vals, const int32_t* order,
    long long begin, int count, int num_features, int num_bins,
    int rows_per_block, int tile_f, int subranges, float* partial,
    float* out, cudaStream_t stream) {
  const int nblocks = (count + rows_per_block - 1) / rows_per_block;
  const int ntiles = (num_features + tile_f - 1) / tile_f;
  const int threads = tile_f * subranges;
  const size_t smem = (size_t)threads * num_bins * kChannels * sizeof(double);
  seg_hist_partial<<<dim3(nblocks, ntiles), threads, smem, stream>>>(
      binned, vals, order, begin, count, num_features, num_bins,
      rows_per_block, tile_f, subranges, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int elems = num_features * num_bins * kChannels;
  seg_reduce<<<(elems + 255) / 256, 256, 0, stream>>>(partial, nblocks,
                                                      elems, out);
  return (int)cudaGetLastError();
}

// B11a's integer form: vals [N, 3] int8 (bits 8) or int16 (bits 16);
// partial: [ceil(count / rows_per_block), F, B, 3] int32 scratch; out
// [F, B, 3] int32; count >= 1.
extern "C" int lgbt_segment_histogram_int(
    const uint8_t* binned, const void* vals, int bits, const int32_t* order,
    long long begin, int count, int num_features, int num_bins,
    int rows_per_block, int tile_f, int32_t* partial, int32_t* out,
    cudaStream_t stream) {
  const int nblocks = (count + rows_per_block - 1) / rows_per_block;
  const int ftiles = (num_features + tile_f - 1) / tile_f;
  const size_t smem = (size_t)tile_f * num_bins * kChannels * sizeof(int32_t);
  const dim3 grid(nblocks, ftiles);
  if (bits == 8)
    seg_hist_int_partial<int8_t><<<grid, kIntThreads, smem, stream>>>(
        binned, static_cast<const int8_t*>(vals), order, begin, count,
        num_features, num_bins, rows_per_block, tile_f, partial);
  else if (bits == 16)
    seg_hist_int_partial<int16_t><<<grid, kIntThreads, smem, stream>>>(
        binned, static_cast<const int16_t*>(vals), order, begin, count,
        num_features, num_bins, rows_per_block, tile_f, partial);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int elems = num_features * num_bins * kChannels;
  seg_reduce_int<<<(elems + 255) / 256, 256, 0, stream>>>(partial, nblocks,
                                                          elems, out);
  return (int)cudaGetLastError();
}

// B11b.  binned [N, num_cols] uint8; order [N] int32, partitioned in place
// over [begin, begin + count); rank [nrank] int32; tiles [ceil(count /
// 1024)] int32 scratch; order2 [N] int32 scratch; left_count a device
// int32 (written); count >= 1.
extern "C" int lgbt_partition_segment(
    const uint8_t* binned, int num_cols, int32_t* order, long long begin,
    int count, int col, int na, int goff, int nbm1, int thr, int dleft,
    const int32_t* rank, int nrank, int32_t* tiles, int32_t* order2,
    int32_t* left_count, cudaStream_t stream) {
  const SegSplit s{col, na, goff, nbm1, thr, dleft, nrank};
  const int ntiles = (count + kTile - 1) / kTile;
  seg_count<<<ntiles, kTile, 0, stream>>>(binned, num_cols, order, begin,
                                          count, s, rank, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_scan<<<1, 1024, 0, stream>>>(tiles, ntiles, left_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_scatter<<<ntiles, kTile, 0, stream>>>(binned, num_cols, order, begin,
                                            count, s, rank, tiles,
                                            left_count, order2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(order + begin, order2 + begin,
                        (size_t)count * sizeof(int32_t),
                        cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// B11c.  order [n] int32; seg_begin [S] int32 ascending (seg_begin[0] ==
// 0), seg_leaf [S] int32; leaf_of_row [n] int32 (written).
extern "C" int lgbt_leaf_of_row(const int32_t* order, int n,
                                const int32_t* seg_begin,
                                const int32_t* seg_leaf, int num_segs,
                                int32_t* leaf_of_row, cudaStream_t stream) {
  if (n > 0)
    seg_leaf_of_row<<<(n + 255) / 256, 256, 0, stream>>>(
        order, n, seg_begin, seg_leaf, num_segs, leaf_of_row);
  return (int)cudaGetLastError();
}

// Once per process, before any launch: let the histogram kernels use up to
// `smem_bytes` of dynamic shared memory, and load the kernels.
extern "C" int lgbt_segment_setup(int smem_bytes) {
  const void* big[] = {(const void*)seg_hist_partial,
                       (const void*)seg_hist_int_partial<int8_t>,
                       (const void*)seg_hist_int_partial<int16_t>};
  for (const void* k : big) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const void* rest[] = {(const void*)seg_reduce, (const void*)seg_reduce_int,
                        (const void*)seg_count, (const void*)seg_scan,
                        (const void*)seg_scatter,
                        (const void*)seg_leaf_of_row};
  cudaFuncAttributes attr;
  for (const void* k : rest) {
    cudaError_t err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
