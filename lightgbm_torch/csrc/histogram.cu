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
//      into a private [B, 3] f64 slice of shared memory (no atomics).  The
//      block then sums the slices of each feature in sub-range order, in
//      f64, and writes one partial [F, B, 3], rounded once to f32, to
//      global memory.  Features are tiled over grid.y when F*B does not
//      fit in shared memory.
//   2. `hist_reduce`: one thread per (f, b, c) sums the partials in block
//      order, in f64, and rounds the total once to f32.
// Precision.  A bin that holds nearly every row (a one-hot column's bin 0,
// a sparse feature's zero bin) is a sum of thousands of f32 values a
// thread.  In f32 that sum drifts by about n * 2^-24 of its size (0.86% on
// a 500,000-row one-hot set); in f64 its error is that of the one final
// rounding of each block's partial, no worse than a pairwise f32 sum
// (LightGBM's own `hist_t` is double).  The f64 slices take twice the
// shared memory of f32 ones (a 255-bin slice 6,120 B), so a block holds
// half the (feature, sub-range) pairs it held in f32.  Sums that are
// exact in f32 stay exact, bit for bit.
// Bins >= num_bins add nothing (the TPU program's one-hot drops them too).
// This is a first, simple design: every pass reads all N rows, and a
// thread's slice accesses hit data-dependent banks.
//
// `active` (optional, a device int32): the grower's step record flag.
// When it is 0 (the tree is done) both kernels return at once and write
// nothing, so a dead step of a captured tree costs two empty launches.
// The kernel's shared-memory limit is raised once, when the library is
// loaded (`lgbt_histogram_setup`), never per launch.
//
// B1-K — the K-slot form (the batched grower's child pass, grower.py
// `grow_tree_batched` :1060-1070, `_hist(..., tslot, nC)`):
//
//     hist[k, f, b, c] = sum over rows n with slot[n] == k of
//                        [binned[n, f] == b] * vals[n, c],  0 <= k < K
//
// (the JAX package lays it out as [F, B, 3K] with channel c of slot k at
// c*K + k; the port keeps [K, F, B, 3], the grower's per-leaf layout).
// Sums are 64-bit fixed point (csrc/fixed.cuh): exact integers that do
// not depend on the order of the adds, so atomics keep reruns bitwise and
// the launch shape changes no bit; each cell is rounded once to f32.
// Three launches:
//   1. `slots_prep`: clears the accumulator [K, F, B, 3] int64 and its
//      non-finite side buffer, and writes the partial maxima of vals that
//      fix each channel's scale (over all N rows: a function of vals
//      alone).
//   2. `hist_slots_tile`: grid (row ranges, tiles); each block owns one
//      tile [tk slots, tf features, B, 3] of 64-bit counters in shared
//      memory (as many slots as fit the 227 KB a block has) and adds its
//      range a warp at a time over 32 rows, as `hist_int_partial`: the
//      lanes read the rows' slots coalesced, a ballot keeps the rows whose
//      slot is in the tile's range, and the warp adds each kept row, its
//      lanes over the row's features (two or four rows at a time when a
//      tile has at most 16 or 8), each lane the feature's three channels,
//      with 32-bit shared-memory atomics (a low word whose carry goes to a
//      high word: the card has no native 64-bit shared add, and
//      `atomicAdd` on a 64-bit shared word compiles to a compare-and-swap
//      loop, `ATOMS.CAST.SPIN.64`, 2x slower on the H100).  Each warp reads
//      its rows with its own loads, so many are in flight.  The block flushes
//      its tile once, with one global 64-bit atomic a non-zero cell, into
//      the accumulator (no per-row-block partial).  A tile whose first
//      slot is at or past `slots_used` exits at once.
//   3. `slots_finalize`: each cell to f32 (the side value where a
//      non-finite value landed).
// `active` = 0 makes all three return at once; slots at or past
// `slots_used` come out zero.  A first design staged each chunk of rows
// once per thread-block cluster (TMA bulk copies multicast to the
// cluster's tiles, double-buffered on mbarriers); on the H100 it took 2.4x
// (K = 16), 3.9x (K = 64) and 4.4x (136 x 255 bins) this design's device
// time: every block of a cluster needs every row's slot but only its own
// rows' bytes, and the cluster's unique bytes in flight were one stage.
// Bound on this card: bytes, as B1 (N*F + 12N + 4N, about 44 MB at the
// main path, 13 us at 3.35 TB/s).  What sets the time now: the shared
// atomics (two 32-bit ones a (feature, channel) add of a kept row, the
// second skipped where the high part and the carry are zero), every
// tile's scan of its range's slots, and the flush's blocks x tile cells
// global atomics.

// B1-int and B1-K-int — the integer forms (quantized training, the JAX
// package's integer branch of `_compute_histogram_matmul`, ops/histogram.py
// :143-146, which contracts int8/int16 vals into exact int32): the same
// two functions on vals [N, 3] int8 or int16 (ops/quantize.py), summed
// into int32.  Integer addition is exact and order-free, so no fixed
// order is needed: each block keeps an int32 histogram of its tile in
// shared memory and adds with shared-memory atomicAdd, then writes an
// int32 partial, which `hist_reduce_int` sums in int32.  The launch shape
// therefore changes no bit of the result, and the kernel equals its plain
// version (an int64 `index_add_`) exactly.
//   `hist_int_partial`: grid (row blocks, slot tiles x feature tiles), a
//     tile [tile_k, tile_f, B, 3] int32 that fits in shared memory (28 x
//     64 x 12 B = 21.5 KB at the main path; 136 features at 255 bins take
//     two tiles; K = 16 x 28 x 63 untiled would need 338 KB).  Each warp
//     takes 32 rows at a time: each lane reads one row's slot and
//     channels (coalesced), a warp vote marks the rows in the tile's pass
//     (slot in the tile's slot range, a nonzero channel), and the warp
//     then adds those rows one at a time, its lanes over the row's
//     features (the row's bytes read together, each lane's adds to its
//     own feature's counters).  B1-int is the launch with K = 1: the
//     strict grower's slot 0 (the smaller child) or -1, or no slot at all
//     for the root pass (every row in slot 0).  A tile whose first slot is
//     at or past the device count `slots_used` writes zeros at once.
// It reads the step's `active` flag and exits at once on a dead step, so
// a pass is two launches as in the f32 forms.  Bound on this card: bytes:
// every row's slot (4 B) and, of the rows in the pass only, the binned
// row and 3 (int8) or 6 (int16) bytes of vals, plus the histogram out; a
// pass over 400,000 of 1M rows at the main shape (28 features, int8)
// moves 4 + 0.4 x 31 = 16.4 MB, about 4.9 us at 3.35 TB/s.  A first, simple design: hot bins
// serialise on their shared-memory counters, and each tile reads every
// row's slot.
//
// B1-M, B1-K-M and B1-int-M — the member axis of the JAX package's fleet
// program (models/gbdt.py `build_fleet_superepoch` :2184, which vmaps the
// super-epoch body over N members that share one binned matrix): every
// kernel above takes its per-member operands (vals, slot, active,
// slots_used, partial, out) from a `Members` table passed by value, one
// entry per member, and grid.z (grid.y for the reduces) is the member.
// The shared matrix `binned` is one pointer.  A member's blocks take the
// solo launch's row ranges, tiles and thread roles and sum in its order,
// so each member's histogram is bitwise the one a solo launch gives; a
// solo launch is the case of one member, so its bits are unchanged.  A
// member whose `active` is 0 (a dead step, or a step past its own leaf
// budget in a fleet of mixed budgets) exits at once.  Bound on this card:
// bytes, the shared matrix once (the members' blocks read its tiles
// through L2) plus each member's slot, vals and output; a first design
// whose blocks of different members read a tile separately, through L2
// when they run together.  Launches of more than kMaxMembers members go
// out in groups of kMaxMembers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed.cuh"

namespace {

constexpr int kChannels = 3;
// threads of a block of the integer forms
constexpr int kIntThreads = 1024;
// members of one launch (the table below rides in the kernel's parameter
// space, which holds 4 KB)
constexpr int kMaxMembers = 32;

// Per-member operands of one launch; member m is grid.z (grid.y in the
// reduces).  `vals` is f32, int8 or int16 by the kernel; `partial` and
// `out` are f32 or int32.
struct Members {
  const void* vals[kMaxMembers];
  const int32_t* slot[kMaxMembers];
  const int32_t* active[kMaxMembers];
  const int32_t* slots_used[kMaxMembers];
  void* partial[kMaxMembers];
  void* out[kMaxMembers];
};

// the operands of members [m0, m0 + count) from a host table of 6 x
// members pointers (vals, slot, active, slots_used, partial, out; each
// `members` long)
Members members_of(const void* const* ptrs, int members, int m0,
                   int count) {
  Members g{};
  for (int i = 0; i < count; ++i) {
    const int m = m0 + i;
    g.vals[i] = ptrs[0 * members + m];
    g.slot[i] = static_cast<const int32_t*>(ptrs[1 * members + m]);
    g.active[i] = static_cast<const int32_t*>(ptrs[2 * members + m]);
    g.slots_used[i] = static_cast<const int32_t*>(ptrs[3 * members + m]);
    g.partial[i] = const_cast<void*>(ptrs[4 * members + m]);
    g.out[i] = const_cast<void*>(ptrs[5 * members + m]);
  }
  return g;
}

__global__ void hist_partial(const uint8_t* __restrict__ binned,
                             const __grid_constant__ Members mem,
                             int n, int num_features, int num_bins,
                             int rows_per_block, int tile_f,
                             int subranges) {
  const int mi = blockIdx.z;
  const int32_t* __restrict__ active = mem.active[mi];
  if (active != nullptr && *active == 0) return;
  const float* __restrict__ vals = static_cast<const float*>(mem.vals[mi]);
  const int32_t* __restrict__ slot = mem.slot[mi];
  float* __restrict__ partial = static_cast<float*>(mem.partial[mi]);
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
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row_stop = min(row0 + rows_per_block, (long long)n);
  const int sub = (rows_per_block + subranges - 1) / subranges;
  const long long r_begin = row0 + (long long)s * sub;
  const long long r_end = min(r_begin + sub, row_stop);
  double* mine = smem + tid * slice;
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
    double acc = smem[flocal * slice + rest];
    for (int ss = 1; ss < subranges; ++ss)
      acc += smem[(ss * tile_f + flocal) * slice + rest];
    partial[((long long)blockIdx.x * num_features + fg) * slice + rest] =
        (float)acc;
  }
}

__global__ void hist_reduce(const __grid_constant__ Members mem,
                            int nblocks, int elems) {
  const int mi = blockIdx.y;
  const int32_t* __restrict__ active = mem.active[mi];
  if (active != nullptr && *active == 0) return;
  const float* __restrict__ partial =
      static_cast<const float*>(mem.partial[mi]);
  float* __restrict__ out = static_cast<float*>(mem.out[mi]);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  double acc = partial[e];
  for (int k = 1; k < nblocks; ++k) acc += partial[(long long)k * elems + e];
  out[e] = (float)acc;
}

// --- B1-K -------------------------------------------------------------

// threads of a B1-K block (a warp a 32-row group at a time)
constexpr int kSlotThreads = 1024;

// One member's B1-K workspace: the accumulator [cells3] int64 and the
// side buffer [cells3] f32 (both cleared by `slots_prep`), the partial
// maxima [parts, 3].
struct SlotWs {
  unsigned long long* acc;
  float* side;
  unsigned int* mxp;
};

__host__ __device__ __forceinline__ long long slot_clear_words(
    long long cells3) {
  return cells3 + (cells3 + 1) / 2;
}

__device__ __forceinline__ SlotWs slot_ws(void* base, long long cells3) {
  long long* w = static_cast<long long*>(base);
  return {reinterpret_cast<unsigned long long*>(w),
          reinterpret_cast<float*>(w + cells3),
          reinterpret_cast<unsigned int*>(w + slot_clear_words(cells3))};
}

__global__ void slots_prep(const __grid_constant__ Members mem, long long n,
                           long long cells3, int parts) {
  const int mi = blockIdx.y;
  const int32_t* __restrict__ active = mem.active[mi];
  if (active != nullptr && *active == 0) return;
  long long* w = static_cast<long long*>(mem.partial[mi]);
  const long long clear = slot_clear_words(cells3);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < clear; i += (long long)parts * blockDim.x)
    w[i] = 0;
  lgbt_fixed::absmax_parts(static_cast<const float*>(mem.vals[mi]), 3 * n,
                           blockIdx.x, parts, slot_ws(w, cells3).mxp);
}

// grid (row ranges x tiles, members): a block keeps one tile [tk slots,
// tf features, B, 3] as 32-bit low and high words in shared memory and
// adds one row range's rows of those slots, a row to kWidth lanes (tf <=
// kWidth, or 32).  With every slot in use, block x takes tile x % tiles
// and row range x / tiles (`rows` rows).  With fewer in use (a
// super-step's early passes; `slots_used` on the device), the tiles of
// slots past them have no rows, so the blocks are dealt over the live
// tiles instead and the rows over as many finer ranges: the grid keeps
// every SM busy whatever the count, and the fixed-point sums make the
// result independent of the dealing.
template <int kWidth>
__global__ void __launch_bounds__(kSlotThreads, 1)
    hist_slots_tile(const uint8_t* __restrict__ binned,
                    const __grid_constant__ Members mem, int n,
                    int num_features, int num_bins, int num_slots, int rows,
                    int tk, int tf, int parts, int log2n) {
  const int mi = blockIdx.z;
  const int32_t* __restrict__ active = mem.active[mi];
  if (active != nullptr && *active == 0) return;
  const int32_t* __restrict__ slots_used = mem.slots_used[mi];
  const int used =
      slots_used == nullptr ? num_slots : min(*slots_used, num_slots);
  const int F = num_features, B = num_bins;
  const int ftiles = (F + tf - 1) / tf;
  const int tiles = (num_slots + tk - 1) / tk * ftiles;
  // no row has a slot at or past `used`: the live tiles are a prefix
  const int live = min(tiles, (max(used, 0) + tk - 1) / tk * ftiles);
  if (live == 0) return;
  int tile = blockIdx.x % tiles, range = blockIdx.x / tiles;
  if (live < tiles) {
    const int ranges = gridDim.x / live;
    if ((int)blockIdx.x >= ranges * live) return;
    tile = blockIdx.x % live;
    range = blockIdx.x / live;
    rows = (int)(((n + ranges - 1) / ranges + 31) / 32 * 32);
  }
  const int k0 = tile / ftiles * tk, f0 = tile % ftiles * tf;
  const int nk = min(tk, used - k0), nf = min(tf, F - f0);
  const float* __restrict__ vals = static_cast<const float*>(mem.vals[mi]);
  const int32_t* __restrict__ slot = mem.slot[mi];
  const SlotWs ws = slot_ws(mem.partial[mi], (long long)num_slots * F * B * 3);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  extern __shared__ __align__(16) unsigned char shm[];
  int* s_e = reinterpret_cast<int*>(shm);
  const int cells = nk * nf * B * 3;
  unsigned int* lo = reinterpret_cast<unsigned int*>(shm + 16);
  for (int i = tid; i < 2 * cells; i += blockDim.x) lo[i] = 0u;
  lgbt_fixed::block_exponents(ws.mxp, parts, log2n, s_e);
  __syncthreads();
  double scale[3];
  for (int c = 0; c < 3; ++c) scale[c] = lgbt_fixed::pow2(s_e[c]);
  const long long row0 = (long long)range * rows;
  const long long row_end = min(row0 + rows, (long long)n);
  for (long long g = row0 + (long long)warp * 32; g < row_end;
       g += (long long)nwarps * 32) {
    const long long r = g + lane;
    const int k = r < row_end ? slot[r] - k0 : -1;
    long long qv[3];
    float raw[3];
    unsigned int nonfin;
    const bool any = lgbt_fixed::quantize_row(vals + r * 3, k >= 0 && k < nk,
                                              scale, qv, raw, &nonfin);
    lgbt_fixed::add_group<kWidth>(lo, lo + cells, nf, B,
                                  __ballot_sync(0xffffffffu, any), lane, k,
                                  qv, nonfin, raw, binned + r * F + f0,
                                  ws.side, k0, f0, F);
  }
  __syncthreads();
  lgbt_fixed::flush_tile(lo, lo + cells, nk, nf, B, k0, f0, F, ws.acc);
}

__global__ void slots_finalize(const __grid_constant__ Members mem,
                               long long cells3, int parts, int log2n) {
  const int mi = blockIdx.y;
  const int32_t* __restrict__ active = mem.active[mi];
  if (active != nullptr && *active == 0) return;
  __shared__ int s_e[3];
  const SlotWs ws = slot_ws(mem.partial[mi], cells3);
  lgbt_fixed::block_exponents(ws.mxp, parts, log2n, s_e);
  __syncthreads();
  double inv[3];
  for (int c = 0; c < 3; ++c) inv[c] = lgbt_fixed::pow2(-s_e[c]);
  float* __restrict__ out = static_cast<float*>(mem.out[mi]);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cells3; i += (long long)gridDim.x * blockDim.x)
    out[i] = lgbt_fixed::cell_value((long long)ws.acc[i], ws.side[i],
                                    inv[i % 3]);
}

// the int32 partials of the integer forms, summed in block order (exact;
// unsigned, so an overflow would wrap as the plain version's cast does)
__global__ void hist_reduce_int(const __grid_constant__ Members mem,
                                int nblocks, int elems) {
  const int mi = blockIdx.y;
  const int32_t* __restrict__ active = mem.active[mi];
  if (active != nullptr && *active == 0) return;
  const int32_t* __restrict__ partial =
      static_cast<const int32_t*>(mem.partial[mi]);
  int32_t* __restrict__ out = static_cast<int32_t*>(mem.out[mi]);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  uint32_t acc = 0u;
  for (int k = 0; k < nblocks; ++k)
    acc += (uint32_t)partial[(long long)k * elems + e];
  out[e] = (int32_t)acc;
}

// the rows of a 32-row group that are in the pass (bit j of `m` for row
// g + j, whose slot in the tile is lane j's `k` and whose channels are
// lane j's v0..v2) into the tile's histograms `h` [tile slots, nf, B, 3]:
// one row at a time, the warp's lanes over the row's nf features, so a
// row's bytes are read together and its adds go to nf different counters.
// A one-slot tile passes a `tile_stride` of 0 and skips the slot's
// shuffle, which costs B1-int measurably.
__device__ __forceinline__ void add_group_int(
    int32_t* h, int tile_stride, const uint8_t* __restrict__ binned,
    long long g, int lane, uint32_t m, int k, int v0, int v1, int v2,
    int num_features, int f0, int nf, int num_bins) {
  while (m != 0u) {
    const int j = __ffs(m) - 1;
    m &= m - 1u;
    const int kj = tile_stride == 0 ? 0 : __shfl_sync(0xffffffffu, k, j);
    const int a0 = __shfl_sync(0xffffffffu, v0, j);
    const int a1 = __shfl_sync(0xffffffffu, v1, j);
    const int a2 = __shfl_sync(0xffffffffu, v2, j);
    const uint8_t* brow = binned + (g + j) * num_features + f0;
    int32_t* hk = h + kj * tile_stride;
    for (int fl = lane; fl < nf; fl += 32) {
      const int b = brow[fl];
      if (b >= num_bins) continue;
      int32_t* cell = hk + (fl * num_bins + b) * kChannels;
      if (a0 != 0) atomicAdd(cell + 0, a0);
      if (a1 != 0) atomicAdd(cell + 1, a1);
      if (a2 != 0) atomicAdd(cell + 2, a2);
    }
  }
}

template <typename T>
__global__ void hist_int_partial(
    const uint8_t* __restrict__ binned, const __grid_constant__ Members mem,
    int n, int num_features, int num_bins, int num_slots,
    int rows_per_block, int tile_f, int tile_k) {
  const int mi = blockIdx.z;
  const int32_t* __restrict__ active = mem.active[mi];
  if (active != nullptr && *active == 0) return;
  const T* __restrict__ vals = static_cast<const T*>(mem.vals[mi]);
  const int32_t* __restrict__ slot = mem.slot[mi];
  const int32_t* __restrict__ slots_used = mem.slots_used[mi];
  int32_t* __restrict__ partial = static_cast<int32_t*>(mem.partial[mi]);
  extern __shared__ int32_t ihist[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int slice = num_bins * kChannels;
  const int ftiles = (num_features + tile_f - 1) / tile_f;
  const int f0 = (blockIdx.y % ftiles) * tile_f;
  const int k0 = (blockIdx.y / ftiles) * tile_k;
  const int nf = min(tile_f, num_features - f0);
  const int nk = min(tile_k, num_slots - k0);
  const int tile_elems = nk * nf * slice;
  const int used =
      slots_used == nullptr ? num_slots : min(*slots_used, num_slots);
  if (k0 < used) {
    for (int i = tid; i < tile_elems; i += nthreads) ihist[i] = 0;
    __syncthreads();
    const long long row0 = (long long)blockIdx.x * rows_per_block;
    const long long row_stop = min(row0 + rows_per_block, (long long)n);
    for (long long g = row0 + (long long)warp * 32; g < row_stop;
         g += (long long)nwarps * 32) {
      const long long r = g + lane;
      int v0 = 0, v1 = 0, v2 = 0, k = -1;
      if (r < row_stop) {
        k = (slot == nullptr ? 0 : slot[r]) - k0;
        if (k >= 0 && k < nk) {
          v0 = vals[r * kChannels + 0];
          v1 = vals[r * kChannels + 1];
          v2 = vals[r * kChannels + 2];
        }
      }
      const uint32_t m =
          __ballot_sync(0xffffffffu, (v0 | v1 | v2) != 0);
      add_group_int(ihist, nk == 1 ? 0 : nf * slice, binned, g, lane, m, k,
                    v0, v1, v2, num_features, f0, nf, num_bins);
    }
    __syncthreads();
  }
  // the tile's (slot, feature) rows of the partial [row blocks, K, F, B, 3],
  // a row a warp
  for (int row = warp; row < nk * nf; row += nwarps) {
    const int kl = row / nf, fl = row - kl * nf;
    int32_t* dst = partial + (((long long)blockIdx.x * num_slots + k0 + kl) *
                              num_features + f0 + fl) * slice;
    const int32_t* srcr = ihist + row * slice;
    for (int e = lane; e < slice; e += 32) dst[e] = k0 < used ? srcr[e] : 0;
  }
}

template <typename T>
int launch_hist_int(const uint8_t* binned, const Members& g, int count,
                    int n, int num_features, int num_bins, int num_slots,
                    int rows_per_block, int tile_f, int tile_k,
                    cudaStream_t stream) {
  const int nblocks = (n + rows_per_block - 1) / rows_per_block;
  const int ftiles = (num_features + tile_f - 1) / tile_f;
  const int ktiles = (num_slots + tile_k - 1) / tile_k;
  const size_t smem =
      (size_t)tile_k * tile_f * num_bins * kChannels * sizeof(int32_t);
  hist_int_partial<T>
      <<<dim3(nblocks, ftiles * ktiles, count), kIntThreads, smem,
         stream>>>(binned, g, n, num_features, num_bins, num_slots,
                   rows_per_block, tile_f, tile_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int elems = num_slots * num_features * num_bins * kChannels;
  hist_reduce_int<<<dim3((elems + 255) / 256, count), 256, 0, stream>>>(
      g, nblocks, elems);
  return (int)cudaGetLastError();
}

int launch_hist(const uint8_t* binned, const Members& g, int count, int n,
                int num_features, int num_bins, int rows_per_block,
                int tile_f, int subranges, cudaStream_t stream) {
  const int nblocks = (n + rows_per_block - 1) / rows_per_block;
  const int ntiles = (num_features + tile_f - 1) / tile_f;
  const int threads = tile_f * subranges;
  const size_t smem = (size_t)threads * num_bins * kChannels * sizeof(double);
  hist_partial<<<dim3(nblocks, ntiles, count), threads, smem, stream>>>(
      binned, g, n, num_features, num_bins, rows_per_block, tile_f,
      subranges);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int elems = num_features * num_bins * kChannels;
  hist_reduce<<<dim3((elems + 255) / 256, count), 256, 0, stream>>>(
      g, nblocks, elems);
  return (int)cudaGetLastError();
}

// B1-K's launch: the host table of ops/histogram.py `slots_launch_shape`
// (rows, tile_k, tile_f) and the scale's partial maxima `parts`; three
// launches: clear and scale, tiles, finalize.
int launch_hist_slots(const uint8_t* binned, const Members& g, int count,
                      int n, int num_features, int num_bins, int num_slots,
                      int rows, int tk, int tf, int parts,
                      cudaStream_t stream) {
  const long long cells3 = (long long)num_slots * num_features * num_bins * 3;
  const int log2n = lgbt_fixed::log2_ceil(n);
  slots_prep<<<dim3(parts, count), lgbt_fixed::kAbsThreads, 0, stream>>>(
      g, n, cells3, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles =
      (num_slots + tk - 1) / tk * ((num_features + tf - 1) / tf);
  const size_t smem = 16 + (size_t)tk * tf * num_bins * kChannels * 8;
  const dim3 grid((n + rows - 1) / rows * tiles, 1, count);
  if (tf <= 8)
    hist_slots_tile<8><<<grid, kSlotThreads, smem, stream>>>(
        binned, g, n, num_features, num_bins, num_slots, rows, tk, tf, parts,
        log2n);
  else if (tf <= 16)
    hist_slots_tile<16><<<grid, kSlotThreads, smem, stream>>>(
        binned, g, n, num_features, num_bins, num_slots, rows, tk, tf, parts,
        log2n);
  else
    hist_slots_tile<32><<<grid, kSlotThreads, smem, stream>>>(
        binned, g, n, num_features, num_bins, num_slots, rows, tk, tf, parts,
        log2n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long fb = (cells3 + 255) / 256;
  slots_finalize<<<dim3((unsigned)(fb < 264 ? fb : 264), count), 256, 0,
                   stream>>>(g, cells3, parts, log2n);
  return (int)cudaGetLastError();
}

// one member's operands as a table of one
Members one_member(const void* vals, const int32_t* slot,
                   const int32_t* active, const int32_t* slots_used,
                   void* partial, void* out) {
  const void* ptrs[6] = {vals, slot, active, slots_used, partial, out};
  return members_of(ptrs, 1, 0, 1);
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
  return launch_hist(binned,
                     one_member(vals, slot, active, nullptr, partial, out),
                     1, n, num_features, num_bins, rows_per_block, tile_f,
                     subranges, stream);
}

// The K-slot form.  rows, tile_k, tile_f: `slots_launch_shape`; ws: the
// workspace, int64 [K*F*B*3 + ceil(K*F*B*3 / 2) + ceil(parts*3 / 2)]
// (cleared here); out: [K, F, B, 3].  active may be null; slots_used (a
// device int32) promises that no row has a slot >= it.
extern "C" int lgbt_histogram_slots(const uint8_t* binned, const float* vals,
                                    const int32_t* slot, int n,
                                    int num_features, int num_bins,
                                    int num_slots, int rows, int tile_k,
                                    int tile_f, int parts,
                                    const int32_t* active,
                                    const int32_t* slots_used, void* ws,
                                    float* out, cudaStream_t stream) {
  return launch_hist_slots(
      binned, one_member(vals, slot, active, slots_used, ws, out), 1, n,
      num_features, num_bins, num_slots, rows, tile_k, tile_f, parts,
      stream);
}

// The integer forms (B1-K-int; B1-int with num_slots 1).  vals [n, 3]
// int8 (bits 8) or int16 (bits 16); partial: [ceil(n / rows_per_block), K,
// F, B, 3] int32 scratch; out: [K, F, B, 3] int32.  A row adds to slot
// slot[r] when that is in [0, K) (to slot 0 when slot is null).  active
// and slots_used may be null; slots_used (a device int32) promises that no
// row has a slot >= it.
extern "C" int lgbt_histogram_int(
    const uint8_t* binned, const void* vals, int bits, const int32_t* slot,
    int n, int num_features, int num_bins, int num_slots, int rows_per_block,
    int tile_f, int tile_k, const int32_t* active, const int32_t* slots_used,
    int32_t* partial, int32_t* out, cudaStream_t stream) {
  const Members g = one_member(vals, slot, active, slots_used, partial, out);
  if (bits == 8)
    return launch_hist_int<int8_t>(binned, g, 1, n, num_features, num_bins,
                                   num_slots, rows_per_block, tile_f, tile_k,
                                   stream);
  if (bits == 16)
    return launch_hist_int<int16_t>(binned, g, 1, n, num_features, num_bins,
                                    num_slots, rows_per_block, tile_f,
                                    tile_k, stream);
  return (int)cudaErrorInvalidValue;
}

// The member forms (B1-M, B1-K-M, B1-int-M): `ptrs` is a host table of 6 x
// `members` pointers, each row `members` long: vals, slot, active,
// slots_used, partial, out (null where the solo form takes null), with the
// solo form's shapes per member (shape1, shape2: B1's tile_f and
// subranges, B1-K's tile_k and tile_f, the integer forms' tile_f and
// tile_k; shape3 B1-K's parts; B1-K's `partial` is the member's
// workspace).  `form` 0 is B1 (f32, slot optional), 1 B1-K (f32,
// num_slots K), 2 the integer forms (int8 or int16 vals by `bits`).
// Members go out kMaxMembers to a launch.
extern "C" int lgbt_histogram_members(
    const uint8_t* binned, const void* const* ptrs, int members, int form,
    int bits, int n, int num_features, int num_bins, int num_slots,
    int rows_per_block, int shape1, int shape2, int shape3,
    cudaStream_t stream) {
  if (members < 1 || form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  for (int m0 = 0; m0 < members; m0 += kMaxMembers) {
    const int count =
        members - m0 < kMaxMembers ? members - m0 : kMaxMembers;
    const Members g = members_of(ptrs, members, m0, count);
    int err;
    if (form == 0)
      err = launch_hist(binned, g, count, n, num_features, num_bins,
                        rows_per_block, shape1, shape2, stream);
    else if (form == 1)
      err = launch_hist_slots(binned, g, count, n, num_features, num_bins,
                              num_slots, rows_per_block, shape1, shape2,
                              shape3, stream);
    else if (bits == 8)
      err = launch_hist_int<int8_t>(binned, g, count, n, num_features,
                                    num_bins, num_slots, rows_per_block,
                                    shape1, shape2, stream);
    else if (bits == 16)
      err = launch_hist_int<int16_t>(binned, g, count, n, num_features,
                                     num_bins, num_slots, rows_per_block,
                                     shape1, shape2, stream);
    else
      err = (int)cudaErrorInvalidValue;
    if (err != 0) return err;
  }
  return 0;
}

// Once per process, before any launch: let hist_partial, hist_slots_tile
// and the integer forms use up to `smem_bytes` of dynamic shared memory,
// and load the kernels.
extern "C" int lgbt_histogram_setup(int smem_bytes) {
  const void* big[] = {(const void*)hist_partial,
                       (const void*)hist_slots_tile<8>,
                       (const void*)hist_slots_tile<16>,
                       (const void*)hist_slots_tile<32>,
                       (const void*)hist_int_partial<int8_t>,
                       (const void*)hist_int_partial<int16_t>};
  for (const void* k : big) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes attr;
  const void* rest[] = {(const void*)hist_reduce_int,
                        (const void*)hist_reduce, (const void*)slots_prep,
                        (const void*)slots_finalize};
  for (const void* k : rest) {
    const cudaError_t err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
