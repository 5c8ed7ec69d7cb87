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
// rows in [0, slots_used) each to their slot; the batched grower).
// Output [S, F, num_bins, 3] f32; slots at or past `slots_used` come out
// zero; an `active` flag of 0 (a dead step) makes every kernel return at
// once (nothing is written).
//
// Deterministic without an order: the sums are 64-bit fixed point
// (csrc/fixed.cuh, shared with B1-K and B11a): each channel's scale 2^e
// comes from its largest finite magnitude over all N rows of vals and
// ceil(log2 N), each value is rounded to an integer at that scale, and
// the integer sums do not depend on the order or grouping of the adds.
// So the launch shape, the tiles and the row ranges change no bit, and
// every rerun is bitwise equal.  The fill is an exact integer
// subtraction; each bin is rounded once to f32.  Non-finite values (NaN,
// +-Inf) go to f32 side sums of the cells and the slots' totals instead;
// the fill takes their side total minus the side sum of the feature's
// stored cells, and a cell whose side value is set (non-zero) outputs it.
//
// Three launches:
//   1. `sparse_prep`: clears the accumulators of the live slots only
//      (those below `slots_used`, read on the device) and the totals, and
//      writes the partial maxima of vals that fix the scale
//      (`lgbt_fixed::absmax_parts`: no atomics, nothing to clear).
//   2. The pass.  A warp takes 32 consecutive rows at a time: its lanes
//      read the rows' slots coalesced (no slot read in the root form),
//      quantize the kept rows' three channels, and a ballot marks the kept
//      rows with a non-zero channel.  The warp then walks the kept rows'
//      entries as one flattened list, 32 at a time (a full group's 32 x K
//      entries are one contiguous read; the root pass issues four such
//      passes' loads before their adds), each lane taking its entry's
//      row values from the row's lane by shuffle; padding (-1) adds
//      nothing.  Each row's slot and vals are read once, and a row outside
//      the pass costs its 4-byte slot and nothing more.
//      - `rows_pass` (the strict and K forms, a few thousand to a few
//        hundred thousand rows): the warps of a fixed grid (as many blocks
//        as the card holds, so the pass captures into a CUDA graph)
//        stride over the row groups.  Each kept entry adds its three
//        integers into the block's cache of cells in shared memory (1,024
//        entries, a cell at its hash, claimed by compare-and-swap: the
//        cells on the leaf's path, which every row of the pass hits, add
//        there) or, where another cell holds that entry, with 64-bit
//        global atomics into the L2-resident accumulator [S, F, stride,
//        3].  Each block sums its rows' slot totals in shared memory;
//        both flush once.
//      - `root_tile` (every row): a global atomic an entry would be 105M
//        of them at 1M x 35 entries.  Each block keeps a tile of the
//        feature axis, [tile_f, stride, 3] 64-bit counters as 32-bit low
//        and high words in shared memory (`lgbt_fixed::add64`: the card
//        has no 64-bit shared add), scans one range of rows, adds the
//        entries that fall in its tile, and flushes its non-zero cells
//        with one 64-bit global atomic each.  Block x takes tile x %
//        tiles and row range x / tiles, so a range's tiles run together
//        and its second read of the entries comes from L2.  The host
//        plan (sparse_data.py `root_plan`) sizes the tiles from F and
//        the stride and picks the ranges.  The tile-0 blocks sum the
//        rows' totals (a warp sum a group, then one add a channel).
//   3. `sparse_finalize`: one thread a (slot, feature, channel) of the
//      live slots: its stored mass over the stride, the fill, the f32
//      rounding; zeros for the slots at or past `slots_used`.
//
// Bound on this card: bytes.  A pass must read every row's slot (4 B, not
// in the root form) and, of the pass's rows only, their entries (4 K B)
// and vals (12 B), and write the output; at the root pass (1M rows, K =
// 35) that is 156 MB, 46.6 us at 3.35 TB/s; a strict child of 7,532 rows
// 1.1 MB beside the 4 MB of slots.  What the design pays beyond that:
// the scale's read of all N rows of vals (12 MB) in every pass; the root
// pass's shared atomics (two 32-bit ones a channel of an entry), its
// walk of every entry for each tile and its second read of the entries;
// the slotted passes' cache probes and 64-bit global atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed.cuh"

namespace {

using lgbt_fixed::kChannels;

constexpr unsigned int kFull = 0xffffffffu;
// threads of a `sparse_prep`, a `rows_pass` and a `root_tile` block
constexpr int kPrepThreads = 1024;
constexpr int kRowThreads = 512;
constexpr int kTileThreads = 1024;
// entries a lane loads before it adds them (loads in flight): the root
// pass walks every row's entries, a slotted pass one or two rows' at a
// time
constexpr int kTileBatch = 4;
constexpr int kRowBatch = 1;
// bytes ahead of a root tile in shared memory: the exponents and the
// totals' low and high words
constexpr int kTileHead = 64;
// `sparse_finalize` blocks at most
constexpr int kFinalizeBlocks = 528;
// `rows_pass`'s cache of cells in shared memory: entries (a power of
// two) and the empty key; the most slots its launch is sized for
constexpr int kCacheLog2 = 10;
constexpr int kCacheSize = 1 << kCacheLog2;
constexpr unsigned int kEmptyKey = 0xffffffffu;
constexpr int kMaxRowSlots = 64;

// `rows_pass`'s grid: as many blocks as the card holds at once, read by
// `lgbt_sparse_setup`
int g_row_blocks = 132 * 3;

// dynamic shared memory of a `rows_pass` block: the exponents, the
// slots' totals (low and high words), the cache's keys and values
__host__ __device__ __forceinline__ size_t row_smem(int slots) {
  return 16 + (size_t)slots * kChannels * 8 +
         (size_t)kCacheSize * (4 + kChannels * 8);
}

// The pass's workspace (sparse_data.py `ws_layout`): acc [S, F, stride, 3]
// and tot [S, 3] int64, their side sums [S, F, stride, 3] and [S, 3] f32,
// and mxp [parts, 3], the partial maxima of vals (f32 bits).
struct SparseWs {
  unsigned long long* acc;
  unsigned long long* tot;
  float* side_acc;
  float* side_tot;
  unsigned int* mxp;
};

__host__ __device__ __forceinline__ SparseWs sparse_ws(long long* w,
                                                       int slots,
                                                       long long cells) {
  const long long a = (long long)slots * cells * 3, t = (long long)slots * 3;
  const long long ints = a + t;
  float* f = reinterpret_cast<float*>(w + ints);
  return {reinterpret_cast<unsigned long long*>(w),
          reinterpret_cast<unsigned long long*>(w + a), f, f + a,
          reinterpret_cast<unsigned int*>(w + ints + (ints + 1) / 2)};
}

// the slots in use: min(*slots_used, slots), or every slot without it
__device__ __forceinline__ int live_slots(const int32_t* slots_used,
                                          int slots) {
  if (slots_used == nullptr) return slots;
  const int u = *slots_used;
  return u < 0 ? 0 : (u < slots ? u : slots);
}

// row r's slot in the pass, -1 outside it: every row without a slot
// vector; slot >= 0 as slot 0 (num_slots 0); slot in [0, used) (K form)
__device__ __forceinline__ int pass_slot(const int32_t* __restrict__ slot,
                                         long long r, int num_slots,
                                         int used) {
  const int s = slot == nullptr ? 0 : slot[r];
  if (num_slots == 0) return s >= 0 ? 0 : -1;
  return s >= 0 && s < used ? s : -1;
}

// Clear the live slots' accumulators and the totals, and write the
// partial maxima of vals.
__global__ void sparse_prep(const float* __restrict__ vals, long long n,
                            int num_slots, int slots, long long cells,
                            const int32_t* __restrict__ slots_used,
                            const int32_t* __restrict__ active, int parts,
                            SparseWs ws) {
  if (active != nullptr && *active == 0) return;
  const int used = num_slots == 0 ? 1 : live_slots(slots_used, slots);
  const long long live = (long long)used * cells * kChannels;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = i0; i < live; i += step) {
    ws.acc[i] = 0ull;
    ws.side_acc[i] = 0.0f;
  }
  for (long long i = i0; i < (long long)slots * kChannels; i += step) {
    ws.tot[i] = 0ull;
    ws.side_tot[i] = 0.0f;
  }
  lgbt_fixed::absmax_parts(vals, kChannels * n, blockIdx.x, parts, ws.mxp);
}

// the sum modulo 2^64 of the warp's 32 values (exact: no total reaches
// 2^63)
__device__ __forceinline__ unsigned long long warp_sum(long long v) {
  unsigned long long t = (unsigned long long)v;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  return t;
}

// The totals of a 32-row group: lane j's row (slot s, quantized channels
// q, non-finite bits and raw values) into its slot's total (`tlo`/`thi`,
// 32-bit low and high words in shared memory; the non-finite ones to the
// side total).  `one`: every row of the group is in slot 0, so the warp
// sums first (32 lanes adding to the same three words would serialize).
__device__ __forceinline__ void add_totals(bool one, bool any, int s,
                                           const long long* q,
                                           unsigned int nonfin,
                                           const float* raw, int lane,
                                           unsigned int* tlo,
                                           unsigned int* thi,
                                           const SparseWs& ws) {
  for (int c = 0; c < kChannels; ++c) {
    if (one) {
      const unsigned long long t = warp_sum(q[c]);
      if (lane == 0 && t != 0ull) lgbt_fixed::add64(tlo + c, thi + c, t);
    } else if (any && q[c] != 0) {
      lgbt_fixed::add64(tlo + s * kChannels + c, thi + s * kChannels + c,
                        (unsigned long long)q[c]);
    }
    if (nonfin >> c & 1u) atomicAdd(ws.side_tot + s * kChannels + c, raw[c]);
  }
}

// The cache entry of `cell`: the entry at its hash, claimed with a
// compare-and-swap on the key, or -1 when another cell holds it.
__device__ __forceinline__ int cache_entry(unsigned int* key,
                                           unsigned int cell) {
  const unsigned int h = (cell * 2654435761u) >> (32 - kCacheLog2);
  unsigned int old = key[h];
  if (old == kEmptyKey) old = atomicCAS(key + h, kEmptyKey, cell);
  return old == kEmptyKey || old == cell ? (int)h : -1;
}

// The entries of the rows of a 32-row group marked in `m`, walked as one
// list: pass p takes entries 32p .. 32p + 31 of the rows' concatenated
// entry lists, kB passes' loads issued before their adds.  Lane j holds
// row j's index `row`, slot `s`, quantized channels `q`, non-finite bits
// and raw values.  kTile: add the entries of cells [e0, e0 + ne) into the
// block's tile (`lo`/`hi`); else add every valid entry into the block's
// cache (`key`, `lo`/`hi`) or, where the cache has no room, into the
// global accumulator.
template <bool kTile, int kB>
__device__ __forceinline__ void add_entries(
    const int32_t* __restrict__ flat, int k, long long row, uint32_t m,
    int lane, int s, const long long* q, unsigned int nonfin,
    const float* raw, long long cells, int e0, int ne, unsigned int* key,
    unsigned int* lo, unsigned int* hi, const SparseWs& ws) {
  const int total = __popc(m) * k;
  // the marked rows are the group's first ones (a full group): a row's
  // rank in the list is its lane
  const bool prefix = (m & (m + 1u)) == 0u;
  const bool any_nonfin = __any_sync(kFull, nonfin != 0u);
  for (int base = 0; base < total; base += 32 * kB) {
    int src[kB], ent[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int i = base + u * 32 + lane;
      const int kk = i < total ? i / k : 0;
      src[u] = prefix ? kk : (int)__fns(m, 0, kk + 1);
      const long long rj = __shfl_sync(kFull, row, src[u]);
      ent[u] = i < total ? flat[rj * k + (i - kk * k)] : -1;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (base + u * 32 >= total) break;
      const long long a[kChannels] = {__shfl_sync(kFull, q[0], src[u]),
                                      __shfl_sync(kFull, q[1], src[u]),
                                      __shfl_sync(kFull, q[2], src[u])};
      const int sj = kTile ? 0 : __shfl_sync(kFull, s, src[u]);
      unsigned int nf = 0u;
      float w[kChannels] = {0.0f, 0.0f, 0.0f};
      if (any_nonfin) {  // rare: a row with a non-finite value
        nf = __shfl_sync(kFull, nonfin, src[u]);
        for (int c = 0; c < kChannels; ++c)
          w[c] = __shfl_sync(kFull, raw[c], src[u]);
      }
      const int e = ent[u];
      if (kTile) {
        const int le = e - e0;
        if (le < 0 || le >= ne) continue;
        for (int c = 0; c < kChannels; ++c) {
          if (a[c] != 0)
            lgbt_fixed::add64(lo + le * kChannels + c,
                              hi + le * kChannels + c,
                              (unsigned long long)a[c]);
          if (nf >> c & 1u)
            atomicAdd(ws.side_acc + (long long)e * kChannels + c, w[c]);
        }
      } else {
        if (e < 0 || e >= cells) continue;
        const long long cell = (long long)sj * cells + e;
        const int ce =
            cell < kEmptyKey ? cache_entry(key, (unsigned int)cell) : -1;
        for (int c = 0; c < kChannels; ++c) {
          if (a[c] != 0) {
            if (ce >= 0)
              lgbt_fixed::add64(lo + ce * kChannels + c,
                                hi + ce * kChannels + c,
                                (unsigned long long)a[c]);
            else
              atomicAdd(ws.acc + cell * kChannels + c,
                        (unsigned long long)a[c]);
          }
          if (nf >> c & 1u)
            atomicAdd(ws.side_acc + cell * kChannels + c, w[c]);
        }
      }
    }
  }
}

// a block's slot totals (low and high words) into the global totals
__device__ __forceinline__ void flush_totals(const unsigned int* tlo,
                                             const unsigned int* thi,
                                             int count,
                                             unsigned long long* tot) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const unsigned long long v = ((unsigned long long)thi[i] << 32) + tlo[i];
    if (v != 0ull) atomicAdd(tot + i, v);
  }
}

// The strict and K forms (and the root form when its tiles would be too
// many): a fixed grid strides over the 32-row groups.
__global__ void __launch_bounds__(kRowThreads)
    rows_pass(const int32_t* __restrict__ flat, int k, long long n,
              const float* __restrict__ vals,
              const int32_t* __restrict__ slot, int num_slots, int slots,
              long long cells, const int32_t* __restrict__ slots_used,
              const int32_t* __restrict__ active, int parts, int log2n,
              SparseWs ws) {
  if (active != nullptr && *active == 0) return;
  extern __shared__ __align__(16) unsigned char shm[];
  int* s_e = reinterpret_cast<int*>(shm);
  unsigned int* tlo = reinterpret_cast<unsigned int*>(shm + 16);
  unsigned int* thi = tlo + slots * kChannels;
  unsigned int* key = thi + slots * kChannels;
  unsigned int* clo = key + kCacheSize;
  unsigned int* chi = clo + kCacheSize * kChannels;
  for (int i = threadIdx.x; i < 2 * slots * kChannels; i += blockDim.x)
    tlo[i] = 0u;
  for (int i = threadIdx.x; i < kCacheSize; i += blockDim.x)
    key[i] = kEmptyKey;
  for (int i = threadIdx.x; i < 2 * kCacheSize * kChannels; i += blockDim.x)
    clo[i] = 0u;
  lgbt_fixed::block_exponents(ws.mxp, parts, log2n, s_e);
  __syncthreads();
  double scale[kChannels];
  for (int c = 0; c < kChannels; ++c) scale[c] = lgbt_fixed::pow2(s_e[c]);
  const int used = num_slots == 0 ? 1 : live_slots(slots_used, slots);
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long step = (long long)gridDim.x * warps * 32;
  for (long long g = ((long long)blockIdx.x * warps + (threadIdx.x >> 5)) * 32;
       g < n; g += step) {
    const long long r = g + lane;
    const int s = r < n ? pass_slot(slot, r, num_slots, used) : -1;
    long long q[kChannels];
    float raw[kChannels];
    unsigned int nonfin;
    const bool any = lgbt_fixed::quantize_row(vals + r * kChannels, s >= 0,
                                              scale, q, raw, &nonfin);
    const uint32_t m = __ballot_sync(kFull, any);
    if (m == 0u) continue;
    add_totals(slot == nullptr, any, s < 0 ? 0 : s, q, nonfin, raw, lane,
               tlo, thi, ws);
    add_entries<false, kRowBatch>(flat, k, r, m, lane, s, q, nonfin, raw,
                                  cells, 0, 0, key, clo, chi, ws);
  }
  __syncthreads();
  flush_totals(tlo, thi, slots * kChannels, ws.tot);
  for (int i = threadIdx.x; i < kCacheSize; i += blockDim.x) {
    const unsigned int cell = key[i];
    if (cell == kEmptyKey) continue;
    for (int c = 0; c < kChannels; ++c) {
      const unsigned long long v =
          ((unsigned long long)chi[i * kChannels + c] << 32) +
          clo[i * kChannels + c];
      if (v != 0ull) atomicAdd(ws.acc + (long long)cell * kChannels + c, v);
    }
  }
}

// The root form: block x adds row range x / tiles (`rows` rows) into its
// tile x % tiles of `tile_f` features (module comment).
__global__ void __launch_bounds__(kTileThreads, 1)
    root_tile(const int32_t* __restrict__ flat, int k, long long n,
              const float* __restrict__ vals, int num_features, int stride,
              int tile_f, int tiles, long long rows,
              const int32_t* __restrict__ active, int parts, int log2n,
              SparseWs ws) {
  if (active != nullptr && *active == 0) return;
  const int tile = blockIdx.x % tiles;
  const long long row0 = (long long)(blockIdx.x / tiles) * rows;
  const long long row_end = min(row0 + rows, n);
  const int f0 = tile * tile_f;
  const int nf = min(tile_f, num_features - f0);
  const int e0 = f0 * stride, ne = nf * stride;
  extern __shared__ __align__(16) unsigned char shm[];
  int* s_e = reinterpret_cast<int*>(shm);
  unsigned int* tlo = reinterpret_cast<unsigned int*>(shm + 16);
  unsigned int* thi = tlo + kChannels;
  unsigned int* lo = reinterpret_cast<unsigned int*>(shm + kTileHead);
  unsigned int* hi = lo + ne * kChannels;
  for (int i = threadIdx.x; i < 2 * kChannels; i += blockDim.x) tlo[i] = 0u;
  for (int i = threadIdx.x; i < 2 * ne * kChannels; i += blockDim.x)
    lo[i] = 0u;
  lgbt_fixed::block_exponents(ws.mxp, parts, log2n, s_e);
  __syncthreads();
  double scale[kChannels];
  for (int c = 0; c < kChannels; ++c) scale[c] = lgbt_fixed::pow2(s_e[c]);
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (long long g = row0 + (long long)(threadIdx.x >> 5) * 32; g < row_end;
       g += (long long)warps * 32) {
    const long long r = g + lane;
    long long q[kChannels];
    float raw[kChannels];
    unsigned int nonfin;
    const bool any = lgbt_fixed::quantize_row(vals + r * kChannels,
                                              r < row_end, scale, q, raw,
                                              &nonfin);
    if (tile == 0)
      add_totals(true, any, 0, q, nonfin, raw, lane, tlo, thi, ws);
    const uint32_t m = __ballot_sync(kFull, any);
    if (m != 0u)
      add_entries<true, kTileBatch>(flat, k, r, m, lane, 0, q, nonfin, raw,
                                    0, e0, ne, nullptr, lo, hi, ws);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ne * kChannels; i += blockDim.x) {
    const unsigned long long v = ((unsigned long long)hi[i] << 32) + lo[i];
    if (v != 0ull) atomicAdd(ws.acc + (long long)e0 * kChannels + i, v);
  }
  if (tile == 0) flush_totals(tlo, thi, kChannels, ws.tot);
}

__global__ void sparse_finalize(SparseWs ws,
                                const int32_t* __restrict__ default_bin,
                                int num_features, int stride, int num_bins,
                                int slots,
                                const int32_t* __restrict__ slots_used,
                                const int32_t* __restrict__ active, int parts,
                                int log2n, float* __restrict__ out) {
  if (active != nullptr && *active == 0) return;
  __shared__ int s_e[kChannels];
  lgbt_fixed::block_exponents(ws.mxp, parts, log2n, s_e);
  __syncthreads();
  double inv[kChannels];
  for (int c = 0; c < kChannels; ++c) inv[c] = lgbt_fixed::pow2(-s_e[c]);
  const int used = live_slots(slots_used, slots);
  const long long count = (long long)slots * num_features * kChannels;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < count; t += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(t % kChannels);
    const long long sf = t / kChannels;  // slot * F + feature
    const int f = (int)(sf % num_features);
    const long long s = sf / num_features;
    float* o = out + sf * num_bins * kChannels + c;
    if (s >= used) {
      for (int b = 0; b < num_bins; ++b) o[b * kChannels] = 0.0f;
      continue;
    }
    const long long* a = reinterpret_cast<const long long*>(ws.acc) +
                         sf * stride * kChannels + c;
    const float* sa = ws.side_acc + sf * stride * kChannels + c;
    long long stored = 0;
    float side_stored = 0.0f;
    for (int b = 0; b < stride; ++b) {
      stored += a[b * kChannels];
      side_stored += sa[b * kChannels];
    }
    const long long absent = (long long)ws.tot[s * kChannels + c] - stored;
    const float side_absent = ws.side_tot[s * kChannels + c] - side_stored;
    const int db = default_bin[f];
    for (int b = 0; b < num_bins; ++b) {
      long long v = b < stride ? a[b * kChannels] : 0;
      float side = b < stride ? sa[b * kChannels] : 0.0f;
      if (b == db) {
        v += absent;
        side += side_absent;
      }
      o[b * kChannels] = lgbt_fixed::cell_value(v, side, inv[c]);
    }
  }
}

}  // namespace

// flat [n, k] int32; vals [n, 3] f32; slot [n] int32 or null; num_slots 0
// for the one-histogram forms (rows with slot >= 0, or every row without a
// slot vector), K for the K-slot form (with slots_used [1] int32 on the
// device; null otherwise); default_bin [F]; active [1] or null; parts: the
// scale's partial maxima; tile_f: the root form's features a tile (0: the
// root form runs `rows_pass`), ranges its row ranges; ws int64
// [sparse_data.ws_words(S, F, stride)] scratch; out [S, F, num_bins, 3]
// f32.
extern "C" int lgbt_sparse_histogram(
    const int32_t* flat, long long n, int k, const float* vals,
    const int32_t* slot, int num_slots, int num_features, int stride,
    int num_bins, const int32_t* default_bin, const int32_t* active,
    const int32_t* slots_used, int parts, int tile_f, int ranges,
    long long* wsp, float* out, cudaStream_t stream) {
  const int slots = num_slots > 0 ? num_slots : 1;
  const long long cells = (long long)num_features * stride;
  if (parts < 1 || slots > kMaxRowSlots) return (int)cudaErrorInvalidValue;
  const SparseWs ws = sparse_ws(wsp, slots, cells);
  const int log2n = lgbt_fixed::log2_ceil(n);
  const int32_t* used = num_slots > 0 ? slots_used : nullptr;
  const bool tiled = slot == nullptr && tile_f > 0;
  sparse_prep<<<parts, kPrepThreads, 0, stream>>>(
      vals, n, num_slots, slots, cells, used, active, parts, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (tiled) {
    const int tiles = (num_features + tile_f - 1) / tile_f;
    const long long rows = ((n + ranges - 1) / ranges + 31) / 32 * 32;
    const long long blocks = (n + rows - 1) / rows * tiles;
    const size_t smem = kTileHead + (size_t)tile_f * stride * kChannels * 8;
    root_tile<<<(unsigned)blocks, kTileThreads, smem, stream>>>(
        flat, k, n, vals, num_features, stride, tile_f, tiles, rows, active,
        parts, log2n, ws);
  } else {
    rows_pass<<<g_row_blocks, kRowThreads, row_smem(slots), stream>>>(
        flat, k, n, vals, slot, num_slots, slots, cells, used, active, parts,
        log2n, ws);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long fb = ((long long)slots * num_features * kChannels + 255) / 256;
  if (fb > kFinalizeBlocks) fb = kFinalizeBlocks;
  sparse_finalize<<<(unsigned)fb, 256, 0, stream>>>(
      ws, default_bin, num_features, stride, num_bins, slots, used, active,
      parts, log2n, out);
  return (int)cudaGetLastError();
}

// Once per process, before any launch: let `root_tile` use up to
// `smem_bytes` of dynamic shared memory, size `rows_pass`'s grid to the
// blocks the card holds at once, and load the kernels.
extern "C" int lgbt_sparse_setup(int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      root_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rows_pass, kRowThreads, row_smem(kMaxRowSlots));
  if (err != cudaSuccess) return (int)err;
  g_row_blocks = sms * (per_sm > 0 ? per_sm : 1);
  cudaFuncAttributes attr;
  const void* rest[] = {(const void*)sparse_prep, (const void*)rows_pass,
                        (const void*)sparse_finalize};
  for (const void* kf : rest) {
    err = cudaFuncGetAttributes(&attr, kf);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
