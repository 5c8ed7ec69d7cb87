// B9 — EFB group -> feature histogram expansion.
//
// Replaces the JAX package's lightgbm_tpu/efb.py `expand_group_hist`
// (:257; its maps from `make_device_efb`, :244), which the masked grower
// runs on each child just before the split scan (grower.py:341-346, :869,
// :1150).  With EFB the binned matrix is [N, G], G <= F: mutually
// exclusive features share one column (a bundle), and the histogram pass
// (B1) builds group histograms [G, Bg, 3].  This kernel gathers each
// child's per-feature histograms [F, B, 3] from them:
//
//     out[c, f, b, :] = col_idx[f, b] >= 0 ? ghist[c, group_of_feat[f],
//                                                   col_idx[f, b], :] : 0
//
// and, for a bundled feature (fix0[f]), rebuilds its default bin 0 — which
// the bundle shares with every other member — as the child's total minus
// the feature's other bins (FixHistogram, the reference's
// dataset.cpp:1292):
//
//     out[c, f, 0, :] = total[c, :] - (out[c, f, 1, :] + ... + out[c, f,
//                                      B - 1, :])
//
// summed in bin order, one add at a time, as the plain version
// (`efb.expand_group_hist_plain`) sums; with -fmad=false the result is bit
// for bit the plain version's, so B1's determinism holds end to end.
//
// C children: 1 at the root, 2 at a strict step, 2K at a batched
// super-step.  `active` (nullable) is the grower's device step flag: where
// it is 0 the kernel returns at once and writes nothing, so a tree's steps
// capture into one CUDA graph without a host branch (as B2).
//
// Design: one block per (feature, child).  The threads gather the
// feature's B x 3 values into shared memory (masked bins as 0), three of
// them (one a channel) sum bins 1..B-1 in order for the bin-0 fix, then
// all write the feature's row of the output, contiguous.
//
// Bound on this card: bytes.  The function reads the group histograms
// (C*G*Bg*3*4 bytes), the maps (F*B*4 + 5F bytes) and the totals, and
// writes C*F*B*3*4 bytes.  At a batched super-step of the Flight-Delay
// cell (2K = 32 children, G = 8 groups of up to 256 bins, F = 584 features
// of 2..255 bins, B = 255) that is 0.8 + 0.6 + 57 MB, about 17 us at
// 3.35 TB/s; the output, mostly zeros of the 582 two-bin one-hot
// features' unused bins, dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBins = 1024;

__global__ void expand_hist(const float* __restrict__ ghist,
                            const float* __restrict__ total,
                            const int32_t* __restrict__ group_of_feat,
                            const int32_t* __restrict__ col_idx,
                            const uint8_t* __restrict__ fix0, int G, int Bg,
                            int F, int B, const int32_t* __restrict__ active,
                            float* __restrict__ out) {
  if (active != nullptr && active[0] == 0) return;
  __shared__ float sh[3 * kMaxBins];
  const int f = blockIdx.x, c = blockIdx.y;
  const float* src =
      ghist + ((long long)c * G + group_of_feat[f]) * (long long)Bg * 3;
  const int32_t* idx = col_idx + (long long)f * B;
  for (int i = threadIdx.x; i < 3 * B; i += blockDim.x) {
    const int j = idx[i / 3];
    sh[i] = j >= 0 ? src[j * 3 + i % 3] : 0.0f;
  }
  __syncthreads();
  if (fix0[f] != 0 && threadIdx.x < 3) {
    const int ch = threadIdx.x;
    float rest = B > 1 ? sh[3 + ch] : 0.0f;
    for (int b = 2; b < B; ++b) rest = __fadd_rn(rest, sh[b * 3 + ch]);
    sh[ch] = __fsub_rn(total[c * 3 + ch], rest);
  }
  __syncthreads();
  float* dst = out + ((long long)c * F + f) * (long long)B * 3;
  for (int i = threadIdx.x; i < 3 * B; i += blockDim.x) dst[i] = sh[i];
}

}  // namespace

// ghist [C, G, Bg, 3] f32, total [C, 3] f32, group_of_feat [F] int32,
// col_idx [F, B] int32 (-1 = masked), fix0 [F] bool (one byte each),
// active [1] int32 or null; out [C, F, B, 3] f32.  B <= 1024.
extern "C" int lgbt_expand_group_hist(const float* ghist, const float* total,
                                      const int32_t* group_of_feat,
                                      const int32_t* col_idx,
                                      const uint8_t* fix0, int C, int G,
                                      int Bg, int F, int B,
                                      const int32_t* active, float* out,
                                      cudaStream_t stream) {
  if (C <= 0 || F <= 0) return 0;
  if (B > kMaxBins || C > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(F, C);
  expand_hist<<<grid, 128, 0, stream>>>(ghist, total, group_of_feat,
                                        col_idx, fix0, G, Bg, F, B, active,
                                        out);
  return (int)cudaGetLastError();
}

extern "C" int lgbt_efb_setup() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, expand_hist);
}
