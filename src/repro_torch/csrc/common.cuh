// Shared pieces of the packed-BCNN kernels.
//
// Word layout (src/repro_torch/core/binarize.py): 32-bit words, LSB-first,
// packed along the last (channel) axis, zero-bit tails.  PyTorch hands the
// words over as int32 tensors; the kernels read them as uint32_t.
//
// Every kernel maps one warp to one group of 32 output channels of one
// output row or pixel, lane = channel, so the fused epilogue packs a whole
// output word with one __ballot_sync.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kWarp = 32;
constexpr int kBlockThreads = 256;
constexpr int kWarpsPerBlock = kBlockThreads / kWarp;

// Global warp index of the calling thread and its lane.
__device__ __forceinline__ long long global_warp() {
  return static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
         threadIdx.x / kWarp;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x % kWarp; }

// The fused BN-sign epilogue (src/repro/kernels/fused_epilogue.py:65):
// bit = (f32(y) >= tau[c]) == (flip[c] > 0), lane i -> bit i.  A lane past
// the last channel contributes bit 0, as tau = +inf, flip = +1 padding does
// in the reference.  All 32 lanes must call it (no early return before).
__device__ __forceinline__ uint32_t bn_sign_ballot(int32_t y, bool valid,
                                                   const float* tau,
                                                   const float* flip, int c) {
  bool bit = false;
  if (valid) bit = (static_cast<float>(y) >= tau[c]) == (flip[c] > 0.f);
  return __ballot_sync(0xffffffffu, bit);
}

// Mismatch count of one output pixel against one packed weight row over all
// KH x KW taps and Cw words (src/repro/kernels/binary_conv.py:217,
// _tap_mismatch).  ``img`` is one (H, W, Cw) image, ``wrow`` one tap-major
// (KH*KW*Cw) weight row, (ih0, iw0) the input position of tap (0, 0).  A tap
// in the padding reads the word 0 (= all -1) and is never skipped: the C5
// correction and the bit-plane rowsum both count on its -1 contributions.
__device__ __forceinline__ int tap_mismatch(const uint32_t* __restrict__ img,
                                            const uint32_t* __restrict__ wrow,
                                            int H, int W, int Cw, int KH,
                                            int KW, int ih0, int iw0) {
  int mism = 0;
  for (int di = 0; di < KH; ++di) {
    const int ih = ih0 + di;
    const bool row_in = ih >= 0 && ih < H;
    for (int dj = 0; dj < KW; ++dj) {
      const int iw = iw0 + dj;
      const bool in = row_in && iw >= 0 && iw < W;
      const long long off = (static_cast<long long>(ih) * W + iw) * Cw;
      const uint32_t* wt = wrow + (di * KW + dj) * Cw;
      for (int k = 0; k < Cw; ++k) {
        const uint32_t xv = in ? img[off + k] : 0u;
        mism += __popc(xv ^ wt[k]);
      }
    }
  }
  return mism;
}

inline unsigned int blocks_for_warps(long long warps) {
  return static_cast<unsigned int>((warps + kWarpsPerBlock - 1) /
                                   kWarpsPerBlock);
}

}  // namespace repro
