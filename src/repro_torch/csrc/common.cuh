// Shared pieces of the packed-BCNN kernels.
//
// Word layout (src/repro_torch/core/binarize.py): 32-bit words, LSB-first,
// packed along the last (channel) axis, zero-bit tails.  PyTorch hands the
// words over as int32 tensors; the kernels read them as uint32_t.
//
// The warp-per-word kernels (K2, K4's small-M route and K5's general path)
// map one warp to one output word, lane = channel or element, so one
// __ballot_sync packs the whole word (bn_sign_ballot is K2's and K4's
// fused epilogue).
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

inline unsigned int blocks_for_warps(long long warps) {
  return static_cast<unsigned int>((warps + kWarpsPerBlock - 1) /
                                   kWarpsPerBlock);
}

// The query entries (``<entry>_query``): what a launcher would launch for
// the given sizes, without launching, for the shared-memory preflight
// (src/repro_torch/analysis/smem.py) to hold its estimates to.  out[0..8]
// = grid x, y, z, block x, y, z, dynamic shared memory bytes, then the
// kernel's registers a thread and static shared memory bytes
// (cudaFuncGetAttributes); *name = the kernel's symbol (cudaFuncGetName),
// which names its line in the ptxas report.
template <class... Args>
int launch_query(void (*kernel)(Args...), dim3 grid, dim3 block,
                 size_t smem, int* out, const char** name) {
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncGetName(name, reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vals[9] = {static_cast<int>(grid.x), static_cast<int>(grid.y),
                       static_cast<int>(grid.z), static_cast<int>(block.x),
                       static_cast<int>(block.y), static_cast<int>(block.z),
                       static_cast<int>(smem), attr.numRegs,
                       static_cast<int>(attr.sharedSizeBytes)};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace repro
