// Measurement probe for chip_smoke.py; no path of the port launches it.
//
// mma_peak: the tensor cores' mma.sync issue rate on register operands,
//   for the 1-bit m16n8k256 .and.popc step (K4's route; NVIDIA publishes
//   no H100 rate for it) and the int8 m16n8k32 step.  Each warp runs kChains
//   independent accumulator chains so that no MMA waits on the one before;
//   the sums are written out so that nothing is optimised away.  The rate
//   it shows is the 1-bit peak that chip_smoke.py bounds K4 with.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kChains = 8;

template <bool kB1>
__global__ void mma_peak_kernel(int iters, int32_t* __restrict__ out) {
  const uint32_t seed = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const uint32_t a[4] = {seed, seed ^ 0x55555555u, seed * 3u, ~seed};
  const uint32_t b0 = seed ^ 0x0F0F0F0Fu, b1 = seed + 7u;
  int32_t c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch) {
      if constexpr (kB1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[ch][0]), "+r"(c[ch][1]), "+r"(c[ch][2]), "+r"(c[ch][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[ch][0]), "+r"(c[ch][1]), "+r"(c[ch][2]), "+r"(c[ch][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      }
    }
  }
  int32_t s = 0;
#pragma unroll
  for (int ch = 0; ch < kChains; ++ch) s += c[ch][0] + c[ch][1] + c[ch][2] + c[ch][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// kind 0: 1-bit m16n8k256, kind 1: int8 m16n8k32.  out: blocks * 256 ints.
extern "C" int mma_peak(int kind, int blocks, int iters, void* out,
                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int32_t*>(out);
  if (kind == 0)
    mma_peak_kernel<true><<<blocks, kBlockThreads, 0, st>>>(iters, o);
  else
    mma_peak_kernel<false><<<blocks, kBlockThreads, 0, st>>>(iters, o);
  return static_cast<int>(cudaGetLastError());
}
