// Measurement probe for chip_smoke.py; no path of the port launches it.
//
// mma_peak: the tensor cores' mma.sync issue rate on register operands,
//   for the 1-bit m16n8k256 .and.popc step (K4's route; NVIDIA publishes
//   no H100 rate for it), the int8 m16n8k32 step and the TF32 m16n8k8 step
//   (K8's P.V; NVIDIA publishes the TF32 rate of wgmma only).  Each warp
//   runs kChains independent accumulator chains so that no MMA waits on
//   the one before; the sums are written out so that nothing is optimised
//   away.  The rates it shows are the 1-bit peak that chip_smoke.py bounds
//   K4 with, and the TF32 rate of mma.sync, which it prints beside the
//   published (wgmma) TF32 peak that bounds K8's split-TF32 P.V.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kChains = 8;

// kKind 0: 1-bit m16n8k256, 1: int8 m16n8k32, 2: TF32 m16n8k8.
template <int kKind>
__global__ void mma_peak_kernel(int iters, int32_t* __restrict__ out) {
  const uint32_t seed = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  uint32_t a[4] = {seed, seed ^ 0x55555555u, seed * 3u, ~seed};
  uint32_t b0 = seed ^ 0x0F0F0F0Fu, b1 = seed + 7u;
  if constexpr (kKind == 2) {   // TF32 operands: finite, |x| in [0.25, 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = 0x3F000000u | (a[i] & 0x807FE000u);
    b0 = 0x3E800000u | (b0 & 0x807FE000u);
    b1 = 0x3E800000u | (b1 & 0x807FE000u);
  }
  int32_t c[kChains][4] = {};
  float f[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch) {
      if constexpr (kKind == 2) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(f[ch][0]), "+f"(f[ch][1]), "+f"(f[ch][2]), "+f"(f[ch][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      } else if constexpr (kKind == 0) {
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
  for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += c[ch][e] + __float_as_int(f[ch][e]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// kind 0: 1-bit m16n8k256, kind 1: int8 m16n8k32, kind 2: TF32 m16n8k8.
// out: blocks * 256 ints.
extern "C" int mma_peak(int kind, int blocks, int iters, void* out,
                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int32_t*>(out);
  if (kind == 0)
    mma_peak_kernel<0><<<blocks, kBlockThreads, 0, st>>>(iters, o);
  else if (kind == 1)
    mma_peak_kernel<1><<<blocks, kBlockThreads, 0, st>>>(iters, o);
  else if (kind == 2)
    mma_peak_kernel<2><<<blocks, kBlockThreads, 0, st>>>(iters, o);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
