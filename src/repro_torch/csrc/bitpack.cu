// K5 bitpack: sign-binarize + bit-pack along the last axis.
//
// Replaces: src/repro/kernels/bitpack.py:_bitpack_kernel (pallas_call in
//           bitpack).
// Computes: x (M, K) f32 -> out (M, ceil(K/32)) words, bit = (x >= 0),
//           LSB-first, zero-bit tail.  -0.0 packs as 1 and NaN as 0, as
//           `x >= 0` gives in both frameworks.
// Bound on the H100: bytes.  It reads 4 bytes and writes 1/8 byte per
//           element and does one compare.
// Design:   one warp per output word, lane = element.  The 32 lanes read
//           32 consecutive floats (one coalesced 128-byte load, unaligned
//           when K % 32 != 0: rows are not word-aligned, so the index is
//           m*K + word*32 + lane) and __ballot_sync packs the word in a
//           register.  Lanes past K vote 0, which is the reference's -1.0
//           padding.
#include "common.cuh"

using namespace repro;

__global__ void bitpack_kernel(const float* __restrict__ x,
                               uint32_t* __restrict__ out, int M, int K,
                               int Kw) {
  const long long warp = global_warp();
  if (warp >= static_cast<long long>(M) * Kw) return;  // uniform per warp
  const long long m = warp / Kw;
  const int word = static_cast<int>(warp % Kw);
  const int k = word * kWarp + lane_id();
  const bool bit = k < K && x[m * K + k] >= 0.f;
  const uint32_t bits = __ballot_sync(0xffffffffu, bit);
  if (lane_id() == 0) out[m * Kw + word] = bits;
}

extern "C" int bitpack(const void* x, void* out, int M, int K,
                       void* stream) {
  const int Kw = (K + kWarp - 1) / kWarp;
  const long long warps = static_cast<long long>(M) * Kw;
  if (warps > 0) {
    bitpack_kernel<<<blocks_for_warps(warps), kBlockThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<uint32_t*>(out), M, K, Kw);
  }
  return static_cast<int>(cudaGetLastError());
}
