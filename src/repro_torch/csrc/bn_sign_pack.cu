// K2 bn_sign_pack: fused sign(BN(x)) + bit-pack along channels.
//
// Replaces: src/repro/kernels/fused_epilogue.py:_bn_sign_pack_kernel
//           (pallas_call in bn_sign_pack).
// Computes: x (M, C) int32, tau/flip (C,) f32 -> out (M, ceil(C/32)) words,
//           bit = (f32(x) >= tau) == (flip > 0), LSB-first, zero-bit tail.
// Bound on the H100: bytes.  It reads 4 bytes and writes 1/8 byte per
//           element and does one compare, far below the card's ratio of
//           operations to bytes.
// Design:   one warp per output word; the 32 lanes read 32 consecutive
//           int32 (one 128-byte coalesced load), and __ballot_sync packs the
//           word in a register, so nothing but the packed word is written.
#include "common.cuh"

using namespace repro;

__global__ void bn_sign_pack_kernel(const int32_t* __restrict__ x,
                                    const float* __restrict__ tau,
                                    const float* __restrict__ flip,
                                    uint32_t* __restrict__ out, int M, int C,
                                    int Cw) {
  const long long warp = global_warp();
  const int lane = lane_id();
  if (warp >= static_cast<long long>(M) * Cw) return;  // uniform per warp
  const long long m = warp / Cw;
  const int word = static_cast<int>(warp % Cw);
  const int c = word * kWarp + lane;
  const bool valid = c < C;
  const int32_t y = valid ? x[m * C + c] : 0;
  const uint32_t bits = bn_sign_ballot(y, valid, tau, flip, c);
  if (lane == 0) out[m * Cw + word] = bits;
}

extern "C" int bn_sign_pack(const void* x, const void* tau, const void* flip,
                            void* out, int M, int C, void* stream) {
  const int Cw = (C + kWarp - 1) / kWarp;
  const long long warps = static_cast<long long>(M) * Cw;
  if (warps > 0) {
    bn_sign_pack_kernel<<<blocks_for_warps(warps), kBlockThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<const float*>(tau),
        static_cast<const float*>(flip), static_cast<uint32_t*>(out), M, C,
        Cw);
  }
  return static_cast<int>(cudaGetLastError());
}
