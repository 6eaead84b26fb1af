// K2 bn_sign_pack: fused sign(BN(x)) + bit-pack along channels.
//
// Replaces: src/repro/kernels/fused_epilogue.py:96 _bn_sign_pack_kernel
//           (pallas_call at :127 in bn_sign_pack).
// Computes: x (M, C) int32, tau/flip (C,) f32 -> out (M, ceil(C/32)) words,
//           bit = (f32(x) >= tau) == (flip > 0), LSB-first, zero-bit tail.
// Bound on the H100: bytes.  It reads 4 bytes and writes 1/8 byte per
//           element and does one compare, far below the card's ratio of
//           operations to bytes, so it is held by how many bytes it keeps
//           in flight to hide the latency of device memory.  Where the
//           BCNN's first stage does not pool, K1's fused instance
//           (bitplane_conv.cu) runs this epilogue instead, and the int32
//           tensor never reaches device memory.
// Design, aligned path (C % 4 == 0 and x on 16 bytes, which the wrapper
//   checks: every row starts on 16 bytes).  A warp owns a slab of 128
//   channels, lane l channels 4 l.. 4 l + 3 of it, and keeps their tau and
//   flip in registers while it walks over tiles of 8 rows, grid-stride.
//   Per tile each lane first issues its 8 int4 loads (one per row), then
//   turns each into a nibble of bits at its place in the word, and three
//   __shfl_xor_sync ORs over the 8 lanes of a word assemble it; eight more
//   shuffles hand word q of row j to lane 4 j + q, and the warp stores its
//   32 words at once (one 128-byte line where C = 128).  Lanes past C load
//   nothing and give zero bits.
// Design, general path (any other input): one warp per output word; the 32
//   lanes read 32 consecutive int32 (one 128-byte load), and __ballot_sync
//   packs the word in a register, so nothing but the packed word is
//   written.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kRows = 8;            // rows of a tile: int4 loads in flight
constexpr int kSlab = 4 * kWarp;    // channels of a warp's slab
constexpr int kWarpsPerSm = 32;     // the aligned grid's warps per SM

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

// Warp w takes slab w % slabs and tiles w / slabs, w / slabs + walkers, ...
__global__ void bn_sign_pack_aligned_kernel(const int4* __restrict__ x,
                                            const float* __restrict__ tau,
                                            const float* __restrict__ flip,
                                            uint32_t* __restrict__ out,
                                            int M, int C, int Cw, int slabs,
                                            int walkers) {
  const long long gw = global_warp();
  if (gw >= static_cast<long long>(slabs) * walkers) return;  // per warp
  const int lane = lane_id();
  const int s = static_cast<int>(gw % slabs);
  const int c0 = s * kSlab + 4 * lane;
  const bool valid = c0 < C;
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t keep = 0;                 // bit k: flip of channel c0 + k > 0
  if (valid) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t[k] = tau[c0 + k];
      keep |= static_cast<uint32_t>(flip[c0 + k] > 0.f) << k;
    }
  }
  const long long row4 = C / 4;      // int4 per row
  const long long tiles = (static_cast<long long>(M) + kRows - 1) / kRows;
  for (long long tile = gw / slabs; tile < tiles; tile += walkers) {
    const long long m0 = tile * kRows;
    int4 v[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      v[j] = valid && m0 + j < M ? __ldcs(x + (m0 + j) * row4 + c0 / 4)
                                 : make_int4(0, 0, 0, 0);
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const uint32_t ge =
          static_cast<uint32_t>(static_cast<float>(v[j].x) >= t[0]) |
          static_cast<uint32_t>(static_cast<float>(v[j].y) >= t[1]) << 1 |
          static_cast<uint32_t>(static_cast<float>(v[j].z) >= t[2]) << 2 |
          static_cast<uint32_t>(static_cast<float>(v[j].w) >= t[3]) << 3;
      const uint32_t nib = valid ? ~(ge ^ keep) & 0xFu : 0u;
      uint32_t w = nib << (4 * (lane % 8));
      w |= __shfl_xor_sync(0xffffffffu, w, 1);
      w |= __shfl_xor_sync(0xffffffffu, w, 2);
      w |= __shfl_xor_sync(0xffffffffu, w, 4);
      // Word q of row j sits with lanes 8 q..8 q + 7; lane 4 j + q takes it.
      const uint32_t got = __shfl_sync(0xffffffffu, w, 8 * (lane % 4));
      if (lane / 4 == j) mine = got;
    }
    const long long m = m0 + lane / 4;
    const int word = s * 4 + lane % 4;
    if (m < M && word < Cw) out[m * Cw + word] = mine;
  }
}

}  // namespace

// aligned: the wrapper found C % 4 == 0 and x on 16 bytes
// (fused_epilogue.bn_sign_aligned); the kernel checks both again.  sms:
// the card's SM count, which sizes the aligned path's grid.
extern "C" int bn_sign_pack(const void* x, const void* tau, const void* flip,
                            void* out, int M, int C, int aligned, int sms,
                            void* stream) {
  const int Cw = (C + kWarp - 1) / kWarp;
  const long long words = static_cast<long long>(M) * Cw;
  if (words <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  if (aligned) {
    if (C % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || sms < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int slabs = (C + kSlab - 1) / kSlab;
    const long long tiles = (static_cast<long long>(M) + kRows - 1) / kRows;
    long long walkers =
        (static_cast<long long>(sms) * kWarpsPerSm + slabs - 1) / slabs;
    if (walkers > tiles) walkers = tiles;
    bn_sign_pack_aligned_kernel<<<blocks_for_warps(slabs * walkers),
                                  kBlockThreads, 0, st>>>(
        static_cast<const int4*>(x), static_cast<const float*>(tau),
        static_cast<const float*>(flip), static_cast<uint32_t*>(out), M, C,
        Cw, slabs, static_cast<int>(walkers));
  } else {
    bn_sign_pack_kernel<<<blocks_for_warps(words), kBlockThreads, 0, st>>>(
        static_cast<const int32_t*>(x), static_cast<const float*>(tau),
        static_cast<const float*>(flip), static_cast<uint32_t*>(out), M, C,
        Cw);
  }
  return static_cast<int>(cudaGetLastError());
}

// What bn_sign_pack() launches for these sizes (common.cuh: launch_query).
extern "C" int bn_sign_pack_query(int M, int C, int aligned, int sms,
                                  int* out, const char** name) {
  const int Cw = (C + kWarp - 1) / kWarp;
  if (aligned) {
    const int slabs = (C + kSlab - 1) / kSlab;
    const long long tiles = (static_cast<long long>(M) + kRows - 1) / kRows;
    long long walkers =
        (static_cast<long long>(sms) * kWarpsPerSm + slabs - 1) / slabs;
    if (walkers > tiles) walkers = tiles;
    return launch_query(bn_sign_pack_aligned_kernel,
                        dim3(blocks_for_warps(slabs * walkers)),
                        dim3(kBlockThreads), 0, out, name);
  }
  return launch_query(bn_sign_pack_kernel,
                      dim3(blocks_for_warps(static_cast<long long>(M) * Cw)),
                      dim3(kBlockThreads), 0, out, name);
}
