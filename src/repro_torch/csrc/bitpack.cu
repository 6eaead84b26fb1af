// K5 bitpack: sign-binarize + bit-pack along the last axis.
//
// Replaces: src/repro/kernels/bitpack.py:26 _bitpack_kernel (pallas_call at
//           :60 in bitpack).
// Computes: x (M, K) f32 -> out (M, ceil(K/32)) words, bit = (x >= 0),
//           LSB-first, zero-bit tail.  -0.0 packs as 1 and NaN as 0, as
//           `x >= 0` gives in both frameworks.
// Bound on the H100: bytes.  It reads 4 bytes and writes 1/8 byte per
//           element and does one compare, so it is held by how many bytes it
//           keeps in flight to hide the latency of device memory.
// Design, aligned path (K % 32 == 0 and x on 16 bytes, which the wrapper
//   checks: every LM and Table-1 shape).  Rows are then whole words, so
//   the (M, K) floats are one run of M * Kw words with no row arithmetic.
//   A warp owns 32 consecutive output words, 4 KB of input: each lane first
//   issues all of its kLoads = 8 float4 loads (coalesced, 512 bytes a warp
//   each, 128 bytes a lane in flight), then turns each float4 into a nibble
//   of x >= 0 bits at its place in the word, and three __shfl_xor_sync ORs
//   over the 8 lanes that hold a word's 32 floats assemble it.  Eight more
//   shuffles hand word l to lane l, and the warp stores its 32 words as one
//   128-byte line.  Blocks index words directly: no division.
// Design, general path (ragged K such as the BMLP's 784, or rows not on 16
//   bytes): one warp per output word, lane = element.  The 32 lanes read 32
//   consecutive floats (one 128-byte load, unaligned when K % 32 != 0, the
//   index m*K + word*32 + lane) and __ballot_sync packs the word in a
//   register.  Lanes past K vote 0, which is the reference's -1.0 padding.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kLoads = 8;   // float4 loads in flight per lane, aligned path
constexpr int kWordsPerWarp = kLoads * 4;   // 1024 floats a warp

__device__ __forceinline__ uint32_t nibble(float4 v) {
  return static_cast<uint32_t>(v.x >= 0.f) |
         static_cast<uint32_t>(v.y >= 0.f) << 1 |
         static_cast<uint32_t>(v.z >= 0.f) << 2 |
         static_cast<uint32_t>(v.w >= 0.f) << 3;
}

// Words [32 warp, 32 warp + 32) of ``words`` in all.  Load j of lane l is
// float4 32 j + l of the warp's run: nibble l % 8 of word 4 j + l / 8.
__global__ void bitpack_aligned_kernel(const float4* __restrict__ x,
                                       uint32_t* __restrict__ out,
                                       long long words) {
  const long long w0 = global_warp() * kWordsPerWarp;
  if (w0 >= words) return;   // uniform per warp
  const int lane = lane_id();
  const float4* src = x + w0 * 8;
  float4 v[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const bool in = w0 + 4 * j + lane / 8 < words;
    v[j] = in ? __ldcs(src + j * kWarp + lane) : make_float4(-1, -1, -1, -1);
  }
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    uint32_t w = nibble(v[j]) << (4 * (lane % 8));
    w |= __shfl_xor_sync(0xffffffffu, w, 1);
    w |= __shfl_xor_sync(0xffffffffu, w, 2);
    w |= __shfl_xor_sync(0xffffffffu, w, 4);
    // Word 4 j + q sits with lanes 8 q..8 q + 7; lane l takes word l.
    const uint32_t got = __shfl_sync(0xffffffffu, w, 8 * (lane % 4));
    if (lane / 4 == j) mine = got;
  }
  if (w0 + lane < words) out[w0 + lane] = mine;
}

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

}  // namespace

// aligned: the wrapper found K % 32 == 0 and x on 16 bytes
// (bitpack.packs_aligned); the kernel checks both again.
extern "C" int bitpack(const void* x, void* out, int M, int K, int aligned,
                       void* stream) {
  const int Kw = (K + kWarp - 1) / kWarp;
  const long long words = static_cast<long long>(M) * Kw;
  if (words <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  if (aligned) {
    if (K % kWarp != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long warps = (words + kWordsPerWarp - 1) / kWordsPerWarp;
    bitpack_aligned_kernel<<<blocks_for_warps(warps), kBlockThreads, 0, st>>>(
        static_cast<const float4*>(x), static_cast<uint32_t*>(out), words);
  } else {
    bitpack_kernel<<<blocks_for_warps(words), kBlockThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<uint32_t*>(out), M, K, Kw);
  }
  return static_cast<int>(cudaGetLastError());
}

// What bitpack() launches for these sizes (common.cuh: launch_query).
extern "C" int bitpack_query(int M, int K, int aligned, int* out,
                             const char** name) {
  const long long words =
      static_cast<long long>(M) * ((K + kWarp - 1) / kWarp);
  if (aligned)
    return launch_query(
        bitpack_aligned_kernel,
        dim3(blocks_for_warps((words + kWordsPerWarp - 1) / kWordsPerWarp)),
        dim3(kBlockThreads), 0, out, name);
  return launch_query(bitpack_kernel, dim3(blocks_for_warps(words)),
                      dim3(kBlockThreads), 0, out, name);
}
