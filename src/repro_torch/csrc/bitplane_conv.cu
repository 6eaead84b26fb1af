// K1 bitplane_conv: the first-layer conv on 8 packed bit planes (paper C4).
//
// Replaces: src/repro/kernels/binary_conv.py:_bitplane_conv_kernel
//           (pallas_call in bitplane_conv2d_packed).
// Computes: planes (nbits, B, H, W, Cw) words, w (C_out, KH*KW*Cw) words,
//           rowsum (C_out,) int32 -> out (B, OH, OW, C_out) int32,
//             out = ((2^n - 1)(k_true + rowsum) - 2 sum_p 2^p mism_p) >> 1,
//           the exact integer conv of the raw input against sign(W) with
//           true zero padding.  The value before the shift is even, so the
//           arithmetic shift halves it exactly.
// Bound on the H100: operations.  At the BCNN's stage 0 each output reads
//           nbits*KH*KW*Cw = 72 words and writes 4 bytes, so the POPC pipe
//           (16 results per clock per SM) binds before memory does.
// Design:   one warp per output pixel and 32 output channels, lane =
//           channel.  The input word of a tap is the same for the whole warp
//           (one broadcast load); each lane walks its own weight row, which
//           stays in L1 (C_out x 9 words).  The plane loop runs inside the
//           thread, so the int32 plane sums never leave registers.
#include "common.cuh"

using namespace repro;

__global__ void bitplane_conv_kernel(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ w,
    const int32_t* __restrict__ rowsum, int32_t* __restrict__ out, int B,
    int H, int W, int Cw, int C_out, int KH, int KW, int stride, int pad_top,
    int pad_left, int OH, int OW, int k_true, int nbits) {
  const int groups = (C_out + kWarp - 1) / kWarp;
  const long long warp = global_warp();
  if (warp >= static_cast<long long>(B) * OH * OW * groups) return;
  const int g = static_cast<int>(warp % groups);
  long long pix = warp / groups;
  const int ow = static_cast<int>(pix % OW);
  pix /= OW;
  const int oh = static_cast<int>(pix % OH);
  const int b = static_cast<int>(pix / OH);
  const int c = g * kWarp + lane_id();
  if (c >= C_out) return;  // no warp-wide op follows
  const uint32_t* wrow = w + static_cast<long long>(c) * KH * KW * Cw;
  const long long image = static_cast<long long>(H) * W * Cw;
  const long long plane = static_cast<long long>(B) * image;
  int32_t wacc = 0;
  for (int p = 0; p < nbits; ++p) {
    const int mism = tap_mismatch(planes + p * plane + b * image, wrow, H, W,
                                  Cw, KH, KW, oh * stride - pad_top,
                                  ow * stride - pad_left);
    wacc += mism << p;
  }
  const int32_t full = (1 << nbits) - 1;
  out[((static_cast<long long>(b) * OH + oh) * OW + ow) * C_out + c] =
      (full * (k_true + rowsum[c]) - 2 * wacc) >> 1;
}

extern "C" int bitplane_conv(const void* planes, const void* w,
                             const void* rowsum, void* out, int B, int H,
                             int W, int Cw, int C_out, int KH, int KW,
                             int stride, int pad_top, int pad_left, int OH,
                             int OW, int k_true, int nbits, void* stream) {
  const long long warps = static_cast<long long>(B) * OH * OW *
                          ((C_out + kWarp - 1) / kWarp);
  if (warps > 0) {
    bitplane_conv_kernel<<<blocks_for_warps(warps), kBlockThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(planes), static_cast<const uint32_t*>(w),
        static_cast<const int32_t*>(rowsum), static_cast<int32_t*>(out), B, H,
        W, Cw, C_out, KH, KW, stride, pad_top, pad_left, OH, OW, k_true,
        nbits);
  }
  return static_cast<int>(cudaGetLastError());
}
