// K3 conv_bn_sign and K7 binary_conv: packed binary conv + C5 correction,
// with a fused BN-sign repack (K3) or an int32 output (K7).
//
// Replaces: src/repro/kernels/binary_conv.py:_conv_bn_sign_kernel
//           (pallas_call in binary_conv2d_bn_sign_packed) and
//           src/repro/kernels/binary_conv.py:_conv_kernel (pallas_call in
//           binary_conv2d_packed).
// Computes: x (B, H, W, Cw) words, w (C_out, KH*KW*Cw) words, corr
//           (OH*OW, C_out) int32 ->
//             y = k_true - 2*mism + corr[oh*OW + ow][c];
//           K3: tau/flip (C_out,) f32 -> out (B, OH, OW, ceil(C_out/32))
//               words, y thresholded and packed as in K2;
//           K7: out (B, OH, OW, C_out) int32 = y.
//           Any stride; SAME or VALID with the pads of conv_geometry (the
//           extra pad goes bottom/right).
// Bound on the H100: operations.  Each output channel of a pixel costs
//           KH*KW*Cw word XOR-POPCs against 4 bytes of correction read and
//           1/8 byte (K3) or 4 bytes (K7) written, so the POPC pipe binds.
// Design:   one warp per output pixel and output word (32 channels), lane =
//           channel.  The tap loop is an im2col done in registers (one
//           broadcast input load per word, no patch matrix in memory).  The
//           epilogue is a compile-time switch, as in xnor_gemm.cu: K3's
//           __ballot_sync packs the 32 thresholded bits, so its int32
//           activation never leaves the thread; K7 stores y and skips the
//           ballot.
#include "common.cuh"

using namespace repro;

template <bool kFused>
__global__ void conv_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
    const int32_t* __restrict__ corr, const float* __restrict__ tau,
    const float* __restrict__ flip, void* __restrict__ out, int B, int H,
    int W, int Cw, int C_out, int KH, int KW, int stride, int pad_top,
    int pad_left, int OH, int OW, int k_true) {
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
  const bool valid = c < C_out;
  int32_t y = 0;
  if (valid) {  // every lane still reaches the ballot below
    const uint32_t* wrow = w + static_cast<long long>(c) * KH * KW * Cw;
    const int mism = tap_mismatch(
        x + static_cast<long long>(b) * H * W * Cw, wrow, H, W, Cw, KH, KW,
        oh * stride - pad_top, ow * stride - pad_left);
    y = k_true - 2 * mism +
        corr[(static_cast<long long>(oh) * OW + ow) * C_out + c];
  }
  const long long pix_out = (static_cast<long long>(b) * OH + oh) * OW + ow;
  if constexpr (kFused) {
    const uint32_t bits = bn_sign_ballot(y, valid, tau, flip, c);
    if (lane_id() == 0) {
      static_cast<uint32_t*>(out)[pix_out * groups + g] = bits;
    }
  } else {
    if (valid) static_cast<int32_t*>(out)[pix_out * C_out + c] = y;
  }
}

template <bool kFused>
static int launch(const void* x, const void* w, const void* corr,
                  const void* tau, const void* flip, void* out, int B, int H,
                  int W, int Cw, int C_out, int KH, int KW, int stride,
                  int pad_top, int pad_left, int OH, int OW, int k_true,
                  void* stream) {
  const long long warps = static_cast<long long>(B) * OH * OW *
                          ((C_out + kWarp - 1) / kWarp);
  if (warps > 0) {
    conv_kernel<kFused><<<blocks_for_warps(warps), kBlockThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
        static_cast<const int32_t*>(corr), static_cast<const float*>(tau),
        static_cast<const float*>(flip), out, B, H, W, Cw, C_out, KH, KW,
        stride, pad_top, pad_left, OH, OW, k_true);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv_bn_sign(const void* x, const void* w, const void* corr,
                            const void* tau, const void* flip, void* out,
                            int B, int H, int W, int Cw, int C_out, int KH,
                            int KW, int stride, int pad_top, int pad_left,
                            int OH, int OW, int k_true, void* stream) {
  return launch<true>(x, w, corr, tau, flip, out, B, H, W, Cw, C_out, KH, KW,
                      stride, pad_top, pad_left, OH, OW, k_true, stream);
}

extern "C" int binary_conv(const void* x, const void* w, const void* corr,
                           void* out, int B, int H, int W, int Cw, int C_out,
                           int KH, int KW, int stride, int pad_top,
                           int pad_left, int OH, int OW, int k_true,
                           void* stream) {
  return launch<false>(x, w, corr, nullptr, nullptr, out, B, H, W, Cw, C_out,
                       KH, KW, stride, pad_top, pad_left, OH, OW, k_true,
                       stream);
}
