// K3 conv_bn_sign and K7 binary_conv: packed binary conv + C5 correction,
// with a fused BN-sign repack (K3) or an int32 output (K7).
//
// Replaces: src/repro/kernels/binary_conv.py:257 _conv_bn_sign_kernel
//           (pallas_call at :440, in binary_conv2d_bn_sign_packed) and
//           :249 _conv_kernel (pallas_call at :385, in
//           binary_conv2d_packed).
// Computes: x (B, H, W, Cw) words, w (C_out, KH*KW*Cw) words, corr
//           (OH*OW, C_out) int32 ->
//             y = k_true - 2*popc(x ^ w over the taps) + corr[oh*OW + ow][c];
//           K3: tau/flip (C_out,) f32 -> out (B, OH, OW, ceil(C_out/32))
//               words, y thresholded and packed as bn_sign_ballot packs
//               (common.cuh);
//           K7: out (B, OH, OW, C_out) int32 = y.
//           Any stride; SAME or VALID with the pads of conv_geometry (the
//           extra pad goes bottom/right).
// Bound on the H100: K3 the tensor cores (its 1-bit MACs at the 1-bit MMA
//           peak that chip_smoke.py measures; the packed output is small);
//           K7 its int32 output bytes.
// Design:   an implicit GEMM on the 1-bit tensor-core main loop of
//           b1_mma.cuh (K4's, mma.sync.m16n8k256.b1.and.popc).
//   * Rows of A are output pixels m = (b*OH + oh)*OW + ow, columns output
//     channels, depth the (tap, word) index kk = (di*KW + dj)*Cw + c, the
//     order of w_packed's rows.  The output (M, C_out) int32 or
//     (M, ceil(C_out/32)) words is the layer's (B, OH, OW, .) layout.
//   * A block owns a 64 x 128 tile of (pixels, channels), or 64 x 64 where
//     the larger tile would leave SMs without a block; the wrapper picks
//     it from (B*OH*OW, C_out) (binary_conv.conv_tile).  At block start
//     each of its rows is decoded once into (image, ih0, iw0) in shared
//     memory; a row past M gets an ih0 that no tap brings into the image.
//   * The A tile of each 32-word depth chunk is the im2col of those rows,
//     copied by cp.async straight from x into the ring: a thread's copies
//     share one depth kk (decoded once per chunk into di, dj, c) over rows
//     16 (or 4) apart.  A tap in the padding, a row past M and a word past
//     Kw are zero-filled by the copy: the word 0 is all -1, which is what
//     the reference's padding counts, and the C5 correction turns that
//     into zero padding.  16-byte copies where Cw % 4 == 0 and both
//     operands are 16-byte aligned (4 words of one tap), else 4-byte
//     copies; they keep their lines in L1, since neighbouring taps read
//     the same input words.  Weights stream as K4's B tiles.
//   * The ring is two stages deep, not K4's three: the depth is one to
//     five chunks at the BCNN's stages, so blocks in flight hide the copies
//     better than a deeper ring does, and shared memory (56 KB or 38 KB
//     with the row table) bounds how many fit on an SM.  On the H100,
//     64 x 128 with the two-deep ring was the fastest at every BCNN stage
//     at batch 256, and 64 x 64 at batch 1 (PERF.md, chip_conv_tiles.py).
//     The tile alone sets shared memory, whatever H, W and C_in: every
//     shape takes one launch.
//   * Only ceil(Kw/8) k256 steps run: at the BCNN's stages Kw = 9*Cw is
//     36, 72 or 144 words, 4.5 to 18 steps.
//   * Epilogue: b1_mma.cuh's popcount identity gives k_true - 2*mism, the
//     correction row m % (OH*OW) is added, then K3 thresholds and packs
//     32-channel words and K7 stores int32 pairs.
#include <climits>

#include "b1_mma.cuh"

using namespace repro;

namespace {

struct ConvShape {
  int B, H, W, Cw, C_out, KH, KW, stride, pad_top, pad_left, OH, OW, k_true;
};

// Where an output pixel's tap (0, 0) reads: its image and input position,
// padded to 16 bytes so that a row is one shared-memory load.
struct __align__(16) RowInfo {
  int b, ih0, iw0, unused;
};

constexpr int kNoRow = INT_MIN / 2;   // ih0 of a row past M
constexpr int kRing = 2;              // depth chunks in flight

// The im2col of the block's rows at depth words [k0, k0 + kBK) into
// dst[kRows][kLds], zero-filled in the padding, past M and past Kw.
template <int kRows, bool kVec16>
__device__ __forceinline__ void load_im2col(uint32_t* dst,
                                            const uint32_t* __restrict__ x,
                                            const RowInfo* rows,
                                            const ConvShape& S, int Kw,
                                            int k0) {
  constexpr int kPerRow = kVec16 ? kBK / 4 : kBK;   // copies per row
  constexpr int kWords = kBK / kPerRow;             // words per copy
  const int q = threadIdx.x % kPerRow;
  const int kk = k0 + q * kWords;
  const bool kin = kk < Kw;   // a 16-byte copy is in or out whole
  int di = 0, dj = 0, c = 0;
  if (kin) {
    const int tap = kk / S.Cw;
    c = kk - tap * S.Cw;
    di = tap / S.KW;
    dj = tap - di * S.KW;
  }
  for (int r = threadIdx.x / kPerRow; r < kRows;
       r += kMmaThreads / kPerRow) {
    const RowInfo ri = rows[r];
    const int ih = ri.ih0 + di;
    const int iw = ri.iw0 + dj;
    const bool in = kin && ih >= 0 && ih < S.H && iw >= 0 && iw < S.W;
    const uint32_t* s =
        in ? x + ((static_cast<long long>(ri.b) * S.H + ih) * S.W + iw) *
                     S.Cw + c
           : x;
    if constexpr (kVec16)
      cp_async16_ca(dst + r * kLds + q * kWords, s, in ? 16 : 0);
    else
      cp_async4(dst + r * kLds + q, s, in ? 4 : 0);
  }
}

template <int kWM, int kWN>
constexpr size_t conv_smem_bytes() {
  return mma_smem_bytes<kWM, kWN, kRing>() + 2 * 16 * kWM * sizeof(RowInfo);
}

template <int kWM, int kWN, bool kFused, bool kVec16>
__global__ void __launch_bounds__(kMmaThreads)
    conv_mma_kernel(const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ w,
                    const int32_t* __restrict__ corr,
                    const float* __restrict__ tau,
                    const float* __restrict__ flip, void* __restrict__ out,
                    ConvShape S) {
  constexpr int kBM = 2 * 16 * kWM;
  constexpr int kBN = 2 * 8 * kWN;
  extern __shared__ __align__(16) uint32_t smem[];   // the ring, then rows
  RowInfo* rows =
      reinterpret_cast<RowInfo*>(smem + kRing * (kBM + kBN) * kLds);
  const WarpPos p = warp_pos<kWM, kWN>();
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int pix = S.OH * S.OW;
  const int M = S.B * pix;
  const int N = S.C_out;
  const int Kw = S.KH * S.KW * S.Cw;

  for (int r = threadIdx.x; r < kBM; r += kMmaThreads) {
    const int m = m0 + r;
    RowInfo ri{0, kNoRow, kNoRow, 0};
    if (m < M) {
      const int q = m % pix;
      const int oh = q / S.OW;
      ri.b = m / pix;
      ri.ih0 = oh * S.stride - S.pad_top;
      ri.iw0 = (q - oh * S.OW) * S.stride - S.pad_left;
    }
    rows[r] = ri;
  }
  __syncthreads();

  int32_t acc[kWM][kWN][4];
  b1_main_loop<kWM, kWN, kRing, kVec16>(
      smem,
      [&](uint32_t* dst, int k0) {
        load_im2col<kBM, kVec16>(dst, x, rows, S, Kw, k0);
      },
      w, N, n0, Kw, S.k_true, p, acc);
#pragma unroll
  for (int i = 0; i < kWM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + p.wm + i * 16 + p.g + 8 * h;
      if (m >= M) continue;
      const int32_t* crow = corr + static_cast<long long>(m % pix) * N;
#pragma unroll
      for (int j = 0; j < kWN; ++j) {
        const int n = n0 + p.wn + j * 8 + 2 * p.t;
        if (n < N) acc[i][j][2 * h] += crow[n];
        if (n + 1 < N) acc[i][j][2 * h + 1] += crow[n + 1];
      }
    }
  if constexpr (kFused)
    store_fused(acc, tau, flip, static_cast<uint32_t*>(out), M, N,
                m0 + p.wm, n0 + p.wn, p.g, p.t);
  else
    store_int32(acc, static_cast<int32_t*>(out), M, N, m0 + p.wm, n0 + p.wn,
                p.g, p.t);
}

template <int kWM, int kWN, bool kFused, bool kVec16>
cudaError_t launch_as(const void* x, const void* w, const void* corr,
                      const void* tau, const void* flip, void* out,
                      const ConvShape& S, int M, cudaStream_t st) {
  constexpr int kBM = 2 * 16 * kWM;
  constexpr int kBN = 2 * 8 * kWN;
  const dim3 grid((M + kBM - 1) / kBM, (S.C_out + kBN - 1) / kBN);
  return launch_b1<&conv_mma_kernel<kWM, kWN, kFused, kVec16>,
                   conv_smem_bytes<kWM, kWN>()>(
      grid, st, static_cast<const uint32_t*>(x),
      static_cast<const uint32_t*>(w), static_cast<const int32_t*>(corr),
      static_cast<const float*>(tau), static_cast<const float*>(flip), out,
      S);
}

template <int kWM, int kWN, bool kFused>
cudaError_t launch_tile(const void* x, const void* w, const void* corr,
                        const void* tau, const void* flip, void* out,
                        const ConvShape& S, int M, int vec16,
                        cudaStream_t st) {
  return vec16 ? launch_as<kWM, kWN, kFused, true>(x, w, corr, tau, flip,
                                                   out, S, M, st)
               : launch_as<kWM, kWN, kFused, false>(x, w, corr, tau, flip,
                                                    out, S, M, st);
}

// tile: 1 for 64 x 64, 2 for 64 x 128 (binary_conv.TILE_64X64, TILE_64X128).
// vec16: Cw % 4 == 0 and x and w start on 16 bytes.
template <bool kFused>
int launch(const void* x, const void* w, const void* corr, const void* tau,
           const void* flip, void* out, int B, int H, int W, int Cw,
           int C_out, int KH, int KW, int stride, int pad_top, int pad_left,
           int OH, int OW, int k_true, int tile, int vec16, void* stream) {
  const long long M = static_cast<long long>(B) * OH * OW;
  if (M <= 0 || C_out <= 0) return static_cast<int>(cudaGetLastError());
  if (M > INT_MAX || static_cast<long long>(KH) * KW * Cw > INT_MAX ||
      (vec16 && Cw % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvShape S{B, H, W, Cw, C_out, KH, KW, stride, pad_top, pad_left,
                    OH, OW, k_true};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tile == 1)
    err = launch_tile<2, 4, kFused>(x, w, corr, tau, flip, out, S,
                                    static_cast<int>(M), vec16, st);
  else if (tile == 2)
    err = launch_tile<2, 8, kFused>(x, w, corr, tau, flip, out, S,
                                    static_cast<int>(M), vec16, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int conv_bn_sign(const void* x, const void* w, const void* corr,
                            const void* tau, const void* flip, void* out,
                            int B, int H, int W, int Cw, int C_out, int KH,
                            int KW, int stride, int pad_top, int pad_left,
                            int OH, int OW, int k_true, int tile, int vec16,
                            void* stream) {
  return launch<true>(x, w, corr, tau, flip, out, B, H, W, Cw, C_out, KH, KW,
                      stride, pad_top, pad_left, OH, OW, k_true, tile, vec16,
                      stream);
}

extern "C" int binary_conv(const void* x, const void* w, const void* corr,
                           void* out, int B, int H, int W, int Cw, int C_out,
                           int KH, int KW, int stride, int pad_top,
                           int pad_left, int OH, int OW, int k_true,
                           int tile, int vec16, void* stream) {
  return launch<false>(x, w, corr, nullptr, nullptr, out, B, H, W, Cw, C_out,
                       KH, KW, stride, pad_top, pad_left, OH, OW, k_true,
                       tile, vec16, stream);
}

namespace {

template <int kWN, bool kFused>
int query_tile(long long M, int C_out, int vec16, int* out,
               const char** name) {
  constexpr int kBM = 2 * 16 * 2;
  constexpr int kBN = 2 * 8 * kWN;
  const dim3 grid(static_cast<unsigned int>((M + kBM - 1) / kBM),
                  (C_out + kBN - 1) / kBN);
  constexpr size_t kSmem = conv_smem_bytes<2, kWN>();
  return vec16 ? launch_query(conv_mma_kernel<2, kWN, kFused, true>, grid,
                              dim3(kMmaThreads), kSmem, out, name)
               : launch_query(conv_mma_kernel<2, kWN, kFused, false>, grid,
                              dim3(kMmaThreads), kSmem, out, name);
}

template <bool kFused>
int query(long long M, int C_out, int tile, int vec16, int* out,
          const char** name) {
  if (tile == 1) return query_tile<4, kFused>(M, C_out, vec16, out, name);
  if (tile == 2) return query_tile<8, kFused>(M, C_out, vec16, out, name);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// What conv_bn_sign() (fused = 1) or binary_conv() (fused = 0) launches for
// a (B * OH * OW, C_out) output (common.cuh: launch_query).
extern "C" int conv_query(int B, int OH, int OW, int C_out, int tile,
                          int vec16, int fused, int* out, const char** name) {
  const long long M = static_cast<long long>(B) * OH * OW;
  return fused ? query<true>(M, C_out, tile, vec16, out, name)
               : query<false>(M, C_out, tile, vec16, out, name);
}
