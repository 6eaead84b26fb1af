// K1 bitplane_conv: the first-layer conv on the raw uint8 image (paper C4).
//
// Replaces: src/repro/kernels/binary_conv.py:277 _bitplane_conv_kernel
//           (pallas_call at :501, in bitplane_conv2d_packed).
// Computes: x (B, H, W, C_in) uint8, w (C_out, KH*KW*Cw) words ->
//           out (B, OH, OW, C_out) int32, the exact integer conv of x's
//           low nbits bits against sign(W), true zero padding.  The TPU
//           kernel takes x's bit planes, packed on the host, and gets there
//           by popcounts on each plane,
//             ((2^n - 1)(k_true + rowsum) - 2 sum_p 2^p mism_p) >> 1,
//           which equals that conv; this kernel reads the bytes of x and
//           computes the conv itself on the tensor cores, so no plane is
//           built and the plan's rowsum (which turns the plane popcounts
//           into it) is not needed here.  The wrapper still takes and
//           checks it, keeping the TPU kernel's operands.
//           Its fused instance (bitplane_conv_bn_sign) also replaces K2
//           (src/repro/kernels/fused_epilogue.py:96 _bn_sign_pack_kernel)
//           where K2 would follow it directly: out (B, OH, OW,
//           ceil(C_out/32)) words, bit = (f32(y) >= tau) == (flip > 0),
//           zero-bit tails, bit-identical to K2 on the int32 output
//           (|y| <= 255 * K < 2^24 here, so f32(y) is exact).
// Bound on the H100: at the BCNN's stage 0, batch 512, the int32 instance
//           writes 512*32*32*128*4 = 268 MB (0.080 ms at 3.35 TB/s); the
//           fused one reads the image (1.6 MB) and writes 1/32 of that
//           (8.4 MB), a bound of about 3 microseconds, with 1.8 G uint8
//           MACs (1.8 us of int8 peak) beside it.  The contraction is
//           K = KH*KW*C_in = 27 deep there, one k32 step, so the band's
//           copy and the weights' decode per block are what it pays for.
// Design:   a block of 4 warps owns a band of R output rows of one image
//           (R*OW >= 128 pixels) and all C_out channels in chunks of 64.
//   * Shared memory grows with the band (rows x columns x C_in bytes) and
//     with a chunk's weights (channels x depth).  Where 64 channels and
//     the full band exceed the card's per-block limit, the host takes
//     chunks of 32, 16 or 8 channels, then halves R down to 1 row; a
//     shape that fits in none of these is refused with kTooLarge, which
//     the wrapper turns into its own error.
//   * It copies the band's input rows from the image into shared memory,
//     [row][column][channel] bytes, with the halo's zero padding written
//     as 0, one byte a thread, masked to its low nbits bits (the bits x's
//     planes would keep).  At C_in = 3 a band is a few hundred bytes, so
//     the copy is not what bounds the kernel.
//   * A table maps each depth d = (tap, c) to its byte offset in that band,
//     so an A fragment (16 pixels x 32 depths, mma.sync m16n8k32 u8 x s8)
//     is 16 byte loads per thread; depths past K map to offset 0 against
//     zero weights.  General shapes loop over depth in steps of 32.
//   * Each chunk of 64 channels' weights is decoded once per block to +-1
//     int8, [channel][depth] with a 16-byte pad (no bank conflicts for the
//     B fragments), tail channels and depths 0.
//   * Each warp takes 16-pixel tiles: one A fragment per k32 step feeds 8
//     MMAs (64 channels).  The 16 x 64 int32 result is staged in shared
//     memory and written with 16-byte stores along the channel axis (4-byte
//     stores when C_out % 4 != 0); a band's output rows are contiguous.
//   * Fused instance (kFused): the chunk's tau and flip are loaded into
//     shared memory beside its weights.  From the staged tile, per pixel
//     row and per 32-channel word, lane = channel, bn_sign_ballot packs
//     the word; lane r * wpc + q keeps word q of row r (wpc = chunk / 32
//     words a pixel, a compile-time 2 or 1: a loop of ballots with a
//     run-time count spilled), and the warp stores them at once.  A word
//     must not span two chunks, so the host takes chunks of 64 or 32
//     channels only and halves the band before it would go below 32.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kChunkN = 64;                  // channels per chunk, at most
constexpr int kStageLd = kChunkN + 8;        // int32 row stride of stage
constexpr int kMinBandPixels = 128;
constexpr int kTooLarge = -1;                // no band and chunk fit

struct Geometry {
  int B, H, W, Cw, C_in, C_out, KH, KW, stride, pad_top, pad_left, OH, OW,
      nbits;
  int R, rows_b, Wb, K, Kpad, ws_ld, chunk;
  size_t stage_bytes, ws_bytes, off_bytes, xs_bytes, tf_bytes;

  __host__ __device__ size_t smem() const {
    return stage_bytes + ws_bytes + off_bytes + xs_bytes + tf_bytes;
  }
};

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~15ull; }

Geometry make_geometry(int B, int H, int W, int Cw, int C_in, int C_out,
                       int KH, int KW, int stride, int pad_top, int pad_left,
                       int OH, int OW, int nbits, int R, int chunk,
                       bool fused) {
  Geometry g{B, H, W, Cw, C_in, C_out, KH, KW, stride, pad_top, pad_left, OH,
             OW, nbits};
  g.R = R;
  g.chunk = chunk;
  g.rows_b = (g.R - 1) * stride + KH;
  g.Wb = (OW - 1) * stride + KW;
  g.K = KH * KW * C_in;
  g.Kpad = (g.K + 31) / 32 * 32;
  g.ws_ld = g.Kpad + 16;
  g.stage_bytes = static_cast<size_t>(kWarps) * 16 * kStageLd * 4;
  g.ws_bytes = round16(static_cast<size_t>(chunk) * g.ws_ld);
  g.off_bytes = round16(static_cast<size_t>(g.Kpad) * 4);
  g.xs_bytes = round16(static_cast<size_t>(g.rows_b) * g.Wb * C_in);
  // the fused instance's tau and flip of one chunk
  g.tf_bytes = fused ? 2 * kChunkN * sizeof(float) : 0;
  return g;
}

__device__ __forceinline__ void mma_u8s8(int32_t (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four bytes of the band at base + off[0..3], lowest in the lowest byte.
__device__ __forceinline__ uint32_t gather4(const uint8_t* xs, int base,
                                            const int* off) {
  return static_cast<uint32_t>(xs[base + off[0]]) |
         (static_cast<uint32_t>(xs[base + off[1]]) << 8) |
         (static_cast<uint32_t>(xs[base + off[2]]) << 16) |
         (static_cast<uint32_t>(xs[base + off[3]]) << 24);
}

// K1's fused epilogue on one warp's staged 16 x chunk tile: word q of
// pixel row r (lane = channel 32 q + lane of the chunk) by one ballot;
// lane r * kWpc + q keeps it and stores it.  kWpc = chunk / 32.
template <int kWpc>
__device__ __forceinline__ void store_words(const int32_t* st,
                                            const float* tau_s,
                                            const float* flip_s,
                                            uint32_t* out, long long px0,
                                            int rows, int n0, int cn,
                                            int C_out, int lane) {
  uint32_t mine = 0;
#pragma unroll
  for (int i = 0; i < 16 * kWpc; ++i) {
    const int ch = (i % kWpc) * 32 + lane;
    const uint32_t bits =
        bn_sign_ballot(st[(i / kWpc) * kStageLd + ch], n0 + ch < C_out,
                       tau_s, flip_s, ch);
    mine = lane == i ? bits : mine;
  }
  const int r = lane / kWpc;
  const int q = lane % kWpc;
  if (r < rows && q * 32 < cn)
    out[(px0 + r) * ((C_out + 31) / 32) + n0 / 32 + q] = mine;
}

// kFused: out is (B, OH, OW, ceil(C_out/32)) words of the BN-sign
// epilogue on tau/flip; else (B, OH, OW, C_out) int32 and tau/flip unused.
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
    bitplane_conv_kernel(const uint8_t* __restrict__ x,
                         const uint32_t* __restrict__ w,
                         const float* __restrict__ tau,
                         const float* __restrict__ flip,
                         void* __restrict__ out_, Geometry G) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* stage = reinterpret_cast<int32_t*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + G.stage_bytes);
  int* off = reinterpret_cast<int*>(smem + G.stage_bytes + G.ws_bytes);
  uint8_t* xs = reinterpret_cast<uint8_t*>(smem + G.stage_bytes + G.ws_bytes +
                                           G.off_bytes);
  float* tau_s = reinterpret_cast<float*>(smem + G.stage_bytes + G.ws_bytes +
                                          G.off_bytes + G.xs_bytes);
  float* flip_s = tau_s + kChunkN;
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int warp = tid / kWarp;
  const int b = blockIdx.y;
  const int oh0 = blockIdx.x * G.R;
  const int r_eff = min(G.R, G.OH - oh0);
  const int P = r_eff * G.OW;
  const int ih_first = oh0 * G.stride - G.pad_top;

  // 1. the band's input rows -> xs[rb][col][c], the halo 0.  Byte i of
  //    band row rb is image byte o = i - lead of image row ih_first + rb
  //    (o = iw * C_in + c), or padding where that row or o is outside.
  const int row_bytes = G.Wb * G.C_in;
  const int lead = G.pad_left * G.C_in;
  const int img_bytes = G.W * G.C_in;
  const int band = G.rows_b * row_bytes;
  const uint8_t* img = x + static_cast<long long>(b) * G.H * img_bytes;
  const uint32_t mask = (1u << G.nbits) - 1u;
  for (int i = tid; i < band; i += kThreads) {
    const int ih = ih_first + i / row_bytes;
    const int o = i % row_bytes - lead;
    xs[i] = ih >= 0 && ih < G.H && o >= 0 && o < img_bytes
                ? static_cast<uint8_t>(
                      img[static_cast<long long>(ih) * img_bytes + o] & mask)
                : 0;
  }
  // the depth -> band offset table
  for (int d = tid; d < G.Kpad; d += kThreads) {
    int o = 0;
    if (d < G.K) {
      const int tap = d / G.C_in;
      const int c = d % G.C_in;
      o = ((tap / G.KW) * G.Wb + tap % G.KW) * G.C_in + c;
    }
    off[d] = o;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int mtiles = (P + 15) / 16;
  const int w_row = G.KH * G.KW * G.Cw;
  int32_t* st = stage + warp * 16 * kStageLd;
  const long long out_px0 = (static_cast<long long>(b) * G.OH + oh0) * G.OW;

  // depths past K hold weight 0 in every chunk
  const int taps = G.KH * G.KW;
  const int tail = G.Kpad - G.K;
  for (int i = tid; i < G.chunk * tail; i += kThreads)
    ws[(i / tail) * G.ws_ld + G.K + i % tail] = 0;

  for (int n0 = 0; n0 < G.C_out; n0 += G.chunk) {
    __syncthreads();  // the band is copied; the last chunk's weights done
    // 2. this chunk's weights -> ws[n][tap * C_in + c] = +-1, 0 past C_out
    for (int i = tid; i < G.chunk * taps; i += kThreads) {
      const int nl = i / taps;
      const int tap = i % taps;
      const int n = n0 + nl;
      int8_t* dst = ws + nl * G.ws_ld + tap * G.C_in;
      if (n < G.C_out) {
        const uint32_t* wp =
            w + static_cast<long long>(n) * w_row + tap * G.Cw;
        for (int c = 0; c < G.C_in; ++c)
          dst[c] = ((wp[c / 32] >> (c % 32)) & 1u) ? 1 : -1;
      } else {
        for (int c = 0; c < G.C_in; ++c) dst[c] = 0;
      }
    }
    if constexpr (kFused) {
      for (int i = tid; i < G.chunk; i += kThreads) {
        const bool in = n0 + i < G.C_out;
        tau_s[i] = in ? tau[n0 + i] : 0.f;
        flip_s[i] = in ? flip[n0 + i] : 1.f;
      }
    }
    __syncthreads();
    const int cn = min(G.chunk, G.C_out - n0);
    const int ntiles = (cn + 7) / 8;

    // 3. 16-pixel tiles x 64 channels on the tensor cores
    for (int mt = warp; mt < mtiles; mt += kWarps) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        base[h] = p < P ? ((p / G.OW) * G.stride * G.Wb +
                           (p % G.OW) * G.stride) * G.C_in
                        : 0;
      }
      int32_t acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
      for (int k0 = 0; k0 < G.Kpad; k0 += 32) {
        const int* o_lo = off + k0 + 4 * t;
        const int* o_hi = o_lo + 16;
        const uint32_t a0 = gather4(xs, base[0], o_lo);
        const uint32_t a1 = gather4(xs, base[1], o_lo);
        const uint32_t a2 = gather4(xs, base[0], o_hi);
        const uint32_t a3 = gather4(xs, base[1], o_hi);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < ntiles) {
            const int8_t* wr = ws + (j * 8 + g) * G.ws_ld + k0 + 4 * t;
            mma_u8s8(acc[j], a0, a1, a2, a3,
                     *reinterpret_cast<const uint32_t*>(wr),
                     *reinterpret_cast<const uint32_t*>(wr + 16));
          }
        }
      }
      // stage the 16 x chunk tile, then write rows of channels
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<int2*>(st + g * kStageLd + j * 8 + 2 * t) =
            make_int2(acc[j][0], acc[j][1]);
        *reinterpret_cast<int2*>(st + (g + 8) * kStageLd + j * 8 + 2 * t) =
            make_int2(acc[j][2], acc[j][3]);
      }
      __syncwarp();
      const int p0 = mt * 16;
      if constexpr (kFused) {
        uint32_t* out = static_cast<uint32_t*>(out_);
        const int rows = min(16, P - p0);
        if (G.chunk == 64)
          store_words<2>(st, tau_s, flip_s, out, out_px0 + p0, rows, n0, cn,
                         G.C_out, lane);
        else
          store_words<1>(st, tau_s, flip_s, out, out_px0 + p0, rows, n0, cn,
                         G.C_out, lane);
      } else {
        int32_t* out = static_cast<int32_t*>(out_);
        if (G.C_out % 4 == 0) {
          for (int i = lane; i < 16 * (kChunkN / 4); i += kWarp) {
            const int r = i / (kChunkN / 4);
            const int q = i % (kChunkN / 4);
            if (p0 + r < P && q * 4 < cn)
              *reinterpret_cast<int4*>(out + (out_px0 + p0 + r) * G.C_out +
                                       n0 + q * 4) =
                  *reinterpret_cast<const int4*>(st + r * kStageLd + q * 4);
          }
        } else {
          for (int i = lane; i < 16 * kChunkN; i += kWarp) {
            const int r = i / kChunkN;
            const int ch = i % kChunkN;
            if (p0 + r < P && ch < cn)
              out[(out_px0 + p0 + r) * G.C_out + n0 + ch] =
                  st[r * kStageLd + ch];
          }
        }
      }
      __syncwarp();
    }
  }
}

// The geometry search.  The int32 instance takes the largest chunk of 64,
// 32, 16 or 8 channels, then the largest band, that fits the card's
// per-block limit; the fused one chunks of 64 or 32 only, so that no
// 32-channel word spans two chunks.  Returns 0, kTooLarge where nothing
// fits, or a CUDA error.
int search_geometry(int B, int H, int W, int Cw, int C_in, int C_out, int KH,
                    int KW, int stride, int pad_top, int pad_left, int OH,
                    int OW, int nbits, bool fused, Geometry* g) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int min_chunk = fused ? 32 : 8;
  bool fits = false;
  const int r_full = (kMinBandPixels + OW - 1) / OW;
  for (int R = r_full < OH ? r_full : OH; R >= 1 && !fits;
       R = R > 1 ? R / 2 : 0)
    for (int chunk = kChunkN; chunk >= min_chunk && !fits; chunk /= 2) {
      *g = make_geometry(B, H, W, Cw, C_in, C_out, KH, KW, stride, pad_top,
                         pad_left, OH, OW, nbits, R, chunk, fused);
      fits = g->smem() <= static_cast<size_t>(limit);
    }
  return fits ? 0 : kTooLarge;
}

// The launch of either instance in the geometry search_geometry finds.
template <bool kFused>
int launch(const void* x, const void* w, const void* tau,
           const void* flip, void* out, int B, int H, int W, int Cw,
           int C_in, int C_out, int KH, int KW, int stride, int pad_top,
           int pad_left, int OH, int OW, int nbits, void* stream) {
  if (B <= 0 || OH <= 0 || OW <= 0 || C_out <= 0)
    return static_cast<int>(cudaGetLastError());
  if (nbits < 1 || nbits > 8 || C_in < 1 || C_in > 32 * Cw)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{};
  const int found = search_geometry(B, H, W, Cw, C_in, C_out, KH, KW, stride,
                                    pad_top, pad_left, OH, OW, nbits, kFused,
                                    &g);
  if (found != 0) return found;
  cudaError_t e = cudaSuccess;
  const size_t smem = g.smem();
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(bitplane_conv_kernel<kFused>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((OH + g.R - 1) / g.R, B);
  bitplane_conv_kernel<kFused><<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<const float*>(tau), static_cast<const float*>(flip), out,
      g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bitplane_conv(const void* x, const void* w, void* out,
                             int B, int H, int W, int Cw, int C_in, int C_out,
                             int KH, int KW, int stride, int pad_top,
                             int pad_left, int OH, int OW, int nbits,
                             void* stream) {
  return launch<false>(x, w, nullptr, nullptr, out, B, H, W, Cw, C_in,
                       C_out, KH, KW, stride, pad_top, pad_left, OH, OW,
                       nbits, stream);
}

// The fused instance: out (B, OH, OW, ceil(C_out/32)) words.
extern "C" int bitplane_conv_bn_sign(const void* x, const void* w,
                                     const void* tau, const void* flip,
                                     void* out, int B, int H, int W, int Cw,
                                     int C_in, int C_out, int KH, int KW,
                                     int stride, int pad_top, int pad_left,
                                     int OH, int OW, int nbits,
                                     void* stream) {
  return launch<true>(x, w, tau, flip, out, B, H, W, Cw, C_in, C_out,
                      KH, KW, stride, pad_top, pad_left, OH, OW, nbits,
                      stream);
}

// What bitplane_conv() (fused = 0) or bitplane_conv_bn_sign() (fused = 1)
// launches for these sizes (common.cuh: launch_query); kTooLarge where no
// band and chunk fit.
extern "C" int bitplane_conv_query(int B, int H, int W, int Cw, int C_in,
                                   int C_out, int KH, int KW, int stride,
                                   int pad_top, int pad_left, int OH, int OW,
                                   int nbits, int fused, int* out,
                                   const char** name) {
  Geometry g{};
  const int found = search_geometry(B, H, W, Cw, C_in, C_out, KH, KW, stride,
                                    pad_top, pad_left, OH, OW, nbits,
                                    fused != 0, &g);
  if (found != 0) return found;
  const dim3 grid((OH + g.R - 1) / g.R, B);
  return fused ? launch_query(bitplane_conv_kernel<true>, grid,
                              dim3(kThreads), g.smem(), out, name)
               : launch_query(bitplane_conv_kernel<false>, grid,
                              dim3(kThreads), g.smem(), out, name);
}
