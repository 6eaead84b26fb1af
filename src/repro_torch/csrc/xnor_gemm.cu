// K4 xnor_gemm: packed binary GEMM, int32 or fused BN-sign epilogue.
//
// Replaces: src/repro/kernels/binary_matmul.py:120 _gemm_kernel and :156
//           _gemv_kernel (pallas_calls at :287 and :270), and :137
//           _gemm_bn_sign_kernel and :162 _gemv_bn_sign_kernel
//           (pallas_calls at :363 and :343).
// Computes: a (M, Kw) words, b (N, Kw) words ->
//             int32 epilogue: out (M, N) int32 = k_true - 2*popc(a ^ b);
//             fused epilogue: out (M, ceil(N/32)) words, thresholded against
//               tau/flip (N,) f32 and packed along N as bn_sign_ballot does
//               (common.cuh).
// Bound on the H100: at large M the tensor cores.  Their 1-bit MMA (no
//           published H100 rate; chip_smoke.py measures its peak) runs this
//           contraction faster than the int8 route's 1,979 TOP/s bound and
//           far above the POPC pipe's 4.18e12 word-ops/s.  At small M the
//           weight bytes (each weight word is used by M rows only).
// Design, large M (tensor cores; the wrapper picks the route and tile by
//           shape, binary_matmul.gemm_route):
//   * A block of 4 warps (2 x 2) owns a BM x BN output tile, 128 x 128
//     (warp tile 64 x 64) or 64 x 64 (warp tile 32 x 32) when the large
//     tile would leave SMs idle.
//   * Tiles of BK = 32 packed words per row of A and B go through a ring of
//     3 shared-memory stages (110.6 KB or 55.3 KB, dynamic) filled by
//     cp.async (16-byte copies where the wrapper found the rows 16-byte
//     aligned, else 4-byte copies), so the next tiles load while the
//     tensor cores work on this one.  Rows past M or N and words past Kw
//     are zero-filled by the copy itself and add nothing.
//   * The packed words are the fragments: one mma.sync.m16n8k256.b1
//     .and.popc step takes 8 words per row, a thread words t and t+4 of
//     rows g and g+8 (t = lane % 4, g = lane / 4), straight from shared
//     memory with no decode.  It sums popc(a & b).  The same loads give
//     each thread a share of popc(a) and popc(b); two shuffles finish them,
//     and popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b) gives
//     y = k_true - 2 popc(a ^ b) exactly, as the reference computes it.
//   * The int32 epilogue stores two adjacent columns per thread (full
//     32-byte sectors); the fused one thresholds each column, ORs a row's
//     32-column group across the 4 threads that hold it (two shuffles) and
//     writes only the words.
//   * A +-1 int8 route (m16n8k32 on the words decoded to bytes) ran 5-7x
//     slower than this one on the H100 (PERF.md): its decode, not its
//     MMA, bound it.
// Design, small M (M <= kSmallMaxRows = binary_matmul.SMALL_M_MAX, one
//   request to a few, the crossover measured on the H100): the weight
//   bytes bind.  A block owns 32 output columns; its warps split Kw into
//   16-word chunks, each warp reading a 32-row x 16-word tile of B with
//   coalesced 64-byte row segments into shared memory (stride 17, no bank
//   conflicts), then lane = column runs XOR + POPC against the A words,
//   which it takes by shuffle.  Partial counts meet in shared memory, and
//   warp 0 writes lane = column (coalesced int32, or one ballot word).
//   Every weight word is read once, and N/32 blocks fill the card.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kBK = 32;          // packed words per row per stage
constexpr int kStages = 3;
constexpr int kLds = kBK + 4;    // smem row stride in words: 16-byte rows,
                                 // no bank conflicts for 8 rows x 1 word
constexpr int kMmaThreads = 128; // 2 x 2 warps
constexpr int kChunk = 16;       // small-M: words per warp chunk
constexpr int kSmallWarps = 8;
constexpr int kSmallMaxRows = 8;   // binary_matmul.SMALL_M_MAX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; src_bytes = 0 writes zeros without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One m16n8k256 step on 1-bit operands: c += popc(a & b) over 256 bits.
// The A fragment is rows g and g+8, words t and t+4 of an 8-word group;
// the B fragment is column g, words t and t+4 (t = lane % 4, g = lane / 4).
__device__ __forceinline__ void mma_b1(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + kRows) x words [k0, k0 + kBK) of a (rows, Kw)
// word matrix into dst[kRows][kLds], zero-filling outside it.
template <int kRows, int kThreads, bool kVec16>
__device__ __forceinline__ void load_tile(uint32_t* dst,
                                          const uint32_t* __restrict__ src,
                                          int rows, int Kw, int row0, int k0) {
  if constexpr (kVec16) {
    constexpr int kPerRow = kBK / 4;
    for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
      const int r = i / kPerRow;
      const int k = k0 + (i % kPerRow) * 4;
      const bool in = row0 + r < rows && k < Kw;  // Kw % 4 == 0 here
      const uint32_t* s =
          in ? src + static_cast<long long>(row0 + r) * Kw + k : src;
      cp_async16(dst + r * kLds + (i % kPerRow) * 4, s, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kBK; i += kThreads) {
      const int r = i / kBK;
      const int k = k0 + i % kBK;
      const bool in = row0 + r < rows && k < Kw;
      const uint32_t* s =
          in ? src + static_cast<long long>(row0 + r) * Kw + k : src;
      cp_async4(dst + r * kLds + i % kBK, s, in ? 4 : 0);
    }
  }
}

template <int kWM, int kWN>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kStages) * (2 * 16 * kWM + 2 * 8 * kWN) * kLds *
         4;
}

// Tensor-core route: 2 x 2 warps, warp tile (16 kWM) x (8 kWN).
template <int kWM, int kWN, bool kFused, bool kVec16>
__global__ void __launch_bounds__(kMmaThreads)
    xnor_mma_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    const float* __restrict__ tau,
                    const float* __restrict__ flip, void* __restrict__ out,
                    int M, int N, int Kw, int k_true) {
  constexpr int kBM = 2 * 16 * kWM;
  constexpr int kBN = 2 * 8 * kWN;
  static_assert(kWN % 4 == 0, "a warp's columns cover whole 32-col words");
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* As = smem;                          // [kStages][kBM][kLds]
  uint32_t* Bs = smem + kStages * kBM * kLds;   // [kStages][kBN][kLds]

  const int lane = lane_id();
  const int warp = threadIdx.x / kWarp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 16 * kWM;
  const int wn = (warp & 1) * 8 * kWN;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kt_count = (Kw + kBK - 1) / kBK;

  int32_t acc[kWM][kWN][4];   // popc(a & b)
  int pa[kWM][2];             // this thread's share of popc(a row)
  int pb[kWN];                // and of popc(b row)
#pragma unroll
  for (int i = 0; i < kWM; ++i) {
    pa[i][0] = pa[i][1] = 0;
#pragma unroll
    for (int j = 0; j < kWN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  }
#pragma unroll
  for (int j = 0; j < kWN; ++j) pb[j] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) {
      load_tile<kBM, kMmaThreads, kVec16>(As + s * kBM * kLds, a, M, Kw, m0,
                                          s * kBK);
      load_tile<kBN, kMmaThreads, kVec16>(Bs + s * kBN * kLds, b, N, Kw, n0,
                                          s * kBK);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free for reuse
    const int next = kt + kStages - 1;
    if (next < kt_count) {
      load_tile<kBM, kMmaThreads, kVec16>(As + (next % kStages) * kBM * kLds,
                                          a, M, Kw, m0, next * kBK);
      load_tile<kBN, kMmaThreads, kVec16>(Bs + (next % kStages) * kBN * kLds,
                                          b, N, Kw, n0, next * kBK);
    }
    cp_async_commit();
    const uint32_t* as = As + (kt % kStages) * kBM * kLds;
    const uint32_t* bs = Bs + (kt % kStages) * kBN * kLds;
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {   // one k256 step
      uint32_t af[kWM][4];
#pragma unroll
      for (int i = 0; i < kWM; ++i) {
        const uint32_t* r0 = as + (wm + i * 16 + g) * kLds + k8 + t;
        const uint32_t* r1 = r0 + 8 * kLds;
        af[i][0] = r0[0];
        af[i][1] = r1[0];
        af[i][2] = r0[4];
        af[i][3] = r1[4];
        pa[i][0] += __popc(af[i][0]) + __popc(af[i][2]);
        pa[i][1] += __popc(af[i][1]) + __popc(af[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kWN; ++j) {
        const uint32_t* rb = bs + (wn + j * 8 + g) * kLds + k8 + t;
        const uint32_t b0 = rb[0];
        const uint32_t b1 = rb[4];
        pb[j] += __popc(b0) + __popc(b1);
#pragma unroll
        for (int i = 0; i < kWM; ++i) mma_b1(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // Whole-row popcounts: the four threads of a group hold the 8 words of
  // each k256 step between them.
#pragma unroll
  for (int i = 0; i < kWM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pa[i][h] += __shfl_xor_sync(0xffffffffu, pa[i][h], 1);
      pa[i][h] += __shfl_xor_sync(0xffffffffu, pa[i][h], 2);
    }
#pragma unroll
  for (int j = 0; j < kWN; ++j) {
    pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], 1);
    pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], 2);
  }
  // acc becomes y = k_true - 2 popc(a ^ b), popc(a ^ b) = popc(a) +
  // popc(b) - 2 popc(a & b); column 2t + e's popc(b) sits with the lanes of
  // group 2t + e.
#pragma unroll
  for (int j = 0; j < kWN; ++j) {
    const int pc[2] = {__shfl_sync(0xffffffffu, pb[j], 8 * t),
                       __shfl_sync(0xffffffffu, pb[j], 8 * t + 4)};
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[i][j][2 * h + e] =
              k_true - 2 * (pa[i][h] + pc[e] - 2 * acc[i][j][2 * h + e]);
  }

  if constexpr (kFused) {
    const int groups = (N + kWarp - 1) / kWarp;
    uint32_t* o = static_cast<uint32_t*>(out);
#pragma unroll
    for (int q = 0; q < kWN / 4; ++q) {   // one 32-column word per q
      float tv[8], fv[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + (4 * q + jj) * 8 + 2 * t + e;
          tv[jj * 2 + e] = n < N ? tau[n] : 0.f;
          fv[jj * 2 + e] = n < N ? flip[n] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < kWM; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // rows g and g + 8
          uint32_t bits = 0;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = (4 * q + jj) * 8 + 2 * t + e;  // in the warp
              const bool bit =
                  n0 + wn + col < N &&
                  ((static_cast<float>(acc[i][4 * q + jj][2 * h + e]) >=
                    tv[jj * 2 + e]) == (fv[jj * 2 + e] > 0.f));
              bits |= static_cast<uint32_t>(bit) << (col % 32);
            }
          bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
          bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
          const int m = m0 + wm + i * 16 + g + 8 * h;
          const int word = (n0 + wn) / kWarp + q;
          if (t == 0 && m < M && word < groups)
            o[static_cast<long long>(m) * groups + word] = bits;
        }
    }
  } else {
    int32_t* o = static_cast<int32_t*>(out);
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        if (m >= M) continue;
        int32_t* orow = o + static_cast<long long>(m) * N;
#pragma unroll
        for (int j = 0; j < kWN; ++j) {
          const int n = n0 + wn + j * 8 + 2 * t;
          const int32_t y0 = acc[i][j][2 * h];
          const int32_t y1 = acc[i][j][2 * h + 1];
          if (pairs && n < N) {
            *reinterpret_cast<int2*>(orow + n) = make_int2(y0, y1);
          } else {
            if (n < N) orow[n] = y0;
            if (n + 1 < N) orow[n + 1] = y1;
          }
        }
      }
  }
}

// Small-M route: rows of A up to kRows, 32 columns per block.
template <int kRows, bool kFused>
__global__ void __launch_bounds__(kSmallWarps* kWarp)
    xnor_small_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b,
                      const float* __restrict__ tau,
                      const float* __restrict__ flip, void* __restrict__ out,
                      int M, int N, int Kw, int k_true) {
  __shared__ uint32_t tile[kSmallWarps][kWarp * (kChunk + 1)];
  __shared__ int32_t part[kSmallWarps][kRows][kWarp];
  const int lane = lane_id();
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int n0 = blockIdx.x * kWarp;
  const int half = lane / kChunk;       // which of two rows a load serves
  const int kl = lane % kChunk;
  uint32_t* tw = tile[warp];

  int mism[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) mism[m] = 0;

  const int chunks = (Kw + kChunk - 1) / kChunk;
  for (int c = warp; c < chunks; c += warps) {
    const int k = c * kChunk + kl;
    const bool kin = k < Kw;
#pragma unroll
    for (int r = 0; r < kWarp; r += 2) {
      const int n = n0 + r + half;
      tw[(r + half) * (kChunk + 1) + kl] =
          (kin && n < N) ? b[static_cast<long long>(n) * Kw + k] : 0u;
    }
    // A words of this chunk, lane kl holds word k of each row.
    uint32_t aw[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
      aw[m] = (kin && m < M) ? a[static_cast<long long>(m) * Kw + k] : 0u;
    __syncwarp();
    const int kc = min(kChunk, Kw - c * kChunk);
    for (int kk = 0; kk < kc; ++kk) {
      const uint32_t bw = tw[lane * (kChunk + 1) + kk];
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        mism[m] += __popc(__shfl_sync(0xffffffffu, aw[m], kk) ^ bw);
    }
    __syncwarp();
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) part[warp][m][lane] = mism[m];
  __syncthreads();
  if (warp != 0) return;  // uniform per warp; warp 0 writes
  const int n = n0 + lane;
  const bool valid = n < N;
  const int groups = (N + kWarp - 1) / kWarp;
  for (int m = 0; m < M && m < kRows; ++m) {
    int s = 0;
    for (int w = 0; w < warps; ++w) s += part[w][m][lane];
    const int32_t y = k_true - 2 * s;
    if constexpr (kFused) {
      const uint32_t bits = bn_sign_ballot(y, valid, tau, flip, n);
      if (lane == 0)
        static_cast<uint32_t*>(out)[static_cast<long long>(m) * groups +
                                    blockIdx.x] = bits;
    } else {
      if (valid) static_cast<int32_t*>(out)[static_cast<long long>(m) * N + n] = y;
    }
  }
}

template <int kWM, int kWN, bool kFused, bool kVec16>
cudaError_t launch_mma_as(const uint32_t* a, const uint32_t* b,
                          const float* tau, const float* flip, void* out,
                          int M, int N, int Kw, int k_true, cudaStream_t st) {
  constexpr int kBM = 2 * 16 * kWM;
  constexpr int kBN = 2 * 8 * kWN;
  constexpr size_t kSmem = mma_smem_bytes<kWM, kWN>();
  auto kernel = xnor_mma_kernel<kWM, kWN, kFused, kVec16>;
  // above 48 KB a kernel takes dynamic shared memory only after this
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kMmaThreads, kSmem, st>>>(a, b, tau, flip, out, M, N, Kw,
                                           k_true);
  return cudaGetLastError();
}

template <int kWM, int kWN, bool kFused>
cudaError_t launch_mma(const uint32_t* a, const uint32_t* b, const float* tau,
                       const float* flip, void* out, int M, int N, int Kw,
                       int k_true, int vec16, cudaStream_t st) {
  return vec16 ? launch_mma_as<kWM, kWN, kFused, true>(a, b, tau, flip, out,
                                                       M, N, Kw, k_true, st)
               : launch_mma_as<kWM, kWN, kFused, false>(a, b, tau, flip, out,
                                                        M, N, Kw, k_true, st);
}

template <int kRows, bool kFused>
cudaError_t launch_small(const uint32_t* a, const uint32_t* b,
                         const float* tau, const float* flip, void* out,
                         int M, int N, int Kw, int k_true, cudaStream_t st) {
  const int chunks = (Kw + kChunk - 1) / kChunk;
  const int warps = chunks < kSmallWarps ? (chunks > 0 ? chunks : 1)
                                         : kSmallWarps;
  xnor_small_kernel<kRows, kFused><<<(N + kWarp - 1) / kWarp, warps * kWarp,
                                     0, st>>>(a, b, tau, flip, out, M, N, Kw,
                                              k_true);
  return cudaGetLastError();
}

// route: 0 small M (M <= kSmallMaxRows), 1 tensor cores with 64 x 64 tiles, 2 with
// 128 x 128 tiles.  vec16: rows of both operands are 16-byte aligned.
template <bool kFused>
int launch(const void* a_, const void* b_, const void* tau_,
           const void* flip_, void* out, int M, int N, int Kw, int k_true,
           int route, int vec16, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const auto* a = static_cast<const uint32_t*>(a_);
  const auto* b = static_cast<const uint32_t*>(b_);
  const auto* tau = static_cast<const float*>(tau_);
  const auto* flip = static_cast<const float*>(flip_);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 0) {
    if (M > kSmallMaxRows) return static_cast<int>(cudaErrorInvalidValue);
    if (M <= 1)
      err = launch_small<1, kFused>(a, b, tau, flip, out, M, N, Kw, k_true, st);
    else if (M <= 2)
      err = launch_small<2, kFused>(a, b, tau, flip, out, M, N, Kw, k_true, st);
    else if (M <= 4)
      err = launch_small<4, kFused>(a, b, tau, flip, out, M, N, Kw, k_true, st);
    else
      err = launch_small<kSmallMaxRows, kFused>(a, b, tau, flip, out, M, N,
                                                Kw, k_true, st);
  } else if (route == 1) {
    err = launch_mma<2, 4, kFused>(a, b, tau, flip, out, M, N, Kw, k_true,
                                   vec16, st);
  } else if (route == 2) {
    err = launch_mma<4, 8, kFused>(a, b, tau, flip, out, M, N, Kw, k_true,
                                   vec16, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int xnor_gemm(const void* a, const void* b, void* out, int M,
                         int N, int Kw, int k_true, int route, int vec16,
                         void* stream) {
  return launch<false>(a, b, nullptr, nullptr, out, M, N, Kw, k_true, route,
                       vec16, stream);
}

extern "C" int xnor_gemm_bn_sign(const void* a, const void* b,
                                 const void* tau, const void* flip, void* out,
                                 int M, int N, int Kw, int k_true, int route,
                                 int vec16, void* stream) {
  return launch<true>(a, b, tau, flip, out, M, N, Kw, k_true, route, vec16,
                      stream);
}
