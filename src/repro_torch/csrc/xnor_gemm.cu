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
//           shape, binary_matmul.gemm_route; the main loop and both
//           epilogues live in b1_mma.cuh, shared with K3/K7):
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
#include "b1_mma.cuh"

using namespace repro;

namespace {

constexpr int kChunk = 16;       // small-M: words per warp chunk
constexpr int kSmallWarps = 8;
constexpr int kSmallMaxRows = 8;   // binary_matmul.SMALL_M_MAX

// Tensor-core route: 2 x 2 warps, warp tile (16 kWM) x (8 kWN), the main
// loop of b1_mma.cuh with A's rows staged as they are.
template <int kWM, int kWN, bool kFused, bool kVec16>
__global__ void __launch_bounds__(kMmaThreads)
    xnor_mma_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    const float* __restrict__ tau,
                    const float* __restrict__ flip, void* __restrict__ out,
                    int M, int N, int Kw, int k_true) {
  constexpr int kBM = 2 * 16 * kWM;
  constexpr int kBN = 2 * 8 * kWN;
  extern __shared__ __align__(16) uint32_t smem[];
  const WarpPos p = warp_pos<kWM, kWN>();
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int32_t acc[kWM][kWN][4];
  b1_main_loop<kWM, kWN, kStages, kVec16>(
      smem,
      [&](uint32_t* dst, int k0) {
        load_tile<kBM, kMmaThreads, kVec16>(dst, a, M, Kw, m0, k0);
      },
      b, N, n0, Kw, k_true, p, acc);
  if constexpr (kFused)
    store_fused(acc, tau, flip, static_cast<uint32_t*>(out), M, N,
                m0 + p.wm, n0 + p.wn, p.g, p.t);
  else
    store_int32(acc, static_cast<int32_t*>(out), M, N, m0 + p.wm, n0 + p.wn,
                p.g, p.t);
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
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  return launch_b1<&xnor_mma_kernel<kWM, kWN, kFused, kVec16>,
                   mma_smem_bytes<kWM, kWN, kStages>()>(
      grid, st, a, b, tau, flip, out, M, N, Kw, k_true);
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

namespace {

template <int kWM, int kWN, bool kFused>
int query_mma(int M, int N, int vec16, int* out, const char** name) {
  constexpr int kBM = 2 * 16 * kWM;
  constexpr int kBN = 2 * 8 * kWN;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  constexpr size_t kSmem = mma_smem_bytes<kWM, kWN, kStages>();
  return vec16 ? launch_query(xnor_mma_kernel<kWM, kWN, kFused, true>, grid,
                              dim3(kMmaThreads), kSmem, out, name)
               : launch_query(xnor_mma_kernel<kWM, kWN, kFused, false>, grid,
                              dim3(kMmaThreads), kSmem, out, name);
}

template <int kRows, bool kFused>
int query_small(int N, int Kw, int* out, const char** name) {
  const int chunks = (Kw + kChunk - 1) / kChunk;
  const int warps = chunks < kSmallWarps ? (chunks > 0 ? chunks : 1)
                                         : kSmallWarps;
  return launch_query(xnor_small_kernel<kRows, kFused>,
                      dim3((N + kWarp - 1) / kWarp), dim3(warps * kWarp), 0,
                      out, name);
}

template <bool kFused>
int query(int M, int N, int Kw, int route, int vec16, int* out,
          const char** name) {
  if (route == 0) {
    if (M <= 1) return query_small<1, kFused>(N, Kw, out, name);
    if (M <= 2) return query_small<2, kFused>(N, Kw, out, name);
    if (M <= 4) return query_small<4, kFused>(N, Kw, out, name);
    return query_small<kSmallMaxRows, kFused>(N, Kw, out, name);
  }
  if (route == 1) return query_mma<2, 4, kFused>(M, N, vec16, out, name);
  if (route == 2) return query_mma<4, 8, kFused>(M, N, vec16, out, name);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// What xnor_gemm() (fused = 0) or xnor_gemm_bn_sign() (fused = 1) launches
// for these sizes (common.cuh: launch_query).
extern "C" int xnor_gemm_query(int M, int N, int Kw, int route, int vec16,
                               int fused, int* out, const char** name) {
  return fused ? query<true>(M, N, Kw, route, vec16, out, name)
               : query<false>(M, N, Kw, route, vec16, out, name);
}
