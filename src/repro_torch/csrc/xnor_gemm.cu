// K4 xnor_gemm: packed binary GEMM, int32 or fused BN-sign epilogue.
//
// Replaces: src/repro/kernels/binary_matmul.py:_gemm_kernel and
//           _gemv_kernel (pallas_calls in binary_matmul_packed), and
//           _gemm_bn_sign_kernel and _gemv_bn_sign_kernel (pallas_calls in
//           binary_matmul_bn_sign_packed).  The TPU's GEMV/GEMM split is a
//           TPU tiling choice; one kernel serves every M here.
// Computes: a (M, Kw) words, b (N, Kw) words ->
//             int32 epilogue: out (M, N) int32 = k_true - 2*popc(a ^ b);
//             fused epilogue: out (M, ceil(N/32)) words, thresholded against
//               tau/flip (N,) f32 and ballot-packed along N as in K2.
// Bound on the H100: bytes at small M (each weight word is used once per
//           row of A, so one request reads the whole weight matrix for
//           M*N*Kw word operations), operations at large M.
// Design:   one warp per row of A and 32 output columns, lane = column.
//           The A word is a broadcast load; each lane walks its own B row,
//           which L1/L2 keep for the next rows of A.  The epilogue is a
//           compile-time switch, so the fused variant never writes the
//           int32 tile.
#include "common.cuh"

using namespace repro;

template <bool kFused>
__global__ void xnor_gemm_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 const float* __restrict__ tau,
                                 const float* __restrict__ flip,
                                 void* __restrict__ out, int M, int N, int Kw,
                                 int k_true) {
  const int groups = (N + kWarp - 1) / kWarp;
  const long long warp = global_warp();
  if (warp >= static_cast<long long>(M) * groups) return;  // uniform
  const int g = static_cast<int>(warp % groups);
  const long long m = warp / groups;
  const int n = g * kWarp + lane_id();
  const bool valid = n < N;
  int32_t y = 0;
  if (valid) {
    const uint32_t* arow = a + m * Kw;
    const uint32_t* brow = b + static_cast<long long>(n) * Kw;
    int mism = 0;
    for (int k = 0; k < Kw; ++k) mism += __popc(arow[k] ^ brow[k]);
    y = k_true - 2 * mism;
  }
  if constexpr (kFused) {
    const uint32_t bits = bn_sign_ballot(y, valid, tau, flip, n);
    if (lane_id() == 0) static_cast<uint32_t*>(out)[m * groups + g] = bits;
  } else {
    if (valid) static_cast<int32_t*>(out)[m * N + n] = y;
  }
}

template <bool kFused>
static int launch(const void* a, const void* b, const void* tau,
                  const void* flip, void* out, int M, int N, int Kw,
                  int k_true, void* stream) {
  const long long warps =
      static_cast<long long>(M) * ((N + kWarp - 1) / kWarp);
  if (warps > 0) {
    xnor_gemm_kernel<kFused><<<blocks_for_warps(warps), kBlockThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const float*>(tau), static_cast<const float*>(flip), out,
        M, N, Kw, k_true);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xnor_gemm(const void* a, const void* b, void* out, int M,
                         int N, int Kw, int k_true, void* stream) {
  return launch<false>(a, b, nullptr, nullptr, out, M, N, Kw, k_true, stream);
}

extern "C" int xnor_gemm_bn_sign(const void* a, const void* b,
                                 const void* tau, const void* flip, void* out,
                                 int M, int N, int Kw, int k_true,
                                 void* stream) {
  return launch<true>(a, b, tau, flip, out, M, N, Kw, k_true, stream);
}
