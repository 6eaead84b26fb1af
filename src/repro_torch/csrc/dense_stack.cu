// K6 dense_stack: the whole hidden dense stack in one launch.
//
// Replaces: src/repro/kernels/binary_matmul.py:_dense_stack_kernel
//           (pallas_call in binary_dense_stack_packed).
// Computes: x (M, Kw_0) words; per stage s: w_s (N_s, Kw_s) words, tau_s /
//           flip_s (N_s,) f32, k_true_s ->
//             h_{s+1} = pack((f32(k_true_s - 2*popc(h_s ^ w_s)) >= tau_s)
//                            == (flip_s > 0)),
//           chained, with Kw_{s+1} = ceil(N_s/32); out = h_S, (M,
//           ceil(N_{S-1}/32)) words.  Ragged N_s packs zero tails, with no
//           128-lane padding.
// Bound on the H100: at small M, the bytes of the weights (each weight
//           word is used once per row); at large M, operations (POPC).
// Design:   one block per tile of up to 8 rows of M (the wrapper picks
//           ceil(M / SMs) rows, so a large M fills the card).  The tile's
//           packed activation lives in shared memory in two buffers; it
//           never leaves the SM between stages.  In stage s each warp
//           takes 32-channel groups, lane = channel: the lane reads its
//           weight row once (through L2, where the whole stack stays hot
//           across tiles) and contracts every word of it against all rows
//           of the tile (broadcast reads from shared memory), so a weight
//           word is fetched once per tile, not once per row.  The fused
//           BN-sign epilogue (common.cuh) packs each row's 32 bits with one
//           ballot into the other buffer; __syncthreads() ends the stage
//           and the buffers swap.  The last stage writes to global memory.
//           The stage table (pointers and sizes) goes in by value as a
//           __grid_constant__ kernel parameter, so a launch copies nothing
//           to the card first.  At batch 1 the stack runs on one SM and
//           streams every weight through it: bound by one SM's share of
//           L2 bandwidth, not by the card.
#include "common.cuh"

using namespace repro;

constexpr int kMaxStages = 16;
constexpr int kMaxTileRows = 8;
constexpr int kStackThreads = 1024;
constexpr int kStackWarps = kStackThreads / kWarp;

struct StackStages {
  const uint32_t* w[kMaxStages];
  const float* tau[kMaxStages];
  const float* flip[kMaxStages];
  int n[kMaxStages];
  int kw[kMaxStages];
  int k_true[kMaxStages];
};

__global__ void __launch_bounds__(kStackThreads)
    dense_stack_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out, int M, int Kw0,
                       int tile_rows, int buf_words, int n_stages,
                       const __grid_constant__ StackStages st) {
  extern __shared__ uint32_t smem[];
  uint32_t* cur = smem;
  uint32_t* nxt = smem + tile_rows * buf_words;
  const long long m0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = M - m0 < tile_rows ? static_cast<int>(M - m0)
                                      : tile_rows;  // block-uniform
  for (int i = threadIdx.x; i < rows * Kw0; i += kStackThreads) {
    const int r = i / Kw0;
    const int k = i % Kw0;
    cur[r * buf_words + k] = x[(m0 + r) * Kw0 + k];
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  const int lane = lane_id();
  for (int s = 0; s < n_stages; ++s) {
    const int N = st.n[s];
    const int Kw = st.kw[s];
    const int groups = (N + kWarp - 1) / kWarp;
    const bool last = s == n_stages - 1;
    for (int g = warp; g < groups; g += kStackWarps) {  // warp-uniform
      const int n = g * kWarp + lane;
      const bool valid = n < N;
      int mism[kMaxTileRows];
#pragma unroll
      for (int r = 0; r < kMaxTileRows; ++r) mism[r] = 0;
      if (valid) {
        const uint32_t* wrow = st.w[s] + static_cast<long long>(n) * Kw;
        for (int k = 0; k < Kw; ++k) {
          const uint32_t wv = wrow[k];
#pragma unroll
          for (int r = 0; r < kMaxTileRows; ++r) {
            if (r < rows) mism[r] += __popc(cur[r * buf_words + k] ^ wv);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxTileRows; ++r) {
        if (r < rows) {  // every lane reaches the ballot
          const uint32_t bits =
              bn_sign_ballot(st.k_true[s] - 2 * mism[r], valid, st.tau[s],
                             st.flip[s], n);
          if (lane == 0) {
            if (last) {
              out[(m0 + r) * groups + g] = bits;
            } else {
              nxt[r * buf_words + g] = bits;
            }
          }
        }
      }
    }
    __syncthreads();  // reached by every thread, rows past M included
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ``ptrs``: host array of 3*n_stages pointers (w_0.., tau_0.., flip_0..);
// ``dims``: host array of 3*n_stages ints (N_0.., Kw_0.., k_true_0..).
// The wrapper checks Kw_0 == the input's width and Kw_s == ceil(N_{s-1}/32).
extern "C" int dense_stack(const void* x, void* out, const void* ptrs,
                           const void* dims, int n_stages, int M, int Kw0,
                           int tile_rows, int buf_words, void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || tile_rows < 1 ||
      tile_rows > kMaxTileRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StackStages st{};
  const auto* p = static_cast<const unsigned long long*>(ptrs);
  const auto* d = static_cast<const int*>(dims);
  for (int s = 0; s < n_stages; ++s) {
    st.w[s] = reinterpret_cast<const uint32_t*>(p[s]);
    st.tau[s] = reinterpret_cast<const float*>(p[n_stages + s]);
    st.flip[s] = reinterpret_cast<const float*>(p[2 * n_stages + s]);
    st.n[s] = d[s];
    st.kw[s] = d[n_stages + s];
    st.k_true[s] = d[2 * n_stages + s];
  }
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = 2ull * tile_rows * buf_words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks =
      static_cast<unsigned int>((M + tile_rows - 1) / tile_rows);
  dense_stack_kernel<<<blocks, kStackThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), M, Kw0,
      tile_rows, buf_words, n_stages, st);
  return static_cast<int>(cudaGetLastError());
}
