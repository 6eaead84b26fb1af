// The 1-bit tensor-core main loop shared by K4 (xnor_gemm.cu) and K3/K7
// (conv_bn_sign.cu).
//
// Both contract rows of packed words against weight rows of packed words,
// y = k_true - 2 popc(a ^ b), on mma.sync.m16n8k256.b1.and.popc:
//   * A block of 4 warps (2 x 2) owns a (32 kWM) x (16 kWN) output tile;
//     tiles of kBK packed words per row of A and B go through a ring of
//     kRing shared-memory stages filled by cp.async (b1_main_loop; K4's
//     ring is kStages deep, K3/K7's two), row stride kLds words (16-byte
//     rows, no bank conflicts for 8 rows x 1 word).  The kernels differ
//     only in how they stage the A tile: K4 copies rows of A (load_tile),
//     K3/K7 the im2col of their output pixels.
//   * The packed words are the fragments: one k256 step takes 8 words per
//     row, a thread words t and t+4 of rows g and g+8 (t = lane % 4,
//     g = lane / 4).  It sums popc(a & b); the same loads give each thread
//     a share of popc(a) and popc(b), and b1_finish turns them into
//     y = k_true - 2 (popc(a) + popc(b) - 2 popc(a & b)).  Words that the
//     copies zero-fill add nothing, and no step runs past Kw.
//   * Two epilogues: store_int32 (two adjacent columns per thread, full
//     32-byte sectors) and store_fused (each column thresholded against
//     tau/flip, a row's 32-column group ORed across the 4 threads that
//     hold it, one word written, bit i = column 32 w + i as
//     bn_sign_ballot packs it).
//   * launch_b1 launches either kernel; it lifts the kernel's dynamic
//     shared-memory limit once per device, not on every launch.
#pragma once

#include <atomic>

#include "common.cuh"

namespace repro {

constexpr int kBK = 32;          // packed words per row per stage
constexpr int kStages = 3;       // K4's ring depth
constexpr int kLds = kBK + 4;    // shared-memory row stride in words
constexpr int kMmaThreads = 128; // 2 x 2 warps

// A thread's place in the block tile: g = lane / 4 and t = lane % 4 in its
// fragments, and the first row wm and column wn of its warp's tile.
struct WarpPos {
  int g, t, wm, wn;
};

template <int kWM, int kWN>
__device__ __forceinline__ WarpPos warp_pos() {
  const int lane = lane_id();
  const int warp = threadIdx.x / kWarp;
  return {lane >> 2, lane & 3, (warp >> 1) * 16 * kWM, (warp & 1) * 8 * kWN};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; src_bytes = 0 writes zeros without reading.
// The .cg copy bypasses L1 (streamed operands), the .ca ones keep the
// line in L1 (operands that neighbouring copies read again).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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
// word matrix into dst[kRows][kStride], zero-filling outside it.  kVec16
// needs Kw % 4 == 0 and a 16-byte aligned matrix.
template <int kRows, int kThreads, bool kVec16, int kStride = kLds>
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
      cp_async16(dst + r * kStride + (i % kPerRow) * 4, s, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kBK; i += kThreads) {
      const int r = i / kBK;
      const int k = k0 + i % kBK;
      const bool in = row0 + r < rows && k < Kw;
      const uint32_t* s =
          in ? src + static_cast<long long>(row0 + r) * Kw + k : src;
      cp_async4(dst + r * kStride + i % kBK, s, in ? 4 : 0);
    }
  }
}

template <int kWM, int kWN, int kRing>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kRing) * (2 * 16 * kWM + 2 * 8 * kWN) * kLds *
         4;
}

// One k256 step of a warp's (16 kWM) x (8 kWN) tile at word k8 of the
// staged tiles ``as`` (rows wm..) and ``bs`` (rows wn..).
template <int kWM, int kWN>
__device__ __forceinline__ void b1_warp_step(const uint32_t* as,
                                             const uint32_t* bs, int wm,
                                             int wn, int g, int t, int k8,
                                             int32_t (&acc)[kWM][kWN][4],
                                             int (&pa)[kWM][2],
                                             int (&pb)[kWN]) {
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

template <int kWM, int kWN>
__device__ __forceinline__ void b1_zero(int32_t (&acc)[kWM][kWN][4],
                                        int (&pa)[kWM][2], int (&pb)[kWN]) {
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
}

// acc (popc(a & b)) becomes y = k_true - 2 popc(a ^ b).  The four threads
// of a group hold the 8 words of each k256 step between them, so two
// shuffles finish each row's popcount; column 2t + e's popc(b) sits with
// the lanes of group 2t + e.
template <int kWM, int kWN>
__device__ __forceinline__ void b1_finish(int32_t (&acc)[kWM][kWN][4],
                                          int (&pa)[kWM][2], int (&pb)[kWN],
                                          int k_true, int t) {
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
}

// The main loop of a block's (32 kWM) x (16 kWN) tile.  Depth chunks of
// kBK words go through a kRing-deep cp.async ring in ``smem``
// ([kRing][32 kWM][kLds] for A, then [kRing][16 kWN][kLds] for B):
// load_a(dst, k0) stages A's chunk, B's is rows n0.. of the (N, Kw) words
// b.  Each landed chunk runs its k256 steps below Kw.  Leaves
// y = k_true - 2 popc(a ^ b) in acc.
template <int kWM, int kWN, int kRing, bool kVec16, class LoadA>
__device__ __forceinline__ void b1_main_loop(
    uint32_t* smem, LoadA load_a, const uint32_t* __restrict__ b, int N,
    int n0, int Kw, int k_true, const WarpPos& p,
    int32_t (&acc)[kWM][kWN][4]) {
  constexpr int kBM = 2 * 16 * kWM;
  constexpr int kBN = 2 * 8 * kWN;
  uint32_t* As = smem;
  uint32_t* Bs = smem + kRing * kBM * kLds;
  const int kt_count = (Kw + kBK - 1) / kBK;
  const auto stage = [&](int slot, int kt) {
    load_a(As + slot * kBM * kLds, kt * kBK);
    load_tile<kBN, kMmaThreads, kVec16>(Bs + slot * kBN * kLds, b, N, Kw,
                                        n0, kt * kBK);
  };
  int pa[kWM][2];   // this thread's share of popc(a row)
  int pb[kWN];      // and of popc(b row)
  b1_zero(acc, pa, pb);

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < kt_count) stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // chunk kt landed; the slot of kt-1 is free again
    const int next = kt + kRing - 1;
    if (next < kt_count) stage(next % kRing, next);
    cp_async_commit();
    const uint32_t* as = As + (kt % kRing) * kBM * kLds;
    const uint32_t* bs = Bs + (kt % kRing) * kBN * kLds;
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8)   // one k256 step, up to Kw
      if (kt * kBK + k8 < Kw)
        b1_warp_step(as, bs, p.wm, p.wn, p.g, p.t, k8, acc, pa, pb);
  }
  cp_async_wait<0>();
  b1_finish(acc, pa, pb, k_true, p.t);
}

// Launches kKernel on ``grid`` blocks of kMmaThreads with kSmem bytes of
// dynamic shared memory.  Above 48 KB a kernel takes that only after
// cudaFuncSetAttribute, which this makes once per kernel and device.
template <auto kKernel, size_t kSmem, class... Args>
cudaError_t launch_b1(dim3 grid, cudaStream_t st, Args... args) {
  static std::atomic<unsigned long long> opted_in{0};   // bit d: device d
  const auto kernel = kKernel;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted_in.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
    if (e != cudaSuccess) return e;
    opted_in.fetch_or(bit, std::memory_order_relaxed);
  }
  kernel<<<grid, kMmaThreads, kSmem, st>>>(args...);
  return cudaGetLastError();
}

// Fused epilogue of a warp tile whose first row is mw and first column nw
// (a multiple of 32): out (M, ceil(N/32)) words.
template <int kWM, int kWN>
__device__ __forceinline__ void store_fused(int32_t (&acc)[kWM][kWN][4],
                                            const float* __restrict__ tau,
                                            const float* __restrict__ flip,
                                            uint32_t* __restrict__ o, int M,
                                            int N, int mw, int nw, int g,
                                            int t) {
  static_assert(kWN % 4 == 0, "a warp's columns cover whole 32-col words");
  const int groups = (N + kWarp - 1) / kWarp;
#pragma unroll
  for (int q = 0; q < kWN / 4; ++q) {   // one 32-column word per q
    float tv[8], fv[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nw + (4 * q + jj) * 8 + 2 * t + e;
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
                nw + col < N &&
                ((static_cast<float>(acc[i][4 * q + jj][2 * h + e]) >=
                  tv[jj * 2 + e]) == (fv[jj * 2 + e] > 0.f));
            bits |= static_cast<uint32_t>(bit) << (col % 32);
          }
        bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
        bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
        const int m = mw + i * 16 + g + 8 * h;
        const int word = nw / kWarp + q;
        if (t == 0 && m < M && word < groups)
          o[static_cast<long long>(m) * groups + word] = bits;
      }
  }
}

// int32 epilogue of a warp tile: out (M, N) int32.
template <int kWM, int kWN>
__device__ __forceinline__ void store_int32(int32_t (&acc)[kWM][kWN][4],
                                            int32_t* __restrict__ o, int M,
                                            int N, int mw, int nw, int g,
                                            int t) {
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int i = 0; i < kWM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mw + i * 16 + g + 8 * h;
      if (m >= M) continue;
      int32_t* orow = o + static_cast<long long>(m) * N;
#pragma unroll
      for (int j = 0; j < kWN; ++j) {
        const int n = nw + j * 8 + 2 * t;
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

}  // namespace repro
