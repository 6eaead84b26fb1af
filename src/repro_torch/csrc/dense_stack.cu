// K6 dense_stack: the whole hidden dense stack in one launch.
//
// Replaces: src/repro/kernels/binary_matmul.py:169 _dense_stack_kernel
//           (pallas_call at :474 in binary_dense_stack_packed).
// Computes: x (M, Kw_0) words; per stage s: w_s (N_s, Kw_s) words, tau_s /
//           flip_s (N_s,) f32, k_true_s ->
//             h_{s+1} = pack((f32(k_true_s - 2*popc(h_s ^ w_s)) >= tau_s)
//                            == (flip_s > 0)),
//           chained, with Kw_{s+1} = ceil(N_s/32); out = h_S, (M,
//           ceil(N_{S-1}/32)) words.  Ragged N_s packs zero tails, with no
//           128-lane padding.
// Bound on the H100: the weights' bytes at small M (every stage reads its
//           whole weight matrix), the 1-bit MMA's operations at large M.
//           What holds the kernel back is latency: how many weight bytes
//           and MMAs each SM keeps in flight, and the fixed cost of a
//           cluster launch and its barriers.
// Design:   what the Pallas body keeps out of device memory is the packed
//           activation between stages.  Here it stays in the shared memory
//           of a thread-block cluster:
//   * A cluster of C blocks owns an M tile of R rows (R = 16 or 32, C = 8
//     or 16, the tile rule binary_matmul.stack_tile by M and by how many
//     clusters fit the card at once).  Each block computes a contiguous
//     range of every stage's output words (32 channels each), so it reads
//     only its slice of the weights: each weight word is read once per
//     cluster, not once per block, and the stack streams through C SMs.
//   * The slice streams through a kRing-deep cp.async ring of 256-channel
//     x 32-word tiles (16-byte copies where x's and every stage's rows
//     start on 16 bytes), walked as one sequence over all stages, so the
//     next stage's weights load while this stage finishes and waits at its
//     barrier.  A tile's last chunk also brings its tau and flip, so no
//     epilogue waits on device memory; the tile's input rows come with the
//     first chunk.
//   * Eight warps, each owning one 32-channel output word of a tile.  A
//     stage contracts on mma.sync.m16n8k256.b1.and.popc with K4's fragment
//     layout, as popc(a ^ b) = popc(a & ~b) + popc(~a & b): two AND MMAs a
//     step into two accumulators, no population counts (the .xor.popc
//     MMA, exact on sm_90a, ran this kernel slower on the H100 and
//     spilled).  A lane's 16-byte
//     loads (words 4t..4t+3 of a row) feed two k256 steps, A and B in the
//     same word order; row strides of 16 mod 32 words keep them on 32
//     banks.  A fragments come straight from the activation tile in shared
//     memory; its words past Kw_s up to a whole chunk are zero, as are the
//     zero-filled weight words, so they add nothing.
//   * The epilogue thresholds a word as store_fused does, (f32(y) >= tau)
//     == (flip > 0), bit i = channel 32 w + i.  The four lanes that hold a
//     row's word write it into the next activation buffer of every block of
//     the cluster through distributed shared memory (map_shared_rank); the
//     last stage writes rows < M of ``out`` in global memory instead.
//   * Two activation buffers per block and one cluster barrier per stage
//     (arrive.release + wait.acquire): it orders the remote writes before
//     the next stage reads them, and no peer still reads the buffer that
//     the next stage overwrites.  The last stage's barrier is also the one
//     before exit, so no block's shared memory goes while a peer may still
//     write it.  The cluster's first barrier (all blocks started) is split:
//     arrived at once, waited on before the first remote write.
//   * Ragged stages (N_s not C ranges of whole words) leave the last blocks
//     fewer words or none; such a block still reaches every barrier.  Rows
//     past M are computed on zero input and never stored.
//   * The stage table (pointers and sizes) goes in by value as a
//     __grid_constant__ kernel parameter, so a launch copies nothing to the
//     card first.
#include <cooperative_groups.h>

#include "b1_mma.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kMaxStages = 16;     // binary_matmul.STACK_MAX_STAGES
constexpr int kStackWarps = 8;
constexpr int kStackThreads = kStackWarps * kWarp;
constexpr int kTileN = kStackWarps * kWarp;   // channels of a weight tile
constexpr int kRing = 3;                      // weight tiles in the ring
constexpr int kLdw = kBK + 16;   // ring row stride: 16 mod 32 words
// A ring slot: a kTileN x kBK weight tile, then the tile's tau and flip
// (filled with the tile's last chunk).
constexpr int kSlot = kTileN * kLdw + 2 * kTileN;
constexpr int kMaxCluster = 16;
constexpr size_t kRingBytes =
    static_cast<size_t>(kRing) * kSlot * sizeof(uint32_t);
constexpr size_t kMaxSmem = 232448;           // an H100 block's limit

struct StackStages {
  const uint32_t* w[kMaxStages];
  const float* tau[kMaxStages];
  const float* flip[kMaxStages];
  int n[kMaxStages];
  int kw[kMaxStages];
  int k_true[kMaxStages];
};

// The output words [w0, w1) of stage s that block ``rank`` of a cluster of
// ``c`` blocks computes.
struct Words {
  int w0, w1;
};

__device__ __forceinline__ Words block_words(int n, int c, int rank) {
  const int nw = (n + kWarp - 1) / kWarp;
  const int per = (nw + c - 1) / c;
  const int w0 = min(rank * per, nw);
  return {w0, min(w0 + per, nw)};
}

__device__ __forceinline__ int tiles_of(const Words& w) {
  return (w.w1 - w.w0 + kStackWarps - 1) / kStackWarps;
}

__device__ __forceinline__ int round32(int words) {
  return (words + kBK - 1) & ~(kBK - 1);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The weight tiles of the block's slices, in the order the stages use
// them: stage s, kTileN-channel tile nt, 32-word chunk kt.
struct TileWalk {
  int s, nt, kt;

  __device__ __forceinline__ void settle(const StackStages& st, int stages,
                                         int c, int rank) {
    while (s < stages && nt >= tiles_of(block_words(st.n[s], c, rank))) {
      ++s;
      nt = 0;
    }
  }

  __device__ __forceinline__ void next(const StackStages& st, int stages,
                                       int c, int rank) {
    if (++kt * kBK >= st.kw[s]) {
      kt = 0;
      ++nt;
      settle(st, stages, c, rank);
    }
  }
};

// One 32-word chunk of a warp's (16 kWM) x 32 tile: A rows 0.. of the
// activation tile ``as`` (row stride lds) from word ka, B rows wn.. of the
// weight tile ``bs``.  A lane loads words 4t..4t+3 of each 16-word group
// of its rows (one 16-byte load): two k256 steps, the first taking words
// 4t and 4t+1 as its slots t and t+4, the second 4t+2 and 4t+3; A and B
// agree on that order, so each step still pairs equal words.
// popc(a ^ b) = popc(a & ~b) + popc(~a & b): two AND MMAs a step, into
// separate accumulators, and no population counts.
template <int kWM>
__device__ __forceinline__ void stack_chunk(const uint32_t* as, int lds,
                                            const uint32_t* bs, int wn,
                                            int g, int t, int ka,
                                            int32_t (&ax)[kWM][4][4],
                                            int32_t (&ay)[kWM][4][4]) {
#pragma unroll
  for (int q = 0; q < kBK; q += 16) {
    uint4 a[kWM][2];
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[i][h] = *reinterpret_cast<const uint4*>(
            as + (i * 16 + g + 8 * h) * lds + ka + q + 4 * t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 b = *reinterpret_cast<const uint4*>(
          bs + (wn + j * 8 + g) * kLdw + q + 4 * t);
#pragma unroll
      for (int step = 0; step < 2; ++step) {
        const uint32_t b0 = step ? b.z : b.x;
        const uint32_t b1 = step ? b.w : b.y;
#pragma unroll
        for (int i = 0; i < kWM; ++i) {
          const uint32_t af[4] = {step ? a[i][0].z : a[i][0].x,
                                  step ? a[i][1].z : a[i][1].x,
                                  step ? a[i][0].w : a[i][0].y,
                                  step ? a[i][1].w : a[i][1].y};
          const uint32_t nf[4] = {~af[0], ~af[1], ~af[2], ~af[3]};
          mma_b1(ax[i][j], af, ~b0, ~b1);
          mma_b1(ay[i][j], nf, b0, b1);
        }
      }
    }
  }
}

// The fused BN-sign bits of rows g + 8h (+16 i) of a warp's 32-channel
// word, from y = k_true - 2 popc(a ^ b) and the word's thresholds (tv, fv:
// channels j*8 + 2t + e): every lane of a 4-lane group ends with its rows'
// words.
template <int kWM>
__device__ __forceinline__ void word_bits(const int32_t (&ax)[kWM][4][4],
                                          const int32_t (&ay)[kWM][4][4],
                                          int k_true, const float (&tv)[8],
                                          const float (&fv)[8], int N,
                                          int word, int t,
                                          uint32_t (&bits)[kWM][2]) {
#pragma unroll
  for (int i = 0; i < kWM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * t + e;
          const int32_t y =
              k_true - 2 * (ax[i][j][2 * h + e] + ay[i][j][2 * h + e]);
          const bool bit = word * kWarp + col < N &&
                           ((static_cast<float>(y) >= tv[2 * j + e]) ==
                            (fv[2 * j + e] > 0.f));
          b |= static_cast<uint32_t>(bit) << col;
        }
      b |= __shfl_xor_sync(0xffffffffu, b, 1);
      b |= __shfl_xor_sync(0xffffffffu, b, 2);
      bits[i][h] = b;
    }
}

template <int kWM, bool kVec16>
__global__ void __launch_bounds__(kStackThreads)
    dense_stack_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out, int M, int Kw0, int lds,
                       int n_stages, const __grid_constant__ StackStages st) {
  constexpr int kRows = 16 * kWM;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                       // [kRing][kSlot]
  uint32_t* bufs = smem + kRing * kSlot;       // [2][kRows][lds]
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long m0 = static_cast<long long>(blockIdx.x / c) * kRows;
  const int warp = threadIdx.x / kWarp;
  const int lane = lane_id();
  const int g = lane >> 2;
  const int t = lane & 3;

  // The tile's input rows, zero past M and past Kw_0 up to a whole chunk,
  // copied with the first weight tile's group.
  const int kpad0 = round32(Kw0);
  if constexpr (kVec16) {
    for (int i = threadIdx.x; i < kRows * kpad0 / 4; i += kStackThreads) {
      const int r = i / (kpad0 / 4);
      const int k = 4 * (i % (kpad0 / 4));
      const bool in = m0 + r < M && k < Kw0;
      cp_async16(bufs + r * lds + k, in ? x + (m0 + r) * Kw0 + k : x,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kpad0; i += kStackThreads) {
      const int r = i / kpad0;
      const int k = i % kpad0;
      const bool in = m0 + r < M && k < Kw0;
      cp_async4(bufs + r * lds + k, in ? x + (m0 + r) * Kw0 + k : x,
                in ? 4 : 0);
    }
  }
  cluster_arrive_relaxed();      // this block has started
  bool joined = false;           // warp-uniform: waited for the peers

  TileWalk load{0, 0, 0};
  load.settle(st, n_stages, c, rank);
  const auto issue = [&](int slot) {
    const Words w = block_words(st.n[load.s], c, rank);
    const int n_end = min(st.n[load.s], w.w1 * kWarp);
    const int n0 = w.w0 * kWarp + load.nt * kTileN;
    uint32_t* dst = ring + slot * kSlot;
    load_tile<kTileN, kStackThreads, kVec16, kLdw>(
        dst, st.w[load.s], n_end, st.kw[load.s], n0, load.kt * kBK);
    if ((load.kt + 1) * kBK >= st.kw[load.s]) {   // the tile's last chunk
      const int n = n0 + threadIdx.x;   // one thread per channel
      const bool in = n < n_end;
      uint32_t* side = dst + kTileN * kLdw;
      cp_async4(side + threadIdx.x, st.tau[load.s] + (in ? n : 0),
                in ? 4 : 0);
      cp_async4(side + kTileN + threadIdx.x, st.flip[load.s] + (in ? n : 0),
                in ? 4 : 0);
    }
    load.next(st, n_stages, c, rank);
  };
  static_assert(kTileN == kStackThreads, "one thread per channel of a tile");
#pragma unroll
  for (int j = 0; j < kRing - 1; ++j) {
    if (load.s < n_stages) issue(j);
    cp_async_commit();
  }

  int item = 0;   // weight tiles consumed
  for (int s = 0; s < n_stages; ++s) {
    const uint32_t* cur = bufs + (s & 1) * kRows * lds;
    uint32_t* nxt = bufs + ((s + 1) & 1) * kRows * lds;
    const bool last = s == n_stages - 1;
    const int N = st.n[s];
    const int Kw = st.kw[s];
    const int nw = (N + kWarp - 1) / kWarp;
    if (!last) {   // the next stage reads whole 32-word chunks: zero the tail
      const int pad = round32(nw) - nw;
      for (int i = threadIdx.x; i < kRows * pad; i += kStackThreads)
        nxt[(i / pad) * lds + nw + i % pad] = 0u;
    }
    const Words w = block_words(N, c, rank);
    const int tiles = tiles_of(w);
    for (int nt = 0; nt < tiles; ++nt) {
      const int word = w.w0 + nt * kStackWarps + warp;
      const bool mine = word < w.w1;   // warp-uniform
      int32_t ax[kWM][4][4] = {};
      int32_t ay[kWM][4][4] = {};
      for (int k0 = 0; k0 < Kw; k0 += kBK) {
        cp_async_wait<kRing - 2>();
        __syncthreads();   // tile ``item`` landed; its predecessor's slot
                           // is free again
        if (load.s < n_stages) issue((item + kRing - 1) % kRing);
        cp_async_commit();
        if (mine)
          stack_chunk<kWM>(cur, lds, ring + (item % kRing) * kSlot,
                           warp * kWarp, g, t, k0, ax, ay);
        ++item;
      }
      if (!mine) continue;
      // The tile's thresholds came with its last chunk, whose slot is not
      // refilled before the next barrier.
      const float* side = reinterpret_cast<const float*>(
          ring + ((item - 1) % kRing) * kSlot + kTileN * kLdw);
      float tv[8], fv[8];              // this lane's channels' thresholds
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = warp * kWarp + j * 8 + 2 * t + e;
          tv[2 * j + e] = side[col];
          fv[2 * j + e] = side[kTileN + col];
        }
      uint32_t bits[kWM][2];
      word_bits(ax, ay, st.k_true[s], tv, fv, N, word, t, bits);
      if (last) {
        if (t == 0) {
#pragma unroll
          for (int i = 0; i < kWM; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long m = m0 + i * 16 + g + 8 * h;
              if (m < M) out[m * nw + word] = bits[i][h];
            }
        }
        continue;
      }
      if (!joined) {
        cluster_wait();   // every peer has started: its buffers exist
        joined = true;
      }
      for (int r = t; r < c; r += 4) {   // the group's 4 lanes split the peers
        uint32_t* peer = cluster.map_shared_rank(nxt, r);
#pragma unroll
        for (int i = 0; i < kWM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            peer[(i * 16 + g + 8 * h) * lds + word] = bits[i][h];
      }
    }
    if (!joined) {
      cluster_wait();
      joined = true;
    }
    cluster.sync();   // stage s is in every block; its input buffer is free
  }
  cp_async_wait<0>();
}

// The kernel of one (R, copy width), its dynamic shared-memory limit and
// the non-portable cluster sizes lifted once per device.
template <int kWM, bool kVec16>
cudaError_t prepare(int* dev) {
  constexpr int kDevices = 64;
  static std::atomic<unsigned long long> opted_in{0};   // bit d: device d
  const auto kernel = dense_stack_kernel<kWM, kVec16>;
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev >= kDevices) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << *dev;
  if (opted_in.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  opted_in.fetch_or(bit, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int kWM>
cudaLaunchConfig_t stack_config(int M, int c, size_t smem, cudaStream_t st,
                                cudaLaunchAttribute* attr) {
  constexpr int kRows = 16 * kWM;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(c);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>((M + kRows - 1) / kRows) * c);
  cfg.blockDim = dim3(kStackThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of ``c`` blocks of this kernel fit the card at once.
template <int kWM>
cudaError_t clusters_that_fit(int c, size_t smem, int* n) {
  int dev = 0;
  cudaError_t e = prepare<kWM, true>(&dev);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = stack_config<kWM>(1, c, smem, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(n, dense_stack_kernel<kWM, true>,
                                        &cfg);
}

// Launches the kernel of one (R, copy width); refuses a (cluster size,
// shared memory) of which no cluster fits the card, checked once per
// device for the largest shared memory seen to fit.
template <int kWM, bool kVec16>
cudaError_t launch_stack(const uint32_t* x, uint32_t* out, int M, int Kw0,
                         int lds, int n_stages, const StackStages& st,
                         int c, size_t smem, cudaStream_t stream) {
  static std::atomic<size_t> fits[64][kMaxCluster + 1];
  int dev = 0;
  cudaError_t e = prepare<kWM, kVec16>(&dev);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = stack_config<kWM>(M, c, smem, stream, attr);
  if (fits[dev][c].load(std::memory_order_relaxed) < smem) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters,
                                       dense_stack_kernel<kWM, kVec16>, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    fits[dev][c].store(smem, std::memory_order_relaxed);
  }
  e = cudaLaunchKernelEx(&cfg, dense_stack_kernel<kWM, kVec16>, x, out, M,
                         Kw0, lds, n_stages, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

size_t stack_smem(int rows, int lds) {
  return kRingBytes + 2ull * rows * lds * sizeof(uint32_t);
}

}  // namespace

// ``ptrs``: host array of 3*n_stages pointers (w_0.., tau_0.., flip_0..);
// ``dims``: host array of 3*n_stages ints (N_0.., Kw_0.., k_true_0..).
// ``rows`` (16 or 32) and ``cluster`` (1..16) are the tile
// (binary_matmul.stack_tile), ``lds`` the activation row stride in words
// (16 mod 32, at least the widest activation rounded up to 32 words),
// ``vec16`` whether every stage's weight rows start on 16 bytes.  The
// wrapper checks Kw_0 == the input's width and Kw_s == ceil(N_{s-1}/32).
extern "C" int dense_stack(const void* x, void* out, const void* ptrs,
                           const void* dims, int n_stages, int M, int Kw0,
                           int rows, int cluster, int lds, int vec16,
                           void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || (rows != 16 && rows != 32) ||
      cluster < 1 || cluster > kMaxCluster || lds % 32 != 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StackStages st{};
  const auto* p = static_cast<const unsigned long long*>(ptrs);
  const auto* d = static_cast<const int*>(dims);
  int widest = Kw0;
  for (int s = 0; s < n_stages; ++s) {
    st.w[s] = reinterpret_cast<const uint32_t*>(p[s]);
    st.tau[s] = reinterpret_cast<const float*>(p[n_stages + s]);
    st.flip[s] = reinterpret_cast<const float*>(p[2 * n_stages + s]);
    st.n[s] = d[s];
    st.kw[s] = d[n_stages + s];
    st.k_true[s] = d[2 * n_stages + s];
    if (st.n[s] < 1 || st.kw[s] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    widest = max(widest, (st.n[s] + kWarp - 1) / kWarp);
  }
  if (lds < ((widest + kBK - 1) & ~(kBK - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stack_smem(rows, lds);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  const auto* xw = static_cast<const uint32_t*>(x);
  auto* ow = static_cast<uint32_t*>(out);
  auto sm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows == 16)
    err = vec16 ? launch_stack<1, true>(xw, ow, M, Kw0, lds, n_stages, st,
                                        cluster, smem, sm)
                : launch_stack<1, false>(xw, ow, M, Kw0, lds, n_stages, st,
                                         cluster, smem, sm);
  else
    err = vec16 ? launch_stack<2, true>(xw, ow, M, Kw0, lds, n_stages, st,
                                        cluster, smem, sm)
                : launch_stack<2, false>(xw, ow, M, Kw0, lds, n_stages, st,
                                         cluster, smem, sm);
  return static_cast<int>(err);
}

// *n = how many clusters of ``cluster`` blocks fit the card at once with
// ``rows``-row tiles and activation row stride ``lds`` (the input of
// binary_matmul.stack_tile).
extern "C" int dense_stack_clusters(int rows, int cluster, int lds,
                                    void* n) {
  if ((rows != 16 && rows != 32) || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stack_smem(rows, lds);
  if (smem > kMaxSmem) {
    *static_cast<int*>(n) = 0;
    return static_cast<int>(cudaSuccess);
  }
  return static_cast<int>(
      rows == 16 ? clusters_that_fit<1>(cluster, smem, static_cast<int*>(n))
                 : clusters_that_fit<2>(cluster, smem, static_cast<int*>(n)));
}

// What dense_stack() launches for M rows in (rows, cluster) tiles at row
// stride lds (common.cuh: launch_query); the cluster's dimensions are
// (cluster, 1, 1).
extern "C" int dense_stack_query(int M, int rows, int cluster, int lds,
                                 int vec16, int* out, const char** name) {
  if (rows != 16 && rows != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>((M + rows - 1) / rows) * cluster);
  const size_t smem = stack_smem(rows, lds);
  if (rows == 16)
    return vec16 ? launch_query(dense_stack_kernel<1, true>, grid,
                                dim3(kStackThreads), smem, out, name)
                 : launch_query(dense_stack_kernel<1, false>, grid,
                                dim3(kStackThreads), smem, out, name);
  return vec16 ? launch_query(dense_stack_kernel<2, true>, grid,
                              dim3(kStackThreads), smem, out, name)
               : launch_query(dense_stack_kernel<2, false>, grid,
                              dim3(kStackThreads), smem, out, name);
}
