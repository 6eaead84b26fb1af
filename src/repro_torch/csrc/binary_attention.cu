// K8 binary_attention: flash-style binary attention on packed Q and K, on
// the H100's tensor cores.
//
// Replaces: src/repro/kernels/binary_attention.py:60 _attention_kernel
//           (pallas_call at :182, binary_attention_packed).
// Computes: q (B, Sq, Hq, Dw) words, k (B, Skv, Hkv, Dw) words, v (B, Skv,
//           Hkv, Dv) f32 -> out (B, Sq, Hq, Dv) f32, the softmax of the
//           scores s = (d_true - 2*popc(q ^ k)) * scale, soft-capped
//           (cap * tanh(s / cap)) and then masked, against v.  Query head h
//           reads KV head h / (Hq / Hkv).  A masked score (causal: qpos <
//           kpos; window: qpos - kpos >= window; qpos = q_offset + row) is
//           -1e30, as in the reference.  Keys past Skv take no part, so a
//           row with no unmasked key averages v uniformly over the Skv keys,
//           as the reference's exact-softmax oracle does.
// Bound on the H100: the P.V products, 2*Dv operations per computed (q, k)
//           pair, held to 2e-5 of fp32: on the CUDA cores (67 TFLOP/s) or as
//           three TF32 tensor-core products; the 1-bit scores (Dw/8 k256
//           steps per 8 keys and 16 rows) are a few percent beside them.
//           Bytes bind only when Skv is short.
// Design:   a block of 4 warps owns 64 query rows of one (batch, query head)
//           and at most 256 output dims (Dv > 256 takes a second block,
//           which scores again); each warp owns 16 rows.  Where Sq <= 16
//           (a served prompt, a decode step) a block owns 16 rows, and each
//           of its warps scores all 16 and takes a quarter of the dims, so
//           that the P.V chain of a warp is a quarter as long.  The TPU's
//           sequential KV grid dimension becomes a loop over tiles of 32
//           keys, whose K words and V rows go through a two-deep cp.async
//           ring in shared memory; a tile that none of a warp's rows can see
//           (wholly above the causal diagonal, or before the window) is
//           skipped by that warp, and by the block when no warp sees it.
//           Blocks walk the q tiles last to first, the heaviest causal tiles
//           first.
//   * Q.K^T: one mma.sync.m16n8k256.b1.and.popc per 8 keys and k256 step
//     (K4's b1_warp_step and b1_finish, csrc/b1_mma.cuh: Q rows are A, K
//     rows B, y = d_true - 2 (popc(q) + popc(k) - 2 popc(q & k)); words past
//     Dw are zero and add nothing).  Q stays in shared memory for the whole
//     walk.  Past 32 words (D > 1024) a row no longer fits the ring's row
//     stride, and the fragments are read from global memory instead.
//   * The scale, the tanhf softcap, the mask and the online softmax run in
//     registers on the score's C fragment (rows g and g+8, keys 2t and 2t+1
//     of each 8-key n-tile; g = lane / 4, t = lane % 4), each score's float
//     steps those of the Pallas body.  A score takes one of 32 Dw + 1
//     values (bits past D in a caller's words count as mismatches, as in
//     the Pallas body), so a block first computes the float score of every
//     mismatch count into a table in shared memory (by the same steps: bit
//     for bit what each score would give), and the walk reads it instead
//     of calling tanhf.  A tile in which no (row, key) of the warp is
//     masked skips the mask.  The row max (m) reduces across the 4 lanes of
//     a row by __shfl_xor_sync 1 and 2, and the accumulators are rescaled
//     only when some row's max moved; each lane keeps its own share of the
//     sum l, added up at the end.
//   * P.V: mma.sync.m16n8k8.tf32 in three passes, P_hi V_hi + P_hi V_lo +
//     P_lo V_hi, accumulated in fp32, with x_hi = x rounded to TF32 as
//     cvt.rna.tf32.f32 rounds (in integer operations) and x_lo = x - x_hi
//     truncated to TF32 (one TF32 pass keeps 11 bits, too few for 2e-5 on
//     a row with one unmasked key).  The fragment permutation: the
//     C fragment holds keys 2t and 2t+1 where the TF32 A fragment wants k
//     columns t and t+4, and a sum over keys does not depend on their
//     order, so k column t of each 8-key group is key 2t and column t + 4
//     key 2t + 1.  P feeds the A fragment from the registers it was scored
//     in, and the B fragment reads V rows 2t and 2t+1 at column g.  V's row
//     stride in shared memory is 8 NV + 4 words, 4 (mod 8), so those loads
//     hit 32 distinct banks.  V is split per fragment load, not once per
//     tile: a split tile would double V's 33 KB a stage, and two blocks
//     would no longer fit an SM.
//   expf and tanhf, not the fast intrinsics: the output is held to the
//   reference within 2e-5.
#include <cmath>

#include "b1_mma.cuh"

using namespace repro;

namespace {

constexpr int kThreads = kMmaThreads;      // 4 warps of 16 rows each
constexpr int kWarps = kThreads / kWarp;
constexpr int kKeys = 32;                  // keys per KV tile
constexpr int kGroups = kKeys / 8;         // 8-key n-tiles per KV tile
constexpr int kMaxNV = 32;                 // 8-dim n-tiles of V per block
constexpr int kMaxChunks = 2;              // Dv <= 2 * 256
constexpr float kNegInf = -1e30f;          // the reference's NEG_INF

struct AttnArgs {
  const uint32_t* q;
  const uint32_t* k;
  const float* v;
  float* out;
  int Sq, Skv, Hq, Hkv, Dw, Dv, d_true;
  float scale;    // d_true ** -0.5, rounded to f32 by the caller
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
  int q_offset;
  int chunks;     // blocks along Dv, 8 * NV dims each
  int qk16;       // Q and K rows copied 16 bytes at a time
  int v16;        // V rows copied 16 bytes at a time
};

// V rows of a stage hold 8 NV floats and 4 of padding: a stride of 4 (mod
// 8) words puts rows 2t and 2t+1, column g, on 32 distinct banks.
template <int NV>
__host__ __device__ constexpr int v_stride() {
  return 8 * NV + 4;
}

// Staged, Dw <= kBK: the float score of every mismatch count 0..32 Dw
// (32 Dw, not D: the count takes in any bits past D in the last word).
constexpr int kTable = 32 * kBK + 4;

// Dynamic shared memory: V [2][kKeys][v_stride], then (staged) K
// [2][kKeys][kLds] words, Q [kRows][kLds] words and the score table.
template <int NV, bool kStaged, int kRows>
__host__ __device__ constexpr size_t attn_smem_bytes() {
  return (static_cast<size_t>(2) * kKeys * v_stride<NV>() +
          (kStaged ? static_cast<size_t>(2 * kKeys + kRows) * kLds + kTable
                   : 0)) *
         4;
}

// The KV tiles [lo, hi] that query rows [r0, r1] can see.  A row with no
// unmasked key (window set and qpos >= Skv - 1 + window) averages every
// key, so rows that hold one see every tile.  Every tile starts below Skv.
__device__ __forceinline__ void tile_range(const AttnArgs& a, int r0, int r1,
                                           int& lo, int& hi) {
  const long long qmin = static_cast<long long>(a.q_offset) + r0;
  const long long qmax = static_cast<long long>(a.q_offset) + r1;
  lo = 0;
  hi = (a.Skv + kKeys - 1) / kKeys - 1;
  if (a.window <= 0 ||
      qmax < static_cast<long long>(a.Skv) - 1 + a.window) {
    if (a.causal && qmax / kKeys < hi) hi = static_cast<int>(qmax / kKeys);
    const long long first = qmin - a.window + 1;
    if (a.window > 0 && first > 0) lo = static_cast<int>(first / kKeys);
  }
}

// The float score of the integer score y = d_true - 2 mismatches, the
// Pallas body's steps: scale, then the softcap.
__device__ __forceinline__ float score_of(int y, const AttnArgs& a) {
  float x = static_cast<float>(y) * a.scale;
  if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
  return x;
}

// x = hi + lo in TF32: hi is x rounded to nearest, ties away from zero,
// the integer form of cvt.rna.tf32.f32 (two integer operations, where the
// cvt costs more); lo is the rest, exact in f32, with its 13 low bits
// cleared, so that both operands are TF32 values as the MMA's type asks.
// A NaN x may give hi = -0, but then lo is a NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
}

// c += a . b on the TF32 tensor cores, m16n8k8.  A: (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); B: (k t, col g), (k t+4, col g); C: (g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int w,
                                            int Dw) {
  return row != nullptr && w < Dw ? __ldg(row + w) : 0u;
}

// Rows [0, rows) x words [0, words) of a word matrix with row stride
// ``stride`` into dst[rows][kLds], zero past ``valid`` rows and past Dw.
__device__ __forceinline__ void stage_words(uint32_t* dst,
                                            const uint32_t* src,
                                            long long stride, int rows,
                                            int valid, int words, int Dw,
                                            bool vec16) {
  if (vec16) {   // Dw % 4 == 0 and 16-byte aligned rows
    const int per_row = words / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, w = (i % per_row) * 4;
      const bool in = r < valid && w < Dw;
      cp_async16(dst + r * kLds + w, in ? src + r * stride + w : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * words; i += kThreads) {
      const int r = i / words, w = i % words;
      const bool in = r < valid && w < Dw;
      cp_async4(dst + r * kLds + w, in ? src + r * stride + w : src,
                in ? 4 : 0);
    }
  }
}

// Keys [0, kKeys) x dims [0, 8 NV) of V rows with row stride ``stride``
// into dst[kKeys][v_stride], zero past ``valid`` keys and ``dims`` dims.
// A thread's 16-byte copies keep one column and step kThreads / (2 NV)
// rows, so it walks two pointers instead of recomputing 64-bit offsets.
template <int NV>
__device__ __forceinline__ void stage_v(float* dst, const float* src,
                                        long long stride, int valid,
                                        int dims, bool vec16) {
  constexpr int kLdv = v_stride<NV>();
  if (vec16) {   // Dv % 4 == 0 and 16-byte aligned rows
    constexpr int kPerRow = 2 * NV;
    constexpr int kStep = kThreads / kPerRow;
    static_assert(kThreads % kPerRow == 0 && kKeys % kStep == 0,
                  "whole rows per pass");
    const int d = (threadIdx.x % kPerRow) * 4;
    int r = threadIdx.x / kPerRow;
    const float* s = src + r * stride + d;
    float* o = dst + r * kLdv + d;
#pragma unroll
    for (int c = 0; c < kKeys / kStep; ++c) {
      const bool in = r < valid && d < dims;
      cp_async16(o, in ? s : src, in ? 16 : 0);
      r += kStep;
      s += kStep * stride;
      o += kStep * kLdv;
    }
  } else {
    for (int r = 0; r < kKeys; ++r)
      for (int d = threadIdx.x; d < 8 * NV; d += kThreads) {
        const bool in = r < valid && d < dims;
        cp_async4(dst + r * kLdv + d, in ? src + r * stride + d : src,
                  in ? 4 : 0);
      }
  }
}

// NV: 8-dim n-tiles of V per block.  kStaged: Q and K words go through
// shared memory (Dw <= kBK), else their fragments are read from global
// memory.  kRowWarps: warps along the query rows.  4: 64 rows a block, each
// warp 16 of them at all the block's dims.  1: 16 rows a block, every warp
// scores them all and takes a quarter of the dims.
template <int NV, bool kStaged, int kRowWarps>
__global__ void __launch_bounds__(kThreads, 2)
    attention_kernel(const __grid_constant__ AttnArgs a) {
  constexpr int kRows = 16 * kRowWarps;             // query rows per block
  constexpr int kNW = NV * kRowWarps / kWarps;      // n-tiles of a warp
  static_assert(kWarps % kRowWarps == 0 && kNW * kWarps == NV * kRowWarps,
                "warps split the rows and the dims evenly");
  constexpr int kLdv = v_stride<NV>();
  extern __shared__ __align__(16) uint32_t smem[];
  float* vs = reinterpret_cast<float*>(smem);     // [2][kKeys][kLdv]
  uint32_t* ks = smem + 2 * kKeys * kLdv;          // [2][kKeys][kLds]
  uint32_t* qs = ks + 2 * kKeys * kLds;            // [kRows][kLds]
  float* table = reinterpret_cast<float*>(qs + kRows * kLds);  // [kTable]

  const int lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x / kWarp;
  const int wm = (warp % kRowWarps) * 16;          // the warp's first row
  const int wd = (warp / kRowWarps) * 8 * kNW;     // and its first dim
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // last tile first
  const int b = blockIdx.z / a.chunks;
  const int dv0 = (blockIdx.z % a.chunks) * 8 * NV;
  const int hk = h / (a.Hq / a.Hkv);
  const int words = (a.Dw + 7) / 8 * 8;          // whole k256 steps

  const long long q_stride = static_cast<long long>(a.Hq) * a.Dw;
  const long long k_stride = static_cast<long long>(a.Hkv) * a.Dw;
  const long long v_row = static_cast<long long>(a.Hkv) * a.Dv;
  const uint32_t* qbase =
      a.q + (static_cast<long long>(b) * a.Sq * a.Hq + h) * a.Dw;
  const uint32_t* kbase =
      a.k + (static_cast<long long>(b) * a.Skv * a.Hkv + hk) * a.Dw;
  const float* vbase =
      a.v + (static_cast<long long>(b) * a.Skv * a.Hkv + hk) * a.Dv + dv0;
  const int dims = min(8 * NV, a.Dv - dv0);

  int t_lo, t_hi;
  tile_range(a, q0, min(q0 + kRows, a.Sq) - 1, t_lo, t_hi);
  const bool active = q0 + wm < a.Sq && wd < dims;
  int w_lo = 0, w_hi = -1;
  if (active) tile_range(a, q0 + wm, min(q0 + wm + 16, a.Sq) - 1, w_lo, w_hi);

  const auto stage = [&](int slot, int tile) {
    const int k0 = tile * kKeys;
    stage_v<NV>(vs + slot * kKeys * kLdv, vbase + k0 * v_row, v_row,
                a.Skv - k0, dims, a.v16);
    if constexpr (kStaged)
      stage_words(ks + slot * kKeys * kLds, kbase + k0 * k_stride, k_stride,
                  kKeys, a.Skv - k0, words, a.Dw, a.qk16);
  };
  if constexpr (kStaged) {
    stage_words(qs, qbase + q0 * q_stride, q_stride, kRows, a.Sq - q0, words,
                a.Dw, a.qk16);
    for (int i = threadIdx.x; i <= 32 * a.Dw; i += kThreads)
      table[i] = score_of(a.d_true - 2 * i, a);
  }
  stage(0, t_lo);
  cp_async_commit();

  float acc[kNW][4];
#pragma unroll
  for (int n = 0; n < kNW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this lane's share of their sums
  const long long wq0 = static_cast<long long>(a.q_offset) + q0 + wm;
  const long long qpos = wq0 + g;   // row g's; row g + 8 is 8 further on

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int slot = (tile - t_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; the other slot is free again
    if (tile < t_hi) stage(slot ^ 1, tile + 1);
    cp_async_commit();
    if (!active || tile < w_lo || tile > w_hi) continue;
    const int k0 = tile * kKeys;

    // Scores: y = d_true - 2 popc(q ^ k) for rows g, g+8 and keys 2t, 2t+1
    // of each 8-key n-tile.
    int32_t y[1][kGroups][4];
    int pa[1][2], pb[kGroups];
    b1_zero(y, pa, pb);
    if constexpr (kStaged) {
      const uint32_t* kt = ks + slot * kKeys * kLds;
      for (int k8 = 0; k8 < words; k8 += 8)
        b1_warp_step<1, kGroups>(qs, kt, wm, 0, g, t, k8, y, pa, pb);
    } else {
      const int r0 = q0 + wm + g;
      const uint32_t* qr0 = r0 < a.Sq ? qbase + r0 * q_stride : nullptr;
      const uint32_t* qr1 =
          r0 + 8 < a.Sq ? qbase + (r0 + 8) * q_stride : nullptr;
      const uint32_t* kr[kGroups];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int kp = k0 + 8 * j + g;
        kr[j] = kp < a.Skv ? kbase + kp * k_stride : nullptr;
      }
      for (int w0 = 0; w0 < a.Dw; w0 += 8) {
        const uint32_t af[4] = {
            word_at(qr0, w0 + t, a.Dw), word_at(qr1, w0 + t, a.Dw),
            word_at(qr0, w0 + t + 4, a.Dw), word_at(qr1, w0 + t + 4, a.Dw)};
        pa[0][0] += __popc(af[0]) + __popc(af[2]);
        pa[0][1] += __popc(af[1]) + __popc(af[3]);
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
          const uint32_t b0 = word_at(kr[j], w0 + t, a.Dw);
          const uint32_t b1 = word_at(kr[j], w0 + t + 4, a.Dw);
          pb[j] += __popc(b0) + __popc(b1);
          mma_b1(y[0][j], af, b0, b1);
        }
      }
    }
    b1_finish<1, kGroups>(y, pa, pb, a.d_true, t);

    // Scale, softcap (staged: from the table), mask; the tile's row max.
    // e: row g + 8 (e / 2), key 2t + e % 2.  In an open tile every key is
    // below Skv and no (row, key) of the warp is masked.
    const bool open =
        k0 + kKeys <= a.Skv && (!a.causal || k0 + kKeys - 1 <= wq0) &&
        (a.window <= 0 || wq0 + 15 - k0 < a.window);
    float s[kGroups][4];
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const long long qp = qpos + 8 * (e >> 1);
        float x = -INFINITY;  // a key past Skv: p = 0
        if (open || kp < a.Skv) {
          if constexpr (kStaged)
            x = table[(a.d_true - y[0][j][e]) >> 1];
          else
            x = score_of(y[0][j][e], a);
          bool keep = open || !a.causal || qp >= kp;
          if (a.window > 0) keep = keep && (open || qp - kp < a.window);
          if (!keep) x = kNegInf;
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    // Key k0 is below Skv and lane t = 0 scores it, so mt is finite.
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < kNW; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }

    // P.V in three TF32 passes.  k column t of group j is key 8j + 2t,
    // column t + 4 key 8j + 2t + 1.
    const float* vt = vs + slot * kKeys * kLdv;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const float pf[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t p_hi[4], p_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(pf[i], p_hi[i], p_lo[i]);
      const float* v0 = vt + (8 * j + 2 * t) * kLdv + wd + g;
#pragma unroll
      for (int n = 0; n < kNW; ++n) {
        uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
        split_tf32(v0[8 * n], b0_hi, b0_lo);
        split_tf32(v0[kLdv + 8 * n], b1_hi, b1_lo);
        mma_tf32(acc[n], p_lo, b0_hi, b1_hi);
        mma_tf32(acc[n], p_hi, b0_lo, b1_lo);
        mma_tf32(acc[n], p_hi, b0_hi, b1_hi);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  // Rows g and g + 8, dims 8n + 2t and 8n + 2t + 1 of the block's chunk.
  const bool pairs = (a.Dv % 2) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + wm + g + 8 * r;
    if (qi >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = a.out +
                  ((static_cast<long long>(b) * a.Sq + qi) * a.Hq + h) * a.Dv +
                  dv0;
#pragma unroll
    for (int n = 0; n < kNW; ++n) {
      const int d = wd + 8 * n + 2 * t;
      const float o0 = acc[n][2 * r] / denom;
      const float o1 = acc[n][2 * r + 1] / denom;
      if (pairs && d + 1 < dims) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(o0, o1);
      } else {
        if (d < dims) orow[d] = o0;
        if (d + 1 < dims) orow[d + 1] = o1;
      }
    }
  }
}

template <int NV, bool kStaged, int kRowWarps>
int launch(AttnArgs a, int B, cudaStream_t st) {
  constexpr int kRows = 16 * kRowWarps;
  a.chunks = (a.Dv + 8 * NV - 1) / (8 * NV);
  const dim3 grid(a.Hq, (a.Sq + kRows - 1) / kRows, B * a.chunks);
  return static_cast<int>(
      launch_b1<attention_kernel<NV, kStaged, kRowWarps>,
                attn_smem_bytes<NV, kStaged, kRows>()>(grid, st, a));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Returns cudaErrorInvalidValue (1) for Dv past kMaxChunks * 8 * kMaxNV;
// the wrapper raises before that.
extern "C" int binary_attention(const void* q, const void* k, const void* v,
                                void* out, int B, int Sq, int Skv, int Hq,
                                int Hkv, int Dw, int Dv, int d_true,
                                float scale, float softcap, int causal,
                                int window, int q_offset, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0 || Dv == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (Dv > kMaxChunks * 8 * kMaxNV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AttnArgs a;
  a.q = static_cast<const uint32_t*>(q);
  a.k = static_cast<const uint32_t*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Dw = Dw;
  a.Dv = Dv;
  a.d_true = d_true;
  a.scale = scale;
  a.softcap = softcap;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.chunks = 1;
  a.qk16 = Dw % 4 == 0 && aligned16(q) && aligned16(k);
  a.v16 = Dv % 4 == 0 && aligned16(v);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dw > kBK) return launch<kMaxNV, false, kWarps>(a, B, st);
  if (Sq <= 16) return launch<kMaxNV, true, 1>(a, B, st);
  if (Dv <= 128) return launch<16, true, kWarps>(a, B, st);
  return launch<kMaxNV, true, kWarps>(a, B, st);
}

namespace {

template <int NV, bool kStaged, int kRowWarps>
int query(int B, int Sq, int Hq, int Dv, int* out, const char** name) {
  constexpr int kRows = 16 * kRowWarps;
  const int chunks = (Dv + 8 * NV - 1) / (8 * NV);
  return launch_query(attention_kernel<NV, kStaged, kRowWarps>,
                      dim3(Hq, (Sq + kRows - 1) / kRows, B * chunks),
                      dim3(kThreads), attn_smem_bytes<NV, kStaged, kRows>(),
                      out, name);
}

}  // namespace

// What binary_attention() launches for these sizes (common.cuh:
// launch_query), by the same branches.
extern "C" int binary_attention_query(int B, int Sq, int Hq, int Dw, int Dv,
                                      int* out, const char** name) {
  if (Dw > kBK) return query<kMaxNV, false, kWarps>(B, Sq, Hq, Dv, out, name);
  if (Sq <= 16) return query<kMaxNV, true, 1>(B, Sq, Hq, Dv, out, name);
  if (Dv <= 128) return query<16, true, kWarps>(B, Sq, Hq, Dv, out, name);
  return query<kMaxNV, true, kWarps>(B, Sq, Hq, Dv, out, name);
}
