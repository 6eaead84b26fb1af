// K8 binary_attention: flash-style binary attention on packed Q and K.
//
// Replaces: src/repro/kernels/binary_attention.py:_attention_kernel
//           (pallas_call in binary_attention_packed).
// Computes: q (B, Sq, Hq, Dw) words, k (B, Skv, Hkv, Dw) words, v (B, Skv,
//           Hkv, Dv) f32 -> out (B, Sq, Hq, Dv) f32, the softmax of the
//           scores s = (d_true - 2*popc(q ^ k)) * scale, soft-capped
//           (cap * tanh(s / cap)) and then masked, against v.  Query head h
//           reads KV head h / (Hq / Hkv).  A masked score (causal: qpos <
//           kpos; window: qpos - kpos >= window; qpos = q_offset + row) is
//           -1e30, as in the reference.  Keys past Skv take no part, so a
//           row with no unmasked key averages v uniformly over the Skv keys,
//           as the reference's exact-softmax oracle does.
// Bound on the H100: at the LM's shapes, the P.V products on the CUDA
//           cores (2*Dv fp32 operations per unmasked (q, k) pair against
//           Dw word-ops for its score, Dv = 32*Dw); bytes only when Skv is
//           short.
// Design:   one block per (8 query rows, query head, batch), one warp per
//           row.  The TPU's sequential KV grid dimension becomes a loop in
//           the block over KV tiles of 32 keys; a tile that no row of the
//           block can see (wholly above the causal diagonal, or before the
//           window) is skipped.  The block stages each tile's K words and V
//           rows in shared memory for all 8 warps.  Lane j scores key j
//           (XOR + __popc over Dw words against the warp's q row, a
//           broadcast read), the warp takes the tile's max and sum by
//           shuffles (the online-softmax recurrence of the Pallas body), and
//           lane l accumulates output dims l, l+32, ... with each p_j
//           broadcast by shuffle.  The (Sq, Skv) scores never leave
//           registers.  expf and tanhf, not the fast intrinsics: the output
//           is held to the reference within 2e-5.
#include <cmath>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kRows = 8;          // query rows (warps) per block
constexpr int kTile = 32;         // keys per KV tile, one per lane
constexpr float kNegInf = -1e30f; // the reference's NEG_INF
constexpr int kMaxChunks = 16;    // Dv <= 16 * 32

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
  int kstride;    // words per key row of the shared K tile (odd: no bank
                  // conflicts when lane j reads row j)
};

// Output dims are held in NC chunks of 32 per lane; V rows are staged NC*32
// floats wide, zero past Dv.
template <int NC>
__global__ void __launch_bounds__(kRows * kWarp)
    attention_kernel(const __grid_constant__ AttnArgs a) {
  extern __shared__ uint32_t smem[];
  constexpr int kVw = NC * kWarp;
  float* vs = reinterpret_cast<float*>(smem);  // kTile x kVw
  uint32_t* ks = smem + kTile * kVw;           // kTile x kstride
  uint32_t* qs = ks + kTile * a.kstride;       // kRows x Dw

  const int warp = threadIdx.x / kWarp;
  const int lane = lane_id();
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int qi = q0 + warp;
  const long long qpos = static_cast<long long>(a.q_offset) + qi;
  const bool has_window = a.window > 0;

  for (int idx = threadIdx.x; idx < kRows * a.Dw; idx += blockDim.x) {
    const int r = idx / a.Dw, w = idx % a.Dw;
    const int qr = q0 + r;
    qs[idx] = qr < a.Sq
                  ? a.q[((static_cast<long long>(b) * a.Sq + qr) * a.Hq + h) *
                            a.Dw + w]
                  : 0u;
  }

  // The tiles some row of the block can see.  A row with no unmasked key
  // (window set and qpos >= Skv - 1 + window) averages every key, so a
  // block that holds one skips nothing.
  const int n_tiles = (a.Skv + kTile - 1) / kTile;
  const long long qmin = static_cast<long long>(a.q_offset) + q0;
  const int q_last = (q0 + kRows < a.Sq ? q0 + kRows : a.Sq) - 1;
  const long long qmax = static_cast<long long>(a.q_offset) + q_last;
  int t_lo = 0, t_hi = n_tiles - 1;
  if (!has_window ||
      qmax < static_cast<long long>(a.Skv) - 1 + a.window) {
    if (a.causal && qmax / kTile < t_hi) t_hi = static_cast<int>(qmax / kTile);
    const long long first = qmin - a.window + 1;
    if (has_window && first > 0) t_lo = static_cast<int>(first / kTile);
  }

  float m = -INFINITY, l = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile is consumed; qs is written
    for (int idx = threadIdx.x; idx < kTile * a.Dw; idx += blockDim.x) {
      const int j = idx / a.Dw, w = idx % a.Dw;
      const int kp = k0 + j;
      ks[j * a.kstride + w] =
          kp < a.Skv ? a.k[((static_cast<long long>(b) * a.Skv + kp) * a.Hkv +
                            hk) * a.Dw + w]
                     : 0u;
    }
    for (int idx = threadIdx.x; idx < kTile * kVw; idx += blockDim.x) {
      const int j = idx / kVw, dd = idx % kVw;
      const int kp = k0 + j;
      vs[idx] = (kp < a.Skv && dd < a.Dv)
                    ? a.v[((static_cast<long long>(b) * a.Skv + kp) * a.Hkv +
                           hk) * a.Dv + dd]
                    : 0.f;
    }
    __syncthreads();

    const int kp = k0 + lane;
    float s = -INFINITY;  // a key past Skv: p = 0
    if (kp < a.Skv) {
      const uint32_t* qrow = qs + warp * a.Dw;
      const uint32_t* krow = ks + lane * a.kstride;
      int mism = 0;
      for (int w = 0; w < a.Dw; ++w) mism += __popc(qrow[w] ^ krow[w]);
      s = static_cast<float>(a.d_true - 2 * mism) * a.scale;
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      bool keep = !a.causal || qpos >= kp;
      if (has_window) keep = keep && qpos - kp < a.window;
      if (!keep) s = kNegInf;
    }
    // Lane 0's key is below Skv on every tile walked, so mt is finite.
    float mt = s;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    }
    const float m_new = fmaxf(m, mt);
    const float p = expf(s - m_new);
    const float corr = expf(m - m_new);
    float ps = p;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    }
    l = l * corr + ps;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= corr;
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float* vrow = vs + j * kVw + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(pj, vrow[c * kWarp], acc[c]);
    }
    m = m_new;
  }

  if (qi < a.Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow =
        a.out + ((static_cast<long long>(b) * a.Sq + qi) * a.Hq + h) * a.Dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * kWarp + lane;
      if (d < a.Dv) orow[d] = acc[c] / denom;
    }
  }
}

template <int NC>
int launch(const AttnArgs& a, int B, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kTile) * NC * kWarp +
       static_cast<size_t>(kTile) * a.kstride +
       static_cast<size_t>(kRows) * a.Dw) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.Hq, B);
  attention_kernel<NC><<<grid, kRows * kWarp, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaErrorInvalidValue (1) for Dv past kMaxChunks * 32; the wrapper
// raises before that.
extern "C" int binary_attention(const void* q, const void* k, const void* v,
                                void* out, int B, int Sq, int Skv, int Hq,
                                int Hkv, int Dw, int Dv, int d_true,
                                float scale, float softcap, int causal,
                                int window, int q_offset, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0 || Dv == 0) {
    return static_cast<int>(cudaGetLastError());
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
  a.kstride = Dw | 1;
  const int chunks = (Dv + kWarp - 1) / kWarp;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunks <= 1) return launch<1>(a, B, st);
  if (chunks <= 2) return launch<2>(a, B, st);
  if (chunks <= 4) return launch<4>(a, B, st);
  if (chunks <= 8) return launch<8>(a, B, st);
  if (chunks <= kMaxChunks) return launch<16>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
