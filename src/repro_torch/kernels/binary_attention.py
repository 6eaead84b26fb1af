"""Flash-style binary attention on packed Q and K, and its CUDA kernel (K8).

Every QK^T score is the XNOR-popcount identity over sign-binarized Q and
K packed 32 to a word along head_dim,

    s = (D - 2 * popcount(XOR(q_packed, k_packed))) * D^-1/2,

optionally soft-capped (``cap * tanh(s / cap)``), then masked: causal
keeps qpos >= kpos (``q_offset`` aligns decode queries), ``window`` keeps
qpos - kpos < window, and a masked score is the finite ``NEG_INF``.  The
softmax runs online over KV tiles, so the (Sq, Skv) scores never reach
device memory, and V stays real and accumulates in float32.  GQA: query
head h reads KV head h // (Hq // Hkv).

``D^-1/2`` is rounded to float32 once on the host
(:func:`attention_scale`); the kernel and its plain version
(``ref.binary_attention_packed_ref``) take the same value; every integer
score is the same in both, and its float score takes the same steps.
The softmax and P.V do not: the kernel sums over keys tile by tile,
online, and takes P.V on the tensor cores as three TF32 products (P_hi
V_hi + P_hi V_lo + P_lo V_hi) accumulated in float32, in another order
than the plain version's exact float32 softmax.  So the two agree within
rtol = atol = 2e-5, the reference's own tolerance between its kernel and
its oracle, and not bit for bit.

The wrapper launches the kernel and takes CUDA tensors only;
``kernels/ops.py`` routes CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import binarize as B
from repro_torch.kernels import _build
from repro_torch.kernels import smem as S

# Additive mask value: finite, so a row whose every key is masked averages
# V uniformly instead of turning to NaN (the reference's constant).
NEG_INF = -1e30

# csrc/binary_attention.cu: a block holds at most 256 output dims, and Dv
# takes at most two blocks.
MAX_DV = 2 * 256

# csrc/binary_attention.cu's C entry points, its query entry among them
ENTRIES = {"binary_attention": "ppppiiiiiiiiffiiip",
           "binary_attention_query": "iiiiipp"}
# csrc/binary_attention.cu: keys a tile, the widest V slice a block (in
# 8-column groups), the score table's words
ATT_KEYS, ATT_MAX_NV, ATT_TABLE = 32, 32, 32 * S.BK + 4


def attention_scale(d: int) -> float:
    """``d ** -0.5`` rounded to float32, the score scale of both the kernel
    and its plain version."""
    return float(torch.tensor(d, dtype=torch.float32) ** -0.5)


@functools.lru_cache(maxsize=4096)
def attention_estimate(b: int, sq: int, hq: int, dw: int,
                       dv: int) -> S.LaunchEstimate:
    """K8's launch on (B, Sq, Hq, Dw) packed queries and Dv-wide V, in the
    instance its launcher's branches take: K staged in shared memory where
    a head is one stage of words, 16-row query tiles for short queries."""
    staged = dw <= S.BK
    nv = 16 if staged and sq > 16 and dv <= 128 else ATT_MAX_NV
    rows = 16 if staged and sq <= 16 else 64
    terms = [S.SmemTerm("v_ring", 2 * ATT_KEYS * (8 * nv + 4) * 4)]
    if staged:
        terms += [S.SmemTerm("k_ring", 2 * ATT_KEYS * S.LDS * 4),
                  S.SmemTerm("q_tile", rows * S.LDS * 4),
                  S.SmemTerm("score_table", ATT_TABLE * 4)]
    route = f"{rows}rows_nv{nv}" + ("_staged" if staged else "_global")
    return S.LaunchEstimate(
        "binary_attention", route,
        (hq, S.ceil_div(sq, rows), b * S.ceil_div(dv, 8 * nv)),
        S.MMA_THREADS, tuple(terms),
        ("binary_attention", "binary_attention_query", (b, sq, hq, dw, dv)))


def binary_attention_packed(q_packed: torch.Tensor, k_packed: torch.Tensor,
                            v: torch.Tensor, *, d_true: int,
                            causal: bool = True, window: int | None = None,
                            attn_softcap: float | None = None,
                            q_offset: int = 0) -> torch.Tensor:
    """K8: q (B, Sq, Hq, Dw) and k (B, Skv, Hkv, Dw) int32 words, v (B, Skv,
    Hkv, Dv) float32 -> (B, Sq, Hq, Dv) float32.

    ``d_true`` is the logical head_dim before packing.  ``window`` (a
    positive int or None), ``attn_softcap`` (positive or None) and
    ``q_offset`` (>= 0) as in the module docstring.  Adds one to
    ``binary_attention_packed.launches`` per kernel launch.
    """
    dev = _build.cuda_device(q_packed, "q_packed")
    b, sq, hq, dw = q_packed.shape
    skv, hkv, dv = k_packed.shape[1], k_packed.shape[2], v.shape[-1]
    if dw != B.packed_width(d_true) or d_true < 1:
        raise ValueError(f"d_true={d_true} does not pack into {dw} words")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if skv < 1 or not 1 <= dv <= MAX_DV:
        raise ValueError(f"the kernel takes Skv >= 1 and 1 <= Dv <= "
                         f"{MAX_DV}; got Skv={skv}, Dv={dv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int, got {window!r}")
    if attn_softcap is not None and not attn_softcap > 0:
        raise ValueError(f"attn_softcap must be positive, got "
                         f"{attn_softcap!r}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    pq = _build.require(q_packed, "q_packed", torch.int32, (b, sq, hq, dw),
                        dev)
    pk = _build.require(k_packed, "k_packed", torch.int32, (b, skv, hkv, dw),
                        dev)
    pv = _build.require(v, "v", torch.float32, (b, skv, hkv, dv), dev)
    out = torch.empty((b, sq, hq, dv), dtype=torch.float32, device=dev)
    lib = _build.load("binary_attention", ENTRIES)
    err = lib.binary_attention(
        pq, pk, pv, out.data_ptr(), b, sq, skv, hq, hkv, dw, dv, d_true,
        ctypes.c_float(attention_scale(d_true)),
        ctypes.c_float(attn_softcap or 0.0), int(causal), window or 0,
        q_offset, _build.stream_of(q_packed))
    _build.check(err, "binary_attention")
    binary_attention_packed.launches += 1
    return out


binary_attention_packed.launches = 0
