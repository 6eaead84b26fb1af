"""Plain PyTorch versions of every kernel in this package.

Each ``*_ref`` function computes, in ordinary tensor ops, exactly the
function its CUDA kernel computes (bit for bit: every output is integer
or packed, but for attention's float softmax, which they compute exactly
as the reference's oracle does).  The CPU runs them in place of the kernels, and the card
runs them beside the kernels to check them.  Contractions chunk over rows
(``binarize.packed_mismatches``), so they also run at the main path's
full-width shapes on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import binarize as B
from repro_torch.kernels.binary_attention import NEG_INF, attention_scale
from repro_torch.kernels.fused_epilogue import bn_sign_bits_to_words


def bitpack_ref(x: torch.Tensor) -> torch.Tensor:
    """Sign-binarize + pack along the last axis: bit = (x >= 0), on the
    input's own dtype (``binarize.pack_bits``)."""
    return B.pack_bits(x)


def binary_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Binary GEMM on real operands, independent of the packed path:
    (M, K) x (N, K) -> (M, N) int32 = sign(a) . sign(b)^T.  The ±1 dot
    runs in float64, exact for these integers on any device."""
    a_b = B.sign_pm1(a.to(torch.float64))
    b_b = B.sign_pm1(b.to(torch.float64))
    return (a_b @ b_b.T).to(torch.int32)


def bitplane_dot_ref(x_uint8: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """First-layer bit-plane dot == the exact integer GEMM of the raw
    input against sign(W): (M, K) uint8 x (N, K) -> (M, N) int32, in
    float64 (exact: |dot| <= 255 * K)."""
    wb = B.sign_pm1(w.to(torch.float64))
    return (x_uint8.to(torch.float64) @ wb.T).to(torch.int32)


def binary_matmul_packed_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                             k: int) -> torch.Tensor:
    """Packed binary GEMM (paper eq. 2): (M, Kw) x (N, Kw) -> (M, N) int32."""
    return B.packed_matmul(a_packed, b_packed, k)


def bn_sign_pack_ref(x: torch.Tensor, tau: torch.Tensor,
                     flip: torch.Tensor) -> torch.Tensor:
    """Fused BN-sign + pack: bit = (f32(x) >= tau) XNOR (flip > 0), packed
    along the last axis with zero-bit tails (the epilogue contract)."""
    return bn_sign_bits_to_words(x, tau, flip)


def binary_matmul_bn_sign_packed_ref(a_packed: torch.Tensor,
                                     b_packed: torch.Tensor,
                                     tau: torch.Tensor, flip: torch.Tensor,
                                     k: int) -> torch.Tensor:
    """Packed GEMM, then BN-sign + pack: (M, ceil(N/32)) int32 words."""
    return bn_sign_pack_ref(B.packed_matmul(a_packed, b_packed, k), tau, flip)


def binary_dense_stack_packed_ref(stages: list,
                                  x_packed: torch.Tensor) -> torch.Tensor:
    """Hidden dense stack: the per-layer fused epilogue, chained."""
    h = x_packed
    for s in stages:
        h = binary_matmul_bn_sign_packed_ref(h, s["w_packed"], s["tau"],
                                             s["flip"], s["k_true"])
    return h


def extract_patches_packed(x_packed: torch.Tensor, kh: int, kw: int,
                           stride: int, pads) -> torch.Tensor:
    """im2col over channel-packed words: (B, H, W, Cw) -> (B, H', W',
    KH*KW*Cw), tap-major.  Spatial padding is zero words (all -1)."""
    (pt, pb), (pl, pr) = pads
    xp = torch.nn.functional.pad(x_packed, (0, 0, pl, pr, pt, pb))
    _, hp, wp, _ = xp.shape
    out_h = (hp - kh) // stride + 1
    out_w = (wp - kw) // stride + 1
    cols = [xp[:, di:di + (out_h - 1) * stride + 1:stride,
               dj:dj + (out_w - 1) * stride + 1:stride, :]
            for di in range(kh) for dj in range(kw)]
    return torch.cat(cols, dim=-1)


def _packed_conv(x_packed, w_packed, *, kh, kw, stride, pads, c_out,
                 k_true):
    """im2col -> XNOR GEMM, with padding counted as -1 (no correction)."""
    patches = extract_patches_packed(x_packed, kh, kw, stride, pads)
    bsz, oh, ow, kcw = patches.shape
    return B.packed_matmul(patches.reshape(bsz * oh * ow, kcw), w_packed,
                           k_true).reshape(bsz, oh, ow, c_out)


def binary_conv2d_packed_ref(x_packed: torch.Tensor, w_packed: torch.Tensor,
                             correction: torch.Tensor, *, kh: int, kw: int,
                             stride: int, pads, c_out: int,
                             k_true: int) -> torch.Tensor:
    """Packed conv: im2col -> XNOR GEMM -> +correction.  (B,OH,OW,C_out)."""
    out = _packed_conv(x_packed, w_packed, kh=kh, kw=kw, stride=stride,
                       pads=pads, c_out=c_out, k_true=k_true)
    return out + correction.reshape(out.shape[1:])[None]


def bitplane_conv2d_planes_ref(x_planes: torch.Tensor, w_packed: torch.Tensor,
                               rowsum: torch.Tensor, *, kh: int, kw: int,
                               stride: int, pads, c_out: int, k_true: int,
                               nbits: int) -> torch.Tensor:
    """First-layer conv (paper C4) on packed bit planes, one plane at a time.

    ``x_planes``: (nbits, B, H, W, Cw) words.  Recombines the per-plane
    packed convs with  x.w = 1/2 sum_i 2^i (p_i (*) w + rowsum); the
    all-taps rowsum absorbs both the {0,1} -> ±1 shift and the zero-pad
    correction, so each plane conv runs with no correction.  The sum is
    even before the halving, so ``>> 1`` is exact.
    """
    acc = None
    for i in range(nbits):
        d = _packed_conv(x_planes[i], w_packed, kh=kh, kw=kw, stride=stride,
                         pads=pads, c_out=c_out, k_true=k_true)
        term = (d + rowsum[None, None, None, :]) << i
        acc = term if acc is None else acc + term
    return acc >> 1


def bitplane_conv2d_packed_ref(x_uint8: torch.Tensor, w_packed: torch.Tensor,
                               rowsum: torch.Tensor, *, kh: int, kw: int,
                               stride: int, pads, c_out: int, k_true: int,
                               nbits: int) -> torch.Tensor:
    """First-layer conv on raw (B, H, W, C_in) uint8 input: bit planes,
    then :func:`bitplane_conv2d_planes_ref`."""
    return bitplane_conv2d_planes_ref(
        B.pack_bitplanes_uint8(x_uint8, nbits), w_packed, rowsum, kh=kh,
        kw=kw, stride=stride, pads=pads, c_out=c_out, k_true=k_true,
        nbits=nbits)


def bitplane_conv2d_bn_sign_packed_ref(x_uint8: torch.Tensor,
                                      w_packed: torch.Tensor,
                                      rowsum: torch.Tensor,
                                      tau: torch.Tensor, flip: torch.Tensor,
                                      *, kh: int, kw: int, stride: int, pads,
                                      c_out: int, k_true: int,
                                      nbits: int) -> torch.Tensor:
    """First-layer conv on raw uint8 input, then BN-sign + re-bitpack
    along C_out: (B, OH, OW, ceil(C_out/32)) words."""
    y = bitplane_conv2d_packed_ref(x_uint8, w_packed, rowsum, kh=kh, kw=kw,
                                   stride=stride, pads=pads, c_out=c_out,
                                   k_true=k_true, nbits=nbits)
    return bn_sign_pack_ref(y, tau, flip)


def binary_conv2d_bn_sign_packed_ref(x_packed: torch.Tensor,
                                     w_packed: torch.Tensor,
                                     correction: torch.Tensor,
                                     tau: torch.Tensor, flip: torch.Tensor, *,
                                     kh: int, kw: int, stride: int, pads,
                                     c_out: int, k_true: int) -> torch.Tensor:
    """Packed conv, then BN-sign + re-bitpack along C_out."""
    y = binary_conv2d_packed_ref(x_packed, w_packed, correction, kh=kh, kw=kw,
                                 stride=stride, pads=pads, c_out=c_out,
                                 k_true=k_true)
    return bn_sign_pack_ref(y, tau, flip)


def _attention_pm1(qb: torch.Tensor, kb: torch.Tensor, v: torch.Tensor, *,
                   scale: float, causal: bool, window: int | None,
                   attn_softcap: float | None,
                   q_offset: int) -> torch.Tensor:
    """Exact-softmax attention over ±1 float32 Q (B, Sq, Hq, D) and K
    (B, Skv, Hkv, D) and real V (B, Skv, Hkv, Dv), in float32."""
    sq, hq = qb.shape[1], qb.shape[2]
    skv, hkv = kb.shape[1], kb.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    g = hq // hkv
    kb = kb.repeat_interleave(g, dim=2)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
    if attn_softcap is not None:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    qpos = q_offset + torch.arange(sq, device=qb.device)[:, None]
    kpos = torch.arange(skv, device=qb.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=qb.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask[None, None], s, NEG_INF)
    # The softmax as the oracle's ``jax.nn.softmax`` takes it: exp of the
    # max-shifted scores over their sum.  A row with no unmasked key has
    # every score at NEG_INF and averages V uniformly over the Skv keys.
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf)


def binary_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         attn_softcap: float | None = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Binary attention on real Q (B, Sq, Hq, D), K (B, Skv, Hkv, D) and V
    (B, Skv, Hkv, Dv): Q and K sign-binarized to ±1, scores scaled by
    D^-1/2 (``attention_scale``), soft-capped, masked (causal keeps qpos >=
    kpos with ``q_offset``; ``window`` keeps qpos - kpos < window) to
    ``NEG_INF``, softmaxed exactly and averaged against V; query head h
    reads KV head h // (Hq/Hkv).  (B, Sq, Hq, Dv) float32, the reference's
    oracle (``src/repro/kernels/ref.py:160``)."""
    return _attention_pm1(
        B.sign_pm1(q.to(torch.float32)), B.sign_pm1(k.to(torch.float32)), v,
        scale=attention_scale(q.shape[-1]), causal=causal, window=window,
        attn_softcap=attn_softcap, q_offset=q_offset)


def binary_attention_packed_ref(q_packed: torch.Tensor,
                                k_packed: torch.Tensor, v: torch.Tensor, *,
                                d_true: int, causal: bool = True,
                                window: int | None = None,
                                attn_softcap: float | None = None,
                                q_offset: int = 0) -> torch.Tensor:
    """:func:`binary_attention_ref` on packed Q (B, Sq, Hq, Dw) and K
    (B, Skv, Hkv, Dw) words, the inputs of the attention kernel (K8)."""
    return _attention_pm1(
        B.unpack_bits(q_packed, d_true), B.unpack_bits(k_packed, d_true), v,
        scale=attention_scale(d_true), causal=causal, window=window,
        attn_softcap=attn_softcap, q_offset=q_offset)
