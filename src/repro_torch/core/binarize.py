"""Binarization primitives (paper §4) on PyTorch tensors.

Encoding: logical values are {-1,+1}; at the bit level -1 -> 0, +1 -> 1.
Packing: 32-bit words along the LAST axis, LSB-first: element ``j*32 + i``
of a row occupies bit ``i`` of word ``j``; padded elements are 0-bits.

Packed words are ``torch.int32`` tensors holding the bit pattern of the
unsigned word.  PyTorch has no popcount and no ``>>`` on ``uint32`` on the
CPU, and ``>>`` on int32 is arithmetic, so the helpers here widen to
int64, mask to the low 32 bits after every shift, and fold words back
into the signed range before the cast to int32.

The packed dot-product identity (paper eq. 2, XOR form)::

    a . b  =  K - 2 * popcount(XOR(a_packed, b_packed))
"""
from __future__ import annotations

import torch

WORD_BITS = 32
_LOW32 = 0xFFFFFFFF

# Elements of the (rows, N, Kw) broadcast that one chunk of
# :func:`packed_matmul` materializes (int64: 128 MiB per temporary).
_MATMUL_CHUNK_ELEMS = 1 << 24


def packed_width(k: int) -> int:
    """Number of 32-bit words needed for k binary elements."""
    return (k + WORD_BITS - 1) // WORD_BITS


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int,
                    value=0) -> torch.Tensor:
    """Pad ``axis`` of ``x`` up to the next multiple of ``multiple``."""
    axis = axis % x.dim()
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """Paper eq. 1: sign(x) in {-1,+1} with sign(0) = +1."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


class _BinarizeSTE(torch.autograd.Function):
    """sign() forward, hard-tanh straight-through estimator backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return sign_pm1(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x.abs() <= 1.0, g, torch.zeros_like(g))


def binarize_ste(x: torch.Tensor) -> torch.Tensor:
    """sign() with the straight-through estimator backward (paper §4.4).

    Forward: sign(x) in {-1,+1}.  Backward: the gradient passes where
    |x| <= 1 and is zero elsewhere (Bengio et al. 2013 hard-tanh STE).
    """
    return _BinarizeSTE.apply(x)


def clip_latent(w: torch.Tensor) -> torch.Tensor:
    """Clip latent float weights to [-1, 1] after the optimizer step
    (paper §4.4)."""
    return torch.clamp(w, -1.0, 1.0)


def to_words(w64: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> int32 with the same bits."""
    w64 = w64 & _LOW32
    return (w64 - ((w64 >> 31) << 32)).to(torch.int32)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned values in int64."""
    return w.to(torch.int64) & _LOW32


def pack_bool_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a boolean/{0,1} tensor along its last axis into int32 words."""
    k = bits.shape[-1]
    b = pad_to_multiple(bits.to(torch.int64), WORD_BITS, axis=-1)
    b = b.reshape(*bits.shape[:-1], packed_width(k), WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    return to_words((b << shifts).sum(dim=-1))


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack sign-interpretable values along the last axis.

    ``x``: (..., K) real.  Values >= 0 encode to bit 1, < 0 to bit 0.
    Returns (..., ceil(K/32)) int32 words with zero-bit tails, so padded
    positions of two packed operands XOR to no mismatches.
    """
    return pack_bool_bits(x >= 0)


def unpack_bits(packed: torch.Tensor, k: int,
                dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., Kw) words -> (..., k) ±1."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=packed.device)
    bits = (from_words(packed)[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * WORD_BITS)
    return (2 * bits[..., :k] - 1).to(dtype)


def binary_dot_unpacked_mxu(x: torch.Tensor, w_packed: torch.Tensor, k: int,
                            dtype=torch.bfloat16) -> torch.Tensor:
    """The unpack route of a dot on packed weights: unpack ``w_packed``
    (N, Kw) to ±1 in ``dtype`` and contract ``x`` (..., k), cast to
    ``dtype``, with a matmul.  Returns (..., N) in ``dtype``."""
    w = unpack_bits(w_packed, k, dtype=dtype)          # (N, k) ±1
    return torch.matmul(x.to(dtype), w.T)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words (SWAR on int64), as int64."""
    v = x.to(torch.int64) & _LOW32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def packed_mismatches(a_packed: torch.Tensor,
                      b_packed: torch.Tensor) -> torch.Tensor:
    """Total mismatch counts of packed rows: (M, Kw) x (N, Kw) -> (M, N).

    The XNOR-popcount contraction every kernel of this package shares.
    Rows of ``a`` are processed in chunks so that the (rows, N, Kw)
    broadcast stays bounded at any M.
    """
    m, kw = a_packed.shape
    n, kw_b = b_packed.shape
    if kw != kw_b:
        raise ValueError(f"packed widths differ: {tuple(a_packed.shape)} vs "
                         f"{tuple(b_packed.shape)}")
    out = torch.empty((m, n), dtype=torch.int32, device=a_packed.device)
    rows = max(1, _MATMUL_CHUNK_ELEMS // max(1, n * kw))
    for r0 in range(0, m, rows):
        a = a_packed[r0:r0 + rows]
        mism = popcount32(a[:, None, :] ^ b_packed[None, :, :]).sum(dim=-1)
        out[r0:r0 + rows] = mism.to(torch.int32)
    return out


def packed_matmul(a_packed: torch.Tensor, b_packed: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Binary matmul on packed operands (paper eq. 2).

    ``a_packed``: (..., M, Kw), ``b_packed``: (N, Kw) int32 words.
    Returns (..., M, N) int32 exact dot products in [-k, k].
    """
    lead = a_packed.shape[:-1]
    a2 = a_packed.reshape(-1, a_packed.shape[-1])
    mism = packed_mismatches(a2, b_packed)
    return (k - 2 * mism).reshape(*lead, b_packed.shape[0])


def bitplanes_uint8(x: torch.Tensor, nbits: int = 8) -> torch.Tensor:
    """Split fixed-precision input into bit planes.

    ``x``: (..., K) uint8 (or int in [0, 2^nbits)).  Returns
    (nbits, ..., K) int32 with values in {0, 1}: plane ``i`` holds bit ``i``.
    """
    x = x.to(torch.int32)
    shifts = torch.arange(nbits, dtype=torch.int32, device=x.device)
    return (x[None] >> shifts.reshape(nbits, *([1] * x.dim()))) & 1


def pack_bitplanes_uint8(x: torch.Tensor, nbits: int = 8) -> torch.Tensor:
    """Split fixed-precision input into bit planes AND channel-pack them.

    ``x``: (..., C) uint8.  Returns (nbits, ..., ceil(C/32)) int32 words.
    Plane bit 1 encodes +1 and plane bit 0 encodes -1, so the packed word
    is the raw plane bits.
    """
    return pack_bool_bits(bitplanes_uint8(x, nbits))


def bitplane_dot(x_uint8: torch.Tensor, w_pm1: torch.Tensor,
                 nbits: int = 8) -> torch.Tensor:
    """Exact first-layer dot via bit planes (paper §4.3, exact form).

    A {0,1} plane ``p`` relates to its ±1 encoding ``p^ = 2p - 1`` by
    ``p = (p^ + 1)/2``, so

        x . w = sum_i 2^i (plane_i . w)
              = sum_i 2^(i-1) ((plane^_i . w) + sum_j w_j).

    ``x_uint8``: (..., K); ``w_pm1``: (N, K) ±1.  Returns (..., N) int32,
    exactly ``x.int() @ w.T``.  The plane dots run in float64, exact for
    these integers on any device (a float32 product may run in TF32).
    """
    planes = bitplanes_uint8(x_uint8, nbits)            # (nbits, ..., K)
    planes_pm1 = (2 * planes - 1).to(torch.float64)
    w = w_pm1.to(torch.float64)
    plane_dots = torch.einsum("p...k,nk->p...n", planes_pm1, w)
    weights = 2.0 ** torch.arange(nbits, dtype=torch.float64,
                                  device=w.device) / 2.0
    out = torch.tensordot(weights, plane_dots + w.sum(dim=-1), dims=1)
    return out.to(torch.int32)
