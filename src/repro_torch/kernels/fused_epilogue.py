"""Fused BN-sign-fold + re-bitpack epilogue, and its CUDA kernel (K2).

Between binary layers the inference path turns an int32 layer output
into the next layer's packed words: sign(BN(y)) == flip * sign(y - tau)
(``core.binary_layers.fold_bn_sign``), so one compare per element and a
pack.  :func:`bn_sign_pack` runs it as one kernel (K2) after the BMLP's
bit-plane first layer and after the BCNN's first stage where that stage
pools; K1's fused instance
(``binary_conv.bitplane_conv2d_bn_sign_packed``), the conv kernels and
the GEMM kernels inline the same epilogue.

K2 has two paths (``csrc/bn_sign_pack.cu``), chosen by shape and
alignment (:func:`bn_sign_aligned`): rows of whole 4-channel groups on 16
bytes take 16-byte loads, 8 rows in flight a lane, with tau and flip
kept in registers; any other input one warp per output word.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import binarize as B
from repro_torch.kernels import _build
from repro_torch.kernels import binary_matmul as _bmm
from repro_torch.kernels import smem as S

# csrc/bn_sign_pack.cu's C entry points, its query entry among them
ENTRIES = {"bn_sign_pack": "ppppiiiip",
           "bn_sign_pack_query": "iiiipp"}
# csrc/bn_sign_pack.cu's aligned path: rows a warp keeps in flight,
# channels a slab, warps an SM it walks with
SIGN_ROWS, SIGN_SLAB, SIGN_WARPS_PER_SM = 8, 128, 32


def bn_sign_bits_to_words(y: torch.Tensor, tau: torch.Tensor,
                          flip: torch.Tensor) -> torch.Tensor:
    """The epilogue contract shared by every kernel that inlines it.

    bit = (f32(y) >= tau) XNOR (flip > 0), packed LSB-first along the last
    axis.  ``y``: (..., c), ``tau``/``flip``: (c,).  A ragged last word
    gets zero bits, which is what the reference's padding of tau with +inf
    and flip with +1 gives; the kernels mask those lanes instead of
    padding the parameters.
    """
    ge = y.to(torch.float32) >= tau
    return B.pack_bool_bits(ge == (flip > 0))


def bn_sign_aligned(c: int, ptr: int) -> bool:
    """Whether an (M, C) int32 input at address ``ptr`` takes K2's aligned
    path: rows of whole 4-channel groups (C % 4 == 0), the data on 16
    bytes, so every row starts on 16 bytes.  Every other input takes the
    warp-per-word path."""
    return c % 4 == 0 and ptr % 16 == 0


@functools.lru_cache(maxsize=4096)
def bn_sign_pack_estimate(m: int, c: int, aligned: bool,
                          sms: int) -> S.LaunchEstimate:
    """K2's launch on an (M, C) int32 input on a card of ``sms`` SMs: on
    the aligned path a warp per slab of channels and walker of rows,
    else a warp per word; no shared memory."""
    if aligned:
        slabs = S.ceil_div(c, SIGN_SLAB)
        walkers = min(S.ceil_div(sms * SIGN_WARPS_PER_SM, slabs),
                      S.ceil_div(m, SIGN_ROWS))
        warps = slabs * walkers
    else:
        warps = m * B.packed_width(c)
    return S.LaunchEstimate(
        "bn_sign_pack", "aligned" if aligned else "general",
        (S.blocks_for_warps(warps), 1, 1), S.BLOCK_THREADS, (),
        ("bn_sign_pack", "bn_sign_pack_query", (m, c, int(aligned), sms)))


def bn_sign_pack(x: torch.Tensor, tau: torch.Tensor,
                 flip: torch.Tensor) -> torch.Tensor:
    """K2: fused sign(BN(x)) + bit-pack, (M, C) int32 -> (M, ceil(C/32))
    int32 words.

    Launches ``csrc/bn_sign_pack.cu`` on CUDA tensors, on the path
    :func:`bn_sign_aligned` picks, and adds one to
    ``bn_sign_pack.launches``; its plain version is
    :func:`bn_sign_bits_to_words`.
    """
    m, c = x.shape
    dev = _build.cuda_device(x, "x")
    px = _build.require(x, "x", torch.int32, (m, c), dev)
    out = torch.empty((m, B.packed_width(c)), dtype=torch.int32, device=dev)
    lib = _build.load("bn_sign_pack", ENTRIES)
    err = lib.bn_sign_pack(
        px, _build.require(tau, "tau", torch.float32, (c,), dev),
        _build.require(flip, "flip", torch.float32, (c,), dev),
        out.data_ptr(), m, c, int(bn_sign_aligned(c, px)),
        _bmm.sm_count(dev), _build.stream_of(x))
    _build.check(err, "bn_sign_pack")
    bn_sign_pack.launches += 1
    return out


bn_sign_pack.launches = 0
