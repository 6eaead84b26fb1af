"""Packed binary dense GEMM (paper §4.2, C1/C2/C7) and its CUDA kernel (K4).

    out[m, n] = K - 2 * popcount(XOR(a[m, :], b[n, :]))

over packed int32 words, with two epilogues chosen at compile time in
``csrc/xnor_gemm.cu``: the int32 result (:func:`binary_matmul_packed`,
the output layer) or the fused BN-sign threshold + re-bitpack along N
(:func:`binary_matmul_bn_sign_packed`, the hidden layers).  One kernel
serves every M, from a single request to a full batch.  The contraction
contract (the reference's ``_mismatch_counts``) is
``binarize.packed_mismatches``.

Each wrapper launches its kernel and takes CUDA tensors only;
``kernels/ops.py`` routes CPU tensors to the plain versions
(``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import binarize as B
from repro_torch.kernels import _build

_ENTRIES = {"xnor_gemm": "pppiiiip", "xnor_gemm_bn_sign": "pppppiiiip"}


def _operands(a_packed: torch.Tensor, b_packed: torch.Tensor):
    m, kw = a_packed.shape
    n = b_packed.shape[0]
    dev = _build.cuda_device(a_packed, "a_packed")
    pa = _build.require(a_packed, "a_packed", torch.int32, (m, kw), dev)
    pb = _build.require(b_packed, "b_packed", torch.int32, (n, kw), dev)
    return m, n, kw, dev, pa, pb


def binary_matmul_packed(a_packed: torch.Tensor, b_packed: torch.Tensor, *,
                         k_true: int) -> torch.Tensor:
    """K4, int32 epilogue: (M, Kw) x (N, Kw) words -> (M, N) int32.

    ``k_true`` is the logical K before packing.  Adds one to
    ``binary_matmul_packed.launches`` per kernel launch.
    """
    m, n, kw, dev, pa, pb = _operands(a_packed, b_packed)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    lib = _build.load("xnor_gemm", _ENTRIES)
    err = lib.xnor_gemm(pa, pb, out.data_ptr(), m, n, kw, k_true,
                        _build.stream_of(a_packed))
    _build.check(err, "xnor_gemm")
    binary_matmul_packed.launches += 1
    return out


binary_matmul_packed.launches = 0


def binary_matmul_bn_sign_packed(a_packed: torch.Tensor,
                                 b_packed: torch.Tensor, tau: torch.Tensor,
                                 flip: torch.Tensor, *,
                                 k_true: int) -> torch.Tensor:
    """K4, fused epilogue: packed GEMM + BN-sign fold + re-bitpack.

    ``tau``/``flip``: (N,) f32 folded BN.  Returns (M, ceil(N/32)) words,
    bit-identical to ``pack_bits(apply_bn_sign_folded(gemm_out))``.  Adds
    one to ``binary_matmul_bn_sign_packed.launches`` per kernel launch.
    """
    m, n, kw, dev, pa, pb = _operands(a_packed, b_packed)
    out = torch.empty((m, B.packed_width(n)), dtype=torch.int32, device=dev)
    lib = _build.load("xnor_gemm", _ENTRIES)
    err = lib.xnor_gemm_bn_sign(
        pa, pb, _build.require(tau, "tau", torch.float32, (n,), dev),
        _build.require(flip, "flip", torch.float32, (n,), dev),
        out.data_ptr(), m, n, kw, k_true, _build.stream_of(a_packed))
    _build.check(err, "xnor_gemm_bn_sign")
    binary_matmul_bn_sign_packed.launches += 1
    return out


binary_matmul_bn_sign_packed.launches = 0
