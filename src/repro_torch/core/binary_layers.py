"""Binary layers (paper §5.2) as functions over dicts of tensors.

* ``init_*``          -> latent float weights (from a ``torch.Generator``)
* ``apply_*_float``   -> the float-sign reference path
* ``pack_*``          -> sign + bit-pack the weights once (C2), precompute
                         the padding correction (C5) and the folded BN
* ``apply_*_packed``  -> the packed path, through ``kernels.ops``
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import binarize as B
from repro_torch.kernels import binary_conv as bconv
from repro_torch.kernels import ops as kops

Params = dict[str, Any]


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1


# ---------------------------------------------------------------------------
# Dense (fully-connected) binary layer
# ---------------------------------------------------------------------------

def init_binary_dense(gen: torch.Generator, in_dim: int,
                      out_dim: int) -> Params:
    return {"w": _uniform(gen, (out_dim, in_dim))}


def _binarizer(ste: bool):
    return B.binarize_ste if ste else B.sign_pm1


def apply_binary_dense_float(params: Params, x: torch.Tensor, *,
                             ste: bool = False) -> torch.Tensor:
    """Reference: y = sign(x) . sign(W)^T.  The ±1 dot runs in float64,
    which is exact for these integers on any device (a float32 product
    may run in TF32), and returns float32.  ``ste=True`` puts the
    straight-through estimator on both operands (the training path,
    paper §4.4)."""
    binarize = _binarizer(ste)
    xb = binarize(x.to(torch.float32)).to(torch.float64)
    wb = binarize(params["w"]).to(torch.float64)
    return (xb @ wb.T).to(torch.float32)


def pack_binary_dense(params: Params) -> Params:
    """One-time weight packing (paper C2)."""
    w = params["w"]
    return {"w_packed": B.pack_bits(w), "k_true": w.shape[1]}


def apply_binary_dense_packed(packed: Params, x: torch.Tensor, *,
                              backend: str = "auto") -> torch.Tensor:
    """Pack sign(x) (K5 ``bitpack``), then the XNOR-popcount GEMM;
    (..., N) int32."""
    lead = x.shape[:-1]
    x_p = kops.bitpack(x.reshape(-1, x.shape[-1]), backend=backend)
    out = kops.binary_matmul_packed(x_p, packed["w_packed"],
                                    k_true=packed["k_true"], backend=backend)
    return out.reshape(*lead, -1)


def pack_binary_dense_grouped(params: Params, group: int) -> Params:
    """Weight packing for pre-packed activations with per-group padding.

    A packed conv activation flattens to (..., G*Cw) words, each group of
    ``Cw = ceil(group/32)`` words covering ``group`` channels of one pixel
    with zero-bit tails.  Packing W the same way keeps the tails zero on
    both operands, so they add no mismatches.
    """
    w = params["w"]
    out_dim, k = w.shape
    if k % group:
        raise ValueError(f"dense input {k} is not a multiple of {group}")
    w_packed = B.pack_bits(w.reshape(out_dim, k // group, group)
                           ).reshape(out_dim, -1)
    return {"w_packed": w_packed, "k_true": k, "group": group}


def apply_binary_dense_prepacked(packed: Params, x_packed: torch.Tensor, *,
                                 backend: str = "auto") -> torch.Tensor:
    """XNOR-popcount GEMM on an already packed activation; int32 out."""
    lead = x_packed.shape[:-1]
    x2 = x_packed.reshape(-1, x_packed.shape[-1]).contiguous()
    out = kops.binary_matmul_packed(x2, packed["w_packed"],
                                    k_true=packed["k_true"], backend=backend)
    return out.reshape(*lead, -1)


def apply_binary_dense_bn_packed(packed: Params, folded: Params,
                                 x_packed: torch.Tensor, *,
                                 backend: str = "auto") -> torch.Tensor:
    """Fused dense GEMM + BN-sign threshold + re-bitpack: packed in,
    packed out, (..., ceil(N/32)) words."""
    lead = x_packed.shape[:-1]
    x2 = x_packed.reshape(-1, x_packed.shape[-1]).contiguous()
    out = kops.binary_matmul_bn_sign_packed(
        x2, packed["w_packed"], folded["tau"], folded["flip"],
        k_true=packed["k_true"], backend=backend)
    return out.reshape(*lead, -1)


def apply_binary_dense_stack_packed(packed_layers: list, foldeds: list,
                                    x_packed: torch.Tensor, *,
                                    backend: str = "auto",
                                    resident: bool | None = None
                                    ) -> torch.Tensor:
    """The hidden dense stack, each layer GEMM + BN-sign + re-bitpack,
    chained without un-packed activations: one launch for the whole stack
    (K6) or one fused launch per layer, as ``resident`` says
    (``kernels.ops.binary_dense_stack_packed``)."""
    if len(packed_layers) != len(foldeds):
        raise ValueError(f"{len(packed_layers)} layers but {len(foldeds)} "
                         f"folded batch norms")
    stages = [{"w_packed": p["w_packed"], "k_true": p["k_true"],
               "tau": f["tau"], "flip": f["flip"]}
              for p, f in zip(packed_layers, foldeds)]
    lead = x_packed.shape[:-1]
    x2 = x_packed.reshape(-1, x_packed.shape[-1]).contiguous()
    out = kops.binary_dense_stack_packed(stages, x2, backend=backend,
                                         resident=resident)
    return out.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# First-layer bit-plane dense (paper §4.3 / C4)
# ---------------------------------------------------------------------------

def pack_bitplane_dense(params: Params, nbits: int = 8) -> Params:
    """Packed weights plus ``w_rowsum`` = sum of sign(W) per output, the
    correction of the {0,1} -> ±1 plane shift (paper eq. 3)."""
    w = params["w"]
    return {"w_packed": B.pack_bits(w), "k_true": w.shape[1],
            "w_rowsum": B.sign_pm1(w).sum(dim=1).to(torch.int32),
            "nbits": nbits}


def apply_bitplane_dense_packed(packed: Params, x_uint8: torch.Tensor, *,
                                backend: str = "auto") -> torch.Tensor:
    """First layer on fixed-precision input: (..., K) uint8 -> (..., N)
    int32 == x . sign(W)^T, exactly.

    The reference runs one ``bitpack`` + GEMM per bit plane.  Here the
    planes, as ±1 float32, stack along M: one ``bitpack`` over (nbits*M,
    K), one GEMM over (nbits*M, Kw) x (N, Kw), then
    y = 1/2 sum_i 2^i (d_i + rowsum) in int32 tensor ops: the same
    integers from the same two kernels in 2 launches instead of 2*nbits.
    The sum is even before the halving, so ``>> 1`` is exact.
    """
    nbits = packed["nbits"]
    lead = x_uint8.shape[:-1]
    x2 = x_uint8.reshape(-1, x_uint8.shape[-1])
    m = x2.shape[0]
    planes = B.bitplanes_uint8(x2, nbits)               # (nbits, M, K) {0,1}
    planes_pm1 = (2 * planes - 1).to(torch.float32).reshape(nbits * m, -1)
    x_p = kops.bitpack(planes_pm1, backend=backend)
    d = kops.binary_matmul_packed(x_p, packed["w_packed"],
                                  k_true=packed["k_true"], backend=backend)
    d = d.reshape(nbits, m, -1) + packed["w_rowsum"]
    shifts = torch.arange(nbits, dtype=torch.int32, device=d.device)
    out = (d << shifts[:, None, None]).sum(dim=0, dtype=torch.int32) >> 1
    return out.reshape(*lead, -1)


def apply_bitplane_dense_float(params: Params,
                               x_uint8: torch.Tensor) -> torch.Tensor:
    """Reference: the raw uint8 input against sign(W).  The dot runs in
    float64, exact on any device, and returns float32."""
    wb = B.sign_pm1(params["w"]).to(torch.float64)
    return (x_uint8.to(torch.float64) @ wb.T).to(torch.float32)


# ---------------------------------------------------------------------------
# Binary 2D convolution (paper C5/C6) and the bit-plane first layer (C4)
# ---------------------------------------------------------------------------

def init_binary_conv2d(gen: torch.Generator, kh: int, kw: int, c_in: int,
                       c_out: int) -> Params:
    return {"w": _uniform(gen, (c_out, kh, kw, c_in))}


def conv2d_float64(h: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                   padding: str = "SAME") -> torch.Tensor:
    """Correlation of (B, H, W, C) with (O, KH, KW, C), XLA's SAME/VALID
    pads, in float64: exact for integer-valued operands on any device (a
    float32 convolution may run in TF32), differentiable, returned as
    float32 (B, H', W', O)."""
    _, kh, kw, _ = w.shape
    _, pads = bconv.conv_geometry(tuple(h.shape[1:3]), kh, kw, stride,
                                  padding)
    (pt, pb), (pl, pr) = pads
    x = F.pad(h.to(torch.float64).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    z = F.conv2d(x, w.to(torch.float64).permute(0, 3, 1, 2), stride=stride)
    return z.permute(0, 2, 3, 1).to(torch.float32)


def apply_binary_conv2d_float(params: Params, x: torch.Tensor, *,
                              stride: int = 1, padding: str = "SAME",
                              ste: bool = False) -> torch.Tensor:
    """Reference: the convolution of sign(x) with sign(W), true zero
    padding (:func:`conv2d_float64`); ``ste=True`` is the training path."""
    binarize = _binarizer(ste)
    return conv2d_float64(binarize(x.to(torch.float32)),
                          binarize(params["w"]), stride=stride,
                          padding=padding)


def pack_binary_conv2d(params: Params, *, input_hw: tuple[int, int],
                       stride: int = 1, padding: str = "SAME") -> Params:
    """Per-tap channel packing (C3) + the correction matrix (C5), built by
    ``kernels.binary_conv.make_conv_plan``."""
    return bconv.make_conv_plan(params["w"], input_hw=input_hw,
                                stride=stride, padding=padding)


def apply_binary_conv2d_packed(packed: Params, x_packed: torch.Tensor, *,
                               backend: str = "auto") -> torch.Tensor:
    """Packed conv with in-kernel im2col -> XNOR popcount -> +correction:
    (B, H, W, Cw) words -> (B, H', W', C_out) int32."""
    return kops.binary_conv2d_packed(packed, x_packed, backend=backend)


def apply_binary_conv2d_bn_packed(packed: Params, folded: Params,
                                  x_packed: torch.Tensor, *,
                                  backend: str = "auto") -> torch.Tensor:
    """Fused conv + BN-sign threshold + re-bitpack: packed in, packed out,
    (B, H', W', ceil(C_out/32)) words."""
    return kops.binary_conv2d_bn_sign_packed(packed, folded, x_packed,
                                             backend=backend)


def localize_conv_plan(plan: Params, n_shards: int) -> Params:
    """One shard's view of a conv plan whose C_out axis is split
    ``n_shards`` ways (the C_out-parallel sharded forward).

    The tensors (``w_packed``, ``correction``, ``rowsum``) arrive already
    sliced by the placement (``distributed.sharding.shard_packed``); only
    the static ``c_out`` is rewritten to the local count.  ``k_true``,
    the geometry and ``cw`` are contraction-side statics and stay global:
    every shard consumes the full input.
    """
    if n_shards == 1:
        return plan
    c_out = plan["c_out"]
    if c_out % n_shards:
        raise ValueError(f"c_out {c_out} does not split {n_shards} ways")
    return {**plan, "c_out": c_out // n_shards}


def pack_bitplane_conv2d(params: Params, *, input_hw: tuple[int, int],
                         stride: int = 1, padding: str = "SAME",
                         nbits: int = 8) -> Params:
    """Conv plan of the fixed-precision first layer: per-tap packing plus
    the all-taps rowsum (``make_bitplane_conv_plan``)."""
    return bconv.make_bitplane_conv_plan(params["w"], input_hw=input_hw,
                                         stride=stride, padding=padding,
                                         nbits=nbits)


def apply_bitplane_conv2d_packed(packed: Params, x_uint8: torch.Tensor, *,
                                 backend: str = "auto") -> torch.Tensor:
    """First conv layer on raw uint8 input; (B, H', W', C_out) int32 ==
    the integer conv of the raw input against sign(W), zero padding."""
    return kops.bitplane_conv2d_packed(packed, x_uint8, backend=backend)


def apply_bitplane_conv2d_bn_packed(packed: Params, folded: Params,
                                    x_uint8: torch.Tensor, *,
                                    backend: str = "auto") -> torch.Tensor:
    """First conv layer on raw uint8 input with the BN-sign threshold and
    the re-bitpack fused in: (B, H', W', ceil(C_out/32)) words, one kernel
    launch on the card."""
    return kops.bitplane_conv2d_bn_sign_packed(packed, folded, x_uint8,
                                               backend=backend)


# ---------------------------------------------------------------------------
# Batch norm (inference) + sign, and the folded threshold form
# ---------------------------------------------------------------------------

def init_batchnorm(c: int) -> Params:
    return {"gamma": torch.ones(c), "beta": torch.zeros(c),
            "mean": torch.zeros(c), "var": torch.ones(c)}


def apply_batchnorm(params: Params, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    inv = params["gamma"] * torch.rsqrt(params["var"] + eps)
    return (x.to(torch.float32) - params["mean"]) * inv + params["beta"]


def fold_bn_sign(params: Params, eps: float = 1e-5) -> Params:
    """Fold BN + sign into a per-channel threshold compare:

    sign(gamma*(x-mu)/sigma + beta) == flip * sign(x - tau), with
    tau = mu - beta*sigma/gamma and flip = sign(gamma).  Computed in
    float32 in the reference's operation order, so tau matches it bit for
    bit.  PyTorch's vectorized float32 ``sqrt`` on the CPU is not always
    correctly rounded (it misses by an ulp about once in 200 draws), so
    sigma is taken in float64 and rounded once to float32, which is.
    """
    var_eps = (params["var"] + eps).to(torch.float64)
    sigma = torch.sqrt(var_eps).to(torch.float32)
    gamma = params["gamma"]
    tau = params["mean"] - params["beta"] * sigma / gamma
    flip = torch.where(gamma >= 0, 1.0, -1.0).to(torch.float32)
    return {"tau": tau, "flip": flip}


def apply_bn_sign_folded(folded: Params, x_int: torch.Tensor) -> torch.Tensor:
    """±1 output of sign(BN(x)) as a threshold compare on the raw output."""
    ge = x_int.to(torch.float32) >= folded["tau"]
    return torch.where(ge, 1.0, -1.0) * folded["flip"]


def apply_bn_sign_folded_packed(folded: Params, x_int: torch.Tensor, *,
                                backend: str = "auto") -> torch.Tensor:
    """Fused sign(BN(x)) + bit-pack along the channel axis (one kernel)."""
    return kops.bn_sign_pack(x_int, folded["tau"], folded["flip"],
                             backend=backend)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

def _pool_windows(x: torch.Tensor, window: int, stride: int):
    """The window taps of a VALID (B, H, W, C) pool, as strided views."""
    _, h, w, _ = x.shape
    oh = (h - window) // stride + 1
    ow = (w - window) // stride + 1
    return [x[:, di:di + (oh - 1) * stride + 1:stride,
              dj:dj + (ow - 1) * stride + 1:stride, :]
            for di in range(window) for dj in range(window)]


def maxpool2d(x: torch.Tensor, window: int = 2,
              stride: int | None = None) -> torch.Tensor:
    """VALID max pool over (B, H, W, C).  Integers: the elementwise max of
    the taps (works for int32 on every device).  Floats: ``max_pool2d``,
    whose gradient goes to the first maximum of a window in row-major
    order, as the reference's ``reduce_window`` max sends it (an
    elementwise max would split it between ties, and the float forward's
    pre-BN values are integers, so ties are common)."""
    stride = stride or window
    if x.is_floating_point():
        y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
        return y.permute(0, 2, 3, 1)
    taps = _pool_windows(x, window, stride)
    out = taps[0]
    for t in taps[1:]:
        out = torch.maximum(out, t)
    return out


def pool_flip_mask(folded: Params) -> torch.Tensor:
    """Packed per-channel mask of ``flip > 0`` for :func:`maxpool2d_packed`."""
    return B.pack_bits(folded["flip"])


def maxpool2d_packed(x_packed: torch.Tensor, flip_mask: torch.Tensor,
                     window: int = 2, stride: int | None = None
                     ) -> torch.Tensor:
    """Max pool in the packed bit domain.

    BN-sign is monotone per channel, so pooling the thresholded bits is
    OR where flip > 0 and AND where flip < 0: a select under the flip
    mask.  Zero-bit channel tails stay zero because the mask is zero there.
    """
    taps = _pool_windows(x_packed, window, stride or window)
    any_set, all_set = taps[0], taps[0]
    for t in taps[1:]:
        any_set = any_set | t
        all_set = all_set & t
    return (any_set & flip_mask) | (all_set & ~flip_mask)
