"""Packed binary 2-D convolution (paper C3-C6): plans and CUDA kernels.

* :func:`make_conv_plan` / :func:`make_bitplane_conv_plan` pack the conv
  weights per tap along channels (C3) and precompute the zero-padding
  correction (C5) or the bit-plane rowsum (C4).  Plans are built on the
  CPU in exact integer arithmetic and moved to the device afterwards.
* :func:`bitplane_conv2d_packed` (K1, ``csrc/bitplane_conv.cu``) is the
  first-layer conv over packed bit planes, and
  :func:`bitplane_conv2d_bn_sign_packed` the same kernel with K2's BN-sign
  epilogue fused in (packed words out); :func:`binary_conv2d_bn_sign_packed`
  (K3, ``csrc/conv_bn_sign.cu``) is the packed conv with the C5
  correction and the fused BN-sign repack, and :func:`binary_conv2d_packed`
  (K7, the same source with the epilogue switched off) the packed conv
  with an int32 output; both run it as an implicit GEMM on the 1-bit
  tensor cores, K4's main loop (``csrc/b1_mma.cuh``), in the tiles
  :func:`conv_tile` picks.  All of them do their im2col inside the kernel;
  padded taps read the word 0, i.e. all -1.

Each wrapper launches its kernel and takes CUDA tensors only;
``kernels/ops.py`` routes CPU tensors to the plain versions
(``kernels/ref.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import binarize as B
from repro_torch.kernels import _build
from repro_torch.kernels import binary_matmul as _bmm

# csrc/conv_bn_sign.cu: K3 (fused epilogue) and K7 (int32 epilogue)
_CONV_ENTRIES = {"conv_bn_sign": "pppppp" + "i" * 15 + "p",
                 "binary_conv": "pppp" + "i" * 15 + "p"}
# csrc/bitplane_conv.cu: its two C entry points, and kTooLarge: no band
# and channel chunk of K1 fit one block's shared memory
_BITPLANE_ENTRIES = {"bitplane_conv": "ppp" + "i" * 14 + "p",
                     "bitplane_conv_bn_sign": "ppppp" + "i" * 14 + "p"}
BITPLANE_TOO_LARGE = -1
# K3/K7's output tiles (csrc/conv_bn_sign.cu), (pixels, channels), chosen
# by shape (:func:`conv_tile`).
TILE_64X64, TILE_64X128 = 1, 2


def conv_geometry(input_hw: tuple[int, int], kh: int, kw: int, stride: int,
                  padding: str) -> tuple[tuple[int, int], tuple]:
    """Output spatial size and ((top, bottom), (left, right)) pads.

    XLA's SAME/VALID conventions: the extra pad of an odd total goes
    bottom/right.
    """
    h, w = input_hw
    if padding == "SAME":
        out_h = -(-h // stride)
        out_w = -(-w // stride)
        pad_h = max((out_h - 1) * stride + kh - h, 0)
        pad_w = max((out_w - 1) * stride + kw - w, 0)
        pads = ((pad_h // 2, pad_h - pad_h // 2),
                (pad_w // 2, pad_w - pad_w // 2))
    elif padding == "VALID":
        out_h = (h - kh) // stride + 1
        out_w = (w - kw) // stride + 1
        pads = ((0, 0), (0, 0))
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(
            f"conv output would be empty: input {input_hw}, kernel "
            f"({kh}, {kw}), stride {stride}, {padding} padding")
    return (out_h, out_w), pads


def make_conv_plan(w: torch.Tensor, *, input_hw: tuple[int, int],
                   stride: int = 1, padding: str = "SAME") -> dict:
    """Pack conv weights per tap along channels (C3) and precompute the
    zero-padding correction (C5) for the layer's input size.

    ``w``: (C_out, KH, KW, C_in) latent weights.  The packed kernels count
    a padded pixel as -1, so the true zero-pad result is
    ``packed_result + sum over padded taps of sum_c sign(w)``, computed
    here as a float64 correlation on the CPU (exact for these integers).
    Every tensor of the plan is on the CPU.
    """
    w = w.detach().to("cpu", torch.float32)
    c_out, kh, kw, c_in = w.shape
    wsign = B.sign_pm1(w)
    w_packed = B.pack_bits(wsign.reshape(c_out, kh * kw, c_in)
                           ).reshape(c_out, -1)
    (out_h, out_w), pads = conv_geometry(input_hw, kh, kw, stride, padding)
    h, wdt = input_hw
    (pt, pb), (pl, pr) = pads
    pad_mask = F.pad(torch.zeros((1, 1, h, wdt), dtype=torch.float64),
                     (pl, pr, pt, pb), value=1.0)
    w_tap_sum = wsign.sum(dim=3).to(torch.float64)[:, None]  # (O, 1, KH, KW)
    corr = F.conv2d(pad_mask, w_tap_sum, stride=stride)[0]   # (O, OH, OW)
    return {
        "w_packed": w_packed, "k_true": kh * kw * c_in,
        "kh": kh, "kw": kw, "c_in": c_in, "c_out": c_out,
        "cw": B.packed_width(c_in),
        "stride": stride, "pads": pads,
        "in_hw": (h, wdt), "out_hw": (out_h, out_w),
        "correction": corr.permute(1, 2, 0).round().to(torch.int32)
                          .contiguous(),
    }


def make_bitplane_conv_plan(w: torch.Tensor, *, input_hw: tuple[int, int],
                            stride: int = 1, padding: str = "SAME",
                            nbits: int = 8) -> dict:
    """Conv plan for the first-layer bit-plane conv (paper C4).

    The all-taps rowsum replaces both the {0,1} -> ±1 plane shift and the
    pad correction (a zero-padded pixel has every plane bit 0, i.e. -1),
    so the plan carries a rowsum and no correction.
    """
    plan = make_conv_plan(w, input_hw=input_hw, stride=stride,
                          padding=padding)
    wsign = B.sign_pm1(w.detach().to("cpu", torch.float32))
    plan["rowsum"] = wsign.sum(dim=(1, 2, 3)).to(torch.int32)
    del plan["correction"]
    plan["nbits"] = nbits
    return plan


def _check_geometry(h: int, w: int, kh: int, kw: int, stride: int, pads,
                    out_hw) -> None:
    (pt, pb), (pl, pr) = pads
    want = ((h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1)
    if tuple(out_hw) != want:
        raise ValueError(f"out_hw {tuple(out_hw)} does not match input "
                         f"({h}, {w}), kernel ({kh}, {kw}), stride {stride}, "
                         f"pads {pads}: expected {want}")


def _bitplane_operands(x_planes, w_packed, rowsum, *, kh, kw, stride, pads,
                       out_hw, c_out, k_true, nbits):
    """Check the operands K1's two instances share; returns the launch's
    device and the pointers and sizes that lead their C entry points'
    arguments, and those that end them."""
    dev = _build.cuda_device(x_planes, "x_planes")
    nb, bsz, h, w, cw = x_planes.shape
    if nb != nbits or not 1 <= nbits <= 8:
        raise ValueError(f"x_planes holds {nb} planes, plan says {nbits} "
                         f"(the kernel takes 1 to 8)")
    c_in, rem = divmod(k_true, kh * kw)
    if rem or not 32 * (cw - 1) < c_in <= 32 * cw:
        raise ValueError(f"k_true {k_true} is not KH*KW*C_in for a C_in "
                         f"packed into {cw} words")
    _check_geometry(h, w, kh, kw, stride, pads, out_hw)
    _build.require(rowsum, "rowsum", torch.int32, (c_out,), dev)
    ptrs = (_build.require(x_planes, "x_planes", torch.int32,
                           x_planes.shape, dev),
            _build.require(w_packed, "w_packed", torch.int32,
                           (c_out, kh * kw * cw), dev))
    sizes = (bsz, h, w, cw, c_in, c_out, kh, kw, stride, pads[0][0],
             pads[1][0], *out_hw, nbits, _build.stream_of(x_planes))
    return dev, ptrs, sizes


def _bitplane_check(err: int, what: str, *, kh, w, c_in, nbits, k_true,
                    chunk) -> None:
    if err == BITPLANE_TOO_LARGE:
        raise ValueError(
            f"{what}: one output row's band ({kh} input rows of W={w} at "
            f"C_in={c_in}, {nbits} planes) and {chunk} channels' weights of "
            f"depth {k_true} exceed a block's shared memory")
    _build.check(err, what)


def bitplane_conv2d_packed(x_planes: torch.Tensor, w_packed: torch.Tensor,
                           rowsum: torch.Tensor, *, kh: int, kw: int,
                           stride: int, pads, out_hw: tuple[int, int],
                           c_out: int, k_true: int,
                           nbits: int) -> torch.Tensor:
    """K1: first-layer fixed-precision conv (paper C4) in one launch.

    ``x_planes``: (nbits, B, H, W, Cw) packed bit planes
    (``binarize.pack_bitplanes_uint8``), ``w_packed``: (C_out, KH*KW*Cw),
    ``rowsum``: (C_out,) int32.  Returns (B, OH, OW, C_out) int32, the
    exact integer conv of the raw input against sign(W) with zero padding.
    The kernel decodes the planes to the raw values and convolves them on
    the tensor cores, so it needs no rowsum; the wrapper still checks it,
    the plan's operand.  Raises ``ValueError`` for an input whose band of
    rows and 8 channels' weights exceed one block's shared memory.  Adds
    one to ``bitplane_conv2d_packed.launches`` per kernel launch.
    """
    dev, ptrs, sizes = _bitplane_operands(
        x_planes, w_packed, rowsum, kh=kh, kw=kw, stride=stride, pads=pads,
        out_hw=out_hw, c_out=c_out, k_true=k_true, nbits=nbits)
    out = torch.empty((x_planes.shape[1], *out_hw, c_out),
                      dtype=torch.int32, device=dev)
    lib = _build.load("bitplane_conv", _BITPLANE_ENTRIES)
    err = lib.bitplane_conv(*ptrs, out.data_ptr(), *sizes)
    _bitplane_check(err, "bitplane_conv", kh=kh, w=x_planes.shape[3],
                    c_in=sizes[4], nbits=nbits, k_true=k_true, chunk=8)
    bitplane_conv2d_packed.launches += 1
    return out


bitplane_conv2d_packed.launches = 0


def bitplane_conv2d_bn_sign_packed(x_planes: torch.Tensor,
                                   w_packed: torch.Tensor,
                                   rowsum: torch.Tensor, tau: torch.Tensor,
                                   flip: torch.Tensor, *, kh: int, kw: int,
                                   stride: int, pads,
                                   out_hw: tuple[int, int], c_out: int,
                                   k_true: int, nbits: int) -> torch.Tensor:
    """K1 with K2's epilogue fused in: the first-layer conv, BN-sign fold
    and re-bitpack in one launch (``csrc/bitplane_conv.cu``'s fused
    instance).

    Operands as :func:`bitplane_conv2d_packed`, plus ``tau``/``flip``:
    (C_out,) f32.  Returns (B, OH, OW, ceil(C_out/32)) words,
    bit-identical to ``bn_sign_pack`` of :func:`bitplane_conv2d_packed`'s
    output.  The kernel takes channel chunks of 64 or 32 only (a word
    never spans two), so it raises ``ValueError`` for an input whose band
    of rows and 32 channels' weights exceed one block's shared memory;
    nothing reroutes.  Adds one to
    ``bitplane_conv2d_bn_sign_packed.launches`` per kernel launch.
    """
    dev, ptrs, sizes = _bitplane_operands(
        x_planes, w_packed, rowsum, kh=kh, kw=kw, stride=stride, pads=pads,
        out_hw=out_hw, c_out=c_out, k_true=k_true, nbits=nbits)
    out = torch.empty((x_planes.shape[1], *out_hw, B.packed_width(c_out)),
                      dtype=torch.int32, device=dev)
    lib = _build.load("bitplane_conv", _BITPLANE_ENTRIES)
    err = lib.bitplane_conv_bn_sign(
        *ptrs, _build.require(tau, "tau", torch.float32, (c_out,), dev),
        _build.require(flip, "flip", torch.float32, (c_out,), dev),
        out.data_ptr(), *sizes)
    _bitplane_check(err, "bitplane_conv_bn_sign", kh=kh,
                    w=x_planes.shape[3], c_in=sizes[4], nbits=nbits,
                    k_true=k_true, chunk=32)
    bitplane_conv2d_bn_sign_packed.launches += 1
    return out


bitplane_conv2d_bn_sign_packed.launches = 0


def conv_tile(m: int, n: int, sms: int) -> int:
    """K3/K7's tile for an (M, N) = (B*OH*OW, C_out) output on a card of
    ``sms`` SMs: 64 x 128 where that grid gives every SM a block, else
    64 x 64.  On the H100 64 x 128 was the faster at every BCNN stage at
    batch 256 and 64 x 64 at batch 1, where the grid is small (PERF.md,
    ``chip_conv_tiles.py``)."""
    if _bmm.fills_card(m, n, (64, 128), sms):
        return TILE_64X128
    return TILE_64X64


def _conv_operands(x_packed, w_packed, correction, *, kh, kw, stride, pads,
                   out_hw, c_out):
    """Check the operands K3 and K7 share; returns the launch's device,
    input sizes, operand pointers, and its tile (:func:`conv_tile`) and
    copy width (16-byte copies where the rows of x and w_packed start on
    16 bytes)."""
    dev = _build.cuda_device(x_packed, "x_packed")
    bsz, h, w, cw = x_packed.shape
    _check_geometry(h, w, kh, kw, stride, pads, out_hw)
    ptrs = (_build.require(x_packed, "x_packed", torch.int32,
                           x_packed.shape, dev),
            _build.require(w_packed, "w_packed", torch.int32,
                           (c_out, kh * kw * cw), dev),
            _build.require(correction, "correction", torch.int32,
                           (*out_hw, c_out), dev))
    tile = conv_tile(bsz * out_hw[0] * out_hw[1], c_out, _bmm.sm_count(dev))
    vec16 = int(_bmm.rows_aligned16((ptrs[0], cw), (ptrs[1], kh * kw * cw)))
    return dev, (bsz, h, w, cw), ptrs, (tile, vec16)


def binary_conv2d_bn_sign_packed(x_packed: torch.Tensor,
                                 w_packed: torch.Tensor,
                                 correction: torch.Tensor, tau: torch.Tensor,
                                 flip: torch.Tensor, *, kh: int, kw: int,
                                 stride: int, pads, out_hw: tuple[int, int],
                                 c_out: int, k_true: int) -> torch.Tensor:
    """K3: fused conv + C5 correction + BN-sign fold + re-bitpack.

    ``x_packed``: (B, H, W, Cw) channel-packed words, ``correction``:
    (OH, OW, C_out) int32, ``tau``/``flip``: (C_out,) f32.  Returns
    (B, OH, OW, ceil(C_out/32)) words, bit-identical to
    ``pack_bits(apply_bn_sign_folded(conv_out))``.  Adds one to
    ``binary_conv2d_bn_sign_packed.launches`` per kernel launch.
    """
    dev, (bsz, h, w, cw), ptrs, tile = _conv_operands(
        x_packed, w_packed, correction, kh=kh, kw=kw, stride=stride,
        pads=pads, out_hw=out_hw, c_out=c_out)
    oh, ow = out_hw
    out = torch.empty((bsz, oh, ow, B.packed_width(c_out)),
                      dtype=torch.int32, device=dev)
    lib = _build.load("conv_bn_sign", _CONV_ENTRIES)
    err = lib.conv_bn_sign(
        *ptrs, _build.require(tau, "tau", torch.float32, (c_out,), dev),
        _build.require(flip, "flip", torch.float32, (c_out,), dev),
        out.data_ptr(), bsz, h, w, cw, c_out, kh, kw, stride, pads[0][0],
        pads[1][0], oh, ow, k_true, *tile, _build.stream_of(x_packed))
    _build.check(err, "conv_bn_sign")
    binary_conv2d_bn_sign_packed.launches += 1
    return out


binary_conv2d_bn_sign_packed.launches = 0


def binary_conv2d_packed(x_packed: torch.Tensor, w_packed: torch.Tensor,
                         correction: torch.Tensor, *, kh: int, kw: int,
                         stride: int, pads, out_hw: tuple[int, int],
                         c_out: int, k_true: int) -> torch.Tensor:
    """K7: packed conv + C5 correction with an int32 output.

    ``x_packed``: (B, H, W, Cw) channel-packed words, ``correction``:
    (OH, OW, C_out) int32.  Returns (B, OH, OW, C_out) int32, the exact
    integer conv of the ±1 tensors with true zero padding.  Adds one to
    ``binary_conv2d_packed.launches`` per kernel launch.
    """
    dev, (bsz, h, w, cw), ptrs, tile = _conv_operands(
        x_packed, w_packed, correction, kh=kh, kw=kw, stride=stride,
        pads=pads, out_hw=out_hw, c_out=c_out)
    oh, ow = out_hw
    out = torch.empty((bsz, oh, ow, c_out), dtype=torch.int32, device=dev)
    lib = _build.load("conv_bn_sign", _CONV_ENTRIES)
    err = lib.binary_conv(*ptrs, out.data_ptr(), bsz, h, w, cw, c_out, kh,
                          kw, stride, pads[0][0], pads[1][0], oh, ow, k_true,
                          *tile, _build.stream_of(x_packed))
    _build.check(err, "binary_conv")
    binary_conv2d_packed.launches += 1
    return out


binary_conv2d_packed.launches = 0
