"""Packed binary 2-D convolution (paper C3-C6): plans and CUDA kernels.

* :func:`make_conv_plan` / :func:`make_bitplane_conv_plan` pack the conv
  weights per tap along channels (C3) and precompute the zero-padding
  correction (C5) or the bit-plane rowsum (C4).  Plans are built on the
  CPU in exact integer arithmetic and moved to the device afterwards.
* :func:`bitplane_conv2d_packed` (K1, ``csrc/bitplane_conv.cu``) is the
  first-layer conv on the raw uint8 image (no bit plane is built), and
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

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import binarize as B
from repro_torch.kernels import _build
from repro_torch.kernels import binary_matmul as _bmm
from repro_torch.kernels import smem as S

# csrc/conv_bn_sign.cu: K3 (fused epilogue) and K7 (int32 epilogue)
CONV_ENTRIES = {"conv_bn_sign": "pppppp" + "i" * 15 + "p",
                "binary_conv": "pppp" + "i" * 15 + "p",
                "conv_query": "i" * 7 + "pp"}
# csrc/bitplane_conv.cu: its two C entry points, and kTooLarge: no band
# and channel chunk of K1 fit one block's shared memory
BITPLANE_ENTRIES = {"bitplane_conv": "ppp" + "i" * 14 + "p",
                    "bitplane_conv_bn_sign": "ppppp" + "i" * 14 + "p",
                    "bitplane_conv_query": "i" * 15 + "pp"}
BITPLANE_TOO_LARGE = -1
# K3/K7's output tiles (csrc/conv_bn_sign.cu), (pixels, channels), chosen
# by shape (:func:`conv_tile`).
TILE_64X64, TILE_64X128 = 1, 2
CONV_RING = 2                 # csrc/conv_bn_sign.cu: the operand ring's stages
# csrc/bitplane_conv.cu: a block's threads, the fused instance's channel
# chunk, the output stage's row stride, the pixels a band aims at
K1_THREADS, K1_CHUNK, K1_STAGE_LD, K1_MIN_PIXELS = 128, 64, 72, 128


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


def _bitplane_operands(x_uint8, w_packed, rowsum, *, kh, kw, stride, pads,
                       out_hw, c_out, k_true, nbits):
    """Check the operands K1's two instances share; returns the launch's
    device and the pointers and sizes that lead their C entry points'
    arguments, and those that end them."""
    dev = _build.cuda_device(x_uint8, "x_uint8")
    bsz, h, w, c_x = x_uint8.shape
    if not 1 <= nbits <= 8:
        raise ValueError(f"the plan says {nbits} bits; the kernel takes 1 "
                         f"to 8")
    c_in, rem = divmod(k_true, kh * kw)
    if rem or c_in != c_x:
        raise ValueError(f"k_true {k_true} is not KH*KW*C_in for x_uint8's "
                         f"C_in {c_x}")
    cw = B.packed_width(c_in)
    _check_geometry(h, w, kh, kw, stride, pads, out_hw)
    _build.require(rowsum, "rowsum", torch.int32, (c_out,), dev)
    ptrs = (_build.require(x_uint8, "x_uint8", torch.uint8, x_uint8.shape,
                           dev),
            _build.require(w_packed, "w_packed", torch.int32,
                           (c_out, kh * kw * cw), dev))
    sizes = (bsz, h, w, cw, c_in, c_out, kh, kw, stride, pads[0][0],
             pads[1][0], *out_hw, nbits, _build.stream_of(x_uint8))
    return dev, ptrs, sizes


def _bitplane_terms(c_in, kh, kw, stride, ow, rows, chunk,
                    fused) -> tuple[S.SmemTerm, ...]:
    rows_b = (rows - 1) * stride + kh
    wb = (ow - 1) * stride + kw
    kpad = S.ceil_div(kh * kw * c_in, 32) * 32
    terms = [S.SmemTerm("output_stage", 4 * 16 * K1_STAGE_LD * 4),
             S.SmemTerm("chunk_weights", S.round16(chunk * (kpad + 16))),
             S.SmemTerm("depth_offsets", S.round16(kpad * 4)),
             S.SmemTerm("input_band", S.round16(rows_b * wb * c_in))]
    if fused:
        terms.append(S.SmemTerm("tau_flip", 2 * K1_CHUNK * 4))
    return tuple(terms)


@functools.lru_cache(maxsize=4096)
def bitplane_estimate(bsz: int, h: int, w: int, cw: int, c_in: int,
                      c_out: int, kh: int, kw: int, stride: int, pad_top: int,
                      pad_left: int, oh: int, ow: int, nbits: int,
                      fused: bool) -> S.LaunchEstimate:
    """K1's launch (``fused``: K1-fused) in the band of R output rows and
    the channel chunk its launcher's search (``csrc/bitplane_conv.cu``)
    takes: the largest chunk of 64, 32 (then 16, 8 for the int32
    instance), then the largest band from ceil(128 / OW) rows halving to
    1, that fits a block.  Where none fits, the smallest, which the
    launcher refuses.  The arguments are the launcher's query's, in its
    order; the band's bytes do not depend on ``h``, ``cw`` or
    ``nbits``."""
    chunks = (64, 32) if fused else (64, 32, 16, 8)
    bands, r = [], min(S.ceil_div(K1_MIN_PIXELS, ow), oh)
    while r >= 1:
        bands.append(r)
        r = r // 2 if r > 1 else 0
    for rows in bands:
        for chunk in chunks:
            terms = _bitplane_terms(c_in, kh, kw, stride, ow, rows, chunk,
                                    fused)
            if sum(t.bytes for t in terms) <= S.SMEM_BUDGET:
                break
        else:
            continue
        break
    return S.LaunchEstimate(
        "bitplane_conv_bn_sign" if fused else "bitplane_conv",
        f"band{rows}_chunk{chunk}", (S.ceil_div(oh, rows), bsz, 1),
        K1_THREADS, terms, ("bitplane_conv", "bitplane_conv_query",
                            (bsz, h, w, cw, c_in, c_out, kh, kw, stride,
                             pad_top, pad_left, oh, ow, nbits, int(fused))))


def _bitplane_check(err: int, what: str, sizes, fused: bool) -> None:
    """Raise for the error a K1 entry returned: ``SmemBudgetError`` where
    its search found no band and chunk that fit a block (nothing
    launched), with :func:`bitplane_estimate`'s breakdown."""
    if err == BITPLANE_TOO_LARGE:
        w, c_in, kh, kw = sizes[2], sizes[4], sizes[6], sizes[7]
        raise S.SmemBudgetError(
            bitplane_estimate(*sizes[:14], fused),
            detail=f"{what}: one output row's band ({kh} input rows of "
                   f"W={w} at C_in={c_in} bytes a pixel) and "
                   f"{32 if fused else 8} channels' weights of depth "
                   f"{kh * kw * c_in} exceed a block's shared memory")
    _build.check(err, what)


def bitplane_conv2d_packed(x_uint8: torch.Tensor, w_packed: torch.Tensor,
                           rowsum: torch.Tensor, *, kh: int, kw: int,
                           stride: int, pads, out_hw: tuple[int, int],
                           c_out: int, k_true: int,
                           nbits: int) -> torch.Tensor:
    """K1: first-layer fixed-precision conv (paper C4) in one launch.

    ``x_uint8``: (B, H, W, C_in) uint8, the raw image (C_in = k_true /
    (KH*KW)), ``w_packed``: (C_out, KH*KW*Cw), ``rowsum``: (C_out,) int32.
    Returns (B, OH, OW, C_out) int32, the exact integer conv of the
    image's low ``nbits`` bits against sign(W) with zero padding, equal to
    the plane-by-plane conv of ``binarize.pack_bitplanes_uint8(x_uint8,
    nbits)``.  The kernel reads the image's bytes and convolves them on
    the tensor cores, so no bit plane is built and it needs no rowsum; the
    wrapper still checks it, the plan's operand.  Raises
    ``SmemBudgetError`` (a ``ValueError``), before launching, for an input
    whose band of rows and 8 channels' weights exceed one block's shared
    memory.  Adds one to
    ``bitplane_conv2d_packed.launches`` per kernel launch.
    """
    dev, ptrs, sizes = _bitplane_operands(
        x_uint8, w_packed, rowsum, kh=kh, kw=kw, stride=stride, pads=pads,
        out_hw=out_hw, c_out=c_out, k_true=k_true, nbits=nbits)
    out = torch.empty((x_uint8.shape[0], *out_hw, c_out),
                      dtype=torch.int32, device=dev)
    lib = _build.load("bitplane_conv", BITPLANE_ENTRIES)
    err = lib.bitplane_conv(*ptrs, out.data_ptr(), *sizes)
    _bitplane_check(err, "bitplane_conv", sizes, False)
    bitplane_conv2d_packed.launches += 1
    return out


bitplane_conv2d_packed.launches = 0


def bitplane_conv2d_bn_sign_packed(x_uint8: torch.Tensor,
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
    never spans two), so it raises ``SmemBudgetError`` (a ``ValueError``)
    for an input whose band of rows and 32 channels' weights exceed one
    block's shared memory, before launching; nothing reroutes.  Adds one to
    ``bitplane_conv2d_bn_sign_packed.launches`` per kernel launch.
    """
    dev, ptrs, sizes = _bitplane_operands(
        x_uint8, w_packed, rowsum, kh=kh, kw=kw, stride=stride, pads=pads,
        out_hw=out_hw, c_out=c_out, k_true=k_true, nbits=nbits)
    out = torch.empty((x_uint8.shape[0], *out_hw, B.packed_width(c_out)),
                      dtype=torch.int32, device=dev)
    lib = _build.load("bitplane_conv", BITPLANE_ENTRIES)
    err = lib.bitplane_conv_bn_sign(
        *ptrs, _build.require(tau, "tau", torch.float32, (c_out,), dev),
        _build.require(flip, "flip", torch.float32, (c_out,), dev),
        out.data_ptr(), *sizes)
    _bitplane_check(err, "bitplane_conv_bn_sign", sizes, True)
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


@functools.lru_cache(maxsize=4096)
def conv_estimate(bsz: int, oh: int, ow: int, c_out: int, fused: bool,
                  vec16: bool, sms: int) -> S.LaunchEstimate:
    """K3's launch (``fused``) or K7's for a (B*OH*OW, C_out) output on a
    card of ``sms`` SMs, in the tile :func:`conv_tile` picks: the operand
    ring and a 16-byte row table a pixel of the tile."""
    m = bsz * oh * ow
    tile = conv_tile(m, c_out, sms)
    bn = 128 if tile == TILE_64X128 else 64
    terms = S.mma_ring(CONV_RING, 64, bn) + (S.SmemTerm("row_table",
                                                        64 * 16),)
    return S.LaunchEstimate(
        "conv_bn_sign" if fused else "binary_conv", f"64x{bn}",
        (S.ceil_div(m, 64), S.ceil_div(c_out, bn), 1), S.MMA_THREADS, terms,
        ("conv_bn_sign", "conv_query",
         (bsz, oh, ow, c_out, tile, int(vec16), int(fused))))


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
    lib = _build.load("conv_bn_sign", CONV_ENTRIES)
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
    lib = _build.load("conv_bn_sign", CONV_ENTRIES)
    err = lib.binary_conv(*ptrs, out.data_ptr(), bsz, h, w, cw, c_out, kh,
                          kw, stride, pads[0][0], pads[1][0], oh, ow, k_true,
                          *tile, _build.stream_of(x_packed))
    _build.check(err, "binary_conv")
    binary_conv2d_packed.launches += 1
    return out


binary_conv2d_packed.launches = 0
