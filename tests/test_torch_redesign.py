"""The arithmetic of the tensor-core K1 and K4 kernels against the JAX
reference, on the CPU.

``csrc/xnor_gemm.cu`` and ``csrc/bitplane_conv.cu`` run only on a card;
these tests repeat, in numpy, the integer steps those kernels take (K4's
1-bit m16n8k256 fragments and its popc(a) + popc(b) - 2 popc(a & b)
identity, the fused epilogue's 32-column words; K1's band and
depth-offset indexing, at the full band and at the smaller bands it
falls back to, and its u8 x s8 m16n8k32 fragments) and hold the result
to ``repro.kernels.ops`` with ``backend="jnp"``.  Every comparison is
exact.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as JB
from repro.kernels import binary_conv as JBC
from repro.kernels import ops as JOPS
from repro_torch import convert as CV
from repro_torch.kernels import binary_conv as TBC
from repro_torch.kernels import binary_matmul as TBM

BK = 32                 # csrc/b1_mma.cuh: kBK, words per stage


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _words(rng, shape):
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    return np.asarray(JB.pack_bits(jnp.asarray(x)))


def _bn(rng, c, k):
    tau = rng.integers(-k, k + 1, c).astype(np.float32)
    tau += 0.5 * (rng.random(c) < 0.5)
    flip = np.where(rng.random(c) < 0.3, -1.0, 1.0).astype(np.float32)
    return tau, flip


# ---------------------------------------------------------------------------
# K4: xnor_gemm.cu's tensor-core route, 1-bit MMA
# ---------------------------------------------------------------------------

def popc(x):
    """Population count of each uint32 element."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    return np.unpackbits(x.view(np.uint8).reshape(*x.shape, 4),
                         axis=-1).sum(-1).astype(np.int64)


def b1_tile(a_words, b_words):
    """One mma.sync.m16n8k256.b1.and.popc step as the kernel feeds it:
    lane (g, t) gives words t and t+4 of A rows g and g+8 and of B column
    g; the PTX layout puts register r's 32 bits at K columns 32t.. (r = 0,
    1) or 128 + 32t.. (r = 2, 3).  Returns the (16, 8) popc(a & b) sums
    read back from the C fragments."""
    a_k = np.zeros((16, 256), np.int64)
    b_k = np.zeros((256, 8), np.int64)
    bit = np.arange(32, dtype=np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        regs = {(g, 0): a_words[g, t], (g + 8, 0): a_words[g + 8, t],
                (g, 128): a_words[g, t + 4], (g + 8, 128): a_words[g + 8, t + 4]}
        for (row, base), w in regs.items():
            a_k[row, base + 32 * t:base + 32 * t + 32] = (w >> bit) & 1
        b_k[32 * t:32 * t + 32, g] = (b_words[g, t] >> bit) & 1
        b_k[128 + 32 * t:160 + 32 * t, g] = (b_words[g, t + 4] >> bit) & 1
    d = a_k @ b_k
    out = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        out[g, 2 * t:2 * t + 2] = d[g, 2 * t:2 * t + 2]
        out[g + 8, 2 * t:2 * t + 2] = d[g + 8, 2 * t:2 * t + 2]
    return out


def b1_gemm(a, b, k_true):
    """The 1-bit route's int32 result: words zero-filled to whole stages,
    popc(a & b) summed per 8-word step, each thread's share of the row
    popcounts (words t and t+4) summed over the four threads of a group,
    then k_true - 2 (popc(a) + popc(b) - 2 popc(a & b))."""
    kw = a.shape[1]
    kw_iter = -(-kw // BK) * BK
    a = np.pad(a, ((0, 0), (0, kw_iter - kw)))
    b = np.pad(b, ((0, 0), (0, kw_iter - kw)))
    and_ = sum(popc(a[:, None, k] & b[None, :, k]) for k in range(kw_iter))
    steps = a.reshape(a.shape[0], -1, 8)
    pa = sum(popc(steps[:, :, t]) + popc(steps[:, :, t + 4])
             for t in range(4)).sum(1)
    steps = b.reshape(b.shape[0], -1, 8)
    pb = sum(popc(steps[:, :, t]) + popc(steps[:, :, t + 4])
             for t in range(4)).sum(1)
    return (k_true - 2 * (pa[:, None] + pb[None, :] - 2 * and_)).astype(
        np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b1_fragment_layout_matches_jnp(seed):
    rng = _rng("b1-frag", seed)
    a, b = _words(rng, (16, 256)), _words(rng, (8, 256))
    mism = JOPS.binary_matmul_packed(jnp.asarray(a), jnp.asarray(b),
                                     k_true=256, backend="jnp")
    # popc(a ^ b) = (256 - y) / 2 = popc(a) + popc(b) - 2 popc(a & b)
    want = (popc(a).sum(1)[:, None] + popc(b).sum(1)[None, :]
            - (256 - np.asarray(mism)) // 2) // 2
    np.testing.assert_array_equal(b1_tile(a, b), want)


@pytest.mark.parametrize("k", [1, 31, 33, 70, 1000, 3584])
@pytest.mark.parametrize("m,n", [(1, 10), (17, 40), (5, 136)])
def test_b1_route_arithmetic_matches_jnp(m, n, k):
    rng = _rng("b1", m, n, k)
    a, b = _words(rng, (m, k)), _words(rng, (n, k))
    tau, flip = _bn(rng, n, k)
    y = b1_gemm(a, b, k)
    np.testing.assert_array_equal(y, np.asarray(JOPS.binary_matmul_packed(
        jnp.asarray(a), jnp.asarray(b), k_true=k, backend="jnp")))
    np.testing.assert_array_equal(
        fused_words(y, tau, flip), np.asarray(
            JOPS.binary_matmul_bn_sign_packed(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(tau),
                jnp.asarray(flip), k_true=k, backend="jnp")))


def fused_words(y, tau, flip, warp_cols=32):
    """The fused epilogue: each thread sets the bits of its columns of a
    32-column group, four threads OR them (the two shuffles); columns past
    N give bit 0."""
    m, n = y.shape
    groups = -(-n // 32)
    out = np.zeros((m, groups), np.uint32)
    for w in range(groups):
        for t in range(4):
            bits = np.zeros(m, np.uint32)
            for jj in range(4):
                for e in range(2):
                    col = jj * 8 + 2 * t + e
                    c = 32 * w + col
                    if c < n:
                        bit = (y[:, c].astype(np.float32) >= tau[c]) == \
                            (flip[c] > 0)
                        bits |= bit.astype(np.uint32) << np.uint32(col)
            out[:, w] |= bits
    return out


def test_gemm_route_by_shape():
    sms = 132
    assert TBM.gemm_route(1, 256000, sms) == TBM.ROUTE_SMALL
    assert TBM.gemm_route(TBM.SMALL_M_MAX, 3584, sms) == TBM.ROUTE_SMALL
    assert TBM.gemm_route(TBM.SMALL_M_MAX + 1, 3584, sms) == \
        TBM.ROUTE_MMA_64
    assert TBM.gemm_route(128, 3584, sms) == TBM.ROUTE_MMA_64
    assert TBM.gemm_route(4608, 3584, sms) == TBM.ROUTE_MMA_128
    assert TBM.gemm_route(8192, 8192, sms) == TBM.ROUTE_MMA_128
    assert TBM.rows_aligned16((256, 112), (4096, 8))
    assert not TBM.rows_aligned16((256, 112), (4100, 8))
    assert not TBM.rows_aligned16((256, 25))


# ---------------------------------------------------------------------------
# K1: bitplane_conv.cu
# ---------------------------------------------------------------------------

MIN_BAND_PIXELS = 128   # csrc/bitplane_conv.cu: kMinBandPixels


def u8s8_tile(xs, base, off, ws):
    """One mma.sync.m16n8k32.u8.s8.s32 step as K1 feeds it: lane (g, t)
    gathers four band bytes per A register (``gather4``) for pixels g and
    g+8 at depths 4t.. and 4t+16.., and takes its B registers from weight
    row g at the same depths.  The PTX layout puts A register r at row g
    (r = 0, 2) or g+8 (r = 1, 3), columns 4t.. (r < 2) or 4t+16..; B
    register r at rows 4t.. or 4t+16.., column g.  Returns the (16, 8)
    result read back from the C fragments (c0, c1: row g, columns 2t and
    2t+1; c2, c3: row g+8)."""
    a_k = np.zeros((16, 32), np.int64)
    b_k = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        o_lo, o_hi = off[4 * t:4 * t + 4], off[4 * t + 16:4 * t + 20]
        # the kernel's registers: a0..a3 = gather4 at (g, lo), (g+8, lo),
        # (g, hi), (g+8, hi); b0, b1 = weight row g at 4t.., 4t+16..
        a_regs = [xs[base[g] + o_lo], xs[base[g + 8] + o_lo],
                  xs[base[g] + o_hi], xs[base[g + 8] + o_hi]]
        b_regs = [ws[g, 4 * t:4 * t + 4], ws[g, 4 * t + 16:4 * t + 20]]
        # where the PTX layout places each register's four bytes
        for r, (row, col) in enumerate(((g, 4 * t), (g + 8, 4 * t),
                                        (g, 4 * t + 16),
                                        (g + 8, 4 * t + 16))):
            a_k[row, col:col + 4] = a_regs[r]
        for r, k in enumerate((4 * t, 4 * t + 16)):
            b_k[k:k + 4, g] = b_regs[r]
    d = a_k @ b_k
    out = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        out[g, 2 * t:2 * t + 2] = d[g, 2 * t:2 * t + 2]
        out[g + 8, 2 * t:2 * t + 2] = d[g + 8, 2 * t:2 * t + 2]
    return out


def band_conv(x_uint8, w_packed, *, c_in, c_out, kh, kw, stride, pads,
              out_hw, nbits, r_band=None, fragments=False):
    """The kernel's indexing in numpy: per band of R output rows (the
    kernel's full band, or the ``r_band`` it falls back to when shared
    memory is short), the image's bytes copied into a zero-padded band
    [row][col][c] (byte i of band row rb is byte i - pad_left * C_in of
    image row rb + the band's first, or 0 where either is outside the
    image), each masked to its low ``nbits`` bits; the depth -> offset
    table, A gathered at pixel base + offset, B the +-1 weights
    [channel][tap*C_in + c], 0 past K.  The dot is one exact integer
    product, or with ``fragments`` the kernel's 16-pixel x 8-channel
    tiles, one :func:`u8s8_tile` per 32 depths, pixels past the band at
    base 0 and channels past C_out on zero weights."""
    img = np.asarray(x_uint8, np.uint8) & np.uint8((1 << nbits) - 1)
    wp = CV.words_to_numpy(w_packed)
    bsz, h, wd, _ = img.shape
    cw = wp.shape[1] // (kh * kw)
    oh, ow = out_hw
    pt, pl = pads[0][0], pads[1][0]
    if r_band is None:
        r_band = min(-(-MIN_BAND_PIXELS // ow), oh)
    rows_b = (r_band - 1) * stride + kh
    wb = (ow - 1) * stride + kw
    row_bytes, lead, img_bytes = wb * c_in, pl * c_in, wd * c_in
    i = np.arange(rows_b * row_bytes)
    rb, o = i // row_bytes, i % row_bytes - lead
    k = kh * kw * c_in
    kpad = -(-k // 32) * 32
    d = np.arange(kpad)
    tap, c = d // c_in, d % c_in
    off = np.where(d < k, ((tap // kw) * wb + tap % kw) * c_in + c, 0)
    wbits = (wp.reshape(c_out, kh * kw, cw)[:, tap[:k], c[:k] // 32]
             >> (c[:k] % 32)) & 1
    npad = -(-c_out // 8) * 8
    ws = np.zeros((npad, kpad), np.int64)
    ws[:c_out, :k] = np.where(wbits, 1, -1)
    out = np.zeros((bsz, oh, ow, c_out), np.int64)
    for b in range(bsz):
        for oh0 in range(0, oh, r_band):
            ih = oh0 * stride - pt + rb
            inside = (ih >= 0) & (ih < h) & (o >= 0) & (o < img_bytes)
            rows = img[b].reshape(h, img_bytes)
            xs = np.where(inside, rows[np.clip(ih, 0, h - 1),
                                       np.clip(o, 0, img_bytes - 1)],
                          0).astype(np.int64)
            n_px = min(r_band, oh - oh0) * ow
            p = np.arange(-(-n_px // 16) * 16)
            base = np.where(p < n_px, ((p // ow) * stride * wb
                                       + (p % ow) * stride) * c_in, 0)
            if fragments:
                y = np.zeros((len(p), npad), np.int64)
                for m0 in range(0, len(p), 16):
                    for n0 in range(0, npad, 8):
                        for k0 in range(0, kpad, 32):
                            y[m0:m0 + 16, n0:n0 + 8] += u8s8_tile(
                                xs, base[m0:m0 + 16], off[k0:k0 + 32],
                                ws[n0:n0 + 8, k0:k0 + 32])
            else:
                y = xs[base[:, None] + off[None, :]] @ ws.T
            out[b, oh0:oh0 + n_px // ow] = y[:n_px, :c_out].reshape(
                -1, ow, c_out)
    return out.astype(np.int32)


def _band_case(key, hw, c_in, c_out, stride, padding, nbits, **kw):
    """K1's numpy model and the reference on one seeded input, over all 256
    values: the bits above nbits are set, which both must ignore."""
    rng = _rng(*key, hw, c_in, c_out, stride, padding, nbits)
    w = rng.uniform(-1, 1, (c_out, 3, 3, c_in)).astype(np.float32)
    x = rng.integers(0, 256, (2, *hw, c_in), dtype=np.uint8)
    jplan = JBC.make_bitplane_conv_plan(jnp.asarray(w), input_hw=hw,
                                        stride=stride, padding=padding,
                                        nbits=nbits)
    want = JOPS.bitplane_conv2d_packed(jplan, jnp.asarray(x), backend="jnp")
    tplan = TBC.make_bitplane_conv_plan(torch.from_numpy(w), input_hw=hw,
                                        stride=stride, padding=padding,
                                        nbits=nbits)
    got = band_conv(x, tplan["w_packed"], c_in=c_in, c_out=c_out,
                    kh=3, kw=3, stride=stride, pads=tplan["pads"],
                    out_hw=tplan["out_hw"], nbits=nbits, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("nbits", [1, 4, 8])
@pytest.mark.parametrize("hw,c_in,c_out,stride,padding", [
    ((9, 9), 3, 40, 1, "SAME"), ((9, 7), 3, 10, 2, "VALID"),
    ((7, 7), 33, 24, 2, "SAME"), ((6, 8), 33, 72, 1, "VALID")])
def test_band_conv_matches_jnp(hw, c_in, c_out, stride, padding, nbits):
    _band_case(("band",), hw, c_in, c_out, stride, padding, nbits)


# The smaller bands the kernel takes where the full one and a chunk of
# channels' weights would not fit a block's shared memory.
@pytest.mark.parametrize("r_band", [1, 2])
@pytest.mark.parametrize("hw,c_in,c_out,stride,padding,nbits", [
    ((9, 9), 3, 40, 1, "SAME", 8), ((7, 7), 33, 24, 2, "SAME", 4),
    ((6, 8), 33, 72, 1, "VALID", 1)])
def test_band_conv_smaller_bands_match_jnp(hw, c_in, c_out, stride, padding,
                                           nbits, r_band):
    _band_case(("small band", r_band), hw, c_in, c_out, stride, padding,
               nbits, r_band=r_band)


# K1's tensor-core tiles: one whole tile (4 x 4 SAME, 16 pixels, 8
# channels, 27 deep), ragged pixels and channels, ten 32-deep steps, nine
# channel tiles.
@pytest.mark.parametrize("hw,c_in,c_out,stride,padding,nbits", [
    ((4, 4), 3, 8, 1, "SAME", 8), ((9, 7), 3, 10, 2, "SAME", 4),
    ((5, 5), 33, 16, 1, "SAME", 1), ((6, 8), 33, 72, 2, "VALID", 8)])
def test_u8s8_fragments_match_jnp(hw, c_in, c_out, stride, padding, nbits):
    _band_case(("fragments",), hw, c_in, c_out, stride, padding, nbits,
               fragments=True)
