"""The arithmetic of the tensor-core K3 and K7 kernels against the JAX
reference, on the CPU.

``csrc/conv_bn_sign.cu`` runs only on a card; these tests repeat, in
numpy, the integer steps it takes and hold the result to
``repro.kernels.ops`` with ``backend="jnp"``:

* the row table: output pixel m = (b*OH + oh)*OW + ow of a tile -> its
  image and the input position of tap (0, 0), rows past M out of reach;
* the im2col copies of each 32-word depth chunk: depth kk -> (di, dj, c)
  -> the input word, zero in the halo, past M and past Kw, as 16-byte
  (Cw % 4 == 0) or 4-byte copies, each slot of the tile copied once;
* the m16n8k256 fragments, the and-popc identity
  popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b) over the k256 steps up
  to Kw, the correction row m % (OH*OW), and K3's 32-channel words.

Every comparison is exact.
"""
import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import binary_conv as JBC
from repro.kernels import ops as JOPS
from repro_torch.kernels import binary_conv as TBC

BK = 32                  # csrc/b1_mma.cuh: kBK, words per depth chunk
THREADS = 128            # kMmaThreads
TILES = {TBC.TILE_64X64: (64, 64), TBC.TILE_64X128: (64, 128)}
NO_ROW = -(2 ** 31) // 2  # csrc/conv_bn_sign.cu: kNoRow


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def popc(x):
    """Population count of each uint32 element."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    return np.unpackbits(x.view(np.uint8).reshape(*x.shape, 4),
                         axis=-1).sum(-1).astype(np.int64)


def _words(rng, shape):
    """Random channel-packed words of ``shape`` (..., C) with zero tails,
    bit i of word j = channel 32 j + i."""
    c = shape[-1]
    bits = np.zeros((*shape[:-1], -(-c // 32) * 32), bool)
    bits[..., :c] = rng.random(shape) < 0.5
    return np.packbits(bits, axis=-1, bitorder="little").view("<u4")


# ---------------------------------------------------------------------------
# The kernel's steps
# ---------------------------------------------------------------------------

def row_table(m0, bm, m_total, out_hw, stride, pads):
    """The block's RowInfo: image, ih0, iw0 of rows m0.. m0 + bm."""
    oh, ow = out_hw
    pix = oh * ow
    m = m0 + np.arange(bm)
    valid = m < m_total
    p = m % pix
    o_h = p // ow
    return (np.where(valid, m // pix, 0),
            np.where(valid, o_h * stride - pads[0][0], NO_ROW),
            np.where(valid, (p - o_h * ow) * stride - pads[1][0], NO_ROW))


def copy_slots(rows, vec16):
    """The (row, copy) pairs load_im2col's loops give its threads."""
    per_row = BK // 4 if vec16 else BK
    return [(r, tid % per_row) for tid in range(THREADS)
            for r in range(tid // per_row, rows, THREADS // per_row)]


def im2col_chunk(x, rows, kh, kw, k0, vec16):
    """One depth chunk of the A tile as load_im2col stages it: copy q
    takes ``words`` words at depth kk = k0 + q * words, decoded to
    (di, dj, c); a row reads them at (ih0 + di, iw0 + dj), or 0."""
    b, ih0, iw0 = rows
    _, h, w, cw = x.shape
    per_row = BK // 4 if vec16 else BK
    words = BK // per_row
    tile = np.zeros((len(b), BK), np.uint32)
    for q in range(per_row):
        kk = k0 + q * words
        if kk >= kh * kw * cw:
            continue
        tap = kk // cw
        c = kk - tap * cw
        di = tap // kw
        dj = tap - di * kw
        assert c + words <= cw, "a 16-byte copy must stay in one tap"
        ih, iw = ih0 + di, iw0 + dj
        inb = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
        tile[inb, q * words:(q + 1) * words] = x[b[inb], ih[inb], iw[inb],
                                                 c:c + words]
    return tile


def weight_chunk(w_packed, n0, bn, k0):
    """load_tile of the B operand: rows n0.., words k0.., zero outside."""
    n, kw_words = w_packed.shape
    tile = np.zeros((bn, BK), np.uint32)
    rows = w_packed[n0:n0 + bn, k0:k0 + BK]
    tile[:rows.shape[0], :rows.shape[1]] = rows
    return tile


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
        for row in (g, g + 8):
            a_k[row, 32 * t:32 * t + 32] = (a_words[row, t] >> bit) & 1
            a_k[row, 128 + 32 * t:160 + 32 * t] = \
                (a_words[row, t + 4] >> bit) & 1
        b_k[32 * t:32 * t + 32, g] = (b_words[g, t] >> bit) & 1
        b_k[128 + 32 * t:160 + 32 * t, g] = (b_words[g, t + 4] >> bit) & 1
    d = a_k @ b_k
    out = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        out[g, 2 * t:2 * t + 2] = d[g, 2 * t:2 * t + 2]
        out[g + 8, 2 * t:2 * t + 2] = d[g + 8, 2 * t:2 * t + 2]
    return out


def conv_mma(x, w_packed, corr, *, kh, kw, stride, pads, out_hw, c_out,
             k_true, tile, vec16, fragments=False):
    """conv_mma_kernel in numpy: (M, C_out) int64 y per output tile, over
    the ring's depth chunks and the k256 steps below Kw; with
    ``fragments`` each 16 x 8 MMA through :func:`b1_tile`."""
    bsz = x.shape[0]
    oh, ow = out_hw
    m_total, kw_words = bsz * oh * ow, w_packed.shape[1]
    bm, bn = TILES[tile]
    corr = corr.reshape(oh * ow, c_out).astype(np.int64)
    y = np.zeros((m_total, c_out), np.int64)
    for m0 in range(0, m_total, bm):
        rows = row_table(m0, bm, m_total, out_hw, stride, pads)
        for n0 in range(0, c_out, bn):
            acc = np.zeros((bm, bn), np.int64)
            pa = np.zeros(bm, np.int64)
            pb = np.zeros(bn, np.int64)
            for k0 in range(0, kw_words, BK):
                a = im2col_chunk(x, rows, kh, kw, k0, vec16)
                b = weight_chunk(w_packed, n0, bn, k0)
                for k8 in range(0, BK, 8):
                    if k0 + k8 >= kw_words:
                        continue
                    a8, b8 = a[:, k8:k8 + 8], b[:, k8:k8 + 8]
                    if fragments:
                        for i in range(0, bm, 16):
                            for j in range(0, bn, 8):
                                acc[i:i + 16, j:j + 8] += b1_tile(
                                    a8[i:i + 16], b8[j:j + 8])
                    else:
                        acc += popc(a8[:, None, :] & b8[None, :, :]).sum(-1)
                    pa += popc(a8).sum(1)   # the four threads' shares
                    pb += popc(b8).sum(1)
            yt = k_true - 2 * (pa[:, None] + pb[None, :] - 2 * acc)
            m = np.arange(m0, min(m0 + bm, m_total))
            n = np.arange(n0, min(n0 + bn, c_out))
            y[m[:, None], n[None, :]] = (yt[:len(m), :len(n)]
                                         + corr[(m % (oh * ow))[:, None],
                                                n[None, :]])
    return y


def fused_words(y, tau, flip):
    """store_fused: each thread sets the bits of its columns of a
    32-column group, four threads OR them (the two shuffles); columns past
    N give bit 0."""
    m, n = y.shape
    out = np.zeros((m, -(-n // 32)), np.uint32)
    for w in range(out.shape[1]):
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


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _case(hw, c_in, c_out, stride, padding, bsz):
    """Seeded operands, the port's plan (what the kernel gets) and the
    reference's int32 and packed outputs on the JAX plan."""
    rng = _rng("conv mma", hw, c_in, c_out, stride, padding, bsz)
    w = rng.uniform(-1, 1, (c_out, 3, 3, c_in)).astype(np.float32)
    x = _words(rng, (bsz, *hw, c_in))
    k = 9 * c_in
    tau = (rng.integers(-k, k + 1, c_out) + 0.5 * (rng.random(c_out) < 0.5)
           ).astype(np.float32)
    flip = np.where(rng.random(c_out) < 0.3, -1.0, 1.0).astype(np.float32)
    jplan = JBC.make_conv_plan(jnp.asarray(w), input_hw=hw, stride=stride,
                               padding=padding)
    want = np.asarray(JOPS.binary_conv2d_packed(jplan, jnp.asarray(x),
                                                backend="jnp"))
    want_bits = np.asarray(JOPS.binary_conv2d_bn_sign_packed(
        jplan, {"tau": jnp.asarray(tau), "flip": jnp.asarray(flip)},
        jnp.asarray(x), backend="jnp"))
    tplan = TBC.make_conv_plan(torch.from_numpy(w), input_hw=hw,
                               stride=stride, padding=padding)
    return x, tplan, tau, flip, want, want_bits


def _check(case, tile, vec16=None, fragments=False):
    x, plan, tau, flip, want, want_bits = _case(*case)
    cw = x.shape[-1]
    y = conv_mma(x, plan["w_packed"].numpy().view(np.uint32),
                 plan["correction"].numpy(), kh=3, kw=3,
                 stride=plan["stride"], pads=plan["pads"],
                 out_hw=plan["out_hw"], c_out=plan["c_out"],
                 k_true=plan["k_true"], tile=tile,
                 vec16=cw % 4 == 0 if vec16 is None else vec16,
                 fragments=fragments)
    np.testing.assert_array_equal(y.reshape(want.shape), want)
    np.testing.assert_array_equal(
        fused_words(y, tau, flip).reshape(want_bits.shape), want_bits)


# (hw, C_in, C_out, stride, padding, batch): C_in 3, 33, 64, 128 are 1, 2,
# 2, 4 words (KH*KW*Cw of 9, 18 or 36 words, never a whole k256 step and
# for Cw = 4 one word past the first chunk), C_out 10, 40, 136, stride 1
# and 2, SAME and VALID, and pixel counts that end inside a tile.
CASES = [
    ((9, 9), 3, 10, 1, "SAME", 2),
    ((9, 7), 3, 136, 2, "VALID", 3),
    ((7, 7), 33, 40, 2, "SAME", 2),
    ((11, 6), 33, 136, 1, "VALID", 2),
    ((6, 8), 64, 40, 1, "SAME", 3),
    ((6, 6), 128, 136, 1, "SAME", 2),
    ((9, 9), 128, 40, 2, "VALID", 3),
]


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("case", CASES)
def test_conv_mma_matches_jnp(case, tile):
    _check(case, tile)


# Cw = 4 with operands off 16-byte alignment: the kernel's 4-byte copies.
@pytest.mark.parametrize("case", [c for c in CASES if c[1] == 128])
def test_conv_mma_4byte_copies_match_jnp(case):
    _check(case, TBC.TILE_64X64, vec16=False)


# Lane by lane through the m16n8k256 fragments: Cw 1, 2 and 4.
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[-1]])
def test_conv_mma_fragments_match_jnp(case):
    _check(case, TBC.TILE_64X64, fragments=True)


@pytest.mark.parametrize("vec16", [True, False])
@pytest.mark.parametrize("tile", sorted(TILES))
def test_im2col_copies_cover_the_tile_once(tile, vec16):
    bm = TILES[tile][0]
    slots = copy_slots(bm, vec16)
    per_row = BK // 4 if vec16 else BK
    assert sorted(slots) == [(r, q) for r in range(bm)
                             for q in range(per_row)]


def test_rows_past_m_reach_no_input():
    # two 13 x 10 outputs (260 pixels), the tile of rows 256..319
    b, ih0, iw0 = row_table(256, 64, 260, (13, 10), 2, ((1, 1), (1, 1)))
    assert (b[:4] == 1).all() and (ih0[:4] == 12 * 2 - 1).all()
    assert (iw0[:4] == np.array([6, 7, 8, 9]) * 2 - 1).all()
    # any tap of a row past M stays far below row 0
    assert (ih0[4:] + 2 ** 16 < 0).all() and (b[4:] == 0).all()


def test_conv_tile_rule_on_the_bcnn():
    """64 x 128 tiles where the grid still gives each of 132 SMs a block
    (the BCNN at batch 256, every stage), else 64 x 64 (batch 1)."""
    stages = (((32, 32), 128), ((16, 16), 256), ((16, 16), 256),
              ((8, 8), 512), ((8, 8), 512))
    for (h, w), c_out in stages:
        assert TBC.conv_tile(256 * h * w, c_out, 132) == TBC.TILE_64X128
        assert TBC.conv_tile(h * w, c_out, 132) == TBC.TILE_64X64
    assert TBC.conv_tile(64 * 132, 128, 132) == TBC.TILE_64X128
    assert TBC.conv_tile(64 * 131, 128, 132) == TBC.TILE_64X64
