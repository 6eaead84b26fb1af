"""K2 (BN-sign-pack) in its two forms against the JAX reference, on the
CPU.

``csrc/bitplane_conv.cu``'s fused instance and ``csrc/bn_sign_pack.cu``
run only on a card.  These tests repeat, in numpy, the steps they take
and hold the result exactly to ``repro.kernels.ops`` with
``backend="jnp"``, and once each to the reference's Pallas kernels in
interpret mode:

* K1's fused instance: the host's choice of band and channel chunk (64 or
  32 channels, so that no word spans two chunks), then, composed with
  K1's numpy model (``test_torch_redesign.band_conv``), each warp's staged
  16-pixel x chunk tile turned into words by one ballot per pixel row and
  32-channel word, lane = channel, and stored by the lane that keeps it.
  Rows past the band hold garbage, as the kernel's stage does there.
* The standalone K2: the aligned path's slabs of 128 channels (4 a lane,
  tau and flip in registers), the grid-stride walk over tiles of 8 rows,
  the nibbles ORed over the 8 lanes of a word and handed to lane 4 j + q;
  the warp-per-word path; and the rule that picks between them.

Then the port's entry points on the CPU: ``ops.bitplane_conv2d_bn_sign_
packed`` and the BCNN's packed forward, whose first stage takes the fused
route where it does not pool and K1, the int32 pool and K2 where it does.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binary_layers as JL
from repro.kernels import binary_conv as JBC
from repro.kernels import ops as JOPS
from repro.models import cnn as JC
from repro_torch import convert as CV
from repro_torch.core import binary_layers as TL
from repro_torch.kernels import binary_conv as TBC
from repro_torch.kernels import fused_epilogue as TFE
from repro_torch.kernels import ops as TOPS
from repro_torch.models import cnn as TC

from test_torch_redesign import MIN_BAND_PIXELS, band_conv

WARP = 32
STAGE_LD = 72           # csrc/bitplane_conv.cu: kStageLd, int32 a tile row
SMEM_LIMIT = 232448     # an H100 block's opt-in shared memory, in bytes
ROWS = 8                # csrc/bn_sign_pack.cu: kRows
SLAB = 4 * WARP         # csrc/bn_sign_pack.cu: kSlab
WARPS_PER_SM = 32       # csrc/bn_sign_pack.cu: kWarpsPerSm
GARBAGE = np.uint32(0xDEADBEEF)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _bn(rng, c, k, ties=None):
    """tau: integers in [-k, k], half of them +0.5; flip: -1 for about a
    third of the channels.  ``ties`` (values of the input) become the
    first channels' tau, so that some y == tau exactly."""
    tau = rng.integers(-k, k + 1, c).astype(np.float32)
    tau += 0.5 * (rng.random(c) < 0.5)
    if ties is not None:
        tau[:len(ties)] = ties
    flip = np.where(rng.random(c) < 0.3, -1.0, 1.0).astype(np.float32)
    return tau, flip


def _bits(y, tau, flip):
    """The epilogue contract: (f32(y) >= tau) == (flip > 0)."""
    return (y.astype(np.float32) >= tau) == (flip > 0)


# ---------------------------------------------------------------------------
# K1's fused instance: bitplane_conv.cu with kFused
# ---------------------------------------------------------------------------

def _round16(x):
    return (x + 15) & ~15


def k1_smem(*, c_in, ow, stride, r_band, chunk, fused, kh=3, kw=3):
    """K1's shared memory per block (``Geometry::smem``): four warps' 16 x
    72 int32 stages, a chunk's weights, the depth table, the band's image
    bytes, and the fused instance's tau and flip."""
    rows_b = (r_band - 1) * stride + kh
    wb = (ow - 1) * stride + kw
    kpad = -(-(kh * kw * c_in) // 32) * 32
    return (4 * 16 * STAGE_LD * 4
            + _round16(chunk * (kpad + 16)) + _round16(kpad * 4)
            + _round16(rows_b * wb * c_in) + (2 * 64 * 4 if fused else 0))


def k1_geometry(*, c_in, out_hw, stride, fused):
    """The host's search: from the full band (R rows, R * OW >= 128
    pixels) down, halving R, the largest chunk that fits; 64, 32, 16 or 8
    channels for the int32 instance, 64 or 32 for the fused one.  None is
    kTooLarge."""
    oh, ow = out_hw
    r_band = min(-(-MIN_BAND_PIXELS // ow), oh)
    chunks = (64, 32) if fused else (64, 32, 16, 8)
    while r_band >= 1:
        for chunk in chunks:
            if k1_smem(c_in=c_in, ow=ow, stride=stride, r_band=r_band,
                       chunk=chunk, fused=fused) <= SMEM_LIMIT:
                return r_band, chunk
        r_band //= 2
    return None


def fused_words(y, tau, flip, *, r_band, chunk, rng):
    """The fused epilogue on K1's int32 result ``y`` (B, OH, OW, C_out):
    per band of ``r_band`` rows, per chunk of ``chunk`` channels and per
    16-pixel tile, the staged tile (garbage past the band's rows and past
    C_out), then ``store_words<chunk / 32>``:
    ballot i packs word q = i % wpc of pixel row r = i / wpc, lane =
    channel 32 q + lane, lanes past C_out voting 0; lane i keeps it and
    stores it if the row is in the band and the word in the chunk.
    Returns (B, OH, OW, ceil(C_out/32)) words; a word no lane stores keeps
    the garbage it started as."""
    bsz, oh, ow, c_out = y.shape
    wpc = chunk // 32
    cwo = -(-c_out // 32)
    out = np.full((bsz, oh * ow, cwo), GARBAGE, np.uint32)
    lane = np.arange(WARP)
    for b in range(bsz):
        for oh0 in range(0, oh, r_band):
            n_px = min(r_band, oh - oh0) * ow
            px = y[b, oh0:oh0 + n_px // ow].reshape(n_px, c_out)
            for n0 in range(0, c_out, chunk):
                cn = min(chunk, c_out - n0)
                tau_s = np.zeros(64, np.float32)
                flip_s = np.ones(64, np.float32)
                tau_s[:cn], flip_s[:cn] = tau[n0:n0 + cn], flip[n0:n0 + cn]
                for p0 in range(0, n_px, 16):
                    st = rng.integers(-2**31, 2**31, (16, STAGE_LD),
                                      dtype=np.int64)
                    rows = min(16, n_px - p0)
                    st[:rows, :cn] = px[p0:p0 + rows, n0:n0 + cn]
                    mine = np.zeros(WARP, np.uint32)
                    for i in range(16 * wpc):
                        r, q = i // wpc, i % wpc
                        ch = 32 * q + lane
                        vote = (n0 + ch < c_out) & _bits(
                            st[r, ch], tau_s[ch], flip_s[ch])
                        word = (vote.astype(np.uint64) << lane.astype(
                            np.uint64)).sum().astype(np.uint32)
                        mine[i] = word
                    for ln in range(16 * wpc):
                        r, q = ln // wpc, ln % wpc
                        if r < rows and 32 * q < cn:
                            out[b, oh0 * ow + p0 + r, n0 // 32 + q] = \
                                mine[ln]
    return out.reshape(bsz, oh, ow, cwo)


def _conv_case(key, hw, c_in, c_out, stride, padding, nbits=8, bsz=2):
    """Seeded weights, input, BN (some tau equal to outputs) and both
    plans; the reference's words, K2 on its K1 output (``backend``)."""
    rng = _rng(*key, hw, c_in, c_out, stride, padding, nbits)
    w = rng.uniform(-1, 1, (c_out, 3, 3, c_in)).astype(np.float32)
    x = rng.integers(0, 2 ** nbits, (bsz, *hw, c_in), dtype=np.uint8)
    jplan = JBC.make_bitplane_conv_plan(jnp.asarray(w), input_hw=hw,
                                        stride=stride, padding=padding,
                                        nbits=nbits)
    tplan = TBC.make_bitplane_conv_plan(torch.from_numpy(w), input_hw=hw,
                                        stride=stride, padding=padding,
                                        nbits=nbits)
    y = np.asarray(JOPS.bitplane_conv2d_packed(jplan, jnp.asarray(x),
                                               backend="jnp"))
    tau, flip = _bn(rng, c_out, 2 ** nbits * 6, ties=y[0, 0, 0, :3])
    return rng, x, jplan, tplan, tau, flip


def _reference_words(jplan, x, tau, flip, backend="jnp"):
    y = JOPS.bitplane_conv2d_packed(jplan, jnp.asarray(x), backend=backend)
    return np.asarray(JOPS.bn_sign_pack(y, jnp.asarray(tau),
                                        jnp.asarray(flip), backend=backend))


def test_k1_geometry_keeps_whole_words_per_chunk():
    """The BCNN's first stage takes the full band and chunks of 64 in both
    instances; C_in 288 takes 32 in both; at C_in 448 the int32 instance
    takes 16 channels, the fused one halves the band to keep 32; at C_in
    512 and 768, and on a 448-wide row at C_in 128, no band holds 32
    channels' weights, and the fused one refuses."""
    def both(hw, c_in):
        kw = dict(c_in=c_in, out_hw=hw, stride=1)
        return (k1_geometry(fused=False, **kw),
                k1_geometry(fused=True, **kw))
    assert both((32, 32), 3) == ((4, 64), (4, 64))
    assert both((32, 32), 288) == ((4, 32), (4, 32))
    assert both((16, 16), 448) == ((8, 16), (4, 32))
    assert both((32, 32), 512) == ((4, 16), None)
    assert both((32, 32), 768) == ((2, 8), None)
    assert both((4, 448), 128) == ((1, 16), None)


# (hw, C_out, stride, padding, chunk, band): chunks of 64 and 32, C_out
# 40, 33 and 72 (tail words; one, two and three chunks), stride 1 and 2,
# SAME and VALID, the full band and smaller ones.
FUSED_CASES = [((9, 9), 40, 1, "SAME", 64, None),
               ((9, 9), 40, 2, "VALID", 32, None),
               ((7, 8), 33, 2, "SAME", 64, 2),
               ((8, 6), 33, 1, "VALID", 32, 1),
               ((6, 7), 72, 1, "SAME", 32, None),
               ((6, 7), 72, 2, "SAME", 64, 1)]


@pytest.mark.parametrize("hw,c_out,stride,padding,chunk,band", FUSED_CASES)
def test_fused_epilogue_model_matches_jnp(hw, c_out, stride, padding, chunk,
                                          band):
    rng, x, jplan, tplan, tau, flip = _conv_case(
        ("fused", chunk, band), hw, 3, c_out, stride, padding)
    oh, ow = tplan["out_hw"]
    r_band = band or min(-(-MIN_BAND_PIXELS // ow), oh)
    y = band_conv(x, tplan["w_packed"], c_in=3, c_out=c_out, kh=3,
                  kw=3, stride=stride, pads=tplan["pads"],
                  out_hw=tplan["out_hw"], nbits=8, r_band=r_band)
    got = fused_words(y, tau, flip, r_band=r_band, chunk=chunk, rng=rng)
    np.testing.assert_array_equal(got,
                                  _reference_words(jplan, x, tau, flip))


def test_fused_epilogue_model_matches_pallas_interpret():
    rng, x, jplan, tplan, tau, flip = _conv_case(
        ("fused pallas",), (5, 5), 3, 40, 1, "SAME", bsz=1)
    y = band_conv(x, tplan["w_packed"], c_in=3, c_out=40, kh=3, kw=3,
                  stride=1, pads=tplan["pads"], out_hw=tplan["out_hw"],
                  nbits=8)
    got = fused_words(y, tau, flip, r_band=5, chunk=64, rng=rng)
    np.testing.assert_array_equal(
        got, _reference_words(jplan, x, tau, flip, backend="pallas"))


# ---------------------------------------------------------------------------
# The standalone K2: bn_sign_pack.cu's two paths
# ---------------------------------------------------------------------------

def aligned_bn_sign_pack(x, tau, flip, sms):
    """The aligned path (C % 4 == 0): warp w takes slab s = w % slabs of
    128 channels, lane l channels 128 s + 4 l.. + 3 with their tau and
    flip, and tiles w / slabs, + walkers, ... of 8 rows; load j of a tile
    is row m0 + j (0 past M or C), its nibble of bits shifted to 4 (l %
    8), ORed over the 8 lanes of a word (xor 1, 2, 4); lane 4 j + q takes
    word q of row j from lane 8 q and stores it.  Returns the words and
    how many times each was written."""
    m, c = x.shape
    assert c % 4 == 0
    cw = -(-c // 32)
    slabs = -(-c // SLAB)
    tiles = -(-m // ROWS)
    walkers = min(-(-(sms * WARPS_PER_SM) // slabs), tiles)
    out = np.full((m, cw), GARBAGE, np.uint32)
    writes = np.zeros((m, cw), np.int64)
    lane = np.arange(WARP)
    for gw in range(slabs * walkers):
        s = gw % slabs
        c0 = s * SLAB + 4 * lane
        valid = c0 < c
        cols = np.minimum(c0[:, None] + np.arange(4), c - 1)
        t, keep = tau[cols], flip[cols] > 0
        for tile in range(gw // slabs, tiles, walkers):
            m0 = tile * ROWS
            mine = np.zeros(WARP, np.uint32)
            for j in range(ROWS):
                row = x[min(m0 + j, m - 1), cols]
                v = np.where((valid & (m0 + j < m))[:, None], row, 0)
                ge = (v.astype(np.float32) >= t)
                nib = np.where(valid, ((ge == keep) << np.arange(4)).sum(-1),
                               0).astype(np.uint32)
                w = nib << (4 * (lane % 8)).astype(np.uint32)
                for d in (1, 2, 4):
                    w = w | w[lane ^ d]
                got = w[8 * (lane % 4)]
                mine = np.where(lane // 4 == j, got, mine)
            rows = m0 + lane // 4
            words = s * 4 + lane % 4
            ok = (rows < m) & (words < cw)
            out[rows[ok], words[ok]] = mine[ok]
            np.add.at(writes, (rows[ok], words[ok]), 1)
    return out, writes


def general_bn_sign_pack(x, tau, flip):
    """The general path: one warp per word, lane = channel, lanes past C
    vote 0, __ballot_sync packs."""
    m, c = x.shape
    cw = -(-c // 32)
    out = np.zeros((m, cw), np.uint32)
    for word in range(cw):
        ch = word * 32 + np.arange(WARP)
        cc = np.minimum(ch, c - 1)
        vote = (ch[None] < c) & _bits(x[:, cc], tau[cc], flip[cc])
        out[:, word] = (vote.astype(np.uint64)
                        << np.arange(WARP, dtype=np.uint64)).sum(-1)
    return out


def _k2_case(key, m, c):
    rng = _rng("k2", key, m, c)
    x = rng.integers(-99, 99, (m, c)).astype(np.int32)
    tau, flip = _bn(rng, c, 99, ties=x[0, :5])
    return x, tau, flip


# (M, C, SMs): M below, at and past a tile of 8 rows; C 4, a word tail
# (40, 100), the BCNN's 128, two slabs with one lane in the second (132);
# grids of 1 and 2 SMs, so that a warp walks several tiles.
@pytest.mark.parametrize("m,c,sms", [(1, 4, 1), (8, 40, 1), (37, 40, 1),
                                     (37, 128, 2), (300, 128, 1),
                                     (9, 100, 2), (150, 132, 1),
                                     (5, 264, 1)])
def test_bn_sign_pack_paths_match_jnp(m, c, sms):
    x, tau, flip = _k2_case("paths", m, c)
    want = np.asarray(JOPS.bn_sign_pack(jnp.asarray(x), jnp.asarray(tau),
                                        jnp.asarray(flip), backend="jnp"))
    got, writes = aligned_bn_sign_pack(x, tau, flip, sms)
    np.testing.assert_array_equal(got, want)
    assert (writes == 1).all()
    np.testing.assert_array_equal(general_bn_sign_pack(x, tau, flip), want)


@pytest.mark.parametrize("m,c", [(3, 33), (37, 10), (2, 1)])
def test_bn_sign_pack_general_path_ragged_matches_jnp(m, c):
    x, tau, flip = _k2_case("general", m, c)
    np.testing.assert_array_equal(
        general_bn_sign_pack(x, tau, flip),
        np.asarray(JOPS.bn_sign_pack(jnp.asarray(x), jnp.asarray(tau),
                                     jnp.asarray(flip), backend="jnp")))


def test_bn_sign_pack_matches_pallas_interpret():
    x, tau, flip = _k2_case("pallas", 37, 40)
    want = np.asarray(JOPS.bn_sign_pack(jnp.asarray(x), jnp.asarray(tau),
                                        jnp.asarray(flip),
                                        backend="pallas"))
    np.testing.assert_array_equal(aligned_bn_sign_pack(x, tau, flip, 1)[0],
                                  want)
    np.testing.assert_array_equal(general_bn_sign_pack(x, tau, flip), want)


def test_bn_sign_pack_path_by_shape_and_alignment():
    base = 0x7f0000000000
    for c in (4, 40, 128, 132, 4096):
        assert TFE.bn_sign_aligned(c, base)
        assert not TFE.bn_sign_aligned(c, base + 4)
        assert not TFE.bn_sign_aligned(c, base + 8)
    for c in (1, 10, 33, 130, 4095):
        assert not TFE.bn_sign_aligned(c, base)


# ---------------------------------------------------------------------------
# The entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,c_out,stride,padding", [
    ((8, 8), 40, 1, "SAME"), ((9, 7), 33, 2, "VALID")])
def test_ops_bitplane_conv_bn_sign_matches_jnp(hw, c_out, stride, padding):
    _, x, jplan, tplan, tau, flip = _conv_case(("ops",), hw, 3, c_out,
                                               stride, padding)
    want = _reference_words(jplan, x, tau, flip)
    folded = {"tau": torch.from_numpy(tau), "flip": torch.from_numpy(flip)}
    xt = torch.from_numpy(x)
    got = TOPS.bitplane_conv2d_bn_sign_packed(tplan, folded, xt,
                                              backend="torch")
    np.testing.assert_array_equal(CV.words_to_numpy(got), want)
    np.testing.assert_array_equal(CV.words_to_numpy(
        TL.apply_bitplane_conv2d_bn_packed(tplan, folded, xt)), want)
    with pytest.raises(ValueError, match="CUDA"):
        TOPS.bitplane_conv2d_bn_sign_packed(tplan, folded, xt,
                                            backend="cuda")


def _randomize_bn(params, seed):
    rng = np.random.default_rng(seed)
    for bn in params["conv_bns"] + params["dense_bns"]:
        c = bn["gamma"].shape[0]
        sign = np.where(rng.random(c) < 0.3, -1.0, 1.0)
        bn["gamma"] = jnp.asarray(rng.uniform(0.3, 1.5, c) * sign,
                                  jnp.float32)
        bn["beta"] = jnp.asarray(rng.normal(size=c), jnp.float32)
        bn["mean"] = jnp.asarray(rng.normal(size=c) * 3, jnp.float32)
        bn["var"] = jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)
    return params


@pytest.mark.parametrize("pool", [False, True])
def test_bcnn_first_stage_route_matches_reference(pool, monkeypatch):
    """The packed forward's int32 output against the reference's, and the
    first stage's route: the fused K1 where it does not pool, K1 + int32
    pool + K2 where it does."""
    spec = JC.BCNNSpec(input_hw=(8, 8), c_in=3,
                       stages=(JC.ConvStage(40, pool=pool),
                               JC.ConvStage(33, pool=True)),
                       dense=(24, 10))
    params = _randomize_bn(JC.init_bcnn(jax.random.PRNGKey(4), spec), 4)
    x = np.random.default_rng(5).integers(0, 256, (3, 8, 8, 3),
                                          dtype=np.uint8)
    tp = TC.pack_bcnn(CV.params_to_torch(params), CV.bcnn_spec(spec),
                      device="cpu")
    calls = []
    for name in ("apply_bitplane_conv2d_bn_packed",
                 "apply_bitplane_conv2d_packed",
                 "apply_bn_sign_folded_packed"):
        fn = getattr(TL, name)
        monkeypatch.setattr(TL, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    got = TC.bcnn_forward_packed_int(tp, torch.from_numpy(x))
    assert calls == (["apply_bitplane_conv2d_packed",
                      "apply_bn_sign_folded_packed"] if pool
                     else ["apply_bitplane_conv2d_bn_packed"])
    monkeypatch.setattr(JL, "apply_batchnorm", lambda p, z, eps=1e-5: z)
    want = np.asarray(JC.bcnn_forward_packed(JC.pack_bcnn(params, spec),
                                             jnp.asarray(x), backend="jnp"))
    np.testing.assert_array_equal(got.numpy(), want)
