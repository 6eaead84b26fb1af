"""The arithmetic of the tensor-core K8 kernel against the JAX reference,
on the CPU.

``csrc/binary_attention.cu`` runs only on a card; these tests repeat, in
numpy, the steps it takes and hold the result to
``repro.kernels.ops.binary_attention`` with ``backend="jnp"`` (the scores
to the reference's XNOR-popcount ``packed_matmul``):

* the m16n8k256 score fragments lane by lane: A = Q rows g and g+8, B = K
  row (key) g, words t and t+4 of each 8-word step, zero past Dw; the
  and-popc identity y = D - 2 (popc(q) + popc(k) - 2 popc(q & k)) after
  ``b1_finish``'s shuffles; exactly the reference's scores;
* the P.V fragments: the score's C fragment fed as the TF32 A fragment
  with k column t = key 2t and column t + 4 = key 2t + 1, V's B fragment
  read from shared-memory rows 2t and 2t + 1 at column g, the output
  fragment stored as rows g, g+8 and dims 8n + 2t, 8n + 2t + 1; exactly
  the unpermuted product on integer-valued inputs; every fragment load on
  32 distinct banks;
* the three-pass split-TF32 P.V (x_hi = x rounded as ``cvt.rna.tf32``
  rounds: to nearest, ties away from zero, to 10 mantissa bits, in the
  kernel's integer form; x_lo = x - x_hi truncated to 10 mantissa bits)
  inside the kernel's whole walk:
  64-row q tiles of four 16-row warps (16-row q tiles, every warp on all
  16, where Sq <= 16), 32-key KV tiles skipped by the kernel's rule, the
  online softmax in float32; within rtol = atol = 2e-5
  of the reference on gemma2-9b's head (D = Dv = 256, softcap 50, its
  window cut to fit), rows with 1-3 unmasked keys among them.  One TF32
  pass does not hold there;
* K words with bits past D: the scores count them, as the reference's
  Pallas kernel does, and the per-block table of float scores covers every
  count they can reach;
* the tile-skip rule at those tile sizes: every tile that holds an
  unmasked key of a warp's rows is walked, a warp holding a row with no
  unmasked key walks every tile, every walked tile starts below Skv.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import binarize as JB
from repro.kernels import binary_attention as JBA
from repro.kernels import ops as JOPS
from repro_torch.kernels import binary_attention as TBA

WARP_ROWS = 16           # csrc/binary_attention.cu: rows of a warp
WARPS = 4                # kWarps, warps of a block
KEYS = 32                # kKeys, keys of a KV tile
BK = 32                  # csrc/b1_mma.cuh: kBK, words of a staged row
LDS = BK + 4             # kLds, Q and K row stride
TABLE = 32 * BK + 4      # kTable, the score table's length
NEG_INF = np.float32(-1e30)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def popc(x):
    """Population count of each uint32 element."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    return np.unpackbits(x.view(np.uint8).reshape(*x.shape, 4),
                         axis=-1).sum(-1).astype(np.int64)


def _pack(x):
    return np.asarray(JB.pack_bits(jnp.asarray(x)))


def v_stride(nv):
    """V's shared-memory row stride, 8 NV + 4 floats (``v_stride``)."""
    return 8 * nv + 4


def row_warps(sq, dw):
    """kRowWarps of the instantiation ``binary_attention`` launches: 1
    (16-row blocks) where Sq <= 16 and Q and K are staged, else 4."""
    return 1 if sq <= 16 and dw <= BK else WARPS


# ---------------------------------------------------------------------------
# The kernel's steps, lane by lane
# ---------------------------------------------------------------------------

def score_fragments(q_words, k_words, d_true):
    """One warp's scores of 16 Q rows against one 8-key n-tile as the
    kernel gets them: per lane (g, t) the m16n8k256 A fragment (rows g,
    g+8; words t, t+4 of each step) and B fragment (key g; words t, t+4),
    the and-popc MMA assembled from those registers, the lanes' popcount
    shares, then b1_finish.  Returns y (32 lanes, 4): c0 (g, 2t), c1 (g,
    2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)."""
    dw = q_words.shape[1]
    steps = -(-dw // 8)
    qz = np.zeros((16, 8 * steps), np.uint32)
    kz = np.zeros((8, 8 * steps), np.uint32)
    qz[:, :dw], kz[:, :dw] = q_words, k_words       # zero-filled copies
    acc = np.zeros((32, 4), np.int64)
    pa = np.zeros((32, 2), np.int64)
    pb = np.zeros(32, np.int64)
    for k8 in range(0, 8 * steps, 8):
        a = np.stack([qz[G, k8 + T], qz[G + 8, k8 + T],
                      qz[G, k8 + T + 4], qz[G + 8, k8 + T + 4]], 1)
        b = np.stack([kz[G, k8 + T], kz[G, k8 + T + 4]], 1)
        pa[:, 0] += popc(a[:, 0]) + popc(a[:, 2])
        pa[:, 1] += popc(a[:, 1]) + popc(a[:, 3])
        pb += popc(b[:, 0]) + popc(b[:, 1])
        # The MMA reads its operands from the lanes' registers.
        am = np.zeros((16, 8), np.uint32)
        bm = np.zeros((8, 8), np.uint32)
        am[G, T], am[G + 8, T] = a[:, 0], a[:, 1]
        am[G, T + 4], am[G + 8, T + 4] = a[:, 2], a[:, 3]
        bm[G, T], bm[G, T + 4] = b[:, 0], b[:, 1]
        d = popc(am[:, None, :] & bm[None, :, :]).sum(-1)   # (16, 8)
        acc += np.stack([d[G, 2 * T], d[G, 2 * T + 1],
                         d[G + 8, 2 * T], d[G + 8, 2 * T + 1]], 1)
    # b1_finish: the shares of a row (key) summed over its quad, key
    # 2t + e's from lane 8t + 4e.
    pa = np.repeat(pa.reshape(8, 4, 2).sum(1), 4, axis=0)
    pb = np.repeat(pb.reshape(8, 4).sum(1), 4)
    pc = np.stack([pb[8 * T], pb[8 * T + 4]], 1)
    return np.stack([d_true - 2 * (pa[:, h] + pc[:, e] - 2 * acc[:, 2 * h + e])
                     for h in (0, 1) for e in (0, 1)], 1)


def c_to_matrix(frag):
    """A C fragment (32 lanes, 4) as its (16, 8) matrix."""
    m = np.zeros((16, 8), frag.dtype)
    m[G, 2 * T], m[G, 2 * T + 1] = frag[:, 0], frag[:, 1]
    m[G + 8, 2 * T], m[G + 8, 2 * T + 1] = frag[:, 2], frag[:, 3]
    return m


def mma_tf32(a, b):
    """m16n8k8 from the lanes' registers: A (g, t), (g+8, t), (g, t+4),
    (g+8, t+4); B (k t, col g), (k t+4, col g); returns the C fragment
    (32, 4) of A @ B, float64 (exact for the integer-valued tests)."""
    am = np.zeros((16, 8))
    bm = np.zeros((8, 8))
    am[G, T], am[G + 8, T], am[G, T + 4], am[G + 8, T + 4] = a.T
    bm[T, G], bm[T + 4, G] = b.T
    d = am @ bm
    return np.stack([d[G, 2 * T], d[G, 2 * T + 1],
                     d[G + 8, 2 * T], d[G + 8, 2 * T + 1]], 1)


def warp_dims(nv, rows_w, warp):
    """A warp's n-tiles (kNW) and first dim (wd) in a block of NV n-tiles
    with rows_w warps along the rows."""
    nw = nv * rows_w // WARPS
    return nw, (warp // rows_w) * 8 * nw


def pv_fragments(p, v_tile, nv, rows_w=WARPS, warp=0):
    """One warp's P (16 rows x 32 keys) . V (32 keys x its 8 kNW dims) as
    the kernel runs it: P from the scores' C fragments of the 4 groups, V
    from the block's shared-memory tile (8 NV dims) at stride v_stride(nv)
    from the warp's first dim on; returns the output (16, 8 NV) as the
    epilogue stores the accumulators, zero outside the warp's dims."""
    ldv = v_stride(nv)
    nw, wd = warp_dims(nv, rows_w, warp)
    smem = np.zeros(KEYS * ldv)
    for key in range(KEYS):
        smem[key * ldv:key * ldv + 8 * nv] = v_tile[key]
    acc = np.zeros((nw, 32, 4))
    for j in range(KEYS // 8):
        s = np.stack([p[G, 8 * j + 2 * T], p[G, 8 * j + 2 * T + 1],
                      p[G + 8, 8 * j + 2 * T], p[G + 8, 8 * j + 2 * T + 1]],
                     1)
        a = s[:, [0, 2, 1, 3]]            # pf = {s0, s2, s1, s3}
        v0 = (8 * j + 2 * T) * ldv + wd + G
        for n in range(nw):
            b = np.stack([smem[v0 + 8 * n], smem[v0 + ldv + 8 * n]], 1)
            acc[n] += mma_tf32(a, b)
    out = np.zeros((16, 8 * nv))
    for n in range(nw):
        for e in range(4):
            out[G + 8 * (e >> 1), wd + 8 * n + 2 * T + (e & 1)] = acc[n][:, e]
    return out


def tf32_rna(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits, in the kernel's integer form (``split_tf32``: add half
    a TF32 unit to the bit pattern, clear the low 13 bits)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    """The low part's rounding in ``split_tf32``: toward zero, to 10
    mantissa bits (its low 13 bits cleared)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def tile_range(r0, r1, skv, *, causal, window, q_offset):
    """csrc/binary_attention.cu ``tile_range``: the KV tiles [lo, hi] that
    query rows [r0, r1] can see."""
    qmin, qmax = q_offset + r0, q_offset + r1
    lo, hi = 0, -(-skv // KEYS) - 1
    w = window or 0
    if w <= 0 or qmax < skv - 1 + w:
        if causal:
            hi = min(hi, qmax // KEYS)
        first = qmin - w + 1
        if w > 0 and first > 0:
            lo = first // KEYS
    return lo, hi


def _mask(qpos, kpos, *, causal, window):
    keep = np.ones(np.broadcast(qpos, kpos).shape, bool)
    if causal:
        keep &= qpos >= kpos
    if window:
        keep &= qpos - kpos < window
    return keep


def kernel_model(qw, kw, v, *, d_true, causal=True, window=None,
                 attn_softcap=None, q_offset=0, passes=3):
    """The kernel's walk over one (B, Sq, Hq, Dw) x (B, Skv, Hkv, Dw)
    problem in float32: per warp of 16 rows the KV tiles of its
    ``tile_range`` within its block's (64 rows, or 16 where Sq <= 16 and
    Dw <= kBK), the scale, softcap and mask of each
    score, the online softmax, and P.V per 8-key group as ``passes`` TF32
    products (3: P_lo V_hi, P_hi V_lo, P_hi V_hi; 1: P_hi V_hi), each
    added to the float32 accumulator."""
    f32 = np.float32
    b, sq, hq, _ = qw.shape
    skv, hkv, dv = v.shape[1], v.shape[2], v.shape[3]
    scale = f32(TBA.attention_scale(d_true))
    cap = None if attn_softcap is None else f32(attn_softcap)
    out = np.zeros((b, sq, hq, dv), f32)
    kpad = -(-skv // KEYS) * KEYS
    rows_blk = WARP_ROWS * row_warps(sq, qw.shape[-1])
    for bi in range(b):
        for h in range(hq):
            hk = h // (hq // hkv)
            y = d_true - 2 * popc(qw[bi, :, h, None, :]
                                  ^ kw[bi, None, :, hk, :]).sum(-1)
            vt = np.zeros((kpad, dv), f32)
            vt[:skv] = v[bi, :, hk]
            for q0 in range(0, sq, rows_blk):
                blo, bhi = tile_range(q0, min(q0 + rows_blk, sq) - 1, skv,
                                      causal=causal, window=window,
                                      q_offset=q_offset)
                for r0 in range(q0, min(q0 + rows_blk, sq), WARP_ROWS):
                    rows = np.arange(r0, min(r0 + WARP_ROWS, sq))
                    lo, hi = tile_range(rows[0], rows[-1], skv, causal=causal,
                                        window=window, q_offset=q_offset)
                    assert blo <= lo and hi <= bhi
                    m = np.full(len(rows), -np.inf, f32)
                    l = np.zeros(len(rows), f32)
                    acc = np.zeros((len(rows), dv), f32)
                    for tile in range(lo, hi + 1):
                        keys = tile * KEYS + np.arange(KEYS)
                        valid = keys < skv
                        s = y[rows][:, np.minimum(keys, skv - 1)].astype(f32)
                        s = s * scale
                        if cap is not None:
                            s = cap * np.tanh(s / cap)
                        keep = _mask(q_offset + rows[:, None], keys[None],
                                     causal=causal, window=window)
                        s = np.where(keep, s, NEG_INF)
                        s = np.where(valid[None], s, f32(-np.inf))
                        m_new = np.maximum(m, s.max(1))
                        corr = np.exp(m - m_new)
                        p = np.exp(s - m_new[:, None])
                        l = l * corr + p.sum(1, dtype=f32)
                        acc = acc * corr[:, None]
                        vv = vt[tile * KEYS:(tile + 1) * KEYS]
                        for j in range(0, KEYS, 8):
                            pj, vj = p[:, j:j + 8], vv[j:j + 8]
                            p_hi, v_hi = tf32_rna(pj), tf32_rna(vj)
                            if passes == 3:
                                p_lo = tf32_trunc(pj - p_hi)
                                v_lo = tf32_trunc(vj - v_hi)
                                acc = acc + p_lo @ v_hi
                                acc = acc + p_hi @ v_lo
                            acc = acc + p_hi @ v_hi
                        m = m_new
                    out[bi, rows, h] = acc / np.maximum(l, f32(1e-30))[:, None]
    return out


def _problem(shape, seed):
    """Real Q, K, V from a seed; Q and K packed by the reference."""
    b, sq, skv, hq, hkv, d, dv = shape
    rng = _rng(*shape, seed)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, dv)).astype(np.float32)
    return q, k, v


def _reference(q, k, v, **kw):
    return np.asarray(JOPS.binary_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), backend="jnp", **kw))


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [33, 40, 64, 256, 280, 1100])
def test_score_fragments_equal_reference_scores(d):
    """Every 8-key n-tile of a 16-row warp: the lanes' y equal the
    reference's XNOR-popcount scores exactly, with 1-5 k256 steps, zero
    words past Dw, and keys whose bits are all 0 or all 1."""
    rng = _rng("scores", d)
    q = rng.normal(size=(16, d)).astype(np.float32)
    k = rng.normal(size=(24, d)).astype(np.float32)
    k[3], k[17] = 1.0, -1.0
    qw, kw = _pack(q), _pack(k)
    want = np.asarray(JB.packed_matmul(jnp.asarray(qw), jnp.asarray(kw), d))
    for n0 in range(0, 24, 8):
        got = c_to_matrix(score_fragments(qw, kw[n0:n0 + 8], d))
        np.testing.assert_array_equal(got, want[:, n0:n0 + 8])


# (NV, kRowWarps) of the kernel's instantiations with staged Q and K:
# Dv <= 128, Dv <= 256, and the 16-row blocks of Sq <= 16.
BLOCKS = [(16, WARPS), (32, WARPS), (32, 1)]


@pytest.mark.parametrize("nv,rows_w", BLOCKS)
def test_pv_fragments_equal_unpermuted_product(nv, rows_w):
    """P from the scores' C fragments with V's k rows permuted (column t =
    key 2t, column t + 4 = key 2t + 1), each warp's dims of the block
    together: exactly P @ V on integers."""
    rng = _rng("pv", nv, rows_w)
    p = rng.integers(-8, 9, (16, KEYS)).astype(np.float64)
    v = rng.integers(-8, 9, (KEYS, 8 * nv)).astype(np.float64)
    got = sum(pv_fragments(p, v, nv, rows_w, w)
              for w in range(0, WARPS, rows_w))
    np.testing.assert_array_equal(got, p @ v)


@pytest.mark.parametrize("nv,rows_w", BLOCKS)
def test_fragment_loads_hit_distinct_banks(nv, rows_w):
    """V's B-fragment loads (rows 2t, 2t+1 at column g of each of a
    warp's 8-dim n-tiles) and the Q/K word loads (rows g and g + 8 at
    words t and t + 4, stride kLds) each touch 32 distinct banks; V rows
    stay 16-byte aligned for the cp.async copies."""
    ldv = v_stride(nv)
    assert (4 * ldv) % 16 == 0
    for warp in range(WARPS):
        nw, wd = warp_dims(nv, rows_w, warp)
        for j in range(KEYS // 8):
            for n in range(nw):
                for row in (2 * T, 2 * T + 1):
                    addr = (8 * j + row) * ldv + wd + G + 8 * n
                    assert len(set(addr % 32)) == 32
    for k8 in range(0, 32, 8):
        for r, w in ((G, T), (G + 8, T), (G, T + 4), (G + 8, T + 4)):
            assert len(set((r * LDS + k8 + w) % 32)) == 32


def test_tf32_split_roundings():
    """The integer form of cvt.rna: 10 mantissa bits, halfway cases away
    from zero, exact on values that already fit; the low part truncated;
    hi + lo within 2^-21 of x."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    half = np.float32(2.0 ** -11)
    x = np.array([one + half, -(one + half), one + half - np.float32(2 ** -23),
                  one + ulp, np.float32(3.0)], np.float32)
    np.testing.assert_array_equal(
        tf32_rna(x), np.array([one + ulp, -(one + ulp), one, one + ulp, 3.0],
                              np.float32))
    np.testing.assert_array_equal(tf32_trunc(-(one + half + ulp)),
                                  -(one + ulp))
    y = _rng("split").normal(size=1000).astype(np.float32)
    hi = tf32_rna(y)
    lo = tf32_trunc(y - hi)
    np.testing.assert_array_less(np.abs(hi.astype(np.float64) + lo - y),
                                 2.0 ** -21 * np.abs(y) + 1e-30)


# gemma2-9b's head (D = Dv = 256, softcap 50, GQA 2) over a few hundred
# keys; its 4096-key window cut to 100 so that it masks here.  Causal rows
# 0, 1 and 2 see 1, 2 and 3 keys.
GEMMA_HEAD = dict(shape=(1, 300, 300, 2, 1, 256, 256),
                  kw=dict(window=100, attn_softcap=50.0))


@pytest.mark.parametrize("case", ["local", "global"])
def test_split_tf32_walk_matches_reference(case):
    """The whole walk with three TF32 passes: within 2e-5 of the
    reference's exact softmax, rows with 1-3 unmasked keys included."""
    kw = dict(GEMMA_HEAD["kw"])
    if case == "global":
        kw.pop("window")
    q, k, v = _problem(GEMMA_HEAD["shape"], case)
    want = _reference(q, k, v, **kw)
    got = kernel_model(_pack(q), _pack(k), v, d_true=256, **kw)
    np.testing.assert_allclose(got, want, **ATTN_TOL)
    np.testing.assert_allclose(got[:, :3], want[:, :3], **ATTN_TOL)


def test_single_tf32_pass_does_not_hold():
    """One TF32 pass on the same inputs: a row with one unmasked key
    carries V's TF32 rounding (up to 2^-11 |v|) into the output, beyond
    2e-5.  This is what rules it out."""
    kw = GEMMA_HEAD["kw"]
    q, k, v = _problem(GEMMA_HEAD["shape"], "local")
    want = _reference(q, k, v, **kw)
    got = kernel_model(_pack(q), _pack(k), v, d_true=256, passes=1, **kw)
    err = np.abs(got - want)
    assert not np.all(err <= ATTN_TOL["atol"] + ATTN_TOL["rtol"] *
                      np.abs(want))
    assert err[:, 0].max() > 1e-4          # the row with one key


@pytest.mark.parametrize("shape,kw", [
    ((1, 70, 100, 2, 2, 40, 40), dict(window=5, q_offset=60)),
    ((2, 65, 129, 3, 3, 64, 64), dict(window=40, attn_softcap=50.0)),
    ((1, 3, 129, 4, 2, 33, 24), dict(q_offset=126, window=64)),
    ((1, 40, 97, 2, 1, 40, 16), dict(causal=False, window=9)),
    ((1, 33, 70, 2, 2, 40, 8), dict(causal=False))])
def test_tile_skip_walk_matches_reference(shape, kw):
    """The walk with the kernel's tile skipping, against the reference:
    a q tile holding rows that see no key beside rows that do, q_offset,
    a last KV tile of one key, no mask at all."""
    q, k, v = _problem(shape, "walk")
    want = _reference(q, k, v, **kw)
    got = kernel_model(_pack(q), _pack(k), v, d_true=shape[5], **kw)
    np.testing.assert_allclose(got, want, **ATTN_TOL)


@pytest.mark.parametrize("rows_w", [WARPS, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_rule_walks_every_tile_with_an_unmasked_key(causal, rows_w):
    """Over Sq, Skv, window and q_offset, in 64-row and 16-row blocks:
    each warp's [lo, hi] lies in its block's and below Skv, holds every
    tile with an unmasked key of the warp's rows, and is every tile when a
    row has no unmasked key."""
    rows_blk = WARP_ROWS * rows_w
    rng = _rng("rule", causal, rows_w)
    for _ in range(300):
        sq = int(rng.integers(1, 200))
        skv = int(rng.integers(1, 200))
        window = [None, int(rng.integers(1, 80))][int(rng.integers(0, 2))]
        q_offset = int(rng.integers(0, 150))
        n_tiles = -(-skv // KEYS)
        rule = dict(causal=causal, window=window, q_offset=q_offset)
        for q0 in range(0, sq, rows_blk):
            blo, bhi = tile_range(q0, min(q0 + rows_blk, sq) - 1, skv, **rule)
            for r0 in range(q0, min(q0 + rows_blk, sq), WARP_ROWS):
                rows = np.arange(r0, min(r0 + WARP_ROWS, sq))
                lo, hi = tile_range(rows[0], rows[-1], skv, **rule)
                assert 0 <= blo <= lo <= hi <= bhi < n_tiles
                keep = _mask(q_offset + rows[:, None],
                             np.arange(skv)[None], causal=causal,
                             window=window)
                if not keep.any(1).all():
                    assert (lo, hi) == (0, n_tiles - 1)
                seen = np.nonzero(keep.any(0))[0] // KEYS
                assert seen.size == 0 or lo <= seen.min() <= seen.max() <= hi


def _with_bits_past_d(kw_words, d, rng):
    """K words with random bits set past D in their last word."""
    kw_words = kw_words.copy()
    tail = rng.integers(0, 2 ** 32, kw_words.shape[:-1], dtype=np.uint64)
    kw_words[..., -1] |= (tail << np.uint64(d % 32)).astype(np.uint32)
    assert (kw_words[..., -1] >> np.uint32(d % 32)).any()
    return kw_words


@pytest.mark.parametrize("d", [17, 40, 280])
def test_score_table_covers_bits_past_d(d):
    """K words with bits past D: the lanes' y equal the reference's
    ``packed_matmul`` over the whole words, which counts those bits as
    mismatches, and each y's index (D - y) / 2 lies inside the table of
    32 Dw + 1 float scores a block fills, whose entry is the Pallas
    body's scale and softcap of y."""
    rng = _rng("tail", d)
    q = rng.normal(size=(16, d)).astype(np.float32)
    k = rng.normal(size=(8, d)).astype(np.float32)
    k[3] = -q[0]                  # every bit below D a mismatch
    qw, kw = _pack(q), _with_bits_past_d(_pack(k), d, rng)
    dw = qw.shape[1]
    y = c_to_matrix(score_fragments(qw, kw, d))
    want = np.asarray(JB.packed_matmul(jnp.asarray(qw), jnp.asarray(kw), d))
    np.testing.assert_array_equal(y, want)
    assert y[0, 3] < -d                    # a count past D
    f32 = np.float32
    scale, cap = f32(TBA.attention_scale(d)), f32(50.0)

    def score_of(y):
        x = np.asarray(y).astype(f32) * scale
        return cap * np.tanh(x / cap)

    table = score_of(d - 2 * np.arange(32 * dw + 1))
    assert 32 * dw + 1 <= TABLE
    idx = (d - y) >> 1
    assert idx.min() >= 0 and idx.max() <= 32 * dw
    np.testing.assert_array_equal(table[idx], score_of(y))


@pytest.mark.parametrize("shape,kw", [
    ((1, 16, 40, 2, 1, 40, 24), dict(window=9, attn_softcap=50.0)),
    ((1, 40, 70, 2, 2, 17, 16), dict(causal=False))])
def test_walk_with_bits_past_d_matches_pallas_kernel(shape, kw):
    """The walk on K words with bits past D, against the reference's
    Pallas kernel (interpret mode) on the same words: 16-row and 64-row
    blocks."""
    q, k, v = _problem(shape, "tail")
    d = shape[5]
    qw = _pack(q)
    kw_words = _with_bits_past_d(_pack(k), d, _rng("tail words", *shape))
    want = np.asarray(JBA.binary_attention_packed(
        jnp.asarray(qw), jnp.asarray(kw_words), jnp.asarray(v), d_true=d,
        interpret=True, **kw))
    got = kernel_model(qw, kw_words, v, d_true=d, **kw)
    np.testing.assert_allclose(got, want, **ATTN_TOL)
