"""The arithmetic of the cluster K6 (``csrc/dense_stack.cu``) and of K5
(``csrc/bitpack.cu``) against the JAX reference, on the CPU.

Both kernels run only on a card.  These tests repeat, in numpy, the steps
they take and hold the result exactly to ``repro.kernels.ops`` with
``backend="jnp"``, and once each to the reference's Pallas kernel in
interpret mode:

* K6: a cluster of C blocks owns an M tile of R rows (``stack_tile``);
  each block computes its range of every stage's output words from its
  slice of the weights (zero past its range and past Kw), as
  popc(a & ~b) + popc(~a & b) on the 1-bit AND MMA over whole 32-word
  chunks (each lane's 16-byte loads feed two k256 steps in the order
  ``chunk_tile`` checks), and writes each word into the
  next activation buffer of every block of the cluster.  The buffers start
  as garbage, as shared memory does, so a word the kernel fails to zero
  or to write shows.  The words gathered from the peers' buffers must be
  the reference's next activation, stage by stage.
* K5: the aligned path's float4 nibbles, ORed over the 8 lanes that hold a
  word and handed to lane l for word l, and the warp-per-word ballot of
  the general path, with the choice between them.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import binary_matmul as JBM
from repro.kernels import bitpack as JBP
from repro.kernels import ops as JOPS
from repro_torch.kernels import binary_matmul as TBM
from repro_torch.kernels import bitpack as TBP

WARP = 32
TILE_WARPS = 8          # csrc/dense_stack.cu: kStackWarps (a tile's words)
BK = 32                 # csrc/b1_mma.cuh: kBK, words per ring tile
_LUT = np.array([bin(i).count("1") for i in range(1 << 16)], np.int64)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def popc(x):
    x = np.asarray(x, np.uint32)
    return _LUT[x & 0xFFFF] + _LUT[x >> 16]


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _tail_zero(words, k):
    """Zero the bits past ``k`` of each row's last word (a packed tensor's
    zero-bit tail)."""
    words = words.copy()
    if k % 32:
        words[:, -1] &= np.uint32((1 << (k % 32)) - 1)
    return words


def _stack(key, sizes, k0):
    """Random stages {w, tau, flip, k_true}: zero weight tails, integer and
    half-integer thresholds within two spreads (2 sqrt(K)) of 0, where
    random words' outputs fall, both signs of flip."""
    rng = _rng("stack", key)
    stages, k = [], k0
    for n in sizes:
        w = _tail_zero(_words(rng, (n, -(-k // 32))), k)
        spread = int(2 * np.sqrt(k)) + 1
        tau = rng.integers(-spread, spread + 1, n).astype(np.float32)
        tau += 0.5 * (rng.random(n) < 0.5)
        flip = np.where(rng.random(n) < 0.3, -1.0, 1.0).astype(np.float32)
        stages.append(dict(w=w, tau=tau, flip=flip, k_true=k))
        k = n
    return stages


def _reference_chain(stages, x):
    """The reference's activation after each stage (``backend="jnp"``)."""
    hs, h = [], jnp.asarray(x)
    for s in stages:
        h = JOPS.binary_matmul_bn_sign_packed(
            h, jnp.asarray(s["w"]), jnp.asarray(s["tau"]),
            jnp.asarray(s["flip"]), k_true=s["k_true"], backend="jnp")
        hs.append(np.asarray(h))
    return hs


def _round32(w):
    return -(-w // 32) * 32


def _block_words(n, c, rank):
    """Block ``rank``'s output words [w0, w1) of an N-channel stage."""
    nw = -(-n // WARP)
    per = -(-nw // c)
    w0 = min(rank * per, nw)
    return w0, min(w0 + per, nw)


def _block_stage(a, s, w0, w1):
    """One block's words [w0, w1) of a stage on its R-row activation tile
    ``a`` (its words up to whole 32-word chunks, as the MMAs read them):
    the weight tiles hold its 256-channel tiles' rows below min(N, 32 w1),
    zero past them and past Kw; y = k_true - 2 (popc(a & ~b) +
    popc(~a & b)) over every chunk below Kw; then the fused epilogue."""
    n, kw = s["w"].shape
    steps = _round32(kw)
    tiles = -(-(w1 - w0) // TILE_WARPS)
    c0 = 32 * w0
    b = np.zeros((tiles * TILE_WARPS * WARP, steps), np.uint32)
    rows = min(n, 32 * w1) - c0
    b[:rows, :kw] = s["w"][c0:c0 + rows]
    a = a[:, :steps]
    y = s["k_true"] - 2 * (popc(a[:, None, :] & ~b[None, :, :])
                           + popc(~a[:, None, :] & b[None, :, :])).sum(-1)
    ch = c0 + np.arange(b.shape[0])
    valid = ch < n
    tau = np.where(valid, s["tau"][np.minimum(ch, n - 1)], 0)
    flip = np.where(valid, s["flip"][np.minimum(ch, n - 1)], 0)
    bit = valid & ((y.astype(np.float32) >= tau) == (flip > 0))
    words = (bit.reshape(len(a), -1, WARP).astype(np.uint64)
             << np.arange(WARP, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return words[:, :w1 - w0]


def cluster_stack(stages, x, rows, c, seed=0):
    """The cluster K6 on (M, Kw_0) words: for each M tile, C blocks, each
    with two garbage-filled activation buffers of ``rows`` x lds words.
    Returns the kernel's output and, per stage but the last, the words
    gathered from every block's next buffer (rows x Nw, each block's
    copy checked equal to the others)."""
    rng = _rng("garbage", seed)
    m, kw0 = x.shape
    widest = max([kw0] + [-(-s["w"].shape[0] // 32) for s in stages])
    lds = TBM.stack_row_stride(widest)
    assert lds % 32 == 16 and lds >= _round32(widest)
    nw_last = -(-stages[-1]["w"].shape[0] // 32)
    out = np.zeros((m, nw_last), np.uint32)
    gathered = [np.zeros((-(-m // rows) * rows, -(-s["w"].shape[0] // 32)),
                         np.uint32) for s in stages[:-1]]
    for m0 in range(0, m, rows):
        bufs = _words(rng, (c, 2, rows, lds))
        xt = np.zeros((rows, _round32(kw0)), np.uint32)
        xt[:min(rows, m - m0), :kw0] = x[m0:m0 + rows]
        bufs[:, 0, :, :xt.shape[1]] = xt            # the tile's input
        for i, s in enumerate(stages):
            cur, nxt = i % 2, (i + 1) % 2
            nw = -(-s["w"].shape[0] // 32)
            last = i == len(stages) - 1
            if not last:        # each block zeroes its next buffer's tail
                bufs[:, nxt, :, nw:_round32(nw)] = 0
            writes = []
            for rank in range(c):
                w0, w1 = _block_words(s["w"].shape[0], c, rank)
                if w1 > w0:
                    writes.append((w0, w1, _block_stage(
                        bufs[rank, cur], s, w0, w1)))
            for w0, w1, words in writes:   # after the stage's barrier
                if last:
                    keep = min(rows, m - m0)
                    out[m0:m0 + keep, w0:w1] = words[:keep]
                else:
                    bufs[:, nxt, :, w0:w1] = words   # into every peer
            if not last:
                for rank in range(1, c):
                    np.testing.assert_array_equal(bufs[rank, nxt, :, :nw],
                                                  bufs[0, nxt, :, :nw])
                gathered[i][m0:m0 + rows] = bufs[0, nxt, :, :nw]
    return out, gathered


def mma_and(a_regs, b_regs):
    """mma.sync.m16n8k256.b1.and.popc on the lanes' registers in the PTX
    layout: lane (g, t)'s A registers hold rows g, g + 8, g, g + 8 at K
    bits 32 t.. (registers 0, 1) and 128 + 32 t.. (2, 3), its B registers
    column g at K bits 32 t.. and 128 + 32 t...  Returns the (16, 8) sums
    of popc(a & b)."""
    a_k = np.zeros((16, 256), np.int64)
    b_k = np.zeros((256, 8), np.int64)
    bit = np.arange(32, dtype=np.uint32)
    for lane in range(WARP):
        g, t = lane >> 2, lane & 3
        ar, br = a_regs[lane], b_regs[lane]
        for row, base, w in ((g, 0, ar[0]), (g + 8, 0, ar[1]),
                             (g, 128, ar[2]), (g + 8, 128, ar[3])):
            a_k[row, base + 32 * t:base + 32 * t + 32] = (w >> bit) & 1
        b_k[32 * t:32 * t + 32, g] = (br[0] >> bit) & 1
        b_k[128 + 32 * t:160 + 32 * t, g] = (br[1] >> bit) & 1
    return a_k @ b_k


def chunk_tile(a, b):
    """``stack_chunk`` on a 16-row x 8-column fragment and one 32-word
    chunk: lane (g, t) loads words 4t..4t+3 of each 16-word group of rows
    g and g + 8 of A and of row g of B; step 0 takes words 4t and 4t+1 as
    slots t and t + 4, step 1 words 4t+2 and 4t+3; each step adds
    popc(a & ~b) and popc(~a & b)."""
    acc = np.zeros((16, 8), np.int64)
    for q in (0, 16):
        for step in (0, 1):
            a_regs, b_regs = [], []
            for lane in range(WARP):
                g, t = lane >> 2, lane & 3
                k = q + 4 * t + 2 * step
                a_regs.append(np.array([a[g, k], a[g + 8, k], a[g, k + 1],
                                        a[g + 8, k + 1]], np.uint32))
                b_regs.append(np.array([b[g, k], b[g, k + 1]], np.uint32))
            acc += mma_and(a_regs, [~r for r in b_regs])
            acc += mma_and([~r for r in a_regs], b_regs)
    return acc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_fragments_match_jnp(seed):
    rng = _rng("chunk", seed)
    a, b = _words(rng, (16, BK)), _words(rng, (8, BK))
    b[3, 20:] = 0                       # zero words (a ragged Kw) add 0
    a[:, 20:] = 0
    acc = chunk_tile(a, b)
    np.testing.assert_array_equal(
        acc, popc(a[:, None, :] ^ b[None, :, :]).sum(-1))
    y = np.asarray(JOPS.binary_matmul_packed(
        jnp.asarray(a), jnp.asarray(b), k_true=32 * BK, backend="jnp"))
    np.testing.assert_array_equal(32 * BK - 2 * acc, y)


STACKS = {
    "ragged 100-40-96-10": ((40, 96, 10), 100),
    "bmlp 4096-4096": ((4096, 4096), 4096),
    "bcnn 8192-1024-1024": ((1024, 1024), 8192),
}


@pytest.mark.parametrize("m_kind", ["1", "15", "16", "17", "2R+1"])
@pytest.mark.parametrize("tile", TBM.STACK_TILES,
                         ids=[f"R{r}-C{c}" for r, c in TBM.STACK_TILES])
@pytest.mark.parametrize("stack", list(STACKS))
def test_cluster_stack_matches_jnp(stack, tile, m_kind):
    rows, c = tile
    m = 2 * rows + 1 if m_kind == "2R+1" else int(m_kind)
    sizes, k0 = STACKS[stack]
    stages = _stack(stack, sizes, k0)
    rng = _rng("x", stack, m)
    x = _tail_zero(_words(rng, (m, -(-k0 // 32))), k0)
    out, gathered = cluster_stack(stages, x, rows, c, seed=m)
    xp = np.zeros((len(gathered[0]) if gathered else m, x.shape[1]),
                  np.uint32)
    xp[:m] = x                 # rows past M are computed on zero input
    want = _reference_chain(stages, xp)
    for i, g in enumerate(gathered):
        np.testing.assert_array_equal(g, want[i], err_msg=f"stage {i}")
    np.testing.assert_array_equal(out, want[-1][:m])


def test_cluster_stack_sixteen_stages_and_empty_blocks():
    """The kernel's most stages, widths of 1 to 8 words (16 blocks leave
    most idle in a stage) and every tile, against the reference."""
    sizes = (64, 33, 100, 32, 7, 64, 200, 31, 96, 40, 128, 9, 64, 64, 250,
             10)
    assert len(sizes) == TBM.STACK_MAX_STAGES
    stages = _stack("sixteen", sizes, 70)
    x = _tail_zero(_words(_rng("x16"), (37, 3)), 70)
    want = _reference_chain(stages, x)[-1]
    for rows, c in TBM.STACK_TILES:
        out, _ = cluster_stack(stages, x, rows, c)
        np.testing.assert_array_equal(out, want)


def test_cluster_stack_matches_pallas_interpret():
    """The model against the reference's single-launch Pallas kernel."""
    stages = _stack("pallas", (40, 96, 10), 100)
    x = _tail_zero(_words(_rng("xp"), (17, 4)), 100)
    want = np.asarray(JBM.binary_dense_stack_packed(
        jnp.asarray(x), [jnp.asarray(s["w"]) for s in stages],
        [jnp.asarray(s["tau"]) for s in stages],
        [jnp.asarray(s["flip"]) for s in stages],
        k_trues=tuple(s["k_true"] for s in stages), interpret=True))
    for rows, c in TBM.STACK_TILES:
        out, _ = cluster_stack(stages, x, rows, c)
        np.testing.assert_array_equal(out, want)


def test_stack_tile_by_shape():
    h100 = {(16, 16): 7, (16, 8): 15, (32, 8): 15}
    assert TBM.stack_tile(1, h100) == (16, 16)
    assert TBM.stack_tile(112, h100) == (16, 16)
    assert TBM.stack_tile(113, h100) == (16, 8)
    assert TBM.stack_tile(240, h100) == (16, 8)
    assert TBM.stack_tile(241, h100) == (32, 8)
    assert TBM.stack_tile(256, h100) == (32, 8)
    assert TBM.stack_tile(8192, h100) == (32, 8)
    small = {(16, 16): 0, (16, 8): 2, (32, 8): 2}
    assert TBM.stack_tile(1, small) == (16, 8)
    for fit in (h100, small):
        for m in (1, 8, 16, 64, 200, 256, 4096):
            assert TBM.stack_tile(m, fit) in TBM.STACK_TILES
    assert TBM.stack_row_stride(128) == 144      # the BMLP's 4096 channels
    assert TBM.stack_row_stride(256) == 272      # the BCNN's 8192 inputs
    assert TBM.stack_row_stride(3) == 48
    # the BCNN's stack at R = 32 fits a block; 577-word rows do not at 16
    assert TBM.stack_smem_bytes(32, 256) <= TBM.STACK_SMEM_BYTES
    assert TBM.stack_smem_bytes(32, 289) > TBM.STACK_SMEM_BYTES
    assert TBM.stack_smem_bytes(16, 576) <= TBM.STACK_SMEM_BYTES
    assert TBM.stack_smem_bytes(16, 577) > TBM.STACK_SMEM_BYTES


# ---------------------------------------------------------------------------
# K5: bitpack.cu
# ---------------------------------------------------------------------------

def aligned_pack(x):
    """The aligned path on (M, K) float32, K % 32 == 0: warps of 32 words;
    load j of lane l is float4 32 j + l of the warp's run, its x >= 0
    nibble shifted to 4 (l % 8); the 8 lanes of a word OR them (xor 1, 2,
    4), and lane l takes word l from lane 8 (l % 4) at load l / 4."""
    m, k = x.shape
    assert k % 32 == 0
    words = m * k // 32
    f4 = x.reshape(-1, 4)
    out = np.zeros(words, np.uint32)
    lane = np.arange(WARP)
    for w0 in range(0, words, 4 * 8):
        regs = np.zeros((8, WARP), np.uint32)
        for j in range(8):
            idx = 8 * w0 + 32 * j + lane
            inside = w0 + 4 * j + lane // 8 < words
            v = np.where(inside[:, None], f4[np.minimum(idx, len(f4) - 1)],
                         -1.0)
            nib = ((v >= 0) << np.arange(4)).sum(-1).astype(np.uint32)
            w = nib << (4 * (lane % 8)).astype(np.uint32)
            for d in (1, 2, 4):
                w = w | w[lane ^ d]
            regs[j] = w
        mine = np.zeros(WARP, np.uint32)
        for j in range(8):
            got = regs[j][8 * (lane % 4)]
            mine = np.where(lane // 4 == j, got, mine)
        keep = w0 + lane < words
        out[(w0 + lane)[keep]] = mine[keep]
    return out.reshape(m, k // 32)


def general_pack(x):
    """The general path: one warp per word, lane = element, lanes past K
    vote 0, __ballot_sync packs."""
    m, k = x.shape
    kw = -(-k // 32)
    out = np.zeros((m, kw), np.uint32)
    for word in range(kw):
        kk = word * 32 + np.arange(WARP)
        vote = (kk[None] < k) & (x[:, np.minimum(kk, k - 1)] >= 0)
        out[:, word] = (vote.astype(np.uint64)
                        << np.arange(WARP, dtype=np.uint64)).sum(-1)
    return out


FLT_MIN = np.float32(1.17549435e-38)     # the smallest normal float32
EDGES = np.array([-0.0, np.nan, 0.0, FLT_MIN, -FLT_MIN, 1e-30, -1e-30],
                 np.float32)


def _edgy(key, m, k, specials=EDGES):
    """Floats with ``specials`` (by default -0.0, NaN, +-0 and the tiniest
    normals) at word and nibble edges and at random places."""
    rng = _rng("edgy", key, m, k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    edges = [i for i in range(k) if i % 32 in (0, 3, 4, 31) or i % 4 == 3]
    for r in range(m):
        cols = rng.choice(edges, size=min(len(edges), 6), replace=False)
        x[r, cols] = rng.choice(specials, size=len(cols))
    flat = x.reshape(-1)
    flat[rng.integers(0, flat.size, max(1, flat.size // 9))] = \
        rng.choice(specials, max(1, flat.size // 9))
    return x


@pytest.mark.parametrize("k", [32, 64, 100, 784, 3584])
@pytest.mark.parametrize("m", [1, 3, 37])
def test_bitpack_paths_match_jnp(m, k):
    x = _edgy("paths", m, k)
    want = np.asarray(JOPS.bitpack(jnp.asarray(x), backend="jnp"))
    np.testing.assert_array_equal(general_pack(x), want)
    if k % 32 == 0:
        np.testing.assert_array_equal(aligned_pack(x), want)


def test_bitpack_matches_pallas_interpret():
    for m, k in ((9, 3584), (5, 784)):
        x = _edgy("pallas", m, k)
        want = np.asarray(JBP.bitpack(jnp.asarray(x), interpret=True))
        np.testing.assert_array_equal(general_pack(x), want)
        if k % 32 == 0:
            np.testing.assert_array_equal(aligned_pack(x), want)


def test_bitpack_denormals_follow_the_contract():
    """Both paths pack by IEEE ``x >= 0`` (the kernel compiles without
    flush-to-zero): a negative denormal packs as 0, a positive one as 1.
    Only the contract is checked here, not the reference: XLA's CPU
    backend reads float32 denormals as zero and packs -1e-45 as 1."""
    tiny = np.array([1e-45, -1e-45, -1e-40, 1e-40], np.float32)
    x = _edgy("denormal", 5, 64, specials=tiny)
    want = general_pack(np.where(x >= 0, 1.0, -1.0).astype(np.float32))
    assert (x == np.float32(-1e-45)).any()
    np.testing.assert_array_equal(general_pack(x), want)
    np.testing.assert_array_equal(aligned_pack(x), want)


def test_bitpack_path_by_shape_and_alignment():
    base = 0x7f0000000000
    for k in (32, 64, 256, 3584, 4096, 8192):
        assert TBP.packs_aligned(k, base)
        assert not TBP.packs_aligned(k, base + 4)    # a row view 4 bytes on
    for k in (1, 31, 33, 100, 784, 1000):
        assert not TBP.packs_aligned(k, base)
