"""Packed binary dense GEMM (paper §4.2, C1/C2/C7): its CUDA kernel (K4)
and the single-launch hidden stack (K6).

    out[m, n] = K - 2 * popcount(XOR(a[m, :], b[n, :]))

over packed int32 words, with two epilogues chosen at compile time in
``csrc/xnor_gemm.cu``: the int32 result (:func:`binary_matmul_packed`,
the output layer) or the fused BN-sign threshold + re-bitpack along N
(:func:`binary_matmul_bn_sign_packed`, the hidden layers).  Each call is
one launch of one of two kernels, chosen by shape (:func:`gemm_route`):
up to ``SMALL_M_MAX`` rows of A, XOR + POPC with every weight word read
once; above it, the words fed as they are to the tensor cores' 1-bit
MMA.  The contraction contract (the reference's ``_mismatch_counts``)
is ``binarize.packed_mismatches``.

:func:`binary_dense_stack_packed` (K6, ``csrc/dense_stack.cu``) runs a
whole chain of hidden layers, each GEMM + BN-sign + re-bitpack, in one
launch of thread-block clusters on the same 1-bit MMA, in the tile
:func:`stack_tile` picks; :func:`dense_stack_fits` is the shape rule that
decides when a stack takes it (``kernels.ops.binary_dense_stack_packed``).

Each wrapper launches its kernel and takes CUDA tensors only;
``kernels/ops.py`` routes CPU tensors to the plain versions
(``kernels/ref.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import binarize as B
from repro_torch.kernels import _build
from repro_torch.kernels import smem as S

# The C entry points of csrc/xnor_gemm.cu and csrc/dense_stack.cu, the
# launchers' query entries (``analysis.smem.query_card``) among them.
GEMM_ENTRIES = {"xnor_gemm": "pppiiiiiip",
                "xnor_gemm_bn_sign": "pppppiiiiiip",
                "xnor_gemm_query": "iiiiiipp"}
STACK_ENTRIES = {"dense_stack": "ppppiiiiiiip",
                 "dense_stack_clusters": "iiip",
                 "dense_stack_query": "iiiiipp"}

# K4's routes (csrc/xnor_gemm.cu), chosen by shape.  Up to SMALL_M_MAX
# rows of A the weight bytes bind and the XOR + POPC kernel reads each
# weight word once (ROUTE_SMALL); above it the 1-bit tensor-core kernel
# takes 128 x 128 output tiles (ROUTE_MMA_128) when that grid gives every
# SM a block, else 64 x 64 tiles (ROUTE_MMA_64).  SMALL_M_MAX is the
# crossover of the two kernels at the LM's widths, measured on the H100
# (PERF.md; chip_smoke.py times K4 on both sides of it), and the most rows
# the small kernel takes (csrc/xnor_gemm.cu: kSmallMaxRows).
SMALL_M_MAX = 8
ROUTE_SMALL, ROUTE_MMA_64, ROUTE_MMA_128 = 0, 1, 2

# The H100 residency rule of the single-launch stack (K6).  A thread-block
# cluster of C blocks owns an M tile of R rows (:func:`stack_tile`); each
# block reads its slice of every stage's weights once per cluster, and all
# clusters read the whole stack, so the stack is worth one launch when its
# weights and folded thresholds stay hot in the 50 MB L2 while the clusters
# stream them: 16 MiB, a third of L2, leaves the rest to the activations
# and to whatever else runs.  A block also needs the two activation buffers
# of its R rows (row stride :func:`stack_row_stride`) beside its weight
# ring in shared memory (232,448 bytes on the H100), at the largest R the
# tile rule takes.  The reference's rule (``dense_stack_fits_vmem``) sizes
# the same decision against an 8 MiB VMEM budget; both resolve the BMLP's
# and the BCNN's stacks to the single launch.
STACK_L2_BUDGET_BYTES = 16 * 2**20
STACK_SMEM_BYTES = S.SMEM_BUDGET
STACK_RING_BYTES = 3 * (256 * 48 + 512) * 4   # dense_stack.cu: kRingBytes
STACK_MAX_TILE_ROWS = 32      # the largest R of stack_tile
STACK_MAX_STAGES = 16         # csrc/dense_stack.cu: kMaxStages
# K6's tiles, (R rows of M, C blocks a cluster), in the tile rule's order
# of preference: R is one or two m16 fragments of the 1-bit MMA; C = 8 is
# the portable cluster size, 16 needs the non-portable opt-in
# (csrc/dense_stack.cu sets it).
STACK_TILES = ((16, 16), (16, 8), (32, 8))
STACK_THREADS = 256           # csrc/dense_stack.cu: a block's threads
# csrc/xnor_gemm.cu: the tensor-core kernel's pipeline stages; the XOR +
# POPC kernel's words of K a warp takes and its most warps a block
GEMM_STAGES, SMALL_CHUNK, SMALL_WARPS = 3, 16, 8


def fills_card(m: int, n: int, tile: tuple[int, int], sms: int) -> bool:
    """Whether (tile_m, tile_n) output tiles over an (M, N) output give
    each of ``sms`` SMs a block: the tile rule of the tensor-core kernels
    (K4's :func:`gemm_route`, K3/K7's ``binary_conv.conv_tile``)."""
    return -(-m // tile[0]) * -(-n // tile[1]) >= sms


def gemm_route(m: int, n: int, sms: int) -> int:
    """K4's kernel and tile for an (M, N) output on a card of ``sms``
    SMs: ``ROUTE_SMALL`` up to ``SMALL_M_MAX`` rows, else the tensor-core
    kernel with the largest tile whose grid has a block for every SM."""
    if m <= SMALL_M_MAX:
        return ROUTE_SMALL
    if fills_card(m, n, (128, 128), sms):
        return ROUTE_MMA_128
    return ROUTE_MMA_64


@functools.lru_cache(maxsize=None)
def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev``, which the tile rules take."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=4096)
def gemm_estimate(m: int, n: int, kw: int, fused: bool, vec16: bool,
                  sms: int) -> S.LaunchEstimate:
    """K4's launch (``fused``: K4-fused) for (M, Kw) x (N, Kw) words on a
    card of ``sms`` SMs, on the route :func:`gemm_route` picks: the XOR +
    POPC kernel's warps over 32 columns a block, or the tensor-core
    kernel's tile and operand ring."""
    kernel = "xnor_gemm_bn_sign" if fused else "xnor_gemm"
    route = gemm_route(m, n, sms)
    query = ("xnor_gemm", "xnor_gemm_query",
             (m, n, kw, route, int(vec16), int(fused)))
    if route == ROUTE_SMALL:
        rows = next(r for r in (1, 2, 4, SMALL_M_MAX) if m <= r)
        warps = min(SMALL_WARPS, max(1, S.ceil_div(kw, SMALL_CHUNK)))
        return S.LaunchEstimate(kernel, f"small{rows}",
                                (S.ceil_div(n, 32), 1, 1), warps * 32, (),
                                query)
    bm, bn = (128, 128) if route == ROUTE_MMA_128 else (64, 64)
    return S.LaunchEstimate(
        kernel, f"mma{bm}", (S.ceil_div(n, bn), S.ceil_div(m, bm), 1),
        S.MMA_THREADS, S.mma_ring(GEMM_STAGES, bm, bn), query)


def rows_aligned16(*ptr_kw) -> bool:
    """Whether every row of the (pointer, Kw) word matrices starts on a
    16-byte boundary: the condition of K4's 16-byte ``cp.async``."""
    return all(p % 16 == 0 and kw % 4 == 0 for p, kw in ptr_kw)


def _operands(a_packed: torch.Tensor, b_packed: torch.Tensor):
    """Check both operands; returns the sizes, the device, the pointers
    and the launch's route and alignment flag."""
    m, kw = a_packed.shape
    n = b_packed.shape[0]
    dev = _build.cuda_device(a_packed, "a_packed")
    pa = _build.require(a_packed, "a_packed", torch.int32, (m, kw), dev)
    pb = _build.require(b_packed, "b_packed", torch.int32, (n, kw), dev)
    return (m, n, kw, dev, pa, pb, gemm_route(m, n, sm_count(dev)),
            int(rows_aligned16((pa, kw), (pb, kw))))


def binary_matmul_packed(a_packed: torch.Tensor, b_packed: torch.Tensor, *,
                         k_true: int) -> torch.Tensor:
    """K4, int32 epilogue: (M, Kw) x (N, Kw) words -> (M, N) int32.

    ``k_true`` is the logical K before packing.  Adds one to
    ``binary_matmul_packed.launches`` per kernel launch.
    """
    m, n, kw, dev, pa, pb, route, vec16 = _operands(a_packed, b_packed)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    lib = _build.load("xnor_gemm", GEMM_ENTRIES)
    err = lib.xnor_gemm(pa, pb, out.data_ptr(), m, n, kw, k_true, route,
                        vec16, _build.stream_of(a_packed))
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
    m, n, kw, dev, pa, pb, route, vec16 = _operands(a_packed, b_packed)
    out = torch.empty((m, B.packed_width(n)), dtype=torch.int32, device=dev)
    lib = _build.load("xnor_gemm", GEMM_ENTRIES)
    err = lib.xnor_gemm_bn_sign(
        pa, pb, _build.require(tau, "tau", torch.float32, (n,), dev),
        _build.require(flip, "flip", torch.float32, (n,), dev),
        out.data_ptr(), m, n, kw, k_true, route, vec16,
        _build.stream_of(a_packed))
    _build.check(err, "xnor_gemm_bn_sign")
    binary_matmul_bn_sign_packed.launches += 1
    return out


binary_matmul_bn_sign_packed.launches = 0


def dense_stack_bytes(weights: list) -> int:
    """Bytes of a hidden stack that K6 keeps hot in L2: every stage's
    packed (N_s, Kw_s) weights plus its float32 tau and flip."""
    return sum(int(w.shape[0]) * int(w.shape[1]) * 4 + 2 * int(w.shape[0]) * 4
               for w in weights)


def stack_buffer_words(weights: list) -> int:
    """Words of one activation row buffer: the widest packed activation
    of the stack, its input included."""
    return max([int(weights[0].shape[1])]
               + [B.packed_width(int(w.shape[0])) for w in weights])


def stack_tile(m: int, fit: dict) -> tuple[int, int]:
    """K6's tile for M rows, (R, C), given ``fit``: how many clusters of
    each tile fit the card at once (:func:`stack_clusters`).  The first of
    (16, 16), (16, 8), (32, 8) whose ceil(M / R) clusters all fit at once:
    clusters of 16 blocks while they fit (each block streams a sixteenth
    of the stack), then of 8; tiles of 32 rows (the weights read half as
    often) once 16-row clusters would run in two waves.  On the H100, 7
    clusters of 16 and 15 of 8 fit (``chip_smoke.py`` times every tile at
    every batch)."""
    for rows, cluster in STACK_TILES[:-1]:
        if -(-m // rows) <= fit[rows, cluster]:
            return rows, cluster
    return STACK_TILES[-1]


@functools.lru_cache(maxsize=None)
def stack_clusters(dev, buf_words: int) -> dict:
    """How many clusters of each tile in ``STACK_TILES`` fit CUDA device
    ``dev`` at once, for activation rows of ``buf_words`` words: the
    cluster launch's occupancy query (``cudaOccupancyMaxActiveClusters``),
    0 where the tile's buffers do not fit a block."""
    lib = _build.load("dense_stack", STACK_ENTRIES)
    with torch.cuda.device(dev):
        fit = {}
        for rows, cluster in STACK_TILES:
            n = ctypes.c_int(0)
            _build.check(lib.dense_stack_clusters(
                rows, cluster, stack_row_stride(buf_words),
                ctypes.addressof(n)), "dense_stack_clusters")
            fit[rows, cluster] = n.value
    return fit


def stack_row_stride(buf_words: int) -> int:
    """K6's activation row stride in words for rows of ``buf_words``: whole
    32-word chunks, then 16 mod 32, so the 16-byte fragment loads of two
    rows fall on 32 banks (csrc/dense_stack.cu)."""
    return -(-buf_words // 32) * 32 + 16


def stack_terms(rows: int, buf_words: int) -> tuple[S.SmemTerm, ...]:
    """K6's shared memory a block: the weight ring and two activation
    buffers of ``rows`` rows at :func:`stack_row_stride`."""
    return (S.SmemTerm("weight_ring", STACK_RING_BYTES),
            S.SmemTerm("activations",
                       2 * rows * stack_row_stride(buf_words) * 4))


def stack_smem_bytes(rows: int, buf_words: int) -> int:
    """K6's shared memory a block, in bytes (:func:`stack_terms`)."""
    return sum(t.bytes for t in stack_terms(rows, buf_words))


@functools.lru_cache(maxsize=4096)
def dense_stack_estimate(m: int, rows: int, cluster: int, buf_words: int,
                         vec16: bool) -> S.LaunchEstimate:
    """K6's launch for M rows in clusters of ``cluster`` blocks over
    ``rows``-row tiles, activation rows of ``buf_words`` words."""
    return S.LaunchEstimate(
        "dense_stack", f"{rows}x{cluster}",
        (S.ceil_div(m, rows) * cluster, 1, 1), STACK_THREADS,
        stack_terms(rows, buf_words),
        ("dense_stack", "dense_stack_query",
         (m, rows, cluster, stack_row_stride(buf_words), int(vec16))))


def dense_stack_fits(weights: list) -> bool:
    """Residency decision for K6, pure shape math: (a) the stack's
    weights and thresholds fit ``STACK_L2_BUDGET_BYTES`` and (b) a block's
    weight ring and the two activation buffers of the largest M tile fit
    its shared memory (and the stack has at most ``STACK_MAX_STAGES``
    stages): the estimate of a launch at that tile
    (:func:`dense_stack_estimate`) fits."""
    if not weights or len(weights) > STACK_MAX_STAGES:
        return False
    launch = dense_stack_estimate(
        STACK_MAX_TILE_ROWS, STACK_MAX_TILE_ROWS, STACK_TILES[-1][1],
        stack_buffer_words(weights), True)
    return (dense_stack_bytes(weights) <= STACK_L2_BUDGET_BYTES
            and launch.fits(STACK_SMEM_BYTES))


_STAGE_NAMES = [(f"weights[{s}]", f"taus[{s}]", f"flips[{s}]")
                for s in range(STACK_MAX_STAGES)]


@functools.lru_cache(maxsize=None)
def _stack_tables(n_stages: int):
    """The ctypes array types of K6's pointer and size tables."""
    return ctypes.c_uint64 * (3 * n_stages), ctypes.c_int * (3 * n_stages)


def binary_dense_stack_packed(x_packed: torch.Tensor, weights: list,
                              taus: list, flips: list, *,
                              k_trues) -> torch.Tensor:
    """K6: the whole hidden dense stack in one launch.

    ``x_packed``: (M, Kw_0) words; stage ``s`` applies ``weights[s]``
    (N_s, Kw_s) words, then the folded BN ``taus[s]``/``flips[s]`` (N_s,)
    f32 and re-bitpacks.  ``Kw_0`` must be the input's width and ``Kw_s``
    must be ceil(N_{s-1}/32).  Returns (M, ceil(N_last/32)) words,
    bit-identical to chaining :func:`binary_matmul_bn_sign_packed`.  The
    tile, R rows of M to a cluster of C blocks (:func:`stack_tile`), stays
    inside this wrapper; a stack whose buffers do not fit a block's shared
    memory at that R raises ``SmemBudgetError`` (a ``ValueError``) before
    launching.  Adds one to
    ``binary_dense_stack_packed.launches`` per kernel launch.
    """
    dev = _build.cuda_device(x_packed, "x_packed")
    n_stages = len(weights)
    if not 1 <= n_stages <= STACK_MAX_STAGES or not \
            n_stages == len(taus) == len(flips) == len(k_trues):
        raise ValueError(
            f"the stack takes 1 to {STACK_MAX_STAGES} stages with one "
            f"weight, tau, flip and k_true each; got {n_stages} weights, "
            f"{len(taus)} taus, {len(flips)} flips, {len(k_trues)} k_trues")
    m, kw0 = x_packed.shape
    px = _build.require(x_packed, "x_packed", torch.int32, (m, kw0), dev)
    # One pass over the stages: the pointer and size tables of the launch
    # (csrc/dense_stack.cu: w_0.., tau_0.., flip_0..; N_0.., Kw_0..,
    # k_true_0..), the widest activation row and the copy width.
    ptrs = [0] * (3 * n_stages)
    dims = [0] * (3 * n_stages)
    rows16 = [(px, kw0)]
    prev = buf_words = kw0
    for s, w in enumerate(weights):
        n, kw = w.shape
        if kw != prev:
            raise ValueError(f"stage {s} weights are {kw} words wide, its "
                             f"input is {prev} words")
        w_name, tau_name, flip_name = _STAGE_NAMES[s]
        ptrs[s] = _build.require(w, w_name, torch.int32, (n, kw), dev)
        ptrs[n_stages + s] = _build.require(taus[s], tau_name, torch.float32,
                                            (n,), dev)
        ptrs[2 * n_stages + s] = _build.require(flips[s], flip_name,
                                                torch.float32, (n,), dev)
        dims[s], dims[n_stages + s] = n, kw
        dims[2 * n_stages + s] = int(k_trues[s])
        rows16.append((ptrs[s], kw))
        prev = B.packed_width(n)
        buf_words = max(buf_words, prev)
    rows, cluster = stack_tile(m, stack_clusters(dev, buf_words))
    if stack_smem_bytes(rows, buf_words) > STACK_SMEM_BYTES:
        raise S.SmemBudgetError(
            dense_stack_estimate(m, rows, cluster, buf_words,
                                 rows_aligned16(*rows16)),
            detail=f"activation rows of {buf_words} words do not fit the "
                   f"stack kernel's shared memory at {rows} rows")
    out = torch.empty((m, prev), dtype=torch.int32, device=dev)
    ptr_type, dim_type = _stack_tables(n_stages)
    ptr_arr, dim_arr = ptr_type(*ptrs), dim_type(*dims)
    lib = _build.load("dense_stack", STACK_ENTRIES)
    err = lib.dense_stack(px, out.data_ptr(), ctypes.addressof(ptr_arr),
                          ctypes.addressof(dim_arr), n_stages, m, kw0, rows,
                          cluster, stack_row_stride(buf_words),
                          int(rows_aligned16(*rows16)),
                          _build.stream_of(x_packed))
    _build.check(err, "dense_stack")
    binary_dense_stack_packed.launches += 1
    return out


binary_dense_stack_packed.launches = 0
