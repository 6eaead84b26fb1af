"""Sign-binarize + bit-pack along the last axis (C1/C3), and its CUDA
kernel (K5).

Turns a real (M, K) tensor into (M, ceil(K/32)) words, LSB-first: bit =
(x >= 0), zero-bit tail.  Weights are packed once at load; activations
that arrive as reals (the bit planes of the BMLP's first layer, the
operands of ``ops.binary_matmul`` and ``ops.binary_conv2d``) are packed
by this kernel at every call.  Its plain version is
``binarize.pack_bits``.

The kernel has two paths (``csrc/bitpack.cu``), chosen by shape and
alignment (:func:`packs_aligned`): rows of whole words on 16 bytes take
16-byte loads, several in flight a lane; any other input one warp per
output word.  The wrapper launches the kernel and takes CUDA tensors
only; ``kernels/ops.py`` routes CPU tensors to the plain version.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import binarize as B
from repro_torch.kernels import _build
from repro_torch.kernels import smem as S

# csrc/bitpack.cu's C entry points, its query entry among them
ENTRIES = {"bitpack": "ppiiip", "bitpack_query": "iiipp"}
# csrc/bitpack.cu: the aligned path's output words a warp
WORDS_PER_WARP = 32


def packs_aligned(k: int, ptr: int) -> bool:
    """Whether an (M, K) float32 input at address ``ptr`` takes K5's
    aligned path: rows of whole 32-float words (K % 32 == 0), the data on
    16 bytes.  Every other input takes the warp-per-word path."""
    return k % 32 == 0 and ptr % 16 == 0


@functools.lru_cache(maxsize=4096)
def bitpack_estimate(m: int, k: int, aligned: bool) -> S.LaunchEstimate:
    """K5's launch on an (M, K) float32 input: a warp per WORDS_PER_WARP
    words on the aligned path, per word on the other; no shared memory."""
    words = m * B.packed_width(k)
    warps = S.ceil_div(words, WORDS_PER_WARP) if aligned else words
    return S.LaunchEstimate(
        "bitpack", "aligned" if aligned else "general",
        (S.blocks_for_warps(warps), 1, 1), S.BLOCK_THREADS, (),
        ("bitpack", "bitpack_query", (m, k, int(aligned))))


def bitpack(x: torch.Tensor) -> torch.Tensor:
    """K5: float32 (M, K) -> (M, ceil(K/32)) int32 words, bit = (x >= 0).

    -0.0 packs as 1 and NaN as 0.  Adds one to ``bitpack.launches`` per
    kernel launch.
    """
    dev = _build.cuda_device(x, "x")
    m, k = x.shape
    px = _build.require(x, "x", torch.float32, (m, k), dev)
    out = torch.empty((m, B.packed_width(k)), dtype=torch.int32, device=dev)
    lib = _build.load("bitpack", ENTRIES)
    err = lib.bitpack(px, out.data_ptr(), m, k, int(packs_aligned(k, px)),
                      _build.stream_of(x))
    _build.check(err, "bitpack")
    bitpack.launches += 1
    return out


bitpack.launches = 0
