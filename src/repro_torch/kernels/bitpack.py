"""Sign-binarize + bit-pack along the last axis (C1/C3), and its CUDA
kernel (K5).

Turns a real (M, K) tensor into (M, ceil(K/32)) words, LSB-first: bit =
(x >= 0), zero-bit tail.  Weights are packed once at load; activations
that arrive as reals (the bit planes of the BMLP's first layer, the
operands of ``ops.binary_matmul`` and ``ops.binary_conv2d``) are packed
by this kernel at every call.  Its plain version is
``binarize.pack_bits``.

The wrapper launches the kernel and takes CUDA tensors only;
``kernels/ops.py`` routes CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core import binarize as B
from repro_torch.kernels import _build


def bitpack(x: torch.Tensor) -> torch.Tensor:
    """K5: float32 (M, K) -> (M, ceil(K/32)) int32 words, bit = (x >= 0).

    -0.0 packs as 1 and NaN as 0.  Adds one to ``bitpack.launches`` per
    kernel launch.
    """
    dev = _build.cuda_device(x, "x")
    m, k = x.shape
    out = torch.empty((m, B.packed_width(k)), dtype=torch.int32, device=dev)
    lib = _build.load("bitpack", {"bitpack": "ppiip"})
    err = lib.bitpack(_build.require(x, "x", torch.float32, (m, k), dev),
                      out.data_ptr(), m, k, _build.stream_of(x))
    _build.check(err, "bitpack")
    bitpack.launches += 1
    return out


bitpack.launches = 0
