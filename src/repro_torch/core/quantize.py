"""Quantization policy: how the paper's technique plugs into any model.

``QuantMode`` selects how the linear maps of a model execute:

* ``FLOAT``          the float path (bfloat16 or float32 by the config);
* ``BINARY_WEIGHT``  1-bit packed weights with a per-output-channel scale,
                     real activations: the ±1 weights are unpacked and
                     contracted by a float matmul;
* ``BINARY``         1-bit weights and activations (BinaryNet semantics:
                     sign activations, XNOR-popcount dot).

``GemmStrategy`` selects how a ``BINARY`` dot on packed weights runs:

* ``VPU_XNOR``   the activations packed 32 to a word (K5) and contracted
                 against the packed weights by XNOR-popcount (K4);
* ``MXU_UNPACK`` the weights unpacked to ±1 and contracted by a float
                 matmul;
* ``AUTO``       by the number of rows, :meth:`QuantConfig.resolve_strategy`.

Both strategies compute the same integers.  ``backend`` is the backend of
the XNOR route's kernels, handed unchanged to ``kernels.ops`` (which
resolves it): ``'auto'`` launches the CUDA kernels for CUDA tensors and
runs their plain versions for CPU tensors, ``'torch'`` runs the plain
versions on any device, ``'cuda'`` needs CUDA tensors.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class QuantMode(str, enum.Enum):
    FLOAT = "float"
    BINARY_WEIGHT = "binary_weight"
    BINARY = "binary"


class GemmStrategy(str, enum.Enum):
    VPU_XNOR = "vpu_xnor"
    MXU_UNPACK = "mxu_unpack"
    AUTO = "auto"


# The most rows that ``GemmStrategy.AUTO`` sends to the XNOR route.
XNOR_MAX_ROWS = 256


@dataclass(frozen=True)
class QuantConfig:
    mode: QuantMode = QuantMode.FLOAT
    strategy: GemmStrategy = GemmStrategy.AUTO
    backend: str = "auto"

    def resolve_strategy(self, m: int, n: int, k: int) -> GemmStrategy:
        """The ``AUTO`` rule: up to ``XNOR_MAX_ROWS`` rows of activations
        the packed weights' bytes bind, so ``VPU_XNOR``; above it
        ``MXU_UNPACK``.  The crossover is the reference's; the route
        changes no value."""
        del n, k
        return (GemmStrategy.VPU_XNOR if m <= XNOR_MAX_ROWS
                else GemmStrategy.MXU_UNPACK)
