"""The least time one batch of a network needs on an H100 SXM.

A layer's least time is the larger of its operations at the peak of the
fastest route that computes them and its bytes at the memory rate; a
network's least time is the sum over its layers.  Bytes count each input
read once and each output written once: activations per input, weights
and folded batch norm once per batch.  The counts follow from the
network's shapes alone, not from which kernel runs a layer, so a change
of route in the program never makes them stale.

The peaks are frozen here so that the yardstick does not move between
runs.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# The same data sheet: int8 tensor cores, dense, 1,979 TOP/s (2 ops per
# MAC).  A uint8 x +-1 dot (the first layer on raw pixels) runs on them
# as an unsigned-by-signed int8 product.
INT8_OPS_PER_S = 1.979e15
# NVIDIA publishes no 1-bit tensor-core rate for the H100.  This is the
# mma.sync m16n8k256 .and.popc issue rate on register operands with every
# SM busy, 2 ops per bit-MAC, measured on an H100 80GB HBM3 at a 700 W
# power limit by src/repro_torch/csrc/mma_probe.cu.
B1_OPS_PER_S = 1.021e16

PEAK_OPS_PER_S = {"int8": INT8_OPS_PER_S, "b1": B1_OPS_PER_S}


@dataclass(frozen=True)
class Layer:
    """One layer's work for one input (``macs``, ``act_bytes``) and for
    the whole batch (``weight_bytes``); ``route`` keys ``PEAK_OPS_PER_S``."""
    name: str
    route: str
    macs: int
    act_bytes: float
    weight_bytes: float

    def least_s(self, batch: int) -> float:
        ops_s = 2 * self.macs * batch / PEAK_OPS_PER_S[self.route]
        bytes_s = (self.act_bytes * batch + self.weight_bytes) / HBM_BYTES_PER_S
        return max(ops_s, bytes_s)


def least_time_s(layers: list[Layer], batch: int) -> float:
    """The least time the card could take for one batch."""
    return sum(layer.least_s(batch) for layer in layers)


def bn_bytes(channels: int) -> int:
    """A folded batch norm: a float32 threshold and a float32 sign."""
    return 8 * channels


def first_conv(name: str, hw: tuple[int, int], c_in: int, c_out: int,
               k: int, out_hw: tuple[int, int]) -> Layer:
    """A SAME conv on raw uint8 pixels against +-1 weights, BN-sign and
    a 1-bit output; ``out_hw`` is after any pooling."""
    h, w = hw
    return Layer(name, "int8", h * w * c_out * k * k * c_in,
                 h * w * c_in + out_hw[0] * out_hw[1] * c_out / 8,
                 c_out * k * k * c_in / 8 + bn_bytes(c_out))


def binary_conv(name: str, hw: tuple[int, int], c_in: int, c_out: int,
                k: int, out_hw: tuple[int, int]) -> Layer:
    """A SAME conv on 1-bit activations and weights, BN-sign and a 1-bit
    output; ``out_hw`` is after any pooling."""
    h, w = hw
    return Layer(name, "b1", h * w * c_out * k * k * c_in,
                 h * w * c_in / 8 + out_hw[0] * out_hw[1] * c_out / 8,
                 c_out * k * k * c_in / 8 + bn_bytes(c_out))


def first_dense(name: str, k: int, n: int) -> Layer:
    """A dense layer on raw uint8 inputs against +-1 weights, BN-sign and
    a 1-bit output."""
    return Layer(name, "int8", k * n, k + n / 8, k * n / 8 + bn_bytes(n))


def binary_dense(name: str, k: int, n: int, *, logits: bool = False) -> Layer:
    """A dense layer on 1-bit activations and weights: BN-sign and a 1-bit
    output, or with ``logits`` the output batch norm and float32 logits."""
    out = 4 * n if logits else n / 8
    return Layer(name, "b1", k * n, k / 8 + out, k * n / 8 + bn_bytes(n))
