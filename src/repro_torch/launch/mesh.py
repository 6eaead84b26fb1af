"""Device meshes, driven from one process: the sharded packed forward's
and the sharded train step's (``make_host_mesh``), and the dry run's
production mesh (``make_production_mesh``).

The reference is single-controller: one process holds a
``jax.sharding.Mesh`` and runs a ``shard_map`` over it.  The port keeps
that design: a :class:`Mesh` is a grid of positions over named axes,
each position a ``torch.device`` that this process drives.  The same
card may stand at several positions, so one card holds a (2, 2) or
(4, 2) mesh of virtual devices; their shards then run one after
another.  Functions, not module-level meshes: importing this module
touches no device.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


class Mesh:
    """Positions over named axes, row-major, one ``torch.device`` each.

    ``shape`` maps each axis name to its size, in axis order (as a JAX
    mesh's ``shape`` does); ``devices`` holds the device of every
    position, row-major over ``axes``.
    """

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 devices: Sequence):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an empty axis")
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        self.axes = axes
        self.shape = dict(zip(axes, shape))
        self.devices = devices

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, position: int) -> dict[str, int]:
        """{axis: index} of a position (row-major over ``axes``)."""
        out = {}
        for ax in reversed(self.axes):
            position, out[ax] = divmod(position, self.shape[ax])
        return {ax: out[ax] for ax in self.axes}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, 16 x 16 over (data, model), or 2 x
    16 x 16 over (pod, data, model) with ``multi_pod``, as positions on
    the meta device (``meta:0``, ``meta:1``, ...: one device each, as on
    512 chips): the dry run reckons on it and nothing runs there."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, [torch.device("meta", i)
                              for i in range(math.prod(shape))])


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Sequence) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on ``devices``, row-major."""
    return Mesh(shape, axes, devices)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: str = "cuda") -> Mesh:
    """A (data, model) mesh whose positions go round-robin over the
    visible devices of type ``device``: ``"cuda"`` (the default) over the
    cards, so one card holds every position, or ``"cpu"``.  Raises
    ``RuntimeError`` where ``"cuda"`` finds no card: nothing carries on
    on the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' for a "
                               "mesh on the CPU")
        devices = [torch.device("cuda", i % n) for i in range(data * model)]
    elif kind == "cpu":
        devices = [torch.device("cpu")] * (data * model)
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return Mesh((data, model), ("data", "model"), devices)
