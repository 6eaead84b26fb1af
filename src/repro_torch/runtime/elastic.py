"""Elastic scaling: re-mesh on a device-set change.

When devices are lost (or added), the forward moves to a mesh over a
different device count.  ``remesh_plan`` computes the largest valid
(data, model) mesh for the survivors, keeping the model-parallel degree
where it can (weights re-place cheaply along data; moving the model axis
re-lays every packed word).  ``checkpoint.load_packed_checkpoint`` with a
mesh, or ``distributed.sharding.reshard_packed``, does the re-placing.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.launch.mesh import Mesh, make_mesh


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    def build(self, devices: Sequence) -> Mesh:
        """The planned mesh over ``devices`` (one per position)."""
        return make_mesh(self.shape, self.axes, devices)


def remesh_plan(n_devices: int, *, prefer_model: int,
                min_model: int = 1) -> MeshPlan:
    """Largest (data, model) factorization of ``n_devices`` keeping the
    model-parallel degree at ``prefer_model`` when it divides, else the
    largest power-of-two divisor of ``n_devices`` that is
    ``<= prefer_model`` (clamped to ``>= min_model``).  The degree never
    *grows* past ``prefer_model`` on a shrink, so ``min_model`` must be
    ``<= prefer_model``.

    Raises ``ValueError`` for a non-positive device count (an empty
    survivor set has no mesh: the supervisor must escalate, not serve),
    when ``min_model > prefer_model``, or when ``min_model`` does not
    divide ``n_devices``.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if prefer_model < 1 or min_model < 1:
        raise ValueError(
            f"prefer_model/min_model must be >= 1, got "
            f"{prefer_model}/{min_model}")
    if min_model > prefer_model:
        raise ValueError(
            f"min_model={min_model} exceeds prefer_model={prefer_model} "
            f"— honoring it would grow the model degree on a shrink")
    if n_devices % prefer_model == 0:
        model = prefer_model
    else:
        model = 1
        while model * 2 <= prefer_model and n_devices % (model * 2) == 0:
            model *= 2
    if model < min_model:
        if n_devices % min_model:
            raise ValueError(
                f"cannot honor min_model={min_model}: it does not divide "
                f"n_devices={n_devices} (largest divisor <= "
                f"prefer_model={prefer_model} is {model})")
        model = min_model
    return MeshPlan((n_devices // model, model), ("data", "model"))
