"""Sharding pass: the collective rules of the sharded packed forward,
applied to the port's own counters.

The port has no compiled HLO.  Its single-controller mesh moves data
between positions only where it counts it on the process-wide registry
(``telemetry.default()``): ``sharding.gathers`` / ``gathered_bytes``
(``models/cnn.py::_gather_packed``, the packed-word gather at a sharded
stage's seam), ``sharding.reduces`` / ``reduced_bytes`` and
``sharding.partial_sums`` (``distributed/fsdp.py``).  :func:`count_collectives`
reads them around one call; the rules are the reference's
(``repro/analysis/collectives.py``):

* a data-parallel mesh (``|model| == 1``): no collective at all;
* a model-parallel mesh: packed-word all-gathers only.  A reduce or a
  partial sum would mean an int32 contraction crossed positions unpacked.

Bytes are per device: what each position receives from its peers, the
counter's total over the mesh's positions.  The reference's HLO model
counts each all-gather's whole output instead (a device's own span too),
so for a gather over ``|model|`` positions its figure is the port's times
``|model| / (|model| - 1)``.
"""
from __future__ import annotations

import dataclasses

from repro_torch import telemetry

# The one collective a model-parallel packed forward may make
MODEL_PARALLEL_ALLOWED = frozenset({"all-gather"})
# collective kind -> (count counter, bytes counter or None)
COUNTERS = {"all-gather": ("sharding.gathers", "sharding.gathered_bytes"),
            "all-reduce": ("sharding.reduces", "sharding.reduced_bytes"),
            "partial-sum": ("sharding.partial_sums", None)}


@dataclasses.dataclass(frozen=True)
class Collectives:
    """The collectives of one call: kind -> count, and kind -> bytes a
    device received."""
    kinds: dict[str, int]
    bytes_by_kind: dict[str, float]


@dataclasses.dataclass(frozen=True)
class CollectiveReport:
    """A call's collective inventory and the rule's verdict."""
    kinds: dict[str, int]
    bytes_by_kind: dict[str, float]
    total_bytes: float
    violations: tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {"kinds": dict(sorted(self.kinds.items())),
                "total_bytes": self.total_bytes,
                "violations": list(self.violations)}


def _read() -> dict[str, int]:
    m = telemetry.default().metrics
    return {name: m.value(name) for pair in COUNTERS.values()
            for name in pair if name is not None}


def count_collectives(fn, *args, positions: int = 1):
    """Run ``fn(*args)`` and count its collectives from the counters'
    growth; ``positions`` divides the bytes to a device's share.  Returns
    ``(fn's result, Collectives)``."""
    before = _read()
    out = fn(*args)
    after = _read()
    grew = {k: after[k] - before[k] for k in after}
    kinds, nbytes = {}, {}
    for kind, (count, size) in COUNTERS.items():
        if grew[count]:
            kinds[kind] = grew[count]
            nbytes[kind] = grew[size] / positions if size else 0.0
    return out, Collectives(kinds, nbytes)


def _report(c: Collectives, violations) -> CollectiveReport:
    return CollectiveReport(dict(c.kinds), dict(c.bytes_by_kind),
                            float(sum(c.bytes_by_kind.values())),
                            tuple(violations))


def check_data_parallel(c: Collectives) -> CollectiveReport:
    """Data-parallel rule: no collective at all."""
    return _report(c, [
        f"data-parallel path makes {n}x {kind} "
        f"({c.bytes_by_kind.get(kind, 0.0):.0f} B) - must be "
        f"collective-free" for kind, n in sorted(c.kinds.items())])


def check_model_parallel(c: Collectives, *,
                         allowed: frozenset[str] = MODEL_PARALLEL_ALLOWED
                         ) -> CollectiveReport:
    """Model-parallel rule: only ``allowed`` kinds (the packed-word
    all-gather)."""
    return _report(c, [
        f"off-plan collective: {n}x {kind} "
        f"({c.bytes_by_kind.get(kind, 0.0):.0f} B) - a model mesh allows "
        f"only {sorted(allowed)}"
        for kind, n in sorted(c.kinds.items()) if kind not in allowed])


def check_mesh(c: Collectives, mesh_shape: tuple[int, int]
               ) -> CollectiveReport:
    """The rule of a (data, model) mesh: model degree 1 is the
    data-parallel rule, any other the model-parallel one."""
    if mesh_shape[1] == 1:
        return check_data_parallel(c)
    return check_model_parallel(c)
