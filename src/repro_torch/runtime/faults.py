"""Fault injection for the serving stack (chaos harness).

The port's copy of the reference's ``src/repro/runtime/faults.py``: the
same fault kinds, plan and dispatch counting, installed on the port's
:class:`~repro_torch.train.serve.PackedInferenceServer`.

A :class:`FaultPlan` is an ordered script of :class:`FaultSpec`\\ s, each
armed at a global DISPATCH index (every dispatch attempt counts: first
tries, retries, and bisection halves alike — the retry loop is exactly
what the harness must exercise).  :class:`FaultInjector` compiles the
plan into a ``flush_hook`` for :class:`~repro_torch.train.serve.
PackedInferenceServer` — the seam ``_flush_window`` routes every device
dispatch through — so faults fire inside the real retry/bisect/requeue
machinery, not around it.  Driven by ``SimClock`` the whole scenario is
deterministic: backoff sleeps advance the simulated clock, slow flushes
are clock jumps, and no test ever sleeps wall-time.

Fault kinds (the matrix ``tests/test_torch_serve.py`` sweeps against the
reference's server):

* ``transient``  — the dispatch raises :class:`TransientFlushError` for
  ``times`` attempts, then heals; with ``times <= RetryPolicy.
  max_retries`` every request still completes ``ok`` (retries > 0).
* ``persistent`` — the cohort caught at the armed dispatch is poisoned
  wholesale: any dispatch containing one of its rids keeps raising
  :class:`PersistentFlushError`, so retries exhaust, bisection drains,
  and each of its requests completes ``error`` — while later traffic is
  untouched (failure isolation).
* ``poison``     — one request (``rid``) fails every dispatch containing
  it; bisection isolates it in O(log batch) dispatches, the poison rid
  completes ``error`` and its former cohort-mates complete ``ok``.
* ``device_loss`` — the dispatch raises :class:`~repro_torch.train.serve.
  DeviceLossError` once; the server requeues the window (zero requests
  lost) and re-raises for its caller (``runtime.supervisor.
  ServingSupervisor``, which shrinks the mesh).
* ``slow``       — the dispatch completes but only after ``delay_s``
  (clock jump); with ``timeout_grace`` set, requests still queued
  behind the slow flush age past their grace and complete ``timeout``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.train.serve import DeviceLossError

FAULT_KINDS = ("transient", "persistent", "poison", "device_loss", "slow")


class InjectedFault(RuntimeError):
    """Base class for all injected (simulated) failures."""


class TransientFlushError(InjectedFault):
    """A flush failure that heals after ``times`` attempts."""


class PersistentFlushError(InjectedFault):
    """A flush failure that never heals for the afflicted cohort."""


class PoisonRequestError(InjectedFault):
    """A single request that fails every batch containing it."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault.

    ``at_dispatch`` is the 0-based index of the dispatch attempt that
    arms the fault (the injector counts every attempt it sees).
    ``times`` (transient) is how many attempts fail before healing;
    ``rid`` (poison) targets one request; ``survivors`` (device_loss)
    is the post-loss device count; ``delay_s`` (slow) the injected
    stall.
    """
    kind: str
    at_dispatch: int = 0
    times: int = 1
    rid: int | None = None
    survivors: int | None = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        if self.kind == "poison" and self.rid is None:
            raise ValueError("poison fault needs a target rid")
        if self.kind == "device_loss" and self.survivors is None:
            raise ValueError("device_loss fault needs a survivor count")


@dataclasses.dataclass
class FaultPlan:
    """An ordered fault script plus the injector bookkeeping it needs."""
    faults: tuple[FaultSpec, ...] = ()

    @classmethod
    def of(cls, *faults: FaultSpec) -> "FaultPlan":
        return cls(faults=tuple(faults))


class FaultInjector:
    """Compiles a :class:`FaultPlan` into a server ``flush_hook``.

    Install with :meth:`attach` (returns self); every injected fault is
    counted in the server's metrics registry under
    ``faults.injected.<kind>`` so the chaos report can assert the
    scenario actually ran.  ``injected`` holds the full event log
    (dispatch index, kind, rids hit).
    """

    def __init__(self, plan: FaultPlan,
                 sleep: Callable[[float], Any] | None = None):
        self.plan = plan
        self._sleep = sleep
        self.dispatches = 0
        self.injected: list[dict] = []
        self._transient_left = {id(f): f.times for f in plan.faults
                                if f.kind == "transient"}
        self._poisoned_cohorts: list[tuple[FaultSpec, frozenset[int]]] = []
        self._fired: set[int] = set()     # one-shot specs already fired
        self._server = None

    def attach(self, server) -> "FaultInjector":
        """Install as ``server.flush_hook`` (inherits the server's sleep
        so SimClock-driven backoff and slow flushes share one clock)."""
        self._server = server
        if self._sleep is None:
            self._sleep = server._sleep
        server.flush_hook = self
        return self

    def _count(self, kind: str) -> None:
        if self._server is not None:
            self._server.telemetry.metrics.counter(
                f"faults.injected.{kind}").inc()

    def _raise(self, spec: FaultSpec, reqs, n: int) -> None:
        rids = [r.rid for r in reqs]
        self.injected.append(
            {"dispatch": n, "kind": spec.kind, "rids": rids})
        self._count(spec.kind)
        if spec.kind == "transient":
            raise TransientFlushError(f"injected transient @ dispatch {n}")
        if spec.kind == "persistent":
            raise PersistentFlushError(
                f"injected persistent @ dispatch {n}")
        if spec.kind == "poison":
            raise PoisonRequestError(f"injected poison rid={spec.rid}")
        if spec.kind == "device_loss":
            raise DeviceLossError(spec.survivors)
        raise AssertionError(spec.kind)

    def __call__(self, eng, buf, reqs, default):
        n = self.dispatches
        self.dispatches += 1
        rids = {r.rid for r in reqs}
        # standing faults first: poisoned cohorts / poison rids keep
        # failing regardless of dispatch index
        for spec, cohort in self._poisoned_cohorts:
            if cohort & rids:
                self._raise(spec, reqs, n)
        for spec in self.plan.faults:
            if spec.kind == "poison" and spec.rid in rids \
                    and n >= spec.at_dispatch:
                self._raise(spec, reqs, n)
        # scripted one-shots / windows keyed on the dispatch counter
        for spec in self.plan.faults:
            if spec.kind == "transient":
                left = self._transient_left[id(spec)]
                if left > 0 and n >= spec.at_dispatch:
                    self._transient_left[id(spec)] = left - 1
                    self._raise(spec, reqs, n)
            elif spec.kind == "persistent":
                if n == spec.at_dispatch and id(spec) not in self._fired:
                    self._fired.add(id(spec))
                    self._poisoned_cohorts.append((spec, frozenset(rids)))
                    self._raise(spec, reqs, n)
            elif spec.kind == "device_loss":
                if n >= spec.at_dispatch and id(spec) not in self._fired:
                    self._fired.add(id(spec))
                    self._raise(spec, reqs, n)
            elif spec.kind == "slow":
                if n == spec.at_dispatch and id(spec) not in self._fired:
                    self._fired.add(id(spec))
                    self.injected.append({"dispatch": n, "kind": "slow",
                                          "rids": sorted(rids)})
                    self._count("slow")
                    (self._sleep or time.sleep)(spec.delay_s)
        return default()
