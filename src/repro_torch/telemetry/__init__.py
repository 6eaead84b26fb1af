"""Telemetry: the port's observability layer (dependency-free).

The port's own copy of the reference's ``src/repro/telemetry`` (its
static cost probes, which read jaxprs, are not part of it):

* :mod:`repro_torch.telemetry.metrics` — counters / gauges / histograms
  with snapshot, reset, and merge (``MetricsRegistry``).
* :mod:`repro_torch.telemetry.trace` — nestable spans with Chrome
  ``trace_event`` export, near-zero cost when disabled (``Tracer``).

:class:`Telemetry` bundles a registry + tracer; the serving layer owns
one per ``PackedInferenceServer`` (isolated, testable), while
module-level seams that have no object to hang telemetry on
(``kernels.ops.dispatch_batch``) write to the process-wide
:func:`default` instance.
"""
from __future__ import annotations

from repro_torch.telemetry.metrics import (LATENCY_BUCKETS_S, Counter, Gauge,
                                           Histogram, MetricsRegistry,
                                           log_spaced_buckets)
from repro_torch.telemetry.trace import Tracer

__all__ = ["Counter", "Gauge", "Histogram", "LATENCY_BUCKETS_S",
           "MetricsRegistry", "Telemetry", "Tracer", "default",
           "log_spaced_buckets", "set_default"]


class Telemetry:
    """One metrics registry + one tracer, wired together.

    The registry is always live (a counter bump is a few dict/int ops);
    the tracer starts disabled and costs one attribute check per span
    until :meth:`enable_tracing` is called.
    """

    def __init__(self, *, metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def enable_tracing(self) -> "Telemetry":
        self.tracer.enable()
        return self


_default = Telemetry()


def default() -> Telemetry:
    """The process-wide instance used by module-level seams (the kernel
    route counters of ``kernels.ops.dispatch_batch``)."""
    return _default


def set_default(tel: Telemetry) -> Telemetry:
    """Swap the process-wide instance (tests); returns the previous one."""
    global _default
    prev, _default = _default, tel
    return prev
