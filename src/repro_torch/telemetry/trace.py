"""Span tracer with Chrome ``trace_event`` export (Perfetto-loadable).

The port's own copy of the reference's tracer
(``src/repro/telemetry/trace.py``): the same events, fields and export.

    tracer = Tracer(enabled=True)
    with tracer.span("flush", batch=4):
        with tracer.span("pack"):
            ...
    tracer.export("trace.json")        # open in https://ui.perfetto.dev

Design points:

* **Near-zero cost when disabled** — ``span()`` returns one shared
  no-op context manager without allocating; the only work on the
  disabled path is an attribute check and one read of the profiler's
  state.  The serving layer leaves its tracer disabled by default.
* **Seen by ``torch.profiler``** — while a profiler session records,
  ``span()`` also opens a ``torch.profiler.record_function`` range for
  its body, enabled tracer or not: the span lands in the profiler's
  trace as a ``user_annotation`` event on the kernels' clock, and Kineto
  links every kernel to the runtime call that launched inside it.  The
  session is the switch; ``add_complete`` and ``instant`` stay in this
  buffer only (a past interval cannot be opened in the profiler).
* **Nestable** — spans are emitted as Chrome ``"ph": "X"`` (complete)
  events with microsecond ``ts``/``dur``; Perfetto reconstructs nesting
  per thread from the timestamps, so plain ``with`` nesting renders as
  a flame stack.
* **Bounded** — at ``max_events`` the tracer stops recording and counts
  drops (``tracer.dropped``) instead of growing without bound; a
  long-running server cannot leak its trace buffer.
* **Explicit-time spans** — ``add_complete(name, t0_ns, t1_ns)`` emits
  a span whose endpoints were captured earlier with ``now_ns()``; the
  serving queue uses it for per-flush queue-wait spans (submit time →
  flush start) without holding a context manager open across calls.

The buffer's clock is ``time.perf_counter_ns`` (injectable for tests)
and is independent of any simulated serving clock; it is not the
profiler's, which stamps the wall clock from its trace's base time, so
an exported buffer cannot be laid over a profiler trace.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable

import torch

#: True while a ``torch.profiler`` session records (0.1 us a call)
_profiling = torch._C._autograd._profiler_enabled


class _NoopSpan:
    """Shared disabled-path context manager: no allocation per span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: dict,
                 profiled: bool):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._range = (torch.profiler.record_function(name) if profiled
                       else None)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        self._tracer.add_complete(self._name, self._t0,
                                  self._tracer._clock(), **self._args)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Tracer:
    """Collects Chrome-trace events; see module docstring."""

    def __init__(self, *, enabled: bool = False, max_events: int = 200_000,
                 clock_ns: Callable[[], int] = time.perf_counter_ns):
        self.enabled = enabled
        self.max_events = max_events
        self._clock = clock_ns
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self.dropped = 0

    # -- recording ---------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def now_ns(self) -> int:
        """Tracer-clock timestamp for later :meth:`add_complete`."""
        return self._clock()

    def span(self, name: str, **args):
        """Context manager timing its body, and a ``record_function``
        range while a profiler session records.  Disabled tracer and no
        profiler: a shared no-op (near-zero cost)."""
        if not self.enabled:
            return torch.profiler.record_function(name) if _profiling() \
                else _NOOP
        return _Span(self, name, args, _profiling())

    def add_complete(self, name: str, t0_ns: int, t1_ns: int,
                     **args) -> None:
        """Emit one complete ("X") span from explicit tracer-clock
        endpoints (no-op while disabled)."""
        if not self.enabled:
            return
        self._append({"name": name, "ph": "X", "ts": t0_ns / 1e3,
                      "dur": max(0.0, (t1_ns - t0_ns) / 1e3),
                      "pid": 0, "tid": threading.get_ident() % 100_000,
                      **({"args": args} if args else {})})

    def instant(self, name: str, **args) -> None:
        """Point-in-time event ("i" phase)."""
        if not self.enabled:
            return
        self._append({"name": name, "ph": "i", "s": "t",
                      "ts": self._clock() / 1e3, "pid": 0,
                      "tid": threading.get_ident() % 100_000,
                      **({"args": args} if args else {})})

    def _append(self, event: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    # -- export ------------------------------------------------------------

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def span_names(self) -> list[str]:
        return sorted({e["name"] for e in self.events})

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def chrome_trace(self) -> dict:
        """The Chrome ``trace_event`` JSON object (Perfetto-loadable)."""
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
