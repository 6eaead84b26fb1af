"""Metrics registry: counters, gauges, and log-bucketed histograms.

The port's own copy of the reference's registry
(``src/repro/telemetry/metrics.py``), with the same names, bucket edges,
snapshot layout and percentile rule, so that snapshots of the two
compare key for key.  Dependency-free and thread-safe — the serving queue mutates counters
from whatever thread drives ``step()`` while a reporter thread can
``snapshot()`` concurrently.  Three instrument kinds:

* :class:`Counter` — monotone event count (``serve.cache.hits``,
  ``serve.route.gemv``).
* :class:`Gauge` — last-written value (``serve.queue_depth``).
* :class:`Histogram` — fixed log-spaced buckets (default: the shared
  latency ladder :data:`LATENCY_BUCKETS_S`, 1 µs … 100 s, 4 buckets per
  decade).  Bucket edges are FIXED at construction so snapshots from
  different processes/runs merge exactly (``MetricsRegistry.merge``).

``snapshot()`` returns plain dicts (JSON-able: the serving CLI's
``--metrics`` prints one), ``reset()`` zeroes
every instrument in place, and ``merge()`` folds another snapshot in:
counters/histograms add, gauges take the merged-in value.

Metric NAMES are dotted paths: ``serve.*`` from the server
(``train/serve.py``), ``ops.dispatch.*`` from ``kernels.ops.dispatch_batch``
and ``faults.injected.*`` from ``runtime/faults.py``.
"""
from __future__ import annotations

import threading


def log_spaced_buckets(lo: float = 1e-6, hi: float = 100.0,
                       per_decade: int = 4) -> tuple[float, ...]:
    """Log-spaced bucket upper edges covering [lo, hi].

    Edges are generated as exact powers ``lo * 10**(i/per_decade)`` and
    rounded to 6 significant digits so two processes always agree on
    them bit-for-bit (merge compatibility).
    """
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket spec ({lo}, {hi}, {per_decade})")
    edges = []
    i = 0
    while True:
        e = float(f"{lo * 10 ** (i / per_decade):.6g}")
        edges.append(e)
        if e >= hi:
            return tuple(edges)
        i += 1


#: The one latency bucket ladder every histogram in the repo defaults
#: to: 1 µs … 100 s, 4 buckets per decade (33 buckets + overflow).
LATENCY_BUCKETS_S = log_spaced_buckets(1e-6, 100.0, 4)


class Counter:
    """Monotone counter.  ``inc`` rejects negative deltas."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def _merge(self, snap: dict) -> None:
        with self._lock:
            self._value += int(snap["value"])


class Gauge:
    """Last-written value (float)."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def _snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def _merge(self, snap: dict) -> None:
        with self._lock:
            self._value = float(snap["value"])


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.

    ``buckets`` are UPPER edges; one implicit overflow bucket catches
    everything above the last edge.  ``percentile(q)`` is nearest-rank
    over the bucket counts and returns the covering bucket's upper edge
    (the exact observed max for the overflow bucket) — an upper bound on
    the true percentile, same spirit as Prometheus ``histogram_quantile``
    but rank-based so a single observation reports itself exactly when
    it lands alone in a bucket ladder.
    """

    def __init__(self, lock: threading.Lock,
                 buckets: tuple[float, ...] = LATENCY_BUCKETS_S):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be sorted and unique: {buckets}")
        self._lock = lock
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = self._bucket_index(v)
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def _bucket_index(self, v: float) -> int:
        lo, hi = 0, len(self.buckets)
        while lo < hi:                       # first edge >= v
            mid = (lo + hi) // 2
            if self.buckets[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        return lo                            # == len(buckets) -> overflow

    @property
    def counts(self) -> tuple[int, ...]:
        return tuple(self._counts)

    def percentile(self, q: float) -> float:
        if self.count == 0:
            raise ValueError("percentile of an empty histogram")
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        rank = min(self.count - 1, int(self.count * q))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen > rank:
                if i < len(self.buckets):
                    return self.buckets[i]
                return self.max              # overflow: exact observed max
        raise AssertionError("unreachable: counts/count disagree")

    def _snapshot(self) -> dict:
        with self._lock:
            return {"type": "histogram", "count": self.count,
                    "sum": self.sum, "min": self.min, "max": self.max,
                    "buckets": list(self.buckets),
                    "counts": list(self._counts)}

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self.count = 0
            self.sum = 0.0
            self.min = None
            self.max = None

    def _merge(self, snap: dict) -> None:
        if list(snap["buckets"]) != list(self.buckets):
            raise ValueError(
                "cannot merge histograms with different bucket edges")
        with self._lock:
            for i, c in enumerate(snap["counts"]):
                self._counts[i] += int(c)
            self.count += int(snap["count"])
            self.sum += float(snap["sum"])
            for k, pick in (("min", min), ("max", max)):
                other = snap[k]
                if other is None:
                    continue
                mine = getattr(self, k)
                setattr(self, k, other if mine is None
                        else pick(mine, other))


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named instruments, created on first touch.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` get-or-
    create; asking for an existing name with a different kind raises
    (one name, one meaning).  All instruments share the registry's lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, kind: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, _KINDS[kind]):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter", lambda: Counter(self._lock))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge", lambda: Gauge(self._lock))

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = LATENCY_BUCKETS_S
                  ) -> Histogram:
        return self._get(name, "histogram",
                         lambda: Histogram(self._lock, buckets))

    def value(self, name: str):
        """Convenience read: counter/gauge value, histogram count; 0 for
        a name nothing has touched yet (absence == nothing happened)."""
        m = self._metrics.get(name)
        if m is None:
            return 0
        return m.count if isinstance(m, Histogram) else m.value

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict[str, dict]:
        """JSON-able {name: {"type": ..., ...}} of every instrument."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m._snapshot() for name, m in items}

    def reset(self) -> None:
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m._reset()

    def merge(self, snapshot: dict[str, dict]) -> None:
        """Fold another registry's ``snapshot()`` into this one:
        counters and histograms add, gauges take the merged value.
        Instruments absent here are created with the snapshot's kind."""
        for name, snap in snapshot.items():
            kind = snap["type"]
            if kind == "histogram":
                m = self.histogram(name, tuple(snap["buckets"]))
            elif kind == "gauge":
                m = self.gauge(name)
            elif kind == "counter":
                m = self.counter(name)
            else:
                raise ValueError(f"unknown metric type {kind!r} ({name})")
            m._merge(snap)
