"""The port's telemetry (``repro_torch.telemetry``) against the
reference's (``repro.telemetry``): the same calls give the same
snapshots, percentiles, merges, trace events and span names; the
registry stays exact while a reporter thread snapshots it during
``step()``, the use its module docstring names."""
import json
import sys
import threading

import numpy as np
import pytest

from repro import telemetry as JT
from repro.models import cnn as JC
from repro.train import serve as JSV
from repro_torch import convert as CV
from repro_torch import telemetry as TT
from repro_torch.train import serve as TSV


def test_bucket_ladders_match():
    assert TT.LATENCY_BUCKETS_S == JT.LATENCY_BUCKETS_S
    for spec in ((1e-6, 100.0, 4), (1e-3, 1.0, 1), (0.5, 7.0, 3)):
        assert TT.log_spaced_buckets(*spec) == JT.log_spaced_buckets(*spec)
    for bad in ((0.0, 1.0, 4), (1.0, 1.0, 4), (1e-3, 1.0, 0)):
        with pytest.raises(ValueError):
            TT.log_spaced_buckets(*bad)


def _drive_registry(tel, seed, reg=None):
    """A fixed mix of instrument calls from a numpy seed."""
    rng = np.random.default_rng(seed)
    reg = tel.MetricsRegistry() if reg is None else reg
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0:
            reg.counter(f"c.{rng.integers(0, 3)}").inc(int(rng.integers(0,
                                                                        5)))
        elif op == 1:
            reg.gauge("g.depth").set(float(rng.normal()))
        elif op == 2:
            reg.histogram("h.lat").observe(float(10 ** rng.uniform(-7, 3)))
        else:
            reg.histogram("h.coarse", (0.1, 1.0, 10.0)).observe(
                float(rng.uniform(0, 20)))
    return reg


def _reporting(reg):
    """Start a thread that snapshots ``reg`` until the returned stop()
    is called; stop() joins it and returns the snapshots it took."""
    stop, seen = threading.Event(), []

    def report():
        while not stop.is_set():
            seen.append(reg.snapshot())

    t = threading.Thread(target=report)
    t.start()

    def finish():
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive()
        return seen
    return finish


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_reference(seed):
    """The same calls on both registries, the port's with a reporter
    thread snapshotting it throughout."""
    mine = TT.MetricsRegistry()
    finish = _reporting(mine)
    try:
        _drive_registry(TT, seed, mine)
    finally:
        seen = finish()
    assert seen
    ref = _drive_registry(JT, seed)
    assert mine.snapshot() == ref.snapshot()
    assert mine.names() == ref.names()
    for name in mine.names():
        assert mine.value(name) == ref.value(name)
    assert mine.value("never.touched") == ref.value("never.touched") == 0
    for name in ("h.lat", "h.coarse"):
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert mine.histogram(name).percentile(q) == \
                ref.histogram(name).percentile(q)
    snap = mine.snapshot()
    mine.merge(snap)
    ref.merge(ref.snapshot())
    assert mine.snapshot() == ref.snapshot()
    mine.reset()
    ref.reset()
    assert mine.snapshot() == ref.snapshot()
    fresh = TT.MetricsRegistry()
    fresh.merge(snap)                          # creates what it lacks
    assert fresh.snapshot() == snap


@pytest.mark.parametrize("tel", [TT, JT], ids=["port", "reference"])
def test_registry_errors(tel):
    reg = tel.MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.histogram("h").percentile(0.5)
    reg.histogram("h").observe(1.0)
    with pytest.raises(ValueError):
        reg.histogram("h").percentile(1.5)
    other = tel.MetricsRegistry()
    other.histogram("h", (1.0, 2.0)).observe(1.0)
    with pytest.raises(ValueError):
        reg.merge(other.snapshot())
    with pytest.raises(ValueError):
        reg.merge({"y": {"type": "bogus"}})
    with pytest.raises(ValueError):
        tel.Histogram(reg._lock, (2.0, 1.0))


def _drive_tracer(tel, enabled=True, max_events=200_000):
    ticks = iter(range(0, 10**9, 1000))
    tr = tel.Tracer(enabled=enabled, max_events=max_events,
                    clock_ns=lambda: next(ticks))
    with tr.span("flush", batch=4):
        with tr.span("pack"):
            tr.instant("submit", rid=1)
        t0 = tr.now_ns()
        tr.add_complete("queue_wait", t0 - 5000, t0, rid=1)
    tr.add_complete("backwards", 9000, 1000)   # clamped to 0 duration
    return tr


@pytest.mark.parametrize("enabled,max_events", [(True, 200_000), (True, 3),
                                                (False, 200_000)])
def test_tracer_matches_reference(enabled, max_events, tmp_path):
    mine = _drive_tracer(TT, enabled, max_events)
    ref = _drive_tracer(JT, enabled, max_events)
    assert mine.events == ref.events
    assert mine.chrome_trace() == ref.chrome_trace()
    assert mine.span_names() == ref.span_names()
    assert mine.dropped == ref.dropped
    assert len(mine.events) == (min(5, max_events) if enabled else 0)
    path = tmp_path / "trace.json"
    mine.export(str(path))
    assert json.loads(path.read_text()) == json.loads(
        json.dumps(ref.chrome_trace()))
    mine.clear()
    assert mine.events == [] and mine.dropped == 0


def test_telemetry_bundle_and_default():
    tel = TT.Telemetry()
    assert not tel.tracer.enabled
    assert tel.enable_tracing() is tel and tel.tracer.enabled
    with tel.span("x"):
        pass
    assert tel.tracer.span_names() == ["x"]
    mine = TT.Telemetry()
    prev = TT.set_default(mine)
    try:
        assert TT.default() is mine
    finally:
        assert TT.set_default(prev) is mine
    assert TT.default() is prev


def _bmlp_pair():
    params, spec, _ = JC.demo_model("bmlp", smoke=True)
    return ({"params": params, "spec": spec, "kind": "bmlp"},
            {"params": CV.params_to_torch(params),
             "spec": CV.bmlp_spec(spec), "kind": "bmlp"})


def test_server_spans_match_reference():
    """The same script through both servers with tracing on: the same
    span names, each as many times."""
    jreg, treg = _bmlp_pair()
    counts = []
    for sv, reg, extra in ((JSV, jreg, {"backend": "jnp"}),
                           (TSV, treg, {})):
        clock = sv.SimClock()
        srv = sv.PackedInferenceServer(
            max_batch=4, clock=clock, timeout_grace=2.0,
            **({"device": "cpu"} if sv is TSV else {}))
        srv.telemetry.enable_tracing()
        srv.register("m", **reg, **extra)
        xs = np.random.default_rng(0).integers(0, 256, (7, 784), np.uint8)
        for x in xs[:5]:
            srv.submit(x)
        srv.step()
        clock.advance(0.011)
        srv.step()
        srv.submit(xs[5], deadline=0.001)
        clock.advance(0.01)
        srv.step()                              # a timeout, no cohort
        srv.serve([xs[6]])
        names = [e["name"] for e in srv.telemetry.tracer.events]
        counts.append({n: names.count(n) for n in set(names)})
    assert counts[1] == counts[0]
    assert set(counts[1]) == {
        "serve.submit", "serve.bucket_pad", "serve.queue_wait",
        "serve.pack", "serve.dispatch", "serve.compute", "serve.complete",
        "serve.flush"}


def test_reporter_thread_reads_while_step_runs():
    """A reporter thread snapshots the server's registry in a loop while
    the main thread submits and steps: no read fails, no count ever goes
    back between snapshots, and the final counts are exact."""
    _, treg = _bmlp_pair()
    clock = TSV.SimClock()
    srv = TSV.PackedInferenceServer(max_batch=4, clock=clock, device="cpu")
    srv.register("m", **treg)
    xs = np.random.default_rng(1).integers(0, 256, (40, 784), np.uint8)
    stop = threading.Event()
    seen, errors = [], []

    def report():
        try:
            while not stop.is_set():
                snap = srv.telemetry.metrics.snapshot()
                seen.append((snap["serve.submitted"]["value"],
                             snap["serve.completed"]["value"],
                             snap["serve.request_latency_s"]["count"]))
        except Exception as e:            # surfaced by the assert below
            errors.append(e)

    reporter = threading.Thread(target=report)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reporter.start()
        for x in xs:
            srv.submit(x)
            clock.advance(0.003)
            srv.step()
        clock.advance(1.0)
        srv.step()
    finally:
        stop.set()
        reporter.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not reporter.is_alive() and errors == []
    assert seen
    for (s0, c0, h0), (s1, c1, h1) in zip(seen, seen[1:]):
        assert s1 >= s0 and c1 >= c0 and h1 >= h0
    m = srv.telemetry.metrics
    assert m.value("serve.submitted") == m.value("serve.completed") == 40
    assert m.value("serve.request_latency_s") == 40


def test_registry_loses_no_update_across_threads():
    """More writer threads than cores, a short switch interval: counters
    and histograms stay exact (the registry's lock)."""
    reg = TT.MetricsRegistry()
    n_threads, n_ops = 16, 2000

    def work(i):
        c, h = reg.counter("c"), reg.histogram("h")
        for k in range(n_ops):
            c.inc()
            h.observe(1e-3 * (k % 7 + 1))
            reg.gauge(f"g{i}").set(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert reg.value("c") == n_threads * n_ops
    h = reg.histogram("h")
    assert h.count == sum(h.counts) == n_threads * n_ops
    assert all(reg.value(f"g{i}") == n_ops - 1 for i in range(n_threads))

