"""The packed forwards' layer spans: seen by ``torch.profiler`` as
``record_function`` ranges, in the reference's order and names, nested as
the forward nests them; free where neither the tracer nor a profiler
records."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as JT
from repro.models import cnn as JC
from repro_torch import convert as CV
from repro_torch import telemetry as TT
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as TM
from repro_torch.models import cnn as TC
from repro_torch.telemetry import trace as TTR

KINDS = ("bcnn", "bmlp")
BATCH = 4


def _port(kind):
    params, spec, _ = TC.demo_model(kind, smoke=True)
    pack = TC.pack_bcnn if kind == "bcnn" else TC.pack_bmlp
    packed = pack(params, spec, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (BATCH, *TC.packed_input_shape(packed)), np.uint8))
    return packed, spec, x


def _want(kind, spec) -> list:
    """The layer spans of one forward, in order."""
    if kind == "bcnn":
        return (["model.input", "model.bcnn.bitplane_conv"]
                + ["model.bcnn.conv_stage"] * (len(spec.stages) - 1)
                + ["model.bcnn.dense_stack", "model.bcnn.output",
                   "model.bcnn.output"])
    return ["model.input", "model.bmlp.bitplane_dense",
            "model.bmlp.dense_stack", "model.bmlp.output",
            "model.bmlp.output"]


def _profiled(fn, tmp_path) -> list:
    """``fn()`` inside a ``forward`` range under a CPU profiler session;
    returns the session's ranges as (start, end, name), by start."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("forward"):
            fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation")


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("kind", KINDS)
def test_profiler_sees_the_layer_spans_in_order(kind, tmp_path):
    packed, spec, x = _port(kind)
    fwd = TC.make_packed_forward(packed)
    want = fwd(x)
    got = []
    ranges = _profiled(lambda: got.append(fwd(x)), tmp_path)
    assert torch.equal(got[0], want)
    forward = [r for r in ranges if r[2] == "forward"]
    layers = [r for r in ranges if r[2].startswith("model.")]
    assert len(forward) == 1
    assert [r[2] for r in layers] == _want(kind, spec)
    assert all(_inside(r, forward[0]) for r in layers)
    for a, b in zip(layers[:-1], layers[1:]):      # one after another
        assert a[1] <= b[0]


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_forward_nests_each_gather_in_its_stage(kind, tmp_path):
    packed, spec, x = _port(kind)
    fwd = TSH.make_sharded_forward(packed, TM.make_host_mesh(1, 2,
                                                             device="cpu"))
    got = []
    ranges = _profiled(lambda: got.append(fwd(x)), tmp_path)
    assert torch.equal(got[0], TC.make_packed_forward(packed)(x))
    layers = [r for r in ranges if r[2].startswith("model.")]
    gathers = [r for r in ranges if r[2] == "sharding.gather"]
    assert [r[2] for r in layers] == _want(kind, spec)
    assert gathers
    for g in gathers:
        holders = [r[2] for r in layers if _inside(g, r)]
        assert len(holders) == 1
        assert holders[0].split(".")[-1] in (
            "bitplane_conv", "conv_stage", "bitplane_dense", "dense_stack")


@pytest.mark.parametrize("kind", KINDS)
def test_disabled_span_is_the_shared_noop(kind, monkeypatch):
    """No tracer, no profiler: no span object, no ``record_function``."""
    def refuse(*args, **kwargs):
        raise AssertionError("entered the profiler's path")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(TTR, "_Span", refuse)
    prev = TT.set_default(TT.Telemetry())
    try:
        tr = TT.default().tracer
        assert tr.span("model.input") is TTR._NOOP
        assert tr.span("model.bcnn.conv_stage", stage=1) is TTR._NOOP
        packed, _, x = _port(kind)
        TC.make_packed_forward(packed)(x)
        assert tr.events == []
    finally:
        TT.set_default(prev)


def test_profiler_alone_opens_a_range_and_writes_no_event(tmp_path):
    tr = TTR.Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        span = tr.span("model.x")
        assert span is not TTR._NOOP
        with span:
            pass
    assert tr.events == []


def test_enabled_tracer_under_the_profiler_writes_both(tmp_path):
    tr = TTR.Tracer(enabled=True)

    def body():
        with tr.span("model.x", stage=2):
            pass
    ranges = _profiled(body, tmp_path)
    assert "model.x" in [r[2] for r in ranges]
    assert [(e["name"], e["args"]) for e in tr.events] == \
        [("model.x", {"stage": 2})]


def _reference_events(kind) -> list:
    params, spec, _ = JC.demo_model(kind, smoke=True)
    pack = JC.pack_bcnn if kind == "bcnn" else JC.pack_bmlp
    fwd = JC.bcnn_forward_packed if kind == "bcnn" else JC.bmlp_forward_packed
    packed = pack(params, spec)
    x = jnp.asarray(np.random.default_rng(3).integers(
        0, 256, (BATCH, *JC.packed_input_shape(packed)), np.uint8))
    prev = JT.set_default(JT.Telemetry().enable_tracing())
    try:
        fwd(packed, x, backend="jnp")
        return JT.default().tracer.events
    finally:
        JT.set_default(prev)


def _args_by_name(events) -> dict:
    out = {}
    for e in events:
        out.setdefault(e["name"], []).append(e.get("args"))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_layer_span_names_match_the_reference(kind):
    """The enabled buffer holds the reference forward's ``model.*`` names
    on the same smoke network, and ``model.input``: each layer span once
    a forward (the output layer's twice, its batch norm apart), the conv
    stage once a stage, with the reference's arguments."""
    jparams, jspec, _ = JC.demo_model(kind, smoke=True)
    spec = (CV.bcnn_spec if kind == "bcnn" else CV.bmlp_spec)(jspec)
    pack = TC.pack_bcnn if kind == "bcnn" else TC.pack_bmlp
    packed = pack(CV.params_to_torch(jparams), spec, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (BATCH, *TC.packed_input_shape(packed)), np.uint8))
    prev = TT.set_default(TT.Telemetry().enable_tracing())
    try:
        TC.make_packed_forward(packed)(x)
        mine = _args_by_name(TT.default().tracer.events)
    finally:
        TT.set_default(prev)
    ref = _args_by_name(e for e in _reference_events(kind)
                        if e["name"].startswith("model."))
    assert set(mine) == set(ref) | {"model.input"}
    assert sorted(n for n, a in mine.items() for _ in a) == \
        sorted(_want(kind, spec))
    for name, args in ref.items():
        if not name.endswith(".output"):
            assert mine[name] == args, name
