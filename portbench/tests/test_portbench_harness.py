"""The harness on the CPU: BENCHMARK.json against the contract, every
cell's files found by name, the trace reduction, and whole runs at
small sizes."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import devtrace, harness
from portbench.tests.cells import CELLS, run_small

REPO = harness.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str, most: int = 200) -> bool:
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    for section, keys in KEYS.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            extra = set(e) - keys - ({"workloads"} if section in
                                     ("end_to_end", "per_layer") else set())
            assert set(e) >= keys and not extra, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["per_layer"]:
        assert m["moves"] in names


def test_files_under_paths_are_named_from_name_characters():
    for top in BENCH["paths"]:
        for path in (REPO / top).rglob("*"):
            rel = path.relative_to(REPO)
            if "__pycache__" in rel.parts:
                continue
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(rel)), rel


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(name):
    cell = harness.load_cell(name)
    assert cell.workload["why"]
    net = harness.load_module("networks", cell.cfg["network"])
    for fn in ("input_shape", "n_outputs", "make_params", "work", "build"):
        assert callable(getattr(net, fn))
    traffic = harness.load_module("traffic", cell.workload["kind"])
    assert callable(traffic.make_inputs) and traffic.Driver
    ref = harness.load_module("reference", cell.config)
    assert callable(ref.logits) and callable(ref.output_step)
    assert cell.end_to_end and cell.per_layer
    for m in cell.per_layer:
        reader = harness.load_module("metrics", m["name"])
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
        assert callable(reader.read)
    assert set(cell.workload["limits"]) == {"logit_gap"}


def test_configs_are_the_ports_published_specs():
    from repro_torch.models import cnn
    for name, spec in (("bcnn-cifar10", cnn.BCNNSpec()),
                       ("bmlp-mnist", cnn.BMLPSpec())):
        cfg = harness.load_json(REPO / f"portbench/configs/{name}.json")
        if cfg["network"] == "bcnn":
            assert tuple(cfg["input_hw"]) == spec.input_hw
            assert cfg["c_in"] == spec.c_in and cfg["ksize"] == spec.ksize
            assert [(s["c_out"], s["pool"]) for s in cfg["stages"]] == \
                [(s.c_out, s.pool) for s in spec.stages]
            assert tuple(cfg["dense"]) == spec.dense
        else:
            assert tuple(cfg["sizes"]) == spec.sizes
        assert cfg["nbits_input"] == spec.nbits_input
        assert cfg["reduced"] == []


def test_run_exits_without_a_card(no_card):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr


def test_run_exits_without_the_program(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's folder."""
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[1],
         "--seed", "7", "--seconds", "1", "--trace", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _ev("gpu_memcpy", "Memcpy HtoD", 100, 10),
        _ev("kernel", "void (anonymous namespace)::k3_kernel<4>(int*)", 110,
            50),
        _ev("kernel", "void at::native::elementwise_kernel<...>", 150, 20),
        _ev("kernel", "void at::native::elementwise_kernel<...>", 200, 30),
        _ev("gpu_memset", "Memset", 230, 10),
        _ev("user_annotation", "portbench.wait", 168, 40),
        _ev("user_annotation", "other", 0, 1000),
        _ev("cpu_op", "aten::add", 100, 5),
    ]
    r = devtrace.reduce(events, {"k3_kernel"},
                        devtrace.Reading(batches=2, least_s=1e-5))
    assert r.window_s == pytest.approx(140e-6)
    assert r.busy_s == pytest.approx(110e-6)
    assert r.plain_s == pytest.approx(50e-6)
    assert r.device_ops[0][1] == pytest.approx(50e-6)
    assert r.idle_gaps == [["host in wait (1 gaps)", pytest.approx(30e-6)]]
    for m in ("forward_mfu_pct", "kernels_roofline_pct", "plain_ops_ms",
              "device_idle_pct"):
        assert harness.load_module("metrics", m).read(r) > 0
    assert harness.load_module("metrics", "host_enqueue_ms").read(r) is None


def test_trace_reduction_without_device_events():
    r = devtrace.reduce([], set(), devtrace.Reading(batches=3, least_s=1e-5))
    for m in ("forward_mfu_pct", "kernels_roofline_pct", "plain_ops_ms",
              "device_idle_pct"):
        assert harness.load_module("metrics", m).read(r) is None


@pytest.mark.parametrize("name", CELLS)
def test_small_run_is_correct(name):
    out = run_small(name)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] < 1e-3
    assert set(out["metrics"]) == {"inputs_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_small_traced_run_reports_per_layer_metrics(name):
    out = run_small(name, traced=True, seconds=2.0)
    assert out["correct"]
    assert "host_enqueue_ms" in out["metrics"]
    assert "inputs_per_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
