"""One run of one cell of ``BENCHMARK.json``.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` finds everything by name: the cell in ``BENCHMARK.json``,
its workload file ``workloads/<cell>.json`` (configuration, traffic kind
and parameters, the limits of the comparison), the configuration file
that ``BENCHMARK.json`` names, ``networks/<network>.py`` (the data from
the seed and the program's forward), ``traffic/<kind>.py`` (the
driver), ``reference/<config>.py`` (the plain reference) and
``metrics/<metric>.py`` (one reader per per-layer metric).

A run makes the weights, batch norms and inputs from ``--seed``, builds
the program, warms up the cell's shapes, measures for ``--seconds``,
judges every answer of the window against the reference and prints one
JSON line.  Without enough CUDA devices it exits with 2 and prints no
result; if JAX or the JAX package is loaded once the window has closed,
with 3.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import re
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from portbench import devtrace, judge, roofline

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
THREADS = 4
GLOBAL_FN = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*[(<]")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"portbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: str
    cfg: dict
    workload: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = bench or load_json(REPO / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    workload = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return Cell(name=name, chips=entry["chips"], config=entry["config"],
                cfg=load_json(REPO / config["file"]), workload=workload,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def port_kernels() -> set:
    """The names of the program's own CUDA kernels."""
    from repro_torch.kernels import _build
    names = set()
    for src in sorted(_build.CSRC.glob("*.cu")):
        names.update(GLOBAL_FN.findall(src.read_text()))
    return names


def to_device(tree, device):
    """A copy of a tree of tensors (dicts, lists) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device, t0: float, make_forward=None) -> dict:
    """Run ``cell`` once and return its result line as a dict.
    ``make_forward(cfg, params, device)`` replaces the program's forward
    (the control, and the tests' planted faults)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    net = load_module("networks", cell.cfg["network"])
    traffic_kind = load_module("traffic", cell.workload["kind"])
    ref = load_module("reference", cell.config)
    tp = cell.workload["params"]

    phases = {"imports": time.perf_counter() - t0}

    def phase(name):
        phases[name] = time.perf_counter() - t0 - sum(phases.values())

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = net.make_params(cell.cfg, gen, dev)
    inputs = traffic_kind.make_inputs(tp, net.input_shape(cell.cfg), gen,
                                      dev)
    phase("data")
    fwd = (make_forward or net.build)(cell.cfg, params, dev)
    phase("build")
    recorder = devtrace.Recorder(dev) if traced else None
    driver = traffic_kind.Driver(fwd, inputs, tp,
                                 (tp["batch"], net.n_outputs(cell.cfg)),
                                 dev, recorder)
    driver.warm_up()
    phase("warm_up")
    if recorder is not None:
        recorder.warm_up()
        phase("profiler")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.disable()
    try:
        t_start = time.perf_counter()
        win = driver.window(seconds, t_start,
                            tp["trace_batches"] if traced else 0)
    finally:
        gc.enable()
    setup_s = t_start - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del driver, fwd
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    reading = None
    if traced:
        least = roofline.least_time_s(net.work(cell.cfg), tp["batch"])
        reading = devtrace.reduce(
            recorder.events(), port_kernels(),
            devtrace.Reading(batches=win.traced, least_s=least,
                             enqueue_s=win.traced_enqueue_s))

    ref_params = to_device(params, dev)
    step = ref.output_step(params).numpy()

    def reference(slot):
        with torch.no_grad():
            z = ref.logits(cell.cfg, ref_params, inputs[slot].to(dev))
        return z.double().cpu().numpy()

    widest = judge.widest_gap(win.answers, reference, step)
    limits = cell.workload["limits"]
    checks = {"logit_gap": {"value": widest, "limit": limits["logit_gap"]},
              "malformed_batches": {"value": win.malformed, "limit": 0}}
    correct = (win.answers.count > 0 and widest <= limits["logit_gap"]
               and win.malformed == 0)

    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {**win.end_to_end(), "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": win.enqueued * tp["batch"],
           "failed": win.malformed * tp["batch"], "metrics": metrics,
           "device": dev_info}
    if traced:
        dev_info.update(busy_s=reading.busy_s, window_s=reading.window_s)
        out["breakdown"] = {"device_ops": reading.device_ops,
                            "idle_gaps": reading.idle_gaps}
    out["answers"] = win.answers.count
    out["setup_phases_s"] = phases
    out["checks"] = checks
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    cell = load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0
