"""Merged static-analysis report: every pass over the demo networks and
the reduced LM, keyed like the reference's ``ANALYSIS_baseline.json``.

Cells (stable keys: they are the baseline's diff surface):

* ``packedness/{bmlp,bcnn,transformer}``: the packedness verdict of each
  packed forward at batch 8 (the reduced gemma2-9b LM at (8, 8));
* ``smem/{kind}_b8``: the per-launch shared-memory estimates (kernel,
  route, grid, threads, bytes, fits) of the same forwards, the
  counterpart of the reference's ``vmem/{kind}_b8``;
* ``lint``: the lint pass over ``src/repro_torch`` (no violation);
* ``sharding/{bmlp,bcnn}_4x2``: the collective rule's verdict on a
  (4, 2) mesh at batch 8, from the gather counters of one sharded
  forward (every position on the card, or on the CPU without one).

``python -m repro_torch.analysis --check`` fails on a hard violation
(:func:`report_ok`) and on any drift from the committed
``ANALYSIS_baseline.json`` beside this file; after an intended change,
``--write`` regenerates it and the diff is committed.  The forwards are
traced on fake card tensors, so the report is the same on a host without
a card as on the H100 (132 SMs either way).
"""
from __future__ import annotations

import os
from typing import Any

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_PATH = os.path.join(HERE, "ANALYSIS_baseline.json")
SHARDED_MESH = (4, 2)
REPORT_BATCH = 8
LM_SEQ = 8                      # the reference's reduced LM serves max_len 8


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def demo_packed(kind: str) -> dict:
    """The demo configs every standing gate traces, packed on the CPU from
    seed 0: the smoke-sized BCNN and BMLP (``cnn.demo_model``) and the
    reduced gemma2-9b binary LM (``max_len`` 8)."""
    from repro_torch.models import cnn
    gen = torch.Generator().manual_seed(0)
    if kind == "transformer":
        from repro_torch import configs
        from repro_torch.models import transformer as tf
        spec = configs.GEMMA2_9B.reduced()
        return tf.pack_transformer(tf.init_binary_lm(gen, spec), spec,
                                   max_len=LM_SEQ, device="cpu")
    params, spec, kind = cnn.demo_model(kind, smoke=True, gen=gen)
    pack = cnn.pack_bcnn if kind == "bcnn" else cnn.pack_bmlp
    return pack(params, spec, device="cpu")


def forward_input(packed: dict, batch: int) -> torch.Tensor:
    """A zero input of ``batch`` examples for a packed network."""
    from repro_torch.models import cnn
    dtype = (torch.int32 if cnn.packed_kind(packed) == "transformer"
             else torch.uint8)
    return torch.zeros((batch, *cnn.packed_input_shape(packed)), dtype=dtype)


def cuda_forward(packed: dict, x, dense_stack: str = "auto"):
    """``make_packed_forward`` on the kernels' route, as a function of the
    packed tree and the input (what ``graph.trace`` twins)."""
    from repro_torch.models import cnn
    return cnn.make_packed_forward(packed, backend="cuda",
                                   dense_stack=dense_stack)(x)


def packedness_cell(kind: str, *, batch: int = REPORT_BATCH) -> dict:
    from repro_torch.analysis.packedness import (analyze_packedness,
                                                 model_policy)
    packed = demo_packed(kind)
    return analyze_packedness(cuda_forward, packed,
                              forward_input(packed, batch),
                              policy=model_policy(kind)).to_json()


def smem_cell(kind: str, *, batch: int = REPORT_BATCH) -> list[dict]:
    from repro_torch.analysis.smem import estimate_forward
    packed = demo_packed(kind)
    return [e.to_json() for e in
            estimate_forward(cuda_forward, packed,
                             forward_input(packed, batch))]


def lint_cell(root: str | None = None) -> dict:
    from repro_torch.analysis.lint import lint_paths
    root = os.path.join(repo_root(), "src", "repro_torch") if root is None \
        else root
    return {"violations": [str(v).replace(repo_root() + os.sep, "")
                           for v in lint_paths([root])]}


def mesh_device() -> str:
    """Where a report's mesh positions live: the card, else the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def sharded_collectives(packed: dict, mesh_shape: tuple[int, int],
                        batch: int):
    """One sharded forward of ``packed`` on a ``mesh_shape`` (data, model)
    mesh: ``(ShardedForward, Collectives)``."""
    from repro_torch.analysis.collectives import count_collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    dev = mesh_device()
    mesh = make_host_mesh(*mesh_shape, device=dev)
    fwd = SH.make_sharded_forward(packed, mesh)
    x = forward_input(packed, batch).to(dev)
    _, counted = count_collectives(fwd.forward_int, x,
                                   positions=mesh_shape[0] * mesh_shape[1])
    return fwd, counted


def sharding_cell(kind: str, *,
                  mesh_shape: tuple[int, int] = SHARDED_MESH) -> dict:
    from repro_torch.analysis.collectives import check_mesh
    from repro_torch.models import cnn
    packed = cnn.to_device(demo_packed(kind), mesh_device())
    _, counted = sharded_collectives(packed, mesh_shape, REPORT_BATCH)
    return check_mesh(counted, mesh_shape).to_json()


def merged_report(*, sharded: bool = True) -> dict:
    """Every pass over the canonical cells (module docstring)."""
    cells: dict[str, Any] = {}
    for kind in ("bmlp", "bcnn", "transformer"):
        cells[f"packedness/{kind}"] = packedness_cell(kind)
        cells[f"smem/{kind}_b{REPORT_BATCH}"] = smem_cell(kind)
    cells["lint"] = lint_cell()
    if sharded:
        for kind in ("bmlp", "bcnn"):
            cells[f"sharding/{kind}_{SHARDED_MESH[0]}x{SHARDED_MESH[1]}"] = \
                sharding_cell(kind)
    return {"schema": 1, "cells": cells}


def report_ok(report: dict) -> list[str]:
    """Hard invariant failures of a merged report, whatever the baseline:
    packedness escapes or incomplete coverage, launches over a block's
    shared memory, lint or sharding violations."""
    bad: list[str] = []
    for key, cell in report["cells"].items():
        if key.startswith("packedness/"):
            bad += [f"{key}: {e}" for e in cell["escapes"]]
            if not cell["complete"]:
                bad.append(f"{key}: a launch read a value the trace did "
                           f"not see made")
        elif key.startswith("smem/"):
            bad += [f"{key}: {c['kernel']} grid={c['grid']} needs "
                    f"{c['bytes']} B of shared memory (over a block's)"
                    for c in cell if not c["fits"]]
        elif key == "lint":
            bad += [f"lint: {v}" for v in cell["violations"]]
        elif key.startswith("sharding/"):
            bad += [f"{key}: {v}" for v in cell["violations"]]
    return bad


def diff_reports(baseline: Any, current: Any, path: str = "") -> list[str]:
    """Recursive structural diff, one line per drift; both CLIs' gate
    (``telemetry/probes.py`` takes it from here)."""
    out: list[str] = []
    if isinstance(baseline, dict) and isinstance(current, dict):
        for k in sorted(set(baseline) | set(current)):
            p = f"{path}/{k}" if path else str(k)
            if k not in baseline:
                out.append(f"{p}: NEW (not in baseline)")
            elif k not in current:
                out.append(f"{p}: MISSING (in baseline only)")
            else:
                out += diff_reports(baseline[k], current[k], p)
        return out
    if isinstance(baseline, list) and isinstance(current, list):
        if len(baseline) != len(current):
            out.append(f"{path}: length {len(baseline)} -> {len(current)}")
        for i, (b, c) in enumerate(zip(baseline, current)):
            out += diff_reports(b, c, f"{path}[{i}]")
        return out
    if baseline != current:
        out.append(f"{path}: {baseline!r} -> {current!r}")
    return out


def check_against(report: dict, baseline_path: str, *, what: str,
                  regenerate: str) -> int:
    """Diff ``report`` against the baseline at ``baseline_path`` (only the
    cells the report has); print the drift and return 1, else 0."""
    import json
    with open(baseline_path) as f:
        baseline = json.load(f)
    baseline = {"schema": baseline["schema"],
                "cells": {k: v for k, v in baseline["cells"].items()
                          if k in report["cells"]}}
    drift = diff_reports(baseline, report)
    if drift:
        print(f"{what} DRIFT vs {baseline_path} ({len(drift)} "
              f"differences):")
        for line in drift:
            print(f"  {line}")
        print(f"If intentional, regenerate: {regenerate}")
        return 1
    return 0
