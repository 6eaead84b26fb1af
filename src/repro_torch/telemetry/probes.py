"""Static cost probes: standing regression gates on what a forward
launches, independent of wall-clock noise.

Each cell traces a packed forward on fake card tensors
(``analysis.graph``: nothing runs, no card needed) and records only
facts of the program:

* the launch count and each launch's kernel, grid and route (the
  instance it takes), in launch order;
* the GEMV-vs-GEMM route ``kernels.ops.dispatch_batch`` gives the batch;
* the largest tensor an op outside a kernel makes (bytes and shape);
* for sharded cells, the collectives of one sharded forward on a (4, 2)
  mesh at batch 8 from the port's gather counters
  (``analysis.collectives``): kinds and the bytes a device receives.

Cells: the reference's (``repro/telemetry/probes.py``): the smoke demo
BCNN and BMLP and the reduced gemma2-9b LM at batches 1, 8 and 32, and
``sharded/{bmlp,bcnn}_4x2``; and the paper's networks at full width,
``BCNNSpec()`` and ``BMLPSpec()`` at batches 1 and 256 in both
``dense_stack`` modes.  Launches are named by the port's kernels;
:data:`REFERENCE_KERNELS` names the reference's Pallas bodies each one
stands for.

    PYTHONPATH=src python -m repro_torch.telemetry.probes --check

fails on any drift from ``PROBES_baseline.json`` beside this file; after
an intended kernel, grid or route change, regenerate it with ``--write``
and commit the diff.  The traces take the card's SM count, or 132 (an
H100 SXM's) without one, so the baseline holds on the H100 and here.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.kernels import library as _lib

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_PATH = os.path.join(HERE, "PROBES_baseline.json")
SHARDED_MESH = (4, 2)
DEMO_BATCHES = (1, 8, 32)
FULL_BATCHES = (1, 256)
MODES = ("auto", "per_layer")

# The reference's Pallas kernel bodies each port kernel stands for
# (``src/repro/kernels/``), from each kernel's record
# (``KernelSpec.reference``); K4 and K4-fused by route.
REFERENCE_KERNELS = {k: spec.reference for k, spec in _lib.SPECS.items()}
reference_bodies = _lib.reference_bodies


def probe_forward(packed: dict, batch: int, *,
                  dense_stack: str = "auto") -> dict:
    """The static cost of one packed forward at ``batch`` on the kernels'
    route, from its fake trace."""
    from repro_torch.analysis import graph
    from repro_torch.analysis.report import cuda_forward, forward_input
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    tr = graph.trace(lambda p, x: cuda_forward(p, x, dense_stack), packed,
                     forward_input(packed, batch))
    launches = tr.launches()
    best = max(graph.intermediates(tr), key=lambda vi: vi[0].nbytes)[0]
    return {
        "kind": cnn.packed_kind(packed), "batch": batch, "backend": "cuda",
        "dense_stack": dense_stack,
        "launch_count": len(launches),
        "launches": [{"kernel": ln.kernel, "grid": list(ln.grid),
                      "route": ln.route} for ln in launches],
        "route": ops.dispatch_batch(batch,
                                    cnn.packed_dense_kw_words(packed)),
        "max_intermediate_bytes": best.nbytes,
        "max_intermediate_shape": list(best.shape),
    }


def probe_sharded(packed: dict, batch: int, *,
                  mesh_shape: tuple[int, int] = SHARDED_MESH) -> dict:
    """The collectives of one forward of ``packed`` on a (data, model)
    mesh (every position on the card, or the CPU without one): kinds,
    the bytes a device receives, and the shard plan."""
    from repro_torch.analysis.report import mesh_device, sharded_collectives
    from repro_torch.models import cnn
    fwd, counted = sharded_collectives(cnn.to_device(packed, mesh_device()),
                                       mesh_shape, batch)
    return {
        "kind": fwd.kind, "mesh": list(mesh_shape), "batch": batch,
        "shard_plan": {k: list(v) for k, v in fwd.shard_plan.items()},
        "collective_bytes": float(sum(counted.bytes_by_kind.values())),
        "collective_kinds": counted.kinds,
    }


def full_width_packed(kind: str) -> dict:
    """``BCNNSpec()`` or ``BMLPSpec()`` from seed 0, packed on the CPU."""
    from repro_torch.models import cnn
    gen = torch.Generator().manual_seed(0)
    if kind == "bcnn":
        spec = cnn.BCNNSpec()
        return cnn.pack_bcnn(cnn.init_bcnn(gen, spec), spec, device="cpu")
    spec = cnn.BMLPSpec()
    return cnn.pack_bmlp(cnn.init_bmlp(gen, spec), spec, device="cpu")


def standard_report(*, sharded: bool = True) -> dict:
    """The committed probe cells (module docstring); keys are stable,
    they are the baseline's diff surface."""
    from repro_torch.analysis.report import demo_packed
    cells = {}
    for kind in ("bmlp", "bcnn", "transformer"):
        packed = demo_packed(kind)
        for batch in DEMO_BATCHES:
            cells[f"{kind}/b{batch}"] = probe_forward(packed, batch)
        if sharded and kind != "transformer":
            cells[f"sharded/{kind}_{SHARDED_MESH[0]}x{SHARDED_MESH[1]}"] = \
                probe_sharded(packed, batch=8)
    for kind in ("bmlp", "bcnn"):
        packed = full_width_packed(kind)
        for batch in FULL_BATCHES:
            for mode in MODES:
                cells[f"{kind}_full/b{batch}/{mode}"] = probe_forward(
                    packed, batch, dense_stack=mode)
    return {"schema": 1, "cells": cells}


def main(argv: list[str] | None = None) -> int:
    from repro_torch.analysis.report import check_against
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.probes",
        description="static cost probes of the port's packed forwards")
    ap.add_argument("--write", action="store_true",
                    help="regenerate the committed baseline")
    ap.add_argument("--check", action="store_true",
                    help="diff against the baseline; exit 1 on drift")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("--no-sharded", action="store_true",
                    help="skip the collective cells")
    ap.add_argument("--baseline", default=BASELINE_PATH)
    args = ap.parse_args(argv)

    report = standard_report(sharded=not args.no_sharded)
    if args.json:
        print(json.dumps(report, indent=1))
    if args.write:
        with open(args.baseline, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {len(report['cells'])} probe cells -> "
              f"{args.baseline}")
    if args.check:
        if check_against(report, args.baseline, what="PROBE",
                         regenerate="PYTHONPATH=src python -m "
                                    "repro_torch.telemetry.probes --write"):
            return 1
        print(f"probes match baseline ({len(report['cells'])} cells)")
    if not (args.json or args.write or args.check):
        for name, cell in report["cells"].items():
            if "launch_count" in cell:
                print(f"{name}: {cell['launch_count']} launches "
                      f"route={cell['route']} "
                      f"max_intermediate={cell['max_intermediate_bytes']}B "
                      f"{cell['max_intermediate_shape']}")
            else:
                print(f"{name}: collectives={cell['collective_kinds']} "
                      f"{cell['collective_bytes']:.0f}B "
                      f"plan={cell['shard_plan']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
