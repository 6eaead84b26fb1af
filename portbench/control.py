"""Readings that set the limits of the comparison, on many seeds in one
process: the program's (the lower reading) and the control's, the plain
reference computed in bfloat16 in the program's place (the upper one).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 2 --sides program,control

Each reading drives a whole run of the cell at its own size and load
(``harness.run_cell``) and prints its ``logit_gap`` and ``correct``;
the last line summarises the largest program reading and the smallest
control reading.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

if __name__ == "__main__":
    _repo = Path(__file__).resolve().parent.parent
    sys.path[0:1] = [str(_repo), str(_repo / "src")]

from portbench import harness  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def control_forward(ref):
    """``make_forward`` that serves ``ref.logits`` in ``CONTROL_DTYPE``."""
    def make(cfg, params, device):
        p = harness.to_device(params, device)

        def fwd(x):
            with torch.no_grad():
                return ref.logits(cfg, p, x, dtype=CONTROL_DTYPE).float()
        return fwd
    return make


def reading(cell: harness.Cell, seed: int, seconds: float, side: str,
            device) -> dict:
    """One run of ``cell``: ``side`` is ``"program"`` or ``"control"``."""
    make = None
    if side == "control":
        make = control_forward(harness.load_module("reference", cell.config))
    out = harness.run_cell(cell, seed, seconds, False, device,
                           time.perf_counter(), make_forward=make)
    return {"side": side, "seed": seed, "correct": out["correct"],
            "logit_gap": out["checks"]["logit_gap"]["value"],
            "answers": out["answers"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--sides", default="program,control")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(harness.THREADS)
    cell = harness.load_cell(args.workload)
    rows = []
    for side in args.sides.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            rows.append(reading(cell, seed, args.seconds, side, "cuda"))
            print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": cell.name,
               "device": torch.cuda.get_device_name(0)}
    for side in ("program", "control"):
        gaps = [r["logit_gap"] for r in rows if r["side"] == side]
        if gaps:
            summary[side] = {"seeds": len(gaps), "min": min(gaps),
                             "max": max(gaps)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
