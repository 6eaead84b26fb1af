"""CLI for the merged static-analysis report::

    PYTHONPATH=src python -m repro_torch.analysis [--write|--check|--json]
                                                  [--no-sharded]

``--check`` fails on a hard violation (packedness escape, launch over a
block's shared memory, lint or sharding violation) and on any drift from
``ANALYSIS_baseline.json`` beside ``report.py``; ``--write`` regenerates
that baseline after an intended change.  The port's mesh is
single-controller (``launch/mesh.py``), so the sharding cells need no
extra devices: their positions share the card, or the CPU without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import report as R


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's merged static-analysis report")
    ap.add_argument("--write", action="store_true",
                    help="regenerate the committed baseline")
    ap.add_argument("--check", action="store_true",
                    help="check the invariants and diff against the "
                         "baseline; exit 1 on any violation or drift")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("--no-sharded", action="store_true",
                    help="skip the sharding cells")
    ap.add_argument("--baseline", default=R.BASELINE_PATH)
    args = ap.parse_args(argv)

    report = R.merged_report(sharded=not args.no_sharded)
    if args.json:
        print(json.dumps(report, indent=1))
    if args.write:
        os.makedirs(os.path.dirname(args.baseline), exist_ok=True)
        with open(args.baseline, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {len(report['cells'])} analysis cells -> "
              f"{args.baseline}")
    if args.check:
        bad = R.report_ok(report)
        if bad:
            print(f"ANALYSIS VIOLATIONS ({len(bad)}):")
            for line in bad:
                print(f"  {line}")
            return 1
        if R.check_against(report, args.baseline, what="ANALYSIS",
                           regenerate="PYTHONPATH=src python -m "
                                      "repro_torch.analysis --write"):
            return 1
        print(f"analysis clean, matches baseline "
              f"({len(report['cells'])} cells)")
    if not (args.json or args.write or args.check):
        for name, cell in report["cells"].items():
            if name.startswith("packedness/"):
                print(f"{name}: {cell['launch_count']} launches, "
                      f"max_live_unpacked={cell['max_live_unpacked_bytes']}B"
                      f" escapes={len(cell['escapes'])}")
            elif name.startswith("smem/"):
                worst = max(cell, key=lambda c: c["bytes"], default=None)
                if worst:
                    print(f"{name}: {len(cell)} launches, worst "
                          f"{worst['kernel']} {worst['bytes']}B "
                          f"fits={worst['fits']}")
            elif name == "lint":
                print(f"lint: {len(cell['violations'])} violation(s)")
            else:
                print(f"{name}: kinds={cell['kinds']} "
                      f"violations={len(cell['violations'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
