#!/usr/bin/env python3
"""The eager packed forwards of two checkouts of the port, timed in pairs
on one card.

Run on a CUDA card from the root of a checkout, with another checkout
(the parent commit, say, unpacked by ``git archive``) at OTHER::

    python3 chip_forwards_ab.py OTHER [--pairs N]

Each tree runs in a worker process of its own (both hold the package
``repro_torch``), on the tree's own ``src``: it builds the tree's
kernels, makes ``BCNNSpec()`` and ``BMLPSpec()`` from seed 0 (identity
BN) and waits.  Then N pairs (default 10) of readings, the two workers
taking turns and never running at once, OTHER first in even pairs and
this checkout first in odd ones.  A reading times ``make_packed_forward``
in ``'auto'`` at batches 1, 8 and 256 with the batch on the card: ms a
forward, the median over ROUNDS rounds of CALLS forwards each ended by a
synchronize, the garbage collector off.

Prints the card's name and power limit, one JSON line a reading, then
one JSON line with every cell's readings by tree, their medians, the
quartile spread of OTHER's readings, and the pairs this checkout won and
lost (faster or slower than OTHER in the same pair).
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

BATCHES = (1, 8, 256)
ROUNDS, CALLS = 31, 20
HERE = os.path.dirname(os.path.abspath(__file__))


def worker() -> None:
    """Build, make the networks, then one reading for every line on stdin
    (ms a forward of each network and batch, as a JSON line)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import cnn
    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    nets = {"bcnn": cnn.pack_bcnn(cnn.init_bcnn(gen, cnn.BCNNSpec()),
                                  cnn.BCNNSpec(), device=dev),
            "bmlp": cnn.pack_bmlp(cnn.init_bmlp(gen, cnn.BMLPSpec()),
                                  cnn.BMLPSpec(), device=dev)}
    cases = {}
    for kind, packed in nets.items():
        fwd = cnn.make_packed_forward(packed)
        for b in BATCHES:
            x = torch.randint(0, 256, (b, *cnn.packed_input_shape(packed)),
                              generator=gen, dtype=torch.uint8).to(dev)
            cases[f"{kind} B={b}"] = (fwd, x)
    print("ready", flush=True)
    for _ in sys.stdin:
        out = {}
        for cell, (fwd, x) in cases.items():
            for _ in range(CALLS):
                fwd(x)
            torch.cuda.synchronize()
            per = []
            gc.disable()
            try:
                for _ in range(ROUNDS):
                    t0 = time.perf_counter()
                    for _ in range(CALLS):
                        fwd(x)
                    torch.cuda.synchronize()
                    per.append((time.perf_counter() - t0) * 1e3 / CALLS)
            finally:
                gc.enable()
            out[cell] = statistics.median(per)
        print(json.dumps(out), flush=True)


def start(tree: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--worker"], cwd=tree, env=env, text=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    if proc.stdout.readline().strip() != "ready":
        proc.kill()
        raise RuntimeError(f"the worker on {tree} did not start")
    return proc


def reading(proc: subprocess.Popen) -> dict:
    proc.stdin.write("go\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"a worker exited {proc.wait()}")
    return json.loads(line)


def main() -> int:
    args = sys.argv[1:]
    if args == ["--worker"]:
        worker()
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_forwards_ab: no CUDA device", file=sys.stderr)
        return 1
    if not args or args[0].startswith("--"):
        print(__doc__, file=sys.stderr)
        return 2
    pairs = int(args[args.index("--pairs") + 1]) if "--pairs" in args else 10
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    procs = {}
    try:
        procs = {"other": start(os.path.abspath(args[0])),
                 "this": start(HERE)}
        readings = {"other": [], "this": []}
        for i in range(pairs):
            for label in (("other", "this") if i % 2 == 0
                          else ("this", "other")):
                got = reading(procs[label])
                readings[label].append(got)
                print(json.dumps({"pair": i, "tree": label,
                                  "forward_ms": got}), flush=True)
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait(timeout=60)
    cells = {}
    for cell in readings["this"][0]:
        this = [r[cell] for r in readings["this"]]
        oth = [r[cell] for r in readings["other"]]
        q1, _, q3 = statistics.quantiles(oth, n=4)
        cells[cell] = {
            "this": this, "other": oth,
            "this_median": statistics.median(this),
            "other_median": statistics.median(oth),
            "other_quartile_spread": q3 - q1,
            "pairs_won": sum(t < o for t, o in zip(this, oth)),
            "pairs_lost": sum(t > o for t, o in zip(this, oth))}
    print(json.dumps({"pairs": pairs, "cells": cells}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
