"""Cells of BENCHMARK.json cut to sizes a CPU test holds: the same
files, network kinds, traffic and limits, smaller widths and batches."""
from __future__ import annotations

import copy
import time

import torch

from portbench import harness

CELLS = ("bcnn-cifar10.offline-b512", "bmlp-mnist.offline-b4096")
SMALL_CFG = {
    "bcnn": {"input_hw": [8, 8], "dense": [128, 10],
             "stages": [{"c_out": 64, "pool": False},
                        {"c_out": 64, "pool": True}]},
    "bmlp": {"sizes": [784, 256, 256, 10]},
}
SMALL_TRAFFIC = {"batch": 4, "ring": 4, "inflight": 2, "trace_batches": 3}


def small_cell(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(name))
    cell.cfg.update(SMALL_CFG[cell.cfg["network"]])
    cell.workload["params"].update(SMALL_TRAFFIC)
    return cell


def run_small(name: str, *, seed: int = 2 ** 31 + 11, seconds: float = 0.4,
              traced: bool = False, make_forward=None) -> dict:
    torch.set_num_threads(2)
    return harness.run_cell(small_cell(name), seed, seconds, traced, "cpu",
                            time.perf_counter(), make_forward=make_forward)

