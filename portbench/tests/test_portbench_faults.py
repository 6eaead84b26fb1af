"""The comparison fails what it has to: the control (the plain reference
in bfloat16 in the program's place) and faults planted under the timed
path, each driven through a whole run at a CPU test's size."""
import pytest
import torch

from portbench import control, harness
from portbench.tests.cells import CELLS, SMALL_TRAFFIC, run_small


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    ref = harness.load_module("reference", harness.load_cell(name).config)
    out = run_small(name, make_forward=control.control_forward(ref))
    gap = out["checks"]["logit_gap"]
    assert not out["correct"]
    assert gap["value"] > 3 * gap["limit"]


def _planted(fault, at_call):
    """The program's forward with ``fault`` applied to its output from
    call ``at_call`` on (counted from 0; the warm-up's calls come
    first)."""
    def make(cfg, params, device):
        net = harness.load_module("networks", cfg["network"])
        fwd = net.build(cfg, params, device)
        calls = [0]

        def broken(x):
            calls[0] += 1
            if calls[0] > at_call:
                return fault(fwd, x)
            return fwd(x)
        return broken
    return make


def _altered(fwd, x):
    y = fwd(x).clone()
    y[1, 3] += 0.25
    return y


def _half_left_out(fwd, x):
    y = fwd(x[: x.shape[0] // 2])
    return torch.cat([y, torch.zeros_like(y)])


def _half_returned(fwd, x):
    return fwd(x[: x.shape[0] // 2])


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _half_returned])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    at = 2 * SMALL_TRAFFIC["inflight"]           # after the warm-up
    out = run_small(name, make_forward=_planted(fault, at))
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    """On the card, at the cell's own size and load, on three seeds."""
    cell = harness.load_cell(name)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        got = control.reading(cell, seed, 2.0, "control", card)
        assert not got["correct"]
        assert got["logit_gap"] > 3 * cell.workload["limits"]["logit_gap"]
