"""The layer-span reduction (``spans.py``) on a hand-made trace, the
existing reduction unchanged beside it, and on the card the layers adding
up to the busy time at each cell's own size."""
import pytest
import torch

from portbench import devtrace, harness, spans
from portbench.tests.cells import CELLS, small_cell

HOST, OTHER = 1, 2          # the launching thread, and another one


def _ev(cat, name, ts, dur, tid=HOST, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=HOST, cat="cuda_runtime"):
    return _ev(cat, "cudaLaunchKernel", ts, 1, tid, corr)


def _kernel(ts, dur, corr, cat="kernel"):
    return _ev(cat, f"k{corr}", ts, dur, tid=7, corr=corr)


# Times in us.  Host spans on HOST: the harness's enqueue around two
# forwards; the first forward's layers, a gather nested in its first
# layer; the second forward's first layer.
EVENTS = [
    _ev("user_annotation", "portbench.enqueue", 0, 100),
    _ev("user_annotation", "model.input", 1, 4),
    _ev("user_annotation", "model.bmlp.bitplane_dense", 5, 35),
    _ev("user_annotation", "sharding.gather", 30, 5),
    _ev("user_annotation", "model.bmlp.dense_stack", 40, 20),
    _ev("user_annotation", "model.bmlp.output", 60, 10),
    _ev("user_annotation", "portbench.readback", 75, 10),
    _ev("user_annotation", "model.bmlp.bitplane_dense", 190, 7),
    _launch(3, 1), _kernel(175, 5, 1, cat="gpu_memcpy"),  # the H2D copy
    _launch(10, 2), _kernel(100, 30, 2),
    _launch(31, 3), _kernel(130, 20, 3),                # in the gather
    _launch(45, 4), _kernel(160, 10, 4),                # gap queued
    _launch(65, 5, cat="cuda_driver"), _kernel(170, 5, 5),
    _launch(80, 6), _kernel(212, 2, 6, cat="gpu_memset"),
    _launch(195, 7), _kernel(198, 10, 7),               # gap the host made
    _launch(12, 8, tid=OTHER), _kernel(210, 2, 8),      # no span there
    _kernel(90, 5, 9),                                  # launched earlier
    _ev("cpu_op", "aten::add", 10, 3),
]


def test_layer_spans_read_their_hand_computed_values():
    """Busy [90,95] [100,150] [160,180] [198,208] [210,214]: 89 us of a
    124 us window.  Idle 95-100 and 150-160 end in ops queued long
    before; 180-198 ends in an op launched at 195, 15 us late; 208-210
    in one launched at 12."""
    s = spans.reduce(EVENTS)
    want = {"model.bmlp.bitplane_dense": 60, "model.bmlp.dense_stack": 10,
            "model.bmlp.output": 5, "model.input": 5,
            spans.OUTSIDE: 4, spans.BEFORE: 5}
    assert s.device_s == pytest.approx({k: v * 1e-6
                                        for k, v in want.items()})
    assert s.ops == {"model.bmlp.bitplane_dense": 3,
                     "model.bmlp.dense_stack": 1, "model.bmlp.output": 1,
                     "model.input": 1, spans.OUTSIDE: 2, spans.BEFORE: 1}
    assert s.n_spans == 5
    assert s.host_late_s == pytest.approx(15e-6)
    assert s.rest_s == pytest.approx(14e-6)
    assert (s.copy_s, s.copy_ops) == (pytest.approx(5e-6), 1)
    r = devtrace.reduce(EVENTS, set(),
                        devtrace.Reading(batches=2, least_s=1e-6))
    assert r.busy_s == pytest.approx(89e-6)
    assert r.window_s == pytest.approx(124e-6)
    assert spans.readings(s, r.batches, r.window_s) == pytest.approx(
        {"first_layer_ms": 0.03, "packed_layers_ms": 0.0075,
         "host_late_idle_pct": 1500 / 124})
    # the layers and the rest close the sum to busy
    assert s.first_s + s.packed_s + s.rest_s == pytest.approx(r.busy_s)


def test_layer_readings_are_left_out_without_the_programs_spans():
    """A program that opens no ``model.*`` span: the two layer readings
    are left out, the host's share of the idle still reads; a trace with
    no device time reads nothing."""
    events = [e for e in EVENTS if not e["name"].startswith("model.")]
    s = spans.reduce(events)
    assert spans.readings(s, 2, 124e-6) == pytest.approx(
        {"host_late_idle_pct": 1500 / 124})
    assert spans.readings(spans.reduce([]), 2, 0.0) == {}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_keeps_the_events_it_reduces(name):
    """``traced_run`` at a CPU test's size: the harness's result line as
    ever, the reading it reduced, the program's layer spans in it, and
    ``devtrace.reduce`` put back."""
    reduce_trace = devtrace.reduce
    cell = small_cell(name)
    torch.set_num_threads(2)
    out, r, s = spans.traced_run(cell, 2 ** 31 + 7, 2.0, "cpu")
    assert devtrace.reduce is reduce_trace
    assert out["correct"] and "host_enqueue_ms" in out["metrics"]
    assert 1 <= r.batches <= cell.workload["params"]["trace_batches"]
    per_forward = 6 if cell.cfg["network"] == "bcnn" else 5
    assert s.n_spans == per_forward * r.batches
    assert s.device_s == {}


def test_existing_reduction_reads_what_it_read_before():
    """``test_trace_reduction``'s events: the five accepted metrics and
    both breakdown lists, as the reduction read them before the layer
    spans."""
    events = [
        _ev("gpu_memcpy", "Memcpy HtoD", 100, 10),
        _ev("kernel", "void (anonymous namespace)::k3_kernel<4>(int*)",
            110, 50),
        _ev("kernel", "void at::native::elementwise_kernel<...>", 150, 20),
        _ev("kernel", "void at::native::elementwise_kernel<...>", 200, 30),
        _ev("gpu_memset", "Memset", 230, 10),
        _ev("user_annotation", "portbench.wait", 168, 40),
        _ev("user_annotation", "other", 0, 1000),
        _ev("cpu_op", "aten::add", 100, 5),
    ]
    r = devtrace.reduce(events, {"k3_kernel"},
                        devtrace.Reading(batches=2, least_s=1e-5,
                                         enqueue_s=[1e-3, 2e-3]))
    got = {m: harness.load_module("metrics", m).read(r)
           for m in ("forward_mfu_pct", "kernels_roofline_pct",
                     "plain_ops_ms", "host_enqueue_ms", "device_idle_pct")}
    assert got == {"forward_mfu_pct": 14.285714285714286,
                   "kernels_roofline_pct": 18.181818181818183,
                   "plain_ops_ms": 0.024999999999999998,
                   "host_enqueue_ms": 1.5,
                   "device_idle_pct": 21.42857142857143}
    assert r.device_ops == [
        ["void (anonymous namespace)::k3_kernel<4>(int*)",
         4.9999999999999996e-05],
        ["void at::native::elementwise_kernel<...>", 4.9999999999999996e-05],
        ["Memcpy HtoD", 9.999999999999999e-06],
        ["Memset", 9.999999999999999e-06]]
    assert r.idle_gaps == [["host in wait (1 gaps)", 2.9999999999999997e-05]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_layers_close_to_busy_at_the_cells_size(card, name):
    """A short traced run of the cell at its own size: the first layer,
    the packed layers and the device time launched outside them come
    within 2 % of the busy time.  That sum is an identity on one stream;
    the join shows in the rest, which holds only the harness's copies:
    two a traced batch (H2D, D2H), one more or less at each edge of the
    trace, and no more device time than the copies take."""
    out, r, s = spans.traced_run(harness.load_cell(name), 2 ** 31 + 301,
                                 2.0, card)
    assert out["correct"]
    assert set(spans.readings(s, r.batches, r.window_s)) == {
        "first_layer_ms", "packed_layers_ms", "host_late_idle_pct"}
    assert s.first_s > 0 and s.packed_s > 0
    assert abs(s.first_s + s.packed_s + s.rest_s - r.busy_s) \
        <= 0.02 * r.busy_s
    outside = s.ops.get(spans.OUTSIDE, 0) + s.ops.get(spans.BEFORE, 0)
    assert abs(outside - 2 * r.batches) <= 2
    assert s.rest_s <= s.copy_s + 1e-9 * r.busy_s


def test_spans_tool_exits_without_a_card(no_card, capsys):
    assert spans.main(["--workload", CELLS[0], "--seed", "7",
                       "--seconds", "1"]) == 2
    assert "CUDA" in capsys.readouterr().err
