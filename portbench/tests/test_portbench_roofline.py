"""The frozen work counts and peaks of ``roofline`` on the configurations."""
import pytest

from portbench import harness, roofline


def _layers(name):
    cell = harness.load_cell(name)
    return harness.load_module("networks", cell.cfg["network"]).work(cell.cfg)


def _macs(layers, route):
    return sum(layer.macs for layer in layers if layer.route == route)


def test_peaks_are_frozen():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.INT8_OPS_PER_S == 1.979e15
    assert roofline.B1_OPS_PER_S == 1.021e16


@pytest.mark.parametrize("name, b1, int8", [
    # BCNNSpec(): five packed convs 603,979,776 + dense 9,447,424 bit-MACs;
    # the first conv 32*32*128*27 uint8 MACs.
    ("bcnn-cifar10.offline-b512", 613_427_200, 3_538_944),
    # BMLPSpec(): 2 * 4096^2 + 4096 * 10 bit-MACs; 784 * 4096 uint8 MACs.
    ("bmlp-mnist.offline-b4096", 33_595_392, 3_211_264),
])
def test_work_counts(name, b1, int8):
    layers = _layers(name)
    assert _macs(layers, "b1") == b1
    assert _macs(layers, "int8") == int8
    assert {layer.route for layer in layers} == {"b1", "int8"}


@pytest.mark.parametrize("name, batch, lo_us, hi_us", [
    ("bcnn-cifar10.offline-b512", 512, 60, 70),
    ("bmlp-mnist.offline-b4096", 4096, 35, 45),
])
def test_least_time(name, batch, lo_us, hi_us):
    least = roofline.least_time_s(_layers(name), batch)
    assert lo_us * 1e-6 < least < hi_us * 1e-6


def test_layer_takes_the_larger_bound():
    fast = roofline.Layer("x", "b1", macs=1, act_bytes=1e6, weight_bytes=0)
    assert fast.least_s(2) == pytest.approx(2e6 / roofline.HBM_BYTES_PER_S)
    slow = roofline.Layer("x", "int8", macs=10 ** 9, act_bytes=1,
                          weight_bytes=0)
    assert slow.least_s(2) == pytest.approx(4e9 / roofline.INT8_OPS_PER_S)
