"""The launch probes (``repro_torch.telemetry.probes``) against the
reference's committed ``experiments/PROBES_baseline.json``: through
``REFERENCE_KERNELS`` the port's launches name the reference's bodies in
the reference's order and routes, and where the port launches otherwise
on purpose the difference is asserted by name.  Kernel names come from
the committed baseline: under JAX 0.9.0 the reference's ``kernel_name``
reads ``pallas_call`` for every launch."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.analysis import report as TREPORT
from repro_torch.telemetry import probes as PR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference():
    with open(os.path.join(REPO, "experiments", "PROBES_baseline.json")) as f:
        return json.load(f)["cells"]


@pytest.fixture(scope="module")
def committed():
    with open(PR.BASELINE_PATH) as f:
        return json.load(f)["cells"]


@pytest.fixture(scope="module")
def demos():
    return {kind: TREPORT.demo_packed(kind)
            for kind in ("bmlp", "bcnn", "transformer")}


def _bodies(cell):
    return [PR.reference_bodies(ln["kernel"], ln["route"])
            for ln in cell["launches"]]


@pytest.mark.parametrize("batch", PR.DEMO_BATCHES)
def test_lm_launches_are_the_references(reference, demos, batch):
    """One launch for one, by name and by route: the XOR + POPC K4 where
    the reference takes its GEMV (M <= 8), the tensor cores where it
    takes its GEMM."""
    got = PR.probe_forward(demos["transformer"], batch)
    ref = reference[f"transformer/b{batch}"]
    assert got["launch_count"] == ref["launch_count"] == 50
    assert [b for (b,) in _bodies(got)] == \
        [ln["kernel"] for ln in ref["launches"]]
    assert got["route"] == ref["route"]


@pytest.mark.parametrize("batch", PR.DEMO_BATCHES)
def test_bcnn_launches_against_the_reference(reference, demos, batch):
    """The one difference: on the first stage K1-fused replaces
    ``_bitplane_conv_kernel`` + ``_bn_sign_pack_kernel``."""
    got = PR.probe_forward(demos["bcnn"], batch)
    ref = reference[f"bcnn/b{batch}"]
    assert got["launches"][0]["kernel"] == "bitplane_conv_bn_sign"
    assert _bodies(got)[0] == ("_bitplane_conv_kernel",
                               "_bn_sign_pack_kernel")
    flat = [b for bodies in _bodies(got) for b in bodies]
    assert flat == [ln["kernel"] for ln in ref["launches"]]
    assert got["launch_count"] == ref["launch_count"] - 1
    assert got["route"] == ref["route"]


@pytest.mark.parametrize("batch", PR.DEMO_BATCHES)
def test_bmlp_launches_against_the_reference(reference, demos, batch):
    """The one difference: the bit-plane first layer runs K5 once and K4
    once on the 8·M stacked plane rows, where the reference runs its
    bitpack and its GEMV or GEMM once per plane (8 times each).  So K4's
    route there follows 8·M: the tensor cores from M = 2 on."""
    got = PR.probe_forward(demos["bmlp"], batch)
    ref = reference[f"bmlp/b{batch}"]
    ref_names = [ln["kernel"] for ln in ref["launches"]]
    first = got["launches"][:2]
    assert [ln["kernel"] for ln in first] == ["bitpack", "xnor_gemm"]
    assert first[1]["route"] == ("small8" if batch == 1 else "mma64")
    plane_body = PR.reference_bodies("xnor_gemm",
                                     "small" if batch <= 8 else "mma")
    assert ref_names[:16] == ["_bitpack_kernel", *plane_body] * 8
    assert [b for (b,) in _bodies(got)[2:]] == ref_names[16:]
    assert got["launch_count"] == ref["launch_count"] - 14
    assert got["route"] == ref["route"]


def test_sharded_cells_match_the_references_gathers(reference, committed):
    for kind in ("bmlp", "bcnn"):
        got, ref = committed[f"sharded/{kind}_4x2"], \
            reference[f"sharded/{kind}_4x2"]
        assert got["collective_kinds"] == ref["collective_kinds"]
        assert got["shard_plan"] == ref["shard_plan"]
        # bytes a device receives from its one peer, against the whole
        # gathered output the reference counts (analysis.collectives)
        assert got["collective_bytes"] * 2 == ref["collective_bytes"]


def test_full_width_cells(committed):
    """``BCNNSpec()`` and ``BMLPSpec()``: ``'auto'`` means K6 (one launch
    for the hidden stack), ``'per_layer'`` one K4-fused a hidden layer;
    K1 reads the raw image, so no bit-plane stack is built and the BCNN's
    largest intermediate at batch 256 is its first packed pool's words,
    (256, 16, 16, 4) int32, 1 MB."""
    for batch in PR.FULL_BATCHES:
        auto = [ln["kernel"] for ln in
                committed[f"bcnn_full/b{batch}/auto"]["launches"]]
        assert auto == ["bitplane_conv_bn_sign"] + ["conv_bn_sign"] * 5 + \
            ["dense_stack", "xnor_gemm"]
        per = [ln["kernel"] for ln in
               committed[f"bcnn_full/b{batch}/per_layer"]["launches"]]
        assert per == auto[:6] + ["xnor_gemm_bn_sign"] * 2 + ["xnor_gemm"]
        mlp = [ln["kernel"] for ln in
               committed[f"bmlp_full/b{batch}/auto"]["launches"]]
        assert mlp == ["bitpack", "xnor_gemm", "bn_sign_pack",
                       "dense_stack", "xnor_gemm"]
    big = committed["bcnn_full/b256/auto"]
    assert big["max_intermediate_bytes"] == 1048576
    assert big["max_intermediate_shape"] == [256, 16, 16, 4]


def test_full_width_trace_matches_the_committed_cell(committed):
    packed = PR.full_width_packed("bmlp")
    got = PR.probe_forward(packed, 256, dense_stack="per_layer")
    assert got == committed["bmlp_full/b256/per_layer"]


def test_probes_cli_check_passes_against_its_baseline():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.probes", "--check"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "probes match baseline (19 cells)" in out.stdout
