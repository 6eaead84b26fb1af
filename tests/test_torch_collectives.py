"""The collective rules (``repro_torch.analysis.collectives``) on the
port's own gather counters: a data-only mesh is silent, a model mesh may
only gather, ``check_mesh`` dispatches on ``|model|``; on the (4, 2) mesh
at batch 8 the sharded demo forwards make the reference's gathers, with
the per-device bytes the reference's HLO model counts times
``(|model| - 1) / |model|`` (module docstring)."""
import json
import os

import pytest

from repro_torch.analysis import collectives as C
from repro_torch.analysis import report as TREPORT
from repro_torch.distributed import verify_sharded as VS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AG = C.Collectives({"all-gather": 1}, {"all-gather": 512.0})
AR = C.Collectives({"all-reduce": 1}, {"all-reduce": 512.0})
BOTH = C.Collectives({"all-gather": 1, "all-reduce": 1},
                     {"all-gather": 512.0, "all-reduce": 512.0})
NONE = C.Collectives({}, {})


def test_model_parallel_allows_all_gather_only():
    rep = C.check_model_parallel(AG)
    assert rep.ok and rep.kinds == {"all-gather": 1}
    rep = C.check_model_parallel(BOTH)
    assert not rep.ok and any("all-reduce" in v for v in rep.violations)
    assert rep.kinds == {"all-gather": 1, "all-reduce": 1}
    assert rep.total_bytes == 1024.0
    assert C.check_model_parallel(NONE).ok


def test_data_parallel_must_be_silent():
    assert C.check_data_parallel(NONE).ok
    rep = C.check_data_parallel(AG)
    assert not rep.ok and "collective-free" in rep.violations[0]


def test_check_mesh_dispatches_on_model_degree():
    assert not C.check_mesh(AG, (8, 1)).ok
    assert C.check_mesh(AG, (4, 2)).ok
    assert not C.check_mesh(AR, (4, 2)).ok
    assert set(C.CollectiveReport.__dataclass_fields__) == {
        "kinds", "bytes_by_kind", "total_bytes", "violations"}
    assert set(C.check_mesh(AG, (4, 2)).to_json()) == {
        "kinds", "total_bytes", "violations"}


def test_count_collectives_reads_the_counters_around_one_call():
    from repro_torch import telemetry
    m = telemetry.default().metrics

    def reduces():
        m.counter("sharding.reduces").inc(2)
        m.counter("sharding.reduced_bytes").inc(800)
        return "out"

    out, got = C.count_collectives(reduces, positions=4)
    assert out == "out"
    assert got == C.Collectives({"all-reduce": 2}, {"all-reduce": 200.0})
    assert not C.check_mesh(got, (2, 2)).ok


@pytest.fixture(scope="module")
def reference_cells():
    with open(os.path.join(REPO, "experiments", "PROBES_baseline.json")) as f:
        return json.load(f)["cells"]


@pytest.mark.parametrize("kind", ["bcnn", "bmlp"])
def test_sharded_4x2_matches_the_reference(reference_cells, kind):
    ref = reference_cells[f"sharded/{kind}_4x2"]
    packed = TREPORT.demo_packed(kind)
    fwd, got = TREPORT.sharded_collectives(packed, (4, 2), 8)
    assert {k: list(v) for k, v in fwd.shard_plan.items()} == \
        ref["shard_plan"]
    assert got.kinds == ref["collective_kinds"]
    assert got.bytes_by_kind["all-gather"] * 2 / (2 - 1) == \
        ref["collective_bytes"]
    gathers, nbytes = VS.expected_gathers(packed, fwd.shard_plan,
                                          fwd.mesh, 8)
    assert gathers == got.kinds["all-gather"]
    assert nbytes == got.bytes_by_kind["all-gather"] * 8
    assert C.check_mesh(got, (4, 2)).ok


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_other_meshes_keep_their_rule(shape):
    packed = TREPORT.demo_packed("bcnn")
    _, got = TREPORT.sharded_collectives(packed, shape, 8)
    rep = C.check_mesh(got, shape)
    assert rep.ok
    assert (rep.kinds == {}) == (shape[1] == 1)
