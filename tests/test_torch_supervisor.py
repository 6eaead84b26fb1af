"""The port's elastic serving (``runtime.supervisor``, ``runtime.elastic``,
``train.serve`` with ``mesh=``, the CLI's ``--mesh`` and ``--chaos``)
against the JAX reference's, on the CPU under a ``SimClock``.

* ``remesh_plan`` gives the reference's plan, or raises the reference's
  exception type, over a grid of survivor counts and degrees.
* The reference's device-loss scripts (``tests/test_runtime_faults.py``)
  end with the same terminal states, ``DegradeEvent``\\ s, requeued counts
  and ``serve.degraded*`` values on both servers, at one survivor; the
  port's served rows equal its direct forward exactly and the
  reference's rows within the repo's logit tolerance.
* A server on an (4, 2) mesh of CPU positions degrades 8 -> 4 -> 2 with
  every row equal to the port's direct forward.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import cnn as JC
from repro.runtime import elastic as JEL
from repro.runtime import faults as JF
from repro.runtime import supervisor as JSUP
from repro.train import serve as JSV
from repro_torch import convert as CV
from repro_torch.checkpoint import latest_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import cnn as TC
from repro_torch.runtime import elastic as TEL
from repro_torch.runtime import faults as TF
from repro_torch.runtime import supervisor as TSUP
from repro_torch.train import serve as TSV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-3)     # tests/test_paper_equivalence.py
SIZES = (64, 64, 10)                       # tests/test_runtime_faults.py:24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once,
    and the many small tensor ops here would spend their time waiting on
    an oversubscribed thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", range(0, 19))
def test_remesh_plan_equals_the_reference(n):
    for prefer in (1, 2, 3, 4, 8, 16):
        for least in (1, 2, 4, 5):
            try:
                want = JEL.remesh_plan(n, prefer_model=prefer,
                                       min_model=least)
            except ValueError:
                with pytest.raises(ValueError):
                    TEL.remesh_plan(n, prefer_model=prefer, min_model=least)
                continue
            got = TEL.remesh_plan(n, prefer_model=prefer, min_model=least)
            assert (got.shape, got.axes) == (want.shape, want.axes)


@pytest.fixture(scope="module")
def bmlp():
    """The reference's packed (64, 64, 10) BMLP, the port's copy on the
    CPU, and 8 inputs."""
    spec = JC.BMLPSpec(sizes=SIZES)
    params = JC.init_bmlp(jax.random.PRNGKey(0), spec)
    jp = JC.pack_bmlp(params, spec)
    tp = TC.pack_bmlp(CV.params_to_torch(params), CV.bmlp_spec(spec),
                      device="cpu")
    x = np.random.default_rng(1).integers(0, 256, (8, SIZES[0]),
                                          dtype=np.uint8)
    return jp, tp, x


def _side(which, bmlp, plan=(), ckpt_dir=None, **kw):
    """(server, clock, supervisor) of the reference
    (backend 'jnp') or the port (CPU) with ``bmlp`` registered as 'm' and
    the fault ``plan`` (FaultSpec kwargs) attached."""
    jp, tp, _ = bmlp
    sv, rt, sup_mod = ((JSV, JF, JSUP) if which == "jax"
                       else (TSV, TF, TSUP))
    extra = {"backend": "jnp"} if which == "jax" else {}
    clock = sv.SimClock()
    srv = sv.PackedInferenceServer(
        max_batch=8, default_deadline=0.005, clock=clock,
        **({"device": "cpu"} if which == "torch" else {}),
        **{k: (v if k != "retry" else sv.RetryPolicy(max_retries=v))
           for k, v in kw.items()})
    srv.register("m", packed=jp if which == "jax" else tp, **extra)
    if plan:
        rt.FaultInjector(rt.FaultPlan.of(
            *(rt.FaultSpec(**s) for s in plan))).attach(srv)
    sup = sup_mod.ServingSupervisor(
        srv, "m", ckpt_dir=None if ckpt_dir is None else
        os.path.join(ckpt_dir, which), **extra)
    return srv, clock, sup


def _script_loss(srv, clock, sup, xs):
    rids = [srv.submit(r) for r in xs]
    return rids, sup.step()


def _script_loss_in_bisection(srv, clock, sup, xs):
    rids = [srv.submit(r) for r in xs[:4]]
    clock.advance(1.0)
    raised = False
    try:
        srv.step()
    except (JSV.DeviceLossError, TSV.DeviceLossError):
        raised = True
    assert raised and srv.pending() == 4
    assert [r.rid for r in srv._queue] == rids
    sup.degrade(1)
    return rids, srv.step()


def _script_loss_in_bisection_supervised(srv, clock, sup, xs):
    rids = [srv.submit(r) for r in xs[:4]]
    clock.advance(1.0)
    return rids, sup.step()


def _script_restore_from_checkpoint(srv, clock, sup, xs):
    assert sup.checkpoint() is not None
    assert latest_step(sup.ckpt_dir) == 0
    rids = [srv.submit(r) for r in xs]
    return rids, sup.step()


LOSS = [{"kind": "device_loss", "survivors": 1}]
LOSS_IN_BISECTION = [{"kind": "poison", "rid": 1},
                     {"kind": "device_loss", "survivors": 1,
                      "at_dispatch": 2}]
SCRIPTS = {
    "loss": (_script_loss, LOSS, {}),
    "loss_in_bisection": (_script_loss_in_bisection, LOSS_IN_BISECTION,
                          {"retry": 0}),
    "loss_in_bisection_supervised": (_script_loss_in_bisection_supervised,
                                     LOSS_IN_BISECTION, {"retry": 0}),
    "restore_from_checkpoint": (_script_restore_from_checkpoint, LOSS, {}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_device_loss_scripts_as_the_reference(bmlp, tmp_path, name):
    _, tp, xs = bmlp
    script, plan, kw = SCRIPTS[name]
    seen = {}
    for which in ("jax", "torch"):
        srv, clock, sup = _side(which, bmlp, plan, ckpt_dir=str(tmp_path),
                                **kw)
        rids, done = script(srv, clock, sup, xs)
        by = {r.rid: r for r in done}
        assert sorted(by) == rids
        m = srv.telemetry.metrics
        seen[which] = {
            "statuses": [by[r].status for r in rids],
            "events": [(e.survivors, tuple(e.mesh_shape), e.restored_from,
                        e.requeued) for e in sup.events],
            "metrics": (m.value("serve.degraded"),
                        m.value("serve.degraded_state"),
                        m.value("serve.bisections") > 0),
            "pending": srv.pending(),
            "rows": {r: by[r].result for r in rids if by[r].status == "ok"},
            "mesh": tuple(srv.engine("m").fwd.mesh.shape.values()),
        }
    got, want = seen["torch"], seen["jax"]
    assert {k: v for k, v in got.items() if k != "rows"} == \
        {k: v for k, v in want.items() if k != "rows"}
    assert got["events"][0][1] == (1, 1) and got["metrics"][:2] == (1, 0)
    direct = TC.make_packed_forward(tp)(xs)      # rid i is row i
    for rid in got["rows"]:
        assert torch.equal(got["rows"][rid], direct[rid])
        np.testing.assert_allclose(got["rows"][rid].numpy(),
                                   np.asarray(want["rows"][rid]),
                                   **LOGIT_TOL)


@pytest.fixture(scope="module")
def bcnn_smoke():
    params, spec, kind = TC.demo_model("bcnn", smoke=True)
    return params, spec, kind


def test_degrade_eight_four_two_on_cpu_meshes(bcnn_smoke, tmp_path):
    params, spec, kind = bcnn_smoke
    clock = TSV.SimClock()
    srv = TSV.PackedInferenceServer(max_batch=8, default_deadline=0.005,
                                    clock=clock, device="cpu")
    srv.register("m", params, spec, kind=kind,
                 mesh=make_host_mesh(4, 2, device="cpu"))
    eng = srv.engine("m")
    assert eng.batch_multiple == 4 and eng.buckets == (4, 8)
    direct = TC.make_packed_forward(eng.packed)
    sup = TSUP.ServingSupervisor(srv, "m", ckpt_dir=str(tmp_path))
    assert len(sup.devices) == 8
    sup.checkpoint()
    xs = torch.randint(0, 256, (8, *eng.example_shape),
                       generator=torch.Generator().manual_seed(2),
                       dtype=torch.uint8)
    want = direct(xs)
    for survivors, shape in ((4, (2, 2)), (2, (1, 2))):
        TF.FaultInjector(TF.FaultPlan.of(TF.FaultSpec(
            "device_loss", survivors=survivors))).attach(srv)
        rids = [srv.submit(x) for x in xs]
        clock.advance(1.0)
        by = {r.rid: r for r in sup.step()}
        assert [by[r].status for r in rids] == ["ok"] * 8
        assert torch.equal(torch.stack([by[r].result for r in rids]), want)
        eng = srv.engine("m")
        assert tuple(eng.fwd.mesh.shape.values()) == shape
        assert eng.fwd.mesh.size == survivors
        assert eng.buckets == tuple(sorted({-(-b // shape[0]) * shape[0]
                                            for b in (1, 2, 4, 8)}))
    assert [(e.survivors, e.mesh_shape, e.restored_from, e.requeued)
            for e in sup.events] == [(4, (2, 2), "checkpoint", 8),
                                     (2, (1, 2), "checkpoint", 8)]
    m = srv.telemetry.metrics
    assert (m.value("serve.degraded"), m.value("serve.degraded_state")) == \
        (2, 0)
    with pytest.raises(ValueError, match="survivors"):
        sup.degrade(9)


def test_mesh_serving_rounds_buckets_and_refuses_the_lm(bcnn_smoke):
    params, spec, kind = bcnn_smoke
    srv = TSV.PackedInferenceServer(max_batch=8, device="cpu",
                                    clock=TSV.SimClock())
    srv.register("m", params, spec, kind=kind,
                 mesh=make_host_mesh(4, 2, device="cpu"))
    x = torch.randint(0, 256, (1, *srv.engine().example_shape),
                      dtype=torch.uint8)
    out = srv.serve([x[0]])
    assert (srv.flushes[-1].batch, srv.flushes[-1].bucket) == (1, 4)
    assert torch.equal(out[0], TC.make_packed_forward(
        srv.engine().packed)(x)[0])
    lm = {"blocks": [], "head": {}, "meta": {}}
    with pytest.raises(ValueError, match="transformer"):
        srv.register("lm", packed=lm, mesh=make_host_mesh(1, 2, "cpu"))


@pytest.mark.parametrize("args", [
    ["--model", "bcnn", "--smoke", "--device", "cpu", "--mesh", "2,2"],
    ["--chaos", "--smoke", "--device", "cpu"]])
def test_cli_runs_on_the_cpu(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    if "--chaos" in args:
        assert "chaos drill PASSED" in out.stdout
        assert "[FAIL]" not in out.stdout
    else:
        assert "batch_multiple=2" in out.stdout
