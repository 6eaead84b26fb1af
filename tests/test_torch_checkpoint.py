"""The port's checkpoints (``repro_torch.checkpoint``) and step-loop
supervisor (``repro_torch.runtime.fault_tolerance``) against the JAX
reference's.

* Packed checkpoints cross between the packages both ways with equal
  words: the port writes its int32 words as the reference's uint32.
* The checkpointer keeps the reference's layout and lifecycle: atomic
  step directories, ``latest_step`` ignoring ``.tmp``, an async writer
  that re-raises its worker's failure, a kind check before grafting.
* ``Supervisor`` on the reference's toy step functions
  (``tests/test_checkpoint_ft.py``) gives the reference's report.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_packed_checkpoint as j_load_packed
from repro.checkpoint import save_packed_checkpoint as j_save_packed
from repro.models import cnn as JC
from repro.runtime import fault_tolerance as JFT
from repro.telemetry import MetricsRegistry as JMetrics
from repro_torch import convert as CV
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint, load_packed_checkpoint,
                                    save_checkpoint, save_packed_checkpoint)
from repro_torch.distributed.sharding import Placed
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import cnn as TC
from repro_torch.runtime import fault_tolerance as TFT
from repro_torch.telemetry import MetricsRegistry as TMetrics
from repro_torch.tree import leaves_with_path


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once,
    and the many small tensor ops here would spend their time waiting on
    an oversubscribed thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=gen),
            "nested": {"b": torch.arange(10), "step": torch.tensor(3),
                       "words": torch.tensor([-1, 5], dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    tree = _tree(0)
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    restored, meta = load_checkpoint(str(tmp_path), 7, tree)
    assert meta["step"] == 7
    for (pa, a), (pb, b) in zip(leaves_with_path(tree),
                                leaves_with_path(restored)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    assert sorted(os.listdir(tmp_path / "step_00000007")) == \
        ["arrays.npz", "meta.json"]


def test_latest_ignores_tmp(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree(1))
    os.makedirs(tmp_path / "step_00000009.tmp")   # crashed write
    assert latest_step(str(tmp_path)) == 3
    assert latest_step(str(tmp_path / "absent")) is None


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    tree = _tree(2)
    ck.save(1, tree)
    ck.save(2, tree)     # waits for the in-flight save
    ck.wait()
    assert latest_step(str(tmp_path)) == 2


def test_async_checkpointer_surfaces_worker_failure(tmp_path):
    """A save that raises in the worker thread is re-raised from wait(),
    once, and from the next save()."""
    bad = tmp_path / "not_a_dir"
    bad.write_text("")                 # ckpt_dir is a FILE: makedirs raises
    ck = AsyncCheckpointer(str(bad))
    tree = _tree(3)
    ck.save(1, tree)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()
    ck.save(2, tree)
    with pytest.raises(OSError):
        ck.save(3, tree)


def _bn(bns, rng):
    for bn in bns:
        c = bn["gamma"].shape[0]
        bn["gamma"] = jnp.asarray(rng.uniform(0.3, 1.5, c)
                                  * np.where(rng.random(c) < 0.3, -1, 1),
                                  jnp.float32)
        bn["mean"] = jnp.asarray(rng.normal(size=c) * 3, jnp.float32)


def _pair(kind):
    params, spec, _ = JC.demo_model(kind, smoke=True)
    rng = np.random.default_rng(4)
    if kind == "bcnn":
        _bn(params["conv_bns"] + params["dense_bns"], rng)
        return JC.pack_bcnn(params, spec), TC.pack_bcnn(
            CV.params_to_torch(params), CV.bcnn_spec(spec), device="cpu")
    _bn(params["bns"], rng)
    return JC.pack_bmlp(params, spec), TC.pack_bmlp(
        CV.params_to_torch(params), CV.bmlp_spec(spec), device="cpu")


def _assert_same_arrays(jtree, ttree):
    jleaves = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path): np.asarray(leaf)
               for path, leaf in
               jax.tree_util.tree_flatten_with_path(jtree)[0]
               if isinstance(leaf, (jax.Array, np.ndarray))}
    tleaves = {p: leaf for p, leaf in leaves_with_path(ttree)
               if isinstance(leaf, torch.Tensor)}
    assert sorted(jleaves) == sorted(tleaves)
    for path, want in jleaves.items():
        got = tleaves[path].numpy()
        if want.dtype == np.uint32:
            got = CV.words_to_numpy(tleaves[path])
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["bcnn", "bmlp"])
def test_packed_checkpoints_cross_both_ways(tmp_path, kind):
    jp, tp = _pair(kind)
    # the reference writes, the port restores
    j_save_packed(str(tmp_path / "j"), 0, jp)
    got, meta = load_packed_checkpoint(str(tmp_path / "j"), 0, tp)
    assert meta["extra"]["packed_kind"] == kind
    _assert_same_arrays(jp, got)
    # the port writes, the reference restores
    save_packed_checkpoint(str(tmp_path / "t"), 5, tp)
    assert latest_step(str(tmp_path / "t")) == 5
    back, meta = j_load_packed(str(tmp_path / "t"), 5, jp)
    assert meta["extra"]["n_arrays"] == len(
        [1 for _, leaf in leaves_with_path(tp)
         if isinstance(leaf, torch.Tensor)])
    _assert_same_arrays(back, tp)
    # statics are the template's
    assert got["spec"] is tp["spec"]


def test_packed_checkpoint_kind_mismatch_and_missing_leaf(tmp_path):
    _, tbcnn = _pair("bcnn")
    _, tbmlp = _pair("bmlp")
    save_packed_checkpoint(str(tmp_path), 0, tbcnn)
    with pytest.raises(ValueError, match="kind"):
        load_packed_checkpoint(str(tmp_path), 0, tbmlp)
    bigger = dict(tbcnn, convs=[dict(pc) for pc in tbcnn["convs"]])
    bigger["convs"][0]["extra_leaf"] = torch.zeros(2)
    with pytest.raises(KeyError):
        load_packed_checkpoint(str(tmp_path), 0, bigger)


def test_packed_checkpoint_restores_onto_a_mesh(tmp_path):
    _, tp = _pair("bcnn")
    mesh = make_host_mesh(2, 2, device="cpu")
    save_packed_checkpoint(str(tmp_path), 0, tp)
    placed, _ = load_packed_checkpoint(str(tmp_path), 0, tp, mesh=mesh)
    w = placed["convs"][0]["w_packed"]
    assert isinstance(w, Placed) and w.spec == ("model",)
    assert torch.equal(w.to_host(), tp["convs"][0]["w_packed"])
    # a placed tree saves as the host tree it stands for
    save_packed_checkpoint(str(tmp_path / "p"), 0, placed)
    again, _ = load_packed_checkpoint(str(tmp_path / "p"), 0, tp)
    for (_, a), (_, b) in zip(leaves_with_path(again), leaves_with_path(tp)):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b)


# -- the step-loop supervisor on the reference's toy step functions --------

def _failing_at(step, exc):
    def make():
        failed = {"done": False}

        def step_fn(state, i):
            if i == step and not failed["done"]:
                failed["done"] = True
                raise exc("simulated node loss")
            return {"x": state["x"] + 1.0}, {}
        return step_fn
    return make


@pytest.mark.parametrize("fail_at,every,steps", [(7, 5, 12), (3, 2, 6)])
def test_supervisor_restart_report_equals_the_reference(tmp_path, fail_at,
                                                        every, steps):
    """A failure at ``fail_at``: both restart from the newest checkpoint
    and finish with the same state, report and mirrored metrics."""
    results = []
    for ft, metrics, zero in (
            (JFT, JMetrics(), lambda: {"x": jnp.float32(0.0)}),
            (TFT, TMetrics(), lambda: {"x": torch.tensor(0.0)})):
        sup = ft.Supervisor(ft.SupervisorConfig(
            ckpt_dir=str(tmp_path / ft.__name__), ckpt_every=every,
            min_deadline_s=10.0), zero, _failing_at(fail_at,
                                                    ft.StepFailure)(),
            metrics=metrics)
        state, report = sup.run(steps)
        results.append((float(state["x"]), report, metrics))
    (jx, jr, jm), (tx, tr, tm) = results
    assert (tx, tr.steps_done, tr.restarts, tr.heartbeats,
            tr.stragglers_redispatched) == \
        (jx, jr.steps_done, jr.restarts, jr.heartbeats,
         jr.stragglers_redispatched)
    assert tx == float(steps) and tr.restarts == 1
    for name in ("supervisor.restarts", "supervisor.heartbeats",
                 "supervisor.stragglers_redispatched",
                 "supervisor.steps_done"):
        assert tm.value(name) == jm.value(name)
    assert isinstance(TFT.StepFailure("x"), RuntimeError)


def test_supervisor_straggler_redispatch_applies_step_once(tmp_path):
    """The slow first attempt of step 5 is re-dispatched from the PRE-step
    state, on both sides: every step applies exactly once."""
    results = []
    for ft, zero in ((JFT, lambda: {"x": jnp.float32(0)}),
                     (TFT, lambda: {"x": torch.tensor(0.0)})):
        calls = {"n": 0}

        def step_fn(state, i, calls=calls):
            calls["n"] += 1
            if i == 5 and calls["n"] == 6:
                time.sleep(0.15)          # straggler: first attempt only
            return {"x": state["x"] + 1}, {}

        sup = ft.Supervisor(ft.SupervisorConfig(
            ckpt_dir=str(tmp_path / ft.__name__), ckpt_every=100,
            min_deadline_s=0.05, deadline_factor=2.0), zero, step_fn)
        state, report = sup.run(8)
        assert report.stragglers_redispatched >= 1
        assert calls["n"] == 8 + report.stragglers_redispatched
        results.append((float(state["x"]), report.steps_done,
                        report.restarts, report.heartbeats))
    assert results[0] == results[1] == (8.0, 8, 0, 8)


def test_supervisor_restores_onto_a_device(tmp_path):
    def step_fn(state, i):
        return {"x": state["x"] + 1.0}, {}

    cfg = TFT.SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                               min_deadline_s=10.0)
    TFT.Supervisor(cfg, lambda: {"x": torch.tensor(0.0)}, step_fn).run(4)
    sup = TFT.Supervisor(cfg, lambda: {"x": torch.tensor(0.0)}, step_fn,
                         device="cpu")
    state, report = sup.run(6)
    assert float(state["x"]) == 6.0 and report.heartbeats == 2
