"""The port's training path end to end on the CPU: the loss falls on the
port's stream, a run killed and restored from the port's checkpoint
continues as the uninterrupted one, a train-state checkpoint crosses
between the packages both ways and training continues there as it would
have, ``Supervisor`` restarts the real step, the stream is deterministic,
and the launcher runs as a subprocess, with and without a resume.

Tolerances: a restored run against the uninterrupted one within rtol
1e-4 (the reference's own bound, ``tests/test_system.py``); on the CPU
both runs are the same operations on the same bits, and are held equal
where a test says so.  Across packages (float32 configs) the loss within
rtol 1e-5 and every param within rtol 1e-4 / atol 1e-5 after two
continued steps.
"""
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.train import trainer as JTR
from repro_torch.checkpoint import latest_step, load_checkpoint, \
    save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.synthetic import (TokenLoader, TokenStreamConfig,
                                        embed_batch, image_batch,
                                        token_batch)
from repro_torch.runtime.fault_tolerance import (StepFailure, Supervisor,
                                                 SupervisorConfig)
from repro_torch.launch import train as train_cli
from repro_torch.train import trainer as TR
from repro_torch.tree import leaves_with_path, tree_map

import _train as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cfg, tc, steps, dcfg, state=None, start=0):
    step = TR.make_train_step(cfg, tc)
    if state is None:
        state = TR.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    tc, device="cpu")
    losses = []
    for i in range(start, start + steps):
        state, m = step(state, token_batch(dcfg, i, "cpu"))
        losses.append(float(m["loss"]))
    return state, losses


def _leaves(tree):
    return [t for _, t in leaves_with_path(tree)]


@pytest.mark.parametrize("compress,margin", [(False, 0.5), (True, 0.3)])
def test_loss_falls_on_the_port_stream(compress, margin):
    """The reference's ``test_loss_decreases_on_learnable_stream`` and
    ``test_compressed_training_still_learns`` on the port: reduced
    starcoder2-3b in its bfloat16, the port's stream."""
    cfg = get_config("starcoder2-3b", reduced=True)
    tc = TR.TrainConfig(lr=3e-3, warmup=2, total_steps=30,
                        compress_grads=compress)
    dcfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=8)
    _, losses = _run(cfg, tc, 25, dcfg)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - margin, losses


def test_kill_restore_continue(tmp_path):
    """The reference's ``test_train_kill_restore_continue`` on the port's
    checkpoint: 10 steps, checkpoint, 5 more; a fresh job restores and
    replays the same 5 data steps."""
    cfg = get_config("starcoder2-3b", reduced=True)
    tc = TR.TrainConfig(lr=3e-3, warmup=2, total_steps=40)
    dcfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=8)
    state, _ = _run(cfg, tc, 10, dcfg)
    save_checkpoint(str(tmp_path), 9, state, extra={"data_step": 10})
    state, losses_a = _run(cfg, tc, 5, dcfg, state, start=10)

    fresh = TR.init_train_state(torch.Generator().manual_seed(1), cfg, tc,
                                device="cpu")
    state_b, meta = load_checkpoint(str(tmp_path), latest_step(
        str(tmp_path)), fresh)
    assert meta["extra"]["data_step"] == 10
    assert state_b["opt"]["step"].dtype == torch.int32
    assert int(state_b["opt"]["step"]) == 10
    state_b, losses_b = _run(cfg, tc, 5, dcfg, state_b, start=10)
    np.testing.assert_allclose(losses_b[-1], losses_a[-1], rtol=1e-4)
    for a, b in zip(_leaves(state["params"]), _leaves(state_b["params"])):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)
        assert torch.equal(a, b)          # same bits on the CPU


def _continue_both(js, ts, cfg, tcfg, jtc, ttc, seeds):
    jstep = jax.jit(JTR.make_train_step(cfg, jtc))
    tstep = TR.make_train_step(tcfg, ttc)
    for seed in seeds:
        nb = T.batch_np(cfg, seed=seed)
        js, jm = jstep(js, T.jbatch(nb))
        ts, tm = tstep(ts, T.tbatch(nb))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    w = T._np_leaves(js["params"], False)
    g = T._np_leaves(ts["params"], True)
    for a, b in zip(w, g):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["float", "binary"])
def test_train_state_checkpoint_crosses_both_ways(tmp_path, mode):
    """Three reference steps, checkpointed by the reference and by the
    port: the same path keys and dtypes, ``step`` a 0-d int32; the port
    restores the reference's checkpoint and the reference the port's,
    and two more steps of each from either agree."""
    cfg, tcfg = T.configs("starcoder2-3b", mode)
    jtc, ttc = T.train_configs(compress_grads=True)
    js, ts = T.states(cfg, jtc)
    jstep = jax.jit(JTR.make_train_step(cfg, jtc))
    for seed in range(3):
        js, _ = jstep(js, T.jbatch(T.batch_np(cfg, seed=10 + seed)))
    j_save(str(tmp_path / "ref"), 2, js)
    ported, _ = load_checkpoint(str(tmp_path / "ref"), 2, ts)
    save_checkpoint(str(tmp_path / "port"), 2, ported)
    with np.load(tmp_path / "ref" / "step_00000002" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_00000002" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["opt/step"].shape == b["opt/step"].shape == ()
        assert a["opt/step"].dtype == b["opt/step"].dtype == np.int32
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert j_latest(str(tmp_path / "port")) == 2
    back, _ = j_load(str(tmp_path / "port"), 2, js)
    # the port continues from the reference's checkpoint, the reference
    # from the port's, each as the other would
    _continue_both(back, ported, cfg, tcfg, jtc, ttc, seeds=(13, 14))


def test_supervisor_restarts_the_real_step(tmp_path):
    """The reference's ``test_supervisor_restart_and_resume`` with the
    port's train step, handed the state itself (it steps it in place): a
    node loss at step 7, a restart from the step-4 checkpoint, and a
    straggler forced at step 9 (a one-off sleep past the deadline).  A
    re-dispatch from the state before step 9 would apply it twice, since
    that state is the stepped one; the slow attempt is kept instead.  All
    12 steps apply once, and the final state equals an uninterrupted
    run's."""
    cfg = get_config("starcoder2-3b", reduced=True)
    tc = TR.TrainConfig(lr=3e-3, warmup=2, total_steps=20)
    dcfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=16,
                             global_batch=4)
    step = TR.make_train_step(cfg, tc)
    failed, slow, calls, took = {"done": False}, {"done": False}, [], []

    def init_state():
        return TR.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   tc, device="cpu")

    def step_fn(state, i):
        if i == 7 and not failed["done"]:
            failed["done"] = True
            raise StepFailure("simulated node loss")
        calls.append(i)
        t0 = time.monotonic()
        out = step(state, token_batch(dcfg, i, "cpu"))
        if i == 9 and not slow["done"]:
            slow["done"] = True
            time.sleep(4 * max(took) + 0.05)     # past 2 x any median
        took.append(time.monotonic() - t0)
        return out

    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                                      min_deadline_s=0.0,
                                      deadline_factor=2.0),
                     init_state, step_fn)
    state, report = sup.run(12)
    assert report.restarts == 1 and report.steps_done == 12
    assert report.stragglers_kept >= 1
    assert report.stragglers_redispatched == 0
    assert sup.metrics.value("supervisor.stragglers_kept") == \
        report.stragglers_kept
    assert calls == list(range(7)) + list(range(5, 12))
    assert int(state["opt"]["step"]) == 12
    want, _ = _run(cfg, tc, 12, dcfg)
    for a, b in zip(_leaves(want), _leaves(state)):
        assert torch.equal(a, b)


def test_step_writes_into_the_state_it_is_given():
    """The step updates the state's own tensors (the reference donates its
    state); a step on a copy leaves the original as it was and gives the
    same state."""
    cfg = get_config("starcoder2-3b", reduced=True)
    tc = TR.TrainConfig()
    dcfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=8,
                             global_batch=2)
    step = TR.make_train_step(cfg, tc)
    state = TR.init_train_state(torch.Generator().manual_seed(0), cfg, tc,
                                device="cpu")
    before = [t.clone() for t in _leaves(state)]
    copy, _ = step(tree_map(torch.clone, state),
                   token_batch(dcfg, 0, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(state)))
    new, _ = step(state, token_batch(dcfg, 0, "cpu"))
    assert all(a is b for a, b in zip(_leaves(new), _leaves(state)))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(copy),
                                                 _leaves(new)))
    assert not all(torch.equal(a, b) for a, b in zip(before, _leaves(new)))


def test_data_stream_deterministic_and_learnable():
    dcfg = TokenStreamConfig(vocab_size=101, seq_len=16, global_batch=4)
    b1, b2 = token_batch(dcfg, 5, "cpu"), token_batch(dcfg, 5, "cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert b1["tokens"].dtype == b1["labels"].dtype == torch.int32
    assert b1["tokens"].shape == (4, 16)
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 101
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert not torch.equal(token_batch(dcfg, 6, "cpu")["tokens"],
                           b1["tokens"])
    other = TokenStreamConfig(vocab_size=101, seq_len=16, global_batch=4,
                              seed=1)
    assert not torch.equal(token_batch(other, 5, "cpu")["tokens"],
                           b1["tokens"])
    # the recurrence: each row's next token from its (a, drift) and t % 3
    t = b1["tokens"].long()
    for row in t:
        fits = [(a, d) for a in range(1, 8) for d in range(4)
                if all(int(row[i + 1]) == (a * int(row[i]) + d + i % 3) % 101
                       for i in range(15))]
        assert fits
    loader = TokenLoader(dcfg, device="cpu")
    first = [next(loader) for _ in range(3)]
    resumed = TokenLoader(dcfg, device="cpu")
    resumed.load_state_dict(loader.state_dict())
    assert loader.state_dict() == {"step": 3}
    assert torch.equal(next(resumed)["tokens"],
                       token_batch(dcfg, 3, "cpu")["tokens"])
    assert torch.equal(first[2]["tokens"],
                       token_batch(dcfg, 2, "cpu")["tokens"])
    gen = torch.Generator().manual_seed(0)
    e = embed_batch(gen, 2, 3, 8, device="cpu")
    assert e.shape == (2, 3, 8) and e.dtype == torch.bfloat16
    im = image_batch(gen, 2, (4, 4), 3, device="cpu")
    assert im.shape == (2, 4, 4, 3) and im.dtype == torch.uint8


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_config("starcoder2-3b", reduced=True)
    dcfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=8,
                             global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        token_batch(dcfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.init_train_state(torch.Generator().manual_seed(0), cfg,
                            TR.TrainConfig())


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "starcoder2-3b", "--reduced", "--device", "cpu", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_trains_and_resumes(tmp_path):
    """A fresh run checkpointing every 3 steps, then a rerun that restores
    its step-5 checkpoint and runs steps 6 and 7; a (2, 1) mesh trains
    (its parity: ``test_torch_train_sharded.py``)."""
    ck = str(tmp_path / "ck")
    first = _cli("--steps", "6", "--ckpt-dir", ck, "--ckpt-every", "3")
    assert first.returncode == 0, first.stderr
    lines = first.stdout.splitlines()
    assert lines[0] == ("mesh {'data': 1, 'model': 1} arch starcoder2-3b "
                        "quant float")
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == \
        ["0", "5"]
    assert lines[-1].startswith("done: 6 steps in ")
    assert latest_step(ck) == 5
    resumed = _cli("--steps", "8", "--ckpt-dir", ck, "--ckpt-every", "3")
    assert resumed.returncode == 0, resumed.stderr
    lines = resumed.stdout.splitlines()
    assert lines[1] == "restored step 5"
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == ["7"]
    assert lines[-1].startswith("done: 2 steps in ")
    state, meta = load_checkpoint(ck, 5, TR.init_train_state(
        torch.Generator().manual_seed(0), get_config("starcoder2-3b",
                                                     reduced=True),
        TR.TrainConfig(), device="cpu"))
    assert meta["step"] == 5 and int(state["opt"]["step"]) == 6
    train_cli.main(["--arch", "starcoder2-3b", "--reduced", "--data", "2",
                    "--steps", "1", "--device", "cpu"])
