"""The train CLI (``repro_torch.launch.train``) on meshes of CPU
positions: a run on (2, 2) killed after its step-5 checkpoint and resumed
on (4, 1) and on (1, 1) continues the loss trajectory of the run that was
never killed.  A checkpoint holds whole tensors, so it crosses meshes;
the data stream is a function of (seed, step), so the resumed steps see
the same batches.

Bounds.  The first resumed step runs on the restored state: its loss
within rtol 1e-5 of the unkilled run's (it read equal).  After it the
meshes' data splits differ (rows of 1 against 2 per piece), and the
config's bfloat16 activations round apart between them, as between
microbatch splits: the later losses read 1.3e-05 to 2.2e-04 apart, and
two unkilled runs on (2, 2) and (4, 1) up to 4.6e-04; they are held to
rtol 1e-3, the reference's own bound for a microbatch split
(``tests/test_trainer_optim.py``)."""
import shutil

import pytest
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.launch import train as train_cli
from repro_torch.train import trainer as TTR

ARGS = ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
        "--steps", "10", "--batch", "4", "--seq", "16", "--ckpt-every", "3"]


class Killed(Exception):
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(monkeypatch, mesh, ckpt=None, kill_at=None):
    """The CLI on ``mesh`` (data, model); {step: loss} of every step it
    ran, read from the state's step counter."""
    losses = {}
    real = TTR.make_train_step

    def make(cfg, tc, mark=None, *, mesh=None):
        step = real(cfg, tc, mark, mesh=mesh)

        def run(state, batch):
            i = int(state["opt"]["step"].shards[0])
            if i == kill_at:
                raise Killed(i)
            state, m = step(state, batch)
            losses[i] = float(m["loss"])
            return state, m
        return run

    monkeypatch.setattr(TTR, "make_train_step", make)
    argv = ARGS + ["--data", str(mesh[0]), "--model", str(mesh[1])]
    if ckpt:
        argv += ["--ckpt-dir", str(ckpt)]
    try:
        train_cli.main(argv)
    except Killed:
        pass
    monkeypatch.setattr(TTR, "make_train_step", real)
    return losses


def test_killed_on_2x2_resumes_on_4x1_and_1x1(tmp_path, monkeypatch,
                                              capsys):
    whole = _run(monkeypatch, (2, 2))
    assert sorted(whole) == list(range(10))
    ck = tmp_path / "ck"
    first = _run(monkeypatch, (2, 2), ck, kill_at=7)
    out = capsys.readouterr().out
    assert "mesh {'data': 2, 'model': 2} arch starcoder2-3b quant float" \
        in out
    assert sorted(first) == list(range(7)) and latest_step(ck) == 5
    for i in first:
        assert first[i] == whole[i]
    shutil.copytree(ck, tmp_path / "ck11")
    for mesh, where in (((4, 1), ck), ((1, 1), tmp_path / "ck11")):
        resumed = _run(monkeypatch, mesh, where)
        out = capsys.readouterr().out
        assert "restored step 5" in out
        assert f"mesh {{'data': {mesh[0]}, 'model': {mesh[1]}}}" in out
        assert sorted(resumed) == list(range(6, 10))
        assert resumed[6] == pytest.approx(whole[6], rel=1e-5), mesh
        for i, loss in resumed.items():
            assert loss == pytest.approx(whole[i], rel=1e-3), (mesh, i)
