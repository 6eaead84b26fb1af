"""The port's train step over a mesh (``trainer.make_train_step(...,
mesh=)``, ``distributed/fsdp.py``) against the JAX reference's unsharded
step, on the CPU, on reduced float32 configs and ``device="cpu"`` meshes.

The state crosses from the reference (``convert.train_state_to_torch``)
and is placed by ``trainer.state_specs``; one step on a numpy batch.  A
data split is a microbatch split, so the sharded step on a (data, model)
mesh with ``microbatches = n`` is held to the reference's step with
``microbatches = data x n``, which takes the same row slices (an MoE
layer's capacity depends on its rows), within ``tests/_train.py``'s
contract.  Every gather, reduce and partial sum the step counts, of the
weights and of the tensor-parallel blocks' activations, equals
``fsdp.step_traffic``'s reckoning from shapes, the config and the
batch's shape.
"""
import jax
import numpy as np
import pytest
import torch

from repro.train import trainer as JTR
from repro_torch import telemetry as TTEL
from repro_torch.distributed import fsdp as TFS
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as TMESH
from repro_torch.train import trainer as TTR

from _train import (assert_step_close, batch_np, configs, jbatch, states,
                    tbatch, train_configs)

MESHES = ((2, 2), (4, 1), (1, 4))
ROWS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts():
    m = TTEL.default().metrics
    return {k: m.value(k) for k in TFS.COUNTERS}


def sharded_step(name, mode, shape, *, fsdp=True, rows=ROWS, **tc_kw):
    """The reference's unsharded step and the port's step on ``shape``
    from the same state and batch: ((ref state, ref metrics), (port
    state made whole, port metrics), lr, counted, reckoned, placed
    state)."""
    mesh = TMESH.make_host_mesh(*shape, device="cpu")
    n = tc_kw.pop("microbatches", 1)
    cfg, tcfg = configs(name, mode)
    jtc, _ = train_configs(microbatches=shape[0] * n, **tc_kw)
    _, ttc = train_configs(microbatches=n, **tc_kw)
    js, ts = states(cfg, jtc)
    nb = batch_np(cfg, b=rows)
    jout = jax.jit(JTR.make_train_step(cfg, jtc))(js, jbatch(nb))
    want = TFS.step_traffic(ts["params"], TSH.param_specs(
        ts["params"], mesh, fsdp=fsdp), mesh, microbatches=n,
        compress=ttc.compress_grads, grads_bf16=ttc.grads_bf16, cfg=tcfg,
        batch=tbatch(nb))
    placed = TSH.Shardings(mesh, TTR.state_specs(ts, mesh, fsdp=fsdp)
                           ).place(ts, donate=True)
    before = _counts()
    st, tm = TTR.make_train_step(tcfg, ttc, mesh=mesh)(placed,
                                                      tbatch(nb))
    got = {k: v - before[k] for k, v in _counts().items()}
    return (jout, (TSH.unshard(st, "cpu"), tm), jtc.lr, got, want, st)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name,mode", [("starcoder2-3b", "float"),
                                       ("starcoder2-3b", "binary"),
                                       ("qwen3-moe-30b-a3b", "float")])
def test_sharded_step_equals_the_reference(name, mode, shape):
    jout, tout, lr, got, want, st = sharded_step(name, mode, shape)
    assert_step_close(jout, tout, lr)
    if mode == "binary":
        assert max(float(t.abs().max()) for _, t in
                   TSH.leaves_with_path(tout[0]["params"])) <= 1.0
    assert got == want
    assert got["sharding.gathers"] > 0 and got["sharding.reduces"] > 0


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_compress_and_microbatches(shape):
    for kw in (dict(compress_grads=True), dict(microbatches=2)):
        jout, tout, lr, got, want, st = sharded_step(
            "starcoder2-3b", "float", shape, **kw)
        assert_step_close(jout, tout, lr)
        assert got == want
        if "compress_grads" in kw:
            np.testing.assert_allclose(
                TSH.unshard(st["ef_error"], "cpu")["embed"]["table"].numpy(),
                np.asarray(jout[0]["ef_error"]["embed"]["table"]),
                rtol=1e-4, atol=1e-6)


def test_traffic_of_a_known_leaf():
    """The reckoning by hand for the (2, 2) FSDP step of reduced
    starcoder2-3b's head (64 x 256, spec (data, model), 4 slices of 4096
    floats), which runs vocabulary-parallel: each of the 4 positions
    gathers its 128 columns over data once a microbatch (the one slice it
    lacks, 16384 bytes) and reduces its gradient to that slice's copy;
    the layer norms' scales (spec ()) are one shared copy, neither
    gathered nor reduced.  Activations: each data slice (2 rows of 16,
    one 16-row loss chunk) fans its normed hidden state (32 x 64 float32)
    out to the other model position and sums its partial gradient back
    once (8192 bytes), and gathers the float32 partial log-sum-exps and
    sums the target logits (32 floats, 128 bytes each) in the forward
    and again in the recompute.  The whole-leaf gather it replaces moved
    3 slices a data slice and reduced to 3 copies."""
    mesh = TMESH.make_host_mesh(2, 2, device="cpu")
    head = {"head": {"w": torch.empty((64, 256), device="meta")},
            "ln_out": {"scale": torch.empty((64,), device="meta")}}
    specs = TSH.param_specs(head, mesh)
    assert specs == {"head/w": ("data", "model"), "ln_out/scale": ()}
    _, tcfg = configs("starcoder2-3b", "float")
    nb = tbatch(batch_np(tcfg, b=ROWS))
    t = TFS.step_traffic(head, specs, mesh, cfg=tcfg, batch=nb)
    assert t == {"sharding.gathers": 4, "sharding.gathered_bytes": 4 * 16384,
                 "sharding.reduces": 4, "sharding.reduced_bytes": 4 * 16384,
                 "sharding.partial_sums": 3,
                 "sharding.tp_reduces": 4, "sharding.tp_reduced_bytes": 512,
                 "sharding.tp_grad_reduces": 2,
                 "sharding.tp_grad_reduced_bytes": 2 * 8192,
                 "sharding.tp_gathers": 4, "sharding.tp_gathered_bytes": 512}
    t2 = TFS.step_traffic(head, specs, mesh, cfg=tcfg, batch=nb,
                          microbatches=2, compress=True, grads_bf16=True)
    assert t2 == {"sharding.gathers": 8, "sharding.gathered_bytes": 65536,
                  "sharding.reduces": 8, "sharding.reduced_bytes": 65536,
                  "sharding.partial_sums": 6,
                  "sharding.tp_reduces": 8, "sharding.tp_reduced_bytes": 512,
                  "sharding.tp_grad_reduces": 4,
                  "sharding.tp_grad_reduced_bytes": 4 * 4096,
                  "sharding.tp_gathers": 8, "sharding.tp_gathered_bytes": 512}


def test_shared_copy_updated_once():
    """ZeRO-0 on (2, 2): the layer norms and every leaf split only over
    'model' are shared by the positions of both data slices on the one
    device; each shared tensor is one copy, updated once (an update per
    position would move it 2 or 4 times as far), and the step equals the
    reference's."""
    jout, tout, lr, got, want, st = sharded_step(
        "starcoder2-3b", "float", (2, 2), fsdp=False)
    assert_step_close(jout, tout, lr)
    assert got == want
    placed = dict(TSH.leaves_with_path(st["params"]))
    norm = placed["ln_out/scale"]
    assert len(norm.copies()) == 1 and len(set(map(id, norm.shards))) == 1
    head = placed["head/w"]
    assert head.spec == (None, "model")
    assert [pos for _, _, pos in head.copies()] == [[0, 2], [1, 3]]
    assert int(tout[0]["opt"]["step"]) == 1
    step = st["opt"]["step"]
    assert len(step.copies()) == 1 and int(step.shards[3]) == 1
    # the shared copy moved as far as the reference's one update
    np.testing.assert_allclose(
        tout[0]["params"]["ln_out"]["scale"].numpy(),
        np.asarray(jout[0]["params"]["ln_out"]["scale"]), atol=1e-6)


def test_batch_must_split_over_the_data_slices():
    mesh = TMESH.make_host_mesh(4, 1, device="cpu")
    cfg, tcfg = configs("starcoder2-3b")
    jtc, ttc = train_configs()
    _, ts = states(cfg, jtc)
    placed = TSH.Shardings(mesh, TTR.state_specs(ts, mesh)).place(ts)
    step = TTR.make_train_step(tcfg, ttc, mesh=mesh)
    with pytest.raises(ValueError, match="does not split"):
        step(placed, tbatch(batch_np(cfg, b=2)))
    with pytest.raises(ValueError, match="not placed"):
        step(ts, tbatch(batch_np(cfg, b=4)))
