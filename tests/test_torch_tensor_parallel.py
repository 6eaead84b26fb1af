"""Tensor parallelism over ``model`` in the port's sharded train step
(``trainer.make_train_step(..., mesh=)``, ``distributed/fsdp.py``): FSDP
over the data axes, and each block whose split falls on whole units
(``fsdp.split_blocks``) computed at every model position on its own
slices, the partial outputs summed, as the reference's GSPMD step does.

On the CPU, on reduced float32 configs and ``device="cpu"`` meshes, the
step is held to the reference's unsharded step with ``microbatches =
data`` within ``tests/_train.py``'s contract; every counted gather,
reduce and partial sum equals ``fsdp.step_traffic``; no leaf of a
tensor-parallel block is gathered whole over ``model``.  Reduced
starcoder2-3b has 4 query heads over 2 KV heads and d_ff 128: on (1, 2)
and (2, 2) its attention and FFN split, on (1, 4) its attention falls
back to the whole-weight gather and its FFN splits.  recurrentgemma-9b
and whisper-base are ``test_torch_tensor_parallel_hybrid.py``'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.quantize import QuantMode
from repro_torch.distributed import fsdp as TFS
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as TMESH
from repro_torch.models import linear as LN
from repro_torch.models import moe as MOE
from repro_torch.tree import leaves_with_path
from repro_torch.train import trainer as TTR

from _tensor_parallel import MESHES, block_share, \
    check_no_whole_model_gather, one_thread, tp_step
from _train import assert_step_close, batch_np, configs, states, tbatch, \
    train_configs

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name,mode", [("starcoder2-3b", "float"),
                                       ("starcoder2-3b", "binary"),
                                       ("qwen3-moe-30b-a3b", "float")])
def test_tp_step_equals_the_reference(name, mode, shape):
    jout, tout, lr, got, want, seen = tp_step(name, mode, shape)
    assert_step_close(jout, tout, lr)
    assert got == want
    blocks = block_share(name, shape, got, mode)
    assert blocks["sharding.tp_reduces"] > 0
    assert blocks["sharding.tp_grad_reduces"] > 0
    check_no_whole_model_gather(name, shape, seen)


def test_per_block_rule():
    """The reduced configs take both branches: 4 query heads over 2 KV
    heads split over 2 positions, not over 4; the FFN's 128 columns over
    both; MQA attention never."""
    sc = get_config("starcoder2-3b", reduced=True)
    assert TFS.split_blocks(sc, 2) == {"attn", "xattn", "mlp"}
    assert TFS.split_blocks(sc, 4) == {"mlp"}
    assert TFS.split_blocks(sc, 1) == frozenset()
    rg = get_config("recurrentgemma-9b", reduced=True)
    assert TFS.split_blocks(rg, 2) == {"mlp", "rec"}
    assert TFS.split_blocks(get_config("mamba2-1.3b", reduced=True),
                            2) == frozenset()
    full = get_config("starcoder2-3b")               # 24 / 2 heads
    assert TFS.split_blocks(full, 2) == {"attn", "xattn", "mlp"}
    assert TFS.split_blocks(full, 16) == {"mlp"}


def test_traffic_of_a_known_tp_layer():
    """The reckoning by hand for reduced starcoder2-3b's stacked w_up (2
    layers of 64 x 128, spec (None, data, model)) on (2, 2), rows 4 of 16
    tokens.  Weights: each of the 4 positions gathers its 64 columns over
    data, once a layer and pass (forward, recompute): 16 gathers of the
    one 2 x 32 x 64 piece it lacks (16384 B); it reduces its gradient to
    that piece's copy: 8 reduces.  The whole-leaf gather would have moved
    3 pieces a data slice.  Activations (the tree's one FFN block, split
    on (2, 2), one call a layer): per call and data slice (2 rows, 2048
    float32 of 64 wide), one forward sum of the other position's partial
    output (8192 B), twice (forward, recompute), and one backward sum of
    the input gradient (8192 B)."""
    mesh = TMESH.make_host_mesh(2, 2, device="cpu")
    _, tcfg = configs("starcoder2-3b")
    tree = {"stack": [({"mlp": {"w_up": {"w": torch.empty(
        (2, 64, 128), device="meta")}}},)]}
    specs = TSH.param_specs(tree, mesh)
    assert specs == {"stack/0/0/mlp/w_up/w": (None, "data", "model")}
    nb = tbatch(batch_np(tcfg, b=4))
    t = TFS.step_traffic(tree, specs, mesh, cfg=tcfg, batch=nb)
    piece = 2 * 32 * 64 * 4
    assert t == {"sharding.gathers": 16,
                 "sharding.gathered_bytes": 8 * piece,
                 "sharding.reduces": 8, "sharding.reduced_bytes": 4 * piece,
                 "sharding.partial_sums": 3,
                 "sharding.tp_reduces": 8,
                 "sharding.tp_reduced_bytes": 8 * 8192,
                 "sharding.tp_grad_reduces": 4,
                 "sharding.tp_grad_reduced_bytes": 4 * 8192,
                 "sharding.tp_gathers": 0, "sharding.tp_gathered_bytes": 0}


def _positions(trees):
    cpu = torch.device("cpu")
    return TFS._Positions(trees, [cpu] * len(trees), cpu)


@pytest.mark.parametrize("mode", ["binary", "binary_weight"])
def test_row_parallel_alpha(mode):
    """A row-parallel linear in the binary modes scales by the whole
    d_in's mean |w|, applied once after the partial sums: equal to the
    unsplit linear, where the first position's own mean would be about
    5x too small."""
    quant = dataclasses.replace(get_config("starcoder2-3b", quant=mode,
                                           reduced=True).quant)
    assert quant.mode != QuantMode.FLOAT
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((64, 32), generator=gen)
    w[32:] *= 10.0                   # the second position's rows dominate
    x = torch.randn((3, 5, 64), generator=gen)
    want = LN.apply_linear({"w": w}, x, quant, dtype=torch.float32)
    par = _positions([{"w": w[:32]}, {"w": w[32:]}])
    got = LN.apply_row_parallel(par, par.trees, [x[..., :32], x[..., 32:]],
                                quant, dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    local = torch.abs(w[:32]).mean(0)
    assert float((local / torch.abs(w).mean(0)).max()) < 0.3


def test_moe_capacity_from_the_global_experts():
    """Expert parallelism keeps the capacity of the global E: with 16
    tokens, top-2 of 4 experts, C = 12; a position's 2 experts would give
    C = 20 and keep the 8 choices that C = 12 drops.  The split layer
    equals the whole one, drops included."""
    cfg, tcfg = configs("qwen3-moe-30b-a3b")
    moe = tcfg.moe
    assert MOE._capacity(16, moe) == 12
    local = dataclasses.replace(moe, num_experts=moe.num_experts // 2)
    assert MOE._capacity(16, local) == 20
    gen = torch.Generator().manual_seed(1)
    d = tcfg.d_model
    params = {"router": {"w": torch.zeros((d, 4))},
              **{k: {"we": torch.randn(shape, generator=gen) * 0.1}
                 for k, shape in (("we_up", (4, d, 32)),
                                  ("we_gate", (4, d, 32)),
                                  ("we_down", (4, 32, d)))}}
    params["router"]["w"][:, 0] = 1.0     # every token's first choice: 0
    x = torch.rand((1, 16, d), generator=gen) + 0.5
    probs = torch.softmax(x[0] @ params["router"]["w"], -1)
    top_e = MOE.top_k(probs, moe.top_k)[1]
    kept = [int((MOE._dispatch_indices(top_e, 4, c)[1] >= 0).sum())
            for c in (12, 20)]
    assert kept == [24, 32]
    want = MOE.apply_moe(params, tcfg, x)
    halves = [{"router": params["router"],
               **{k: {"we": params[k]["we"][j * 2:(j + 1) * 2]}
                  for k in ("we_up", "we_gate", "we_down")}}
              for j in range(2)]
    got = MOE.apply_moe(_positions(halves), tcfg, x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# bfloat16 activations: the step on (2, 2) against the port's unsharded
# step with microbatches=2 (the same rows).  The row-parallel partial
# outputs and the column-parallel partial input gradients are summed in
# float32 and rounded once, as the unsplit bfloat16 product rounds its
# float32 sum once; they differ from it only in the order of the float32
# sums.  Read on this CPU: loss equal, grad_norm 1.9e-5 apart (rtol), mu
# at most 7.0e-3 of a leaf's largest (with bfloat16 partial input
# gradients: 6.5e-4 and 1.34e-2).  grad_norm held to phase 9's 1e-4, mu
# to about three times the reading.
BF16_LOSS_RTOL, BF16_NORM_RTOL, BF16_MU = 1e-5, 1e-4, 2e-2


def test_bf16_tp_step_against_the_unsharded_step():
    jcfg, tcfg = configs("starcoder2-3b", dtype="bfloat16")
    assert tcfg.activation_dtype == torch.bfloat16
    jtc, _ = train_configs()
    _, ttc = train_configs(microbatches=2)
    _, ts = states(jcfg, jtc)
    _, ref_state = states(jcfg, jtc)
    nb = tbatch(batch_np(jcfg, b=4))
    ref_state, ref = TTR.make_train_step(tcfg, ttc)(ref_state, nb)
    mesh = TMESH.make_host_mesh(2, 2, device="cpu")
    placed = TSH.Shardings(mesh, TTR.state_specs(ts, mesh)).place(
        ts, donate=True)
    _, tc1 = train_configs()
    st, got = TTR.make_train_step(tcfg, tc1, mesh=mesh)(placed, nb)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(ref["grad_norm"]), rtol=BF16_NORM_RTOL)
    mu = dict(leaves_with_path(TSH.unshard(st, "cpu")["opt"]["mu"]))
    for path, want in leaves_with_path(ref_state["opt"]["mu"]):
        top = float(want.abs().max())
        gap = float((mu[path] - want).abs().max())
        assert gap <= BF16_MU * max(top, 1e-30), (path, gap, top)
