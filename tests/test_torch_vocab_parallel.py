"""The vocabulary-parallel embedding and loss in the port's sharded train
step (``fsdp.vocab_split``, ``common.embed_parallel``,
``model._vocab_parallel_nll``), on the CPU.

On reduced float32 configs (vocabulary 256, which 2 and 4 divide) and
``device="cpu"`` meshes, the sharded step is held to the reference's
unsharded step with ``microbatches = data`` within ``tests/_train.py``'s
contract (``_tensor_parallel.tp_step``): gemma2-9b (tied table,
softcapped logits) on (1, 2), starcoder2-3b (untied head) on (1, 4).
Every counter equals ``fsdp.step_traffic``, and no vocabulary-split leaf
is gathered whole over ``model``.  A vocabulary that |model| does not
divide, and a table that ``replicate_embed`` replicates, keep the whole
gather; the new counters are reckoned by hand for one chunk and one data
slice.

Tolerances: the step's, ``tests/_train.py``'s (loss and grad_norm rtol
1e-5, the moments 1e-4 of a value plus 1e-5 of the largest, params
1e-6).  The lookup's sum has one non-zero term an element, so it is held
equal (``torch.equal``) to the unsplit lookup, its gradient too; the
split log-sum-exp rounds apart from the whole row's by ulps: the loss
within rtol 1e-6 of the unsplit loss, and the head's gradient within the
moments' bound (read on this CPU: 2.3e-7 apart at most, where the tied
table's two uses add in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import get_config
from repro_torch.distributed import fsdp as TFS
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as TMESH
from repro_torch.models import common as C
from repro_torch.models import model as M
from repro_torch.train import trainer as TTR
from repro_torch.tree import leaves_with_path

from _tensor_parallel import check_no_whole_model_gather, counts, \
    one_thread, reference, tp_step
from _train import MOMENT_ATOL, MOMENT_RTOL, assert_step_close, batch_np, \
    configs, tbatch, train_configs

LOSS_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,shape", [("gemma2-9b", (1, 2)),
                                        ("starcoder2-3b", (1, 4))])
def test_vocab_parallel_step_equals_the_reference(name, shape):
    jout, tout, lr, got, want, seen = tp_step(name, "float", shape)
    assert_step_close(jout, tout, lr)
    assert got == want
    # the loss's partial log-sum-exps, twice (forward, recompute)
    assert got["sharding.tp_gathers"] >= 2
    vocab = {p for p, j, _ in seen
             if p in TSH.VOCAB_LEAVES and j is not None}
    assert vocab == ({"embed/table"} if name == "gemma2-9b"
                     else {"embed/table", "head/w"})
    check_no_whole_model_gather(name, shape, seen)


def _positions(trees):
    cpu = torch.device("cpu")
    return TFS._Positions(trees, [cpu] * len(trees), cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_equals_the_whole_table(dtype):
    """Each token's row comes from the one position that holds it: the
    split lookup and its gradient equal the whole table's, bit for
    bit; the sum is counted in ``dtype``."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((12, 5), generator=gen)
    tokens = torch.tensor([[0, 3, 4, 11], [7, 8, 3, 5]])
    g = torch.randn((2, 4, 5), generator=gen).to(dtype)
    whole = table.clone().requires_grad_(True)
    want = C.embed({"table": whole}, tokens, dtype)
    want.backward(g)
    slices = [table[i:i + 4].clone().requires_grad_(True)
              for i in (0, 4, 8)]
    before = counts()
    got = C.embed(_positions([{"table": t} for t in slices]), tokens,
                  dtype)
    after = counts()
    got.backward(g)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(torch.cat([t.grad for t in slices]), whole.grad)
    item = torch.empty((), dtype=dtype).element_size()
    assert after["sharding.tp_reduces"] - before["sharding.tp_reduces"] == 1
    assert (after["sharding.tp_reduced_bytes"]
            - before["sharding.tp_reduced_bytes"]) == 2 * 2 * 4 * 5 * item


@pytest.mark.parametrize("name", ["gemma2-9b", "starcoder2-3b"])
def test_loss_with_ignored_labels(name):
    """``loss_fn`` with the head split over 2 positions equals the
    unsplit loss, labels of -1 counting for nothing, the gradient of the
    tied table (lookup and unembed) the sum of both uses."""
    _, tcfg = configs(name)
    params = M.init_model(torch.Generator().manual_seed(1), tcfg,
                          device="cpu")
    nb = batch_np(tcfg, b=2, s=8)
    nb["labels"][0, :3] = -1
    nb["labels"][1, 5] = -1
    batch = tbatch(nb)
    key, axis = ("embed", 0) if tcfg.tie_embeddings else ("head", 1)
    leaf = "table" if tcfg.tie_embeddings else "w"
    whole = params[key][leaf].clone().requires_grad_(True)
    want = M.loss_fn({**params, key: {leaf: whole}}, tcfg, batch)
    want.backward()
    halves = [t.clone().requires_grad_(True)
              for t in torch.chunk(params[key][leaf], 2, dim=axis)]
    par = _positions([{leaf: t} for t in halves])
    got = M.loss_fn({**params, key: par}, tcfg, batch)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=LOSS_RTOL)
    grad = torch.cat([t.grad for t in halves], dim=axis)
    top = float(whole.grad.abs().max())
    torch.testing.assert_close(grad, whole.grad, rtol=MOMENT_RTOL,
                               atol=MOMENT_ATOL * top)


def _sharded_vs_unsharded(tcfg, shape):
    """The port's step on ``shape`` and its unsharded step with
    ``microbatches = data`` from one fresh state: (sharded metrics,
    unsharded metrics, counted, reckoned, gathers)."""
    gen = torch.Generator().manual_seed(0)
    _, ttc = train_configs()
    state = TTR.init_train_state(gen, tcfg, ttc, device="cpu")
    ref = TTR.init_train_state(torch.Generator().manual_seed(0), tcfg,
                               ttc, device="cpu")
    nb = tbatch(batch_np(tcfg, b=4))
    _, rtc = train_configs(microbatches=shape[0])
    _, ref_m = TTR.make_train_step(tcfg, rtc)(ref, nb)
    mesh = TMESH.make_host_mesh(*shape, device="cpu")
    want = TFS.step_traffic(state["params"], TSH.param_specs(
        state["params"], mesh), mesh, cfg=tcfg, batch=nb)
    placed = TSH.Shardings(mesh, TTR.state_specs(state, mesh)).place(state)
    seen, gather = [], TFS._Leaf.gather

    def spy(leaf, d, g=None, j=None):
        seen.append((leaf.path, j))
        return gather(leaf, d, g, j)

    before = counts()
    TFS._Leaf.gather = spy
    try:
        _, got_m = TTR.make_train_step(tcfg, ttc, mesh=mesh)(placed, nb)
    finally:
        TFS._Leaf.gather = gather
    got = {k: v - before[k] for k, v in counts().items()}
    return got_m, ref_m, got, want, seen


def test_vocabulary_that_does_not_split_is_gathered_whole():
    """Reduced starcoder2-3b with a vocabulary of 255 on (2, 2): ``_fit``
    drops 'model' from the table's and the head's vocabulary axis, so
    both are gathered whole at each data slice's first position, no
    vocabulary collective runs, and the step equals the unsharded one."""
    _, tcfg = configs("starcoder2-3b")
    tcfg = dataclasses.replace(tcfg, vocab_size=255)
    got_m, ref_m, got, want, seen = _sharded_vs_unsharded(tcfg, (2, 2))
    assert got == want
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]),
                                   rtol=1e-5)
    vocab = [(p, j) for p, j in seen if p in TSH.VOCAB_LEAVES]
    assert vocab and all(j is None for _, j in vocab)
    # whisper-base's 51,865 ids at full width: reckoned on meta tensors
    wcfg = get_config("whisper-base")
    meta = M.init_model(C.MetaGenerator(), wcfg, device="meta")
    for shape in ((1, 2), (2, 2), (1, 4)):
        mesh = TMESH.make_host_mesh(*shape, device="cpu")
        specs = TSH.param_specs(meta, mesh)
        assert not any(TFS.vocab_split(p, specs[p]) for p in specs)
        table = {"embed": meta["embed"]}
        t = TFS.step_traffic(table, {"embed/table": specs["embed/table"]},
                             mesh, cfg=wcfg, batch={"labels": torch.empty(
                                 (4, 448), device="meta")})
        assert all(t[k] == 0 for k in TFS.TP_COUNTERS)
        numel = 51865 * 512
        assert t["sharding.gathers"] == (shape[0] if shape[0] > 1 else 0)
        assert t["sharding.gathered_bytes"] == (
            numel * 4 if shape[0] > 1 else 0)


def test_replicate_embed_gathers_nothing_for_the_table():
    """``replicate_embed`` on (1, 2): the table's spec is (), one copy on
    the one device, read where it lies: no gather, no reduce and no
    lookup sum counted for it, while the untied head stays
    vocabulary-parallel; the step from the reference's state equals the
    reference's."""
    js, jout, nb, lr = reference("starcoder2-3b", "float", 1)
    _, tcfg = configs("starcoder2-3b")
    _, ttc = train_configs()
    ts = CV.train_state_to_torch(js)
    mesh = TMESH.make_host_mesh(1, 2, device="cpu")
    specs = TSH.param_specs(ts["params"], mesh, replicate_embed=True)
    assert specs["embed/table"] == () and specs["head/w"] == (None, "model")
    want = TFS.step_traffic(ts["params"], specs, mesh, cfg=tcfg,
                            batch=tbatch(nb))
    table = {"embed": ts["params"]["embed"]}
    assert all(v == 0 for v in TFS.step_traffic(
        table, {"embed/table": ()}, mesh, cfg=tcfg,
        batch=tbatch(nb)).values())
    # trainer.state_specs with the table's spec () in params, mu and nu
    sspecs = {p: (() if p.endswith("embed/table") else spec)
              for p, spec in TTR.state_specs(ts, mesh).items()}
    placed = TSH.Shardings(mesh, sspecs).place(ts, donate=True)
    seen, gather = [], TFS._Leaf.gather

    def spy(leaf, d, g=None, j=None):
        seen.append((leaf.path, j))
        return gather(leaf, d, g, j)

    before = counts()
    TFS._Leaf.gather = spy
    try:
        st, tm = TTR.make_train_step(tcfg, ttc, mesh=mesh)(placed,
                                                          tbatch(nb))
    finally:
        TFS._Leaf.gather = gather
    got = {k: v - before[k] for k, v in counts().items()}
    assert got == want
    assert ("head/w", 1) in seen
    assert all(j is None for p, j in seen if p == "embed/table")
    assert_step_close(jout, (TSH.unshard(st, "cpu"), tm), lr)


@pytest.mark.parametrize("dtype,embed_bytes", [("float32", 8192),
                                               ("bfloat16", 4096)])
def test_traffic_of_the_vocabulary_by_hand(dtype, embed_bytes):
    """Reduced starcoder2-3b's table (256 x 64, spec (model, None)) and
    untied head (64 x 256, spec (None, model)) on (1, 2), one data slice
    of 2 rows of 16 tokens, one 16-row loss chunk.  Each position holds
    its vocabulary half whole: nothing gathered or reduced; one partial
    sum a leaf.  The lookup sums 32 rows of 64 from the other position
    once, in the activation dtype (8192 bytes float32, 4096 bfloat16);
    the loss chunk fans the 32 x 64 normed hidden state out and sums its
    float32 partial gradient once (8192 bytes), gathers the float32
    partial log-sum-exps and sums the target logits (128 bytes each) in
    the forward and the recompute."""
    _, tcfg = configs("starcoder2-3b", dtype=dtype)
    mesh = TMESH.make_host_mesh(1, 2, device="cpu")
    tree = {"embed": {"table": torch.empty((256, 64), device="meta")},
            "head": {"w": torch.empty((64, 256), device="meta")},
            "ln_out": {"scale": torch.empty((64,), device="meta")}}
    specs = TSH.param_specs(tree, mesh)
    assert specs == {"embed/table": ("model", None),
                     "head/w": (None, "model"), "ln_out/scale": ()}
    nb = tbatch(batch_np(tcfg, b=2))
    t = TFS.step_traffic(tree, specs, mesh, cfg=tcfg, batch=nb)
    assert t == {"sharding.gathers": 0, "sharding.gathered_bytes": 0,
                 "sharding.reduces": 0, "sharding.reduced_bytes": 0,
                 "sharding.partial_sums": 2,
                 "sharding.tp_reduces": 3,
                 "sharding.tp_reduced_bytes": embed_bytes + 2 * 128,
                 "sharding.tp_grad_reduces": 1,
                 "sharding.tp_grad_reduced_bytes": 8192,
                 "sharding.tp_gathers": 2, "sharding.tp_gathered_bytes": 256}
    rows = dict(leaves_with_path(tree))
    assert [p for p in rows if TFS.vocab_split(p, specs[p])] == \
        ["embed/table", "head/w"]
