"""Shared set-up of the tensor-parallel step's parity tests
(``test_torch_tensor_parallel*.py``): the reference's unsharded step with
``microbatches = data`` (the same row slices as the mesh's data slices),
run once per (config, mode, data) and reused across meshes, and the
port's step on a (data, model) CPU mesh from a fresh copy of the same
state, with its counted traffic, the reckoning, and every gather the step
made, by leaf.  Not a test module."""
import dataclasses
import functools

import jax
import torch

from repro.train import trainer as JTR
from repro_torch import convert as CV
from repro_torch import telemetry as TTEL
from repro_torch.distributed import fsdp as TFS
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as TMESH
from repro_torch.models import common as C
from repro_torch.models import model as M
from repro_torch.train import trainer as TTR
from repro_torch.tree import leaves_with_path

from _train import batch_np, configs, jbatch, states, tbatch, train_configs

ROWS = 4
MESHES = ((1, 2), (2, 2), (1, 4))


def counts() -> dict:
    m = TTEL.default().metrics
    return {k: m.value(k) for k in TFS.COUNTERS}


def split_configs(name, mode="float", dtype="float32", ssm_split=False):
    """``_train.configs``, with Mamba-2's split form
    (``fused_proj=False``) in both packages' configs where
    ``ssm_split``."""
    cfg, tcfg = configs(name, mode, dtype)
    if ssm_split:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, fused_proj=False))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(
            tcfg.ssm, fused_proj=False))
    return cfg, tcfg


@functools.lru_cache(maxsize=None)
def reference(name, mode, data, dtype="float32", ssm_split=False):
    """(reference state, its step's output, numpy batch, lr): one
    unsharded reference step with ``microbatches = data``."""
    cfg, _ = split_configs(name, mode, dtype, ssm_split)
    jtc, _ = train_configs(microbatches=data)
    js, _ = states(cfg, jtc)
    nb = batch_np(cfg, b=ROWS)
    jout = jax.jit(JTR.make_train_step(cfg, jtc))(js, jbatch(nb))
    return js, jout, nb, jtc.lr


def tp_step(name, mode, shape, dtype="float32", ssm_split=False):
    """The port's step on a ``shape`` CPU mesh from the reference's
    initial state: (reference output, (port state made whole, port
    metrics), lr, counted, reckoned, gathers), ``gathers`` a list of
    (path, model position or None, gathered shape) of every leaf gather
    the step made."""
    js, jout, nb, lr = reference(name, mode, shape[0], dtype, ssm_split)
    _, tcfg = split_configs(name, mode, dtype, ssm_split)
    _, ttc = train_configs()
    ts = CV.train_state_to_torch(js)
    mesh = TMESH.make_host_mesh(*shape, device="cpu")
    want = TFS.step_traffic(ts["params"], TSH.param_specs(ts["params"],
                                                          mesh), mesh,
                            cfg=tcfg, batch=tbatch(nb))
    placed = TSH.Shardings(mesh, TTR.state_specs(ts, mesh)).place(
        ts, donate=True)
    seen = []
    gather = TFS._Leaf.gather

    def spy(leaf, d, g=None, j=None):
        out = gather(leaf, d, g, j)
        seen.append((leaf.path, j, tuple(out.shape)))
        return out

    before = counts()
    TFS._Leaf.gather = spy
    try:
        st, tm = TTR.make_train_step(tcfg, ttc, mesh=mesh)(placed,
                                                           tbatch(nb))
    finally:
        TFS._Leaf.gather = gather
    got = {k: v - before[k] for k, v in counts().items()}
    return jout, (TSH.unshard(st, "cpu"), tm), lr, got, want, seen


def block_share(name, shape, got, mode="float", ssm_split=False) -> dict:
    """``got``'s :data:`fsdp.TP_COUNTERS` less the vocabulary-parallel
    embedding's and loss's share (``fsdp.step_traffic`` of the ``embed``
    and ``head`` leaves alone, on :func:`tp_step`'s batch): what the
    tensor-parallel blocks moved between model positions."""
    _, tcfg = split_configs(name, mode, ssm_split=ssm_split)
    mesh = TMESH.make_host_mesh(*shape, device="cpu")
    params = M.init_model(C.MetaGenerator(), tcfg, device="meta")
    sub = {k: params[k] for k in ("embed", "head") if k in params}
    vocab = TFS.step_traffic(sub, TSH.param_specs(sub, mesh), mesh,
                             cfg=tcfg, batch=tbatch(batch_np(tcfg, b=ROWS)))
    return {k: got[k] - vocab[k] for k in TFS.TP_COUNTERS}


def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n


def check_no_whole_model_gather(name, shape, seen, ssm_split=False):
    """Every leaf split over ``model`` in a tensor-parallel block, and
    every vocabulary-split leaf (``fsdp.vocab_split``), is gathered per
    model position, at 1/|model| of its split axis; the blocks that fall
    back, and a vocabulary that does not split, are gathered whole."""
    _, tcfg = split_configs(name, ssm_split=ssm_split)
    m = shape[1]
    split = TFS.split_blocks(tcfg, m)
    mesh = TMESH.make_host_mesh(*shape, device="cpu")
    params = dict(leaves_with_path(M.init_model(C.MetaGenerator(), tcfg,
                                                device="meta")))
    specs = TSH.param_specs(params, mesh)
    tp = {p for p in params if TFS.block_of(p) in split
          and "model" in TFS._names(specs[p])}
    vocab = {p for p in params if TFS.vocab_split(p, specs[p])}
    assert tp
    for path, j, got in seen:
        if path not in tp | vocab:
            assert j is None, path
            continue
        assert j is not None, path
        axis = next(k for k, ax in enumerate(specs[path]) if ax == "model")
        lead = 0 if path in vocab else 1          # the layer axis
        whole = list(params[path].shape[lead:])
        whole[axis - lead] //= m
        assert list(got) == whole, (path, got, whole)
