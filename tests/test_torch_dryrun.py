"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: every
(arch x shape) cell reckoned on the production mesh's meta positions,
and its per-position bytes held to the reference's specs on a 16 x 16
``jax.sharding.AbstractMesh``.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to force 512
devices when it is imported, which would reach every later JAX process
of this worker; so its two plain functions, ``cell_skip_reason`` and
``_microbatches``, are taken from its source and run on their own.
"""
import ast
import json
import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config, list_configs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core.quantize import QuantMode
from repro.distributed import sharding as JSH
from repro.launch import specs as JSP
from repro.models import linear as JLN
from repro.models import model as JM
from repro_torch import convert as CV
from repro_torch.configs import SHAPES, get_shape
from repro_torch.launch import dryrun as TD

REF_DRYRUN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src", "repro", "launch", "dryrun.py")
CELLS = [(a, s) for a in ("starcoder2-3b", "gemma2-9b") for s in SHAPES]


def _ref_functions() -> dict:
    tree = ast.parse(open(REF_DRYRUN, encoding="utf-8").read())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("cell_skip_reason", "_microbatches")]
    ns = {"ArchConfig": object, "ShapeConfig": object}
    exec(compile(ast.Module(fns, []), REF_DRYRUN, "exec"), ns)
    return ns


REF = _ref_functions()
MESH16 = AbstractMesh((16, 16), ("data", "model"))


def _ref_bytes(tree, specs) -> int:
    """The bytes a position of MESH16 holds of ``tree`` under the
    reference's specs (every assignment divides its dim)."""
    total = 0
    for leaf, spec in zip(jtu.tree_leaves(tree), jtu.tree_leaves(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        n = leaf.size * jnp.dtype(leaf.dtype).itemsize
        for ax in spec:
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                if name is not None:
                    n //= MESH16.shape[name]
        total += n
    return total


def _ref_params(cfg, serve):
    def mk():
        p = JM.init_model(jax.random.PRNGKey(0), cfg)
        if serve:
            if cfg.quant.mode != QuantMode.FLOAT:
                p = JLN.maybe_pack_tree(p, cfg.quant)
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                             if a.dtype == jnp.float32 else a, p)
        return p
    return jax.eval_shape(mk)


def _ref_cell_bytes(arch, shape_name, quant=None) -> dict:
    cfg, shape = get_config(arch, quant=quant), JSHAPES[shape_name]
    if shape.kind == "train":
        jp = _ref_params(cfg, False)
        pb = _ref_bytes(jp, JSH.param_specs(jp, MESH16))
        batch = JSP.train_batch_specs(cfg, shape)
        return {"params": pb, "opt_state": 2 * pb + 4, "grads": pb,
                "batch": _ref_bytes(batch, JSH.batch_specs(batch, MESH16))}
    jp = _ref_params(cfg, True)
    out = {"params": _ref_bytes(jp, JSH.param_specs(jp, MESH16))}
    if shape.kind == "prefill":
        batch = JSP.prefill_batch_specs(cfg, shape)
        out["batch"] = _ref_bytes(batch, JSH.batch_specs(batch, MESH16))
        return out
    cache = jax.eval_shape(lambda: JM.init_cache(
        jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jp), cfg,
        shape.global_batch, shape.seq_len))
    out["cache"] = _ref_bytes(cache, JSH.cache_specs(
        cache, MESH16, shard_seq=shape.global_batch == 1,
        kv_layout="seq_model"))
    tokens = {"tokens": JSP.decode_token_specs(shape)}
    out["batch"] = _ref_bytes(tokens, JSH.batch_specs(tokens, MESH16))
    return out


def test_shapes_equal_the_reference():
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.kind) for k, v in JSHAPES.items()}
    assert get_shape("train_4k").global_batch == 256


@pytest.mark.parametrize("arch,shape", CELLS + [
    ("mamba2-1.3b", "long_500k"), ("gemma2-9b", "long_500k")])
def test_cells(tmp_path, arch, shape):
    rec = TD.run_cell(arch, shape, out_dir=str(tmp_path))
    path = tmp_path / (TD._cell_id(rec) + ".json")
    assert json.loads(path.read_text())["status"] == rec["status"]
    cfg = get_config(arch)
    want = REF["cell_skip_reason"](cfg, JSHAPES[shape])
    assert rec.get("skip_reason") == want
    if want:
        assert rec["status"] == "skipped" and "bytes_per_position" not in rec
        return
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["positions"] == 256
    assert rec["param_counts"] == cfg.param_counts()
    assert rec["bytes_per_position"] == _ref_cell_bytes(arch, shape)
    assert rec["fits_hbm"] == (rec["bytes_per_position_total"] <= 80e9)
    kind = rec["kind"]
    tokens = (JSHAPES[shape].global_batch *
              (JSHAPES[shape].seq_len if kind != "decode" else 1))
    factor = 6.0 if kind == "train" else 2.0
    assert rec["model_flops"] == factor * cfg.param_counts()["active"] * \
        tokens
    if kind == "train":
        assert rec["microbatches"] == REF["_microbatches"](
            cfg, JSHAPES[shape])
        assert rec["fsdp"] is True
        t = rec["step_traffic"]
        assert t["gathers"] > 0 and t["gathered_bytes"] > 0
        assert t["reduces"] > 0 and t["reduced_bytes"] > 0
    else:
        assert rec["step_traffic"] is None


def test_gemma2_train_bytes_per_position():
    """gemma2-9b's float32 params on the production mesh: 9.2414e9 x 4 B
    over 256 positions where every large leaf splits both ways."""
    rec = TD.run_cell("gemma2-9b", "train_4k")
    assert rec["bytes_per_position"]["params"] == _ref_cell_bytes(
        "gemma2-9b", "train_4k")["params"]
    assert abs(rec["bytes_per_position"]["params"]
               - 9.2414e9 * 4 / 256) / (9.2414e9 * 4 / 256) < 0.01


def test_binary_decode_cell_equals_the_reference():
    rec = TD.run_cell("starcoder2-3b", "decode_32k", quant="binary")
    assert rec["bytes_per_position"] == _ref_cell_bytes(
        "starcoder2-3b", "decode_32k", quant="binary")
    assert rec["quant"] == "binary"


def test_multi_pod_cell():
    rec = TD.run_cell("starcoder2-3b", "train_4k", multi_pod=True)
    assert rec["mesh"] == "2x16x16" and rec["positions"] == 512
    assert rec["axes"] == ["pod", "data", "model"]
    single = TD.run_cell("starcoder2-3b", "train_4k")
    assert rec["bytes_per_position"]["batch"] * 2 == \
        single["bytes_per_position"]["batch"]


def test_microbatches_over_the_mesh_positions():
    """The reference's rule at its 256 positions, and fewer positions
    needing deeper accumulation."""
    cfg = get_config("qwen2-vl-72b")
    tcfg = CV.arch_config(cfg)
    shape = JSHAPES["train_4k"]
    for arch in list_configs():
        c = get_config(arch)
        assert TD._microbatches(CV.arch_config(c), get_shape("train_4k"),
                                256) == REF["_microbatches"](c, shape)
    assert TD._microbatches(tcfg, get_shape("train_4k"), 16) >= \
        TD._microbatches(tcfg, get_shape("train_4k"), 256)


def test_all_cells(tmp_path):
    """``--all``: a record for every (arch x shape) cell, the reference's
    skip reasons."""
    TD.main(["--all", "--out", str(tmp_path)])
    files = sorted(os.listdir(tmp_path))
    assert len(files) == len(list_configs()) * len(SHAPES)
    for a in list_configs():
        cfg = get_config(a)
        for s in SHAPES:
            rec = json.loads((tmp_path / f"{a}__{s}__16x16__float.json")
                             .read_text())
            reason = REF["cell_skip_reason"](cfg, JSHAPES[s])
            assert rec["status"] == ("skipped" if reason else "ok")
            assert rec.get("skip_reason") == reason
