"""The port's dry run (``repro_torch.launch.dryrun``) with the reference's
options (``run_cell(..., layers_override, opts, tag)``,
``src/repro/launch/dryrun.py``): ``replicate_embed``, ``fsdp`` False and
``"auto"``, ``ssm_split``, ``kv_int8`` with ``kv_layout``,
``layers_override`` and ``tag``.  The specs each record reports equal the
reference's ``param_specs`` / ``cache_specs`` with the same options on a
16 x 16 ``jax.sharding.AbstractMesh`` (the reference's functions read
only the mesh's axis sizes and the leaves' shapes), path for path; the
traffic follows the options.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.sharding import AbstractMesh

from repro.configs import get_config
from repro.distributed import sharding as JSH
from repro.models import model as JM
from repro_torch import convert as CV
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import dryrun as TD
from repro_torch.launch.mesh import make_production_mesh

MESH16 = AbstractMesh((16, 16), ("data", "model"))


def _ref_specs(specs_tree, like) -> dict:
    flat = jtu.tree_flatten_with_path(like)[0]
    specs = jtu.tree_leaves(specs_tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    return {JSH._path_str(p): tuple(s) for (p, _), s in zip(flat, specs)}


def _port_specs(rec_specs) -> dict:
    return {p: tuple(tuple(a) if isinstance(a, list) else a for a in spec)
            for p, spec in rec_specs.items()}


def _ref_train_specs(cfg, **kw) -> dict:
    jp = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), cfg))
    return _ref_specs(JSH.param_specs(jp, MESH16, **kw), jp)


def _split(cfg):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, fused_proj=False))


def test_replicate_embed():
    rec = TD.run_cell("starcoder2-3b", "train_4k",
                      opts={"replicate_embed": True})
    assert rec["opts"] == {"replicate_embed": True} and rec["fsdp"] is True
    want = _ref_train_specs(get_config("starcoder2-3b"),
                            replicate_embed=True)
    assert _port_specs(rec["param_specs"]) == want
    assert want["embed/table"] == ()
    base = TD.run_cell("starcoder2-3b", "train_4k")
    assert base["param_specs"]["embed/table"] == ["model", "data"]
    # the replicated table is read where it lies, its lookup sums nothing
    # over 'model', and its gradient goes to each of its 256 copies
    for k in ("gathered_bytes", "tp_reduced_bytes"):
        assert rec["step_traffic"][k] < base["step_traffic"][k], k
    assert rec["step_traffic"]["reduced_bytes"] > \
        base["step_traffic"]["reduced_bytes"]


def test_fsdp_false_and_auto():
    cfg = get_config("starcoder2-3b")
    off = TD.run_cell("starcoder2-3b", "train_4k", opts={"fsdp": False})
    assert off["fsdp"] is False
    assert _port_specs(off["param_specs"]) == _ref_train_specs(
        cfg, fsdp=False)
    auto = TD.run_cell("starcoder2-3b", "train_4k", opts={"fsdp": "auto"})
    decided = TSH.should_fsdp(CV.arch_config(cfg), make_production_mesh())
    assert auto["fsdp"] is decided
    assert _port_specs(auto["param_specs"]) == _ref_train_specs(
        cfg, fsdp=decided)
    # ZeRO-0 gathers over 'model' only (the attention that 16 positions
    # do not split) and reduces the gradients to every data slice's copy
    base = TD.run_cell("starcoder2-3b", "train_4k")
    assert 0 < off["step_traffic"]["gathered_bytes"] < \
        base["step_traffic"]["gathered_bytes"]
    assert off["step_traffic"]["reduced_bytes"] > \
        base["step_traffic"]["reduced_bytes"]
    # serving reads the option as the reference's builders do
    dec = TD.run_cell("starcoder2-3b", "decode_32k", opts={"fsdp": False})
    assert all("data" not in spec for spec in dec["param_specs"].values())


def test_ssm_split():
    rec = TD.run_cell("mamba2-1.3b", "train_4k", opts={"ssm_split": True})
    want = _ref_train_specs(_split(get_config("mamba2-1.3b")))
    assert _port_specs(rec["param_specs"]) == want
    assert want["stack/0/0/ssm/z_proj/w"] == (None, "data", "model")
    fused = TD.run_cell("mamba2-1.3b", "train_4k")
    assert "stack/0/0/ssm/in_proj/w" in fused["param_specs"]
    # 64 heads over 16 positions: the block runs tensor-parallel, and its
    # norm's sums of squares and row-parallel outputs are summed
    assert rec["step_traffic"]["tp_reduces"] > \
        fused["step_traffic"]["tp_reduces"]


def test_kv_int8_with_layout():
    recs = {}
    for layout in ("seq_model", "batch_heads"):
        rec = recs[layout] = TD.run_cell(
            "starcoder2-3b", "decode_32k",
            opts={"kv_int8": True, "kv_layout": layout})
        cfg = dataclasses.replace(get_config("starcoder2-3b"),
                                  kv_cache_dtype="int8")
        jp = jax.eval_shape(lambda: jax.tree.map(
            lambda a: a.astype(jnp.bfloat16), JM.init_model(
                jax.random.PRNGKey(0), cfg)))
        cache = jax.eval_shape(lambda: JM.init_cache(jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), jp), cfg, 128, 32768))
        want = _ref_specs(JSH.cache_specs(cache, MESH16, kv_layout=layout),
                          cache)
        assert _port_specs(rec["cache_specs"]) == want
        assert any(p.endswith("k_scale") for p in want)
    default = TD.run_cell("starcoder2-3b", "decode_32k")
    # int8 values (with a bfloat16 scale a head and position) against the
    # bfloat16 cache, both with S over 'model'; 2 KV heads over 16
    # positions do not split, so 'batch_heads' keeps every head
    int8 = recs["seq_model"]["bytes_per_position"]["cache"]
    assert int8 < 0.6 * default["bytes_per_position"]["cache"]
    assert recs["batch_heads"]["bytes_per_position"]["cache"] > int8


def test_layers_override_and_tag(tmp_path):
    rec = TD.run_cell("starcoder2-3b", "train_4k", out_dir=str(tmp_path),
                      layers_override=4, tag="probe")
    assert rec["layers_override"] == 4 and rec["num_layers"] == 4
    assert rec["tag"] == "probe" and rec["opts"] == {}
    path = tmp_path / "starcoder2-3b__train_4k__16x16__float__L4__probe.json"
    assert json.loads(path.read_text())["tag"] == "probe"
    cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=4)
    assert rec["param_counts"] == cfg.param_counts()
    assert _port_specs(rec["param_specs"]) == _ref_train_specs(cfg)


def test_cli_options(tmp_path):
    TD.main(["--arch", "mamba2-1.3b", "--shape", "train_4k", "--ssm-split",
             "--fsdp", "false", "--grads-bf16", "--layers", "2", "--tag",
             "cli", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2-1.3b__train_4k__16x16__float__L2"
                      "__cli.json").read_text())
    assert rec["opts"] == {"fsdp": False, "grads_bf16": True,
                           "ssm_split": True}
    assert rec["fsdp"] is False
    # bfloat16 gradient accumulators: half the float32 params' bytes
    assert 2 * rec["bytes_per_position"]["grads"] == \
        rec["bytes_per_position"]["params"]
