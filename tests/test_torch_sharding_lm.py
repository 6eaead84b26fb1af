"""The LM half of the port's sharding rules (``repro_torch.distributed.
sharding``) and ``ArchConfig.param_counts`` against the JAX reference,
on the CPU.

The reference's spec functions read only a mesh's axis sizes and the
leaves' shapes, so they run on ``jax.sharding.AbstractMesh`` shapes and
``jax.eval_shape`` trees; the port's on its own meshes (``device="cpu"``
positions, or the production mesh's meta positions) and trees of meta
tensors of the same shapes (``common.MetaGenerator``).  Specs are equal
path for path, as tuples; ``should_fsdp`` is compared at the reference's
16e9 bytes, the figure both packages are given.
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config, list_configs
from repro.distributed import sharding as JSH
from repro.models import linear as JLN
from repro.models import model as JM
from repro_torch import convert as CV
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as TMESH
from repro_torch.models import common as TCOM
from repro_torch.models import linear as TLN
from repro_torch.models import model as TM
from repro_torch.tree import leaves_with_path

NAMES = list_configs()
MESHES = ((2, 2), (4, 1), (1, 4))
VARIANTS = {"fsdp": dict(fsdp=True), "zero0": dict(fsdp=False),
            "replicate_embed": dict(fsdp=True, replicate_embed=True)}


def _ref_mesh(shape, axes=("data", "model")):
    return AbstractMesh(shape, axes)


def _port_mesh(shape):
    return TMESH.make_host_mesh(*shape, device="cpu")


def _ref_specs(specs_tree, like):
    """{path: tuple} of a reference spec tree laid over ``like``."""
    flat = jtu.tree_flatten_with_path(like)[0]
    specs = jtu.tree_leaves(specs_tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert len(flat) == len(specs)
    return {JSH._path_str(p): tuple(s) for (p, _), s in zip(flat, specs)}


def _cfgs(name, reduced=True, quant=None):
    cfg = get_config(name, quant=quant, reduced=reduced)
    return cfg, CV.arch_config(cfg)


def _shapes(cfg, tcfg, packed=False):
    """The reference's params shapes (eval_shape) and the port's meta
    tree."""
    def mk():
        p = JM.init_model(jax.random.PRNGKey(0), cfg)
        return JLN.maybe_pack_tree(p, cfg.quant) if packed else p
    jp = jax.eval_shape(mk)
    tp = TM.init_model(TCOM.MetaGenerator(), tcfg, device="meta")
    if packed:
        tp = TLN.maybe_pack_tree(tp, tcfg.quant, device="meta")
    return jp, tp


@pytest.fixture(scope="module")
def reduced_shapes():
    return {n: _shapes(*_cfgs(n)) for n in NAMES}


def _same_shapes(jp, tp):
    want = {JSH._path_str(p): tuple(a.shape)
            for p, a in jtu.tree_flatten_with_path(jp)[0]}
    got = {p: tuple(t.shape) for p, t in leaves_with_path(tp)}
    assert got == want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_equal_the_reference(reduced_shapes, name, shape,
                                         variant):
    jp, tp = reduced_shapes[name]
    _same_shapes(jp, tp)
    kw = VARIANTS[variant]
    want = _ref_specs(JSH.param_specs(jp, _ref_mesh(shape), **kw), jp)
    assert TSH.param_specs(tp, _port_mesh(shape), **kw) == want


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("name", ["whisper-base", "gemma2-9b"])
def test_param_specs_full_size_16x16(name, fsdp):
    """Published widths on the production mesh; whisper-base's vocab
    (51865) does not divide 16, so its table's vocab dim falls back to
    replication where the reference's does."""
    cfg, tcfg = _cfgs(name, reduced=False)
    jp, tp = _shapes(cfg, tcfg)
    _same_shapes(jp, tp)
    want = _ref_specs(JSH.param_specs(jp, _ref_mesh((16, 16)), fsdp=fsdp),
                      jp)
    got = TSH.param_specs(tp, TMESH.make_production_mesh(), fsdp=fsdp)
    assert got == want
    if name == "whisper-base":
        assert got["embed/table"][0] is None


@pytest.mark.parametrize("name", ["gemma2-9b", "starcoder2-3b"])
def test_packed_param_specs_equal_the_reference(name):
    """The packed inference tree's ``w_packed`` / ``alpha`` rules."""
    cfg, tcfg = _cfgs(name, quant="binary")
    jp, tp = _shapes(cfg, tcfg, packed=True)
    _same_shapes(jp, tp)
    for shape in MESHES:
        want = _ref_specs(JSH.param_specs(jp, _ref_mesh(shape)), jp)
        assert TSH.param_specs(tp, _port_mesh(shape)) == want


def _batch(name, b, s):
    cfg = get_config(name, reduced=True)
    jb = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
          "labels": jax.ShapeDtypeStruct((b, s), jnp.int32),
          "embeds": jax.ShapeDtypeStruct((b, s, cfg.d_model), jnp.bfloat16),
          "scalar": jax.ShapeDtypeStruct((), jnp.int32)}
    tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
    return jb, tb


@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("b", [1, 4, 6])
@pytest.mark.parametrize("shape", MESHES + ((16, 16),))
def test_batch_specs_equal_the_reference(shape, b, shard_seq):
    jb, tb = _batch("starcoder2-3b", b, 32)
    pm = (TMESH.make_production_mesh() if shape == (16, 16)
          else _port_mesh(shape))
    want = _ref_specs(JSH.batch_specs(jb, _ref_mesh(shape),
                                      shard_seq=shard_seq), jb)
    assert TSH.batch_specs(tb, pm, shard_seq=shard_seq) == want


def test_multi_pod_batch_and_activation_specs():
    """(pod, data) together, and the partial fallbacks to one of them."""
    jm = _ref_mesh((2, 16, 16), ("pod", "data", "model"))
    pm = TMESH.make_production_mesh(multi_pod=True)
    for b in (1, 2, 16, 32, 48):
        jb, tb = _batch("starcoder2-3b", b, 64)
        for seq in (False, True):
            want = _ref_specs(JSH.batch_specs(jb, jm, shard_seq=seq), jb)
            assert TSH.batch_specs(tb, pm, shard_seq=seq) == want
    for nd in (2, 3, 4):
        for seq in (False, True):
            assert TSH.logical_activation_spec(pm, nd, shard_seq=seq) == \
                tuple(JSH.logical_activation_spec(jm, nd, shard_seq=seq))


@pytest.mark.parametrize("shape", MESHES + ((16, 16),))
def test_logical_activation_spec_equals_the_reference(shape):
    pm = (TMESH.make_production_mesh() if shape == (16, 16)
          else _port_mesh(shape))
    for nd in (2, 3, 4):
        for seq in (False, True):
            assert TSH.logical_activation_spec(pm, nd, shard_seq=seq) == \
                tuple(JSH.logical_activation_spec(_ref_mesh(shape), nd,
                                                  shard_seq=seq))


def _caches(name, b, s, kv_int8=False):
    cfg, tcfg = _cfgs(name)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    jp = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), cfg))
    jc = jax.eval_shape(lambda: JM.init_cache(
        jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jp), cfg, b, s))
    tp = TM.init_model(TCOM.MetaGenerator(), tcfg, device="meta")
    tc = TM.init_cache(tp, tcfg, b, s)
    return jc, tc


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_equal_the_reference(name, b):
    jc, tc = _caches(name, b, 32)
    _same_shapes(jc, tc)
    for shape in MESHES + ((16, 16),):
        pm = (TMESH.make_production_mesh() if shape == (16, 16)
              else _port_mesh(shape))
        for layout in ("batch_heads", "seq_model"):
            for seq in (False, True):
                want = _ref_specs(JSH.cache_specs(
                    jc, _ref_mesh(shape), shard_seq=seq, kv_layout=layout),
                    jc)
                got = TSH.cache_specs(tc, pm, shard_seq=seq,
                                      kv_layout=layout)
                assert got == want, (shape, layout, seq)


def test_cache_specs_int8_scales_equal_the_reference():
    jc, tc = _caches("gemma2-9b", 4, 32, kv_int8=True)
    _same_shapes(jc, tc)
    assert any(p.endswith("k_scale") for p, _ in leaves_with_path(tc))
    for shape in MESHES:
        for layout in ("batch_heads", "seq_model"):
            for seq in (False, True):
                want = _ref_specs(JSH.cache_specs(
                    jc, _ref_mesh(shape), shard_seq=seq, kv_layout=layout),
                    jc)
                assert TSH.cache_specs(tc, _port_mesh(shape), shard_seq=seq,
                                       kv_layout=layout) == want


@pytest.mark.parametrize("name", NAMES)
def test_should_fsdp_equals_the_reference_at_16e9(name):
    for reduced in (False, True):
        cfg, tcfg = _cfgs(name, reduced=reduced)
        for shape in MESHES + ((1, 1), (16, 16)):
            pm = (TMESH.make_production_mesh() if shape == (16, 16)
                  else _port_mesh(shape))
            for budget in (0.6, 0.1):
                assert TSH.should_fsdp(tcfg, pm, hbm_bytes=16e9,
                                       budget=budget) == \
                    JSH.should_fsdp(cfg, _ref_mesh(shape), hbm_bytes=16e9,
                                    budget=budget)


def test_should_fsdp_defaults_to_the_card():
    """The port's default is the H100's 80 GB: starcoder2-3b on (2, 2)
    keeps FSDP at the reference's 16e9 and drops it at 80e9; on (4, 1)
    it keeps it at both."""
    cfg, tcfg = _cfgs("starcoder2-3b", reduced=False)
    assert TSH.HBM_BYTES == 80e9
    assert JSH.should_fsdp(cfg, _ref_mesh((2, 2))) is True
    assert TSH.should_fsdp(tcfg, _port_mesh((2, 2))) is False
    assert TSH.should_fsdp(tcfg, _port_mesh((2, 2)), hbm_bytes=16e9) is True
    assert JSH.should_fsdp(cfg, _ref_mesh((4, 1))) is True
    assert TSH.should_fsdp(tcfg, _port_mesh((4, 1))) is True


def test_drop_fsdp_equals_the_reference():
    for spec in [("data", "model"), ("model", "data"), (None, "data"),
                 ("model", "data", None), (None,), (), ("pod", "data"),
                 (("pod", "data"), None)]:
        assert TSH.drop_fsdp(spec) == JSH.drop_fsdp(spec)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_param_counts_equal_the_reference(name, reduced):
    cfg, tcfg = _cfgs(name, reduced=reduced)
    assert tcfg.param_counts() == cfg.param_counts()
    for k, v in cfg.param_counts().items():
        assert type(tcfg.param_counts()[k]) is type(v), k


def test_param_counts_published_totals():
    got = {n: _cfgs(n, reduced=False)[1].param_counts()
           for n in ("starcoder2-3b", "gemma2-9b",
                     "llama4-maverick-400b-a17b")}
    assert round(got["starcoder2-3b"]["total"] / 1e9, 2) == 3.18
    assert round(got["gemma2-9b"]["total"] / 1e9, 3) == 9.241
    assert round(got["llama4-maverick-400b-a17b"]["total"] / 1e11, 3) == \
        7.843
    assert round(got["llama4-maverick-400b-a17b"]["active"] / 1e10, 2) == \
        1.72


def test_quant_config_fields_cross():
    for mode in ("float", "binary_weight", "binary"):
        cfg = get_config("starcoder2-3b", quant=mode)
        tq = CV.arch_config(cfg).quant
        assert (tq.mode.value, tq.binarize_embeddings,
                tq.binarize_lm_head) == (mode, False, False)
        for name in ("binarize_embeddings", "binarize_lm_head"):
            q = dataclasses.replace(cfg.quant, **{name: True})
            with pytest.raises(ValueError, match=name):
                CV.arch_config(dataclasses.replace(cfg, quant=q))
            with pytest.raises(ValueError, match=name):
                dataclasses.replace(tq, **{name: True})
