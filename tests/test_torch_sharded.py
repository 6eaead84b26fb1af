"""The port's sharded packed forward (``repro_torch.distributed``,
``launch.mesh``, ``core.binary_layers.localize_conv_plan``) against the
JAX reference on the same weights and inputs, on the CPU.

* The shard plans and per-leaf specs equal the reference's on the same
  trees; the reference's plan functions read only a mesh's axis sizes,
  so they take ``jax.sharding.AbstractMesh`` shapes (one JAX device
  here, no forced count).
* The port's sharded forward on CPU meshes of those shapes: int32 pre-BN
  outputs exactly equal to the reference's unsharded forward
  (``backend="jnp"``), logits within the repo's tolerance, and
  ``torch.equal`` to the port's unsharded forward; gathers only on model
  meshes, and then exactly the packed words of the sharded seams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.core import binary_layers as JL
from repro.distributed import sharding as JSH
from repro.models import cnn as JC
from repro_torch import convert as CV
from repro_torch import telemetry as TTEL
from repro_torch.core import binary_layers as TL
from repro_torch.distributed import sharding as TSH
from repro_torch.distributed import verify_sharded as TV
from repro_torch.launch import mesh as TM
from repro_torch.models import cnn as TC
from repro_torch.tree import leaves_with_path

LOGIT_TOL = dict(rtol=1e-4, atol=1e-3)     # tests/test_paper_equivalence.py
MESHES = ((1, 1), (8, 1), (4, 2), (2, 4), (1, 8))
BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once,
    and the many small tensor ops here would spend their time waiting on
    an oversubscribed thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the smoke presets of ``demo_model`` and the verifier's nets, whose 48-
# and 96-channel stages are not word-divisible at any model degree
NETS = {
    "bcnn-smoke": ("bcnn", JC.demo_model("bcnn", smoke=True)[1]),
    "bmlp-smoke": ("bmlp", JC.demo_model("bmlp", smoke=True)[1]),
    "bcnn-ragged": ("bcnn", JC.BCNNSpec(
        input_hw=(8, 8), c_in=3,
        stages=(JC.ConvStage(128), JC.ConvStage(48, pool=True),
                JC.ConvStage(64, pool=True)), dense=(128, 10))),
    "bmlp-ragged": ("bmlp", JC.BMLPSpec(sizes=TV.BMLP_SIZES)),
}


def _randomize_bn(bns, rng):
    for bn in bns:
        c = bn["gamma"].shape[0]
        sign = np.where(rng.random(c) < 0.3, -1.0, 1.0)
        bn["gamma"] = jnp.asarray(rng.uniform(0.3, 1.5, c) * sign,
                                  jnp.float32)
        bn["beta"] = jnp.asarray(rng.normal(size=c), jnp.float32)
        bn["mean"] = jnp.asarray(rng.normal(size=c) * 3, jnp.float32)
        bn["var"] = jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)


def _build(name):
    kind, spec = NETS[name]
    rng = np.random.default_rng(len(name))
    if kind == "bcnn":
        params = JC.init_bcnn(jax.random.PRNGKey(1), spec)
        _randomize_bn(params["conv_bns"] + params["dense_bns"], rng)
        jp = JC.pack_bcnn(params, spec)
        tp = TC.pack_bcnn(CV.params_to_torch(params), CV.bcnn_spec(spec),
                          device="cpu")
        x = rng.integers(0, 256, (BATCH, *spec.input_hw, spec.c_in),
                         dtype=np.uint8)
        forward = JC.bcnn_forward_packed
    else:
        params = JC.init_bmlp(jax.random.PRNGKey(1), spec)
        _randomize_bn(params["bns"], rng)
        jp = JC.pack_bmlp(params, spec)
        tp = TC.pack_bmlp(CV.params_to_torch(params), CV.bmlp_spec(spec),
                          device="cpu")
        x = rng.integers(0, 256, (BATCH, spec.sizes[0]), dtype=np.uint8)
        forward = JC.bmlp_forward_packed
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JL, "apply_batchnorm", lambda p, z, eps=1e-5: z)
        want_int = np.asarray(forward(jp, jnp.asarray(x), backend="jnp"))
    bn_out = jp["bn_out"]
    want = np.asarray(JL.apply_batchnorm(bn_out, jnp.asarray(want_int)))
    return kind, jp, tp, x, want_int, want


@pytest.fixture(scope="module")
def nets():
    return {name: _build(name) for name in NETS}


def _port_mesh(shape):
    return TM.make_host_mesh(*shape, device="cpu")


def _ref_mesh(shape):
    return AbstractMesh(shape, ("data", "model"))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", sorted(NETS))
def test_plans_and_specs_equal_the_reference(nets, name, shape):
    kind, jp, tp, *_ = nets[name]
    pm, jm = _port_mesh(shape), _ref_mesh(shape)
    plan = (JSH.bcnn_shard_plan if kind == "bcnn" else JSH.bmlp_shard_plan)(
        jp, jm)
    tplan = (TSH.bcnn_shard_plan if kind == "bcnn"
             else TSH.bmlp_shard_plan)(tp, pm)
    assert tplan == plan
    for c in (10, 32, 64, 96, 128, 256, 512, 4096):
        assert TSH.packed_stage_shards(c, pm) == \
            JSH.packed_stage_shards(c, jm)
    jspecs = {k: tuple(v) for k, v in JSH.packed_param_specs(jp, jm).items()}
    assert TSH.packed_param_specs(tp, pm) == jspecs


@pytest.mark.parametrize("n", [1, 2, 4])
def test_localize_conv_plan_equals_the_reference(nets, n):
    _, jp, tp, *_ = nets["bcnn-ragged"]
    for jplan, tplan in zip(jp["convs"], tp["convs"]):
        if jplan["c_out"] % n:
            with pytest.raises(ValueError):
                TL.localize_conv_plan(tplan, n)
            continue
        want = JL.localize_conv_plan(jplan, n)
        got = TL.localize_conv_plan(tplan, n)
        assert {k: v for k, v in got.items()
                if not isinstance(v, torch.Tensor)} == \
            {k: v for k, v in want.items() if not hasattr(v, "shape")}
        assert got["w_packed"] is tplan["w_packed"]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", sorted(NETS))
def test_sharded_forward_equals_the_reference(nets, name, shape):
    kind, _, tp, x, want_int, want = nets[name]
    mesh = _port_mesh(shape)
    fwd = TSH.make_sharded_forward(tp, mesh)
    m = TTEL.default().metrics
    g0, b0 = m.value("sharding.gathers"), m.value("sharding.gathered_bytes")
    got_int = fwd.forward_int(x)
    gathered = (m.value("sharding.gathers") - g0,
                m.value("sharding.gathered_bytes") - b0)
    np.testing.assert_array_equal(got_int.numpy(), want_int)
    got = fwd(x)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    unsharded = (TC.bcnn_forward_packed_int if kind == "bcnn"
                 else TC.bmlp_forward_packed_int)
    assert torch.equal(got_int, unsharded(tp, torch.from_numpy(x)))
    assert torch.equal(got, TC.make_packed_forward(tp)(x))
    assert gathered == TV.expected_gathers(tp, fwd.shard_plan, mesh, BATCH)
    if shape[1] == 1:
        assert gathered == (0, 0)
    assert fwd.batch_multiple == shape[0]


@pytest.mark.parametrize("mode", ["resident", "per_layer"])
def test_sharded_forward_dense_stack_modes(nets, mode):
    """A mesh whose hidden dense layer replicates runs the stack mode it
    is given; one whose layer shards runs it per layer; both equal the
    unsharded forward in that mode."""
    for name in ("bcnn-ragged", "bmlp-smoke"):
        kind, _, tp, x, want_int, _ = nets[name]
        for shape in ((2, 1), (2, 2)):
            fwd = TSH.make_sharded_forward(tp, _port_mesh(shape),
                                           dense_stack=mode)
            np.testing.assert_array_equal(fwd.forward_int(x).numpy(),
                                          want_int)


def test_placement_round_trips_and_shares_slices(nets):
    _, _, tp, *_ = nets["bcnn-ragged"]
    mesh = _port_mesh((2, 4))
    placed = TSH.shard_packed(tp, mesh)
    w = placed["convs"][0]["w_packed"]
    assert isinstance(w, TSH.Placed) and w.spec == ("model",)
    assert w.shards[0] is w.shards[4]          # the same slice, one copy
    assert [s.shape[0] for s in w.shards] == [32] * 8
    corr = placed["convs"][2]["correction"]
    assert corr.spec == () and len({id(s) for s in corr.shards}) == 1
    host = TSH.reshard_packed(placed, None)
    for (pa, a), (pb, b) in zip(leaves_with_path(host),
                                leaves_with_path(tp)):
        assert pa == pb
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    again = TSH.reshard_packed(placed, _port_mesh((1, 2)))
    assert again["convs"][0]["w_packed"].shards[1].shape[0] == 64


def test_sharded_forward_refuses_what_it_cannot_take(nets):
    _, _, tp, x, *_ = nets["bcnn-smoke"]
    fwd = TSH.make_sharded_forward(tp, _port_mesh((4, 1)))
    with pytest.raises(ValueError, match="multiple"):
        fwd(x[:3])
    with pytest.raises(ValueError, match="uint8"):
        fwd(x.astype(np.int32))
    with pytest.raises(ValueError, match="dense_stack"):
        TSH.make_sharded_forward(tp, _port_mesh((1, 1)), dense_stack="x")


def test_host_mesh_is_round_robin_and_needs_a_card_for_cuda(monkeypatch):
    mesh = TM.make_host_mesh(4, 2, device="cpu")
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.coords(5) == {"data": 2, "model": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.make_host_mesh(2, 2)
    with pytest.raises(ValueError):
        TM.make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)


def test_verifier_cells_hold_on_the_cpu():
    cells = TV.run_cells(device="cpu")
    assert [c["ok"] for c in cells] == [True] * len(cells)
    assert len(cells) == 2 * len(TV.MESH_SHAPES) + 2
