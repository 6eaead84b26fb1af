"""The port's packed serving path (``repro_torch.train.serve``,
``repro_torch.runtime.faults``, ``kernels.ops.dispatch_batch``) against
the JAX reference's server on the same weights and inputs.

Every server here runs on the CPU under a ``SimClock``, so the scripts
are deterministic.  What is held:

* the lifecycle exactly: the ``FlushRecord`` batch / bucket / retries
  sequence, the rid → status map and every ``serve.*`` metric of the
  reference, ``serve.route.*`` excepted (the port routes by K4's H100
  rule, the reference by the TPU's);
* served logits within ``LOGIT_TOL`` of the reference's (its jitted,
  bucket-padded float logits may differ from its direct forward by an
  ulp), and exactly equal to the port's own direct forward on the
  unpadded rows;
* the reference's uint8 staging of token ids is a defect the port does
  not copy (``test_lm_token_ids_past_a_byte``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import cnn as JC
from repro.models import transformer as JTF
from repro.runtime import faults as JF
from repro.train import serve as JSV
from repro_torch import convert as CV
from repro_torch import telemetry as TTEL
from repro_torch.kernels import binary_matmul as TBMM
from repro_torch.kernels import ops as TOPS
from repro_torch.models import cnn as TC
from repro_torch.models import transformer as TT
from repro_torch.runtime import faults as TF
from repro_torch.train import serve as TSV

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)     # tests/test_torch_bcnn.py:21
LM_SEQ = 6
KINDS = ("bcnn", "bmlp", "lm")
# the port's dense_stack modes per kind (the LM's names are its own)
MODES = {"bcnn": ("auto", "per_layer"), "bmlp": ("auto", "per_layer"),
         "lm": ("auto", "layered")}


def _randomize_bn(bns, rng):
    """Random BN statistics with both signs of gamma, made with numpy."""
    for bn in bns:
        c = bn["gamma"].shape[0]
        sign = np.where(rng.random(c) < 0.3, -1.0, 1.0)
        bn["gamma"] = jnp.asarray(rng.uniform(0.3, 1.5, c) * sign,
                                  jnp.float32)
        bn["beta"] = jnp.asarray(rng.normal(size=c), jnp.float32)
        bn["mean"] = jnp.asarray(rng.normal(size=c) * 3, jnp.float32)
        bn["var"] = jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)


@dataclasses.dataclass
class Model:
    """One model on both sides: what each server's ``register`` takes, the
    port's packed tree and its input sampler."""
    kind: str
    jax_reg: dict
    torch_reg: dict
    tpacked: dict
    limit: int                  # inputs lie in [0, limit)
    dtype: type

    def inputs(self, n, seed):
        shape = TC.packed_input_shape(self.tpacked)
        return np.random.default_rng(seed).integers(
            0, self.limit, (n, *shape)).astype(self.dtype)


def _lm_pair(cfg, seed):
    params = JTF.init_binary_lm(jax.random.PRNGKey(seed), cfg)
    _randomize_bn([blk["bn1"] for blk in params["blocks"]],
                  np.random.default_rng(seed))
    jp = JTF.pack_transformer(params, cfg, max_len=LM_SEQ)
    tp = TT.pack_transformer(CV.params_to_torch(params), CV.lm_spec(cfg),
                             max_len=LM_SEQ, device="cpu")
    return jp, tp


def _build(kind) -> Model:
    if kind == "lm":
        jp, tp = _lm_pair(get_config("gemma2-9b", reduced=True), 3)
        return Model(kind, {"packed": jp}, {"packed": tp}, tp, 256,
                     np.uint8)
    params, spec, _ = JC.demo_model(kind, smoke=True)
    rng = np.random.default_rng(1)
    _randomize_bn(params["conv_bns"] + params["dense_bns"]
                  if kind == "bcnn" else params["bns"], rng)
    tspec = CV.bcnn_spec(spec) if kind == "bcnn" else CV.bmlp_spec(spec)
    tparams = CV.params_to_torch(params)
    tp = (TC.pack_bcnn if kind == "bcnn" else TC.pack_bmlp)(
        tparams, tspec, device="cpu")
    return Model(kind, {"params": params, "spec": spec, "kind": kind},
                 {"params": tparams, "spec": tspec, "kind": kind}, tp, 256,
                 np.uint8)


@pytest.fixture(scope="module")
def models():
    return {k: _build(k) for k in KINDS}


def _servers(model, **kw):
    """The reference's server (backend 'jnp') and the port's (CPU), each
    on its own SimClock with ``model`` registered under 'm': [(server,
    clock)] for the reference, then the port."""
    out = []
    for sv, reg, extra in ((JSV, model.jax_reg, {"backend": "jnp"}),
                           (TSV, model.torch_reg, {})):
        clock = sv.SimClock()
        srv = sv.PackedInferenceServer(
            clock=clock, **kw, **({"device": "cpu"} if sv is TSV else {}))
        srv.register("m", **reg, **extra)
        out.append((srv, clock))
    return out


def _serve_metrics(srv):
    return {k: v for k, v in srv.telemetry.metrics.snapshot().items()
            if k.startswith("serve.") and not k.startswith("serve.route.")}


def _lifecycle(srv):
    return ([(f.batch, f.bucket, f.retries) for f in srv.flushes],
            {r.rid: r.status for r in srv.served})


def _assert_same_lifecycle(jsrv, tsrv, model):
    """Flush sequence, statuses and serve.* metrics equal; every ok row
    equal to the port's direct forward exactly and within LOGIT_TOL of the
    reference's served row.  The LM's two direct forwards may differ in a
    whole row where an attention bit flips near 0 (the LM parity contract
    of tests/test_torch_lm.py, held stage by stage there): such a row is
    held to each framework's own direct forward instead, so serving adds
    no difference of its own."""
    assert _lifecycle(tsrv) == _lifecycle(jsrv)
    assert _serve_metrics(tsrv) == _serve_metrics(jsrv)
    fwd = TC.make_packed_forward(model.tpacked)
    for jr, tr in zip(jsrv.served, tsrv.served):
        assert (jr.rid, jr.status) == (tr.rid, tr.status)
        if jr.status != "ok":
            assert tr.result is None
            assert type(tr.error).__name__ == type(jr.error).__name__
            continue
        assert isinstance(tr.result, torch.Tensor)
        direct = fwd(tr.x[None])[0]
        assert torch.equal(tr.result, direct)
        want = np.asarray(jr.result)
        if model.kind == "lm":
            jdirect = np.asarray(JTF.transformer_forward_packed(
                model.jax_reg["packed"], jnp.asarray(jr.x[None]),
                backend="jnp"))[0]
            np.testing.assert_allclose(want, jdirect, **LOGIT_TOL)
            if not np.allclose(direct.numpy(), jdirect, **LOGIT_TOL):
                continue
        np.testing.assert_allclose(tr.result.numpy(), want, **LOGIT_TOL)


# ---------------------------------------------------------------------------
# (a) the queue lifecycle, script for script against the reference
# ---------------------------------------------------------------------------

def _script(srv, clock, xs, other):
    """Deadline flush, full windows, cancel, backpressure, zero-deadline
    singles, timeouts, serve(), take(), a model swap and back, and an
    invalidation.  Returns the rids that raised backpressure."""
    srv.submit(xs[0], deadline=0.010)
    clock.advance(0.004)
    srv.submit(xs[1], deadline=0.010)
    srv.submit(xs[2], deadline=0.050)
    assert srv.step() == []                   # nothing due yet
    clock.advance(0.008)
    assert [r.rid for r in srv.step()] == [0, 1, 2]
    rids = [srv.submit(x) for x in xs[3:14]]  # 11 queued: max_queue
    assert srv.cancel(rids[4]) and not srv.cancel(rids[4])
    srv.submit(xs[14])
    shed = 0
    try:
        srv.submit(xs[15])                     # the queue is full again
    except RuntimeError as e:
        assert type(e).__name__ == "BackpressureError"
        shed += 1
    srv.step()                                 # one full window of 8
    clock.advance(0.011)
    srv.step()                                 # the tail of 3
    for x in xs[15:18]:                        # flush-me-now singles
        srv.submit(x, deadline=0.0)
        srv.step()
    late = [srv.submit(x, deadline=0.002) for x in xs[18:21]]
    clock.advance(0.010)                       # past grace 2 x 2 ms
    done = {r.rid: r.status for r in srv.step()}
    assert [done[r] for r in late] == ["timeout"] * 3
    mine = srv.submit(xs[21])
    rows = srv.serve(list(xs[22:27]))          # drains `mine` too
    assert len(rows) == 5 and srv.take(mine).rid == mine
    assert srv.take(mine) is None
    srv.register("other", **other)
    srv.submit(xs[27])
    assert len(srv.use("other")) == 1          # force-flushed first
    srv.use("m")
    srv.register("m")                          # known key: a cache hit
    assert srv.cache.hits == 1
    srv.submit(xs[28])
    assert len(srv.invalidate("m")) == 1 and srv.active is None
    return shed


@pytest.mark.parametrize("kind", KINDS)
def test_lifecycle_matches_reference(models, kind):
    model = models[kind]
    other = models["bmlp" if kind != "bmlp" else "bcnn"]
    xs = model.inputs(29, seed=2)
    (jsrv, jclock), (tsrv, tclock) = _servers(
        model, max_batch=8, default_deadline=0.010, max_queue=11,
        timeout_grace=2.0)
    assert _script(jsrv, jclock, xs, {**other.jax_reg, "backend": "jnp"}) \
        == _script(tsrv, tclock, xs, other.torch_reg) == 1
    _assert_same_lifecycle(jsrv, tsrv, model)
    assert [f.batch for f in tsrv.flushes] == [3, 8, 3, 1, 1, 1, 6, 1, 1]


# ---------------------------------------------------------------------------
# (b) served rows == the port's direct forward on the unpadded rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 8, 9, 12])
@pytest.mark.parametrize("kind,mode", [(k, m) for k in KINDS
                                       for m in MODES[k]])
def test_served_rows_equal_direct_forward(models, kind, mode, n):
    """One cohort of ``n`` after a full flush of the same bucket, so the
    reused staging buffer held real rows past ``n``: the served rows equal
    the direct forward on the ``n`` rows exactly, and the tail is zeros."""
    model = models[kind]
    srv = TSV.PackedInferenceServer(max_batch=16, clock=TSV.SimClock(),
                                    device="cpu")
    srv.register("m", packed=model.tpacked, dense_stack=mode)
    eng = srv.engine()
    bucket = srv._bucket_for(eng, n)
    warm = model.inputs(bucket, seed=100 + n)
    srv.serve(list(warm))
    xs = model.inputs(n, seed=n)
    rids = [srv.submit(x) for x in xs]
    done = {r.rid: r for r in srv.flush()}
    got = torch.stack([done[r].result for r in rids])
    want = TC.make_packed_forward(model.tpacked, dense_stack=mode)(xs)
    assert torch.equal(got, want)
    assert [(f.batch, f.bucket) for f in srv.flushes] == \
        [(bucket, bucket), (n, bucket)]
    buf = srv.pool.batch_buffer(bucket, eng.example_shape, eng.input_dtype)
    assert srv.pool.allocations == 1
    assert torch.equal(buf[:n], torch.from_numpy(xs).to(eng.input_dtype))
    assert not buf[n:].any()


# ---------------------------------------------------------------------------
# (c) the fault seam: every fault kind against the reference's server
# ---------------------------------------------------------------------------

# case -> (the reference's fault specs, retries, timeout grace, requests;
# None for the slow script)
FAULT_CASES = {
    "transient": ((JF.FaultSpec("transient", times=2),), 2, None, 8),
    "transient_beyond_budget": ((JF.FaultSpec("transient", times=99),), 1,
                                None, 1),
    "persistent": ((JF.FaultSpec("persistent"),), 2, None, 4),
    "poison": ((JF.FaultSpec("poison", rid=3),), 2, None, 8),
    "slow": ((JF.FaultSpec("slow", delay_s=1.0),), 2, 2.0, None),
    "device_loss": ((JF.FaultSpec("device_loss", survivors=1),), 2, None,
                    8),
    "device_loss_in_bisection": (
        (JF.FaultSpec("poison", rid=1),
         JF.FaultSpec("device_loss", survivors=1, at_dispatch=2)), 0, None,
        4),
}


def _drive_faults(srv, clock, xs, n):
    """Submit ``n`` requests and step past their deadline (``n`` None: the
    slow script — 4 requests whose flush jumps the clock by 1 s, then 4
    that age behind it past their grace); a DeviceLossError is caught
    once, the queue read, and the server stepped again.  Returns the
    rids, the requeued rids (or None) and the statuses of a clean wave
    served after the fault."""
    requeued = None
    if n is None:
        rids = [srv.submit(x) for x in xs[:4]]
        clock.advance(0.006)
        srv.step()                             # the 1 s jump inside
        rids += [srv.submit(x) for x in xs[4:8]]
        clock.advance(0.100)
    else:
        rids = [srv.submit(x) for x in xs[:n]]
        clock.advance(1.0)
    try:
        srv.step()
    except RuntimeError as e:
        assert type(e).__name__ == "DeviceLossError" and e.survivors == 1
        requeued = [r.rid for r in srv._queue]
        srv.step()
    assert srv.pending() == 0
    srv.flush_hook = None                      # the server keeps serving
    after = [srv.submit(x) for x in xs[:4]]
    clock.advance(0.006)
    done = {r.rid: r.status for r in srv.step()}
    return rids, requeued, [done[r] for r in after]


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_fault_kind_matches_reference(models, case):
    """The same FaultPlan through both servers: the same dispatches and
    injected faults, terminal states, retries, bisections and metrics; a
    device loss requeues every rid of the window in FIFO order, also from
    inside a bisection; the server serves a clean wave afterwards."""
    specs, retries, grace, n = FAULT_CASES[case]
    model = models["bmlp"]
    xs = model.inputs(8, seed=4)
    runs = []
    for (srv, clock), sv, faults in zip(
            _servers(model, max_batch=8, default_deadline=0.005,
                     timeout_grace=grace), (JSV, TSV), (JF, TF)):
        srv.retry = sv.RetryPolicy(max_retries=retries)
        plan = faults.FaultPlan.of(*(faults.FaultSpec(**dataclasses.asdict(
            s)) for s in specs))
        inj = faults.FaultInjector(plan).attach(srv)
        runs.append((srv, inj, _drive_faults(srv, clock, xs, n)))
    (jsrv, jinj, jres), (tsrv, tinj, tres) = runs
    assert tres == jres
    rids, requeued, after = tres
    assert after == ["ok"] * 4
    assert (requeued is not None) == case.startswith("device_loss")
    if requeued is not None:                   # no rid lost, FIFO order
        assert requeued == rids
    assert tinj.injected == jinj.injected and tinj.injected
    assert tinj.dispatches == jinj.dispatches
    _assert_same_lifecycle(jsrv, tsrv, model)
    for kind in TF.FAULT_KINDS:
        name = f"faults.injected.{kind}"
        assert tsrv.telemetry.metrics.value(name) == \
            jsrv.telemetry.metrics.value(name)


def test_every_fault_kind_is_covered():
    kinds = {s.kind for specs, *_ in FAULT_CASES.values() for s in specs}
    assert kinds == set(TF.FAULT_KINDS) == set(JF.FAULT_KINDS)


# ---------------------------------------------------------------------------
# (d) token ids past a byte: the reference's uint8 staging defect
# ---------------------------------------------------------------------------

def test_lm_token_ids_past_a_byte():
    """An LM with a 1000-token vocab: the port stages ids in int32 and
    serves them as the direct forward does; the reference stages them in
    uint8 (``src/repro/train/serve.py:225``, ``:736–738``) and serves
    ``id % 256``."""
    cfg = dataclasses.replace(get_config("gemma2-9b", reduced=True),
                              vocab_size=1000)
    jp, tp = _lm_pair(cfg, 5)
    tokens = np.random.default_rng(0).integers(256, 1000, (5, LM_SEQ),
                                               dtype=np.int32)
    srv = TSV.PackedInferenceServer(max_batch=8, clock=TSV.SimClock(),
                                    device="cpu")
    srv.register("lm", packed=tp)
    assert srv.engine().input_dtype == torch.int32
    got = torch.stack(srv.serve(list(tokens)))
    assert torch.equal(got, TC.make_packed_forward(tp)(tokens))
    for dtype in (np.uint16, np.uint32, np.int64):   # any integer type
        assert torch.equal(torch.stack(srv.serve(list(tokens.astype(
            dtype)))), got)
    jsrv = JSV.PackedInferenceServer(max_batch=8, clock=JSV.SimClock())
    jsrv.register("lm", packed=jp, backend="jnp")
    jgot = np.stack(jsrv.serve(list(tokens)))
    np.testing.assert_array_equal(jgot, np.asarray(
        JTF.transformer_forward_packed(jp, jnp.asarray(tokens % 256),
                                       backend="jnp")))
    assert not np.array_equal(jgot, np.asarray(
        JTF.transformer_forward_packed(jp, jnp.asarray(tokens),
                                       backend="jnp")))


@pytest.mark.parametrize("bad", ["id_past_vocab", "negative", "float",
                                 "shape", "uint64_past_int64"])
def test_submit_refuses_what_staging_would_change(bad):
    cfg = dataclasses.replace(get_config("gemma2-9b", reduced=True),
                              vocab_size=300, num_layers=1)
    _, tp = _lm_pair(cfg, 6)
    x = np.full((LM_SEQ,), 299, np.int64)
    x = {"id_past_vocab": x + 1, "negative": -x,
         "float": x.astype(np.float32), "shape": x[:-1],
         "uint64_past_int64": np.full((LM_SEQ,), 2**63 + 5, np.uint64)}[bad]
    srv = TSV.PackedInferenceServer(max_batch=4, clock=TSV.SimClock(),
                                    device="cpu")
    srv.register("lm", packed=tp)
    srv.submit(np.full((LM_SEQ,), 299, np.int64))      # the edge is fine
    with pytest.raises(ValueError):
        srv.submit(x)
    with pytest.raises(ValueError):
        srv.serve([np.zeros((LM_SEQ,), np.int64), x])  # all or nothing
    assert srv.pending() == 1
    assert srv.telemetry.metrics.value("serve.submitted") == 1


# ---------------------------------------------------------------------------
# (e) the route rule: K4's, not the TPU's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,sms", [(10, 132), (4096, 132), (256000, 1),
                                   (33, 16)])
def test_dispatch_batch_is_k4s_route(n, sms):
    prev = TTEL.set_default(TTEL.Telemetry())
    try:
        ms = range(1, 2 * TBMM.SMALL_M_MAX + 3)
        for m in ms:
            for kw in (1, 25, 4097, 8000):
                assert (TOPS.dispatch_batch(m, kw) == "gemv") == \
                    (TBMM.gemm_route(m, n, sms) == TBMM.ROUTE_SMALL)
        reg = TTEL.default().metrics
        assert reg.value("ops.dispatch.gemv") == 4 * TBMM.SMALL_M_MAX
        assert reg.value("ops.dispatch.gemm") == 4 * (len(ms) -
                                                      TBMM.SMALL_M_MAX)
    finally:
        TTEL.set_default(prev)
    for m, kw in ((0, 1), (1, 0), (-1, 5)):
        with pytest.raises(ValueError):
            TOPS.dispatch_batch(m, kw)


def test_route_for_and_flush_routes_follow_dispatch_batch(models):
    model = models["bmlp"]
    srv = TSV.PackedInferenceServer(max_batch=32, clock=TSV.SimClock(),
                                    device="cpu")
    with pytest.raises(RuntimeError, match="no model"):
        srv.route_for(1)
    srv.register("m", **model.torch_reg)
    eng = srv.engine()
    for b in range(1, 33):
        bucket = srv._bucket_for(eng, b)
        assert srv.route_for(b) == TOPS.dispatch_batch(bucket, eng.kw_words)
        assert (srv.route_for(b) == "gemv") == (bucket <= TBMM.SMALL_M_MAX)
    for n in (3, 8, 9, 32):
        srv.serve(list(model.inputs(n, seed=n)))
    assert [(f.bucket, f.route) for f in srv.flushes] == [
        (4, "gemv"), (8, "gemv"), (16, "gemm"), (32, "gemm")]
    m = srv.telemetry.metrics
    assert (m.value("serve.route.gemv"), m.value("serve.route.gemm")) == \
        (2, 2)


# ---------------------------------------------------------------------------
# Registration and the device
# ---------------------------------------------------------------------------

def test_server_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSV.PackedInferenceServer()


def test_register_validation(models):
    model = models["bmlp"]
    srv = TSV.PackedInferenceServer(clock=TSV.SimClock(), device="cpu")
    with pytest.raises(ValueError, match="kind"):
        srv.register("m", model.torch_reg["params"],
                     model.torch_reg["spec"], kind="mlp")
    with pytest.raises(RuntimeError, match="no model"):
        srv.submit(np.zeros((784,), np.uint8))
    with pytest.raises(TypeError, match="Mesh"):
        srv.register("m", **model.torch_reg, mesh=(2, 2))
    with pytest.raises(ValueError, match="dense_stack"):
        srv.register("m", **model.torch_reg, dense_stack="bogus")
    srv.register("m", **model.torch_reg)
    with pytest.raises(KeyError):
        srv.use("nope")
    other = TC.to_device(model.tpacked, "meta")   # another device
    with pytest.raises(ValueError, match="server on cpu"):
        srv.register("meta", packed=other)


def test_rebuild_engine_serves_the_queue(models):
    """The recovery seam after a device loss: rebuild from the packed tree
    without flushing; the queued requests are served by the new engine."""
    model = models["bcnn"]
    srv = TSV.PackedInferenceServer(max_batch=8, clock=TSV.SimClock(),
                                    device="cpu")
    srv.register("m", **model.torch_reg)
    old = srv.engine()
    xs = model.inputs(3, seed=9)
    rids = [srv.submit(x) for x in xs]
    srv.rebuild_engine("m", packed=model.tpacked, dense_stack="per_layer")
    assert srv.engine() is not old and srv.pending() == 3
    done = {r.rid: r for r in srv.flush()}
    assert torch.equal(torch.stack([done[r].result for r in rids]),
                       TC.make_packed_forward(model.tpacked)(xs))
    assert srv.telemetry.metrics.value("serve.cache.invalidations") == 1


def test_demo_model_has_the_reference_shapes():
    for kind in ("bcnn", "bmlp"):
        for smoke in (True, False):
            jparams, jspec, jkind = JC.demo_model(kind, smoke=smoke)
            params, spec, got = TC.demo_model(kind, smoke=smoke)
            assert got == jkind == kind
            assert spec == (CV.bcnn_spec(jspec) if kind == "bcnn"
                            else CV.bmlp_spec(jspec))
            shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                            jparams)
            assert jax.tree_util.tree_map(
                lambda t: tuple(t.shape), params,
                is_leaf=lambda t: isinstance(t, torch.Tensor)) == shapes
    with pytest.raises(ValueError, match="kind"):
        TC.demo_model("lm")


def test_latency_percentile_and_sim_clock_match_reference():
    vals = sorted(np.random.default_rng(0).random(37).tolist())
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert TSV.latency_percentile(vals, q) == \
            JSV.latency_percentile(vals, q)
    for bad in ((vals, 1.5), (vals, -0.1), ([], 0.5)):
        with pytest.raises(ValueError):
            TSV.latency_percentile(*bad)
    clock = TSV.SimClock(1.0)
    assert clock.advance(0.5) == clock() == 1.5
    policy, ref = TSV.RetryPolicy(), JSV.RetryPolicy()
    assert [policy.backoff(k) for k in range(1, 12)] == \
        [ref.backoff(k) for k in range(1, 12)]
    assert TSV.TERMINAL_STATES == JSV.TERMINAL_STATES


def test_cli_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve as cli
    cli.main(["--model", "bmlp", "--smoke", "--device", "cpu",
              "--requests", "5", "--max-batch", "4", "--deadline-ms", "1",
              "--metrics"])
    out = capsys.readouterr().out
    assert "registered bmlp on cpu" in out and "served 5 requests" in out
    assert "latency p50=" in out and "weight cache: 1 pack(s)" in out
    assert '"serve.completed"' in out
