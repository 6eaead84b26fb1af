"""The paper's evaluation networks (§6.2, §6.3) on PyTorch.

* ``bmlp``: BinaryNet MLP for MNIST (Courbariaux et al. 2016 §2.1):
  784 -> 3 x [4096 dense, BN, sign] -> 10 dense, BN.
* ``bcnn``: BinaryNet CNN for CIFAR-10 (Hubara et al. 2016 §2.3):
  2x128C3-MP2-2x256C3-MP2-2x512C3-MP2-2x1024FC-10FC, BN + sign after
  every conv/dense.

Each network has:

  init_*(gen, spec)           -> latent float weights + BN
  *_forward_float(...)        -> the float-sign reference forward
  pack_*(params, spec)        -> one-time packed inference params (C2)
  *_forward_packed(...)       -> the packed forward through the kernels

The packed forward equals the float one exactly on the integer dots and
to float round-off on the final BN logits.

Layer spans: the packed forwards open the reference's ``model.bcnn.*`` /
``model.bmlp.*`` spans, plus ``model.input`` around the input's check
and copy, on ``telemetry.default()``'s tracer, once per forward at run
time (the reference opens them once per trace).  While a
``torch.profiler`` session records they are ``record_function`` ranges
on the kernels' clock; with neither, each costs the tracer's no-op.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import telemetry
from repro_torch.core import binarize as B
from repro_torch.core import binary_layers as L


# ---------------------------------------------------------------------------
# Shared by both networks
# ---------------------------------------------------------------------------

def to_device(tree, device):
    """A copy of a tree of tensors (dicts/lists) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return device


# The layer spans that ``ShardedForward`` opens too (see the module
# docstring); ``model.input`` is the port's own.
SPAN_INPUT = "model.input"
SPAN_OUTPUT = {"bcnn": "model.bcnn.output", "bmlp": "model.bmlp.output"}


def _tracer():
    return telemetry.default().tracer


def check_dense_stack(dense_stack: str) -> None:
    if dense_stack not in ("auto", "resident", "per_layer"):
        raise ValueError(f"unknown dense_stack mode {dense_stack!r}")


# ---------------------------------------------------------------------------
# Positions: one stage loop for the unsharded and the sharded forward
# ---------------------------------------------------------------------------
#
# A forward runs on a list of positions, each with its own packed tree and
# activation on its own device: one position for the unsharded forward,
# one per mesh position for the sharded one
# (``distributed.sharding.make_sharded_forward``).  A stage whose C_out is
# split ``shards`` > 1 ways over the 'model' axis runs on each position's
# local output channels, so each position emits its own span of packed
# words; ``peers[i]`` lists, in model order, the positions whose spans
# position ``i`` gathers before the next stage contracts over all
# channels.

def _gather_packed(hs: list, peers: list) -> list:
    """Reassemble C_out-sharded PACKED activations along their word axis.

    Each position concatenates its peers' word spans, in model order, on
    its own device: the exact unsharded word layout.  This is the ONLY
    traffic between positions in the packed forward, and it moves 1-bit
    words, never an int32 activation.  Every gather site adds one to
    ``sharding.gathers`` and the bytes the positions receive from their
    peers to ``sharding.gathered_bytes`` on the process-wide registry
    (``telemetry.default()``), per call: the reference counts each gather
    site once per trace, since its compiled forward re-runs untraced.
    """
    tel = telemetry.default()
    with tel.span("sharding.gather", positions=len(hs)):
        out = [torch.cat([hs[j].to(h.device) for j in peers[i]], dim=-1)
               for i, h in enumerate(hs)]
    received = sum(hs[j].numel() * hs[j].element_size()
                   for i in range(len(hs)) for j in peers[i] if j != i)
    tel.metrics.counter("sharding.gathers").inc()
    tel.metrics.counter("sharding.gathered_bytes").inc(received)
    return out


def _seam(hs: list, peers: list, shards: int) -> list:
    """A stage's output: gathered where the stage was C_out-sharded."""
    return _gather_packed(hs, peers) if shards > 1 else hs


def _dense_hidden_stack(layers: list, foldeds: list, hs: list, peers: list,
                        shards: tuple, *, backend: str,
                        dense_stack: str) -> list:
    """The hidden dense stack shared by both networks, packed in / packed
    out; ``layers[p]`` / ``foldeds[p]`` are position ``p``'s.  A stack no
    layer of which is sharded is one launch (K6) where its weights fit
    the H100 residency rule (``'auto'``; ``'resident'`` forces it), one
    fused GEMM + BN-sign + re-bitpack launch per layer otherwise
    (``'per_layer'`` forces that).  Sharded layers always run per layer
    on their local rows, each followed by its gather."""
    check_dense_stack(dense_stack)
    if all(s == 1 for s in shards):
        resident = {"auto": None, "resident": True,
                    "per_layer": False}[dense_stack]
        return [L.apply_binary_dense_stack_packed(ls, fs, h, backend=backend,
                                                  resident=resident)
                for ls, fs, h in zip(layers, foldeds, hs)]
    for i, s in enumerate(shards):
        hs = _seam([L.apply_binary_dense_bn_packed(ls[i], fs[i], h,
                                                   backend=backend)
                    for ls, fs, h in zip(layers, foldeds, hs)], peers, s)
    return hs


def apply_output_batchnorm(packed: dict, z: torch.Tensor) -> torch.Tensor:
    """The float output batch norm on the output layer's int32 values."""
    return L.apply_batchnorm(packed["bn_out"], z)


# ---------------------------------------------------------------------------
# Binary MLP (paper §6.2)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BMLPSpec:
    sizes: tuple[int, ...] = (784, 4096, 4096, 4096, 10)
    nbits_input: int = 8          # MNIST pixels are 8-bit (paper §4.3)


def init_bmlp(gen: torch.Generator, spec: BMLPSpec) -> dict:
    """Latent weights uniform in [-1, 1) from ``gen``, identity BN."""
    layers, bns = [], []
    for d_in, d_out in zip(spec.sizes[:-1], spec.sizes[1:]):
        layers.append(L.init_binary_dense(gen, d_in, d_out))
        bns.append(L.init_batchnorm(d_out))
    return {"layers": layers, "bns": bns}


def bmlp_forward_float(params: dict, x_uint8: torch.Tensor, *,
                       ste: bool = False) -> torch.Tensor:
    """Reference forward on (B, K) fixed-precision input.  The first
    layer takes the raw integer input (no sign).  ``ste=True`` is the
    training path: sign with the straight-through estimator backward."""
    n = len(params["layers"])
    h = None
    for i in range(n):
        if i == 0:
            z = L.apply_bitplane_dense_float(params["layers"][i], x_uint8)
        else:
            z = L.apply_binary_dense_float(params["layers"][i], h, ste=ste)
        z = L.apply_batchnorm(params["bns"][i], z)
        if i < n - 1:
            h = B.binarize_ste(z) if ste else B.sign_pm1(z)
    return z


def pack_bmlp(params: dict, spec: BMLPSpec, device="cuda") -> dict:
    """One-time packing of ``init_bmlp`` params, on ``device``; the
    default device is the card, and without one it raises."""
    device = _check_device(device)
    params = to_device(params, "cpu")
    layers = params["layers"]
    packed_layers = [L.pack_bitplane_dense(layers[0],
                                           nbits=spec.nbits_input)]
    packed_layers += [L.pack_binary_dense(p) for p in layers[1:]]
    folded = [L.fold_bn_sign(bn) for bn in params["bns"][:-1]]
    packed = to_device({"layers": packed_layers, "folded": folded,
                        "bn_out": params["bns"][-1]}, device)
    packed["spec"] = spec
    return packed


def bmlp_forward_positions(trees: list, xs: list, peers: list,
                           shard_plan: dict, *, backend: str = "auto",
                           dense_stack: str = "auto") -> list:
    """The packed BMLP on positions (see ``_gather_packed``): position
    ``p`` runs ``trees[p]`` on ``xs[p]``; ``shard_plan["layer"][i]`` is
    layer ``i``'s C_out split.  Returns each position's int32 output.

    Layer 0 is the bit-plane dense layer (one ``bitpack`` and one K4 over
    the stacked planes) and the standalone BN-sign pack (K2); the hidden
    layers are the dense stack (K6, or K4-fused per layer); the output
    layer is the int32 GEMM (K4).
    """
    layer_shards = shard_plan["layer"]
    n = len(trees[0]["layers"])
    if layer_shards[-1] != 1:
        raise ValueError("the output layer must stay replicated")
    tr = _tracer()
    with tr.span("model.bmlp.bitplane_dense"):
        hs = _seam([L.apply_bn_sign_folded_packed(
            t["folded"][0], L.apply_bitplane_dense_packed(
                t["layers"][0], x, backend=backend),
            backend=backend) for t, x in zip(trees, xs)], peers,
            layer_shards[0])
    # an argument only where the tracer records it: none on the off path
    with (tr.span("model.bmlp.dense_stack", layers=n - 2) if tr.enabled
          else tr.span("model.bmlp.dense_stack")):
        hs = _dense_hidden_stack([t["layers"][1:n - 1] for t in trees],
                                 [t["folded"][1:] for t in trees], hs, peers,
                                 layer_shards[1:n - 1], backend=backend,
                                 dense_stack=dense_stack)
    with tr.span(SPAN_OUTPUT["bmlp"]):
        return [L.apply_binary_dense_prepacked(t["layers"][n - 1], h,
                                               backend=backend)
                for t, h in zip(trees, hs)]


def bmlp_forward_packed_int(packed: dict, x_uint8: torch.Tensor, *,
                            backend: str = "auto",
                            dense_stack: str = "auto") -> torch.Tensor:
    """The packed forward up to the output layer's int32 pre-BN values
    (:func:`bmlp_forward_positions` on one position)."""
    plan = {"layer": (1,) * len(packed["layers"])}
    return bmlp_forward_positions([packed], [x_uint8], [[0]], plan,
                                  backend=backend, dense_stack=dense_stack)[0]


def bmlp_forward_packed(packed: dict, x_uint8: torch.Tensor, *,
                        backend: str = "auto",
                        dense_stack: str = "auto") -> torch.Tensor:
    """Packed forward: (B, K) uint8 -> (B, n_classes) f32 logits.  Every
    activation after layer 0 stays bit-packed; ``backend`` and
    ``dense_stack`` as in :func:`bcnn_forward_packed`."""
    z = bmlp_forward_packed_int(packed, x_uint8, backend=backend,
                                dense_stack=dense_stack)
    with _tracer().span(SPAN_OUTPUT["bmlp"]):
        return apply_output_batchnorm(packed, z)


# ---------------------------------------------------------------------------
# Binary CNN (paper §6.3)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvStage:
    c_out: int
    pool: bool = False


@dataclass(frozen=True)
class BCNNSpec:
    input_hw: tuple[int, int] = (32, 32)
    c_in: int = 3
    stages: tuple[ConvStage, ...] = (
        ConvStage(128), ConvStage(128, pool=True),
        ConvStage(256), ConvStage(256, pool=True),
        ConvStage(512), ConvStage(512, pool=True),
    )
    dense: tuple[int, ...] = (1024, 1024, 10)
    ksize: int = 3
    nbits_input: int = 8


def _stage_hw(spec: BCNNSpec):
    """Spatial size entering each conv stage (SAME convs, pool /2)."""
    h, w = spec.input_hw
    out = []
    for st in spec.stages:
        out.append((h, w))
        if st.pool:
            h, w = h // 2, w // 2
    return out, (h, w)


def init_bcnn(gen: torch.Generator, spec: BCNNSpec) -> dict:
    """Latent weights uniform in [-1, 1) from ``gen``, identity BN."""
    convs, conv_bns = [], []
    c = spec.c_in
    for st in spec.stages:
        convs.append(L.init_binary_conv2d(gen, spec.ksize, spec.ksize, c,
                                          st.c_out))
        conv_bns.append(L.init_batchnorm(st.c_out))
        c = st.c_out
    _, (fh, fw) = _stage_hw(spec)
    d_in = fh * fw * c
    denses, dense_bns = [], []
    for d_out in spec.dense:
        denses.append(L.init_binary_dense(gen, d_in, d_out))
        dense_bns.append(L.init_batchnorm(d_out))
        d_in = d_out
    return {"convs": convs, "conv_bns": conv_bns,
            "denses": denses, "dense_bns": dense_bns}


def bcnn_forward_float(params: dict, x_uint8: torch.Tensor,
                       spec: BCNNSpec, *, ste: bool = False) -> torch.Tensor:
    """Reference forward on (B, H, W, C) fixed-precision input.  The first
    conv takes the raw integer input (no sign).  ``ste=True`` is the
    training path: sign with the straight-through estimator backward."""
    binarize = B.binarize_ste if ste else B.sign_pm1
    h = x_uint8.to(torch.float32)
    for i, st in enumerate(spec.stages):
        w = binarize(params["convs"][i]["w"])
        z = L.conv2d_float64(h if i == 0 else binarize(h), w)
        if st.pool:
            z = L.maxpool2d(z)
        h = L.apply_batchnorm(params["conv_bns"][i], z)
    h = binarize(h).reshape(h.shape[0], -1)
    n = len(params["denses"])
    for i in range(n):
        z = L.apply_binary_dense_float(params["denses"][i], h, ste=ste)
        z = L.apply_batchnorm(params["dense_bns"][i], z)
        if i < n - 1:
            h = binarize(z)
    return z


def pack_bcnn(params: dict, spec: BCNNSpec, device="cuda") -> dict:
    """One-time packing of ``init_bcnn`` params, on ``device``.

    Plans, folded BN and masks are computed on the CPU in the reference's
    arithmetic, then moved.  The default device is the card; without one
    it raises.
    """
    device = _check_device(device)
    params = to_device(params, "cpu")
    hws, _ = _stage_hw(spec)
    packed_convs = []
    for i, st in enumerate(spec.stages):
        if i == 0:
            pc = L.pack_bitplane_conv2d(params["convs"][i], input_hw=hws[i],
                                        stride=1, padding="SAME",
                                        nbits=spec.nbits_input)
        else:
            pc = L.pack_binary_conv2d(params["convs"][i], input_hw=hws[i],
                                      stride=1, padding="SAME")
        packed_convs.append(pc)
    folded_conv = [L.fold_bn_sign(bn) for bn in params["conv_bns"]]
    pool_masks = [L.pool_flip_mask(folded_conv[i]) if st.pool else None
                  for i, st in enumerate(spec.stages)]
    c_last = spec.stages[-1].c_out
    packed_dense = [L.pack_binary_dense_grouped(params["denses"][0], c_last)]
    packed_dense += [L.pack_binary_dense(p) for p in params["denses"][1:]]
    folded_dense = [L.fold_bn_sign(bn) for bn in params["dense_bns"][:-1]]
    packed = {"convs": packed_convs, "folded_conv": folded_conv,
              "pool_masks": pool_masks,
              "denses": packed_dense, "folded_dense": folded_dense,
              "bn_out": params["dense_bns"][-1]}
    packed = to_device(packed, device)
    packed["spec"] = spec
    return packed


def bcnn_forward_positions(trees: list, xs: list, peers: list,
                           shard_plan: dict, *, backend: str = "auto",
                           dense_stack: str = "auto") -> list:
    """The packed BCNN on positions (see ``_gather_packed``): position
    ``p`` runs ``trees[p]`` on ``xs[p]``; ``shard_plan["conv"][i]`` and
    ``shard_plan["dense"][i]`` are each stage's C_out split.  Returns each
    position's int32 output.

    Stage 0 is the bit-plane conv with the BN-sign pack fused in (K1's
    fused instance) where the stage does not pool, as ``BCNNSpec()``'s
    does; where it pools, the bit-plane conv (K1), the int32 pool and the
    standalone BN-sign pack (K2), in the reference's order.  Stages 1..
    are fused conv + BN-sign + repack (K3) with bit-domain pooling under
    the (local) pool mask.  The hidden dense layers are the dense stack
    (K6, or K4-fused per layer) and the output layer is the int32 GEMM
    (K4).  A sharded stage's conv plan is localized to its C_out share.
    """
    spec: BCNNSpec = trees[0]["spec"]
    conv_shards, dense_shards = shard_plan["conv"], shard_plan["dense"]
    if dense_shards[-1] != 1:
        raise ValueError("the output layer must stay replicated")

    def stage0(t, x):
        pc = L.localize_conv_plan(t["convs"][0], conv_shards[0])
        if spec.stages[0].pool:
            z = L.apply_bitplane_conv2d_packed(pc, x, backend=backend)
            return L.apply_bn_sign_folded_packed(t["folded_conv"][0],
                                                 L.maxpool2d(z),
                                                 backend=backend)
        return L.apply_bitplane_conv2d_bn_packed(pc, t["folded_conv"][0], x,
                                                 backend=backend)

    def stage(i, t, h):
        h = L.apply_binary_conv2d_bn_packed(
            L.localize_conv_plan(t["convs"][i], conv_shards[i]),
            t["folded_conv"][i], h, backend=backend)
        if spec.stages[i].pool:
            h = L.maxpool2d_packed(h, t["pool_masks"][i])
        return h

    tr = _tracer()
    with tr.span("model.bcnn.bitplane_conv"):
        hs = _seam([stage0(t, x) for t, x in zip(trees, xs)], peers,
                   conv_shards[0])
    for i in range(1, len(spec.stages)):
        with (tr.span("model.bcnn.conv_stage", stage=i) if tr.enabled
              else tr.span("model.bcnn.conv_stage")):
            hs = _seam([stage(i, t, h) for t, h in zip(trees, hs)], peers,
                       conv_shards[i])
    hs = [h.reshape(h.shape[0], -1) for h in hs]   # packed (B, fh*fw*Cw)
    n = len(trees[0]["denses"])
    with (tr.span("model.bcnn.dense_stack", layers=n - 1) if tr.enabled
          else tr.span("model.bcnn.dense_stack")):
        hs = _dense_hidden_stack([t["denses"][:n - 1] for t in trees],
                                 [t["folded_dense"] for t in trees], hs,
                                 peers, dense_shards[:n - 1],
                                 backend=backend, dense_stack=dense_stack)
    with tr.span(SPAN_OUTPUT["bcnn"]):
        return [L.apply_binary_dense_prepacked(t["denses"][n - 1], h,
                                               backend=backend)
                for t, h in zip(trees, hs)]


def bcnn_forward_packed_int(packed: dict, x_uint8: torch.Tensor, *,
                            backend: str = "auto",
                            dense_stack: str = "auto") -> torch.Tensor:
    """The packed forward up to the output layer's int32 pre-BN values
    (:func:`bcnn_forward_positions` on one position)."""
    plan = {"conv": (1,) * len(packed["convs"]),
            "dense": (1,) * len(packed["denses"])}
    return bcnn_forward_positions([packed], [x_uint8], [[0]], plan,
                                  backend=backend, dense_stack=dense_stack)[0]


def bcnn_forward_packed(packed: dict, x_uint8: torch.Tensor, *,
                        backend: str = "auto",
                        dense_stack: str = "auto") -> torch.Tensor:
    """Packed forward: (B, H, W, C_in) uint8 -> (B, n_classes) f32 logits.

    Every inter-layer activation after stage 0 stays bit-packed.
    ``backend``: 'auto' | 'cuda' | 'torch' (see ``kernels.ops``);
    ``dense_stack``: 'auto' | 'resident' | 'per_layer'.
    """
    z = bcnn_forward_packed_int(packed, x_uint8, backend=backend,
                                dense_stack=dense_stack)
    with _tracer().span(SPAN_OUTPUT["bcnn"]):
        return apply_output_batchnorm(packed, z)


def packed_kind(packed: dict) -> str:
    """'bcnn' | 'bmlp' | 'transformer' from the shape of a packed tree;
    raises ``ValueError`` for anything else."""
    if "convs" in packed:
        return "bcnn"
    if "blocks" in packed:
        return "transformer"
    if "layers" in packed:
        return "bmlp"
    raise ValueError(f"not a packed bcnn/bmlp/transformer tree: keys "
                     f"{sorted(packed)}")


def packed_input_shape(packed: dict) -> tuple[int, ...]:
    """Per-example input shape (no batch axis) of a packed network: bcnn
    ``(H, W, C_in)`` and bmlp ``(K,)`` raw uint8, transformer
    ``(seq_len,)`` integer token ids."""
    kind = packed_kind(packed)
    if kind == "bcnn":
        spec: BCNNSpec = packed["spec"]
        return (*spec.input_hw, spec.c_in)
    if kind == "transformer":
        return (int(packed["meta"]["seq_len"]),)
    return (int(packed["layers"][0]["k_true"]),)


def packed_dense_kw_words(packed: dict) -> int:
    """Widest dense packed-K extent of the network, in 32-bit words: the
    K side of the serving route decision, where the widest dense layer
    decides for the whole forward."""
    kind = packed_kind(packed)
    if kind == "transformer":
        mats = [blk[w] for blk in packed["blocks"]
                for w in ("wq", "wk", "wv", "wo", "w1", "w2")]
        mats.append(packed["head"])
        return max(int(p["w_packed"].shape[1]) for p in mats)
    layers = packed["denses"] if kind == "bcnn" else packed["layers"]
    return max(int(p["w_packed"].shape[1]) for p in layers)


def packed_device(packed: dict) -> torch.device:
    """The device a packed network's tensors are on."""
    kind = packed_kind(packed)
    if kind == "transformer":
        return packed["head"]["w_packed"].device
    return packed["convs" if kind == "bcnn" else "layers"][0][
        "w_packed"].device


def demo_model(kind: str, *, smoke: bool = False,
               gen: torch.Generator | None = None):
    """Reduced evaluation-network preset + random params for demo programs
    (the serving CLI, ``launch/serve.py``), with the reference's shapes
    (``src/repro/models/cnn.py:451``).  Returns ``(params, spec, kind)``;
    ``smoke`` picks CI-sized shapes; the weights come from ``gen`` (seed 0
    if None)."""
    gen = torch.Generator().manual_seed(0) if gen is None else gen
    if kind == "bcnn":
        spec = BCNNSpec(
            input_hw=(8, 8) if smoke else (16, 16), c_in=3,
            stages=(ConvStage(64), ConvStage(64, pool=True)),
            dense=(128, 10))
        return init_bcnn(gen, spec), spec, "bcnn"
    if kind == "bmlp":
        spec = BMLPSpec(sizes=(784, 256, 256, 10) if smoke
                        else (784, 1024, 1024, 10))
        return init_bmlp(gen, spec), spec, "bmlp"
    raise ValueError(f"kind must be 'bcnn' or 'bmlp', got {kind!r}")


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def check_input(kind: str, input_shape: tuple[int, ...], x,
                device=None) -> torch.Tensor:
    """``x`` (numpy or a tensor) as a tensor on ``device`` (where it is if
    None), checked against a packed network's input: uint8 for the bcnn
    and the bmlp, any integer dtype for the transformer's token ids, of
    shape (B, *input_shape).  Raises ``ValueError`` otherwise."""
    x = torch.as_tensor(x, device=device)
    ok = _is_integer(x.dtype) if kind == "transformer" else \
        x.dtype == torch.uint8
    if not ok or tuple(x.shape[1:]) != input_shape:
        want = "integer" if kind == "transformer" else "uint8"
        raise ValueError(f"expected {want} (B, {input_shape}) input, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x


def make_packed_forward(packed: dict, *, backend: str = "auto",
                        dense_stack: str = "auto"):
    """Forward ``fwd(x) -> logits`` of a packed network, on the device its
    packed tensors are on; ``x`` may be a numpy array or a tensor of shape
    (B, *packed_input_shape(packed)): uint8 for the bcnn and the bmlp,
    integer token ids of any integer dtype for the transformer.
    ``dense_stack`` is validated against the network's own modes."""
    kind = packed_kind(packed)
    input_shape = packed_input_shape(packed)
    device = packed_device(packed)
    if kind == "transformer":
        from repro_torch.models import transformer as tf
        tf.check_dense_stack(dense_stack)
        forward = tf.transformer_forward_packed
    else:
        check_dense_stack(dense_stack)
        forward = (bcnn_forward_packed if kind == "bcnn"
                   else bmlp_forward_packed)

    def fwd(x) -> torch.Tensor:
        with _tracer().span(SPAN_INPUT):
            x = check_input(kind, input_shape, x, device)
        return forward(packed, x, backend=backend, dense_stack=dense_stack)
    return fwd
