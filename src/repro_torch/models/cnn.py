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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core import binarize as B
from repro_torch.core import binary_layers as L
from repro_torch.kernels import binary_conv as bconv


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


def _check_dense_stack(dense_stack: str) -> None:
    if dense_stack not in ("auto", "resident", "per_layer"):
        raise ValueError(f"unknown dense_stack mode {dense_stack!r}")


def _dense_hidden_stack(layers: list, foldeds: list, hp: torch.Tensor, *,
                        backend: str, dense_stack: str) -> torch.Tensor:
    """The hidden dense stack shared by both networks, packed in / packed
    out: one launch for the whole stack when its weights fit the H100
    residency rule (``'auto'``; ``'resident'`` forces it), one fused
    GEMM + BN-sign + re-bitpack launch per layer otherwise
    (``'per_layer'`` forces that)."""
    _check_dense_stack(dense_stack)
    resident = {"auto": None, "resident": True,
                "per_layer": False}[dense_stack]
    return L.apply_binary_dense_stack_packed(layers, foldeds, hp,
                                             backend=backend,
                                             resident=resident)


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


def bmlp_forward_float(params: dict, x_uint8: torch.Tensor) -> torch.Tensor:
    """Reference forward on (B, K) fixed-precision input.  The first
    layer takes the raw integer input (no sign)."""
    n = len(params["layers"])
    h = None
    for i in range(n):
        if i == 0:
            z = L.apply_bitplane_dense_float(params["layers"][i], x_uint8)
        else:
            z = L.apply_binary_dense_float(params["layers"][i], h)
        z = L.apply_batchnorm(params["bns"][i], z)
        if i < n - 1:
            h = B.sign_pm1(z)
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


def bmlp_forward_packed_int(packed: dict, x_uint8: torch.Tensor, *,
                            backend: str = "auto",
                            dense_stack: str = "auto") -> torch.Tensor:
    """The packed forward up to the output layer's int32 pre-BN values.

    Layer 0 is the bit-plane dense layer (one ``bitpack`` and one K4 over
    the stacked planes) and the standalone BN-sign pack (K2); the hidden
    layers are the dense stack (K6, or K4-fused per layer); the output
    layer is the int32 GEMM (K4).
    """
    layers = packed["layers"]
    n = len(layers)
    z = L.apply_bitplane_dense_packed(layers[0], x_uint8, backend=backend)
    hp = L.apply_bn_sign_folded_packed(packed["folded"][0], z,
                                       backend=backend)
    hp = _dense_hidden_stack(layers[1:n - 1], packed["folded"][1:], hp,
                             backend=backend, dense_stack=dense_stack)
    return L.apply_binary_dense_prepacked(layers[n - 1], hp, backend=backend)


def bmlp_forward_packed(packed: dict, x_uint8: torch.Tensor, *,
                        backend: str = "auto",
                        dense_stack: str = "auto") -> torch.Tensor:
    """Packed forward: (B, K) uint8 -> (B, n_classes) f32 logits.  Every
    activation after layer 0 stays bit-packed; ``backend`` and
    ``dense_stack`` as in :func:`bcnn_forward_packed`."""
    z = bmlp_forward_packed_int(packed, x_uint8, backend=backend,
                                dense_stack=dense_stack)
    return L.apply_batchnorm(packed["bn_out"], z)


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


def _conv_same_float64(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME, stride-1 correlation of (B, H, W, C) with (O, KH, KW, C) in
    float64 (exact for these integers; no TF32), returned as float32."""
    _, kh, kw, _ = w.shape
    _, pads = bconv.conv_geometry(tuple(h.shape[1:3]), kh, kw, 1, "SAME")
    (pt, pb), (pl, pr) = pads
    x = F.pad(h.to(torch.float64).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    z = F.conv2d(x, w.to(torch.float64).permute(0, 3, 1, 2))
    return z.permute(0, 2, 3, 1).to(torch.float32)


def bcnn_forward_float(params: dict, x_uint8: torch.Tensor,
                       spec: BCNNSpec) -> torch.Tensor:
    """Reference forward on (B, H, W, C) fixed-precision input.  The first
    conv takes the raw integer input (no sign)."""
    h = x_uint8.to(torch.float32)
    for i, st in enumerate(spec.stages):
        w = B.sign_pm1(params["convs"][i]["w"])
        z = _conv_same_float64(h if i == 0 else B.sign_pm1(h), w)
        if st.pool:
            z = L.maxpool2d(z)
        h = L.apply_batchnorm(params["conv_bns"][i], z)
    h = B.sign_pm1(h).reshape(h.shape[0], -1)
    n = len(params["denses"])
    for i in range(n):
        z = L.apply_binary_dense_float(params["denses"][i], h)
        z = L.apply_batchnorm(params["dense_bns"][i], z)
        if i < n - 1:
            h = B.sign_pm1(z)
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


def bcnn_forward_packed_int(packed: dict, x_uint8: torch.Tensor, *,
                            backend: str = "auto",
                            dense_stack: str = "auto") -> torch.Tensor:
    """The packed forward up to the output layer's int32 pre-BN values.

    Stage 0 is the bit-plane conv with the BN-sign pack fused in (K1's
    fused instance) where the stage does not pool, as ``BCNNSpec()``'s
    does; where it pools, the bit-plane conv (K1), the int32 pool and the
    standalone BN-sign pack (K2), in the reference's order.  Stages 1..
    are fused conv + BN-sign + repack (K3) with bit-domain pooling.  The
    hidden dense layers are the dense stack (K6, or K4-fused per layer)
    and the output layer is the int32 GEMM (K4).
    """
    spec: BCNNSpec = packed["spec"]
    if spec.stages[0].pool:
        z = L.apply_bitplane_conv2d_packed(packed["convs"][0], x_uint8,
                                           backend=backend)
        hp = L.apply_bn_sign_folded_packed(packed["folded_conv"][0],
                                           L.maxpool2d(z), backend=backend)
    else:
        hp = L.apply_bitplane_conv2d_bn_packed(
            packed["convs"][0], packed["folded_conv"][0], x_uint8,
            backend=backend)
    for i in range(1, len(packed["convs"])):
        hp = L.apply_binary_conv2d_bn_packed(packed["convs"][i],
                                             packed["folded_conv"][i], hp,
                                             backend=backend)
        if spec.stages[i].pool:
            hp = L.maxpool2d_packed(hp, packed["pool_masks"][i])
    h = hp.reshape(hp.shape[0], -1)            # packed (B, fh*fw*Cw) words
    n = len(packed["denses"])
    h = _dense_hidden_stack(packed["denses"][:n - 1], packed["folded_dense"],
                            h, backend=backend, dense_stack=dense_stack)
    return L.apply_binary_dense_prepacked(packed["denses"][n - 1], h,
                                          backend=backend)


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
    return L.apply_batchnorm(packed["bn_out"], z)


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


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def make_packed_forward(packed: dict, *, backend: str = "auto",
                        dense_stack: str = "auto"):
    """Forward ``fwd(x) -> logits`` of a packed network, on the device its
    packed tensors are on; ``x`` may be a numpy array or a tensor of shape
    (B, *packed_input_shape(packed)): uint8 for the bcnn and the bmlp,
    integer token ids of any integer dtype for the transformer.
    ``dense_stack`` is validated against the network's own modes."""
    kind = packed_kind(packed)
    input_shape = packed_input_shape(packed)
    if kind == "transformer":
        from repro_torch.models import transformer as tf
        tf.check_dense_stack(dense_stack)
        forward, device = (tf.transformer_forward_packed,
                           packed["head"]["w_packed"])
        accepts, want = _is_integer, "integer"
    else:
        _check_dense_stack(dense_stack)
        if kind == "bcnn":
            forward, device = (bcnn_forward_packed,
                               packed["convs"][0]["w_packed"])
        else:
            forward, device = (bmlp_forward_packed,
                               packed["layers"][0]["w_packed"])
        accepts, want = (lambda dt: dt == torch.uint8), "uint8"
    device = device.device

    def fwd(x) -> torch.Tensor:
        x = torch.as_tensor(x, device=device)
        if not accepts(x.dtype) or tuple(x.shape[1:]) != input_shape:
            raise ValueError(f"expected {want} (B, {input_shape}) input, got "
                             f"{x.dtype} {tuple(x.shape)}")
        return forward(packed, x, backend=backend, dense_stack=dense_stack)
    return fwd
