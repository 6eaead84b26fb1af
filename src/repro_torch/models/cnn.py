"""The paper's BinaryNet CNN for CIFAR-10 (§6.3) on PyTorch.

``bcnn``: 2x128C3-MP2-2x256C3-MP2-2x512C3-MP2-2x1024FC-10FC, BN + sign
after every conv/dense (Hubara et al. 2016 §2.3).

  init_bcnn(gen, spec)        -> latent float weights + BN
  bcnn_forward_float(...)     -> the float-sign reference forward
  pack_bcnn(params, spec)     -> one-time packed inference params (C2)
  bcnn_forward_packed(...)    -> the packed forward through the kernels

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


def _check_dense_stack(dense_stack: str) -> None:
    """``'per_layer'`` is this port's hidden stack; ``'auto'`` resolves to
    it until the single-launch resident stack kernel is ported."""
    if dense_stack == "resident":
        raise NotImplementedError(
            "dense_stack='resident' needs the single-launch dense stack "
            "kernel, not yet ported (ROADMAP, queue 2: "
            "_dense_stack_kernel); use 'per_layer' or 'auto'")
    if dense_stack not in ("auto", "per_layer"):
        raise ValueError(f"unknown dense_stack mode {dense_stack!r}")


def _dense_hidden_stack(layers: list, foldeds: list, hp: torch.Tensor, *,
                        backend: str, dense_stack: str) -> torch.Tensor:
    """Hidden dense layers: fused GEMM + BN-sign + re-bitpack per layer,
    packed in / packed out.  ``dense_stack`` 'auto' means per-layer here."""
    _check_dense_stack(dense_stack)
    return L.apply_binary_dense_stack_packed(layers, foldeds, hp,
                                             backend=backend)


def bcnn_forward_packed_int(packed: dict, x_uint8: torch.Tensor, *,
                            backend: str = "auto",
                            dense_stack: str = "auto") -> torch.Tensor:
    """The packed forward up to the output layer's int32 pre-BN values.

    Stage 0 is the bit-plane conv (K1), an int32 pool when the stage
    pools, and the standalone BN-sign pack (K2).  Stages 1.. are fused
    conv + BN-sign + repack (K3) with bit-domain pooling.  The hidden
    dense layers are fused GEMM + BN-sign + repack (K4, fused epilogue)
    and the output layer is the int32 GEMM (K4).
    """
    spec: BCNNSpec = packed["spec"]
    z = L.apply_bitplane_conv2d_packed(packed["convs"][0], x_uint8,
                                       backend=backend)
    if spec.stages[0].pool:
        z = L.maxpool2d(z)
    hp = L.apply_bn_sign_folded_packed(packed["folded_conv"][0], z,
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
    ``dense_stack``: 'auto' | 'per_layer' ('resident' is not ported yet).
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
    """Per-example input shape (no batch axis) of a packed bcnn:
    ``(H, W, C_in)`` raw uint8."""
    kind = packed_kind(packed)
    if kind != "bcnn":
        raise NotImplementedError(f"packed {kind} is not ported yet")
    spec: BCNNSpec = packed["spec"]
    return (*spec.input_hw, spec.c_in)


def make_packed_forward(packed: dict, *, backend: str = "auto",
                        dense_stack: str = "auto"):
    """Forward ``fwd(x_uint8) -> logits`` of a packed bcnn, on the device
    its packed tensors are on; ``x_uint8`` may be a numpy array or a
    tensor of shape (B, *packed_input_shape(packed))."""
    input_shape = packed_input_shape(packed)
    _check_dense_stack(dense_stack)
    device = packed["convs"][0]["w_packed"].device

    def fwd(x) -> torch.Tensor:
        x = torch.as_tensor(x, device=device)
        if x.dtype != torch.uint8 or tuple(x.shape[1:]) != input_shape:
            raise ValueError(f"expected uint8 (B, {input_shape}) input, got "
                             f"{x.dtype} {tuple(x.shape)}")
        return bcnn_forward_packed(packed, x, backend=backend,
                                   dense_stack=dense_stack)
    return fwd
