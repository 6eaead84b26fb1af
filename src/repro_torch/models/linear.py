"""Quantization-aware linear maps: the paper's technique as an LM feature
(the reference's ``models/linear.py``).

A linear's params dict is either:

* float form:   {"w": (d_in, d_out) float32}                (FLOAT, latent)
* packed form:  {"w_packed": (d_out, ceil(d_in/32)) int32 words,
                 "alpha": (d_out,) float32}                  (packed once)

``apply_linear`` dispatches on ``QuantMode`` and ``GemmStrategy``:

* FLOAT          a matmul in the activation dtype;
* BINARY_WEIGHT  sign(W) times a per-output-channel scale alpha (XNOR-Net
                 scaling), real activations: packed, the ±1 weights are
                 unpacked and contracted by a matmul;
* BINARY         sign activations too; packed, the XNOR route packs the
                 activations with K5 (``kernels.ops.bitpack``) and
                 contracts them with K4 (``kernels.ops.binary_matmul_packed``)
                 on the backend ``quant.backend`` names, the unpack route
                 contracts ±1 float32 operands with a matmul.  Both give the
                 same integers.

A linear split over its d_in across the model positions of the sharded
train step (row-parallel) is :func:`apply_row_parallel`: float32 partial
products, summed, alpha from the whole d_in (:func:`latent_alpha`).  A
linear split over its d_out (column-parallel) reads a float32 copy of its
input at each position and gives that copy a float32 gradient
(``apply_linear(..., column=True)``), so the positions' partial input
gradients are summed before they are rounded.
"""
from __future__ import annotations

import torch

from repro_torch.core import binarize as B
from repro_torch.core.quantize import GemmStrategy, QuantConfig, QuantMode
from repro_torch.kernels import ops as kops
from repro_torch.models.cnn import _check_device
from repro_torch.models.common import randn

# Output rows of a weight packed at once: the packing widens bits to int64.
_PACK_ROWS = 16384


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                scale: float | None = None) -> dict:
    s = scale if scale is not None else d_in ** -0.5
    return {"w": randn(gen, (d_in, d_out), s)}


def row_mean(t: torch.Tensor) -> torch.Tensor:
    """The float32 mean over the last axis, summed in the reference's
    order: windows of 32 elements (the axis zero-padded on both sides,
    the smaller half in front), each summed from its first element on,
    then the window sums the same way until one is left, times
    float32(1/K).  So ``alpha`` equals the reference's bit for bit."""
    k = t.shape[-1]
    t = t.to(torch.float32)
    while t.shape[-1] > 1:
        n = -(-t.shape[-1] // 32)
        pad = n * 32 - t.shape[-1]
        t = torch.nn.functional.pad(t, (pad // 2, pad - pad // 2))
        t = t.reshape(*t.shape[:-1], n, 32)
        acc = t[..., 0]
        for j in range(1, 32):
            acc = acc + t[..., j]
        t = acc
    return t[..., 0] * torch.tensor(1.0 / k, dtype=torch.float32,
                                    device=t.device)


def latent_alpha(w: torch.Tensor, dim: int = 0, *,
                 keepdim: bool = False) -> torch.Tensor:
    """XNOR-Net's per-output scale of a latent weight: the mean of |w|
    over d_in (``dim``), detached, in ``w``'s dtype.  Summed in float64
    (exact for any d_in here) and rounded once, so it does not depend on
    the order of the sum: a d_in split over positions whose float64
    partial sums are added (:func:`apply_row_parallel`) gives it bit for
    bit."""
    total = torch.abs(w.detach()).sum(dim, keepdim=keepdim,
                                     dtype=torch.float64)
    return (total / w.shape[dim]).to(w.dtype)


def pack_rows(wt: torch.Tensor) -> torch.Tensor:
    """``pack_bits`` of a (rows, K) matrix along K, a slice of rows at a
    time (the 256000-row LM head would widen to 8 GB of int64 at once)."""
    return torch.cat([B.pack_bits(wt[i:i + _PACK_ROWS])
                      for i in range(0, wt.shape[0], _PACK_ROWS)])


def pack_linear(params: dict) -> dict:
    """One-time conversion to the packed inference form (paper C2).

    Takes stacked weights too: (..., d_in, d_out) packs along d_in, one
    matrix at a time.  The logical d_in is not stored; it is the trailing
    dim of the activation at apply time."""
    w = params["w"]
    lead = w.shape[:-2]
    mats = w.reshape(-1, *w.shape[-2:])
    words, alphas = [], []
    for m in mats:
        wt = m.T                                       # (d_out, d_in)
        alphas.append(row_mean(torch.abs(wt)))
        words.append(pack_rows(wt))
    return {"w_packed": torch.stack(words).reshape(*lead, *words[0].shape),
            "alpha": torch.stack(alphas).reshape(*lead, w.shape[-1])}


def is_packed(params: dict) -> bool:
    return "w_packed" in params


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (b one matrix, or one a batch entry of ``a``) as float32:
    each product of the operands' values exact, the sum in float32.  On
    the card, operands of a lower precision go through one tensor-core
    GEMM with a float32 output (``torch.bmm``'s ``out_dtype``); elsewhere
    they are upcast, the same products."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    if b.ndim == 2:
        y = torch.bmm(a.reshape(1, -1, a.shape[-1]), b[None],
                      out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    return torch.bmm(a, b, out_dtype=torch.float32)


class _Share(torch.autograd.Function):
    """One position's share of a split float product, ``x`` and ``w``
    rounded to ``dtype`` as :func:`apply_linear` rounds them.  ``wide``
    (row-parallel): the output in float32 (:func:`matmul_f32`), for a sum
    over the positions rounded once; else in ``dtype``.  The backward
    gives ``x`` its gradient at ``x``'s own precision: a column-parallel
    position's float32 input copy gets a float32 partial gradient.  ``w``
    (one matrix, or (E, D, F) with ``x`` (E, C, D)) gets the product in
    ``dtype``, as the unsplit product's gradient is."""

    @staticmethod
    def forward(ctx, x, w, dtype, wide):
        xb, wb = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = x.dtype, w.dtype
        return matmul_f32(xb, wb) if wide else torch.matmul(xb, wb)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        x_dt, w_dt = ctx.dtypes
        g = g.to(wb.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            wt = wb.transpose(-1, -2)
            gx = (matmul_f32(g, wt) if x_dt == torch.float32
                  else torch.matmul(g, wt)).to(x_dt)
        if ctx.needs_input_grad[1]:
            if wb.ndim == 2:
                gw = xb.reshape(-1, xb.shape[-1]).T @ g.reshape(
                    -1, g.shape[-1])
            else:
                gw = xb.transpose(-1, -2) @ g
            gw = gw.to(w_dt)
        return gx, gw, None, None


def share_product(x: torch.Tensor, w: torch.Tensor, dtype, *,
                  wide: bool = False) -> torch.Tensor:
    """``x @ w`` in ``dtype`` as one position of a split product runs it
    (:class:`_Share`); the values are those of
    ``torch.matmul(x.to(dtype), w.to(dtype))``."""
    return _Share.apply(x, w, dtype, wide)


def apply_linear(params: dict, x: torch.Tensor, quant: QuantConfig, *,
                 dtype=torch.bfloat16, column: bool = False) -> torch.Tensor:
    """y = x @ W under the quantization policy.  x: (..., d_in).
    ``column``: ``x`` is a column-parallel position's float32 copy of its
    input, whose gradient stays float32 (the latent binary paths contract
    in float32 anyway)."""
    if is_packed(params):
        return _apply_packed(params, x, quant, dtype)
    w = params["w"]
    if quant.mode == QuantMode.FLOAT:
        if column:
            return share_product(x, w, dtype)
        return torch.matmul(x.to(dtype), w.to(dtype))
    # latent-weight paths (STE); the ±1 weights contract in float32 (as
    # the reference's einsum promotes bfloat16 ones: ``grads_bf16``)
    wb = B.binarize_ste(w).to(torch.float32)
    alpha = latent_alpha(w)
    if quant.mode == QuantMode.BINARY:
        y = torch.matmul(B.binarize_ste(x.to(torch.float32)), wb)
    else:                                              # BINARY_WEIGHT
        y = torch.matmul(x.to(torch.float32), wb)
    return (y * alpha).to(dtype)


def _row_product(w: torch.Tensor, x: torch.Tensor, quant: QuantConfig,
                 dtype) -> torch.Tensor:
    """One position's float32 share of a row-parallel product, before
    alpha: ``x`` and ``w`` rounded to ``dtype`` as :func:`apply_linear`
    rounds them, the products summed in float32, so the sum over
    positions is rounded once."""
    if quant.mode == QuantMode.FLOAT:
        return share_product(x, w, dtype, wide=True)
    wb = B.binarize_ste(w).to(torch.float32)
    if quant.mode == QuantMode.BINARY:
        return torch.matmul(B.binarize_ste(x.to(torch.float32)), wb)
    return torch.matmul(x.to(torch.float32), wb)


def apply_row_parallel(par, params: list, xs: list, quant: QuantConfig, *,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ W for a linear split over its d_in across the positions of
    ``par`` (a ``common.Parallel``): ``params[j]`` holds position j's rows
    of W (latent float form), ``xs[j]`` its columns of x.  The partial
    products are summed over the positions in float32
    (``par.reduce``).  In the binary modes alpha is the whole d_in's
    mean of |W| (:func:`latent_alpha`): each position's detached float64
    column sums of its rows, summed over the positions, over the whole
    d_in, applied once after the sum.  Then one cast to ``dtype``."""
    if any(is_packed(p) for p in params):
        raise ValueError("a row-parallel linear takes the latent float "
                         "form; packed linears are served whole")
    y = par.reduce([_row_product(p["w"], x, quant, dtype)
                    for p, x in zip(params, xs)])
    if quant.mode != QuantMode.FLOAT:
        w = params[0]["w"]
        d_in = sum(p["w"].shape[0] for p in params)
        total = par.reduce([torch.abs(p["w"].detach()).sum(
            0, dtype=torch.float64) for p in params])
        y = y * (total / d_in).to(w.dtype)
    return y.to(dtype)


def row_parallel_traffic(quant: QuantConfig, numel: int,
                         d_out: int) -> list:
    """The traffic entries (``common.Parallel``) of one
    :func:`apply_row_parallel` with an output of ``numel`` elements, width
    ``d_out``: the sum of the float32 partial outputs, and in the binary
    modes of alpha's float64 partial sums."""
    out = [("reduce", numel, 4)]
    if quant.mode != QuantMode.FLOAT:
        out.append(("reduce", d_out, 8))
    return out


def _apply_packed(params: dict, x: torch.Tensor, quant: QuantConfig,
                  dtype) -> torch.Tensor:
    k = x.shape[-1]                                    # logical d_in
    alpha = params["alpha"]
    m = 1
    for s in x.shape[:-1]:
        m *= s
    strat = quant.strategy
    if strat == GemmStrategy.AUTO:
        strat = quant.resolve_strategy(m, alpha.shape[0], k)
    if quant.mode == QuantMode.BINARY:
        if strat == GemmStrategy.VPU_XNOR:
            # the sign of x is packed as the sign of sign(x): bit = x >= 0
            xp = kops.bitpack(x.to(torch.float32).reshape(m, k),
                              backend=quant.backend)
            y = kops.binary_matmul_packed(
                xp, params["w_packed"], k_true=k,
                backend=quant.backend).to(torch.float32)
            y = y.reshape(*x.shape[:-1], -1)
        else:
            xb = B.sign_pm1(x.to(torch.float32))
            y = B.binary_dot_unpacked_mxu(xb, params["w_packed"], k,
                                          dtype=torch.float32)
    else:                                              # BINARY_WEIGHT
        y = B.binary_dot_unpacked_mxu(x, params["w_packed"], k, dtype=dtype)
        y = y.to(torch.float32)
    return (y * alpha).to(dtype)


def maybe_pack_tree(params, quant: QuantConfig, device="cuda"):
    """Pack every linear of a param tree for inference (weights pack once
    at load, paper C2), on ``device``: the card unless the caller asks for
    the CPU.  A linear is a dict whose one key is ``"w"``, of two or more
    dims.  Every other leaf is placed on ``device`` as it is (the same
    tensor where it is there already); in ``FLOAT`` mode that is all."""
    device = _check_device(device)

    def walk(p):
        if isinstance(p, dict):
            if quant.mode != QuantMode.FLOAT and "w" in p and \
                    len(p) == 1 and getattr(p["w"], "ndim", 0) >= 2:
                return pack_linear({"w": p["w"].to(device)})
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v) for v in p)
        return p.to(device) if isinstance(p, torch.Tensor) else p

    return walk(params)
