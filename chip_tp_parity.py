#!/usr/bin/env python3
"""How far the tensor-parallel train step's numbers sit from the unsharded
step's on a CUDA card, and why.

    python3 chip_tp_parity.py [part ...]   # from the repository root

Parts (all of them where none is named); TF32 is off, as in
``chip_smoke.py``; without a card the script exits non-zero.

``products``: the products alone, at starcoder2-3b's FFN and attention
shapes at (4, 512) (seeded normal operands, rounded to bfloat16): for
each, the share of output elements where cuBLAS's bfloat16 product
(``torch.matmul``, bfloat16 out) differs from the exact product rounded
once to bfloat16 (a float64 product on the card), and the same share for
the tensor-parallel form (column split: a slice of the columns; row
split: the positions' float32 partial products, ``linear.matmul_f32``,
summed and rounded once).

``cublas``: starcoder2-3b at its published width and depth, (B, S) =
(4, 512), seed 0, float mode, as phase 10 runs it.  For each setting of
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
(True is PyTorch's default: cuBLAS may add a bfloat16 product's partial
sums in bfloat16), one unsharded step and one on each of the meshes
(2, 2) and (1, 4) of the one card, from the same state and batch: each
step's loss and ``grad_norm``, their relative gaps from the unsharded
step's, and ``mu``'s largest gap over each leaf's largest.

``vocab``: the same starcoder2-3b step on (1, 4) at bfloat16 with the
embedding and the head vocabulary-parallel, and again with both gathered
whole (``fsdp.vocab_split`` forced False), each against the unsharded
bfloat16 step and the unsharded float32 one: how much of the split
step's ``grad_norm`` gap from the unsharded step the vocabulary split
makes, against the gap of any bfloat16 step from float32.

``ssm``: phase 10's split-form mamba2-1.3b step (16 layers, (4, 512),
seed 0) against a float64 step from the same state and batch (the
unsharded step with every activation, product and scan in float64; the
params, the gradients and AdamW stay float32): the unsharded float32
step, the same in two microbatches (the same sums in another order), the
split step on (1, 2) at float32, and both at bfloat16, each as loss and
``grad_norm`` gaps and ``mu``'s largest gap over each leaf's largest
(``A_log`` also layer by layer).  Beside it, the cancellation in
``A_log``'s gradient in the float32 step: head h's gradient is the sum
over the (B, S) tokens of dL/d(A dt) times A dt, and for each layer the
largest sum of those terms' magnitudes over the largest |sum| of a head
(how far a rounding of the terms is magnified in the leaf's gap).
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

MESHES = ((2, 2), (1, 4))
# (name, M, K, N, split, positions): the step's products at (4, 512)
PRODUCTS = (("w_up, columns over 4", 2048, 3072, 12288, "column", 4),
            ("w_down, rows over 4", 2048, 12288, 3072, "row", 4),
            ("wo, rows over 2", 2048, 3072, 3072, "row", 2))


def products(dev) -> None:
    import torch
    from repro_torch.models import linear as LN
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, m, k, n, split, parts in PRODUCTS:
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        b = (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(torch.bfloat16)
        exact = (a.double() @ b.double()).to(torch.bfloat16)
        whole = torch.matmul(a, b)
        if split == "column":
            w = n // parts
            tp = torch.cat([torch.matmul(a, b[:, j * w:(j + 1) * w])
                            for j in range(parts)], 1)
        else:
            w = k // parts
            tp = sum(LN.matmul_f32(a[:, j * w:(j + 1) * w],
                                   b[j * w:(j + 1) * w])
                     for j in range(parts)).to(torch.bfloat16)
        print(f"product {name} ({m} x {k} x {n}): elements off the exact "
              f"product rounded once: bfloat16 cuBLAS "
              f"{float((whole != exact).double().mean()):.4g}, "
              f"tensor-parallel {float((tp != exact).double().mean()):.4g}; "
              f"tensor-parallel off the bfloat16 cuBLAS product "
              f"{float((tp != whole).double().mean()):.4g}", flush=True)
        del a, b, exact, whole, tp


def tp_step(cfg, tc, shape, dev, batch) -> tuple[dict, dict]:
    """One step of a fresh state placed on ``shape``: (loss and
    grad_norm, the placed mu)."""
    import chip_smoke as S
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import trainer as TR
    S.free_card()
    mesh = make_host_mesh(*shape, device=dev.type)
    state = S.fresh_state(cfg, tc, dev)
    state = SH.Shardings(mesh, TR.state_specs(state, mesh)).place(
        state, donate=True)
    state, m = TR.make_train_step(cfg, tc, mesh=mesh)(state, batch)
    return ({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])},
            state["opt"]["mu"])


def host_mu(state, sharded: bool) -> dict:
    """{path: mu on the host} of a state after its step."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.tree import leaves_with_path
    mu = state["opt"]["mu"]
    if sharded:
        mu = SH.unshard(mu, "cpu")
    return {p: t.detach().to("cpu") for p, t in leaves_with_path(mu)}


def run_step(cfg, tc, dev, batch, shape=None, during=None) -> dict:
    """One step of a fresh state (seed 0), unsharded or placed on
    ``shape``, the step itself inside the context ``during`` where given:
    loss, grad_norm, mu on the host."""
    import chip_smoke as S
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import trainer as TR
    if dev.type == "cuda":
        S.free_card()
    state = S.fresh_state(cfg, tc, dev)
    if shape is None:
        step = TR.make_train_step(cfg, tc)
    else:
        mesh = make_host_mesh(*shape, device=dev.type)
        state = SH.Shardings(mesh, TR.state_specs(state, mesh)).place(
            state, donate=True)
        step = TR.make_train_step(cfg, tc, mesh=mesh)
    with during() if during else contextlib.nullcontext():
        state, m = step(state, batch)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "mu": host_mu(state, shape is not None)}
    del state
    return out


def leaf_gaps(got: dict, ref: dict) -> dict:
    """{path: largest |got - ref| over the largest |ref|} of each leaf
    (``chip_smoke.mu_gap``'s measure)."""
    out = {}
    for p, r in ref.items():
        r = r.double()
        out[p] = float((got[p].double() - r).abs().max()
                       / r.abs().max().clamp_min(1e-30))
    return out


def compare(what: str, got: dict, ref: dict, ref_name: str) -> None:
    """Prints ``got``'s loss and grad_norm gaps from ``ref``'s, mu's
    largest leaf gap and its leaf, the next four leaves, and A_log's gap
    layer by layer where the tree has one."""
    gaps = leaf_gaps(got["mu"], ref["mu"])
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    print(f"{what} against {ref_name}: loss rtol "
          f"{abs(got['loss'] / ref['loss'] - 1):.3g}, grad_norm rtol "
          f"{abs(got['grad_norm'] / ref['grad_norm'] - 1):.3g}; mu gap "
          + ", ".join(f"{p} {g:.3g}" for p, g in top), flush=True)
    for p in ref["mu"]:
        if p.endswith("A_log"):
            r, g = ref["mu"][p].double(), got["mu"][p].double()
            top_r = float(r.abs().max())
            layers = [float((g[i] - r[i]).abs().max()) / top_r
                      for i in range(r.shape[0])]
            print(f"{what} against {ref_name}: {p} gap by layer, over the "
                  f"leaf's largest: " + " ".join(f"{x:.2g}" for x in layers),
                  flush=True)


class _Float64Torch:
    """``torch`` as a model module sees it inside :func:`float64_step`:
    its ``float32`` is float64, every other name torch's own."""

    def __init__(self, torch):
        self._torch = torch
        self.float32 = torch.float64

    def __getattr__(self, name):
        return getattr(self._torch, name)


@contextlib.contextmanager
def float64_step():
    """Within it the model runs in float64: the config's activation dtype
    and every float32 that the embedding, the Mamba-2 block, the norms,
    the convs and the loss name are float64.  The params stay float32
    (each use casts them up), so their gradients are the float64
    gradients rounded once to float32, and AdamW runs as before."""
    import torch
    from repro_torch.configs import base
    from repro_torch.models import common, model, ssm
    mods = (common, model, ssm)
    prop = base.ArchConfig.activation_dtype
    wide = _Float64Torch(torch)
    base.ArchConfig.activation_dtype = property(lambda self: torch.float64)
    for mod in mods:
        mod.torch = wide
    try:
        yield
    finally:
        base.ArchConfig.activation_dtype = prop
        for mod in mods:
            mod.torch = torch


# the aten products and scans whose inputs the float64 step must not
# take in float32
_WIDE_OPS = ("mm", "bmm", "addmm", "baddbmm", "cumsum", "exp", "softplus",
             "rsqrt", "_log_softmax", "logsumexp", "convolution")


@contextlib.contextmanager
def float32_products(seen: dict):
    """Counts, into ``seen``, the aten calls of :data:`_WIDE_OPS` (their
    backward included) that take a float32 tensor."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Audit(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name.rstrip("_") in _WIDE_OPS or name.endswith("_backward"):
                if any(isinstance(t, torch.Tensor)
                       and t.dtype == torch.float32
                       for t in tree_leaves((args, kwargs or {}))):
                    seen[name] = seen.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Audit():
        yield


@contextlib.contextmanager
def a_log_terms(terms: list):
    """Appends, for each Mamba-2 layer the backward reaches, the (B, S, H)
    terms of A_log's gradient: dL/d(A dt) times A dt."""
    from repro_torch.models import ssm
    scan = ssm.ssd_chunked

    def hooked(x, a, *args, **kw):
        if a.requires_grad:
            a.register_hook(lambda g, a=a.detach():
                            terms.append((g * a).detach().double()))
        return scan(x, a, *args, **kw)
    ssm.ssd_chunked = hooked
    try:
        yield
    finally:
        ssm.ssd_chunked = scan


def ssm_config(layers: int):
    """phase 10's split-form mamba2-1.3b, ``layers`` deep."""
    import dataclasses
    import chip_smoke as S
    from repro_torch import configs
    base = configs.get_config(S.MAMBA_TRAIN)
    return dataclasses.replace(base, num_layers=layers,
                               ssm=dataclasses.replace(base.ssm,
                                                       fused_proj=False))


def ssm_part(dev, cfg=None, batch_shape=None, shape=None) -> None:
    import dataclasses
    import chip_smoke as S
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    cfg = cfg or ssm_config(S.MAMBA_TRAIN_LAYERS)
    b, s = batch_shape or S.TRAIN_BATCH
    shape = shape or S.MAMBA_TRAIN_MESH
    batch = token_batch(TokenStreamConfig(cfg.vocab_size, s, b), 0, dev)
    tc = S.train_config(warmup=1)
    c32 = dataclasses.replace(cfg, dtype="float32")
    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    print(f"ssm: {cfg.name} split form, {cfg.num_layers} layers, (B, S) = "
          f"({b}, {s}), mesh {shape}", flush=True)
    seen = {}

    @contextlib.contextmanager
    def wide():
        with float64_step(), float32_products(seen):
            yield
    f64 = run_step(c32, tc, dev, batch, during=wide)
    print(f"ssm: float64 step, loss {f64['loss']:.10g} grad_norm "
          f"{f64['grad_norm']:.10g}; aten products and scans that took a "
          f"float32 tensor: {seen or 'none'}", flush=True)
    if any(k.rstrip("_") in ("mm", "bmm", "addmm", "baddbmm", "cumsum")
           for k in seen):
        raise AssertionError(f"the float64 step ran float32 products: {seen}")
    terms = []
    u32 = run_step(c32, tc, dev, batch,
                   during=lambda: a_log_terms(terms))
    if len(terms) != cfg.num_layers:
        raise AssertionError(f"{len(terms)} layers of A_log terms, not "
                             f"{cfg.num_layers}")
    ratios = []
    for t in reversed(terms):                   # the backward runs last first
        mag = t.abs().sum((0, 1))
        ratios.append(float(mag.max() / t.sum((0, 1)).abs().max()))
    print("ssm: float32 A_log's gradient, by layer: the largest sum of its "
          "terms' magnitudes over the largest |sum| of a head: "
          + " ".join(f"{r:.3g}" for r in ratios), flush=True)
    del terms
    mb2 = run_step(c32, dataclasses.replace(tc, microbatches=2), dev, batch)
    s32 = run_step(c32, tc, dev, batch, shape)
    for what, got in (("unsharded float32", u32),
                      ("unsharded float32, microbatches=2", mb2),
                      (f"split {shape} float32", s32)):
        compare(f"ssm: {what}", got, f64, "the float64 step")
    compare(f"ssm: split {shape} float32", s32, u32, "the unsharded float32")
    compare("ssm: unsharded float32, microbatches=2", mb2, u32,
            "the unsharded float32")
    del mb2, s32, u32
    u16 = run_step(c16, tc, dev, batch)
    s16 = run_step(c16, tc, dev, batch, shape)
    compare("ssm: unsharded bfloat16", u16, f64, "the float64 step")
    compare(f"ssm: split {shape} bfloat16", s16, f64, "the float64 step")
    compare(f"ssm: split {shape} bfloat16", s16, u16,
            "the unsharded bfloat16")


def vocab_part(dev, cfg=None, batch_shape=None, shape=(1, 4)) -> None:
    import dataclasses
    import chip_smoke as S
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.distributed import fsdp as FS
    cfg = cfg or configs.get_config(S.TRAIN_LM)
    b, s = batch_shape or S.TRAIN_BATCH
    batch = token_batch(TokenStreamConfig(cfg.vocab_size, s, b), 0, dev)
    tc = S.train_config(warmup=1)
    c32 = dataclasses.replace(cfg, dtype="float32")
    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    u32 = run_step(c32, tc, dev, batch)
    u16 = run_step(c16, tc, dev, batch)
    split = run_step(c16, tc, dev, batch, shape)
    rule = FS.vocab_split
    FS.vocab_split = lambda path, spec: False
    try:
        whole = run_step(c16, tc, dev, batch, shape)
    finally:
        FS.vocab_split = rule
    compare("vocab: unsharded bfloat16", u16, u32, "the unsharded float32")
    for what, got in ((f"{shape} bfloat16, vocabulary-parallel", split),
                      (f"{shape} bfloat16, vocabulary gathered whole",
                       whole)):
        compare(f"vocab: {what}", got, u32, "the unsharded float32")
        compare(f"vocab: {what}", got, u16, "the unsharded bfloat16")
    compare(f"vocab: {shape} bfloat16, vocabulary-parallel", split, whole,
            "the same mesh with the vocabulary gathered whole")


def cublas_part(dev) -> None:
    import torch
    import chip_smoke as S
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    b, s = S.TRAIN_BATCH
    cfg = configs.get_config(S.TRAIN_LM)
    batch = token_batch(TokenStreamConfig(cfg.vocab_size, s, b), 0, dev)
    tc = S.train_config(warmup=1)
    for reduced in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
        ref = S.unsharded_step(cfg, tc, dev, batch)
        print(f"reduced-precision bf16 reduction {reduced}: unsharded loss "
              f"{ref['loss']:.8g} grad_norm {ref['grad_norm']:.8g}",
              flush=True)
        for shape in MESHES:
            got, mu = tp_step(cfg, tc, shape, dev, batch)
            worst, _, _ = S.mu_gap(mu, ref["mu"], dev)
            del mu
            print(f"reduced-precision bf16 reduction {reduced}: {shape} loss "
                  f"{got['loss']:.8g} (rtol "
                  f"{abs(got['loss'] / ref['loss'] - 1):.3g}) grad_norm "
                  f"{got['grad_norm']:.8g} (rtol "
                  f"{abs(got['grad_norm'] / ref['grad_norm'] - 1):.3g}); mu "
                  f"largest gap {worst:.3g} of its leaf's largest",
                  flush=True)
        del ref
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True


PARTS = {"products": products, "cublas": cublas_part, "vocab": vocab_part,
         "ssm": ssm_part}


def main(argv: list[str]) -> int:
    import torch
    parts = argv or list(PARTS)
    if any(p not in PARTS for p in parts):
        print(f"chip_tp_parity: parts are {list(PARTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_tp_parity: torch.cuda.is_available() is false; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    for p in parts:
        PARTS[p](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
