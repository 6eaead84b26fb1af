#!/usr/bin/env python3
"""How far the tensor-parallel train step's bfloat16 numbers sit from the
unsharded step's on a CUDA card, under each setting of cuBLAS's
reduced-precision reduction for bfloat16 products.

    python3 chip_tp_parity.py        # from the repository root

starcoder2-3b at its published width and depth, (B, S) = (4, 512), seed
0, float mode, as ``chip_smoke.py``'s phase 10 runs it.  For each setting
of ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
(True is PyTorch's default: cuBLAS may add a bfloat16 product's partial
sums in bfloat16), one unsharded step and one on each of the meshes
(2, 2) and (1, 4) of the one card (tensor-parallel over ``model``), from
the same state and batch.  Prints each step's loss and ``grad_norm``,
their relative gaps from the unsharded step's, and ``mu``'s largest gap
over each leaf's largest.  TF32 is off, as in ``chip_smoke.py``.  Without
a card it exits non-zero.

First, the products alone, at the FFN's and attention's shapes (seeded
normal operands, rounded to bfloat16): for each, the share of output
elements where cuBLAS's bfloat16 product (``torch.matmul``, bfloat16
out) differs from the exact product rounded once to bfloat16 (a float64
product on the card), and the same share for the tensor-parallel form
(column split: a slice of the columns; row split: the positions' float32
partial products, ``linear.matmul_f32``, summed and rounded once).
"""
from __future__ import annotations

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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_tp_parity: torch.cuda.is_available() is false; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as S
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    products(dev)
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
            worst, _ = S.mu_gap(mu, ref["mu"], dev)
            del mu
            print(f"reduced-precision bf16 reduction {reduced}: {shape} loss "
                  f"{got['loss']:.8g} (rtol "
                  f"{abs(got['loss'] / ref['loss'] - 1):.3g}) grad_norm "
                  f"{got['grad_norm']:.8g} (rtol "
                  f"{abs(got['grad_norm'] / ref['grad_norm'] - 1):.3g}); mu "
                  f"largest gap {worst:.3g} of its leaf's largest",
                  flush=True)
        del ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
