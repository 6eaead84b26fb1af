"""Quickstart: the paper's XNOR-popcount dot (``examples/quickstart.py``
on the port).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the GEMM is K5 (``bitpack``) on both operands and K4 (the
XNOR GEMM); on the CPU their plain versions.
"""
import argparse
import sys

import torch

from repro_torch.core import binarize as B
from repro_torch.kernels import ops, ref
from repro_torch.models.cnn import _check_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _check_device(args.device)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((64, 1000), generator=gen).to(dev)    # activations
    w = torch.randn((256, 1000), generator=gen).to(dev)   # weights

    # 1. pack once (paper C2): 32 ±1 values per 32-bit word
    w_packed = B.pack_bits(w)
    size = w.numel() * 4
    packed = w_packed.numel() * 4
    print(f"weights: {size} bytes fp32 -> {packed} packed "
          f"({size / packed:.0f}x smaller)")

    # 2. binary GEMM: a.b == K - 2*popcount(XOR) (paper eq. 2)
    out = ops.binary_matmul(a, w)                      # K5 + K4 on the card
    out_plain = ops.binary_matmul(a, w, backend="torch")  # plain version
    expected = ref.binary_matmul_ref(a, w)             # fp oracle
    assert torch.equal(out, expected) and torch.equal(out_plain, expected)
    print("XNOR-popcount GEMM == sign-binarized fp GEMM, bit-exact  ✓")

    # 3. first-layer fixed-precision input via bit-planes (paper eq. 3)
    x = torch.randint(0, 256, (4, 1000), generator=gen,
                      dtype=torch.uint8).to(dev)
    wb = B.sign_pm1(w)
    exact = B.bitplane_dot(x, wb)
    want = (x.to(torch.float64) @ wb.to(torch.float64).T).to(torch.int32)
    assert torch.equal(exact, want)
    print("bit-plane first layer == exact integer GEMM              ✓")
    return 0


if __name__ == "__main__":
    sys.exit(main())
