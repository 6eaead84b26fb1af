"""Train a BinaryNet MLP end-to-end (STE + latent clipping, paper §4.4),
then deploy it the Espresso way: pack once, serve packed, verify the
packed network classifies identically to the training-time reference
(``examples/train_binary_mlp.py`` on the port).

    PYTHONPATH=src python -m repro_torch.examples.train_binary_mlp \
        [--steps 300] [--device cpu]

On the card the packed forward runs K5 (``bitpack``), K4 on the stacked
bit planes, K2 (BN-sign pack), K6 (the hidden stack) and K4.
"""
import argparse
import sys

import torch
import torch.nn.functional as F

from repro_torch.core import binarize as B
from repro_torch.models import cnn
from repro_torch.tree import tree_map


def synthetic_mnist(gen: torch.Generator, n: int):
    """Deterministic MNIST-shaped task: class = argmax over 10 prototype
    projections — learnable by a binary MLP."""
    x = torch.randint(0, 256, (n, 784), generator=gen, dtype=torch.uint8)
    proto = torch.randn((10, 784), generator=gen)
    y = torch.argmax(x.to(torch.float32) @ proto.T, dim=1)
    return x, y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = cnn._check_device(args.device)

    gen = torch.Generator().manual_seed(0)
    spec = cnn.BMLPSpec(sizes=(784, 256, 128, 10))
    params = cnn.to_device(cnn.init_bmlp(gen, spec), dev)
    xs, ys = (t.to(dev) for t in synthetic_mnist(gen, 4096))

    for i in range(args.steps):
        sl = (i * args.batch) % (4096 - args.batch)
        xb, yb = xs[sl:sl + args.batch], ys[sl:sl + args.batch]
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        logits = cnn.bmlp_forward_float(leaves, xb, ste=True)
        loss = F.cross_entropy(logits, yb)
        loss.backward()
        # SGD on fp latents + clip to [-1,1] (paper §4.4)
        params = tree_map(lambda w: B.clip_latent(
            w.detach() - args.lr * (w.grad if w.grad is not None
                                    else torch.zeros_like(w))), leaves)
        if i % 50 == 0:
            print(f"step {i:4d}  loss {float(loss.detach()):.4f}")

    # deploy: pack once (C2), serve packed
    packed = cnn.pack_bmlp(params, spec, device=dev)
    with torch.no_grad():
        logits_ref = cnn.bmlp_forward_float(params, xs[:512])
    logits_bin = cnn.bmlp_forward_packed(packed, xs[:512])
    acc_ref = float((torch.argmax(logits_ref, 1) == ys[:512]).float().mean())
    acc_bin = float((torch.argmax(logits_bin, 1) == ys[:512]).float().mean())
    agree = float((torch.argmax(logits_ref, 1)
                   == torch.argmax(logits_bin, 1)).float().mean())
    print(f"reference acc {acc_ref:.3f} | packed acc {acc_bin:.3f} "
          f"| prediction agreement {agree:.3f}")
    assert agree > 0.999, "packed deployment must match the reference"
    print("packed deployment is numerically equivalent  ✓")
    return 0


if __name__ == "__main__":
    sys.exit(main())
