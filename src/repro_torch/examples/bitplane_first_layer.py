"""Paper §4.3 / §6.2: first-layer binary optimization via bit-planes
(``examples/bitplane_first_layer.py`` on the port).

Shows (1) the exact integer identity, (2) the work accounting behind the
paper's ~3x whole-network claim: with bit-planes the first layer costs
8 packed GEMMs instead of one fp GEMM — on binary hardware ops that is
8 * K/32 bitwise ops vs K FMAs per dot (4x fewer ops, and no fp unit).
The dense layer runs as its packed form (K5 + K4 on the card, the 8
planes stacked into one GEMM) and as a 1 x 1 convolution over a 1 x 1
image on K1, the bit-plane convolution kernel.

    PYTHONPATH=src python -m repro_torch.examples.bitplane_first_layer \
        [--device cpu]
"""
import argparse
import sys

import torch

from repro_torch.core import binary_layers as L
from repro_torch.models.cnn import _check_device, to_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _check_device(args.device)
    gen = torch.Generator().manual_seed(0)
    d_in, d_out, batch = 784, 512, 8
    params = to_device(L.init_binary_dense(gen, d_in, d_out), dev)
    x = torch.randint(0, 256, (batch, d_in), generator=gen,
                      dtype=torch.uint8).to(dev)

    want = L.apply_bitplane_dense_float(params, x)       # integer GEMM
    packed = to_device(L.pack_bitplane_dense(to_device(params, "cpu")), dev)
    got = L.apply_bitplane_dense_packed(packed, x)
    assert torch.equal(got, want.to(torch.int32))
    print("bit-plane packed first layer == integer GEMM, exact  ✓")

    conv = {"w": params["w"].reshape(d_out, 1, 1, d_in)}
    plan = to_device(L.pack_bitplane_conv2d(to_device(conv, "cpu"),
                                            input_hw=(1, 1),
                                            padding="VALID"), dev)
    got_conv = L.apply_bitplane_conv2d_packed(
        plan, x.reshape(batch, 1, 1, d_in)).reshape(batch, d_out)
    assert torch.equal(got_conv, want.to(torch.int32))
    print("bit-plane conv kernel (1x1) == integer GEMM, exact   ✓")

    fma_ops = d_in                                  # per output dot, fp path
    plane_ops = 8 * 2 * (d_in // 32 + 1)            # 8 planes x (xor+popcnt)
    print(f"per-dot work: {fma_ops} FMAs (fp) vs {plane_ops} bitwise ops "
          f"(packed, 8 planes) -> {fma_ops / plane_ops:.1f}x fewer ops, "
          "no FPU needed (paper reports ~3x whole-net)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
