"""Time K8 (``csrc/binary_attention.cu``) at the LM's attention shapes, on
the card alone and through its wrapper.

Run on a CUDA card from the root of a checkout::

    PYTHONPATH=src python3 chip_attention_times.py [label]

``PYTHONPATH`` may name the ``src`` of another checkout, whose K8 is then
built from that checkout's sources and timed by the same code: run two
trees in turn (A, B, B, A) to compare them on one card.

Cases, operands random from seed 0 (Q and K packed from normal floats, V
normal): gemma2-9b's local and global layers at (B, S) = (1, 4608), its
local layer at the served (1, 16) and (8, 16), and a starcoder2-3b layer
at (1, 1024).  Each case is first held to its plain version
(``ref.binary_attention_packed_ref``) within rtol = atol = 2e-5, then
prints one JSON line with

* ``eager_ms``: CUDA events around back-to-back wrapper calls, per call;
* ``graph_ms``: the same calls captured in a CUDA graph and replayed, per
  call: the card's own time, without the host's launch cost;
* ``host_ms``: host time per wrapper call, enqueued without waiting;

each the median of 7 trials (``chip_conv_tiles.py``'s timers).
"""
from __future__ import annotations

import json
import sys

from chip_conv_tiles import eager_ms, graph_ms, host_ms

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


def cases() -> dict:
    """name -> ((B, Sq, Skv, Hq, Hkv, D, Dv), keyword arguments)."""
    from repro_torch import configs
    g, sc = configs.GEMMA2_9B, configs.STARCODER2_3B
    gem = (g.num_heads, g.num_kv_heads, g.head_dim, g.head_dim)
    local = dict(window=g.window_size, attn_softcap=g.attn_softcap)
    return {
        "gemma2-9b local (1, 4608)": ((1, 4608, 4608, *gem), local),
        "gemma2-9b global (1, 4608)": (
            (1, 4608, 4608, *gem), dict(attn_softcap=g.attn_softcap)),
        "gemma2-9b local (1, 16)": ((1, 16, 16, *gem), local),
        "gemma2-9b local (8, 16)": ((8, 16, 16, *gem), local),
        "starcoder2-3b (1, 1024)": ((1, 1024, 1024, sc.num_heads,
                                     sc.num_kv_heads, sc.head_dim,
                                     sc.head_dim), {}),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_attention_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_attention as ba
    from repro_torch.kernels import ref
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    for name, ((b, sq, skv, hq, hkv, d, dv), kw) in cases().items():
        qp = B.pack_bits(torch.randn((b, sq, hq, d), generator=gen)).to(dev)
        kp = B.pack_bits(torch.randn((b, skv, hkv, d), generator=gen)).to(dev)
        v = torch.randn((b, skv, hkv, dv), generator=gen).to(dev)

        def fn():
            return ba.binary_attention_packed(qp, kp, v, d_true=d, **kw)

        got = fn()
        want = ref.binary_attention_packed_ref(qp, kp, v, d_true=d, **kw)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, **ATTN_TOL):
            print(f"chip_attention_times: {name} differs from its plain "
                  f"version by {err}", file=sys.stderr)
            return 1
        del want
        print(json.dumps({"label": label, "case": name, "max_abs_err": err,
                          "eager_ms": eager_ms(fn), "graph_ms": graph_ms(fn),
                          "host_ms": host_ms(fn)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
