"""Serve a small LM with continuous batching and 1-bit packed weights
(``examples/serve_binary_lm.py`` on the port).

The LM-side serving demo (the packed BCNN/BMLP serving engine is
``python -m repro_torch.launch.serve``):

* loads a reduced starcoder2 config with QuantMode.BINARY_WEIGHT,
* packs every projection ONCE (paper C2, 16-32x weight memory cut),
* drives ``train.serve.BatchedServer`` — a ragged mix of requests
  shares one ring of decode slots; finished requests free their slot
  for the next queued prompt, and requests the shared cache cannot
  finish come back flagged ``truncated`` (never dropped),
* reports tokens/s and the packed-vs-fp parameter bytes.

    PYTHONPATH=src python -m repro_torch.examples.serve_binary_lm \
        [--requests 6] [--device cpu]
"""
import argparse
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import linear as LN
from repro_torch.models import model as M
from repro_torch.models.cnn import _check_device
from repro_torch.train import serve as SV
from repro_torch.tree import tree_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _check_device(args.device)

    cfg = get_config("starcoder2-3b", quant="binary_weight", reduced=True)
    gen = torch.Generator().manual_seed(0)
    params_fp = M.init_model(gen, cfg, device=dev)
    fp_bytes = tree_bytes(params_fp["stack"])
    params = LN.maybe_pack_tree(params_fp, cfg.quant, device=dev)
    print(f"packed stack: {fp_bytes} -> {tree_bytes(params['stack'])} bytes"
          f" ({fp_bytes / tree_bytes(params['stack']):.1f}x)")

    server = SV.BatchedServer(cfg, params, batch_slots=args.slots,
                              max_len=args.max_len, device=dev)
    # Ragged request mix: prompts of different lengths, different budgets
    # — continuous batching packs them into the slot ring as slots free.
    reqs = [SV.Request(
        rid=i,
        prompt=torch.randint(0, cfg.vocab_size, (args.prompt_len + i % 3,),
                             generator=gen, dtype=torch.int32),
        max_new=args.max_new + i % 2)
        for i in range(args.requests)]

    t0 = time.monotonic()
    done = server.submit_and_run(reqs)
    dt = time.monotonic() - t0
    total = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests ({total} tokens) in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s, {args.slots} slots)")
    for r in sorted(done, key=lambda r: r.rid):
        mark = " [truncated]" if r.truncated else ""
        print(f"  req{r.rid}: prompt={len(r.prompt)} -> "
              f"{r.out[:8]}{'...' if len(r.out) > 8 else ''}{mark}")
    assert {r.rid for r in done} == {r.rid for r in reqs}, "request lost"
    return 0


if __name__ == "__main__":
    sys.exit(main())
