#!/usr/bin/env python3
"""Where a full-width training step's time goes on a CUDA card.

    python3 chip_train_profile.py        # from the repository root

starcoder2-3b at its published width and depth, the training cell of
``chip_smoke.py``'s phase 9: for ``float`` and ``binary`` mode a fresh
state from seed 0, one warm step, then one step of the port's trainer
(``train/trainer.py``) at (B, S) = (4, 512) under ``torch.profiler``.
Prints, per mode: the step's wall time (host clock, ending in a
synchronize), the device's kernel time and its share of the wall (the
busy share; one stream, so kernels do not overlap), kernel time by
group (matrix products, elementwise, reductions, copies and fills, the
rest) and the ten kernels that take the most.  Without a card it exits
non-zero.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

BATCH = (4, 512)
GROUPS = (("matrix products", ("gemm", "nvjet", "xmma", "cutlass",
                               "wgmma", "gemv", "dot_kernel")),
          ("elementwise", ("elementwise",)),
          ("reductions", ("reduce", "softmax", "norm")),
          ("copies and fills", ("copy", "fill", "memcpy", "memset",
                                "cat", "index")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "the rest"


def profile_step(mode: str, dev) -> None:
    import gc
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.train import trainer as TR
    cfg = configs.get_config("starcoder2-3b", quant=mode)
    tc = TR.TrainConfig()
    state = TR.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                cfg, tc, device=dev)
    step = TR.make_train_step(cfg, tc)
    dcfg = TokenStreamConfig(cfg.vocab_size, BATCH[1], BATCH[0])
    state, _ = step(state, token_batch(dcfg, 0, dev))
    batch = token_batch(dcfg, 1, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {mode}: loss {float(m['loss']):.6g}; step wall "
          f"{wall_ms:.6g} ms (host clock, profiled), device kernel time "
          f"{total_ms:.6g} ms: busy {total_ms / wall_ms:.1%} of the wall, "
          f"idle {1 - total_ms / wall_ms:.1%}; "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    if not kernels:
        print(f"profile {mode}: the profiler recorded no device time "
              f"(not measured)", flush=True)
    groups: dict = {}
    for e in kernels:
        g = group_of(e.key)
        ms, n = groups.get(g, (0.0, 0))
        groups[g] = (ms + e.self_device_time_total / 1e3, n + e.count)
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"profile {mode}: {g}: {ms:.6g} ms "
              f"({ms / max(total_ms, 1e-12):.1%} of kernel time), {n} "
              f"launches", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        ms = e.self_device_time_total / 1e3
        print(f"profile {mode}:   {ms:.6g} ms x{e.count} "
              f"[{group_of(e.key)}] {e.key[:110]}", flush=True)
    del state, m, step
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("chip_train_profile: torch.cuda.is_available() is false; "
              "this script needs a CUDA card", file=sys.stderr)
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
    for mode in ("float", "binary"):
        profile_step(mode, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
