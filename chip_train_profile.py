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

    python3 chip_train_profile.py --sharded

The float step over a mesh of the one card instead (``trainer.
make_train_step(..., mesh=)``, the cells of ``chip_smoke.py``'s phase
10): unsharded, unsharded with ``microbatches=4``, (2, 2) and (4, 1),
each from a fresh state.  A warm step is split at the trainer's marks
(device time by CUDA events, and the host's time between the same
marks, where it launches and does not wait); the next step runs under
the profiler, which adds, beside the above, the device time spent inside
the step's weight gathers, the gradient slices' reduces, autograd's
adds into the preset gradient buffers and the AdamW leaf updates.
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


# (mesh or None for the unsharded step, microbatches)
SHARDED_CELLS = ((None, 1), (None, 4), ((2, 2), 1), ((4, 1), 1))
# Ranges the profiler reads device time in: name -> (module, attribute).
RANGES = {"gathers": ("fsdp", "_Site.assemble"),
          "reduces": ("fsdp", "_Site.scatter"),
          "AdamW leaf updates": ("adamw", "update_leaf")}


def _ranged(fn, name):
    import functools
    import torch

    @functools.wraps(fn)
    def run(*args, **kw):
        with torch.profiler.record_function(f"range: {name}"):
            return fn(*args, **kw)
    return run


class _Marks:
    """The trainer's ``mark`` hook: a CUDA event and the host's clock at
    each mark; ``parts()`` sums (device ms, host ms) by part name."""

    def __init__(self):
        self.events = []

    def __call__(self, name) -> None:
        import torch
        if name == "begin":
            self.events = []
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev, time.perf_counter()))

    def parts(self) -> dict:
        out: dict = {}
        for (_, a, ta), (name, b, tb) in zip(self.events, self.events[1:]):
            dev_ms, host_ms = out.get(name, (0.0, 0.0))
            out[name] = (dev_ms + a.elapsed_time(b),
                         host_ms + (tb - ta) * 1e3)
        return out


def _device_ms(e) -> float:
    us = getattr(e, "device_time_total", None)
    if us is None:
        us = e.cuda_time_total
    return us / 1e3


def profile_sharded(mesh_shape, micro: int, dev) -> None:
    import gc
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw as OPT
    from repro_torch.train import trainer as TR
    what = (f"float {mesh_shape or 'unsharded'} microbatches={micro}")
    mods = {"fsdp": FS, "adamw": OPT}
    saved = []
    for name, (mod, attr) in RANGES.items():
        owner, _, fn = attr.rpartition(".")
        obj = getattr(mods[mod], owner) if owner else mods[mod]
        saved.append((obj, fn, getattr(obj, fn)))
        setattr(obj, fn, _ranged(getattr(obj, fn), name))
    try:
        cfg = configs.get_config("starcoder2-3b", quant="float")
        tc = TR.TrainConfig(microbatches=micro, warmup=1)
        state = TR.init_train_state(
            torch.Generator(device=dev).manual_seed(0), cfg, tc, device=dev)
        mesh = None
        if mesh_shape is not None:
            mesh = make_host_mesh(*mesh_shape, device=dev.type)
            state = SH.Shardings(mesh, TR.state_specs(state, mesh)).place(
                state, donate=True)
        marks = _Marks()
        step = TR.make_train_step(cfg, tc, marks, mesh=mesh)
        dcfg = TokenStreamConfig(cfg.vocab_size, BATCH[1], BATCH[0])
        state, _ = step(state, token_batch(dcfg, 0, dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, token_batch(dcfg, 1, dev))
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        parts = marks.parts()
        print(f"sharded {what}: warm step {warm_ms:.6g} ms (host clock, "
              f"ending in a synchronize); by part, device ms (CUDA events) "
              f"/ host ms between the same marks: " + "; ".join(
                  f"{k} {d:.6g} / {h:.6g}" for k, (d, h) in parts.items()),
              flush=True)
        batch = token_batch(dcfg, 2, dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        # A range is two events: the host's, whose device time is that of
        # the kernels it launched, and its span on the device (a user
        # annotation, device type CUDA), which is no kernel.
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("range: ")]
        total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        launches = sum(e.count for e in kernels)
        host_ms = sum(e.self_cpu_time_total for e in events
                      if e.device_type == DeviceType.CPU) / 1e3
        print(f"sharded {what}: profiled step wall {wall_ms:.6g} ms, "
              f"device kernel time {total_ms:.6g} ms: busy "
              f"{total_ms / wall_ms:.1%}, idle {1 - total_ms / wall_ms:.1%}; "
              f"{launches} kernel launches; host time in the profiled ops "
              f"{host_ms:.6g} ms (the profiler's own included); loss "
              f"{float(m['loss']):.6g}", flush=True)
        if not kernels:
            print(f"sharded {what}: the profiler recorded no device time "
                  f"(not measured)", flush=True)
        for e in events:
            if e.key.startswith("range: ") or \
                    e.key == "torch::autograd::AccumulateGrad":
                if e.device_type == DeviceType.CPU:
                    print(f"sharded {what}:   {e.key}: {e.count} calls, "
                          f"host {e.cpu_time_total / 1e3:.6g} ms, kernels "
                          f"launched inside {_device_ms(e):.6g} ms",
                          flush=True)
                else:
                    print(f"sharded {what}:   {e.key}: its spans on the "
                          f"device {_device_ms(e):.6g} ms", flush=True)
        top = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)[:8]
        print(f"sharded {what}: host self time, the most: " + "; ".join(
            f"{e.key[:60]} {e.self_cpu_time_total / 1e3:.6g} ms x{e.count}"
            for e in top), flush=True)
        groups: dict = {}
        for e in kernels:
            g = group_of(e.key)
            ms, n = groups.get(g, (0.0, 0))
            groups[g] = (ms + e.self_device_time_total / 1e3, n + e.count)
        print(f"sharded {what}: kernel time by group: " + "; ".join(
            f"{g} {ms:.6g} ms, {n} launches" for g, (ms, n) in
            sorted(groups.items(), key=lambda kv: -kv[1][0])), flush=True)
        del state, m, step, prof, events, kernels
    finally:
        for obj, fn, orig in saved:
            setattr(obj, fn, orig)
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
    if "--sharded" in sys.argv[1:]:
        for mesh, micro in SHARDED_CELLS:
            profile_sharded(mesh, micro, dev)
        return 0
    for mode in ("float", "binary"):
        profile_step(mode, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
