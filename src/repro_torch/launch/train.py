"""Training launcher (the reference's ``launch/train.py``).

    # on the card: every mesh position on the visible cards
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --reduced --steps 50 [--quant binary] [--data 2 --model 2] \
        [--microbatches 2] [--ckpt-dir /tmp/ckpt] [--compress-grads]

    # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --reduced --steps 6 --device cpu [--data 2 --model 2]

The reference's flags and printed lines, plus ``--device``.  The state is
placed on the (data, model) mesh by ``trainer.state_specs`` and every
batch by ``sharding.batch_specs``, as the reference places them; the
step (``trainer.make_train_step(..., mesh=)``) writes out the gathers and
reductions that GSPMD writes there.  With ``--ckpt-dir`` the run resumes
from the newest checkpoint there, on whatever mesh this run has (a
checkpoint holds whole tensors), and replays the same data steps (the
stream is a function of (seed, step)).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, \
    save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.synthetic import TokenStreamConfig, token_batch
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import trainer as TR


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, quant=args.quant, reduced=args.reduced)
    tc = TR.TrainConfig(microbatches=args.microbatches,
                        compress_grads=args.compress_grads, lr=args.lr,
                        warmup=5, total_steps=args.steps)
    mesh = make_host_mesh(args.data, args.model, args.device)
    device = mesh.devices[0]
    print(f"mesh {dict(mesh.shape)} arch {cfg.name} quant "
          f"{cfg.quant.mode.value}")

    gen = torch.Generator(device=device).manual_seed(0)
    state = TR.init_train_state(gen, cfg, tc, device=device)
    shardings = SH.Shardings(mesh, TR.state_specs(state, mesh))
    state = shardings.place(state, donate=True)

    dcfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                             global_batch=args.batch)
    step_fn = TR.make_train_step(cfg, tc, mesh=mesh)

    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state, meta = load_checkpoint(args.ckpt_dir, last, state,
                                          shardings=shardings)
            start = int(meta["step"]) + 1
            print(f"restored step {last}")

    t0 = time.monotonic()
    for i in range(start, args.steps):
        batch = token_batch(dcfg, i, device)
        batch = SH.Shardings(mesh, SH.batch_specs(batch, mesh)).place(batch)
        state, metrics = step_fn(state, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i, state)
    for dev in {d for d in mesh.devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    print(f"done: {args.steps - start} steps in {dt:.1f}s "
          f"({(args.steps - start) / max(dt, 1e-9):.2f} it/s)")


if __name__ == "__main__":
    main()
