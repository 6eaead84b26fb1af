"""Deterministic synthetic data (the reference's ``data/synthetic.py``).

No downloads: streams are functions of (seed, step), so a restarted job
resumes bit for bit mid-epoch, the property the fault-tolerance tests
rely on.  Provides token streams with learnable structure (next-token
prediction follows a recurrence, so a real model's loss falls), stub
frontend embeddings, and uint8 image batches shaped like MNIST or
CIFAR-10 for the paper's nets.

A token batch is drawn from numpy's PCG64 seeded with the pair (seed,
step) through a ``SeedSequence``, which keeps every pair distinct (a
``torch.Generator`` on the CPU keeps 32 bits of its seed): the same
shapes, dtypes, ranges and recurrence as the reference's stream, not its
bits (those are ``jax.random``'s).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.cnn import _check_device


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def token_batch(cfg: TokenStreamConfig, step: int, device="cuda") -> dict:
    """Deterministic {"tokens", "labels"}, (B, S) int32 each, on
    ``device``.

    Row b follows x[t+1] = (a_b * x[t] + drift_b + t % 3) % V from a random
    x[0] in [0, V), a_b in [1, 8), drift_b in [0, 4); the labels are the
    next tokens."""
    device = _check_device(device)
    rng = np.random.default_rng([cfg.seed, step])
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    x = rng.integers(0, v, b, dtype=np.int64)
    a = rng.integers(1, 8, b, dtype=np.int64)
    drift = rng.integers(0, 4, b, dtype=np.int64)
    toks = np.empty((b, s + 1), dtype=np.int64)
    toks[:, 0] = x
    for t in range(s):
        x = (a * x + drift + t % 3) % v
        toks[:, t + 1] = x
    toks = torch.from_numpy(toks.astype(np.int32))      # (B, S + 1)
    return {"tokens": toks[:, :-1].contiguous().to(device),
            "labels": toks[:, 1:].contiguous().to(device)}


def embed_batch(gen: torch.Generator, batch: int, seq: int, d: int,
                dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """Stub-frontend embeddings (vision, audio): unit variance."""
    device = _check_device(device)
    x = torch.randn((batch, seq, d), generator=gen, device=gen.device)
    return x.to(dtype).to(device)


def image_batch(gen: torch.Generator, batch: int, hw: tuple[int, int],
                c: int, device="cuda") -> torch.Tensor:
    """uint8 images shaped like MNIST or CIFAR-10 for the paper's nets."""
    device = _check_device(device)
    x = torch.randint(0, 256, (batch, *hw, c), generator=gen,
                      device=gen.device, dtype=torch.uint8)
    return x.to(device)


class TokenLoader:
    """Iterator over ``token_batch`` with a checkpointable cursor."""

    def __init__(self, cfg: TokenStreamConfig, start_step: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.step = start_step
        self.device = device

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = token_batch(self.cfg, self.step, self.device)
        self.step += 1
        return batch

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])
