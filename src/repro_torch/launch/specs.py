"""Meta-tensor stand-ins for the dry run's inputs (the reference's
``launch/specs.py``): what each cell's step would consume, with shapes
and dtypes and no memory.  Stub frontends (vlm, audio) take precomputed
embeddings, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch: dict = {"labels": _meta((b, s), torch.int32),
                   "tokens": _meta((b, s), torch.int32)}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    if cfg.encoder_layers:
        batch["enc_embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch: dict = {}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
    if cfg.encoder_layers:
        batch["enc_embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    return batch


def decode_token_specs(shape: ShapeConfig) -> torch.Tensor:
    return _meta((shape.global_batch, 1), torch.int32)

