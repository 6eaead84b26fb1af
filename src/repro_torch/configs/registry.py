"""Architecture registry: ``get_config(name)``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (chatglm3_6b, gemma2_9b, llama4_maverick_400b,
                                 mamba2_1_3b, nemotron_4_15b, qwen2_vl_72b,
                                 qwen3_moe_30b_a3b, recurrentgemma_9b,
                                 starcoder2_3b, whisper_base)
from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import QuantConfig, QuantMode

_REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in [
        nemotron_4_15b.CONFIG,
        chatglm3_6b.CONFIG,
        gemma2_9b.CONFIG,
        starcoder2_3b.CONFIG,
        mamba2_1_3b.CONFIG,
        llama4_maverick_400b.CONFIG,
        qwen3_moe_30b_a3b.CONFIG,
        qwen2_vl_72b.CONFIG,
        whisper_base.CONFIG,
        recurrentgemma_9b.CONFIG,
    ]
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(name: str, *, quant: str | None = None,
               reduced: bool = False) -> ArchConfig:
    """Look up an architecture; ``quant`` in {float, binary_weight, binary}
    applies the paper's technique."""
    cfg = _REGISTRY[name]
    if quant is not None:
        cfg = dataclasses.replace(cfg, quant=QuantConfig(
            mode=QuantMode(quant)))
    if reduced:
        cfg = cfg.reduced()
    return cfg


def list_configs() -> tuple[str, ...]:
    return ARCH_IDS
