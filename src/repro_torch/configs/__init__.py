"""The registry architectures (``base.ArchConfig``, one file each, looked
up by ``get_config``) and ``LMSpec``, the fields of a config that the
packed binary LM reads (``LMSpec.from_arch``)."""
from repro_torch.configs.base import (ArchConfig, MoEConfig, RGLRUConfig,
                                      SSMConfig)
from repro_torch.configs.lm import GEMMA2_9B, STARCODER2_3B, LMSpec
from repro_torch.configs.registry import get_config, list_configs

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
           "get_config", "list_configs", "LMSpec", "GEMMA2_9B",
           "STARCODER2_3B"]
