"""The registry architectures (``base.ArchConfig``, one file each, looked
up by ``get_config``), the dry run's input shapes (``shapes.SHAPES``,
``get_shape``) and ``LMSpec``, the fields of a config that the packed
binary LM reads (``LMSpec.from_arch``)."""
from repro_torch.configs.base import (ArchConfig, MoEConfig, RGLRUConfig,
                                      ShapeConfig, SSMConfig)
from repro_torch.configs.lm import GEMMA2_9B, STARCODER2_3B, LMSpec
from repro_torch.configs.registry import get_config, list_configs
from repro_torch.configs.shapes import SHAPES, get_shape

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
           "ShapeConfig", "get_config", "list_configs", "SHAPES",
           "get_shape", "LMSpec", "GEMMA2_9B", "STARCODER2_3B"]
