"""Carry weights and packed words across from the JAX reference.

The reference package (``src/repro``) keeps parameters as JAX arrays and
packed words as ``uint32``; the port keeps torch tensors and ``int32``
words with the same bit pattern.  These helpers take anything
``numpy.asarray`` accepts (numpy or JAX arrays), so this module imports
neither JAX nor the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import LMSpec
from repro_torch.models import cnn


def params_to_torch(tree):
    """A reference parameter tree (dicts/lists of arrays, e.g. the output of
    ``repro.models.cnn.init_bcnn`` or ``init_bmlp``, or of
    ``repro.models.transformer.init_binary_lm``) -> the same tree of float32
    tensors."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def words_to_torch(words) -> torch.Tensor:
    """Reference ``uint32`` packed words -> int32 tensor, same bits."""
    arr = np.ascontiguousarray(np.asarray(words))
    if arr.dtype != np.uint32:
        raise ValueError(f"packed words must be uint32, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32).copy())


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The port's int32 packed words -> ``uint32`` numpy, same bits."""
    return words.detach().cpu().numpy().view(np.uint32)


def bcnn_spec(ref_spec) -> cnn.BCNNSpec:
    """The port's ``BCNNSpec`` with the fields of a reference spec."""
    return cnn.BCNNSpec(
        input_hw=tuple(ref_spec.input_hw), c_in=ref_spec.c_in,
        stages=tuple(cnn.ConvStage(st.c_out, st.pool)
                     for st in ref_spec.stages),
        dense=tuple(ref_spec.dense), ksize=ref_spec.ksize,
        nbits_input=ref_spec.nbits_input)


def bmlp_spec(ref_spec) -> cnn.BMLPSpec:
    """The port's ``BMLPSpec`` with the fields of a reference spec."""
    return cnn.BMLPSpec(sizes=tuple(ref_spec.sizes),
                        nbits_input=ref_spec.nbits_input)


def lm_spec(ref_cfg) -> LMSpec:
    """The port's ``LMSpec`` with the fields of a reference ``ArchConfig``
    that the packed LM reads."""
    return LMSpec(
        name=ref_cfg.name, num_layers=ref_cfg.num_layers,
        d_model=ref_cfg.d_model, num_heads=ref_cfg.num_heads,
        num_kv_heads=ref_cfg.num_kv_heads, head_dim=ref_cfg.head_dim,
        d_ff=ref_cfg.d_ff, vocab_size=ref_cfg.vocab_size,
        attention_pattern=tuple(ref_cfg.attention_pattern),
        window_size=ref_cfg.window_size, attn_softcap=ref_cfg.attn_softcap,
        moe_d_ff_expert=(None if ref_cfg.moe is None
                         else ref_cfg.moe.d_ff_expert))
