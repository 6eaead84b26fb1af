"""Carry weights and packed words across from the JAX reference.

The reference package (``src/repro``) keeps parameters as JAX arrays and
packed words as ``uint32``; the port keeps torch tensors and ``int32``
words with the same bit pattern.  These helpers take anything
``numpy.asarray`` accepts (numpy or JAX arrays), so this module imports
neither JAX nor the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import (ArchConfig, LMSpec, MoEConfig, RGLRUConfig,
                                 SSMConfig)
from repro_torch.core.quantize import GemmStrategy, QuantConfig, QuantMode
from repro_torch.models import cnn


def params_to_torch(tree):
    """A reference parameter tree (dicts/lists of arrays, e.g. the output of
    ``repro.models.cnn.init_bcnn`` or ``init_bmlp``, or of
    ``repro.models.transformer.init_binary_lm``) -> the same tree of float32
    tensors.  Every leaf is cast, so packed words and the model zoo's
    tuples go through :func:`tree_to_torch` instead."""
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


def lm_spec(cfg) -> LMSpec:
    """The port's ``LMSpec`` with the fields of an ``ArchConfig`` (the
    reference's or the port's) that the packed LM reads."""
    return LMSpec.from_arch(cfg)


def arch_config(ref_cfg) -> ArchConfig:
    """The port's ``ArchConfig`` with every field of a reference one."""
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ArchConfig)}
    for name, kind in (("moe", MoEConfig), ("ssm", SSMConfig),
                       ("rglru", RGLRUConfig)):
        if fields[name] is not None:
            fields[name] = kind(**dataclasses.asdict(fields[name]))
    q = ref_cfg.quant
    fields["quant"] = QuantConfig(
        mode=QuantMode(q.mode.value), strategy=GemmStrategy(q.strategy.value))
    return ArchConfig(**fields)


def _leaf_to_torch(a, float_dtype):
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        return words_to_torch(arr)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if float_dtype is None:
            float_dtype = (torch.bfloat16 if arr.dtype.name == "bfloat16"
                           else torch.float32)
        return t.to(float_dtype)
    return torch.from_numpy(np.array(arr))


def tree_to_torch(tree, *, float_dtype=torch.float32):
    """A reference model tree (the output of ``repro.models.model.
    init_model``, of ``linear.maybe_pack_tree``, or a decode cache) -> the
    same tree of tensors: dicts, lists and tuples keep their kinds,
    ``uint32`` packed words become int32 words (:func:`words_to_torch`),
    other integer leaves keep their dtype, float leaves become
    ``float_dtype`` (``None`` keeps bfloat16 and makes every other float
    float32).  ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, float_dtype=float_dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_to_torch(v, float_dtype=float_dtype) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return _leaf_to_torch(tree, float_dtype)


def train_state_to_torch(state) -> dict:
    """A reference train state (``repro.train.trainer.init_train_state``
    or a step's output: {"params", "opt": {"mu", "nu", "step"},
    ["ef_error"]}) -> the port's (``repro_torch.train.trainer``): the same
    tree through :func:`tree_to_torch`, float leaves float32, ``step`` a
    0-d int32 tensor."""
    if not {"params", "opt"} <= set(state) or \
            set(state["opt"]) != {"mu", "nu", "step"}:
        raise ValueError(f"not a train state: keys {sorted(state)}")
    out = tree_to_torch(state)
    step = out["opt"]["step"]
    if step.dim() or step.dtype != torch.int32:
        raise ValueError(f"step must be a 0-d int32, got {step.dtype} of "
                         f"shape {tuple(step.shape)}")
    return out
