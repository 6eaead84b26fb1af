"""Shared set-up of the model-zoo parity tests (``test_torch_zoo_*.py``,
``test_torch_batched_server.py``): reference configs and their port
counterparts, reference weights crossed over through
``repro_torch.convert.tree_to_torch``, inputs from numpy seeds, and the
comparisons.  Not a test module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config, list_configs
from repro.models import linear as JLN
from repro.models import model as JM
from repro_torch import convert as CV

NAMES = list_configs()
MODES = ("float", "binary_weight", "binary")
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def configs(name, mode, dtype="float32"):
    """The reduced reference config in ``mode`` and ``dtype``, and the
    port's config with the same fields."""
    cfg = dataclasses.replace(get_config(name, quant=mode, reduced=True),
                              dtype=dtype)
    return cfg, CV.arch_config(cfg)


def weights(cfg, seed, packed):
    """Reference weights from ``init_model`` (packed by the reference's
    ``maybe_pack_tree`` when ``packed``) and the same tree in the port."""
    jp = JM.init_model(jax.random.PRNGKey(seed), cfg)
    if packed:
        jp = JLN.maybe_pack_tree(jp, cfg.quant)
    return jp, CV.tree_to_torch(jp)


def batch(cfg, rng, b, s, enc_len=10):
    """Token ids (and, for the encoder-decoder, frame embeddings) as a
    reference batch and a port batch."""
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    if cfg.encoder_layers:
        enc = rng.normal(size=(b, enc_len, cfg.d_model)).astype(np.float32)
        jb["enc_embeds"] = jnp.asarray(enc)
        tb["enc_embeds"] = torch.from_numpy(enc)
    return jb, tb


def np_of(x):
    """float32 (or integer) numpy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t
                ).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_close(got, want, tol, what=""):
    g, w = np_of(got), np_of(want)
    if w.dtype == np.uint32 and g.dtype == np.int32:
        g = g.view(np.uint32)             # the port's words hold the bits
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, err_msg=what, **tol)


def assert_tree_close(got, want, tol, what=""):
    """Leaf for leaf: the port's tree (dicts, lists, tuples) against the
    reference's; integer leaves exactly."""
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = list(leaves(got))
    assert len(jl) == len(tl), (what, len(jl), len(tl))
    for (path, w), (tpath, g) in zip(jl, tl):
        assert_close(g, w, tol, f"{what} {jax.tree_util.keystr(path)} "
                                f"({tpath})")


def leaves(tree, prefix=""):
    """The port tree's leaves in the order of the reference's (dict keys
    sorted, as JAX flattens them)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
        return
    yield prefix, tree
