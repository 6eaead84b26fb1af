"""The port's ``models.model.logits_fn`` against the JAX reference on
all ten reduced registry configs in the three quant modes, on the latent
float weights (the STE path in the binary modes), and the stub
frontend's ``embeds`` bypass.

Contract: float32 configs (``dataclasses.replace(cfg, dtype="float32")``)
within rtol = atol = 1e-4, as in ``test_torch_zoo_model.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.models import model as TM

from _zoo import F32_TOL, MODES, NAMES, assert_close, batch, configs, weights

B, S = 2, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_logits_fn_latent_weights(name, mode):
    cfg, tcfg = configs(name, mode)
    jp, tp = weights(cfg, 2, packed=False)
    jb, tb = batch(cfg, np.random.default_rng(3), B, S)
    got = TM.logits_fn(tp, tcfg, tb)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    assert_close(got, JM.logits_fn(jp, cfg, jb), F32_TOL, "logits")


def test_vlm_embeds_bypass_the_token_embedding():
    """qwen2-vl's stub frontend: ``batch["embeds"]`` takes the token
    embedding's place."""
    cfg, tcfg = configs("qwen2-vl-72b", "float")
    jp, tp = weights(cfg, 4, packed=False)
    emb = np.random.default_rng(5).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    got = TM.logits_fn(tp, tcfg, {"embeds": torch.from_numpy(emb)})
    assert_close(got, JM.logits_fn(jp, cfg, {"embeds": jnp.asarray(emb)}),
                 F32_TOL, "logits from embeds")
