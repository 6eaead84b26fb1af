"""Mamba-2's split form (``SSMConfig.fused_proj=False``) tensor-parallel
over ``model`` in the port's sharded train step (``ssm._forward_parallel``,
``fsdp.split_blocks``), against the reference's unsharded step with
``microbatches = data``, within ``tests/_train.py``'s contract (``loss``
and ``grad_norm`` rtol 1e-5, the moments 1e-4 of a value plus 1e-5 of
the largest, params 1e-6 where the gradient is not noise).

Both packages' reduced mamba2-1.3b take the split form: 16 heads of 8
(d_inner 128), one group of B and C (d_state 16), vocabulary 256.  On
(1, 2) and (2, 2) each position runs 8 heads: ``z_proj``/``x_proj``
columns, the x conv's channels, ``norm_tp`` and ``out_proj_tp`` rows
split over ``model``; B, C and dt made once and fanned out; the norm's
sums of squares summed over ``model``.  Every counter equals
``fsdp.step_traffic``; no split leaf is gathered whole over ``model``.
On (1, 3) 3 divides neither the 16 heads nor the vocabulary: the block
falls back to the whole-weight gather (as the fused form always does),
and nothing moves between model positions.

The block alone, on one input: the split forward within 1e-5 of the
whole forward (float32), its input gradient too (read on this CPU: at
most 1.4e-6 on outputs up to 3.7, and 1.9e-6 on gradients up to 7.2).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import fsdp as TFS
from repro_torch.models import ssm as S

from _tensor_parallel import block_share, check_no_whole_model_gather, \
    one_thread, split_configs, tp_step
from _train import assert_step_close

NAME = "mamba2-1.3b"
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode,shape", [("float", (1, 2)),
                                        ("float", (2, 2)),
                                        ("binary", (2, 2))])
def test_split_form_step_equals_the_reference(mode, shape):
    jout, tout, lr, got, want, seen = tp_step(NAME, mode, shape,
                                              ssm_split=True)
    assert_step_close(jout, tout, lr)
    assert got == want
    blocks = block_share(NAME, shape, got, mode, ssm_split=True)
    assert blocks["sharding.tp_reduces"] > 0
    assert blocks["sharding.tp_grad_reduces"] > 0
    assert any(p.endswith("ssm/z_proj/w") and j == 1 for p, j, _ in seen)
    check_no_whole_model_gather(NAME, shape, seen, ssm_split=True)


def test_heads_that_do_not_split_fall_back():
    """(1, 3): no block splits and the vocabulary does not: every leaf is
    gathered whole at the one data slice's first position, and the step
    still equals the reference's."""
    _, tcfg = split_configs(NAME, ssm_split=True)
    assert TFS.split_blocks(tcfg, 3) == frozenset()
    jout, tout, lr, got, want, seen = tp_step(NAME, "float", (1, 3),
                                              ssm_split=True)
    assert_step_close(jout, tout, lr)
    assert got == want
    assert all(got[k] == 0 for k in TFS.TP_COUNTERS)
    assert all(j is None for _, j, _ in seen)


def test_per_block_rule():
    """The split form splits where |model| divides the heads and each
    position's heads read whole groups (or one); the fused form never."""
    fused = get_config(NAME, reduced=True)
    assert TFS.split_blocks(fused, 2) == frozenset()
    split = dataclasses.replace(fused, ssm=dataclasses.replace(
        fused.ssm, fused_proj=False))
    assert TFS.split_blocks(split, 2) == {"ssm"}
    assert TFS.split_blocks(split, 16) == {"ssm"}
    assert TFS.split_blocks(split, 3) == frozenset()
    groups4 = dataclasses.replace(split, ssm=dataclasses.replace(
        split.ssm, ngroups=4))
    assert S.heads_split(groups4, 2) and S.heads_split(groups4, 8)
    groups3 = dataclasses.replace(split, d_model=96, ssm=dataclasses.replace(
        split.ssm, ngroups=3))                    # 24 heads, 8 a group
    assert not S.heads_split(groups3, 2)         # 12 heads: 1.5 groups
    full = dataclasses.replace(get_config(NAME), ssm=dataclasses.replace(
        get_config(NAME).ssm, fused_proj=False))  # 64 heads of 64
    assert TFS.split_blocks(full, 2) == {"ssm"}   # no attention: 0 heads
    assert TFS.split_blocks(full, 16) == {"ssm"}


def _split_params(p, m, heads, head_dim):
    """Position j's tree: its heads' columns, channels and rows of the
    split leaves, every other leaf whole."""
    step = heads // m * head_dim
    trees = []
    for j in range(m):
        cols = slice(j * step, (j + 1) * step)
        t = dict(p)
        t["z_proj"] = {"w": p["z_proj"]["w"][:, cols]}
        t["x_proj"] = {"w": p["x_proj"]["w"][:, cols]}
        t["conv_w_x"] = p["conv_w_x"][:, cols]
        t["conv_b_x"] = p["conv_b_x"][cols]
        t["norm_tp"] = {"scale": p["norm_tp"]["scale"][cols]}
        t["out_proj_tp"] = {"w": p["out_proj_tp"]["w"][cols]}
        trees.append(t)
    return trees


@pytest.mark.parametrize("m,ngroups", [(2, 1), (4, 1), (2, 4)])
def test_block_equals_the_whole_block(m, ngroups):
    """The split block on one input (B and C in one group, or in 4 of
    which each position holds whole ones) against the whole block."""
    cfg = get_config(NAME, reduced=True)
    cfg = dataclasses.replace(cfg, dtype="float32", ssm=dataclasses.replace(
        cfg.ssm, fused_proj=False, ngroups=ngroups))
    gen = torch.Generator().manual_seed(3)
    p = S.init_mamba2(gen, cfg)
    p["norm_tp"]["scale"] = torch.randn(p["norm_tp"]["scale"].shape,
                                        generator=gen) * 0.1
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=gen) * 0.1
    u = torch.randn((2, 12, cfg.d_model), generator=gen)
    _, d_inner, heads, _ = S._dims(cfg)
    u1 = u.clone().requires_grad_(True)
    want = S.mamba2_forward(p, cfg, u1)
    want.sum().backward()
    cpu = torch.device("cpu")
    par = TFS._Positions(_split_params(p, m, heads, cfg.ssm.head_dim),
                         [cpu] * m, cpu)
    u2 = u.clone().requires_grad_(True)
    got = S.mamba2_forward(par, cfg, u2)
    got.sum().backward()
    torch.testing.assert_close(got, want, **BLOCK_TOL)
    torch.testing.assert_close(u2.grad, u1.grad, **BLOCK_TOL)
    with pytest.raises(ValueError, match="train step"):
        S.mamba2_forward(par, cfg, u, return_cache=True)
