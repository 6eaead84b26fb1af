"""The packed binary LM (``models/transformer.py``'s packed half) on every
reduced registry config against the reference's ``backend="jnp"``,
stage by stage, under ``tests/test_torch_lm.py``'s parity contract: q,
k, v, packed words, the fused FFN output, residuals and logits exactly;
the attention output within rtol = atol = 2e-5, its packed bits flipping
only where the reference value is within 4e-5 of 0; whole logits equal
when no bit flips.  'rec' and 'ssm' layers run as window attention, as
in the reference; MoE configs take the expert width where d_ff is 0.
"""
import pytest
import torch

from repro.configs import get_config, list_configs
from repro_torch import configs as TCFG
from repro_torch import convert as CV

from test_torch_lm import _check_stages, _setup


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list_configs())
def test_lm_spec_from_the_port_config(name):
    """``LMSpec.from_arch`` on the port's own config equals the spec of
    the reference's config, full and reduced."""
    for reduced in (False, True):
        ref = get_config(name, reduced=reduced)
        port = TCFG.get_config(name, reduced=reduced)
        assert TCFG.LMSpec.from_arch(port) == CV.lm_spec(ref)
    assert TCFG.LMSpec.from_arch(TCFG.get_config(name)).reduced() == \
        TCFG.LMSpec.from_arch(TCFG.get_config(name, reduced=True))


@pytest.mark.parametrize("name", list_configs())
def test_packed_lm_on_the_registry(name):
    """S = 12 is longer than the reduced window of 8, so the local and
    the 'rec'/'ssm' layers mask."""
    cfg = get_config(name, reduced=True)
    jp, tp, tokens = _setup(cfg, 11, 2, 12)
    flips = _check_stages(jp, tp, tokens, "jnp")
    print(f"{name} (2, 12): {flips} packed attention bits differ")
