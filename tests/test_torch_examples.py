"""The four examples as modules of the port
(``python -m repro_torch.examples.<name>``): each ``main`` on the CPU at
a small size returns 0 and prints the checks its reference
(``examples/*.py``) prints; on the card ``chip_smoke.py`` runs them."""
import pytest
import torch

from repro_torch.examples import (bitplane_first_layer, quickstart,
                                  serve_binary_lm, train_binary_mlp)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("module,argv,checks", [
    (quickstart, [], ["XNOR-popcount GEMM == sign-binarized fp GEMM, "
                      "bit-exact  ✓",
                      "bit-plane first layer == exact integer GEMM"]),
    (bitplane_first_layer, [],
     ["bit-plane packed first layer == integer GEMM, exact  ✓",
      "bit-plane conv kernel (1x1) == integer GEMM, exact   ✓",
      "per-dot work: 784 FMAs (fp) vs 400 bitwise ops"]),
    (train_binary_mlp, ["--steps", "30"],
     ["step    0  loss", "prediction agreement 1.000",
      "packed deployment is numerically equivalent  ✓"]),
    (serve_binary_lm, ["--requests", "6"],
     ["packed stack:", "served 6 requests (", "  req5: prompt=10 -> "]),
])
def test_example_runs_on_the_cpu(module, argv, checks, capsys):
    assert module.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in checks:
        assert line in out, (line, out)


def test_examples_default_to_the_card(monkeypatch):
    """No ``--device``: the card, and without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (quickstart, bitplane_first_layer, train_binary_mlp,
                   serve_binary_lm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main([])
