"""The plain references against the port's forward, and the imports of
every file of the benchmark."""
import ast
from pathlib import Path

import pytest
import torch

from portbench import harness, judge

HERE = Path(harness.__file__).resolve().parent
BANNED = {"jax", "jaxlib", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for path in files:
        found = _imports(path)
        assert not found & BANNED, (path, found & BANNED)
        if path.parent.name == "reference":
            assert "repro_torch" not in found, path
            assert "portbench" not in found, path


@pytest.mark.parametrize("name", ["bcnn-cifar10.offline-b512",
                                  "bmlp-mnist.offline-b4096"])
def test_reference_matches_the_port_at_full_width(name):
    """The port's ``torch`` backend on the CPU, batch 2, full width: no
    logit more than float rounding from the reference's."""
    torch.set_num_threads(4)
    cell = harness.load_cell(name)
    net = harness.load_module("networks", cell.cfg["network"])
    ref = harness.load_module("reference", cell.config)
    gen = torch.Generator().manual_seed(2 ** 31 + 3)
    params = net.make_params(cell.cfg, gen, torch.device("cpu"))
    x = torch.randint(0, 256, (2, *net.input_shape(cell.cfg)), generator=gen,
                      dtype=torch.uint8)
    got = net.build(cell.cfg, params, torch.device("cpu"))(x)
    want = ref.logits(cell.cfg, params, x).double().numpy()
    step = ref.output_step(params).numpy()
    assert judge.gap(got.numpy(), want, step) < 1e-3


def test_reference_sign_of_zero_is_plus_one():
    ref = harness.load_module("reference", "bmlp-mnist")
    cfg = {"sizes": [2, 1]}
    params = {"layers": [{"w": torch.tensor([[0.0, -0.5]])}],
              "bns": [{"gamma": torch.ones(1), "beta": torch.zeros(1),
                       "mean": torch.zeros(1), "var": torch.ones(1)}]}
    z = ref.logits(cfg, params, torch.tensor([[3, 1]], dtype=torch.uint8))
    assert z.item() == pytest.approx(2 / (1 + ref.BN_EPS) ** 0.5)
