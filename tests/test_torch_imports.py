"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke.py`` (with the modules its phases import) loads neither JAX
nor the reference package."""
import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {repo!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "repro")
                or m.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps([names, leaked]))
"""


def test_port_imports_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c",
         _PROBE.format(src=os.path.join(REPO, "src"), repo=REPO)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    names, leaked = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) >= 10
    # the serving slice's subpackages are walked too
    assert {"repro_torch.telemetry", "repro_torch.telemetry.metrics",
            "repro_torch.telemetry.trace", "repro_torch.train.serve",
            "repro_torch.runtime.faults",
            "repro_torch.launch.serve"} <= set(names)
    assert leaked == []


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_name_no_jax_or_reference_import():
    """Also the imports inside functions, which an import probe only
    reaches when they run."""
    files = [os.path.join(REPO, n)
             for n in ("chip_smoke.py", "chip_conv_tiles.py",
                       "chip_attention_times.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
