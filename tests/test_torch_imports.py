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
    # the serving slice's subpackages are walked too, and the sharding,
    # checkpoint and supervisor slice's
    assert {"repro_torch.telemetry", "repro_torch.telemetry.metrics",
            "repro_torch.telemetry.trace", "repro_torch.train.serve",
            "repro_torch.runtime.faults",
            "repro_torch.launch.serve"} <= set(names)
    assert {"repro_torch.distributed", "repro_torch.distributed.sharding",
            "repro_torch.distributed.verify_sharded",
            "repro_torch.checkpoint", "repro_torch.checkpoint.checkpointer",
            "repro_torch.checkpoint.packed", "repro_torch.launch.mesh",
            "repro_torch.runtime.elastic",
            "repro_torch.runtime.fault_tolerance",
            "repro_torch.runtime.supervisor", "repro_torch.tree"} <= set(names)
    # and the model zoo's: the registry configs, the quant policy and the
    # float stack's modules
    assert {"repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.registry",
            "repro_torch.configs.lm", "repro_torch.configs.gemma2_9b",
            "repro_torch.configs.whisper_base", "repro_torch.core.quantize",
            "repro_torch.models.common", "repro_torch.models.linear",
            "repro_torch.models.ffn", "repro_torch.models.attention",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.rglru", "repro_torch.models.encdec",
            "repro_torch.models.model"} <= set(names)
    # and the training half's: the optimizers, the data stream, the
    # trainer and its launcher
    assert {"repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.compress", "repro_torch.optim.schedule",
            "repro_torch.data", "repro_torch.data.synthetic",
            "repro_torch.train.trainer",
            "repro_torch.launch.train"} <= set(names)
    # and the sharded-training and dry-run slice's
    assert {"repro_torch.distributed.fsdp", "repro_torch.configs.shapes",
            "repro_torch.launch.specs",
            "repro_torch.launch.dryrun"} <= set(names)
    # and the static analysis and launch probes' slice
    assert {"repro_torch.kernels.library", "repro_torch.analysis",
            "repro_torch.analysis.graph", "repro_torch.analysis.packedness",
            "repro_torch.analysis.smem", "repro_torch.analysis.collectives",
            "repro_torch.analysis.lint", "repro_torch.analysis.report",
            "repro_torch.analysis.__main__",
            "repro_torch.telemetry.probes"} <= set(names)
    # and the tensor-parallel step's examples
    assert {"repro_torch.examples", "repro_torch.examples.quickstart",
            "repro_torch.examples.bitplane_first_layer",
            "repro_torch.examples.train_binary_mlp",
            "repro_torch.examples.serve_binary_lm"} <= set(names)
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
                       "chip_attention_times.py", "chip_train_profile.py",
                       "chip_forwards_ab.py", "chip_tp_parity.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
