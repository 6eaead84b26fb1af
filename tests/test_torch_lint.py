"""The port's copy of the lint rules R001-R004
(``repro_torch.analysis.lint``): on the same seeded sources it gives the
same violations as the reference's ``repro.analysis.lint``, and the
port's source is clean under both."""
import os
import subprocess
import sys

import pytest

from repro.analysis import lint as JLINT
from repro_torch.analysis import lint as TLINT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

SEEDED = {
    "unrouted backend": ("def run(x, backend='auto'):\n"
                         "    if backend == 'cuda':\n"
                         "        return x + 1\n"
                         "    return x\n", "src/repro_torch/kernels/fake.py"),
    "forwarded backend": ("def run(x, backend='auto'):\n"
                          "    return go(x, backend=backend)\n",
                          "src/repro_torch/kernels/fake.py"),
    "resolved backend": ("def run(x, backend='auto'):\n"
                         "    return _resolve(backend, x)\n",
                         "src/repro_torch/kernels/fake.py"),
    "unvalidated knob": ("def conv(x, *, block_n=128):\n"
                         "    return x[:block_n]\n",
                         "src/repro_torch/kernels/fake.py"),
    "validated knob": ("def conv(x, *, block_n=128):\n"
                       "    check_block_lanes('block_n', block_n)\n"
                       "    return x[:block_n]\n",
                       "src/repro_torch/kernels/fake.py"),
    "private knob": ("def _conv(x, *, words_per_step=8):\n"
                     "    return x\n", "src/repro_torch/kernels/fake.py"),
    "hardcoded interpret": ("def f(x):\n"
                            "    return call(k, interpret=True)(x)\n",
                            "src/repro_torch/models/fake.py"),
    "backend probe in a model": ("import jax\n"
                                 "def f(x, backend):\n"
                                 "    if backend == 'torch':\n"
                                 "        return jax.default_backend()\n",
                                 "src/repro_torch/models/fake.py"),
    "backend match at home": ("def _resolve(backend, x):\n"
                              "    if backend == 'auto':\n"
                              "        return 'cuda'\n",
                              "src/repro_torch/kernels/ops.py"),
    "plain version exempt": ("def bitpack_ref(x, backend='torch'):\n"
                             "    return x\n",
                             "src/repro_torch/kernels/ref.py"),
}


def _key(violations):
    return [(v.rule, v.path, v.line) for v in violations]


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_same_violations_as_the_reference(case):
    source, path = SEEDED[case]
    got = TLINT.lint_source(source, path)
    assert _key(got) == _key(JLINT.lint_source(source, path))


def test_seeded_cases_hit_each_rule():
    rules = {case: {v.rule for v in TLINT.lint_source(*SEEDED[case])}
             for case in SEEDED}
    assert rules["unrouted backend"] == {"R001", "R004"}
    assert rules["unvalidated knob"] == {"R002"}
    assert rules["hardcoded interpret"] == {"R003"}
    assert rules["backend probe in a model"] == {"R004"}
    assert not rules["forwarded backend"] | rules["resolved backend"] | \
        rules["validated knob"] | rules["private knob"] | \
        rules["backend match at home"] | rules["plain version exempt"]


def test_port_is_clean_under_both_lints():
    assert TLINT.lint_paths([PORT]) == []
    assert JLINT.lint_paths([PORT]) == []
    assert _key(TLINT.lint_paths([PORT])) == _key(JLINT.lint_paths([PORT]))


def test_lint_cli(tmp_path):
    bad = tmp_path / "kernels"
    bad.mkdir()
    (bad / "fake.py").write_text(SEEDED["unrouted backend"][0])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = [sys.executable, "-m", "repro_torch.analysis.lint"]
    out = subprocess.run(run, capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0 and "lint clean" in out.stdout
    out = subprocess.run(run + [str(tmp_path)], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 1 and "2 lint violation(s)" in out.stdout
