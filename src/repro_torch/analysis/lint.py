"""Repo lint pass: AST-enforced conventions of the port's kernel layer.

The port's copy of the reference's rules (``repro/analysis/lint.py``),
with the same rule ids, scopes and verdicts on the same sources:

* **R001 backend-resolve**: in ``kernels/``, every function exposing a
  ``backend`` parameter routes it through ``_resolve`` (the one place an
  unknown backend raises) or forwards it onward; a dispatcher that
  string-matches backends locally accepts typos and falls back silently.
* **R002 knob-validation**: in ``kernels/``, every public block knob
  (``block_*``, ``words_per_step``) goes through a ``check_*`` /
  ``resolve_*`` helper or is forwarded to one (the port exposes none:
  its launch geometry stays inside the wrappers).
* **R003 no-hardcoded-interpret**: no ``interpret=True`` literal.
* **R004 backend-probe-locality**: ``default_backend()`` calls and
  ``backend == "..."`` comparisons only in ``kernels/ops.py``, so no
  silent plain-version fallback hides in a model file.

Run as a CLI::

    PYTHONPATH=src python -m repro_torch.analysis.lint [paths]

(default ``src/repro_torch``); it exits 1 and prints ``path:line: RULE
message`` per violation.  The merged analysis report embeds the same
result as its ``lint`` cell.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import sys
from typing import Iterable, Iterator

KNOB_PREFIXES = ("block_",)
KNOB_NAMES = ("words_per_step",)

# Files exempt per rule (paths matched by basename within kernels/).
R001_EXEMPT = ("ref.py",)
R002_EXEMPT = ("ref.py",)
R004_HOME = os.path.join("kernels", "ops.py")
DEFAULT_ROOT = os.path.join("src", "repro_torch")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _is_kernels_file(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return "kernels" in parts


def _func_params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in
            (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def _calls(fn: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            yield node


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _forwards_name(call: ast.Call, name: str) -> bool:
    """Does ``call`` pass the bare variable ``name`` (positionally or as
    any keyword)?"""
    for arg in call.args:
        if isinstance(arg, ast.Name) and arg.id == name:
            return True
    for kw in call.keywords:
        if isinstance(kw.value, ast.Name) and kw.value.id == name:
            return True
    return False


def _check_backend_rule(fn: ast.FunctionDef | ast.AsyncFunctionDef,
                        path: str) -> Iterator[Violation]:
    """R001: a kernels/ function with a ``backend`` param must resolve
    or forward it."""
    if "backend" not in _func_params(fn) or fn.name == "_resolve":
        return
    for call in _calls(fn):
        if _call_name(call).endswith("_resolve"):
            return
        if _forwards_name(call, "backend"):
            return
        if any(kw.arg == "backend" for kw in call.keywords):
            return
    yield Violation("R001", path, fn.lineno,
                    f"function '{fn.name}' takes a backend parameter but "
                    "neither routes it through _resolve nor forwards it")


def _check_knob_rule(fn: ast.FunctionDef | ast.AsyncFunctionDef,
                     path: str) -> Iterator[Violation]:
    """R002: every block knob param must be validated (check_*/resolve_*)
    or forwarded into some call that will.

    Applies to public functions only: validation is the exposed
    wrapper's contract; private kernels/helpers receive knobs their
    wrapper already validated.
    """
    if fn.name.startswith("_"):
        return
    knobs = [p for p in _func_params(fn)
             if p.startswith(KNOB_PREFIXES) or p in KNOB_NAMES]
    for knob in knobs:
        ok = False
        for call in _calls(fn):
            name = _call_name(call)
            validated = name.startswith(("check_", "resolve_"))
            if validated or _forwards_name(call, knob):
                if validated and not _forwards_name(call, knob):
                    # check_block_lanes("block_n", block_n) names the knob
                    # as a string; accept that spelling too.
                    if not any(isinstance(a, ast.Constant) and
                               a.value == knob for a in call.args):
                        continue
                ok = True
                break
        if not ok:
            yield Violation(
                "R002", path, fn.lineno,
                f"block knob '{knob}' of '{fn.name}' is neither validated "
                "(check_*/resolve_*) nor forwarded to a validator")


def _check_interpret_rule(tree: ast.AST, path: str) -> Iterator[Violation]:
    """R003: no literal ``interpret=True`` keyword."""
    for call in _calls(tree):
        for kw in call.keywords:
            if kw.arg == "interpret" and \
                    isinstance(kw.value, ast.Constant) and \
                    kw.value.value is True:
                yield Violation(
                    "R003", path, kw.value.lineno,
                    "hardcoded interpret=True - a kernel's mode is decided "
                    "per call by kernels.ops")


def _check_backend_locality(tree: ast.AST, path: str) -> Iterator[Violation]:
    """R004: backend probing / string-matching only in kernels/ops.py."""
    if os.path.normpath(path).endswith(R004_HOME):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                node.attr == "default_backend":
            yield Violation(
                "R004", path, node.lineno,
                "default_backend() outside kernels/ops.py - backend "
                "resolution has one home")
        if isinstance(node, ast.Compare) and \
                isinstance(node.left, ast.Name) and \
                node.left.id == "backend" and \
                any(isinstance(c, ast.Constant) and isinstance(c.value, str)
                    for c in node.comparators):
            yield Violation(
                "R004", path, node.lineno,
                "string-matching 'backend' outside kernels/ops.py - route "
                "through ops._resolve instead")


def lint_source(source: str, path: str) -> list[Violation]:
    """Lint one file's source text; ``path`` scopes the per-dir rules."""
    tree = ast.parse(source, filename=path)
    out: list[Violation] = []
    base = os.path.basename(path)
    if _is_kernels_file(path):
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if base not in R001_EXEMPT:
                    out.extend(_check_backend_rule(node, path))
                if base not in R002_EXEMPT:
                    out.extend(_check_knob_rule(node, path))
    out.extend(_check_interpret_rule(tree, path))
    out.extend(_check_backend_locality(tree, path))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_paths(paths: Iterable[str]) -> list[Violation]:
    """Lint every ``.py`` file under the given files/directories."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files += [os.path.join(root, n) for n in names
                          if n.endswith(".py")]
        elif p.endswith(".py"):
            files.append(p)
    out: list[Violation] = []
    for f in sorted(files):
        with open(f, encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), f))
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    paths = argv or [DEFAULT_ROOT]
    violations = lint_paths(paths)
    for v in violations:
        print(v)
    if violations:
        print(f"{len(violations)} lint violation(s)")
        return 1
    print("lint clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
