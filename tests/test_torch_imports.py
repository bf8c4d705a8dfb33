"""The port's import rule: no module of reporter_tpu_torch, and not
chip_smoke.py (which runs on the machine with the card, where there is no
JAX), imports ``jax`` (or ``jaxlib``, ``jax.*``) or anything of the JAX
package ``reporter_tpu``. Each file is parsed (``ast``), not imported, so
an import inside a function counts too."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "reporter_tpu_torch")):
        out += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top.startswith("jax") or top == "reporter_tpu"


def imported_modules(source: str):
    """(line, module) of every absolute import in ``source``."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_reporter_tpu_import(path):
    with open(path) as f:
        bad = [(ln, m) for ln, m in imported_modules(f.read())
               if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize("src,bad", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jaxlib import xla_client", True),
    ("from reporter_tpu.config import Config", True),
    ("import reporter_tpu.ops", True),
    ("def f():\n    from reporter_tpu import faults", True),
    ("importlib.import_module('reporter_tpu.service')", True),
    ("from reporter_tpu_torch.config import Config", False),
    ("import reporter_tpu_torch.service", False), ("import json", False),
    ("from . import locks", False)])
def test_the_guard_sees_each_form(src, bad):
    assert any(_forbidden(m) for _, m in imported_modules(src)) is bad


_SLICE_13 = ("reporter_tpu_torch.ops.candidates",
             "reporter_tpu_torch.tiles.__main__",
             "reporter_tpu_torch.tiles.capacity",
             "reporter_tpu_torch.tiles.osmlr_export",
             "reporter_tpu_torch.tiles.osmlr_tiles",
             "reporter_tpu_torch.tiles.reach_audit")


@pytest.mark.parametrize("module", _SLICE_13)
def test_new_modules_import_without_jax(module):
    """The grid backend and the tile tools import in a fresh interpreter
    with neither jax nor reporter_tpu loaded afterwards (the walk above
    checks their source too)."""
    import subprocess
    import sys

    code = (f"import importlib, sys; importlib.import_module({module!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'reporter_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
