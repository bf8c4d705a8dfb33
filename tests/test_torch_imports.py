"""The port's import rule: no module of reporter_tpu_torch, and not
chip_smoke.py, scripts/ or the port's examples (examples/torch_*.py),
which run on the machine with the card, where there is no JAX, imports
``jax`` (or ``jaxlib``, ``jax.*``) or anything of the JAX
package ``reporter_tpu``. Each file is parsed (``ast``), not imported, so
an import inside a function counts too."""

import ast
import os

import pytest
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    scripts = os.path.join(ROOT, "scripts")
    out += [os.path.join(scripts, n) for n in sorted(os.listdir(scripts))
            if n.endswith(".py")]
    examples = os.path.join(ROOT, "examples")
    out += [os.path.join(examples, n) for n in sorted(os.listdir(examples))
            if n.startswith("torch_") and n.endswith(".py")]
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
_SLICE_14 = ("reporter_tpu_torch.fleet", "reporter_tpu_torch.fleet.residency",
             "reporter_tpu_torch.fleet.router")


@pytest.mark.parametrize("module", _SLICE_13 + _SLICE_14)
def test_new_modules_import_without_jax(module):
    """The grid backend, the tile tools and the fleet import in a fresh
    interpreter with neither jax nor reporter_tpu loaded afterwards (the
    walk above checks their source too)."""
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


def test_the_parallel_package_is_checked():
    """The mesh modules (parallel/) are among the files held to the
    rule: each must keep its own copy of what it needs from the JAX
    package's parallel/, never import it."""
    names = {os.path.relpath(p, ROOT) for p in _files()}
    for mod in ("__init__", "mesh", "dp", "dp_e2e", "sharded_candidates",
                "multimetro", "multihost"):
        assert os.path.join("reporter_tpu_torch", "parallel",
                            f"{mod}.py") in names


def _torch_tests():
    d = os.path.join(ROOT, "tests")
    return sorted(os.path.join(d, n) for n in os.listdir(d)
                  if n.startswith("test_torch_") and n.endswith(".py"))


@pytest.mark.parametrize("path", _torch_tests(),
                         ids=lambda p: os.path.basename(p))
def test_the_gate_is_imported_before_the_port(path):
    """Every port test file imports the gate (tests/_torch_support.py,
    which arms the port's lockdep) at module level, above its first
    reporter_tpu_torch import: arming is creation-time, and port modules
    create locks at import, which under ``--dist loadfile`` happens at
    collection, in file order."""
    with open(path) as f:
        tree = ast.parse(f.read())
    support = port = None
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module == "_torch_support":
            names = {a.name for a in node.names}
            assert {"_torch_gate", "_torch_module_gate"} <= names, names
            support = support or node.lineno
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom)
                else [])
        if port is None and any(m.split(".")[0] == "reporter_tpu_torch"
                                for m in mods):
            port = node.lineno
    assert support is not None, "no module-level import of the gate"
    assert port is None or support < port, (support, port)


@pytest.mark.parametrize("src,ok", [
    ("from _torch_support import _torch_gate, _torch_module_gate\n"
     "from reporter_tpu_torch import faults\n", True),
    ("from reporter_tpu_torch import faults\n"
     "from _torch_support import _torch_gate, _torch_module_gate\n", False),
    ("import reporter_tpu_torch.ops\n", False),
    ("from _torch_support import few_torch_threads\n", False)])
def test_the_order_check_sees_each_form(tmp_path, src, ok):
    p = tmp_path / "test_torch_synthetic.py"
    p.write_text(src)
    if ok:
        test_the_gate_is_imported_before_the_port(str(p))
    else:
        with pytest.raises(AssertionError):
            test_the_gate_is_imported_before_the_port(str(p))


@pytest.mark.parametrize("module", ("reporter_tpu_torch.analysis",
                                    "reporter_tpu_torch.utils.profiling"))
def test_the_analysis_package_and_profiling_are_checked(module):
    """The analysis package and the profiling hook are among the files
    held to the rule (the walk above), and import without JAX."""
    rel = module.replace(".", os.sep)
    names = {os.path.relpath(p, ROOT) for p in _files()}
    assert (rel + ".py") in names or os.path.join(rel, "__init__.py") \
        in names
    if module.endswith("analysis"):
        for mod in ("lint_rules", "concurrency_contract", "global_state",
                    "slo_contract", "device_contract", "compile_manifest",
                    "bench_delta", "__main__"):
            assert os.path.join(rel, f"{mod}.py") in names
    test_new_modules_import_without_jax(module)


def test_the_examples_are_checked():
    """The port's four examples are among the files held to the rule."""
    names = {os.path.relpath(p, ROOT) for p in _files()}
    for stem in ("quickstart", "streaming_demo", "fleet", "multichip"):
        assert os.path.join("examples", f"torch_{stem}.py") in names
    assert os.path.join("examples", "quickstart.py") not in names
