"""The port's top-level import API (reporter_tpu_torch/__init__.py) against
the JAX package's (reporter_tpu/__init__.py): the same names, each the
port's counterpart of the same name, imported at first use, so that a
bare ``import reporter_tpu_torch`` loads no torch. The JAX package's
names are read from its source (``ast``), so nothing here imports jax."""

import ast
import importlib
import os
import subprocess
import sys

import pytest

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
import reporter_tpu_torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_api() -> "dict[str, tuple[str, str]]":
    """name → (module, attribute) of reporter_tpu's lazy ``_api`` dict."""
    with open(os.path.join(_ROOT, "reporter_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_api"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("reporter_tpu/__init__.py has no _api dict")


JAX_API = _jax_api()


def test_the_jax_api_is_read():
    assert len(JAX_API) == 17
    assert {"SegmentMatcher", "make_app", "KafkaProbeConsumer"} <= set(
        JAX_API)


def test_the_names_are_the_jax_packages():
    """Every JAX name, and beyond them only FleetResidency, which the
    port exported at the top level before this API was complete (the
    JAX package has it in reporter_tpu.fleet)."""
    ours = set(reporter_tpu_torch._LAZY)
    assert set(JAX_API) <= ours
    assert ours - set(JAX_API) == {"FleetResidency"}


@pytest.mark.parametrize("name", sorted(JAX_API))
def test_each_name_is_the_ports_counterpart(name):
    obj = getattr(reporter_tpu_torch, name)
    assert obj.__name__ == name == JAX_API[name][1]
    mod, attr = reporter_tpu_torch._LAZY[name]
    assert mod.startswith("reporter_tpu_torch.")
    # the same module path below the package root
    assert mod.split(".", 1)[1] == JAX_API[name][0].split(".", 1)[1]
    assert obj is getattr(importlib.import_module(mod), attr)
    assert obj.__module__.split(".")[0] == "reporter_tpu_torch"


def test_an_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'Nope'"):
        getattr(reporter_tpu_torch, "Nope")


def test_a_bare_import_loads_no_torch():
    code = ("import sys, reporter_tpu_torch\n"
            "assert 'torch' not in sys.modules, 'torch'\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'reporter_tpu')]\n"
            "assert not bad, bad\n"
            "reporter_tpu_torch.Config\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('reporter_tpu_torch')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "reporter_tpu_torch.config" in proc.stdout
