"""The port's examples (examples/torch_*.py) run, each as the subprocess a
user starts, with ``--device cpu`` (this box has no card), and print the
markers tests/test_examples.py asserts of their JAX counterparts. Without
``--device`` an example runs on ``cuda``, and on a host without a card it
raises rather than falling back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = os.path.join(_ROOT, "examples")
# a tiny city's compile and match: seconds each on this box
EXAMPLE_TIMEOUT_S = 180


def _run(script: str, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    # the suite's workers run side by side: a small intra-op pool each
    env.update(PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, os.path.join(_EXAMPLES, script), *args],
        capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S, env=env)


def _ok(script: str) -> str:
    proc = _run(script, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_runs():
    out = _ok("torch_quickstart.py")
    assert "POST /report" in out
    assert "GET /stats" in out
    assert "segments" in out
    assert "matcher on cpu" in out


def test_streaming_demo_runs():
    out = _ok("torch_streaming_demo.py")
    assert "replay" in out.lower() or "restore" in out.lower(), out
    assert "lag 0" in out, out


def test_fleet_demo_runs():
    out = _ok("torch_fleet.py")
    assert "routed" in out and "demotions=" in out
    assert "occupancy report" in out
    assert "[pinned]" in out


def test_multichip_demo_runs():
    out = _ok("torch_multichip.py")
    assert "devices: 4 × cpu" in out
    assert "bit-identical to single-device: True" in out
    assert "MetroRouter over submeshes" in out


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_streaming_demo.py",
                                    "torch_fleet.py", "torch_multichip.py"])
def test_examples_import_only_the_port(script):
    """Each example names the port alone: no jax, no reporter_tpu (the
    walk of tests/test_torch_imports.py holds the same rule)."""
    import ast

    with open(os.path.join(_EXAMPLES, script)) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add((node.module or "").split(".")[0])
    assert "reporter_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "reporter_tpu"}, tops


def test_the_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is served, not refused")
    proc = _run("torch_quickstart.py")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
    assert "POST /report" not in proc.stdout
