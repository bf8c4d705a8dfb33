"""The port's profiling hook (reporter_tpu_torch/utils/profiling.py): a
torch.profiler Chrome trace written on the CPU, a nested or concurrent
trace refused (it runs untraced inside the first), REPORTER_TPU_TRACE_DIR
turning on the matcher's own hook, and no capture (and no profiler
import) with the variable unset."""

import contextlib
import json
import os
import threading

import pytest

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.utils import profiling

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _traces(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".json"))


def test_a_trace_is_written_on_the_cpu(tmp_path):
    import torch

    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("rtt_span"):
            torch.ones(64).add_(1).sum()
    (name,) = _traces(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "rtt_span" in names and any("add" in str(n) for n in names)


def test_a_nested_trace_does_not_start(tmp_path):
    inner = tmp_path / "inner"
    with profiling.device_trace(str(tmp_path)):
        assert profiling._trace_active
        with profiling.device_trace(str(inner)):
            pass
    assert not inner.exists() and len(_traces(tmp_path)) == 1
    assert not profiling._trace_active


def test_a_concurrent_trace_runs_untraced(tmp_path):
    other = tmp_path / "other"
    started, release = threading.Event(), threading.Event()

    def first():
        with profiling.device_trace(str(tmp_path)):
            started.set()
            release.wait(10)

    t = threading.Thread(target=first)
    t.start()
    assert started.wait(10)
    with profiling.device_trace(str(other)):
        pass
    release.set()
    t.join(10)
    assert not other.exists() and len(_traces(tmp_path)) == 1


def test_unset_costs_nothing(monkeypatch):
    """No directory: no profiler, no lock, no flag: the body just runs."""
    import torch.profiler

    def refuse(*a, **k):
        raise AssertionError("the profiler started with the variable unset")

    monkeypatch.delenv("REPORTER_TPU_TRACE_DIR", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(profiling, "_trace_lock", None)   # never taken
    for arg in (None, ""):
        with profiling.device_trace(arg):
            assert not profiling._trace_active
    # a span outside a capture (the sweep launch carries one) is free
    assert isinstance(profiling.annotate("sweep_exact_kernel"),
                      contextlib.nullcontext)


def test_the_matcher_batch_is_wrapped(tmp_path, monkeypatch):
    """REPORTER_TPU_TRACE_DIR turns on the hook around match_many (the
    JAX package wraps the same batch); unset, no file appears and the
    records are the same."""
    from reporter_tpu_torch.config import CompilerParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.tiles.compiler import compile_network

    ts = compile_network(generate_city("tiny"),
                         CompilerParams(reach_radius=500.0))
    m = SegmentMatcher(ts, device="cpu")
    traces = [Trace.from_json(p.to_report_json(), ts)
              for p in synthesize_fleet(ts, 3, num_points=20, seed=2)]
    monkeypatch.delenv("REPORTER_TPU_TRACE_DIR", raising=False)
    plain = [[r.to_json() for r in x] for x in m.match_many(traces)]
    assert not os.listdir(tmp_path)
    monkeypatch.setenv("REPORTER_TPU_TRACE_DIR", str(tmp_path))
    traced = [[r.to_json() for r in x] for x in m.match_many(traces)]
    assert traced == plain
    assert len(_traces(tmp_path)) == 1
