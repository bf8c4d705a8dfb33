"""The port's sub-package import names and the last helpers of the JAX
package's surface, against the JAX package on the CPU.

- Each sub-package exports the names the JAX package's of the same path
  exports, and each is the port's own object (``__module__`` under
  ``reporter_tpu_torch``).
- ``geometry.polyline_length`` and ``great_circle_m`` equal the JAX
  package's at tolerance 0 (both float64 numpy).
- ``PartialTraceCache``: one retain / merge / drop / merge sequence under
  one fake clock gives the same results on both packages.
- ``reporter_tpu_torch.native.lib`` resolves at first access: a bare
  import runs no g++ and loads nothing (a subprocess checks it).
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from reporter_tpu import geometry as jgeo
from reporter_tpu.service.cache import PartialTraceCache as JCache
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
from reporter_tpu_torch import geometry as pgeo
from reporter_tpu_torch.service.cache import PartialTraceCache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUBPACKAGE_NAMES = {
    "ops": ("CandidateSet", "find_candidates", "find_candidates_dense",
            "viterbi_decode", "match_batch", "match_trace", "match_traces"),
    "matcher": ("SegmentMatcher", "MatchedPoint", "SegmentRecord",
                "build_segments", "Trace"),
    "quality": ("QualitySignals", "extract", "QualityMonitor",
                "ShadowAuditor"),
    "utils": ("MetricsRegistry", "StageTimer"),
    "native": ("load_native_lib",),
}


@pytest.mark.parametrize("pkg", sorted(SUBPACKAGE_NAMES))
def test_subpackage_exports_the_ports_own_names(pkg):
    mod = importlib.import_module(f"reporter_tpu_torch.{pkg}")
    for name in SUBPACKAGE_NAMES[pkg]:
        obj = getattr(mod, name)
        assert obj.__module__.split(".")[0] == "reporter_tpu_torch", name
        assert name in mod.__all__, name


def test_native_load_native_lib_is_build_load():
    from reporter_tpu_torch import native
    from reporter_tpu_torch.native import build

    assert native.load_native_lib is build.load
    assert native.lib is build.load()
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        getattr(native, "nope")


def test_a_bare_native_import_leaves_lib_unresolved():
    code = ("import sys, reporter_tpu_torch.native as n\n"
            "from reporter_tpu_torch.native import build\n"
            "assert 'lib' not in vars(n), 'lib resolved at import'\n"
            "assert build._loaded is None, 'the library was loaded'\n"
            "assert 'torch' not in sys.modules, 'torch'\n"
            "print('UNRESOLVED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "UNRESOLVED" in proc.stdout


def test_polyline_length_equals_the_jax_packages():
    rng = np.random.default_rng(21)
    for n in (0, 1, 2, 17, 500):
        pts = rng.normal(0, 800.0, (n, 2))
        assert pgeo.polyline_length(pts) == jgeo.polyline_length(pts)
    f32 = rng.normal(0, 800.0, (64, 2)).astype(np.float32)
    assert pgeo.polyline_length(f32) == jgeo.polyline_length(f32)
    assert pgeo.polyline_length([[0, 0], [3, 4]]) == 5.0


def test_great_circle_m_equals_the_jax_packages():
    rng = np.random.default_rng(22)
    a = np.stack([rng.uniform(-180, 180, 400), rng.uniform(-90, 90, 400)], 1)
    b = a + rng.normal(0, 0.05, a.shape)
    b[:40] = -a[:40]                 # antipodes and near-antipodes: h at 1
    b[40:80] = a[40:80]              # zero distances
    np.testing.assert_array_equal(pgeo.great_circle_m(a, b),
                                  jgeo.great_circle_m(a, b))
    np.testing.assert_array_equal(pgeo.great_circle_m(a[:3, None], b[None]),
                                  jgeo.great_circle_m(a[:3, None], b[None]))
    assert pgeo.great_circle_m(a[5], b[5]) == jgeo.great_circle_m(a[5], b[5])


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _points(t0, n):
    return [{"lat": 37.7 + 1e-4 * i, "lon": -122.4, "time": float(t0 + i)}
            for i in range(n)]


def _sequence(cache_cls):
    """retain / merge / drop / merge on two uuids, the clock advancing
    between steps, with dumps between them."""
    clock = _Clock()
    cache = cache_cls(ttl=30.0, max_points=4, clock=clock)
    out = []
    cache.retain("a", _points(0, 10), from_time=6.0)
    cache.retain("b", _points(0, 3), from_time=100.0)
    out.append(cache.dump())
    clock.t += 5.0
    out.append(cache.merge("a", _points(8, 5)))
    cache.drop("a")
    cache.drop("missing")
    out.append(cache.dump())
    clock.t += 5.0
    out.append(cache.merge("a", _points(8, 5)))
    out.append(cache.merge("b", _points(2, 3)))
    out.append(len(cache))
    return out


def test_partial_trace_cache_drop_equals_the_jax_packages():
    got, ref = _sequence(PartialTraceCache), _sequence(JCache)
    assert got == ref
    # the drop took "a" out: its merge is the new points alone
    assert got[3] == _points(8, 5) and got[5] == 1
    assert len(got[1]) > 5            # before the drop, the tail was merged
