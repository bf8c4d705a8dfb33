"""The port's reach-table audit (tiles/reach_audit.py, over the port's
oracle) against the JAX package's (reporter_tpu/tiles/reach_audit.py):
``summary()`` equal (tolerance 0) on a plain tile, a starved one and a
turn-restricted one (private rows read through edge_reach_row, the
oracle in edge space), and the CLI line equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.netgen.synthetic import (
    add_random_restrictions as j_add_random_restrictions)
from reporter_tpu.netgen.synthetic import generate_city as j_generate_city
from reporter_tpu.netgen.traces import synthesize_fleet as j_fleet
from reporter_tpu.tiles.compiler import compile_network as j_compile_network
from reporter_tpu.tiles.reach_audit import audit_reach as j_audit_reach
from reporter_tpu.tiles.reach_audit import \
    node_coverage_radii as j_node_coverage_radii
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS as J_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
from reporter_tpu_torch.tiles.reach_audit import (audit_reach,
                                                  node_coverage_radii)
from reporter_tpu_torch.tiles.tileset import TileSet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CASES = {
    "plain": lambda: j_compile_network(
        j_generate_city("tiny", seed=5, nx=8, ny=8), JCompilerParams()),
    "starved": lambda: j_compile_network(
        j_generate_city("tiny", seed=5, nx=8, ny=8),
        JCompilerParams(reach_max=4, reach_radius=150.0)),
    "restricted": lambda: j_compile_network(
        j_add_random_restrictions(j_generate_city("tiny", seed=5, nx=8,
                                                  ny=8), fraction=0.3),
        JCompilerParams()),
}


@pytest.fixture(scope="module", params=sorted(_CASES))
def case(request):
    ref = _CASES[request.param]()
    ts = TileSet.from_arrays(ref.name, ref.meta,
                             {f: getattr(ref, f) for f in J_FIELDS})
    ts.stats = dict(ref.stats)
    fleet = [p.xy for p in j_fleet(ref, 6, num_points=80, seed=5)]
    return request.param, ref, ts, fleet


@pytest.mark.parametrize("stride", [1, 3])
def test_summary_equals_reference(case, stride):
    name, ref, ts, fleet = case
    traces = [xy[::stride] for xy in fleet]
    got = audit_reach(ts, traces)
    want = j_audit_reach(ref, traces)
    assert got.summary() == want.summary()
    assert got.missed_gaps == want.missed_gaps
    assert got.pairs_accepted_exact > 50
    if name == "starved":
        assert got.pairs_missed > 0
    if name == "restricted":
        assert len(ts.ban_from) and len(ts.reach_to) > ts.num_nodes


def test_coverage_radii_equal_reference(case):
    _, ref, ts, _ = case
    got, want = node_coverage_radii(ts), j_node_coverage_radii(ref)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_cli_line_equals_reference():
    """``python -m ...tiles.reach_audit tiny 4`` prints the JAX CLI's
    JSON line."""
    def run(mod):
        out = subprocess.run([sys.executable, "-m", mod, "tiny", "4"],
                             capture_output=True, text=True, timeout=300,
                             cwd=ROOT, env=dict(os.environ,
                                                JAX_PLATFORMS="cpu",
                                                PYTHONPATH=ROOT))
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout.strip().splitlines()[-1])

    got = run("reporter_tpu_torch.tiles.reach_audit")
    assert got == run("reporter_tpu.tiles.reach_audit")
    assert got["city"] == "tiny" and got["n_traces"] == 4
