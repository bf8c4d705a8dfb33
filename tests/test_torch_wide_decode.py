"""The decode past K = 64, on the CPU: a matcher with max_candidates = 96
against the JAX package's.

On a card K = 96 runs the Viterbi kernel's wide instance 1
(kernels/viterbi.cu) and the lattice's wide forward instance and the
backtrack's wider CTAs (kernels/lattice.cu), each held bit-equal to its
plain version in tests/test_torch_kernels_gpu.py; on the CPU the plain
versions run, which are held here to the JAX package on sf at a 150 m
search radius (sf's lists hold up to some 48 edges there, so the columns
past them are empty) and at 250 m (lists of up to some 90 edges: past
64, short of 96, so no list is cut).

Tolerances. ``match_many``'s records: tolerance 0 (``to_json()``), as
tests/test_torch_wide_k.py holds them at K = 64. ``match_topk``, the
terminal form (R = 1) and the exact one (R = K = 96): the ranked paths'
edges per point at tolerance 0; their offsets within 1e-3 m, the dense
candidates' tolerance (tests/test_torch_wide_k.py: XLA:CPU contracts
multiply-adds, the port does not); the scores within
tests/test_torch_topk.py's SCORE_RTOL for the same reason.
"""

import numpy as np
import pytest
import torch

from reporter_tpu.config import Config, MatcherParams
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet, synthesize_probe
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import MatcherParams as PMatcherParams
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.ops import hmm
from reporter_tpu_torch.ops import match as match_ops
from reporter_tpu_torch.tiles.tileset import TileSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

K = 96
RADII = (150.0, 250.0)
SCORE_RTOL = 2e-6      # tests/test_torch_topk.py's
OFFSET_ATOL = 1e-3     # tests/test_torch_wide_k.py's candidates'


@pytest.fixture(scope="module")
def sf():
    return compile_network(generate_city("sf"))


@pytest.fixture(scope="module", params=RADII, ids=["150m", "250m"])
def pair(sf, request):
    """sf, the JAX matcher and the port's CPU matcher at K = 96 and the
    radius."""
    params = dict(max_candidates=K, search_radius=request.param)
    jm = JSegmentMatcher(sf, Config(
        matcher_backend="jax",
        matcher=MatcherParams(candidate_backend="dense", **params)))
    arrays = {f: getattr(sf, f) for f in _ARRAY_FIELDS}
    ts = TileSet.from_arrays(sf.name, sf.meta.origin_lonlat, arrays)
    m = SegmentMatcher(ts, PMatcherParams(**params), device="cpu")
    return sf, jm, m


def test_k96_is_past_every_shared_instance(pair):
    """K = 96 plans the wide instances on a card; sf's lists fill past 64
    edges at 250 m (so the wide widths carry real candidates) and stay
    short of 96 at both radii."""
    sf, _, m = pair
    assert hmm.viterbi_plan(4, 64, K)["instance"] == 1
    assert hmm.lattice_plan(64, K, 1)["scratch_bytes"] > 0
    assert hmm.backtrack_plan(64, K, K)["threads"] > 96
    pr = synthesize_probe(sf, seed=5, num_points=40)
    pts = torch.from_numpy(pr.xy.astype(np.float32))[None]
    c = match_ops.batch_candidates(pts, torch.ones(pts.shape[:2],
                                                   dtype=torch.bool),
                                   m.tables, m.params, m.ts.meta)
    longest = int(c.valid.sum(-1).max())
    assert longest < K
    assert longest > 64 or m.params.search_radius == 150.0


def test_match_many_at_k96_records_equal(pair):
    """match_many on sf traces at K = 96 and the radius: the records equal
    the JAX matcher's (tolerance 0)."""
    sf, jm, m = pair
    fleet = synthesize_fleet(sf, 4, num_points=40, seed=26)
    traces = [JTrace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]
    ref = jm.match_many(traces)
    got = m.match_many([Trace(t.uuid, t.xy, t.times) for t in traces])
    assert len(got) == len(ref) == len(traces)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert [x.to_json() for x in g] == [x.to_json() for x in r], i
    assert sum(len(g) for g in got) > 0


@pytest.mark.parametrize("exact", [False, True], ids=["terminal", "exact"])
def test_match_topk_at_k96_equals_the_jax_package(pair, exact):
    """match_topk at K = 96 (R = 1, or R = K = 96 exact) on a probe: the
    same ranked paths (each point's edge), offsets within OFFSET_ATOL,
    the scores within SCORE_RTOL."""
    sf, jm, m = pair
    pr = synthesize_probe(sf, seed=5, num_points=40)
    xy = pr.xy.astype(np.float32)
    want = jm.match_topk(JTrace(uuid="u", xy=xy, times=pr.times),
                         exact=exact)
    got = m.match_topk(Trace(uuid="u", xy=xy, times=pr.times), exact=exact)
    assert len(got) == len(want) >= 2
    if exact:
        assert len(got) > 64
    for (gs, gp), (ws, wp) in zip(got, want):
        assert [p.edge for p in gp] == [p.edge for p in wp]
        np.testing.assert_allclose([p.offset for p in gp],
                                   [p.offset for p in wp], rtol=0,
                                   atol=OFFSET_ATOL)
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want],
                               rtol=SCORE_RTOL)
