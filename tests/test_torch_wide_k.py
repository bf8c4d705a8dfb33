"""The sweep past K = 16 (the card's wide instance), on the CPU: the
port's plain path against the JAX package at top-K widths the register
instances do not hold.

Radius. At the default 50 m no point of sf has more than 16 distinct
edges within reach, so a list past 16 is never evicted from; at 150 m
most points have more (PERF.md §6, PR 19), so these cases do evict.

Tolerances. Candidates: ``_assert_close`` of test_torch_dense_candidates
.py at the case's K and radius (per point the same edges except within
1e-4 m of a cut; per shared edge |Δdist| and |Δoffset| <= 1e-3 m: XLA:CPU
contracts multiply-adds, the port does not). The JAX Pallas body in
interpret mode: the same. Records through match_many: tolerance 0
(``to_json()``), as tests/test_torch_matcher.py holds them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reporter_tpu.config import Config, MatcherParams
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.ops import dense_candidates as jdc
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
import test_torch_dense_candidates as tdc
from reporter_tpu_torch.config import MatcherParams as PMatcherParams
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.ops import dense_candidates as dc
from reporter_tpu_torch.tiles.tileset import TileSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

WIDE_RADIUS = 150.0


@pytest.fixture(scope="module")
def sf():
    return compile_network(generate_city("sf"))


def _points(ts, rng, n_fleet=4):
    """Every 8th node (d = 0 ties), points 148-152 m from segment
    midpoints (cuts at the radius) and a small fleet's points."""
    mid = ((ts.seg_a + ts.seg_b) * 0.5)[rng.choice(len(ts.seg_a), 96)]
    ang = rng.uniform(0, 2 * np.pi, len(mid))
    r = rng.uniform(148.0, 152.0, len(mid))[:, None]
    edge_pts = mid + np.stack([np.cos(ang), np.sin(ang)], 1) * r
    fleet = np.concatenate(
        [p.xy for p in synthesize_fleet(ts, n_fleet, num_points=40, seed=2)])
    return np.concatenate([ts.node_xy[::8], edge_pts, fleet]).astype(
        np.float32)


@pytest.mark.parametrize("k", [17, 24, 32, 48])
def test_wide_k_candidates_match_the_jax_package(sf, monkeypatch, k):
    """find_candidates_dense at K past the register widths on sf at 150 m
    (the CPU path is the plain sweep; on the card the same K runs the
    wide instance, held bit-equal to it in tests/test_torch_kernels_gpu
    .py) against the JAX package's (_dense_jnp on the CPU)."""
    pts = _points(sf, np.random.default_rng(k))
    sp = dc.build_seg_pack(sf.seg_a, sf.seg_b, sf.seg_edge, sf.seg_off,
                           sf.seg_len)
    ref = jdc.find_candidates_dense(jnp.asarray(pts), (jnp.asarray(sp.pack),
                                                       jnp.asarray(sp.bbox)),
                                    WIDE_RADIUS, k)
    got = dc.find_candidates_dense(torch.from_numpy(pts),
                                   tuple(torch.from_numpy(x) for x in sp),
                                   WIDE_RADIUS, k)
    assert got.edge.shape == (len(pts), k)
    filled = (got.edge >= 0).sum(1)
    assert int(filled.max()) > dc.SWEEP_KS[-1], "no list past 16 fills"
    monkeypatch.setattr(tdc, "K", k)
    monkeypatch.setattr(tdc, "RADIUS", WIDE_RADIUS)
    dd, do, flips = tdc._assert_close(
        [np.asarray(x) for x in (ref.edge, ref.offset, ref.dist)],
        [x.numpy() for x in (got.edge, got.offset, got.dist)])
    print(f"K={k}: max|Δdist| {dd:.3g} m, max|Δoffset| {do:.3g} m, "
          f"{flips} cut flips, {int((filled == k).sum())} full lists")


def test_wide_k_matches_the_interpret_pallas_body(monkeypatch):
    """The JAX package's Pallas sweep (the two-level body, in interpret
    mode, as tests/test_torch_sweep_arms.py runs its arms) at K = 20 on
    the tiny city at 150 m, where lists past 16 fill, against the port."""
    from reporter_tpu.config import CompilerParams

    monkeypatch.setattr(jdc, "_INTERPRET", True)
    monkeypatch.setattr(jdc, "_SBLK", 128)
    monkeypatch.setattr(jdc, "_SUB", 64)
    monkeypatch.setattr(jdc, "_NJ_CAP", 8)
    ts = compile_network(generate_city("tiny", seed=11), CompilerParams())
    rng = np.random.default_rng(20)
    lo, hi = ts.node_xy.min(0), ts.node_xy.max(0)
    pts = np.concatenate([ts.node_xy[:64], rng.uniform(lo, hi, (64, 2))]
                         ).astype(np.float32)
    args = (ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off, ts.seg_len)
    jsp = jdc.build_seg_pack(*args, block=128)
    sp = dc.build_seg_pack(*args)
    k = 20
    ref = jdc.find_candidates_dense(jnp.asarray(pts),
                                    tuple(jnp.asarray(x) for x in jsp),
                                    WIDE_RADIUS, k)
    got = dc.find_candidates_dense(torch.from_numpy(pts),
                                   tuple(torch.from_numpy(x) for x in sp),
                                   WIDE_RADIUS, k)
    assert int((got.edge >= 0).sum(1).max()) > 16
    monkeypatch.setattr(tdc, "K", k)
    monkeypatch.setattr(tdc, "RADIUS", WIDE_RADIUS)
    tdc._assert_close(
        [np.asarray(x) for x in (ref.edge, ref.offset, ref.dist)],
        [x.numpy() for x in (got.edge, got.offset, got.dist)])


def test_match_many_at_k24_records_equal(sf):
    """match_many at max_candidates = 24 and a 120 m search radius on a
    few sf traces: the port's records equal the JAX matcher's
    (tolerance 0)."""
    params = dict(max_candidates=24, search_radius=120.0)
    jm = JSegmentMatcher(sf, Config(
        matcher_backend="jax",
        matcher=MatcherParams(candidate_backend="dense", **params)))
    arrays = {f: getattr(sf, f) for f in _ARRAY_FIELDS}
    ts = TileSet.from_arrays(sf.name, sf.meta.origin_lonlat, arrays)
    m = SegmentMatcher(ts, PMatcherParams(**params), device="cpu")
    fleet = synthesize_fleet(sf, 6, num_points=60, seed=24)
    traces = [JTrace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]
    ref = jm.match_many(traces)
    got = m.match_many([Trace(t.uuid, t.xy, t.times) for t in traces])
    assert len(got) == len(ref) == len(traces)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert [x.to_json() for x in g] == [x.to_json() for x in r], i
    assert sum(len(g) for g in got) > 0
