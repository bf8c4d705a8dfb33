"""Turn-restricted tiles in the port against the JAX package, at tolerance
0: the banned pairs and every TileSet array (the private ban-aware reach
rows and ``edge_reach_row`` among them), the edge-space search, the
hybrid build against a full edge-space rebuild, the oracle's banned
search, legal fleets, ``match_many`` records and the walks on R = N + F
rows.

Fixtures: tests/test_restrictions.py's T-grid (a ``no_left_turn`` that
forces a detour round the east block, a ``no_u_turn`` at its corner, and
an ``only_straight_on``), and ``add_random_restrictions`` over
``generate_city("tiny")`` at the default density and at 0.3.
"""

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.matcher import cpu_reference as jref
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen import network as jnet
from reporter_tpu.netgen import synthetic as jsyn
from reporter_tpu.netgen.traces import synthesize_fleet as j_fleet
from reporter_tpu.tiles import reach as jreach
from reporter_tpu.tiles.compiler import compile_network as j_compile
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads,
    fresh_link_sampler)
from reporter_tpu_torch.config import CompilerParams, Config
from reporter_tpu_torch.matcher import cpu_reference as ref
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace, walk_python
from reporter_tpu_torch.matcher.segments import reach_route_fn
from reporter_tpu_torch.netgen import network as pnet
from reporter_tpu_torch.netgen import synthetic as psyn
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.tiles import reach
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import ARRAY_FIELDS

pytestmark = pytest.mark.usefixtures("few_torch_threads")

K = 100.0 / 111319.49079327358     # ~100 m in degrees at lat 0
# T-grid (meters): node i at _NODES[i]; ways (id, nodes)
_NODES = [(0, 100), (100, 100), (200, 100), (100, 0), (100, 200),
          (100, 300), (200, 200)]
_WAYS = [(1, [0, 1]), (2, [3, 1, 4]), (4, [4, 5]), (6, [1, 2]),
         (3, [4, 6]), (5, [2, 6])]
# (from way, via node, to way, kind)
_TGRID = {
    "no_left+no_u": [(1, 1, 2, "no_left_turn"), (6, 2, 6, "no_u_turn")],
    "only_straight": [(1, 1, 6, "only_straight_on")],
}


def _tgrid(pkg, rules):
    nodes = np.array([[x * K / 100.0, y * K / 100.0] for x, y in _NODES])
    ways = [pkg.Way(way_id=w, nodes=list(n), speed_mps=13.4)
            for w, n in _WAYS]
    return pkg.RoadNetwork(
        node_lonlat=nodes, ways=ways, name="tgrid",
        restrictions=[pkg.TurnRestriction(*r) for r in rules])


def _nets(case):
    """(JAX network, port network) of a case."""
    if case in _TGRID:
        return _tgrid(jnet, _TGRID[case]), _tgrid(pnet, _TGRID[case])
    frac = 0.3 if case == "tiny+r0.3" else 0.08
    return (jsyn.add_random_restrictions(jsyn.generate_city("tiny"), frac),
            psyn.add_random_restrictions(psyn.generate_city("tiny"), frac))


CASES = ["no_left+no_u", "only_straight", "tiny+r", "tiny+r0.3"]


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.fixture(scope="module", params=CASES)
def tiles(request):
    """(case, JAX tile, port tile), each package compiling its own
    network with the Python builders."""
    jn, pn = _nets(request.param)
    kw = dict(reach_radius=500.0, osmlr_max_length=200.0)
    return (request.param,
            j_compile(jn, JCompilerParams(use_native=False, **kw)),
            compile_network(pn, CompilerParams(use_native=False, **kw)))


def _stats(ts):
    return {k: v for k, v in ts.stats.items()
            if k not in ("compile_seconds", "grid_cells", "grid_overflow")}


def test_every_array_equal(tiles):
    case, jts, ts = tiles
    bad = [f for f in ARRAY_FIELDS if not _same(getattr(ts, f),
                                                getattr(jts, f))]
    assert not bad, bad
    assert _stats(ts) == _stats(jts)
    assert ts.ban_set == jts.ban_set and ts.ban_set
    # one private row per from-edge, after the node rows
    from_edges = sorted({a for a, _ in ts.ban_set})
    assert len(ts.reach_to) == ts.num_nodes + len(from_edges)
    assert [int(ts.edge_reach_row[e]) for e in from_edges] == \
        list(range(ts.num_nodes, len(ts.reach_to)))


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "c"])
def test_compile_with_either_builder_equals_reference(use_native):
    """The hybrid build over the C++ node rows and over the Python ones
    give the JAX package's arrays."""
    jn, pn = _nets("tiny+r0.3")
    jts = j_compile(jn, JCompilerParams(use_native=False))
    ts = compile_network(pn, CompilerParams(use_native=use_native))
    bad = [f for f in ARRAY_FIELDS if not _same(getattr(ts, f),
                                                getattr(jts, f))]
    assert not bad, bad


def test_only_bans_every_other_exit():
    """only_straight_on from way 1 at X bans every exit but way 6's."""
    jn, pn = _nets("only_straight")
    jts = j_compile(jn, JCompilerParams(use_native=False))
    ts = compile_network(pn, CompilerParams())
    assert ts.ban_set == jts.ban_set
    (e_from,) = {a for a, _ in ts.ban_set}
    x = int(ts.edge_dst[e_from])
    outs = {int(e) for e in ts.node_out[x] if e >= 0}
    allowed = outs - {b for _, b in ts.ban_set}
    assert [int(ts.edge_way[e]) for e in allowed] == [6]


def test_edge_space_targets_equal(tiles):
    _, jts, ts = tiles
    rng = np.random.default_rng(3)
    for _ in range(12):
        seeds = sorted({int(x) for x in rng.integers(0, ts.num_edges, 3)})
        for radius in (150.0, 600.0):
            got = reach.edge_space_targets(seeds, ts.node_out, ts.edge_dst,
                                           ts.edge_len, radius, ts.ban_set)
            assert got == jreach.edge_space_targets(
                seeds, jts.node_out, jts.edge_dst, jts.edge_len, radius,
                jts.ban_set)


def test_hybrid_build_equals_full_edge_space_rebuild(tiles):
    """The compile rebuilds only the ball of node rows around the via
    nodes on top of the node-space rows; a full edge-space rebuild gives
    the same distances, rows and row map (next hops may differ only
    between equal-cost first edges), here and in the JAX package."""
    _, jts, ts = tiles
    banned = np.stack([ts.ban_from, ts.ban_to], axis=1)
    args = (ts.node_out, ts.edge_src, ts.edge_dst, ts.edge_len, 500.0, 128,
            banned)
    full = reach.build_reach_tables_restricted(*args)
    jfull = jreach.build_reach_tables_restricted(*args)
    for got, want in zip(full, jfull):
        assert _same(got, want) if isinstance(got, np.ndarray) \
            else got == want
    assert _same(ts.reach_to, full[0])
    assert _same(ts.reach_dist, full[1])
    assert _same(ts.edge_reach_row, full[4])
    for e in range(ts.num_edges):
        for e2 in ts.reach_to[ts.edge_reach_row[e]][:4]:
            assert reach.reach_lookup(ts.reach_to, ts.reach_dist,
                                      ts.edge_reach_row, e, int(e2)) == \
                jreach.reach_lookup(jts.reach_to, jts.reach_dist,
                                    jts.edge_reach_row, e, int(e2))


def test_oracle_banned_search_equal(tiles):
    """edge_dijkstra searches edge space on a restricted tile: labels
    equal the JAX oracle's, and every path it rebuilds is legal."""
    _, jts, ts = tiles
    for e in range(ts.num_edges):
        for bound in (120.0, 900.0):
            got = ref.edge_dijkstra(ts, e, bound)
            assert got == jref.edge_dijkstra(jts, e, bound)
            for e2 in got:
                path = [e, *ref.walk_prev(got, e2), e2]
                assert not any(p in ts.ban_set for p in zip(path, path[1:]))
    cache, jcache = ref.DijkstraCache(8), jref.DijkstraCache(8)
    for e in (0, 3, 0, 5, 3, 1, 2, 0):
        assert cache.reached(ts, e % ts.num_edges, 700.0) == \
            jcache.reached(jts, e % jts.num_edges, 700.0)
    assert (cache.searches, cache.hits) == (jcache.searches, jcache.hits)


def test_tgrid_detour_distance():
    """The no_left_turn's from-edge reaches the banned exit only round
    the east block (~400 m), in the tables and in the oracle; another
    approach reaches it directly."""
    _, ts = [j_compile(_nets("no_left+no_u")[0], JCompilerParams()),
             compile_network(_nets("no_left+no_u")[1], CompilerParams())]
    w1_in = next(a for a, _ in ts.ban_set if int(ts.edge_way[a]) == 1)
    n_up = next(b for a, b in ts.ban_set if a == w1_in
                and ts.node_xy[ts.edge_dst[b], 1] > ts.node_xy[
                    ts.edge_src[b], 1])
    d = reach.reach_lookup(ts.reach_to, ts.reach_dist, ts.edge_reach_row,
                           w1_in, n_up)
    assert 350.0 < d < 450.0
    assert 350.0 < ref.edge_dijkstra(ts, w1_in, 600.0)[n_up][0] < 450.0


def test_legal_fleets_equal(tiles):
    case, jts, ts = tiles
    got = synthesize_fleet(ts, 12, num_points=60, seed=4)
    want = j_fleet(jts, 12, num_points=60, seed=4)
    for a, b in zip(got, want):
        for f in ("lonlat", "xy", "times", "true_edges", "true_offsets",
                  "path_edges"):
            assert _same(getattr(a, f), getattr(b, f)), f
        p = [int(e) for e in a.path_edges]
        assert not any(x in ts.ban_set for x in zip(p, p[1:])), case


def _fleet(ts, n=12):
    return [Trace(p.uuid, p.xy.astype(np.float32), p.times)
            for p in synthesize_fleet(ts, n, num_points=80, seed=9,
                                      gps_sigma=4.0)]


@pytest.mark.parametrize("backend", ["torch", "reference_cpu"])
def test_match_many_equals_jax_matcher(tiles, backend):
    """The port's match_many on the CPU (and its reference_cpu oracle, the
    watchdog's fallback and the audit's reference) against the JAX
    SegmentMatcher's dense path (and its oracle), record for record."""
    _, jts, ts = tiles
    traces = _fleet(ts)
    m = SegmentMatcher(ts, Config(matcher_backend=backend), device="cpu")
    got = m.match_many(traces)
    jb = "jax" if backend == "torch" else backend
    jm = JSegmentMatcher(jts, JConfig(
        matcher_backend=jb, matcher=JMatcherParams(candidate_backend="dense")))
    want = jm.match_many([JTrace(t.uuid, t.xy, t.times) for t in traces])
    assert [[r.to_json() for r in x] for x in got] == \
        [[r.to_json() for r in x] for x in want]
    assert sum(len(x) for x in got) > 0


def test_tgrid_match_routes_round_the_ban():
    """A two-point trace from W1 to north of X: on the restricted tile the
    port routes round the east block (way 5), as its oracle and the JAX
    matcher do; on the unrestricted tile it turns left."""
    from reporter_tpu_torch.geometry import lonlat_to_xy

    jn, pn = _nets("no_left+no_u")
    ts = compile_network(pn, CompilerParams())
    xy = np.asarray([lonlat_to_xy(np.asarray([x * K / 100.0, y * K / 100.0]),
                                  np.asarray(ts.meta.origin_lonlat))
                     for x, y in ((40, 100), (100, 260))], np.float32)
    times = np.array([0.0, 12.0])

    def run(ts, backend):
        m = SegmentMatcher(ts, Config(matcher_backend=backend),
                           device="cpu")
        return [r.to_json() for r in m.match_many([Trace("t", xy, times)])[0]]

    dev = run(ts, "torch")
    # the oracle is float64: the same segments, lengths within f32 rounding
    assert [r["segment_id"] for r in dev] == \
        [r["segment_id"] for r in run(ts, "reference_cpu")]
    assert 5 in {w for r in dev for w in r["way_ids"]}
    jm = JSegmentMatcher(j_compile(jn, JCompilerParams()), JConfig(
        matcher=JMatcherParams(candidate_backend="dense")))
    assert dev == [r.to_json() for r in
                   jm.match_many([JTrace("t", xy, times)])[0]]
    pn.restrictions = []
    free = run(compile_network(pn, CompilerParams()), "torch")
    assert 5 not in {w for r in free for w in r["way_ids"]}


def test_c_walk_equals_python_walk_on_private_rows(tiles):
    """The decoded paths cross from-edges, whose transitions read private
    rows: the C walk equals the Python walk record for record, and no
    rebuilt path inside a chain takes a banned turn."""
    _, _, ts = tiles
    traces = _fleet(ts, 16)
    m = SegmentMatcher(ts, device="cpu")
    decoded = m._decode_many(traces)
    c = m._walk_decoded(traces, decoded)
    py = walk_python(ts, traces, decoded, m._route_fn,
                     m.params.backward_slack)
    assert [[r.to_json() for r in x] for x in c] == \
        [[r.to_json() for r in x] for x in py]
    route = reach_route_fn(ts)
    from_edges = {a for a, _ in ts.ban_set}
    private = banned = 0
    for edges, _, starts in decoded:
        for i in range(1, len(edges)):
            e1, e2 = int(edges[i - 1]), int(edges[i])
            if e1 < 0 or e2 < 0 or starts[i] or e1 == e2:
                continue
            mid = route(e1, e2)
            assert mid is not None
            path = [e1, *mid, e2]
            private += sum(e in from_edges for e in path[:-1])
            banned += sum(p in ts.ban_set for p in zip(path, path[1:]))
    assert banned == 0
    assert private > 0


def test_watchdog_fallback_and_audit_honour_bans(fresh_link_sampler):
    """The dispatch watchdog's reference_cpu fallback and the shadow audit
    reach the oracle through edge_dijkstra, so on a restricted tile they
    search edge space with no change of their own: the fallback's records
    equal the JAX oracle's, and the audit counts the JAX audit's
    disagreement."""
    from reporter_tpu.quality import audit as jaudit
    from reporter_tpu_torch import faults
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.quality import audit

    jn, pn = _nets("tiny+r0.3")
    kw = dict(reach_radius=500.0, osmlr_max_length=200.0)
    jts = j_compile(jn, JCompilerParams(**kw))
    ts = compile_network(pn, CompilerParams(**kw))
    traces = _fleet(ts, 4)
    jtraces = [JTrace(t.uuid, t.xy, t.times) for t in traces]
    m = SegmentMatcher(ts, Config(matcher=MatcherParams(
        dispatch_timeout_s=2.0, dispatch_fallback="reference_cpu")),
        device="cpu")
    with faults.use(faults.FaultPlan.parse("dispatch:hang(5)@0-")):
        got = m.match_many(traces)
    assert m.metrics.value("dispatch_fallback") == 1
    oracle = JSegmentMatcher(jts, JConfig(matcher_backend="reference_cpu"))
    assert [[r.to_json() for r in x] for x in got] == \
        [[r.to_json() for r in x] for x in oracle.match_many(jtraces)]
    stats = []
    jm = JSegmentMatcher(jts, JConfig(matcher=JMatcherParams(
        candidate_backend="dense")))
    for mod, matcher, tr in ((audit, SegmentMatcher(ts, device="cpu"),
                              traces), (jaudit, jm, jtraces)):
        a = mod.ShadowAuditor(rate=1.0, max_traces=2, timeout_s=60.0,
                              duty_pct_cap=100.0, min_interval_s=0.0)
        try:
            assert a.maybe_audit(matcher, tr, matcher.match_many(tr))
            assert a.drain(60.0)
            stats.append({k: a.stats()[k] for k in (
                "audited_batches", "audited_traces", "disagreement_rate")})
        finally:
            a.stop()
    assert stats[0] == stats[1] and stats[0]["audited_traces"] == 2
