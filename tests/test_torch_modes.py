"""Per-mode subgraphs in the port against the JAX package, at tolerance 0,
mirroring tests/test_modes.py: ``RoadNetwork.for_mode`` and
``fingerprint``, ``assign_mode_access``, per-mode compiles of the full
network (every array, the OSMLR ids shared across modes), the legacy
unqualified compile of a mixed network, per-mode records against the JAX
``SegmentMatcher``, ``Config.for_mode``, the app's mode tag and its 400,
and the full-graph OSMLR memo missing after a mutation.
"""

import dataclasses
import warnings

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen import network as jnet
from reporter_tpu.netgen import synthetic as jsyn
from reporter_tpu.service.app import make_app as j_make_app
from reporter_tpu.tiles.compiler import compile_network as j_compile
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import CompilerParams, Config, MatcherParams
from reporter_tpu_torch.geometry import xy_to_lonlat
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.netgen import network as pnet
from reporter_tpu_torch.netgen import synthetic as psyn
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.service.app import BadRequest, make_app
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import ARRAY_FIELDS

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CYCLEWAY_ID = 99
MODES = ("auto", "bicycle", "foot")


def _mode_city(pkg):
    """tests/test_modes.py's 3x3 grid: a street ring, vertical sides and a
    bike-and-foot cycleway across the middle (nodes 3-4-5)."""
    xy = np.array([[x, y] for y in (220.0, 0.0, -220.0)
                   for x in (-220.0, 0.0, 220.0)])
    ways = [pkg.Way(way_id=1, nodes=[0, 1, 2], name="top"),
            pkg.Way(way_id=2, nodes=[6, 7, 8], name="bottom"),
            pkg.Way(way_id=3, nodes=[0, 3, 6], name="west"),
            pkg.Way(way_id=4, nodes=[2, 5, 8], name="east"),
            pkg.Way(way_id=CYCLEWAY_ID, nodes=[3, 4, 5], name="cycle-cut",
                    speed_mps=5.6,
                    access_mask=pkg.ACCESS_BICYCLE | pkg.ACCESS_FOOT)]
    return pkg.RoadNetwork(
        node_lonlat=xy_to_lonlat(xy, np.array([-122.4, 37.75])),
        ways=ways, name="modecity")


def _mixed(pkg_syn, name="tiny", **kw):
    return pkg_syn.assign_mode_access(pkg_syn.generate_city(name), **kw)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _same_net(a, b):
    assert (a.name, a.mode) == (b.name, b.mode)
    assert _same(a.node_lonlat, b.node_lonlat)
    assert [(w.way_id, w.nodes, w.oneway, w.name, w.speed_mps,
             w.access_mask, sorted(w.geometry)) for w in a.ways] == \
        [(w.way_id, w.nodes, w.oneway, w.name, w.speed_mps, w.access_mask,
          sorted(w.geometry)) for w in b.ways]
    assert [(r.from_way, r.via_node, r.to_way, r.kind)
            for r in a.restrictions] == \
        [(r.from_way, r.via_node, r.to_way, r.kind) for r in b.restrictions]


def _same_tile(ts, jts):
    bad = [f for f in ARRAY_FIELDS if not _same(getattr(ts, f),
                                                getattr(jts, f))]
    assert not bad, bad
    assert ts.name == jts.name
    assert ts.meta.origin_lonlat == tuple(jts.meta.origin_lonlat)
    drop = ("compile_seconds", "grid_cells", "grid_overflow")
    assert {k: v for k, v in ts.stats.items() if k not in drop} == \
        {k: v for k, v in jts.stats.items() if k not in drop}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("net", ["modecity", "tiny+m+r"])
def test_for_mode_and_fingerprint_equal(net, mode):
    """The subgraph (ways, oneway cleared for foot, restrictions filtered,
    nodes compacted) and both fingerprints equal the JAX package's."""
    if net == "modecity":
        jn, pn = _mode_city(jnet), _mode_city(pnet)
        for n, pkg in ((jn, jnet), (pn, pnet)):
            n.ways[0].oneway = True
            n.restrictions.append(pkg.TurnRestriction(
                from_way=3, via_node=0, to_way=1, kind="no_turn"))
    else:
        jn = jsyn.add_random_restrictions(_mixed(jsyn, p_bike_only=0.2,
                                                 p_foot_only=0.2))
        pn = psyn.add_random_restrictions(_mixed(psyn, p_bike_only=0.2,
                                                 p_foot_only=0.2))
    assert pn.fingerprint() == jn.fingerprint()
    js, ps = jn.for_mode(mode), pn.for_mode(mode)
    _same_net(ps, js)
    assert ps.fingerprint() == js.fingerprint()
    if mode == "foot":
        assert not ps.restrictions and not any(w.oneway for w in ps.ways)


def test_for_mode_restrictions_and_errors():
    for pkg in (jnet, pnet):
        net = _mode_city(pkg)
        net.restrictions.append(pkg.TurnRestriction(
            from_way=CYCLEWAY_ID, via_node=3, to_way=3, kind="no_turn"))
        net.restrictions.append(pkg.TurnRestriction(
            from_way=3, via_node=0, to_way=1, kind="no_turn"))
        # a restriction on a dropped way is dropped
        assert len(net.for_mode("auto").restrictions) == 1
        assert len(net.for_mode("bicycle").restrictions) == 2
        assert net.for_mode("foot").restrictions == []
    with pytest.raises(ValueError, match="unknown mode"):
        _mode_city(pnet).for_mode("hovercraft")


@pytest.mark.parametrize("kw", [{}, dict(seed=21, p_bike_only=0.25,
                                         p_foot_only=0.15)])
def test_assign_mode_access_equal(kw):
    jn, pn = _mixed(jsyn, **kw), _mixed(psyn, **kw)
    _same_net(pn, jn)
    assert pn.name.endswith("+m")
    assert len({w.access_mask for w in pn.ways}) > 1


@pytest.fixture(scope="module", params=["modecity", "tiny+m", "tiny+m+r"])
def nets(request):
    if request.param == "modecity":
        return _mode_city(jnet), _mode_city(pnet)
    jn = _mixed(jsyn, p_bike_only=0.2, p_foot_only=0.15)
    pn = _mixed(psyn, p_bike_only=0.2, p_foot_only=0.15)
    if request.param.endswith("+r"):
        jsyn.add_random_restrictions(jn, 0.2)
        psyn.add_random_restrictions(pn, 0.2)
    return jn, pn


@pytest.fixture(scope="module")
def mode_tiles(nets):
    """{mode: (JAX tile, port tile)} compiled from the full network."""
    jn, pn = nets
    kw = dict(reach_radius=500.0, osmlr_max_length=200.0)
    return {m: (j_compile(jn, JCompilerParams(use_native=False, **kw),
                          mode=m),
                compile_network(pn, CompilerParams(**kw), mode=m))
            for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_mode_compile_equal(mode_tiles, mode):
    jts, ts = mode_tiles[mode]
    _same_tile(ts, jts)
    assert ts.stats["mode"] == mode


def test_osmlr_ids_shared_across_modes(mode_tiles):
    """A road's segment ids are the same in every mode's tile: one
    full-graph association, the same id and length tables."""
    tiles = {m: mode_tiles[m][1] for m in MODES}
    for m in MODES[1:]:
        assert _same(tiles[m].osmlr_id, tiles["auto"].osmlr_id)
        assert _same(tiles[m].osmlr_len, tiles["auto"].osmlr_len)

    by_way = {m: {} for m in MODES}
    for m, ts in tiles.items():
        for e, r in enumerate(ts.edge_osmlr):
            if r >= 0:
                by_way[m].setdefault(int(ts.edge_way[e]), set()).add(
                    int(ts.osmlr_id[r]))
    shared = set(by_way["auto"]) & set(by_way["bicycle"]) & set(
        by_way["foot"])
    assert shared
    for w in shared:
        # foot walks one-way streets both ways, so it may hold fewer
        # directional ids; never another id
        assert by_way["foot"][w] <= by_way["auto"][w] == \
            by_way["bicycle"][w], w


def test_mixed_network_compiles_its_auto_subgraph(nets):
    jn, pn = nets
    with pytest.warns(UserWarning, match="non-drivable"):
        ts = compile_network(pn, CompilerParams())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jts = j_compile(jn, JCompilerParams(use_native=False))
    _same_tile(ts, jts)
    assert all(w & pnet.ACCESS_AUTO for w in
               {w.access_mask for w in pn.ways if w.way_id in
                set(ts.edge_way.tolist())})


def test_prefiltered_and_all_foot_networks_compile_as_is():
    sub = _mode_city(pnet).for_mode("bicycle")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ts = compile_network(sub, CompilerParams())
    assert CYCLEWAY_ID in set(ts.edge_way.tolist()) and "mode" not in ts.stats
    _same_tile(ts, j_compile(_mode_city(jnet).for_mode("bicycle"),
                             JCompilerParams(use_native=False)))
    net = _mode_city(pnet)
    for w in net.ways:
        w.access_mask = pnet.ACCESS_FOOT
    assert CYCLEWAY_ID in set(compile_network(net).edge_way.tolist())


def test_osmlr_memo_misses_after_a_mutation():
    net = _mode_city(pnet)
    a1 = compile_network(net, CompilerParams(), mode="auto")
    net.ways.append(pnet.Way(way_id=7, nodes=[1, 4], name="new-cut"))
    a2 = compile_network(net, CompilerParams(), mode="auto")
    assert a2.num_edges == a1.num_edges + 2
    assert (a2.edge_osmlr[a2.edge_way == 7] >= 0).all()
    jn = _mode_city(jnet)
    jn.ways.append(jnet.Way(way_id=7, nodes=[1, 4], name="new-cut"))
    _same_tile(a2, j_compile(jn, JCompilerParams(use_native=False),
                             mode="auto"))


def _traces(ts, n=10):
    return [Trace(p.uuid, p.xy.astype(np.float32), p.times)
            for p in synthesize_fleet(ts, n, num_points=60, seed=5,
                                      gps_sigma=3.0)]


@pytest.mark.parametrize("mode", MODES)
def test_mode_records_equal_jax_matcher(mode_tiles, mode):
    """A fleet driven on the mode's tile, matched with the mode's preset:
    the port's records equal the JAX SegmentMatcher's."""
    jts, ts = mode_tiles[mode]
    traces = _traces(ts)
    got = SegmentMatcher(ts, Config.for_mode(mode),
                         device="cpu").match_many(traces)
    jcfg = JConfig.for_mode(mode)
    jm = JSegmentMatcher(jts, dataclasses.replace(
        jcfg, matcher=dataclasses.replace(jcfg.matcher,
                                          candidate_backend="dense")))
    want = jm.match_many([JTrace(t.uuid, t.xy, t.times) for t in traces])
    assert [[r.to_json() for r in x] for x in got] == \
        [[r.to_json() for r in x] for x in want]
    assert sum(len(x) for x in got) > 0


def test_bike_trace_uses_the_cycleway_only_in_the_bicycle_tile():
    pn = _mode_city(pnet)
    rng = np.random.default_rng(5)
    x = np.linspace(-215.0, 215.0, 60)
    pts = np.stack([x, np.zeros(60)], axis=1) + rng.normal(0.0, 2.0, (60, 2))
    tr = Trace("bike-1", pts.astype(np.float32), np.arange(60, dtype=float))
    ways = {}
    for mode in ("auto", "bicycle"):
        ts = compile_network(pn, CompilerParams(), mode=mode)
        recs = SegmentMatcher(ts, Config.for_mode(mode),
                              device="cpu").match_many([tr])[0]
        ways[mode] = {w for r in recs for w in r.way_ids}
    assert CYCLEWAY_ID in ways["bicycle"]
    assert CYCLEWAY_ID not in ways["auto"] and ways["auto"] <= {1, 2, 3, 4}


def test_config_for_mode():
    for mode in MODES:
        cfg = Config.for_mode(mode).validate()
        assert cfg.service.mode == mode
        assert cfg.matcher == MatcherParams.preset(mode)
        jcfg = JConfig.for_mode(mode)
        assert Config.from_json(jcfg.to_json()).validate() == cfg
    with pytest.raises(ValueError):
        Config.for_mode("warp")


def test_app_mode_tag_and_400(mode_tiles):
    jts, ts = mode_tiles["bicycle"]
    app = make_app(ts, Config.for_mode("bicycle"), device="cpu")
    japp = j_make_app(jts, JConfig.for_mode("bicycle"))
    try:
        p = synthesize_fleet(ts, 1, num_points=40, seed=2)[0].to_report_json()
        got = app.report_one(dict(p, mode="bicycle"))
        assert got["mode"] == "bicycle"
        assert got == japp.report_one(dict(p, mode="bicycle"))
        assert app.report_one(p)["mode"] == "bicycle"     # untagged passes
        with pytest.raises(BadRequest, match="bicycle"):
            app.report_one(dict(p, mode="auto"))
        m = SegmentMatcher(ts, Config.for_mode("bicycle"), device="cpu")
        assert m.match(p)["mode"] == "bicycle"
    finally:
        app.close()
        japp.close()
