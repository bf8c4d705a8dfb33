"""The grid candidate backend: the port's spatial grid (its Python fill and
its C++ fill), ``build_cell_pack`` and the cell-row gather against the
JAX package's (reporter_tpu), and against the port's own dense sweep.

Tolerances: the grid, the cell pack, the metadata and every edge set are
equal (tolerance 0). Distances and offsets of the gather are held to
``DIST_ULPS`` f32 ulps of the JAX package's: XLA:CPU may fuse the
multiply-adds the port rounds one by one (ROADMAP queue 3); the largest
difference measured on these fixtures is 0 ulps. One deliberate
difference is pinned as such: the port ranks a cell's segments by the
squared distance, as both dense sweeps do, where the JAX grid ranks by
the rounded distance; the two differ only where a K-th-place tie exists
in the rounded distance alone (44 of sf's 122,880 fleet points by the
JAX rule against the dense sweep, 0 by the port's; queue 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.netgen.synthetic import generate_city as j_generate_city
from reporter_tpu.netgen.traces import synthesize_fleet as j_fleet
from reporter_tpu.ops.candidates import \
    find_candidates_trace as j_find_candidates_trace
from reporter_tpu.tiles.compiler import _build_grid as j_build_grid
from reporter_tpu.tiles.compiler import compile_network as j_compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS as J_FIELDS
from reporter_tpu.tiles.tileset import build_cell_pack as j_build_cell_pack
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import (CompilerParams, Config,
                                       MatcherParams)
from reporter_tpu_torch.matcher import autotune
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.ops.candidates import (as_grid_meta, find_candidates,
                                               find_candidates_trace)
from reporter_tpu_torch.ops.dense_candidates import find_candidates_dense
from reporter_tpu_torch.ops.match import batch_candidates
from reporter_tpu_torch.tiles.compiler import _build_grid, compile_network
from reporter_tpu_torch.tiles.tileset import (ARRAY_FIELDS, TileSet,
                                              build_cell_pack,
                                              tables_from_numpy)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

DIST_ULPS = 4
_FIXED = ("edge_len", "reach_row", "reach_to", "reach_dist")
_DENSE = ("seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
          "seg_coarse")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.fixture(scope="module")
def jts():
    """tests/test_dense_candidates.py's tile: tiny, seed 11."""
    return j_compile_network(j_generate_city("tiny", seed=11),
                             JCompilerParams())


def _both_tables(ts):
    """The dense staging and the grid staging of one tile in one dict."""
    return {**tables_from_numpy(ts.arrays(), "cpu", "dense"),
            **tables_from_numpy(ts.arrays(), "cpu", "grid")}


@pytest.fixture(scope="module")
def port(jts):
    ts = TileSet.from_arrays(jts.name, jts.meta,
                             {f: getattr(jts, f) for f in J_FIELDS})
    return ts, _both_tables(ts)


def _fleet_points(ts, b, t, seed=5):
    return np.stack([p.xy for p in j_fleet(ts, b, num_points=t, seed=seed)]
                    ).astype(np.float32).reshape(-1, 2)


def _edge_sets(edge):
    return [frozenset(int(e) for e in row if e >= 0) for row in edge]


@pytest.mark.parametrize("city", ["tiny", "sf"])
@pytest.mark.parametrize("cell,cap,radius", [(64.0, 64, 50.0),
                                             (100.0, 32, 25.0),
                                             (48.0, 8, 0.0)])
@pytest.mark.parametrize("native", [False, True], ids=["python", "cxx"])
def test_build_grid_equals_reference(city, cell, cap, radius, native):
    """The Python fill and the C++ fill against the JAX package's Python
    fill (the JAX package's own test cases): grid, dims, origin and the
    dropped-registration count equal."""
    ts = j_compile_network(j_generate_city(city),
                           JCompilerParams(use_native=False))
    want = j_build_grid(ts.seg_a, ts.seg_b, cell, cap, radius,
                        use_native=False)
    got = _build_grid(ts.seg_a, ts.seg_b, cell, cap, radius,
                      use_native=native)
    assert _same(got[0], want[0])
    assert got[1] == want[1] and _same(got[2], want[2])
    assert got[3] == want[3]
    if cap == 8:
        assert got[3] > 0           # this case overflows: the count is held


def test_compile_doubles_capacity_as_the_reference(recwarn):
    """A starting capacity that overflows doubles until clean, as in the
    JAX compile: the same grid, metadata and stats."""
    kw = dict(cell_size=96.0, cell_capacity=4, index_radius=60.0)
    ts = compile_network(generate_city("tiny"), CompilerParams(**kw))
    ref = j_compile_network(j_generate_city("tiny"),
                            JCompilerParams(use_native=False, **kw))
    assert ts.grid.shape[1] > 4 and ts.stats["grid_overflow"] == 0
    assert _same(ts.grid, ref.grid)
    assert tuple(ts.meta) == tuple(ref.meta)
    drop = ("compile_seconds",)
    assert ({k: v for k, v in ts.stats.items() if k not in drop}
            == {k: v for k, v in ref.stats.items() if k not in drop})


@pytest.mark.parametrize("city", ["tiny", "sf"])
def test_build_cell_pack_byte_equal(city):
    ref = j_compile_network(j_generate_city(city), JCompilerParams())
    args = (ref.grid, ref.seg_a, ref.seg_b, ref.seg_edge, ref.seg_off,
            ref.seg_len)
    got = build_cell_pack(*args)
    assert _same(got, j_build_cell_pack(*args))
    host = ref.host_tables("grid")["cell_pack"]
    tab = tables_from_numpy({f: getattr(ref, f) for f in J_FIELDS}, "cpu",
                            "grid")
    assert _same(tab["cell_pack"].numpy(), host)
    assert not any(k in tab for k in _DENSE)


def test_dense_tables_unchanged_by_the_grid(port):
    """The dense staging (the default, and "auto") holds no cell_pack and
    the segment pack as build_seg_pack makes it; the grid staging holds
    cell_pack and no segment pack; the per-edge and reach tables of the
    two are equal bit for bit. Any other backend name raises."""
    from reporter_tpu_torch.ops.dense_candidates import build_seg_pack

    ts, _ = port
    dense = tables_from_numpy(ts.arrays(), "cpu")
    auto = tables_from_numpy(ts.arrays(), "cpu", "auto")
    grid = tables_from_numpy(ts.arrays(), "cpu", "grid")
    assert list(dense) == list(auto) == [*_FIXED, *_DENSE]
    assert list(grid) == [*_FIXED, "cell_pack"]
    sp = build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                        ts.seg_len)
    for k in _DENSE:
        want = getattr(sp, k.removeprefix("seg_"))
        assert _same(dense[k].numpy(), want), k
        assert _same(auto[k].numpy(), want), k
    for k in _FIXED:
        assert _same(dense[k].numpy(), grid[k].numpy()), k
    with pytest.raises(ValueError, match="candidate_backend"):
        tables_from_numpy(ts.arrays(), "cpu", "both")


def test_find_candidates_trace_equals_reference(jts, port):
    """The cell-row gather on the same tile and points as the JAX
    package's: validity equal; edge sets equal except at a K-th-place tie
    of the rounded distance (3 of these 480 points), where the port's set
    is the dense sweep's and the distance multiset is the JAX grid's;
    each shared candidate's distance and offset within DIST_ULPS."""
    ts, tab = port
    pts = _fleet_points(jts, 8, 60)
    want = j_find_candidates_trace(jnp.asarray(pts),
                                   jts.device_tables("grid"), jts.meta,
                                   50.0, 8)
    got = find_candidates_trace(torch.from_numpy(pts), tab, ts.meta, 50.0, 8)
    dense = find_candidates_dense(torch.from_numpy(pts),
                                  tuple(tab[k] for k in _DENSE), 50.0, 8)
    wv = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), wv)
    assert wv.sum() > len(pts)
    gs, ws = _edge_sets(got.edge.numpy()), _edge_sets(np.asarray(want.edge))
    ties = [i for i in range(len(pts)) if gs[i] != ws[i]]
    assert len(ties) == 3, ties
    for i in ties:
        wd = np.asarray(want.dist[i])[wv[i]]
        kth = wd.max()
        for e, d in zip(np.asarray(want.edge[i]), np.asarray(want.dist[i])):
            if int(e) in ws[i] - gs[i]:
                assert d == kth
        for e, d in zip(got.edge[i].numpy(), got.dist[i].numpy()):
            if int(e) in gs[i] - ws[i]:
                assert d == kth
        assert gs[i] == _edge_sets(dense.edge[i:i + 1].numpy())[0]
        np.testing.assert_array_equal(
            np.sort(got.dist[i].numpy()[wv[i]]), np.sort(wd))
    # per edge: distance and offset of the same candidate
    for i in range(len(pts)):
        w = {int(e): (d, o) for e, d, o in zip(
            np.asarray(want.edge[i]), np.asarray(want.dist[i]),
            np.asarray(want.offset[i])) if e >= 0}
        for e, d, o in zip(got.edge[i].numpy(), got.dist[i].numpy(),
                           got.offset[i].numpy()):
            if int(e) in w:
                wd, wo = w[int(e)]
                np.testing.assert_array_max_ulp(d, wd, DIST_ULPS)
                np.testing.assert_array_max_ulp(o, wo, DIST_ULPS)


def test_grid_matches_dense(port, jts):
    """tests/test_dense_candidates.py:65 on the port: the same edge sets
    and distance multisets as the port's dense sweep."""
    ts, tab = port
    pts = torch.from_numpy(_fleet_points(jts, 4, 40))
    dense = find_candidates_dense(pts, tuple(tab[k] for k in _DENSE),
                                  50.0, 8)
    grid = find_candidates(pts, tab, ts.meta, 50.0, 8)
    assert _edge_sets(dense.edge.numpy()) == _edge_sets(grid.edge.numpy())
    for i in range(len(pts)):
        dv, gv = dense.valid[i].numpy(), grid.valid[i].numpy()
        np.testing.assert_allclose(np.sort(dense.dist[i].numpy()[dv]),
                                   np.sort(grid.dist[i].numpy()[gv]),
                                   rtol=1e-5, atol=1e-3, err_msg=str(i))


def test_ties_rank_by_squared_distance():
    """A point whose K-th place is a tie in the rounded distance alone:
    the JAX grid takes the smaller edge id, the port (as the dense sweep)
    the smaller squared distance; the candidate sets are equal before the
    K-th place and every distance is equal."""
    ref = j_compile_network(j_generate_city("tiny"),
                            JCompilerParams(use_native=False))
    pts = _fleet_points(ref, 16, 60)[832:833]   # such a point (tiny fleet)
    ts = TileSet.from_arrays(ref.name, ref.meta,
                             {f: getattr(ref, f) for f in J_FIELDS})
    tab = _both_tables(ts)
    got = find_candidates(torch.from_numpy(pts), tab, ts.meta, 50.0, 8)
    dense = find_candidates_dense(torch.from_numpy(pts),
                                  tuple(tab[k] for k in _DENSE), 50.0, 8)
    want = j_find_candidates_trace(jnp.asarray(pts),
                                   ref.device_tables("grid"), ref.meta,
                                   50.0, 8)
    assert _edge_sets(got.edge.numpy()) == _edge_sets(dense.edge.numpy())
    je = np.asarray(want.edge)[0]
    assert list(got.edge[0].numpy()[:6]) == list(je[:6])
    assert set(got.edge[0].numpy()) != set(je)
    np.testing.assert_array_equal(np.sort(got.dist.numpy()),
                                  np.sort(np.asarray(want.dist)))


def test_grid_matcher_records_equal_dense():
    """A grid matcher and a dense matcher over one tile give equal
    records; the grid matcher stages cell_pack and no segment pack."""
    ts = compile_network(generate_city("tiny"),
                         CompilerParams(reach_radius=500.0,
                                        osmlr_max_length=200.0))
    fleet = synthesize_fleet(ts, 12, num_points=60, seed=4)
    traces = [Trace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]
    grid = SegmentMatcher(ts, MatcherParams(candidate_backend="grid"),
                          device="cpu")
    dense = SegmentMatcher(ts, device="cpu")
    assert "cell_pack" in grid.tables and "seg_pack" not in grid.tables
    assert "cell_pack" not in dense.tables
    want = [[r.to_json() for r in x] for x in dense.match_many(traces)]
    got = [[r.to_json() for r in x] for x in grid.match_many(traces)]
    assert got == want and sum(map(len, got)) > 0
    assert grid.tuned_plan is None


def test_grid_coverage_is_checked(port):
    """A search radius past the tile's index_radius raises at dispatch,
    and Config.validate refuses it against the compiler's."""
    ts, tab = port
    pts = torch.zeros((1, 4, 2))
    valid = torch.ones((1, 4), dtype=torch.bool)
    p = MatcherParams(candidate_backend="grid", search_radius=80.0)
    with pytest.raises(ValueError, match="index_radius"):
        batch_candidates(pts, valid, tab, p, ts.meta)
    with pytest.raises(ValueError, match="index_radius"):
        Config(matcher=p).validate()
    assert Config(matcher=p, compiler=CompilerParams(index_radius=80.0)
                  ).validate()
    # a tile without its grid metadata refuses every radius
    bare = TileSet.from_arrays(ts.name, ts.meta.origin_lonlat, ts.arrays())
    with pytest.raises(ValueError, match="index_radius"):
        batch_candidates(pts, valid, tab,
                         MatcherParams(candidate_backend="grid"), bare.meta)
    assert as_grid_meta(ts.meta).index_radius == 50.0


def test_tuner_does_not_act_on_grid(port):
    """resolve_plan leaves a grid matcher's params alone, on the card
    too (no kernel arms), as the JAX tuner does."""
    ts, _ = port

    def measure(plan):
        raise AssertionError("a grid matcher measured an arm")

    plan, info = autotune.resolve_plan(
        MatcherParams(candidate_backend="grid"), ts, measure,
        backend="cuda", devkey="test")
    assert plan is None and info == {"source": "cpu"}


def test_port_compile_grid_equals_reference_file(tmp_path):
    """The port's compile (C++ fill) saved and read back by both packages:
    every array, the grid among them, and the metadata equal the JAX
    compile of the same network."""
    from reporter_tpu.tiles.tileset import TileSet as JTileSet

    ts = compile_network(generate_city("sf"))
    ref = j_compile_network(j_generate_city("sf"), JCompilerParams())
    path = ts.save(str(tmp_path / "sf"))
    back, jback = TileSet.load(path), JTileSet.load(path)
    for f in ARRAY_FIELDS:
        assert _same(getattr(back, f), getattr(ref, f)), f
        assert _same(getattr(jback, f), getattr(ref, f)), f
    assert tuple(back.meta) == tuple(ref.meta) == tuple(jback.meta)
