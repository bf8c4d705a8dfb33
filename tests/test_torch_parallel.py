"""The port's mesh programs and mesh front ends (reporter_tpu_torch/
parallel/) against the JAX package, on the CPU.

The port's mesh is process-local and may repeat a device: a mesh over
``["cpu"] * 8`` runs the whole sharding path (padding, per-shard
dispatch, gather, K-merge, histogram reduce) here, where the JAX
package's mesh runs on the 8 virtual CPU devices of tests/conftest.py.
Every mesh result is held to the JAX package's single-device result on
the same numpy inputs (its own tests/test_parallel.py, slow-marked, holds
its mesh to that same result), with ``candidate_backend="dense"`` pinned
on the JAX side ("auto" takes the grid backend on a CPU).

Tolerances. Records, responses, datastore bodies, histograms and grids:
0. The mesh programs' MatchOutput (no wire quantization): edge, matched
and chain_start equal, offset within FIELD_TOL = 1e-3 m, the per-field
tolerance of the single-device candidate parity
(tests/test_torch_dense_candidates.py: XLA:CPU fuses multiply-adds where
the port rounds each operation); and every mesh program equals the
port's own single-device result at tolerance 0.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reporter_tpu.backfill import BackfillConfig as JBackfillConfig
from reporter_tpu.backfill import BackfillEngine as JBackfillEngine
from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.config import ServiceConfig as JServiceConfig
from reporter_tpu.config import StreamingConfig as JStreamingConfig
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet, synthesize_probe
from reporter_tpu.ops.dense_candidates import (
    find_candidates_dense as j_find_candidates_dense)
from reporter_tpu.ops.match import match_batch
from reporter_tpu.parallel import dispatch_traces as j_dispatch_traces
from reporter_tpu.parallel import make_mesh as j_make_mesh
from reporter_tpu.service.app import make_app as jmake_app
from reporter_tpu.service.router import make_router as jmake_router
from reporter_tpu.streaming import StreamPipeline as JStreamPipeline
from reporter_tpu.streaming.columnar import (
    ColumnarStreamPipeline as JColumnarStreamPipeline)
from reporter_tpu.streaming.columnar import pack_records as jpack_records
from reporter_tpu.streaming.durable_columnar import (
    DurableColumnarIngestQueue as JDurableColumnarIngestQueue)
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.backfill import BackfillConfig, BackfillEngine
from reporter_tpu_torch.config import (Config, MatcherParams, ServiceConfig,
                                       StreamingConfig)
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.ops.aggregate import FixedGridCounts, reference_counts
from reporter_tpu_torch.ops.dense_candidates import (build_seg_pack,
                                                     find_candidates_dense,
                                                     root_dist)
from reporter_tpu_torch.ops.match import match_traces
from reporter_tpu_torch.parallel import (DpWireMatcher, dispatch_traces,
                                         make_dp_matcher, make_mesh,
                                         make_multimetro_matcher,
                                         make_sharded_matcher, stack_tilesets)
from reporter_tpu_torch.parallel import multihost
from reporter_tpu_torch.parallel.dp_e2e import flat_device_count
from reporter_tpu_torch.parallel.sharded_candidates import (
    shard_host_tables, sharded_candidates, shard_tables)
from reporter_tpu_torch.service.app import make_app
from reporter_tpu_torch.service.router import make_router
from reporter_tpu_torch.streaming import StreamPipeline
from reporter_tpu_torch.streaming.columnar import ColumnarStreamPipeline
from reporter_tpu_torch.tiles.tileset import TileSet, tables_from_numpy

pytestmark = pytest.mark.usefixtures("few_torch_threads")

FIELD_TOL = 1e-3      # m: offset, the single-device candidate parity's
URL = "http://ds.test/"
JDENSE = JMatcherParams(candidate_backend="dense")
PARAMS = MatcherParams()
CPU8 = ["cpu"] * 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(jts):
    """The port's TileSet over a JAX-compiled tile (grid metadata kept)."""
    return TileSet.from_arrays(jts.name, tuple(jts.meta),
                               {f: getattr(jts, f) for f in _ARRAY_FIELDS})


@pytest.fixture(scope="module")
def metro_a():
    return compile_network(generate_city("tiny"),
                           JCompilerParams(reach_radius=500.0))


@pytest.fixture(scope="module")
def metro_b():
    return compile_network(generate_city("tiny", seed=42),
                           JCompilerParams(reach_radius=500.0))


@pytest.fixture(scope="module")
def wide():
    """A tile of three 512-column blocks, so four segment shards split
    it (and one is padding only)."""
    return compile_network(generate_city("tiny", nx=16, ny=16),
                           JCompilerParams(reach_radius=500.0))


@pytest.fixture(scope="module")
def svc_tiles():
    """Short OSMLR spans, so reports carry both boundary times (the
    service and streaming tests' tile)."""
    return compile_network(
        generate_city("tiny"),
        JCompilerParams(reach_radius=500.0, osmlr_max_length=200.0))


def _batch(ts, n, T=48, seed=0):
    fleet = synthesize_fleet(ts, n, num_points=T, seed=seed, gps_sigma=3.0)
    return (np.stack([p.xy for p in fleet]).astype(np.float32),
            np.ones((n, T), bool))


def _jax_single(jts, pts, valid):
    return match_batch(jnp.asarray(pts), jnp.asarray(valid),
                       jts.device_tables("dense"), jts.meta, JDENSE)


def _port_single(ts, pts, valid):
    return match_traces(torch.from_numpy(pts), torch.from_numpy(valid),
                        tables_from_numpy(ts.arrays(), "cpu"), PARAMS, None,
                        ts.meta)


def _assert_output(got, want_jax, want_port):
    for f in ("edge", "matched", "chain_start"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want_jax, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.offset.numpy(),
                               np.asarray(want_jax.offset), atol=FIELD_TOL)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want_port, f)), f


# ---------------------------------------------------------------------------
# the mesh


class TestMesh:
    @pytest.mark.parametrize("kw,want", [
        (dict(tile=2), {"tile": 2, "dp": 4}),
        (dict(), {"tile": 1, "dp": 8}),
        (dict(tile=4, dp=2), {"tile": 4, "dp": 2}),
        (dict(tile=1, dp=3), {"tile": 1, "dp": 3}),
    ])
    def test_shapes_equal_jax(self, kw, want):
        m = make_mesh(**kw, devices=CPU8)
        jm = j_make_mesh(**kw, devices=jax.devices()[:8])
        assert dict(m.shape) == dict(jm.shape) == want
        assert m.axis_names == tuple(jm.axis_names) == ("tile", "dp")
        assert m.devices.shape == jm.devices.shape
        assert flat_device_count(m) == m.size == want["tile"] * want["dp"]

    @pytest.mark.parametrize("kw", [dict(tile=3), dict(tile=3, dp=3)])
    def test_errors_equal_jax(self, kw):
        with pytest.raises(ValueError) as pe:
            make_mesh(**kw, devices=CPU8)
        with pytest.raises(ValueError) as je:
            j_make_mesh(**kw, devices=jax.devices()[:8])
        assert str(pe.value) == str(je.value)

    def test_repeated_devices_and_missing_cards(self):
        m = make_mesh(tile=2, dp=2, devices=["cpu"] * 4)
        assert m.distinct_devices == [torch.device("cpu")]
        assert m.flat_devices == [torch.device("cpu")] * 4
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="cuda:3"):
            make_mesh(dp=1, devices=["cuda:3"])
        with pytest.raises(ValueError, match="unsupported"):
            make_mesh(dp=1, devices=["meta"])


# ---------------------------------------------------------------------------
# dispatch_traces (numpy) against the JAX package's


def _dispatch_equal(names, jobs, dp, bucket):
    got = dispatch_traces(names, jobs, dp=dp, bucket=bucket)
    want = j_dispatch_traces(names, jobs, dp=dp, bucket=bucket)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.index == want.index
    return got


class TestDispatch:
    def test_routing_and_padding(self):
        jobs = [("a", np.ones((10, 2), np.float32)),
                ("b", np.ones((5, 2), np.float32)),
                ("a", np.ones((7, 2), np.float32))]
        mb = _dispatch_equal(("a", "b"), jobs, 4, 16)
        assert mb.points.shape == (2, 4, 16, 2)
        assert mb.index[0] == [(0, 0, 10), (2, 0, 7)]

    def test_long_traces_are_chunked_not_truncated(self):
        xy = np.arange(40, dtype=np.float32).reshape(20, 2)
        mb = _dispatch_equal(("a",), [("a", xy)], 1, 8)
        assert mb.index[0] == [(0, 0, 8), (0, 8, 8), (0, 16, 4)]
        assert int(mb.valid.sum()) == 20

    @pytest.mark.parametrize("n_jobs,want", [(3, 4), (5, 8), (9, 16),
                                             (13, 16)])
    def test_batch_shape_is_quantized(self, n_jobs, want):
        jobs = [("a", np.ones((4, 2), np.float32))] * n_jobs
        assert _dispatch_equal(("a",), jobs, 4, 8).points.shape[1] == want

    def test_unknown_and_duplicate_metros_raise(self):
        for fn in (dispatch_traces, j_dispatch_traces):
            with pytest.raises(KeyError):
                fn(("a",), [("zz", np.ones((2, 2), np.float32))], dp=1,
                   bucket=8)
            with pytest.raises(ValueError, match="duplicate"):
                fn(("a", "a"), [], dp=1, bucket=8)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_jobs(self, seed):
        rng = np.random.default_rng(seed)
        names = ("sf", "nyc", "la")
        jobs = [(names[int(rng.integers(3))],
                 rng.normal(0, 500, (int(rng.integers(0, 70)), 2))
                 .astype(np.float32)) for _ in range(int(rng.integers(1, 40)))]
        _dispatch_equal(names, jobs, int(rng.integers(1, 5)),
                        int(rng.choice([16, 32])))


# ---------------------------------------------------------------------------
# the four mesh programs


def test_dp_matcher_equals_single_device(metro_a):
    """tile=2 x dp=4 over eight host devices: rows sharded over both
    axes, each shard the whole matcher on its rows."""
    ts = _port(metro_a)
    pts, valid = _batch(metro_a, 16, seed=3)
    valid[5, 30:] = False                       # a short trace
    step = make_dp_matcher(make_mesh(tile=2, dp=4, devices=CPU8), ts, PARAMS)
    _assert_output(step(pts, valid), _jax_single(metro_a, pts, valid),
                   _port_single(ts, pts, valid))
    with pytest.raises(ValueError, match="multiple"):
        step(pts[:7], valid[:7])


def test_sharded_matcher_equals_unsharded(wide):
    """tile=4 (segment shards) x dp=2 (rows): shards built from their
    own columns, every real block's derived tables equal to the
    unsharded pack's, and the match equal to the single device's."""
    ts = _port(wide)
    sp = build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                        ts.seg_len)
    host = shard_host_tables(ts, 4)
    nb = sp.bbox.shape[0]
    assert nb == 3 and all(h["seg_bbox"].shape == (1, 4) for h in host)
    for i, h in enumerate(host):
        if i < nb:                              # a real block
            for key, whole in (("seg_sweep", sp.sweep[i * 512:(i + 1) * 512]),
                               ("seg_coarse", sp.coarse[i:i + 1]),
                               ("seg_sub", sp.sub[i:i + 1]),
                               ("seg_bbox", sp.bbox[i:i + 1])):
                assert h[key].tobytes() == np.ascontiguousarray(
                    whole).tobytes(), (i, key)
        else:                                   # padding: never hit
            assert np.isnan(h["seg_bbox"]).all()
            assert np.isnan(h["seg_sub"]).all()
            assert (h["seg_pack"][6].view(np.int32) == -1).all()
    pts, valid = _batch(wide, 8, seed=12)
    step = make_sharded_matcher(make_mesh(tile=4, dp=2, devices=CPU8), ts,
                                PARAMS)
    _assert_output(step(pts, valid), _jax_single(wide, pts, valid),
                   _port_single(ts, pts, valid))


def test_sharded_candidates_exact_ties(wide):
    """Points on the network's nodes: every edge at the node ties at
    d = 0, and the tied edges lie in different shards; and fleet points,
    where the two directions of a street have squared distances an ulp
    apart that round to one distance. The merge keeps the sweep's
    resolution (on d², smallest edge id, then its lowest offset):
    bit-equal to the unsharded sweep, and at the nodes to the JAX sweep's
    edges (exact node coordinates agree to the bit)."""
    ts = _port(wide)
    tables = shard_tables(make_mesh(tile=4, dp=1, devices=["cpu"] * 4), ts)
    fleet = np.concatenate([p.xy for p in synthesize_fleet(
        wide, 24, num_points=64, seed=4, gps_sigma=3.0)])
    pts = np.ascontiguousarray(np.concatenate([ts.node_xy, fleet]),
                               np.float32)
    valid = np.ones(len(pts), bool)
    me, md, mo = sharded_candidates(tables, pts, valid, PARAMS)
    sp = build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                        ts.seg_len)
    want = find_candidates_dense(torch.from_numpy(pts),
                                 (torch.from_numpy(sp.pack),
                                  torch.from_numpy(sp.bbox)), 50.0, 8)
    assert torch.equal(me, want.edge) and torch.equal(mo, want.offset)
    assert torch.equal(md, want.dist)
    zero = (md[:, 0] == 0) & (md[:, 1] == 0)
    zero[len(ts.node_xy):] = False
    assert int(zero.sum()) > 50                 # many exact ties
    shard_of = {}
    for i, h in enumerate(tables.host):
        for e in np.unique(h["seg_pack"][6].view(np.int32)):
            shard_of.setdefault(int(e), set()).add(i)
    e01 = me.numpy()[zero.numpy()][:, :2]
    assert any(shard_of[int(a)] != shard_of[int(b)] for a, b in e01)
    # the squared output is the distance before its square root
    sq = find_candidates_dense(torch.from_numpy(pts),
                               (torch.from_numpy(sp.pack),
                                torch.from_numpy(sp.bbox)), 50.0, 8,
                               squared=True)
    assert torch.equal(sq.edge, want.edge)
    assert torch.equal(root_dist(sq.dist), want.dist)
    jsp = wide.host_tables("dense")
    jc = j_find_candidates_dense(jnp.asarray(pts),
                                 (jnp.asarray(jsp["seg_pack"]),
                                  jnp.asarray(jsp["seg_bbox"])), 50.0, 8)
    tied = zero.numpy()
    np.testing.assert_array_equal(me.numpy()[tied][:, :2],
                                  np.asarray(jc.edge)[tied][:, :2])


def test_multimetro_equals_each_metro(metro_a, metro_b):
    """Two metros over tile=2, rows over dp=4: each metro's outputs equal
    its own single-device match; the histogram equals the bincount of
    the matched OSMLR rows, zero past each metro's real G."""
    pa, pb = _port(metro_a), _port(metro_b)
    stacked = stack_tilesets([pa, pb])
    step = make_multimetro_matcher(make_mesh(tile=2, dp=4, devices=CPU8),
                                   stacked, PARAMS)
    batches = [_batch(metro_a, 8, seed=1), _batch(metro_b, 8, seed=2)]
    batches[1][1][3, 20:] = False
    out, hist = step(np.stack([b[0] for b in batches]),
                     np.stack([b[1] for b in batches]))
    assert hist.dtype == torch.int32
    for m, (jts, ts) in enumerate(((metro_a, pa), (metro_b, pb))):
        got = type(out)(*(x[m] for x in out))
        _assert_output(got, _jax_single(jts, *batches[m]),
                       _port_single(ts, *batches[m]))
        edges, matched = got.edge.numpy(), got.matched.numpy()
        rows = jts.edge_osmlr[np.maximum(edges, 0)][matched & (edges >= 0)]
        want = np.bincount(rows[rows >= 0], minlength=stacked.osmlr_pad)
        np.testing.assert_array_equal(hist[m].numpy(), want)
        assert hist[m, stacked.num_osmlr[m]:].sum() == 0
    with pytest.raises(ValueError, match="not divisible by tile"):
        make_multimetro_matcher(make_mesh(tile=4, dp=2, devices=CPU8),
                                stacked, PARAMS)
    with pytest.raises(ValueError, match="index_radius"):
        make_multimetro_matcher(make_mesh(tile=2, dp=1, devices=CPU8),
                                stacked, MatcherParams(search_radius=1e4))


def test_multimetro_mixed_capacity_pads(metro_a):
    """Cell capacity sizes per content, so metros differ: the narrower
    grid is padded before its cell_pack is built, and both candidate
    backends (dense, and the grid gather on the padded packs) still
    equal each metro's single-device match."""
    narrow = compile_network(
        generate_city("tiny", seed=42),
        JCompilerParams(reach_radius=500.0, cell_capacity=128))
    assert narrow.grid.shape[1] != metro_a.grid.shape[1]
    ports = [_port(metro_a), _port(narrow)]
    stacked = stack_tilesets(ports)
    assert stacked.tables["cell_pack"].shape[2] == \
        8 * max(metro_a.grid.shape[1], narrow.grid.shape[1])
    batches = [_batch(metro_a, 4, seed=5), _batch(narrow, 4, seed=6)]
    points = np.stack([b[0] for b in batches])
    valid = np.stack([b[1] for b in batches])
    for backend in ("dense", "grid"):
        p = MatcherParams(candidate_backend=backend)
        out, _ = make_multimetro_matcher(
            make_mesh(tile=2, dp=2, devices=["cpu"] * 4), stacked, p)(
            points, valid)
        for m, ts in enumerate(ports):
            want = match_traces(torch.from_numpy(points[m]),
                                torch.from_numpy(valid[m]),
                                tables_from_numpy(ts.arrays(), "cpu",
                                                  backend), p, None, ts.meta)
            for f in want._fields:
                assert torch.equal(getattr(out, f)[m], getattr(want, f)), \
                    (backend, m, f)
        if backend == "dense":
            for m, jts in enumerate((metro_a, narrow)):
                np.testing.assert_array_equal(
                    out.edge[m].numpy(),
                    np.asarray(_jax_single(jts, points[m], valid[m]).edge))


# ---------------------------------------------------------------------------
# the product path: SegmentMatcher, the app, the router, both pipelines


def _traces(jts, n, seed):
    fleet = synthesize_fleet(jts, n, num_points=48, seed=seed)
    out = []
    for i, p in enumerate(fleet):
        k = 48 if i % 3 else 20
        acc = np.full(k, 12.0, np.float32) if i == 5 else None
        out.append((str(i), p.xy[:k].astype(np.float32),
                    np.arange(k, dtype=np.float64), acc))
    return out


@pytest.fixture(scope="module")
def mesh_fleet(metro_a):
    """13 traces and the JAX single-device matcher's records of them."""
    rows = _traces(metro_a, 13, 21)
    jb = JSegmentMatcher(metro_a, JConfig(matcher=JDENSE)).match_many(
        [JTrace(u, xy, t, accuracy=a) for u, xy, t, a in rows])
    return rows, jb


@pytest.mark.parametrize("dp", [8, 3])
def test_segment_matcher_mesh_records_equal_jax(metro_a, mesh_fleet, dp):
    """13 rows, not a multiple of the device count: padded on submit,
    dropped at the harvest. Mixed lengths span two buckets; one trace
    carries per-point accuracy. Every record column equal (tolerance 0)
    to the JAX single-device matcher's, and to the port's."""
    rows, jb = mesh_fleet
    ts = _port(metro_a)
    mesh = make_mesh(tile=1, dp=dp, devices=["cpu"] * dp)
    m = SegmentMatcher(ts, mesh=mesh)
    assert m.wire_mesh is mesh and m.tuned_plan is None
    traces = [Trace(u, xy, t, accuracy=a) for u, xy, t, a in rows]
    got = m.match_many(traces)
    one = SegmentMatcher(ts, device="cpu").match_many(traces)
    assert got.n_records == jb.n_records > 0
    for f in jb.columns._fields:
        np.testing.assert_array_equal(getattr(got.columns, f),
                                      getattr(jb.columns, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got.columns, f),
                                      getattr(one.columns, f), err_msg=f)
    # one trace (the decode-then-walk path) and the per-point decode
    t0 = traces[1]
    assert [r.to_json() for r in m.match_trace(t0)] == \
        [r.to_json() for r in one[1]]
    assert m.matched_points(t0) == SegmentMatcher(
        ts, device="cpu").matched_points(t0)


def test_segment_matcher_mesh_refusals(metro_a):
    ts = _port(metro_a)
    mesh = make_mesh(dp=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="matcher_backend='torch'"):
        SegmentMatcher(ts, Config(matcher_backend="reference_cpu"),
                       mesh=mesh)
    staged = {"staged_layout": np.int32(3)}
    with pytest.raises(ValueError, match="single-device only"):
        SegmentMatcher(ts, mesh=mesh, staged_tables=staged)
    with pytest.raises(ValueError, match="not both"):
        SegmentMatcher(ts, mesh=mesh, device="cpu")
    m = SegmentMatcher(ts, mesh=mesh)
    with pytest.raises(ValueError, match="single-device only"):
        m.unstage_tables()


def test_dp_wire_matcher_places_one_copy_per_device(metro_a):
    ts = _port(metro_a)
    w = DpWireMatcher(make_mesh(tile=2, dp=3, devices=["cpu"] * 6), ts,
                      PARAMS, None)
    assert list(w.tables) == [torch.device("cpu")] and w.ndev == 6
    wire = w.f32(np.zeros((4, 16, 2), np.float32),
                 np.zeros(4, np.int32), None)
    assert len(wire.shards) == 6 and wire.cpu().shape[0] == 6


def _capture():
    bodies = []
    return bodies, lambda url, body: bodies.append(json.loads(body)) or 200


def test_reporter_app_mesh_equals_jax(svc_tiles):
    """validate, cache merge, sharded match, filter, publish: the same
    responses and datastore bodies as the JAX single-device app."""
    jb, jt = _capture()
    pb, pt = _capture()
    ja = jmake_app(svc_tiles, JConfig(
        matcher=JDENSE, service=JServiceConfig(datastore_url=URL)),
        transport=jt)
    pa = make_app(_port(svc_tiles), Config(
        service=ServiceConfig(datastore_url=URL)), transport=pt,
        mesh=make_mesh(tile=2, dp=2, devices=["cpu"] * 4))
    try:
        payloads = [synthesize_probe(svc_tiles, seed=s, num_points=90,
                                     gps_sigma=3.0).to_report_json()
                    for s in range(5)]
        assert pa.report_many(payloads) == ja.report_many(payloads)
        assert pa.report_one(payloads[0]) == ja.report_one(payloads[0])
        assert pb == jb and jb
    finally:
        ja.close()
        pa.close()


def test_metro_router_meshes_equal_jax(svc_tiles):
    """BASELINE config 4's product shape: metros routed on the host, each
    metro's matcher over its own mesh (one metro on a mesh, the other on
    the device), reports equal to the JAX single-device router's."""
    other = compile_network(
        generate_city("nyc", nx=8, ny=8),
        JCompilerParams(reach_radius=500.0, osmlr_max_length=200.0))
    jtiles = [svc_tiles, other]
    jb, jt = _capture()
    pb, pt = _capture()
    jr = jmake_router(jtiles, JConfig(
        matcher=JDENSE, service=JServiceConfig(datastore_url=URL)),
        transport=jt)
    pr = make_router([_port(t) for t in jtiles], Config(
        service=ServiceConfig(datastore_url=URL)), transport=pt,
        meshes={svc_tiles.name: make_mesh(dp=4, devices=["cpu"] * 4)},
        device="cpu")
    try:
        assert pr.apps[svc_tiles.name].matcher.wire_mesh is not None
        assert pr.apps[other.name].matcher.wire_mesh is None
        payloads = [synthesize_probe(ts, seed=s, num_points=60,
                                     gps_sigma=3.0).to_report_json()
                    for ts in jtiles for s in range(3)]
        got = pr.report_many(payloads)
        assert got == jr.report_many(payloads)
        assert {o["metro"] for o in got} == {svc_tiles.name, other.name}
        assert pb == jb
    finally:
        jr.close()
        pr.close()


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _stream_records(jts, seed, n=6, points=40):
    rng = np.random.default_rng(seed)
    probes = [synthesize_probe(jts, seed=int(s), num_points=points,
                               gps_sigma=3.0)
              for s in rng.integers(0, 10_000, n)]
    recs = []
    for t in range(points):
        for p in probes:
            recs.append({"uuid": p.uuid, "lat": float(p.lonlat[t, 1]),
                         "lon": float(p.lonlat[t, 0]),
                         "time": float(p.times[t])})
    return recs


@pytest.mark.parametrize("columnar", [False, True])
def test_stream_pipelines_mesh_equal_jax(svc_tiles, columnar):
    recs = _stream_records(svc_tiles, 7, n=5, points=30)
    kw = dict(flush_min_points=10, flush_max_age=5.0, poll_max_records=48,
              hist_flush_interval=6.0)
    if columnar:
        kw["pipeline_depth"] = 0
    jpub, ppub = [], []
    jclock, pclock = _Clock(), _Clock()
    jcls, pcls = ((JColumnarStreamPipeline, ColumnarStreamPipeline)
                  if columnar else (JStreamPipeline, StreamPipeline))
    jp = jcls(svc_tiles, JConfig(matcher=JDENSE,
                                 service=JServiceConfig(datastore_url=URL),
                                 streaming=JStreamingConfig(**kw)),
              transport=lambda u, b: jpub.append(json.loads(b)) or 200,
              clock=jclock)
    pp = pcls(_port(svc_tiles), Config(
        service=ServiceConfig(datastore_url=URL),
        streaming=StreamingConfig(**kw)),
        transport=lambda u, b: ppub.append(json.loads(b)) or 200,
        clock=pclock, mesh=make_mesh(tile=1, dp=3, devices=["cpu"] * 3))
    for pipe, clock in ((jp, jclock), (pp, pclock)):
        for chunk in np.array_split(np.arange(len(recs)), 5):
            rows = [recs[i] for i in chunk]
            if columnar:
                from reporter_tpu_torch.streaming.columnar import pack_records
                pipe.queue.append_columns(
                    (jpack_records if pipe is jp else pack_records)(rows))
            else:
                pipe.queue.append_many(rows)
            pipe.step()
            clock.now += 2.0
        pipe.drain()
        pipe.flush_histograms()
        if columnar:
            pipe.close()
    assert ppub == jpub
    assert any(b.get("reports") for b in ppub)
    np.testing.assert_array_equal(pp.hist.snapshot(), jp.hist.snapshot())
    np.testing.assert_array_equal(pp.qhist.snapshot(), jp.qhist.snapshot())
    assert pp.committed == jp.committed


# ---------------------------------------------------------------------------
# partial grids and backfill over a mesh


@pytest.mark.parametrize("ndev,n", [(2, 1), (3, 4096 * 3 + 5),
                                    (8, 4096 * 9 + 100)])
def test_fixed_grid_counts_mesh_equals_reference(ndev, n):
    """Partials across shard boundaries sum to reference_counts; a load
    puts the merged grid in partial row 0 and adds continue on top."""
    rng = np.random.default_rng(ndev)
    size = 977
    g = FixedGridCounts(size, mesh=make_mesh(dp=ndev,
                                             devices=["cpu"] * ndev))
    idx = rng.integers(-5, size + 5, n)
    g.add(idx)
    g.add(idx[:1000])
    want = reference_counts(size, np.concatenate([idx, idx[:1000]]))
    np.testing.assert_array_equal(g.snapshot(), want)
    assert g.partials().shape == (ndev, size)
    g2 = FixedGridCounts(size, mesh=make_mesh(dp=ndev,
                                              devices=["cpu"] * ndev))
    g2.load(want)
    np.testing.assert_array_equal(g2.partials()[0], want)
    assert not g2.partials()[1:].any()
    g2.add(np.array([3, 3, size]))
    want[3] += 2
    np.testing.assert_array_equal(g2.snapshot(), want)


def test_backfill_engine_mesh_equals_jax(svc_tiles, tmp_path):
    """BackfillEngine over a four-device mesh (its own matcher and
    partial grids) against the JAX single-device engine on the same
    spool: the aggregate document, both grids and the stats equal."""
    probes = synthesize_fleet(svc_tiles, 12, num_points=60, seed=5,
                              gps_sigma=3.0)
    records = [{"uuid": p.uuid, "lat": float(p.lonlat[t, 1]),
                "lon": float(p.lonlat[t, 0]), "time": float(p.times[t])}
               for t in range(60) for p in probes]
    broker = str(tmp_path / "spool")
    q = JDurableColumnarIngestQueue(broker, 2)
    for lo in range(0, len(records), 300):
        q.append_columns(jpack_records(records[lo:lo + 300]))
    q.close()
    kw = dict(slice_traces=8, max_inflight=2, poll_records=256,
              k_anonymity=1, checkpoint_every_waves=1)
    mesh = make_mesh(dp=4, devices=["cpu"] * 4)
    eng = BackfillEngine(_port(svc_tiles), bf=BackfillConfig(**kw),
                         mesh=mesh)
    assert eng.matcher.wire_mesh is mesh and eng.hist._grid.ndev == 4
    eng.enable_shadow_reference()
    stats = eng.run(broker)
    jeng = JBackfillEngine(svc_tiles, JConfig(matcher=JDENSE),
                           bf=JBackfillConfig(**kw))
    jstats = jeng.run(broker)
    assert json.dumps(eng.store.snapshot(), sort_keys=True) == \
        json.dumps(jeng.store.snapshot(), sort_keys=True)
    np.testing.assert_array_equal(eng.hist.snapshot(), jeng.hist.snapshot())
    np.testing.assert_array_equal(eng.qhist.snapshot(),
                                  jeng.qhist.snapshot())
    for k in ("records", "traces", "waves", "reports", "kept_segments"):
        assert stats[k] == jstats[k], k
    assert stats["reports"] > 0 and eng.shadow_identical() is True
    # a provided mesh matcher's mesh is authoritative
    m = SegmentMatcher(_port(svc_tiles), mesh=mesh)
    assert BackfillEngine(_port(svc_tiles), matcher=m).mesh is mesh


# ---------------------------------------------------------------------------
# multihost


_ENV = ("REPORTER_TPU_COORDINATOR", "REPORTER_TPU_NUM_PROCESSES",
        "REPORTER_TPU_PROCESS_ID")


def test_multihost_single_process_is_noop(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_multihost() is False
    multihost.shutdown_multihost()              # never joined: a no-op
    multihost.shutdown_multihost()


@pytest.mark.parametrize("args,env", [
    (dict(num_processes=4), {}),
    (dict(process_id=0), {}),
    ({}, {"REPORTER_TPU_NUM_PROCESSES": "2"}),
    (dict(coordinator="localhost:1"), {}),
    ({}, {"REPORTER_TPU_COORDINATOR": "localhost:1",
          "REPORTER_TPU_PROCESS_ID": "0"}),
])
def test_multihost_errors_equal_jax(monkeypatch, args, env):
    from reporter_tpu.parallel.multihost import (
        initialize_multihost as j_initialize)

    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as pe:
        multihost.initialize_multihost(**args)
    with pytest.raises(ValueError) as je:
        j_initialize(**args)
    assert str(pe.value) == str(je.value)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_GROUP = """
import os, sys
import torch
import torch.distributed as dist
from reporter_tpu_torch.parallel.multihost import (initialize_multihost,
                                                   shutdown_multihost)
pid = int(sys.argv[1])
os.environ["REPORTER_TPU_COORDINATOR"] = "localhost:%d"
os.environ["REPORTER_TPU_NUM_PROCESSES"] = sys.argv[2]
os.environ["REPORTER_TPU_PROCESS_ID"] = str(pid)
assert initialize_multihost() is True
assert dist.get_backend() == "gloo"
assert dist.get_world_size() == int(sys.argv[2]) and dist.get_rank() == pid
x = torch.full((4, 2), pid + 1, dtype=torch.int32)
dist.all_reduce(x)
n = int(sys.argv[2])
assert int(x.sum()) == n * (n + 1) // 2 * 8, int(x.sum())
shutdown_multihost()
shutdown_multihost()
assert not dist.is_initialized()
print(f"GROUP-OK-{pid}", flush=True)
"""


@pytest.mark.parametrize("n", [1, 2])
def test_multihost_gloo_group_all_reduce(n):
    """n processes join one gloo group through initialize_multihost (the
    JAX package's two-process test skips on this host's CPU backend) and
    all_reduce: every rank sees the sum; shutdown is idempotent."""
    code = _GROUP % _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in _ENV and k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid), str(n)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for pid in range(n)]
    outs = [p.communicate(timeout=120) for p in procs]
    for pid, (out, err) in enumerate(outs):
        assert f"GROUP-OK-{pid}" in out, err[-2000:]
