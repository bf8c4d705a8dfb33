"""Open-loop backfill (reporter_tpu_torch/backfill/, ops/aggregate.py)
against the JAX package's (tests/test_backfill.py, without its mesh arm).

Three layers, innermost out, all exact (tolerance 0: integer grids, JSON
documents, counts):

  - FixedGridCounts on ``device="cpu"`` equals ``reference_counts`` and
    the JAX grid over the same index stream, across the JAX update
    shape's boundaries, incrementally and after a load;
  - SpeedTodHistogram / TurnCounts binning, snapshots and
    ``harvest_aggregates`` documents equal the JAX package's for the same
    observations, the k-anonymity cases included;
  - the engine over a columnar and a records spool written by the JAX
    package's brokers: the port's document and stats equal the JAX
    engine's (dense candidates); ``backfill:crash@N`` and a resume are
    coverage-exact and equal the JAX resume, the replay tax counted; a
    checkpoint written by either package resumes in the other; config
    errors; and GET /aggregates in its five forms equals the JAX app's.
"""

import io
import json
import os

import numpy as np
import pytest

from reporter_tpu import faults as jfaults
from reporter_tpu.backfill import BackfillConfig as JBackfillConfig
from reporter_tpu.backfill import BackfillEngine as JBackfillEngine
from reporter_tpu.backfill.aggregate import AggregateStore as JAggregateStore
from reporter_tpu.backfill.aggregate import (
    SpeedTodHistogram as JSpeedTodHistogram)
from reporter_tpu.backfill.aggregate import TurnCounts as JTurnCounts
from reporter_tpu.backfill.aggregate import (
    harvest_aggregates as jharvest_aggregates)
from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.ops.aggregate import _CAP
from reporter_tpu.ops.aggregate import FixedGridCounts as JFixedGridCounts
from reporter_tpu.service.app import ReporterApp as JReporterApp
from reporter_tpu.streaming.columnar import pack_records as jpack_records
from reporter_tpu.streaming.durable_columnar import (
    DurableColumnarIngestQueue as JDurableColumnarIngestQueue)
from reporter_tpu.streaming.durable_queue import (
    DurableIngestQueue as JDurableIngestQueue)
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch import faults
from reporter_tpu_torch.backfill import (AggregateStore, BackfillConfig,
                                         BackfillEngine, SpeedTodHistogram,
                                         TurnCounts, harvest_aggregates)
from reporter_tpu_torch.config import Config
from reporter_tpu_torch.matcher.api import SegmentMatcher
from reporter_tpu_torch.ops.aggregate import FixedGridCounts, reference_counts
from reporter_tpu_torch.service.app import make_app
from reporter_tpu_torch.tiles.tileset import TileSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_STATS = ("records", "traces", "waves", "chunks", "reports", "malformed",
          "short_traces", "records_total", "replay_tax_records",
          "kanon_dropped", "kept_segments", "format", "partitions")


@pytest.fixture(scope="module")
def jtiles():
    # short OSMLR spans, so reports carry both boundary times
    return compile_network(
        generate_city("tiny"),
        JCompilerParams(reach_radius=500.0, osmlr_max_length=200.0))


@pytest.fixture(scope="module")
def tiles(jtiles):
    return TileSet.from_arrays(jtiles.name, jtiles.meta.origin_lonlat,
                               {f: getattr(jtiles, f) for f in _ARRAY_FIELDS})


@pytest.fixture(scope="module")
def jmatcher(jtiles):
    m = JSegmentMatcher(jtiles, JConfig(
        matcher_backend="jax",
        matcher=JMatcherParams(candidate_backend="dense")))
    if m._native_walker is None:
        pytest.skip("the JAX engine needs its native column walker")
    return m


@pytest.fixture(scope="module")
def matcher(tiles):
    return SegmentMatcher(tiles, device="cpu")


def _fleet_records(ts, n_veh=16, n_pt=80, seed=5):
    """Interleaved record dicts (firehose arrival order)."""
    probes = synthesize_fleet(ts, n_veh, num_points=n_pt, seed=seed,
                              gps_sigma=3.0)
    records = []
    for t in range(max(len(p.times) for p in probes)):
        for p in probes:
            if t < len(p.times):
                records.append({"uuid": p.uuid,
                                "lat": float(p.lonlat[t, 1]),
                                "lon": float(p.lonlat[t, 0]),
                                "time": float(p.times[t])})
    return records


def _spool(path, records, columnar):
    if columnar:
        q = JDurableColumnarIngestQueue(path, 2)
        for lo in range(0, len(records), 300):
            q.append_columns(jpack_records(records[lo:lo + 300]))
    else:
        q = JDurableIngestQueue(path, 2)
        q.append_many(records)
    q.close()
    return path


def _bf(mod, ck=None, **kw):
    kw.setdefault("slice_traces", 32)
    kw.setdefault("max_inflight", 2)
    # 2 partitions x 256 records a wave over ~1280 records: >= 3 waves
    kw.setdefault("poll_records", 256)
    kw.setdefault("k_anonymity", 1)
    return mod(checkpoint_path=ck, checkpoint_every_waves=1, **kw)


def _doc(store):
    return json.dumps(store.snapshot(), sort_keys=True)


# ---------------------------------------------------------------------------
# ops/aggregate: the scatter against the numpy reference and the JAX grid


@pytest.mark.parametrize("n", [0, 1, _CAP - 1, _CAP, _CAP + 1,
                               3 * _CAP + 17])
def test_grid_counts_equal_reference_and_jax(n):
    size = 257
    rng = np.random.default_rng(n)
    # in range, negative and past the end: rejects add to no cell
    idx = rng.integers(-5, size + 5, size=n)
    g = FixedGridCounts(size, device="cpu")
    accepted = g.add(idx)
    ref = reference_counts(size, idx)
    np.testing.assert_array_equal(g.snapshot(), ref)
    assert accepted == int(((idx >= 0) & (idx < size)).sum())
    assert g.snapshot().sum() == accepted
    j = JFixedGridCounts(size)
    assert j.add(idx) == accepted
    np.testing.assert_array_equal(g.snapshot(), j.snapshot())
    assert g.snapshot().dtype == j.snapshot().dtype == np.int32


def test_grid_incremental_adds_equal_one_stream():
    size = 97
    rng = np.random.default_rng(7)
    idx = rng.integers(-3, size + 3, size=2 * _CAP + 31)
    g = FixedGridCounts(size, device="cpu")
    for lo, hi in zip([0, 13, _CAP - 1, _CAP + 500],
                      [13, _CAP - 1, _CAP + 500, len(idx)]):
        g.add(idx[lo:hi])
    np.testing.assert_array_equal(g.snapshot(), reference_counts(size, idx))


def test_grid_load_roundtrip_and_owned_copies():
    g = FixedGridCounts(11, device="cpu")
    g.add(np.array([1, 1, 4]))
    snap = g.snapshot()
    g.add(np.array([4]))
    assert snap[4] == 1                   # a snapshot is not a view
    g2 = FixedGridCounts(11, device="cpu")
    g2.load(snap)
    snap[4] = 99                          # load took a copy
    g2.add(np.array([4]))
    expected = reference_counts(11, np.array([1, 1, 4, 4]))
    np.testing.assert_array_equal(g2.snapshot(), expected)


def test_grid_mesh_raises_naming_the_item():
    """The mesh arm this test once found refused (ROADMAP item 7, now
    ported): per-device partials over a three-device host mesh take the
    index stream in _CAP blocks in turn, as the JAX package's [ndev,
    _CAP] dispatch does, and sum to reference_counts (tolerance 0); the
    one refusal left is a device that is not the mesh's first."""
    from reporter_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=3, devices=["cpu"] * 3)
    rng = np.random.default_rng(3)
    idx = rng.integers(-3, 53, 3 * _CAP + 17)
    g = FixedGridCounts(50, mesh=mesh)
    assert g.add(idx) == int(((idx >= 0) & (idx < 50)).sum())
    parts = g.partials()
    assert parts.shape == (3, 50)
    for d in range(3):
        sel = np.arange(len(idx)) // _CAP % 3 == d
        np.testing.assert_array_equal(parts[d],
                                      reference_counts(50, idx[sel]))
    np.testing.assert_array_equal(g.snapshot(), reference_counts(50, idx))
    with pytest.raises(ValueError, match="first device"):
        FixedGridCounts(8, mesh=mesh, device="cuda:0")


# ---------------------------------------------------------------------------
# backfill/aggregate: binning, legend and harvest against the JAX package


def test_speed_tod_histogram_equals_jax():
    edges = [0.0, 2.0, 5.0, 10.0, 20.0]
    h = SpeedTodHistogram(7, edges, tod_bins=6, device="cpu")
    j = JSpeedTodHistogram(7, edges, tod_bins=6)
    rng = np.random.default_rng(3)
    n = _CAP + 123
    rows = rng.integers(-1, 8, size=n)          # unknown rows included
    times = rng.uniform(-1e5, 2e5, size=n)      # the day wraps both ways
    speeds = rng.uniform(-1.0, 30.0, size=n)    # negatives: no cell
    np.testing.assert_array_equal(h.flat_cells(rows, times, speeds),
                                  j.flat_cells(rows, times, speeds))
    assert h.update(rows, times, speeds) == j.update(rows, times, speeds)
    np.testing.assert_array_equal(h.snapshot(), j.snapshot())
    np.testing.assert_array_equal(h.snapshot(),
                                  h.reference(rows, times, speeds))
    h2 = SpeedTodHistogram(7, edges, tod_bins=6, device="cpu")
    h2.load(j.snapshot().reshape(-1))           # a flat snapshot loads too
    np.testing.assert_array_equal(h2.snapshot(), j.snapshot())


def test_turn_counts_equal_jax_with_legend_and_overflow():
    rows = np.array([0, 0, 0, 1, 0, -1, 2, 3, 3, 3, 3, 3, 3])
    nxt = np.array([9, 9, 7, 7, 9, 5, -1, 10, 11, 12, 13, 12, 10])
    t = TurnCounts(4, slots=2, device="cpu")
    j = JTurnCounts(4, slots=2)
    np.testing.assert_array_equal(t.flat_cells(rows, nxt),
                                  j.flat_cells(rows, nxt))
    t.update(rows, nxt)
    j.update(rows, nxt)
    t.update(np.array([0, 3]), np.array([9, 14]))
    j.update(np.array([0, 3]), np.array([9, 14]))
    np.testing.assert_array_equal(t.snapshot(), j.snapshot())
    assert t._legend == j._legend == {0: [7, 9], 1: [7], 3: [10, 11]}
    assert t.snapshot()[3, 2] == 4              # the counted overflow
    t2 = TurnCounts(4, slots=2, device="cpu")
    t2.load_legend(json.loads(json.dumps(j.dump_legend())))
    assert t2._legend == j._legend and t.dump_legend() == j.dump_legend()


def _aggregates(mods, counts_per_row, turn_rows=(), turn_nxt=()):
    hist_cls, turn_cls, kw = mods
    h = hist_cls(len(counts_per_row), [0.0, 5.0], tod_bins=2, **kw)
    for r, c in enumerate(counts_per_row):
        if c:
            h.update(np.full(c, r), np.zeros(c), np.ones(c))
    t = turn_cls(len(counts_per_row), slots=2, **kw)
    if len(turn_rows):
        t.update(np.asarray(turn_rows), np.asarray(turn_nxt))
    return h, t


_PORT = (SpeedTodHistogram, TurnCounts, {"device": "cpu"})
_JAX = (JSpeedTodHistogram, JTurnCounts, {})


@pytest.mark.parametrize("counts,turn_rows,turn_nxt,ids,k", [
    ([5, 3, 0], (), (), [100, 101, 102], 4),     # 101 withheld, 102 empty
    ([0, 2], (), (), [7, 8], 0),                 # k = 0 still needs one
    ([1, 0], [0, 0, 0], [9, 9, 9], [40, 41], 3),  # per-aggregate cutoff
    ([4, 4, 1], [0, 1, 1, 2, 2], [3, 3, 5, 6, 6], [1, 2, 3], 2)])
def test_harvest_docs_equal_jax(counts, turn_rows, turn_nxt, ids, k):
    doc = harvest_aggregates(*_aggregates(_PORT, counts, turn_rows,
                                          turn_nxt), np.array(ids), k)
    jdoc = jharvest_aggregates(*_aggregates(_JAX, counts, turn_rows,
                                            turn_nxt), np.array(ids), k)
    assert doc == jdoc
    for r, c in enumerate(counts):
        if 0 < c < max(k, 1) and str(ids[r]) in doc["segments"]:
            # a withheld histogram is absent from the block, not zeroed
            assert "speed_tod" not in doc["segments"][str(ids[r])]


# ---------------------------------------------------------------------------
# the engine against the JAX engine


@pytest.mark.parametrize("columnar", [True, False],
                         ids=["columnar", "records"])
def test_engine_equals_jax(jtiles, tiles, jmatcher, matcher, tmp_path,
                           columnar):
    records = _fleet_records(jtiles)
    broker = _spool(str(tmp_path / "spool"), records, columnar)
    eng = BackfillEngine(tiles, matcher=matcher, bf=_bf(BackfillConfig))
    eng.enable_shadow_reference()
    stats = eng.run(broker)
    jeng = JBackfillEngine(jtiles, matcher=jmatcher,
                           bf=_bf(JBackfillConfig))
    jstats = jeng.run(broker)
    assert {k: stats[k] for k in _STATS} == {k: jstats[k] for k in _STATS}
    assert stats["records"] == len(records) and stats["reports"] > 0
    assert stats["waves"] >= 3
    assert eng.shadow_identical() is True
    assert _doc(eng.store) == _doc(jeng.store)
    np.testing.assert_array_equal(eng.hist.snapshot(), jeng.hist.snapshot())
    np.testing.assert_array_equal(eng.qhist.snapshot(),
                                  jeng.qhist.snapshot())
    assert set(eng.stage_seconds) == {"prepare", "dispatch", "device",
                                      "walk", "aggregate"}


def test_crash_and_resume_is_coverage_exact_as_jax(
        jtiles, tiles, jmatcher, matcher, tmp_path):
    records = _fleet_records(jtiles, seed=6)
    broker = _spool(str(tmp_path / "spool"), records, columnar=False)
    clean = BackfillEngine(tiles, matcher=matcher,
                           bf=_bf(BackfillConfig, str(tmp_path / "clean")))
    clean.run(broker)
    out = {}
    for name, fmod, eng_cls, bf_cls, ts, m in (
            ("port", faults, BackfillEngine, BackfillConfig, tiles, matcher),
            ("jax", jfaults, JBackfillEngine, JBackfillConfig, jtiles,
             jmatcher)):
        ck = str(tmp_path / f"ck_{name}")
        with pytest.raises(fmod.InjectedCrash):
            with fmod.use(fmod.FaultPlan.parse("backfill:crash@2")):
                eng_cls(ts, matcher=m, bf=_bf(bf_cls, ck)).run(broker)
        assert os.path.exists(ck + ".npz")   # waves 0-1 checkpointed
        resumed = eng_cls(ts, matcher=m, bf=_bf(bf_cls, ck))
        stats = resumed.run(broker)
        out[name] = ({k: stats[k] for k in _STATS}, _doc(resumed.store))
    assert out["port"] == out["jax"]
    stats, doc = out["port"]
    assert doc == _doc(clean.store)          # coverage-exact
    # the tax is counted: processed = spool + replay
    assert stats["records_total"] >= len(records)
    assert stats["replay_tax_records"] == \
        stats["records_total"] - len(records)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(jtiles, tiles, jmatcher,
                                            matcher, tmp_path, writer):
    """A checkpoint one package wrote mid-spool resumes in the other to
    the clean document."""
    records = _fleet_records(jtiles, seed=8)
    broker = _spool(str(tmp_path / "spool"), records, columnar=True)
    clean = JBackfillEngine(jtiles, matcher=jmatcher,
                            bf=_bf(JBackfillConfig))
    clean.run(broker)
    ck = str(tmp_path / "ck")
    if writer == "jax":
        with pytest.raises(jfaults.InjectedCrash):
            with jfaults.use(jfaults.FaultPlan.parse("backfill:crash@1")):
                JBackfillEngine(jtiles, matcher=jmatcher,
                                bf=_bf(JBackfillConfig, ck)).run(broker)
        resumed = BackfillEngine(tiles, matcher=matcher,
                                 bf=_bf(BackfillConfig, ck))
    else:
        with pytest.raises(faults.InjectedCrash):
            with faults.use(faults.FaultPlan.parse("backfill:crash@1")):
                BackfillEngine(tiles, matcher=matcher,
                               bf=_bf(BackfillConfig, ck)).run(broker)
        resumed = JBackfillEngine(jtiles, matcher=jmatcher,
                                  bf=_bf(JBackfillConfig, ck))
    stats = resumed.run(broker)
    assert _doc(resumed.store) == _doc(clean.store)
    assert stats["records_total"] >= len(records)
    assert stats["records"] < len(records)      # resumed past wave 0


def test_config_validation_and_env_overrides():
    for mod in (BackfillConfig, JBackfillConfig):
        with pytest.raises(ValueError, match="trace-count rung"):
            mod(slice_traces=33).validate()
        with pytest.raises(ValueError, match="max_inflight"):
            mod(max_inflight=0).validate()
        with pytest.raises(ValueError, match="k_anonymity"):
            mod(k_anonymity=-1).validate()
        cfg = mod().with_env_overrides(
            {"RTPU_BACKFILL_K": "9", "RTPU_BACKFILL_INFLIGHT": "2",
             "RTPU_BACKFILL_READAHEAD": ""})
        assert cfg.k_anonymity == 9 and cfg.max_inflight == 2
        assert cfg.readahead_slices == mod().readahead_slices
        with pytest.raises(ValueError, match="RTPU_BACKFILL_K"):
            mod().with_env_overrides({"RTPU_BACKFILL_K": "many"})
        with pytest.raises(ValueError, match="RTPU_BACKFILL_MESH"):
            mod().with_env_overrides({"RTPU_BACKFILL_MESH": "all"})
        assert mod().with_env_overrides(
            {"RTPU_BACKFILL_MESH": "8"}).mesh_devices == 8
    assert BackfillConfig() == BackfillConfig().validate()
    # the mesh arm (ported: it raised naming ROADMAP item 7 before) takes
    # any device count, as the JAX config does
    for mod in (BackfillConfig, JBackfillConfig):
        assert mod(mesh_devices=2).validate().mesh_devices == 2


def test_engine_refuses_the_mesh_and_the_oracle(tiles, matcher):
    """A mesh beside a matcher dispatching elsewhere (the mesh arm itself
    is ported: the provided matcher's wire_mesh is authoritative, as in
    the JAX engine), and the oracle backend."""
    from reporter_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="wire_mesh"):
        BackfillEngine(tiles, matcher=matcher,
                       mesh=make_mesh(dp=2, devices=["cpu"] * 2))
    oracle = SegmentMatcher(tiles, Config(matcher_backend="reference_cpu"))
    with pytest.raises(ValueError, match="matcher_backend='torch'"):
        BackfillEngine(tiles, matcher=oracle)


def _get(app, path, query=""):
    status: list = []
    env = {"REQUEST_METHOD": "GET", "PATH_INFO": path,
           "QUERY_STRING": query, "wsgi.input": io.BytesIO(b"")}
    data = b"".join(app(env, lambda s, h: status.append(s)))
    return status[0], json.loads(data)


def test_aggregates_endpoint_equals_the_jax_app(jtiles, tiles, jmatcher,
                                                matcher, tmp_path):
    """The five forms: no store wired (404), an empty store (404), the
    whole document (200), one segment (200), an unknown segment (404)."""
    broker = _spool(str(tmp_path / "spool"), _fleet_records(jtiles),
                    columnar=True)
    store, jstore = AggregateStore(), JAggregateStore()
    apps = {"port": (make_app(tiles, Config(), device="cpu"),
                     make_app(tiles, Config(), device="cpu",
                              aggregates=store)),
            "jax": (JReporterApp(jtiles, JConfig()),
                    JReporterApp(jtiles, JConfig(), aggregates=jstore))}
    answers = {}
    for name, (bare, wired) in apps.items():
        answers[name] = [_get(bare, "/aggregates"),
                         _get(wired, "/aggregates")]
    BackfillEngine(tiles, matcher=matcher, bf=_bf(BackfillConfig),
                   store=store).run(broker)
    JBackfillEngine(jtiles, matcher=jmatcher, bf=_bf(JBackfillConfig),
                    store=jstore).run(broker)
    seg = next(iter(store.snapshot()["segments"]))
    for name, (bare, wired) in apps.items():
        answers[name] += [_get(wired, "/aggregates"),
                          _get(wired, "/aggregates", f"segment={seg}"),
                          _get(wired, "/aggregates", "segment=no-such")]
        bare.close()
        wired.close()
    assert answers["port"] == answers["jax"]
    assert [s[:3] for s, _ in answers["port"]] == \
        ["404", "404", "200", "200", "404"]
    assert answers["port"][3][1]["segment_id"] == seg
