"""The port's native host half of match_many (reporter_tpu_torch/native:
the C prepare and the C edge walk) against its numpy / Python forms and
against the JAX package's native forms, all at tolerance 0: the prepared
bytes, the Morton keys, the record columns and the records
(``to_json()``), the merge of per-slice columns, and the whole
``match_many`` on the CPU against the JAX ``SegmentMatcher``."""

import json
import os
import re

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams, Config, MatcherParams
from reporter_tpu.matcher import native_prepare as j_npp
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.matcher.native_walk import make_native_walker
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.matcher import native_prepare as npp
from reporter_tpu_torch.matcher import segments
from reporter_tpu_torch.matcher.api import (MatchBatch, SegmentMatcher,
                                            Trace, _merge_columns,
                                            walk_python)
from reporter_tpu_torch.matcher.native_walk import (NativeWalker,
                                                    RecordColumns,
                                                    materialize_records,
                                                    record_bounds)
from reporter_tpu_torch.native import build as native_build
from reporter_tpu_torch.tiles.tileset import TileSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")
_WALKER_CC = os.path.join(os.path.dirname(__file__), "..",
                          "reporter_tpu_torch", "native", "walker.cc")


# ---- prepare -------------------------------------------------------------

def _xys(case, rng):
    """One slice's traces per case."""
    walk = lambda n: (np.cumsum(rng.uniform(-10, 10, (n, 2)), axis=0)  # noqa: E731
                      + rng.uniform(-400, 400, 2)).astype(np.float32)
    if case == "i8":             # 1 Hz-ish walks, uneven lengths
        return [walk(int(n)) for n in rng.integers(1, 60, 17)]
    if case == "uniform":        # the fleet shape (one stack)
        return [walk(32) for _ in range(8)]
    if case == "i16":            # steps past ±127 quanta
        return [np.cumsum(rng.uniform(-80, 80, (30, 2)), axis=0)
                .astype(np.float32) for _ in range(5)]
    if case == "f32":            # a span past the i16 range
        xs = [rng.uniform(-500, 500, (20, 2)).astype(np.float32)
              for _ in range(4)]
        xs[2][10] = [9000.0, 0.0]
        return xs
    if case == "nan":            # NaN / inf poison
        xs = [rng.uniform(-500, 500, (10, 2)).astype(np.float32)
              for _ in range(3)]
        xs[1][3, 0] = np.nan
        xs[2][0, 1] = np.inf
        return xs
    if case in ("step127", "step128"):   # one step of exactly ±q quanta
        q = 127 if case == "step127" else 128
        xs = [np.repeat(rng.uniform(-400, 400, (1, 2)), 20, 0)
              .astype(np.float32) for _ in range(3)]
        for x, sign, axis in zip(xs, (1.0, -1.0, 1.0), (0, 0, 1)):
            x[5:, axis] += np.float32(sign * q * 0.25)
        base = np.zeros((12, 2), np.float32)
        base[6:, 1] = -q * 0.25                  # exact in f32
        return [*xs, base]
    if case == "degenerate":     # empty and length-1 traces
        return [np.zeros((0, 2), np.float32),
                rng.uniform(-100, 100, (1, 2)).astype(np.float32),
                np.zeros((0, 2), np.float32)]
    raise AssertionError(case)


_MODE = {"i8": 2, "uniform": 2, "i16": 1, "f32": 0, "nan": 0,
         "step127": 2, "step128": 1, "degenerate": 2}


def _same_prep(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:4], b[1:4]):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    if a[0] == 0:
        assert a[4] is None and b[4] is None
    else:
        assert a[4].dtype == b[4].dtype and a[4].tobytes() == b[4].tobytes()


@pytest.mark.parametrize("case", sorted(_MODE))
def test_prepare_slice_c_equals_numpy_and_reference(case, monkeypatch):
    """The port's C prepare against its numpy form and both of the JAX
    package's forms: mode, padded points, lens, origins and payload
    bytes; threaded and single-threaded."""
    rng = np.random.default_rng(sorted(_MODE).index(case))
    for _ in range(10):
        xys = _xys(case, rng)
        b = 16
        while b < max((len(x) for x in xys), default=1):
            b *= 2
        py = npp.prepare_slice_python(xys, b)
        assert py[0] == _MODE[case]
        _same_prep(npp.prepare_slice(xys, b), py)
        with monkeypatch.context() as mp:     # threaded at this size
            mp.setattr(npp, "THREADED_MIN_POINTS", 1)
            _same_prep(npp.prepare_slice(xys, b), py)
        _same_prep(j_npp.prepare_slice_python(xys, b), py)
        ref = j_npp.prepare_slice(xys, b)
        if ref is not None:
            _same_prep(ref, py)


def test_prepare_slice_rejects_a_trace_past_its_bucket():
    with pytest.raises(ValueError, match="exceeds bucket"):
        npp.prepare_slice([np.zeros((20, 2), np.float32)], 16)


@pytest.mark.parametrize("case", ["finite", "nonfinite"])
def test_morton_keys_c_equals_numpy_and_reference(case):
    rng = np.random.default_rng(3)
    first = rng.uniform(-5e5, 5e5, (500, 2))
    if case == "nonfinite":
        first[::7, 0] = np.nan
        first[3::11, 1] = np.inf
        first[5::13, 0] = -np.inf
        first[9] = [1e300, -1e300]
    keys = npp.morton_keys(first)
    py = npp.morton_keys_python(first)
    assert keys.dtype == py.dtype == np.uint64
    assert keys.tobytes() == py.tobytes()
    assert j_npp.morton_keys_python(first).tobytes() == py.tobytes()
    ref = j_npp.morton_keys(first)
    if ref is not None:
        assert ref.tobytes() == py.tobytes()


# ---- walk ----------------------------------------------------------------

def _load(name):
    with open(os.path.join(_FIX, name)) as f:
        return json.load(f)


def _port_tile(jts):
    arrays = {f: getattr(jts, f) for f in _ARRAY_FIELDS}
    return TileSet.from_arrays(jts.name, jts.meta.origin_lonlat, arrays)


def _tile(which):
    if which == "golden":
        fx = _load("golden_traces.json")[0]
        return compile_network(generate_city(fx["city"]),
                               CompilerParams(**fx["compiler"]))
    if which == "irregular":
        from reporter_tpu.netgen.osm_xml import parse_osm_xml

        fx = _load("golden_irregular.json")[0]
        net = parse_osm_xml(os.path.join(_FIX, "irregular.osm"),
                            name="irregular")
        return compile_network(net, CompilerParams(**fx["compiler"]))
    return compile_network(generate_city("sf"))


@pytest.fixture(scope="module", params=["golden", "irregular", "sf"])
def decoded(request):
    """(JAX tile, port tile, port CPU matcher, traces, decoded triples) of
    a fleet on each tile (64 traces on sf), with unmatched runs and chain
    breaks cut into some traces."""
    jts = _tile(request.param)
    ts = _port_tile(jts)
    n = 64 if request.param == "sf" else 16
    fleet = synthesize_fleet(jts, n, num_points=100, seed=7)
    traces = [Trace(p.uuid, p.xy.astype(np.float32), p.times) for p in fleet]
    m = SegmentMatcher(ts, device="cpu")
    dec = [tuple(np.array(a) for a in d) for d in m._decode_many(traces)]
    rng = np.random.default_rng(1)
    for i in range(0, len(dec), 3):
        e, o, s = dec[i]
        lo = int(rng.integers(5, 60))
        e[lo:lo + int(rng.integers(1, 15))] = -1          # unmatched run
        s[int(rng.integers(1, len(s)))] = True            # chain break
    # a jump to a far edge: the route fails and the chain splits
    e = dec[1][0]
    e[50] = (int(e[49]) + ts.num_edges // 2) % ts.num_edges
    return jts, ts, m, traces, dec


def _arrays(traces, dec):
    B, T = len(dec), max(len(d[0]) for d in dec)
    edges = np.full((B, T), -1, np.int32)
    offs = np.zeros((B, T), np.float32)
    starts = np.zeros((B, T), np.uint8)
    times = np.zeros((B, T), np.float64)
    for b, ((e, o, s), t) in enumerate(zip(dec, traces)):
        edges[b, :len(e)], offs[b, :len(e)], starts[b, :len(e)] = e, o, s
        times[b, :len(e)] = t.times[:len(e)]
    return edges, offs, starts, times


def test_walk_columns_equal_reference_walker(decoded):
    """NativeWalker.walk_columns against the JAX package's NativeWalker on
    the same decoded arrays: every column, byte for byte."""
    jts, ts, _, traces, dec = decoded
    ref_walker = make_native_walker(jts)
    if ref_walker is None:
        pytest.skip("the JAX package's native library is unavailable")
    args = (*_arrays(traces, dec), 10.0)
    got = NativeWalker(ts).walk_columns(*args)
    ref = ref_walker.walk_columns(*args)
    assert got.n_records > 3 * len(traces)
    for f in RecordColumns._fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_walk_equals_python_walk(decoded):
    """NativeWalker.walk against the port's Python walk (build_segments),
    record for record; the unmatched runs and chain breaks included."""
    _, ts, m, traces, dec = decoded
    got = NativeWalker(ts).walk(*_arrays(traces, dec), 10.0)
    want = walk_python(ts, traces, dec, m._route_fn, 10.0)
    assert [[r.to_json() for r in x] for x in got] == \
        [[r.to_json() for r in x] for x in want]
    assert m._walk_decoded(traces, dec) == got


def test_walker_rejects_unsorted_reach_rows(decoded):
    _, ts, _, _, _ = decoded
    bad = TileSet.from_arrays(ts.name, ts.meta.origin_lonlat, ts.arrays())
    row = int(np.argmax((bad.reach_to >= 0).sum(1)))
    bad.reach_to = bad.reach_to.copy()
    bad.reach_to[row, :2] = bad.reach_to[row, 1::-1]
    with pytest.raises(ValueError, match="ascend"):
        NativeWalker(bad)


def test_walker_rejects_bad_arrays(decoded):
    """Shapes that disagree, or an edge id past the tile, raise before the
    C walk could read out of bounds."""
    _, ts, _, traces, dec = decoded
    edges, offs, starts, times = _arrays(traces, dec)
    walker = NativeWalker(ts)
    with pytest.raises(ValueError, match="must all be"):
        walker.walk_columns(edges, offs[:, 1:], starts, times, 10.0)
    edges[0, 0] = ts.num_edges
    with pytest.raises(ValueError, match="outside the tile"):
        walker.walk_columns(edges, offs, starts, times, 10.0)


@pytest.mark.parametrize("name,value", [("kMinSpan", "MIN_RECORD_SPAN"),
                                        ("kQueueSpeed", "QUEUE_SPEED"),
                                        ("kQueueWindow", "QUEUE_WINDOW")])
def test_walker_constants_equal_python_walk(name, value):
    """The C walker's thresholds equal matcher/segments.py's, read from
    the port's walker.cc; MIN_RECORD_SPAN is the wire quantum."""
    from reporter_tpu_torch.ops.match import OFFSET_QUANTUM

    with open(_WALKER_CC) as f:
        m = re.search(rf"{name}\s*=\s*([0-9.]+)", f.read())
    assert m, f"{name} not found in walker.cc"
    assert float(m.group(1)) == getattr(segments, value)
    assert segments.MIN_RECORD_SPAN == OFFSET_QUANTUM


# ---- merging and the batch -----------------------------------------------

def test_merge_of_shuffled_slices_equals_one_walk(decoded):
    """Walk the traces in Morton-like shuffled slices, remap each slice's
    rows to global trace indices, merge: the columns equal one walk of the
    whole batch."""
    _, ts, _, traces, dec = decoded
    walker = NativeWalker(ts)
    edges, offs, starts, times = _arrays(traces, dec)
    whole = walker.walk_columns(edges, offs, starts, times, 10.0)
    perm = np.random.default_rng(5).permutation(len(traces))
    parts = []
    for ws in np.array_split(perm, 3):
        c = walker.walk_columns(edges[ws], offs[ws], starts[ws], times[ws],
                                10.0)
        parts.append(c._replace(trace=ws.astype(np.int32)[c.trace]))
    merged = _merge_columns(parts[::-1])
    for f in RecordColumns._fields:
        assert getattr(merged, f).tobytes() == getattr(whole, f).tobytes(), f
    batch = MatchBatch(merged, len(traces))
    b = record_bounds(whole, len(traces))
    assert [batch[i] for i in range(len(traces))] == \
        [materialize_records(whole, int(b[i]), int(b[i + 1]))
         for i in range(len(traces))]
    assert batch[-1] == batch[len(traces) - 1] and len(batch[2:5]) == 3


def test_match_batch_rejects_unsorted_columns(decoded):
    _, ts, _, traces, dec = decoded
    cols = NativeWalker(ts).walk_columns(*_arrays(traces, dec), 10.0)
    flipped = cols._replace(trace=cols.trace[::-1].copy())
    with pytest.raises(ValueError, match="trace-sorted"):
        MatchBatch(flipped, len(traces))
    with pytest.raises(TypeError):
        MatchBatch(tuple(cols), len(traces))
    with pytest.raises(IndexError):
        MatchBatch(cols, len(traces))[len(traces)]


def test_match_many_cpu_equals_jax_matcher(decoded):
    """The whole path on the CPU: the port's match_many (C prepare,
    overlapped harvest, C column walk → MatchBatch; a prepared batch
    too) against the JAX SegmentMatcher, trace for trace; its stages are
    timed."""
    jts, ts, _, traces, _ = decoded
    jm = JSegmentMatcher(jts, Config(
        matcher_backend="jax",
        matcher=MatcherParams(candidate_backend="dense")))
    m = SegmentMatcher(ts, device="cpu")
    got = m.match_many(traces)
    assert isinstance(got, MatchBatch)
    ref = jm.match_many([JTrace(t.uuid, t.xy, t.times) for t in traces])
    want = [[r.to_json() for r in x] for x in ref]
    assert [[r.to_json() for r in x] for x in got] == want
    ahead = m.prepare_many(traces)
    assert ahead is not None and m.prepare_many(traces[:1]) is None
    assert [[r.to_json() for r in x]
            for x in m.match_many(traces, prepared=ahead)] == want
    st = m.stage_seconds
    assert set(st) == {"prepare", "dispatch", "device", "walk", "wall"}
    assert all(v > 0 for v in st.values())
    assert m.point_counts["points"] == 2 * sum(len(t.xy) for t in traces)


def test_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """No g++, or a g++ that fails: the build raises; nothing falls back
    to the Python forms."""
    monkeypatch.setattr(native_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native_build.build()
    monkeypatch.setattr(native_build.shutil, "which", lambda _: "false")
    with pytest.raises(RuntimeError, match="g.. failed"):
        native_build.build()
    assert not list(tmp_path.glob("*.so"))


# ---- the compiler's C++ reach builder ------------------------------------

@pytest.fixture(scope="module")
def reach_tile():
    """A tile whose node-space rows both builders rebuild: tiny (seed 11)
    compiled by the port's Python builders."""
    from reporter_tpu_torch.config import CompilerParams as PCompilerParams
    from reporter_tpu_torch.netgen.synthetic import (
        generate_city as p_generate_city)
    from reporter_tpu_torch.tiles.compiler import (
        compile_network as p_compile_network)

    return p_compile_network(p_generate_city("tiny", seed=11),
                             PCompilerParams(reach_radius=500.0,
                                             use_native=False))


@pytest.mark.parametrize("radius,max_targets", [(300.0, 16), (500.0, 32),
                                                (800.0, 8), (600.0, 128)])
def test_build_reach_native_equals_python_and_reference(reach_tile, radius,
                                                        max_targets):
    """build_reach_native against the port's Python builder and the JAX
    package's C++ builder: every table byte for byte, the truncated count
    too (rows cut at 8, 16 and 32 targets)."""
    from reporter_tpu.tiles.native import (
        build_reach_native as j_build_reach_native)
    from reporter_tpu_torch.tiles.native import build_reach_native
    from reporter_tpu_torch.tiles.reach import build_reach_tables

    ts = reach_tile
    args = (ts.node_out, ts.edge_src, ts.edge_dst, ts.edge_len, radius,
            max_targets)
    got = build_reach_native(*args)
    want = build_reach_tables(*args)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got[3] == want[3]
    ref = j_build_reach_native(*args)
    if ref is None:
        pytest.skip("the JAX package's native library is unavailable")
    for a, b in zip(got[:3], ref[:3]):
        assert a.tobytes() == b.tobytes()
    assert got[3] == ref[3]


def test_build_reach_native_one_thread_deterministic(reach_tile,
                                                     monkeypatch):
    """Every hardware thread and one thread (REPORTER_TPU_NATIVE_THREADS,
    the JAX package's variable) give the same tables."""
    from reporter_tpu_torch.tiles.native import build_reach_native

    ts = reach_tile
    args = (ts.node_out, ts.edge_src, ts.edge_dst, ts.edge_len, 500.0, 32)
    monkeypatch.delenv("REPORTER_TPU_NATIVE_THREADS", raising=False)
    many = build_reach_native(*args)
    monkeypatch.setenv("REPORTER_TPU_NATIVE_THREADS", "1")
    one = build_reach_native(*args)
    for a, b in zip(many[:3], one[:3]):
        assert a.tobytes() == b.tobytes()
    assert many[3] == one[3]


def test_compiler_honours_use_native(reach_tile, monkeypatch):
    """use_native (the default) calls the C++ builder, False the Python
    one, with the same tile; a failed build raises rather than fall back."""
    from reporter_tpu_torch.config import CompilerParams as PCompilerParams
    from reporter_tpu_torch.netgen.synthetic import (
        generate_city as p_generate_city)
    from reporter_tpu_torch.tiles import compiler, native

    calls = []
    real = native.build_reach_native
    monkeypatch.setattr(native, "build_reach_native",
                        lambda *a: calls.append(1) or real(*a))
    net = p_generate_city("tiny", seed=11)
    c = compiler.compile_network(net, PCompilerParams(reach_radius=500.0))
    assert calls == [1]
    for f in ("reach_to", "reach_dist", "reach_next", "edge_reach_row"):
        assert getattr(c, f).tobytes() == getattr(reach_tile, f).tobytes()

    def broken():
        raise RuntimeError("g++ failed on the host library")

    monkeypatch.setattr(native, "load", broken)
    monkeypatch.setattr(native, "build_reach_native", real)
    with pytest.raises(RuntimeError, match="g.. failed"):
        compiler.compile_network(net, PCompilerParams(reach_radius=500.0))
    compiler.compile_network(net, PCompilerParams(reach_radius=500.0,
                                                  use_native=False))
