"""ASan/UBSan and TSan runs of the port's host library
(reporter_tpu_torch/native: prepare.cc, walker.cc, reach.cc), the twin of
tests/test_native_sanitizers.py.

Each flavor is built here, in the clean test process (g++ under a
preloaded sanitizer runtime can wedge), then driven in a CHILD started
with the runtime in ``LD_PRELOAD``: an instrumented shared object cannot
load into an uninstrumented interpreter otherwise. The child imports no
torch (libtorch under a preloaded runtime is slow at best and can
wedge): this process compiles a tiny tile with the port and writes the
arrays the C entries read to an ``.npz``; the child loads only numpy,
``native/build.py`` and ctypes, and calls the C entries directly. It
runs the multithreaded paths, the walker on 8 threads, the reach builder
on 4, the grid fill and the slice prepare from 4 Python threads at once
(ctypes releases the GIL), the Morton keys, the report build and the
tail cuts, through the instrumented library and the plain one, and
writes both results. Here the instrumented output must equal the plain
output, and the plain output the port's own wrappers' (NativeWalker,
tiles/native.py, matcher/native_prepare.py) on the same inputs, at
tolerance 0.

A runtime the toolchain lacks skips; so does a preloaded no-op
interpreter that hangs or fails (the environment, not our code), and
a child that wedges after a passing probe (the known TSan interceptor
wedge of tests/test_native_sanitizers.py), each naming its reason. A
failed instrumented build, a sanitizer report or a differing output
fails.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import CompilerParams
from reporter_tpu_torch.matcher import native_prepare as npp
from reporter_tpu_torch.matcher.native_walk import NativeWalker
from reporter_tpu_torch.native import build as native_build
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.native import (build_grid_native,
                                             build_reach_native)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_TIMEOUT_S = 60
# a working sanitizer runs this tiny workload in seconds; a wedge must
# not eat the suite's budget
CHILD_TIMEOUT_S = 150
REACH_RADIUS, REACH_M = 500.0, 32
GRID = dict(lo=np.zeros(2, np.float32), cell_size=100.0, gw=12, gh=12,
            capacity=8)
PREP_BUCKET = 128

_CHILD = r"""
import ctypes, sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from reporter_tpu_torch.native import build as nb

flavor, src, dst = sys.argv[1:4]
z = dict(np.load(src))
P = ctypes.POINTER
i8, i16, i32, i64 = (ctypes.c_int8, ctypes.c_int16, ctypes.c_int32,
                     ctypes.c_int64)
u8, u64, f32, f64 = (ctypes.c_uint8, ctypes.c_uint64, ctypes.c_float,
                     ctypes.c_double)


def p(a, t):
    return a.ctypes.data_as(P(t))


def walk(lib):
    e, B, T = z["edges"], *z["edges"].shape
    cap = 2 * B * T + 64
    wcap = 8 * cap
    cols = [np.empty(cap, d) for d in (np.int32, np.int64, np.float64,
                                       np.float64, np.float64, np.float64,
                                       np.uint8)]
    way_off = np.empty(cap + 1, np.int32)
    way_ids = np.empty(wcap, np.int64)
    nw = i64(0)
    n = lib.reporter_walk_segments(
        p(e, i32), p(z["offs"], f32), p(z["starts"], u8), p(z["times"], f64),
        B, T, p(z["edge_len"], f32), p(z["edge_way"], i64),
        p(z["edge_osmlr"], i32), p(z["edge_osmlr_off"], f32),
        p(z["osmlr_id"], i64), p(z["osmlr_len"], f32),
        p(z["edge_reach_row"], i32), p(z["reach_to"], i32),
        p(z["reach_dist"], f32), p(z["reach_next"], i32),
        z["reach_to"].shape[1], 10.0, 8,
        *(p(c, t) for c, t in zip(cols, (i32, i64, f64, f64, f64, f64, u8))),
        cap, p(way_off, i32), p(way_ids, i64), wcap, ctypes.byref(nw))
    assert n <= cap and nw.value <= wcap, (n, nw.value)
    names = ("trace", "segment_id", "start_time", "end_time", "length",
             "queue_length", "internal")
    got = {k: c[:n].copy() for k, c in zip(names, cols)}
    got["way_off"] = way_off[:n + 1].astype(np.int64)
    got["way_ids"] = way_ids[:int(way_off[n]) if n else 0].copy()
    return got


def reach(lib):
    node_out = z["node_out"]
    N, D = node_out.shape
    M = int(z["reach_m"])
    to = np.full((N, M), -1, np.int32)
    dist = np.full((N, M), np.inf, np.float32)
    nxt = np.full((N, M), -1, np.int32)
    trunc = lib.reporter_build_reach(
        p(node_out, i32), N, D, p(z["edge_dst"], i32), p(z["edge_len"], f32),
        float(z["reach_radius"]), M, 4, p(to, i32), p(dist, f32),
        p(nxt, i32))
    return {"to": to, "dist": dist, "next": nxt,
            "truncated": np.int64(trunc)}


def grid(lib):
    smin, smax, (lox, loy) = z["smin"], z["smax"], z["grid_lo"]
    x0, y0, x1, y1 = (np.ascontiguousarray(a, np.float32) for a in
                      (smin[:, 0], smin[:, 1], smax[:, 0], smax[:, 1]))
    gw, gh, cap = (int(v) for v in z["grid_shape"])
    g = np.full((gw * gh, cap), -1, np.int32)
    counts = np.zeros(gw * gh, np.int32)
    over = lib.reporter_build_grid(
        p(x0, f32), p(y0, f32), p(x1, f32), p(y1, f32), len(x0),
        float(lox), float(loy), float(z["grid_cell"]), gw, gh, cap,
        p(g, i32), p(counts, i32))
    return {"grid": g, "overflow": np.int64(over)}


def prepare(lib):
    flat, offs = z["xy_flat"], z["xy_offs"]
    B, b = len(offs) - 1, int(z["bucket"])
    out = {"pts": np.empty((B, b, 2), np.float32),
           "lens": np.empty(B, np.int32),
           "origins": np.empty((B, 2), np.float32),
           "dq16": np.empty((B, b, 2), np.int16),
           "d8": np.empty((B, b, 2), np.int8)}
    out["mode"] = np.int64(lib.reporter_prepare_slice(
        p(flat, f32), p(offs, i64), B, b, 4, p(out["pts"], f32),
        p(out["lens"], i32), p(out["origins"], f32), p(out["dq16"], i16),
        p(out["d8"], i8)))
    return out


def reports(lib, w):
    n, nt = len(w["trace"]), int(z["n_traces"])
    outs = [np.empty(n, d) for d in (np.int64, np.int64, np.float64,
                                     np.float64, np.float64, np.float64)]
    per = np.empty(max(nt, int(w["trace"].max(initial=-1)) + 1, 1), np.int64)
    R = lib.reporter_build_reports(
        p(w["trace"], i32), p(w["segment_id"], i64), p(w["start_time"], f64),
        p(w["end_time"], f64), p(w["length"], f64),
        p(w["queue_length"], f64), p(w["internal"], u8), n,
        float(z["min_length"]), len(per),
        *(p(o, t) for o, t in zip(outs, (i64, i64, f64, f64, f64, f64))),
        p(per, i64))
    names = ("seg", "nxt", "t0", "t1", "length", "queue")
    return {**{k: o[:R] for k, o in zip(names, outs)}, "per_trace": per}


def misc(lib):
    first = z["first"]
    keys = np.empty(len(first), np.uint64)
    lib.reporter_morton_keys(p(first, f64), len(first), p(keys, u64))
    bounds = z["cut_bounds"]
    V = len(bounds) - 1
    lo = np.empty(V, np.int64)
    lib.reporter_tail_cuts(p(z["cut_times"], f64), p(bounds, i64), V,
                           p(z["cut_from"], f64), int(z["cut_max"]),
                           p(lo, i64))
    return {"morton": keys, "cuts": lo}


def concurrently(fn, lib, n=4):
    with ThreadPoolExecutor(max_workers=n) as pool:
        runs = [f.result() for f in [pool.submit(fn, lib) for _ in range(n)]]
    for other in runs[1:]:        # concurrent calls agree with each other
        for k, v in runs[0].items():
            np.testing.assert_array_equal(v, other[k])
    return runs[0]


res = {}
for tag, lib in (("san", nb.load(flavor)), ("plain", nb.load())):
    w = walk(lib)
    parts = {"walk": w, "reach": reach(lib), "grid": concurrently(grid, lib),
             "prep": concurrently(prepare, lib), "rep": reports(lib, w),
             "misc": misc(lib)}
    for part, d in parts.items():
        for k, v in d.items():
            res[f"{tag}.{part}.{k}"] = v
np.savez(dst, **res)
assert "torch" not in sys.modules, "the sanitized child imported torch"
print("SANITIZED-OK", len(res["plain.walk.trace"]))
"""


def _runtime_path(name: str) -> "str | None":
    try:
        out = subprocess.run(["g++", f"-print-file-name={name}"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    path = out.stdout.strip()
    return path if path and os.path.isabs(path) else None


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The tile's arrays and every entry's inputs, in one .npz, and the
    port wrappers' results on them (what the child's plain output must
    equal)."""
    ts = compile_network(generate_city("tiny", seed=19),
                         CompilerParams(use_native=False))
    rng = np.random.default_rng(3)
    B, T = 48, 96
    edges = rng.integers(-1, ts.num_edges, size=(B, T)).astype(np.int32)
    offs = rng.uniform(0, 50, size=(B, T)).astype(np.float32)
    starts = (rng.random((B, T)) < 0.1).astype(np.uint8)
    times = np.cumsum(rng.uniform(0.5, 2.0, size=(B, T)), axis=1)
    xys = [np.cumsum(rng.uniform(-10, 10, (int(rng.integers(1, 90)), 2)),
                     axis=0).astype(np.float32) for _ in range(48)]
    smin = rng.uniform(0, 1100, (300, 2)).astype(np.float32)
    smax = (smin + rng.uniform(0, 250, (300, 2))).astype(np.float32)
    cut = dict(cut_times=np.sort(rng.uniform(0, 50, 96)),
               cut_bounds=np.asarray([0, 40, 41, 96], np.int64),
               cut_from=np.asarray([10.0, -1.0, 60.0]), cut_max=16)

    walker = NativeWalker(ts)
    cols = walker.walk_columns(edges, offs, starts, times, 10.0)
    min_length = float(cols.length.max() / 2) if cols.n_records else 1.0
    sizes = [len(x) for x in xys]
    first = np.asarray([x[0] for x in xys], np.float64)
    arrays = dict(
        edges=edges, offs=offs, starts=starts, times=times,
        edge_len=np.ascontiguousarray(ts.edge_len, np.float32),
        edge_way=np.ascontiguousarray(ts.edge_way, np.int64),
        edge_osmlr=np.ascontiguousarray(ts.edge_osmlr, np.int32),
        edge_osmlr_off=np.ascontiguousarray(ts.edge_osmlr_off, np.float32),
        osmlr_id=np.ascontiguousarray(ts.osmlr_id, np.int64),
        osmlr_len=np.ascontiguousarray(ts.osmlr_len, np.float32),
        edge_reach_row=np.ascontiguousarray(ts.edge_reach_row, np.int32),
        reach_to=np.ascontiguousarray(ts.reach_to, np.int32),
        reach_dist=np.ascontiguousarray(ts.reach_dist, np.float32),
        reach_next=np.ascontiguousarray(ts.reach_next, np.int32),
        node_out=np.ascontiguousarray(ts.node_out, np.int32),
        edge_dst=np.ascontiguousarray(ts.edge_dst, np.int32),
        reach_radius=REACH_RADIUS, reach_m=REACH_M,
        smin=smin, smax=smax, grid_lo=GRID["lo"],
        grid_cell=GRID["cell_size"],
        grid_shape=np.asarray([GRID["gw"], GRID["gh"], GRID["capacity"]]),
        xy_flat=np.ascontiguousarray(np.concatenate(xys), np.float32),
        xy_offs=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        bucket=PREP_BUCKET, first=first, n_traces=B, min_length=min_length,
        **cut)
    path = tmp_path_factory.mktemp("sanitizers") / "workload.npz"
    np.savez(path, **arrays)

    to, dist, nxt, trunc = build_reach_native(
        ts.node_out, ts.edge_src, ts.edge_dst, ts.edge_len, REACH_RADIUS,
        REACH_M)
    grid, overflow = build_grid_native(smin, smax, **GRID)
    mode, pts, lens, origins, payload = npp.prepare_slice(xys, PREP_BUCKET)
    seg, nxt_seg, t0, t1, length, queue, per_trace = npp.build_reports(
        cols, B, min_length)
    want = {
        "walk.trace": cols.trace, "walk.segment_id": cols.segment_id,
        "walk.start_time": cols.start_time, "walk.end_time": cols.end_time,
        "walk.length": cols.length, "walk.queue_length": cols.queue_length,
        "walk.internal": cols.internal.astype(np.uint8),
        "walk.way_off": cols.way_off, "walk.way_ids": cols.way_ids,
        "reach.to": to, "reach.dist": dist, "reach.next": nxt,
        "reach.truncated": trunc, "grid.grid": grid,
        "grid.overflow": overflow, "prep.mode": mode, "prep.pts": pts,
        "prep.lens": lens, "prep.origins": origins,
        {2: "prep.d8", 1: "prep.dq16"}.get(mode, "prep.none"): payload,
        "rep.seg": seg, "rep.nxt": nxt_seg, "rep.t0": t0, "rep.t1": t1,
        "rep.length": length, "rep.queue": queue,
        "rep.per_trace": per_trace,
        "misc.morton": npp.morton_keys(first),
        "misc.cuts": npp.tail_cuts(cut["cut_times"], cut["cut_bounds"],
                                   cut["cut_from"], cut["cut_max"])}
    want.pop("prep.none", None)
    return path, want


def test_the_workload_drives_every_entry(workload):
    """The inputs reach the paths the sanitizers watch: records with
    ways, truncated reach rows absent or counted, a full grid cell
    (overflow), an i8 or i16 prepare, and non-empty reports."""
    _, want = workload
    assert len(want["walk.trace"]) > 100
    assert len(want["walk.way_ids"]) > 0
    assert want["grid.overflow"] > 0
    assert want["prep.mode"] in (1, 2)
    assert len(want["rep.seg"]) > 0
    assert (want["reach.to"] >= 0).any()


@pytest.mark.parametrize("flavor,runtime", [
    ("asan", "libasan.so"), ("tsan", "libtsan.so")])
def test_sanitized_host_library(flavor, runtime, workload, tmp_path):
    rt = _runtime_path(runtime)
    if rt is None:
        pytest.skip(f"{runtime} not available from g++")
    # built HERE (a failed build raises: a failure, not a skip), with the
    # plain library the child compares against
    native_build.build(flavor)
    native_build.build()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "LD_PRELOAD")}
    env.update(PYTHONPATH=_ROOT, LD_PRELOAD=rt,
               # leak checking sees the interpreter's own allocations:
               # the point is memory errors and races in the library
               ASAN_OPTIONS="detect_leaks=0",
               TSAN_OPTIONS="halt_on_error=1")
    try:
        probe = subprocess.run([sys.executable, "-c", "print('PROBE-OK')"],
                               capture_output=True, text=True,
                               timeout=PROBE_TIMEOUT_S, env=env)
    except subprocess.TimeoutExpired:
        pytest.skip(f"{runtime} preloaded hangs a no-op interpreter in "
                    f"this environment ({PROBE_TIMEOUT_S} s probe)")
    if "PROBE-OK" not in probe.stdout:
        pytest.skip(f"{runtime} preloaded cannot run a no-op interpreter "
                    f"here: {probe.stderr[-500:]!r}")
    src, want = workload
    dst = tmp_path / f"{flavor}.npz"
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, flavor, str(src), str(dst)],
            capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
            env=env, cwd=_ROOT)
    except subprocess.TimeoutExpired as exc:
        err = (exc.stderr or b"")
        err = err.decode(errors="replace") if isinstance(err, bytes) else err
        pytest.skip(f"the {flavor} child wedged past {CHILD_TIMEOUT_S} s "
                    f"after its runtime probe passed (the sanitizer "
                    f"interceptor wedge of tests/test_native_sanitizers.py)"
                    f"; stderr tail: {err[-300:]!r}")
    for marker in ("ERROR: AddressSanitizer", "runtime error:",
                   "WARNING: ThreadSanitizer"):
        assert marker not in proc.stderr, proc.stderr[-3000:]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SANITIZED-OK" in proc.stdout, proc.stderr[-2000:]
    got = dict(np.load(dst))
    for key, value in want.items():
        np.testing.assert_array_equal(got[f"san.{key}"], got[f"plain.{key}"],
                                      err_msg=f"{flavor}: {key}")
        np.testing.assert_array_equal(got[f"plain.{key}"], value,
                                      err_msg=f"wrapper: {key}")
