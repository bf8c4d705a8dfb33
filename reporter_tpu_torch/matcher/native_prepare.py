"""The host prepare of ``match_many`` and the stream pipelines' report
build, in C and in numpy.

Counterpart: reporter_tpu/matcher/native_prepare.py (``prepare_slice``,
``prepare_slice_python``, ``morton_keys``, ``morton_keys_python``,
``build_reports``, ``tail_cuts``, ``tail_cuts_python``). Each function has
a C form (native/prepare.cc, one pass over a flat buffer) and a plain
numpy form with byte-identical outputs: the numpy form is the
specification the C entry implements and what the tests hold it against
(``build_reports``'s is ``streaming/columnar.build_report_columns``).
``SegmentMatcher`` and the columnar stream pipeline serve the C forms on
both devices (this is host code); a library that does not build raises
(native/build.py), where the JAX package's bindings return None.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from reporter_tpu_torch.native import build as native_build
from reporter_tpu_torch.ops.dense_candidates import _morton
from reporter_tpu_torch.ops.match import OFFSET_QUANTUM as _QUANTUM


def prepare_slice_python(xys: Sequence[np.ndarray], b: int):
    """Pad → i16 quantize → i8 delta pack of one bucket slice. Returns
    (mode, pts, lens, origins, payload): mode 2 ⇒ payload is the i8 delta
    wire, 1 ⇒ the i16 absolute wire (a step overflowed ±127 quanta), 0 ⇒
    f32 points (a trace spans past the i16 range, or carries NaN/inf,
    which fail the float gate by NaN propagation) and no payload."""
    B = len(xys)
    pts = np.zeros((B, b, 2), np.float32)
    lens = np.zeros(B, np.int32)
    L = len(xys[0]) if xys else 0
    if L and all(len(xy) == L for xy in xys):
        pts[:, :L] = np.stack(xys)
        pts[:, L:] = pts[:, :1]        # pad at origin: keeps i16 range
        lens[:] = L
    else:
        for r, xy in enumerate(xys):
            pts[r, :len(xy)] = xy
            if len(xy):
                pts[r, len(xy):] = xy[0]
                lens[r] = len(xy)
    origins = pts[:, 0, :].copy()
    dq = np.round((pts - origins[:, None, :]) * np.float32(1.0 / _QUANTUM))
    if np.abs(dq).max(initial=0.0) < 32767:
        dqi = dq.astype(np.int32)
        d8 = np.diff(dqi, axis=1, prepend=dqi[:, :1] * 0)
        d8[np.arange(b)[None, :] >= lens[:, None]] = 0
        if np.abs(d8).max(initial=0) < 128:
            return 2, pts, lens, origins, d8.astype(np.int8)
        return 1, pts, lens, origins, dqi.astype(np.int16)
    return 0, pts, lens, origins, None


# slices of at least this many padded points are prepared on several
# threads (a row each at a time)
THREADED_MIN_POINTS = 65536


def prepare_slice(xys: Sequence[np.ndarray], b: int):
    """prepare_slice_python in one C pass over a flat buffer, threaded
    across rows for slices of THREADED_MIN_POINTS padded points or more;
    the same return tuple. A trace longer than the bucket raises
    ValueError (the numpy form's broadcast fails too)."""
    lib = native_build.load()
    B = len(xys)
    sizes = np.fromiter((len(xy) for xy in xys), np.int64, count=B)
    if B and int(sizes.max()) > b:
        raise ValueError(
            f"trace of {int(sizes.max())} points exceeds bucket {b}")
    offs = np.zeros(B + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    if int(offs[-1]):
        flat = np.ascontiguousarray(np.concatenate(xys), np.float32)
    else:
        flat = np.zeros((1, 2), np.float32)     # a non-null base pointer
    pts = np.empty((B, b, 2), np.float32)
    lens = np.empty(B, np.int32)
    origins = np.empty((B, 2), np.float32)
    dq16 = np.empty((B, b, 2), np.int16)
    d8 = np.empty((B, b, 2), np.int8)
    n_threads = 1 if B * b < THREADED_MIN_POINTS \
        else min(8, os.cpu_count() or 1)
    ptr = native_build.ptr
    mode = lib.reporter_prepare_slice(
        ptr(flat, ctypes.c_float), ptr(offs, ctypes.c_int64), B, int(b),
        int(n_threads), ptr(pts, ctypes.c_float),
        ptr(lens, ctypes.c_int32), ptr(origins, ctypes.c_float),
        ptr(dq16, ctypes.c_int16), ptr(d8, ctypes.c_int8))
    payload = d8 if mode == 2 else dq16 if mode == 1 else None
    return int(mode), pts, lens, origins, payload


def morton_keys_python(first: np.ndarray) -> np.ndarray:
    """Keys of [W, 2] f64 first points at 64 m resolution, biased positive
    so negative tile-local coordinates keep locality (the sweep's segment
    blocking curve, ops/dense_candidates._morton)."""
    q = np.floor(first / 64.0).astype(np.int64) + 0x8000
    return _morton((q[:, 0] & 0xFFFF).astype(np.uint32),
                   (q[:, 1] & 0xFFFF).astype(np.uint32))


def morton_keys(first: np.ndarray) -> np.ndarray:
    """morton_keys_python in C: u64 keys, bit-equal (non-finite points
    included)."""
    lib = native_build.load()
    first = np.ascontiguousarray(first, np.float64)
    keys = np.empty(len(first), np.uint64)
    lib.reporter_morton_keys(native_build.ptr(first, ctypes.c_double),
                             len(first),
                             native_build.ptr(keys, ctypes.c_uint64))
    return keys


# ---------------------------------------------------------------------------
# The streaming half: the columnar report build and the tail cuts


def build_reports(cols, n_traces: "int | None", min_length: float):
    """streaming/columnar.build_report_columns in one C pass: the same
    return tuple (seg, nxt, t0, t1, length, queue, per_trace), per_trace
    None when ``n_traces`` is None."""
    lib = native_build.load()
    n = cols.n_records
    if not n:
        z = np.empty(0, np.int64)
        zf = np.empty(0)
        return z, z, zf, zf, zf, zf, (
            None if n_traces is None else np.zeros(n_traces, np.int64))
    ptr = native_build.ptr
    trace = np.ascontiguousarray(cols.trace, np.int32)
    seg = np.ascontiguousarray(cols.segment_id, np.int64)
    t0 = np.ascontiguousarray(cols.start_time, np.float64)
    t1 = np.ascontiguousarray(cols.end_time, np.float64)
    length = np.ascontiguousarray(cols.length, np.float64)
    queue = np.ascontiguousarray(cols.queue_length, np.float64)
    internal = np.ascontiguousarray(cols.internal, np.bool_).view(np.uint8)
    out_seg = np.empty(n, np.int64)
    out_nxt = np.empty(n, np.int64)
    out_t0 = np.empty(n, np.float64)
    out_t1 = np.empty(n, np.float64)
    out_len = np.empty(n, np.float64)
    out_queue = np.empty(n, np.float64)
    # np.bincount(minlength=n_traces) grows past minlength when trace ids
    # exceed it: size the C buffer the same way
    nt = -1 if n_traces is None else max(int(n_traces),
                                         int(trace.max()) + 1)
    per_trace = np.empty(max(nt, 1), np.int64)
    R = int(lib.reporter_build_reports(
        ptr(trace, ctypes.c_int32), ptr(seg, ctypes.c_int64),
        ptr(t0, ctypes.c_double), ptr(t1, ctypes.c_double),
        ptr(length, ctypes.c_double), ptr(queue, ctypes.c_double),
        ptr(internal, ctypes.c_uint8), n, float(min_length), nt,
        ptr(out_seg, ctypes.c_int64), ptr(out_nxt, ctypes.c_int64),
        ptr(out_t0, ctypes.c_double), ptr(out_t1, ctypes.c_double),
        ptr(out_len, ctypes.c_double), ptr(out_queue, ctypes.c_double),
        ptr(per_trace, ctypes.c_int64)))
    return (out_seg[:R], out_nxt[:R], out_t0[:R], out_t1[:R],
            out_len[:R], out_queue[:R],
            None if n_traces is None else per_trace[:nt])


def tail_cuts_python(time_flat: np.ndarray, bounds: np.ndarray,
                     from_time: np.ndarray, max_points: int) -> np.ndarray:
    """Per vehicle v (times sorted ascending): lo = max(max(0,
    first_at_or_after(from_time) - 1), n - max_points); lo >= n means
    retain nothing (ColumnarTraceCache.retain's cut)."""
    V = len(bounds) - 1
    lo = np.empty(V, np.int64)
    for v in range(V):
        t = time_flat[bounds[v]:bounds[v + 1]]
        at = np.nonzero(t >= from_time[v])[0]
        cut = max(0, int(at[0]) - 1) if len(at) else max(0, len(t) - 1)
        lo[v] = max(cut, len(t) - max_points)
    return lo


def tail_cuts(time_flat: np.ndarray, bounds: np.ndarray,
              from_time: np.ndarray, max_points: int) -> np.ndarray:
    """tail_cuts_python in C: one lower bound per vehicle."""
    lib = native_build.load()
    ptr = native_build.ptr
    time_flat = np.ascontiguousarray(time_flat, np.float64)
    bounds = np.ascontiguousarray(bounds, np.int64)
    from_time = np.ascontiguousarray(from_time, np.float64)
    V = len(bounds) - 1
    lo = np.empty(max(V, 1), np.int64)
    lib.reporter_tail_cuts(
        ptr(time_flat, ctypes.c_double), ptr(bounds, ctypes.c_int64), V,
        ptr(from_time, ctypes.c_double), int(max_points),
        ptr(lo, ctypes.c_int64))
    return lo[:V]
