"""The host prepare of ``match_many``, in C and in numpy.

Counterpart: reporter_tpu/matcher/native_prepare.py (``prepare_slice``,
``prepare_slice_python``, ``morton_keys``, ``morton_keys_python``). Each
function has a C form (native/prepare.cc, one pass over a flat buffer) and
a ``_python`` form with byte-identical outputs: the numpy form is the
specification the C entry implements and what the tests hold it against.
``SegmentMatcher`` serves the C form on both devices (this is host code);
a library that does not build raises (native/build.py).
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
