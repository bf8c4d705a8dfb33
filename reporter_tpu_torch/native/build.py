"""Lazy build and ctypes binding of the port's host library.

``prepare.cc`` (the host prepare: ``reporter_prepare_slice``,
``reporter_morton_keys``; the streaming half: ``reporter_build_reports``,
``reporter_tail_cuts``) and ``walker.cc`` (the edge walk:
``reporter_walk_segments``) are the host half of ``match_many`` and of
the stream pipelines' report build; ``reach.cc`` (the tile compiler's
node-space reach tables, ``reporter_build_reach``, and the spatial
grid's fill, ``reporter_build_grid``) holds the compiler's default
builders (tiles/native.py). ``g++``
compiles them at first use into ``reporter_tpu_torch/_build/``: one shared
library with a plain C interface, loaded with ``ctypes.CDLL`` (not
``PyDLL``), so a call releases the GIL and a walk can run beside the main
thread's wait on the card. The library is named by a hash of its sources
and the flags, so an edited source rebuilds. The build is warning-clean
(``-Wall -Wextra -Werror``). A missing ``g++`` or a failed build raises;
nothing falls back to the Python forms.

Two instrumented flavors, as the JAX package has
(reporter_tpu/native/build.py): ``"asan"`` (AddressSanitizer and
UndefinedBehaviorSanitizer) and ``"tsan"`` (ThreadSanitizer), each built
under its own content-hashed name (``librtt_sanitized_<flavor>_*.so``).
An instrumented library loads only into a process started with its
runtime preloaded (``LD_PRELOAD``), so ``load(flavor)`` is for such a
child (tests/test_torch_native_sanitizers.py); ``load()`` caches the
default flavor alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parent / "_build"
SOURCES = (_HERE / "prepare.cc", _HERE / "walker.cc", _HERE / "reach.cc")
FLAGS = ("-O3", "-Wall", "-Wextra", "-Werror", "-std=c++17", "-shared",
         "-fPIC")
# the sanitizer flavors: the JAX package's flags (no -Werror there, so
# toolchain notes are not mistaken for races) plus the library's own
_COMMON = ("-std=c++17", "-shared", "-fPIC")
FLAVOR_FLAGS = {
    None: FLAGS,
    "asan": ("-fsanitize=address,undefined", "-fno-omit-frame-pointer",
             "-g", "-O1", *_COMMON),
    "tsan": ("-fsanitize=thread", "-fno-omit-frame-pointer", "-g", "-O1",
             *_COMMON),
}

_lock = threading.Lock()
_loaded: "ctypes.CDLL | None" = None
BUILD_LOG: "dict[str, float]" = {}     # {"seconds": g++ wall time}


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the port's host library "
                           "(native/prepare.cc, walker.cc, reach.cc) is "
                           "built from source at first use")
    return found


def build(flavor: "str | None" = None) -> Path:
    """Compile the sources with ``flavor``'s flags (None: the default
    library) into the build directory, if not already there, and return
    the library's path."""
    if flavor not in FLAVOR_FLAGS:
        raise ValueError(f"unknown flavor {flavor!r}: one of "
                         f"{sorted(k for k in FLAVOR_FLAGS if k)} or None")
    flags = FLAVOR_FLAGS[flavor]
    h = hashlib.sha256(" ".join(flags).encode())
    for f in SOURCES:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    stem = ("librtt_native" if flavor is None
            else f"librtt_sanitized_{flavor}")
    out = _BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = _compiler()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cxx, *flags, "-o", tmp, *map(str, SOURCES), "-lpthread"],
        capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on the host library "
                           f"({flavor or 'default'} flavor, rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    if flavor is None:
        BUILD_LOG["seconds"] = time.perf_counter() - t0
    return out


def load(flavor: "str | None" = None) -> ctypes.CDLL:
    """Build (if needed), load and declare the library. The default
    flavor is cached; an instrumented one is loaded anew on each call and
    needs its sanitizer runtime preloaded in this process."""
    global _loaded
    if flavor is not None:
        lib = ctypes.CDLL(str(build(flavor)))
        _declare(lib)
        return lib
    with _lock:
        if _loaded is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _loaded = lib
        return _loaded


def _declare(lib: ctypes.CDLL) -> None:
    P = ctypes.POINTER
    i8p, i16p, i32p, i64p = (P(ctypes.c_int8), P(ctypes.c_int16),
                             P(ctypes.c_int32), P(ctypes.c_int64))
    u8p, u64p = P(ctypes.c_uint8), P(ctypes.c_uint64)
    f32p, f64p = P(ctypes.c_float), P(ctypes.c_double)
    i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    lib.reporter_prepare_slice.restype = i32
    lib.reporter_prepare_slice.argtypes = [
        f32p, i64p,                              # xy flat, offs
        i64, i64, i32,                           # B, b, n_threads
        f32p, i32p, f32p,                        # pts, lens, origins
        i16p, i8p,                               # dq16, d8
    ]
    lib.reporter_morton_keys.restype = None
    lib.reporter_morton_keys.argtypes = [f64p, i64, u64p]
    lib.reporter_build_reports.restype = i64
    lib.reporter_build_reports.argtypes = [
        i32p, i64p, f64p, f64p,                  # trace, seg, t0, t1
        f64p, f64p, u8p,                         # length, queue, internal
        i64, f64, i64,                           # n, min_length, n_traces
        i64p, i64p, f64p, f64p, f64p, f64p,      # out seg, nxt, t0, t1,
        #                                          length, queue
        i64p,                                    # per_trace
    ]
    lib.reporter_tail_cuts.restype = None
    lib.reporter_tail_cuts.argtypes = [f64p, i64p, i64, f64p, i64, i64p]
    lib.reporter_walk_segments.restype = i64
    lib.reporter_walk_segments.argtypes = [
        i32p, f32p, u8p, f64p,                   # edges, offs, starts, times
        i64, i64,                                # B, T
        f32p, i64p, i32p, f32p,                  # edge_{len,way,osmlr,osmlr_off}
        i64p, f32p,                              # osmlr_{id,len}
        i32p,                                    # reach_row (edge → row)
        i32p, f32p, i32p, i32,                   # reach_{to,dist,next}, M
        f64, i32,                                # backward_slack, n_threads
        i32p, i64p, f64p, f64p, f64p, f64p, u8p,  # record columns
        i64,                                     # rec_cap
        i32p, i64p, i64,                         # way_off, way_ids, way_cap
        i64p,                                    # n_ways_out
    ]
    lib.reporter_build_reach.restype = i64
    lib.reporter_build_reach.argtypes = [
        i32p, i64, i64,                          # node_out, N, D
        i32p, f32p,                              # edge_dst, edge_len
        f64, i32, i32,                           # radius, M, n_threads
        i32p, f32p, i32p,                        # reach_{to,dist,next}
    ]
    f32 = ctypes.c_float
    lib.reporter_build_grid.restype = i64
    lib.reporter_build_grid.argtypes = [
        f32p, f32p, f32p, f32p, i64,             # x0, y0, x1, y1, S
        f32, f32, f32,                           # origin x, y; cell size
        i32, i32, i32,                           # gw, gh, capacity
        i32p, i32p,                              # grid, counts
    ]


def ptr(arr, ctype):
    """A ctypes pointer to a contiguous numpy array's data."""
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
