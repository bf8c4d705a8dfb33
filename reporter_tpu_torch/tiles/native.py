"""numpy-facing wrappers of the host library's tile builders.

Counterpart: reporter_tpu/tiles/native.py (``build_reach_native``,
``build_grid_native``). The tile compiler calls them unless
``CompilerParams(use_native=False)``; the library is built by g++ at
first use (native/build.py), and a failed build raises: nothing falls
back to the Python builders. The reach tables equal tiles/reach.py's
``build_reach_tables`` bit for bit, the grid the fill loop of
tiles/compiler.py's ``_build_grid``, overflow count included.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from reporter_tpu_torch.native.build import load, ptr


def build_reach_native(node_out: np.ndarray, edge_src: np.ndarray,
                       edge_dst: np.ndarray, edge_len: np.ndarray,
                       radius: float, max_targets: int,
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The C++ twin of tiles.reach.build_reach_tables: (reach_to,
    reach_dist, reach_next, truncated nodes), node-keyed [N, max_targets].
    Its threads: REPORTER_TPU_NATIVE_THREADS, the JAX package's variable
    (0 or unset: every hardware thread)."""
    lib = load()
    n_threads = int(os.environ.get("REPORTER_TPU_NATIVE_THREADS", "0"))
    num_nodes, deg = node_out.shape
    node_out = np.ascontiguousarray(node_out, np.int32)
    edge_dst = np.ascontiguousarray(edge_dst, np.int32)
    edge_len = np.ascontiguousarray(edge_len, np.float32)
    reach_to = np.full((num_nodes, max_targets), -1, dtype=np.int32)
    reach_dist = np.full((num_nodes, max_targets), np.inf, dtype=np.float32)
    reach_next = np.full((num_nodes, max_targets), -1, dtype=np.int32)
    truncated = lib.reporter_build_reach(
        ptr(node_out, ctypes.c_int32), num_nodes, deg,
        ptr(edge_dst, ctypes.c_int32), ptr(edge_len, ctypes.c_float),
        float(radius), int(max_targets), int(n_threads),
        ptr(reach_to, ctypes.c_int32), ptr(reach_dist, ctypes.c_float),
        ptr(reach_next, ctypes.c_int32))
    return reach_to, reach_dist, reach_next, int(truncated)


def build_grid_native(smin: np.ndarray, smax: np.ndarray, lo: np.ndarray,
                      cell_size: float, gw: int, gh: int, capacity: int,
                      ) -> "tuple[np.ndarray, int]":
    """The C++ twin of the fill loop of tiles.compiler._build_grid: each
    segment registered in every cell its dilated box [smin, smax] (f32
    [S, 2] each) overlaps, from origin ``lo`` (f32 [2]). → (grid i32
    [gw*gh, capacity] -1 padded, registrations dropped)."""
    lib = load()
    x0, y0, x1, y1 = (np.ascontiguousarray(a, np.float32)
                      for a in (smin[:, 0], smin[:, 1], smax[:, 0],
                                smax[:, 1]))
    lo = np.asarray(lo, np.float32)
    grid = np.full((gw * gh, capacity), -1, dtype=np.int32)
    counts = np.zeros(gw * gh, dtype=np.int32)
    overflow = lib.reporter_build_grid(
        ptr(x0, ctypes.c_float), ptr(y0, ctypes.c_float),
        ptr(x1, ctypes.c_float), ptr(y1, ctypes.c_float), len(x0),
        float(lo[0]), float(lo[1]), float(np.float32(cell_size)),
        int(gw), int(gh), int(capacity),
        ptr(grid, ctypes.c_int32), ptr(counts, ctypes.c_int32))
    return grid, int(overflow)
