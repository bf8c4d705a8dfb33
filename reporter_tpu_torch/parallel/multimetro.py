"""Multi-metro tile sharding (BASELINE config 4: sf + nyc + la on one
mesh).

Counterpart: reporter_tpu/parallel/multimetro.py. Each shard of the
mesh's "tile" axis owns whole metros: every metro's tables are padded to
a common shape and stacked on a leading metro axis, metros go over
"tile" and each metro's rows over "dp"; probes are dispatched to their
metro on the host (``dispatch_traces``, the MoE-style router). Each
device matches only its own metros' rows (no traffic between shards in
the matcher), and the per-OSMLR-row observation histogram of each metro
is summed in i32 over the "dp" shards (the reference's ``psum``).

Beside the reference's tables the stack holds the port's ``seg_sweep``
and ``seg_coarse``, each built from its metro's padded pack (the
kernel reads them, so they follow the padded columns and blocks), and
``edge_osmlr``, which the histogram reads though the port's matcher
does not stage it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.ops.candidates import GridMeta
from reporter_tpu_torch.ops.dense_candidates import (SP_EDGE, _coarse_table,
                                                     _filter_table,
                                                     _sweep_table)
from reporter_tpu_torch.ops.match import MatchOutput, match_traces
from reporter_tpu_torch.parallel.dp import as_tensor, gather
from reporter_tpu_torch.parallel.dp_e2e import _row_blocks
from reporter_tpu_torch.parallel.mesh import Mesh
from reporter_tpu_torch.tiles.tileset import HOST_KEYS, place_tables

_PAD_VALUES: "dict[str, Any]" = {
    # padded cell rows are never gathered (indices clip to the metro's
    # own gw / gh); the bit pattern of edge = -1 anyway, so a stray
    # gather could only give an invalid candidate
    "cell_pack": np.int32(-1).view(np.float32),
    # the sweep does visit padding columns: edge = bitcast(-1) marks them
    # invalid (the other components become NaN, masked before any
    # reduction)
    "seg_pack": np.int32(-1).view(np.float32),
    # NaN boxes never overlap anything: padded blocks are never selected
    "seg_bbox": np.float32(np.nan),
    # the same for the slice quads (rows pad in sync with seg_bbox)
    "seg_sub": np.float32(np.nan),
    # feature rows pad in whole blocks too, gated off by their NaN quads;
    # BIG keeps a stray read conservative
    "seg_feat": np.float32(1e30),
    "reach_to": -1,          # no reachable target
    "reach_dist": np.float32(np.inf),
    "edge_osmlr": -1,
    # lengths / offsets: zero is safe, the padded ids above make sure
    # padded rows are never selected as real candidates
}
# built from the padded pack, not padded themselves
_DERIVED = ("seg_sweep", "seg_coarse")


class StackedTiles(NamedTuple):
    """All metros' tables, shape-padded and stacked on axis 0 (host
    numpy: placed per device by ``make_multimetro_matcher``)."""

    tables: "dict[str, np.ndarray]"   # each [M, ...]
    names: "tuple[str, ...]"
    cell_size: float
    index_radius: float               # uniform grid registration dilation
    num_osmlr: "tuple[int, ...]"      # real OSMLR row count per metro
    osmlr_pad: int                    # padded G (histogram width)
    grids: "tuple[GridMeta, ...]"     # each metro's grid scalars


def _pad_to(arr: np.ndarray, shape: "tuple[int, ...]", fill) -> np.ndarray:
    out = np.full(shape, fill, dtype=arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def _derived(pack: np.ndarray, sub: np.ndarray, feat: np.ndarray) -> dict:
    """seg_sweep and seg_coarse of one metro's padded pack (real columns
    a prefix; padded blocks carry NaN quads)."""
    nb = sub.shape[0]
    quads = sub.reshape(-1, 4)
    half = np.float32(0.5)
    centers = np.stack([(quads[:, 0] + quads[:, 2]) * half,
                        (quads[:, 1] + quads[:, 3]) * half], axis=1)
    real = int((pack[SP_EDGE].view(np.int32) >= 0).sum())
    return {"seg_sweep": _sweep_table(pack),
            "seg_coarse": np.ascontiguousarray(np.concatenate(
                [_coarse_table(feat, centers, nb),
                 _filter_table(pack, quads, real, nb)], axis=1))}


def stack_tilesets(tilesets: Sequence) -> StackedTiles:
    """Pad every metro's tables to common shapes and stack them.

    Requires a uniform compiler cell_size and index_radius; grid origin
    and dims vary per metro and ride along in ``grids``. Stacking is
    positional: duplicate names are legal here, but every name-keyed
    consumer (``dispatch_traces``, the router) requires unique names."""
    cell_sizes = {ts.meta.cell_size for ts in tilesets}
    if len(cell_sizes) != 1:
        raise ValueError(
            f"metros compiled with differing cell_size: {cell_sizes}")
    radii = {ts.meta.index_radius for ts in tilesets}
    if len(radii) != 1:
        raise ValueError(
            f"metros compiled with differing index_radius: {radii}")
    caps = {ts.grid.shape[1] for ts in tilesets}
    if len(caps) != 1:
        # capacity auto-sizes per content, so metros differ: tail-pad the
        # narrower grids with -1 first; cell_pack rows are component-major
        # [8*C] and are built from the grid, so widening the grid up
        # front gives one pack layout
        cap = max(caps)
        tilesets = [ts if ts.grid.shape[1] == cap else dataclasses.replace(
            ts, grid=_pad_to(ts.grid, (ts.grid.shape[0], cap), -1))
            for ts in tilesets]

    host_tables = []
    for ts in tilesets:
        t = {k: v for k, v in ts.host_tables("dense").items()
             if k not in HOST_KEYS and k not in _DERIVED}
        t["cell_pack"] = ts.host_tables("grid")["cell_pack"]
        t["edge_osmlr"] = np.asarray(ts.edge_osmlr)
        host_tables.append(t)

    stacked: "dict[str, np.ndarray]" = {}
    for k in host_tables[0]:
        arrs = [t[k] for t in host_tables]
        shape = tuple(max(a.shape[d] for a in arrs)
                      for d in range(arrs[0].ndim))
        fill = _PAD_VALUES.get(k, 0)
        stacked[k] = np.stack([_pad_to(a, shape, fill) for a in arrs])
    derived = [_derived(stacked["seg_pack"][m], stacked["seg_sub"][m],
                        stacked["seg_feat"][m]) for m in range(len(tilesets))]
    for k in _DERIVED:
        stacked[k] = np.stack([d[k] for d in derived])

    num_osmlr = tuple(len(ts.osmlr_id) for ts in tilesets)
    index_radius = float(radii.pop())
    return StackedTiles(
        tables=stacked,
        names=tuple(ts.name for ts in tilesets),
        cell_size=float(cell_sizes.pop()),
        index_radius=index_radius,
        num_osmlr=num_osmlr,
        osmlr_pad=max(num_osmlr),
        grids=tuple(GridMeta(ox=float(ts.meta.grid_origin[0]),
                             oy=float(ts.meta.grid_origin[1]),
                             cell_size=float(ts.meta.cell_size),
                             gw=int(ts.meta.grid_dims[0]),
                             gh=int(ts.meta.grid_dims[1]),
                             index_radius=index_radius)
                    for ts in tilesets))


def metro_histogram(out: MatchOutput, edge_osmlr: torch.Tensor,
                    gmax: int) -> torch.Tensor:
    """i32 [gmax]: matched-point observations per OSMLR row."""
    rows = torch.where(out.matched,
                       edge_osmlr[torch.clamp_min(out.edge, 0).long()], -1)
    ok = (rows >= 0).reshape(-1)
    hist = torch.zeros(gmax, dtype=torch.int32, device=rows.device)
    return hist.index_add_(0, torch.clamp_min(rows, 0).reshape(-1).long(),
                           ok.to(torch.int32))


def make_multimetro_matcher(mesh: Mesh, stacked: StackedTiles,
                            params: MatcherParams):
    """→ step(points [M, B, T, 2], valid [M, B, T]) → (MatchOutput
    [M, B, T], hist i32 [M, G]), both on the mesh's first device.

    M (metros) must be a multiple of the "tile" axis, B of "dp". ``hist``
    counts matched-point observations per OSMLR row, summed in i32 over
    the "dp" shards: the seed of the streaming speed-histogram path
    (BASELINE config 5)."""
    if params.search_radius > stacked.index_radius:
        raise ValueError(
            f"search_radius ({params.search_radius}) exceeds index_radius "
            f"({stacked.index_radius})")
    n_tile, n_dp = mesh.shape["tile"], mesh.shape["dp"]
    M = len(stacked.names)
    if M % n_tile:
        raise ValueError(f"{M} metros not divisible by tile axis {n_tile}")
    per_tile = M // n_tile
    gmax = stacked.osmlr_pad
    # metro m's tables on every distinct device of its tile row
    placed: "dict[tuple[int, torch.device], dict]" = {}
    for m in range(M):
        host = {k: v[m] for k, v in stacked.tables.items()}
        for dev in dict.fromkeys(mesh.devices[m // per_tile]):
            placed[m, dev] = place_tables(host, dev)
    out_dev = mesh.devices[0, 0]

    def step(points, valid):
        if points.shape[0] != M:
            raise ValueError(f"points for {points.shape[0]} metros, the "
                             f"stack holds {M}")
        B = points.shape[1]
        if B % n_dp:
            raise ValueError(f"{B} rows per metro not divisible by dp "
                             f"axis {n_dp}")
        outs, hists = [], []
        for m in range(M):
            parts, partial = [], []
            for d, rows in enumerate(_row_blocks(B, n_dp)):
                dev = mesh.devices[m // per_tile, d]
                tbl = placed[m, dev]
                out = match_traces(as_tensor(points[m, rows], dev),
                                   as_tensor(valid[m, rows], dev), tbl,
                                   params, None, stacked.grids[m])
                parts.append(out)
                partial.append(metro_histogram(out, tbl["edge_osmlr"], gmax))
            outs.append(gather(parts, out_dev))
            # the dp reduce: i32 partials summed on one device
            hists.append(torch.stack([h.to(out_dev) for h in partial])
                         .sum(0, dtype=torch.int32))
        return (MatchOutput(*(torch.stack([getattr(o, f) for o in outs])
                              for f in MatchOutput._fields)),
                torch.stack(hists))

    return step


class MetroBatch(NamedTuple):
    """Host-side dispatch result: device inputs and scatter-back indices."""

    points: np.ndarray               # f32 [M, B, T, 2]
    valid: np.ndarray                # bool [M, B, T]
    # [metro][slot] → (caller job idx, chunk start within the job, length);
    # an over-bucket job takes several consecutive slots (each chunk an
    # independent HMM, as matcher/api.py chunks a long trace)
    index: "list[list[tuple[int, int, int]]]"


def dispatch_traces(names: Sequence[str],
                    jobs: "Sequence[tuple[str, np.ndarray]]",
                    dp: int, bucket: int) -> MetroBatch:
    """Route (metro, points [T, 2]) jobs into padded [M, B, T] arrays.

    Jobs longer than ``bucket`` are split into consecutive chunks (one
    slot each). B is the largest per-metro slot count, rounded up to
    dp x the next power of two, so repeated dispatches keep to a few
    shapes; T pads to ``bucket``."""
    if len(set(names)) != len(names):
        # the slot map is name-keyed: duplicates would merge two stack
        # rows' traffic
        raise ValueError(f"duplicate metro names: {list(names)}")
    by_metro: "dict[str, list[tuple[int, int, int]]]" = {n: [] for n in names}
    for j, (metro, xy) in enumerate(jobs):
        if metro not in by_metro:
            raise KeyError(f"unknown metro {metro!r}; have {list(names)}")
        for lo in range(0, max(len(xy), 1), bucket):
            by_metro[metro].append((j, lo, min(bucket, len(xy) - lo)))

    load = max((len(v) for v in by_metro.values()), default=1)
    B = dp * (1 << max(0, (load + dp - 1) // dp - 1).bit_length())
    M = len(names)
    points = np.zeros((M, B, bucket, 2), np.float32)
    valid = np.zeros((M, B, bucket), bool)
    index: "list[list[tuple[int, int, int]]]" = []
    for m, name in enumerate(names):
        slots = []
        for slot, (j, lo, t) in enumerate(by_metro[name]):
            xy = jobs[j][1]
            points[m, slot, :t] = xy[lo:lo + t]
            valid[m, slot, :t] = True
            slots.append((j, lo, t))
        index.append(slots)
    return MetroBatch(points=points, valid=valid, index=index)
