"""Open-loop batch backfill: a durable spool replayed into device-resident
aggregates.

Counterpart: reporter_tpu/backfill/engine.py (``BackfillConfig``,
``BackfillEngine``), single-device. A durable broker spool, records or
columnar (streaming/durable_queue.py, durable_columnar.py, both in the
JAX package's on-disk formats), goes through three stages:

  1. a read-ahead thread polls waves (``poll_records`` per partition),
     groups each wave's points into per-uuid traces, splits them into
     groups of ``slice_traces`` padded to a scheduler trace-count rung
     with traces far off the tile (``_PAD_XY``; they match nothing), and
     runs the host prepare per slice (``plan_submit``,
     ``prepare_submit_slice``) into a bounded queue;
  2. the main loop dispatches each prepared slice through the matcher's
     wire entries (``submit_prepared``, the sweep kernel, Viterbi and
     pack on the card), keeping up to ``max_inflight`` outstanding;
  3. each harvest takes one ``.cpu()`` of the oldest wire, walks it
     (``walk_wire_columns``, the C walk), builds the reports
     (``build_report_columns``) and scatters them into the two
     FixedGridCounts grids (backfill/aggregate.py): speed × time of day,
     and next-segment turns. No per-wave readback of the grids; the
     k-anonymity cutoff runs once, at ``harvest()``.

A uuid's points split across waves become separate traces: the open loop
keeps no cross-wave cache. Waves complete in FIFO order, so when a wave's
last slice lands no later wave has contributed: the commit floor moves
past whole waves only, the ``backfill`` fault site fires once per
completed wave, and a checkpoint (streaming/state.py's npz schema, the
JAX package's) is taken at a wave boundary every
``checkpoint_every_waves``. A killed run resumes at the floor and
replays whole waves: the grids stay coverage-exact and the replay tax is
counted (``records_total`` in the cache dump adds up across runs).

``stage_seconds`` splits the main loop's time: "dispatch" (queueing the
wire entries), "device" (the wait in ``.cpu()``), "walk" (unpack and C
walk), "aggregate" (report build, binning and scatter); the read-ahead
thread's prepare is "prepare" (overlapped).

The mesh arm: ``mesh=`` (a parallel.mesh.Mesh), or ``mesh_devices`` /
``RTPU_BACKFILL_MESH`` = N, which builds ``make_mesh(dp=N)`` over the
first N visible cards, for a matcher the engine builds itself. A
provided matcher's ``wire_mesh`` is authoritative: the grids' partials
live on the mesh its wire dispatches shard over, and a different
``mesh=`` raises. Each group's wire entries then run once per shard.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from reporter_tpu_torch import faults
from reporter_tpu_torch.backfill.aggregate import (DEFAULT_TOD_BINS,
                                                   DEFAULT_TURN_SLOTS,
                                                   AggregateStore,
                                                   SpeedTodHistogram,
                                                   TurnCounts,
                                                   harvest_aggregates)
from reporter_tpu_torch.config import Config
from reporter_tpu_torch.geometry import lonlat_to_xy
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.service.scheduler import _TRACE_RUNGS
from reporter_tpu_torch.streaming import state as stream_state
from reporter_tpu_torch.streaming.columnar import (build_report_columns,
                                                   pack_records)
from reporter_tpu_torch.streaming.durable_columnar import (
    DurableColumnarIngestQueue)
from reporter_tpu_torch.streaming.durable_queue import (DurableIngestQueue,
                                                        read_broker_format)

# padding traces sit far outside any metro tile (tile-local meters), so
# they match nothing and add no records
_PAD_XY = 1.0e7

@dataclass(frozen=True)
class BackfillConfig:
    """Open-loop engine knobs (environment: RTPU_BACKFILL_*)."""

    slice_traces: int = 64         # traces per submit group (a scheduler
    #                                trace-count rung)
    max_inflight: int = 4          # chained dispatches outstanding
    readahead_slices: int = 4      # prepared slices buffered ahead
    poll_records: int = 16384      # broker records per partition per
    #   wave. A wave is also a uuid's trace boundary: size waves in
    #   vehicle-minutes, or most segments come out partial
    k_anonymity: int = 5           # harvest cutoff (0: any observation)
    tod_bins: int = DEFAULT_TOD_BINS
    turn_slots: int = DEFAULT_TURN_SLOTS
    checkpoint_path: "str | None" = None
    checkpoint_every_waves: int = 8
    mesh_devices: int = 0          # 0 = one device; N >= 1 builds a
    #   data-parallel mesh over the first N cards (make_mesh(dp=N)) when
    #   the engine builds its own matcher; a provided matcher or mesh wins

    def validate(self) -> "BackfillConfig":
        if self.slice_traces not in _TRACE_RUNGS:
            raise ValueError(
                f"backfill.slice_traces={self.slice_traces} is not a "
                f"scheduler trace-count rung {_TRACE_RUNGS} — off-rung "
                "slices grow the compiled-shape universe")
        for f, lo in (("max_inflight", 1), ("readahead_slices", 1),
                      ("poll_records", 1), ("k_anonymity", 0),
                      ("tod_bins", 1), ("turn_slots", 1),
                      ("checkpoint_every_waves", 1), ("mesh_devices", 0)):
            if getattr(self, f) < lo:
                raise ValueError(f"backfill.{f} must be >= {lo}")
        return self

    def with_env_overrides(self, env=None) -> "BackfillConfig":
        """RTPU_BACKFILL_K, _INFLIGHT, _READAHEAD and _MESH, as integers;
        an empty value is unset."""
        env = os.environ if env is None else env
        out = self
        for var, field in (("RTPU_BACKFILL_K", "k_anonymity"),
                           ("RTPU_BACKFILL_INFLIGHT", "max_inflight"),
                           ("RTPU_BACKFILL_READAHEAD", "readahead_slices"),
                           ("RTPU_BACKFILL_MESH", "mesh_devices")):
            raw = env.get(var)
            if raw is None or raw == "":
                continue
            try:
                val = int(raw)
            except ValueError:
                raise ValueError(f"{var}={raw!r} is not an integer")
            out = replace(out, **{field: val})
        return out


class _Group:
    """One rung-padded submit group (a wave, or a split of one): the
    bookkeeping of FIFO completion and the commit floor."""

    __slots__ = ("traces", "work", "n_real", "remaining", "offsets",
                 "n_records")

    def __init__(self, traces, work, n_real, remaining, offsets, n_records):
        self.traces = traces
        self.work = work
        self.n_real = n_real
        self.remaining = remaining
        self.offsets = offsets      # reader offsets after the wave's
        #                             records (None on a non-final split)
        self.n_records = n_records


_DONE = object()
STAGES = ("prepare", "dispatch", "device", "walk", "aggregate")


class BackfillEngine:
    """One tileset, one matcher (built on ``device``, ``cuda`` unless the
    caller passes ``device="cpu"``, or over ``mesh``; or the ``matcher``
    given, whose device or mesh the grids share)."""

    def __init__(self, tileset, config: "Config | None" = None,
                 bf: "BackfillConfig | None" = None,
                 matcher: "SegmentMatcher | None" = None,
                 store: "AggregateStore | None" = None, mesh=None,
                 device: "str | torch.device | None" = None):
        self.ts = tileset
        self.bf = (bf or BackfillConfig()).with_env_overrides().validate()
        if matcher is not None:
            if mesh is not None and matcher.wire_mesh is not mesh:
                raise ValueError(
                    "backfill mesh= must be the provided matcher's "
                    "wire_mesh (the aggregate partials shard over the mesh "
                    "the wire dispatches on): pass one or the other")
            mesh = matcher.wire_mesh
            self.matcher = matcher
        else:
            if mesh is None and self.bf.mesh_devices:
                from reporter_tpu_torch.parallel.mesh import make_mesh

                mesh = make_mesh(dp=self.bf.mesh_devices)
            self.matcher = (SegmentMatcher(tileset, config, mesh=mesh)
                            if mesh is not None else
                            SegmentMatcher(tileset, config, device=device))
        self.mesh = mesh
        if self.matcher.backend != "torch":
            raise ValueError("backfill dispatches through the device wire "
                             "entries: it needs matcher_backend='torch'")
        self.config = self.matcher.config
        self.metrics = self.matcher.metrics
        self.store = store or AggregateStore()
        self._osmlr_ids = np.asarray(tileset.osmlr_id)
        self._row_order = np.argsort(self._osmlr_ids, kind="stable")
        self._row_sorted = self._osmlr_ids[self._row_order]
        rows = len(self._osmlr_ids)
        dev = self.matcher.device
        # streaming/state.py's checkpoint reads hist, qhist and the flush
        # baselines (which stay empty: backfill publishes once, at harvest)
        self.hist = SpeedTodHistogram(rows, self.config.streaming.speed_bins,
                                      self.bf.tod_bins, mesh=mesh, device=dev)
        self.qhist = TurnCounts(rows, self.bf.turn_slots, mesh=mesh,
                                device=dev)
        self._hist_flushed = np.zeros(0, np.int32)
        self._qhist_flushed = np.zeros(0, np.int32)
        self._records_prior = 0     # records of earlier (crashed) runs
        self._shadow = None
        self.stats: "dict[str, int | float]" = {}
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)

    def enable_shadow_reference(self) -> None:
        """Accumulate a host numpy twin of both grids (the same
        flat_cells, np.add.at for the scatter), so a run can check the
        device grids against it (``shadow_identical``). Fresh runs only:
        a resumed grid starts ahead of the zeroed twin."""
        self._shadow = {
            "hist": np.zeros(self.hist._grid.size, np.int32),
            "turns": np.zeros(self.qhist._grid.size, np.int32),
        }

    def shadow_identical(self) -> "bool | None":
        """Both device grids equal their host twins (None without a
        shadow)."""
        if self._shadow is None:
            return None
        return bool(
            np.array_equal(self.hist.snapshot().reshape(-1),
                           self._shadow["hist"])
            and np.array_equal(self.qhist.snapshot().reshape(-1),
                               self._shadow["turns"]))

    # ---- spool → traces (the reader thread) --------------------------------

    def _wave_traces(self, cols) -> "tuple[list[Trace], int, int]":
        """One wave's ProbeColumns → per-uuid time-sorted traces, with the
        malformed points and the short (one-point) traces dropped."""
        good = ~np.isnan(cols.lat)
        malformed = int((~good).sum())
        cols = cols.rows(good)
        if not cols.n:
            return [], malformed, 0
        t = np.where(np.isnan(cols.time), np.arange(cols.n, dtype=np.float64),
                     cols.time)
        order = np.lexsort((t, cols.uuid))
        u, lat, lon = cols.uuid[order], cols.lat[order], cols.lon[order]
        tt, acc = t[order], cols.accuracy[order]
        xy = lonlat_to_xy(np.stack([lon, lat], axis=1),
                          np.asarray(self.ts.meta.origin_lonlat))
        bounds = np.concatenate([[0], np.nonzero(u[1:] != u[:-1])[0] + 1,
                                 [len(u)]])
        traces, short = [], 0
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi - lo < 2:
                short += 1
                continue
            a = acc[lo:hi]
            traces.append(Trace(
                uuid=str(u[lo]), xy=xy[lo:hi].astype(np.float32),
                times=tt[lo:hi].astype(np.float64),
                accuracy=(np.nan_to_num(a, nan=0.0).astype(np.float32)
                          if np.isfinite(a).any() else None)))
        return traces, malformed, short

    @staticmethod
    def _pad_to_rung(traces: "list[Trace]") -> "list[Trace]":
        rung = next((r for r in _TRACE_RUNGS if r >= len(traces)),
                    _TRACE_RUNGS[-1])
        pad = [Trace(uuid="", times=np.asarray([0.0, 1.0]),
                     xy=np.asarray([[_PAD_XY, _PAD_XY],
                                    [_PAD_XY, _PAD_XY + 1.0]], np.float32))
               for _ in range(rung - len(traces))]
        return list(traces) + pad

    def _reader(self, queue, fmt: str, nparts: int, ends: "list[int]",
                out_q, stop: threading.Event, err: list) -> None:
        """Poll waves, build the rung groups, run the host prepare and
        feed the bounded slice queue (its bound is the read-ahead)."""
        try:
            offsets = list(self._consumed)
            while not stop.is_set():
                if all(offsets[p] >= ends[p] for p in range(nparts)):
                    break
                recs = 0
                wave_cols = []
                for p in range(nparts):
                    if offsets[p] >= ends[p]:
                        continue
                    want = min(self.bf.poll_records, ends[p] - offsets[p])
                    if fmt == "columnar":
                        got = queue.poll_batch(p, offsets[p], want)
                        n = sum(c.n for _, c in got)
                        wave_cols.extend(c for _, c in got)
                    else:
                        got = queue.poll(p, offsets[p], want)
                        n = len(got)
                        if n:
                            wave_cols.append(
                                pack_records([r for _, r in got]))
                    offsets[p] += n
                    recs += n
                if not recs:
                    break                       # the static spool is read
                t0 = time.perf_counter()
                cols = (wave_cols[0] if len(wave_cols) == 1 else
                        type(wave_cols[0])(*(np.concatenate(parts)
                                             for parts in zip(*wave_cols))))
                traces, malformed, short = self._wave_traces(cols)
                self.stats["malformed"] += malformed
                self.stats["short_traces"] += short
                # split an oversized wave; the offsets ride its last group,
                # so the commit floor only passes whole waves
                chunks = [traces[i:i + self.bf.slice_traces]
                          for i in range(0, len(traces),
                                         self.bf.slice_traces)] or [[]]
                for j, part in enumerate(chunks):
                    last = j == len(chunks) - 1
                    padded = self._pad_to_rung(part)
                    work, sliced = self.matcher.plan_submit(padded)
                    group = _Group(padded, work, len(part), len(sliced),
                                   list(offsets) if last else None,
                                   recs if last else 0)
                    for b, ws in sliced:
                        ps = self.matcher.prepare_submit_slice(
                            padded, work, b, ws)
                        self.stage_seconds["prepare"] += (
                            time.perf_counter() - t0)
                        if stop.is_set():
                            return
                        out_q.put((group, ws, ps))
                        t0 = time.perf_counter()
            out_q.put(_DONE)
        except BaseException as exc:    # noqa: BLE001 - relayed to main loop
            err.append(exc)
            out_q.put(_DONE)

    # ---- harvest and aggregation (the main loop) ----------------------------

    def _harvest(self, group: _Group, ws, wire, done_q) -> None:
        t0 = time.monotonic()
        arr = wire.cpu().numpy()             # the one sync of this slice
        t1 = time.monotonic()
        cols, _ = self.matcher.walk_wire_columns(group.traces, group.work,
                                                 ws, arr)
        t2 = time.monotonic()
        rep = build_report_columns(
            cols, None, self.config.service.min_segment_length)
        seg, nxt, rt0, rt1, rlen, _rqueue, _ = rep
        if len(seg):
            pos = np.searchsorted(self._row_sorted, seg)
            pos = np.minimum(pos, len(self._row_sorted) - 1)
            rows = np.where(self._row_sorted[pos] == seg,
                            self._row_order[pos], -1).astype(np.int64)
            dur = rt1 - rt0
            okd = dur > 0
            speeds = rlen[okd] / np.maximum(dur[okd], 1e-9)
            self.hist.update(rows[okd], rt0[okd], speeds)
            self.qhist.update(rows, nxt)
            if self._shadow is not None:
                for key, cells in (
                        ("hist", self.hist.flat_cells(rows[okd], rt0[okd],
                                                      speeds)),
                        ("turns", self.qhist.flat_cells(rows, nxt))):
                    hit = cells[cells >= 0]
                    np.add.at(self._shadow[key], hit, np.int32(1))
            self.stats["reports"] += int(len(seg))
        t3 = time.monotonic()
        self.stage_seconds["device"] += t1 - t0
        self.stage_seconds["walk"] += t2 - t1
        self.stage_seconds["aggregate"] += t3 - t2
        self.metrics.count("backfill_chunks_total")
        self.metrics.observe("backfill_chunk_seconds", t3 - t0)
        self.stats["chunks"] += 1
        group.remaining -= 1
        if group.remaining == 0:
            done_q.append(group)

    def _complete_groups(self, done_q) -> None:
        """FIFO wave completions: counters, the commit floor, the fault
        site and the wave-boundary checkpoint."""
        while done_q:
            group = done_q.pop(0)
            self.metrics.count("backfill_traces_total", group.n_real)
            self.stats["traces"] += group.n_real
            if group.offsets is not None:
                self.metrics.count("backfill_records_total",
                                   group.n_records)
                self.metrics.count("backfill_waves_total")
                self.stats["records"] += group.n_records
                self.stats["waves"] += 1
                self._consumed = list(group.offsets)
                faults.fire("backfill")
                if (self.bf.checkpoint_path and self.stats["waves"]
                        % self.bf.checkpoint_every_waves == 0):
                    self._write_checkpoint()

    def _write_checkpoint(self) -> None:
        cache = {"turn_legend": self.qhist.dump_legend(),
                 "records_total": self._records_prior
                 + self.stats["records"]}
        stream_state.save_checkpoint(
            self.bf.checkpoint_path, list(self._consumed), cache,
            self.hist.snapshot(), self._hist_flushed,
            self.qhist.snapshot(), self._qhist_flushed)

    def _load_checkpoint(self) -> None:
        path = self.bf.checkpoint_path
        if not path:
            return
        npz = path if path.endswith(".npz") else path + ".npz"
        if not os.path.exists(npz):
            return
        state = stream_state.load_checkpoint(path, self)
        self._consumed = [int(x) for x in state["committed"]]
        cache = state.get("cache", {}) or {}
        self.qhist.load_legend(cache.get("turn_legend", {}))
        self._records_prior = int(cache.get("records_total", 0))

    # ---- the run --------------------------------------------------------

    def run(self, broker_dir: str) -> dict:
        """Replay the whole spool → the run's stats (the harvested,
        k-anonymized document lands in ``self.store``)."""
        fmt = read_broker_format(broker_dir)
        if fmt is None:
            raise ValueError(f"{broker_dir}: not a broker directory "
                             "(no meta.json)")
        with open(os.path.join(broker_dir, "meta.json")) as f:
            nparts = int(json.load(f)["num_partitions"])
        queue_cls = (DurableColumnarIngestQueue if fmt == "columnar"
                     else DurableIngestQueue)
        queue = queue_cls(broker_dir, nparts)
        self.stats = {k: 0 for k in ("records", "traces", "waves", "chunks",
                                     "reports", "malformed", "short_traces")}
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self._consumed = [0] * nparts
        self._load_checkpoint()
        try:
            ends = [queue.end_offset(p) for p in range(nparts)]
            spool_records = sum(ends[p] - queue.retention_floor(p)
                                for p in range(nparts))
            out_q: "_queue.Queue" = _queue.Queue(
                maxsize=self.bf.readahead_slices)
            stop = threading.Event()
            err: list = []
            reader = threading.Thread(
                target=self._reader,
                args=(queue, fmt, nparts, ends, out_q, stop, err),
                name="backfill-reader", daemon=True)
            t0 = time.monotonic()
            reader.start()
            inflight: "list[tuple]" = []
            done_q: "list[_Group]" = []
            try:
                while True:
                    item = out_q.get()
                    if item is _DONE:
                        break
                    group, ws, ps = item
                    td = time.monotonic()
                    wire = self.matcher.submit_prepared(ps)
                    self.stage_seconds["dispatch"] += time.monotonic() - td
                    inflight.append((group, ws, wire))
                    self.metrics.gauge("backfill_inflight", len(inflight))
                    if len(inflight) >= self.bf.max_inflight:
                        self._harvest(*inflight.pop(0), done_q)
                        self._complete_groups(done_q)
                while inflight:
                    self._harvest(*inflight.pop(0), done_q)
                    self._complete_groups(done_q)
                self.metrics.gauge("backfill_inflight", 0)
                if err:
                    raise err[0]
                # every wave aggregated: the floor is the spool's end
                self._consumed = list(ends)
                if self.bf.checkpoint_path:
                    self._write_checkpoint()
            finally:
                stop.set()
                # unblock a reader waiting on a full slice queue
                while not out_q.empty():
                    try:
                        out_q.get_nowait()
                    except _queue.Empty:     # pragma: no cover - race
                        break
                reader.join(timeout=30.0)
            seconds = max(time.monotonic() - t0, 1e-9)
        finally:
            queue.close()
        doc = self.harvest()
        records_total = self._records_prior + self.stats["records"]
        self.stats.update(
            format=fmt, partitions=nparts, seconds=round(seconds, 3),
            records_total=records_total,
            replay_tax_records=max(0, records_total - spool_records),
            krows_per_s=round(self.stats["records"] / seconds / 1e3, 3),
            kanon_dropped=doc["kanon_dropped"],
            kept_segments=len(doc["segments"]))
        return dict(self.stats)

    def harvest(self) -> dict:
        """The host harvest and k-anonymity cutoff; installs the document
        in the store and returns it."""
        doc = harvest_aggregates(self.hist, self.qhist, self._osmlr_ids,
                                 self.bf.k_anonymity)
        self.metrics.gauge("backfill_kanon_dropped", doc["kanon_dropped"])
        self.store.install(doc)
        return doc
