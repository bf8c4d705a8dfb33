"""StreamPipeline: the matcher worker of the streaming path.

Counterpart: reporter_tpu/streaming/pipeline.py. Consume partitions,
buffer points per uuid, and when enough points or time have gathered,
flush the buffered traces through the same match, filter and publish
pipeline the HTTP service uses (the port's ReporterApp, pinned to
``batching="combine"`` as the JAX worker pins it: the flush loop is a
single caller, so the scheduler's close wait would tax every flush for
nothing). Speed and queue histograms live on the matcher's device
(streaming/histogram.py).

Recovery: offsets are committed only up to the oldest record still in a
buffer, so a crash and restore replays exactly the unflushed tail:
at-least-once, duplicates possible, loss impossible. A flush matches
before it drops the buffers, so a flush that raises keeps the commit
floor where it was.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Sequence

import numpy as np
import torch

from reporter_tpu_torch.config import Config
from reporter_tpu_torch.service.app import ReporterApp
from reporter_tpu_torch.service.datastore import Transport
from reporter_tpu_torch.streaming.broker import ProbeConsumer
from reporter_tpu_torch.streaming.histogram import SpeedHistogram
from reporter_tpu_torch.streaming.queue import IngestQueue
from reporter_tpu_torch.tiles.tileset import TileSet
from reporter_tpu_torch.utils import tracing

# inherited trace ids recorded per span are BOUNDED: a wave may cover
# thousands of probes, and span args must stay a small payload (the
# traced count rides alongside so truncation is visible)
_TRACE_IDS_PER_SPAN = 8


class _Buffer:
    __slots__ = ("points", "first_offset", "born", "trace_ids", "traced")

    def __init__(self, born: float):
        self.points: list[dict] = []
        self.first_offset: "tuple[int, int] | None" = None  # (partition, offset)
        self.born = born
        self.trace_ids: list[str] = []   # inherited broker trace ids
        self.traced = 0                  # (bounded list + full count)


class StreamPipeline:
    """Single-worker streaming matcher over an IngestQueue, its matcher
    and histograms on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``), or over ``mesh`` (a parallel.mesh.Mesh: the
    matcher's dispatches shard over it, the histograms live on its first
    device)."""

    def __init__(self, tileset: TileSet, config: Config | None = None,
                 queue: ProbeConsumer | None = None,
                 transport: Transport | None = None,
                 clock=time.monotonic,
                 partitions: "Sequence[int] | None" = None,
                 mesh=None,
                 device: "str | torch.device | None" = None):
        self.config = (config or Config()).validate()
        sc = self.config.streaming
        # Any ProbeConsumer works here (streaming/broker.py): the in-proc
        # IngestQueue is the default; an external Kafka/PubSub adapter
        # implementing the same poll/end_offset surface drops in.
        self.queue: ProbeConsumer = queue or IngestQueue(sc.num_partitions)
        if self.queue.num_partitions != sc.num_partitions:
            raise ValueError("queue/config partition count mismatch")
        # Partition assignment (the Kafka consumer-group analog):
        # each worker owns a disjoint subset; uuid-hash routing guarantees a
        # vehicle's records live in exactly one partition, so per-worker
        # buffers never overlap. Reassigning a dead worker's partitions to a
        # live pipeline (constructed at the dead worker's committed offsets)
        # replays its unflushed tail — at-least-once, like a group rebalance.
        owned = range(sc.num_partitions) if partitions is None else partitions
        self.partitions = sorted(set(int(p) for p in owned))
        if any(p < 0 or p >= sc.num_partitions for p in self.partitions):
            raise ValueError(
                f"partitions {self.partitions} out of range "
                f"0..{sc.num_partitions - 1}")
        # The flush loop is a single-threaded internal caller: the serving
        # scheduler's close wait (batch_close_ms) and executor handoff
        # would tax every flush for nothing, so the embedded app takes the
        # direct combine path (the worker's own overlap machinery is the
        # pipelined columnar flush).
        app_cfg = dataclasses.replace(
            self.config, service=dataclasses.replace(self.config.service,
                                                     batching="combine"))
        self.app = ReporterApp(tileset, app_cfg, transport=transport,
                               device=device, mesh=mesh)
        self.clock = clock
        self.committed = [0] * sc.num_partitions
        self._consumed = [0] * sc.num_partitions   # read position (ahead of committed)
        self._buffers: dict[str, _Buffer] = {}
        dev = self.app.matcher.device
        self.hist = SpeedHistogram(len(tileset.osmlr_id), sc.speed_bins,
                                   device=dev)
        # Same device-resident accumulator, binned by queue_length (meters
        # backed up from the stop line) — every report contributes one
        # observation, so bin 0 counts queue-free traversals too.
        self.qhist = SpeedHistogram(len(tileset.osmlr_id), sc.queue_bins,
                                    device=dev)
        self._row_of = {int(sid): i for i, sid in enumerate(tileset.osmlr_id)}
        self._osmlr_ids = np.asarray(tileset.osmlr_id)
        self._hist_flushed = self.hist.snapshot()   # delta-flush baseline
        self._qhist_flushed = self.qhist.snapshot()
        self._hist_flush_at = self.clock()
        self.hist_flushes = 0
        self.steps = 0
        self.malformed = 0
        self.overrun = 0    # records lost to broker drop-oldest shed
        # broker-propagated trace context: spans this worker records
        # carry the trace ids inherited from producer-stamped records
        self._tracer = tracing.tracer()
        self.traced_records = 0

    @property
    def publisher(self):
        """The app's datastore publisher (shared state.py helpers address
        the publisher uniformly across both pipeline flavors)."""
        return self.app.publisher

    # ---- one poll/flush cycle -------------------------------------------

    def step(self, force_flush: bool = False) -> int:
        """Consume available records, flush ripe buffers, commit offsets.

        Returns the number of reports produced this step.
        """
        from reporter_tpu_torch.streaming.state import poll_with_overrun_skip

        sc = self.config.streaming
        with self._tracer.span("consume"):
            for p in self.partitions:
                pairs = poll_with_overrun_skip(
                    self, lambda pp, off, n: self.queue.poll(pp, off, n),
                    p, sc.poll_max_records)
                for off, rec in pairs:
                    self._consume(p, off, rec)
                    self._consumed[p] = off + 1

        now = self.clock()
        ripe = [u for u, b in self._buffers.items()
                if force_flush
                or len(b.points) >= sc.flush_min_points
                or (b.points and now - b.born >= sc.flush_max_age)]
        n_reports = self._flush(ripe) if ripe else 0
        self._commit()
        if (sc.hist_flush_interval > 0
                and now - self._hist_flush_at >= sc.hist_flush_interval):
            self.flush_histograms()
        self.steps += 1
        return n_reports

    def drain(self) -> int:
        """Flush everything (shutdown path)."""
        return self.step(force_flush=True)

    def _consume(self, p: int, off: int, rec: dict) -> None:
        uuid = str(rec.get("uuid", ""))
        try:
            # Full conversion before any state change: a poison record must
            # be droppable, never allowed to wedge its partition. Finiteness
            # included: float('nan') converts fine here but would fail the
            # service validator at FLUSH time, where the points are already
            # buffered and a raising flush retries forever.
            lat = float(rec["lat"])
            lon = float(rec["lon"])
            t = float(rec["time"]) if "time" in rec else None
            if not (math.isfinite(lat) and math.isfinite(lon)
                    and (t is None or math.isfinite(t))):
                raise ValueError("non-finite coordinate")
        except (KeyError, TypeError, ValueError):
            self.malformed += 1
            return                                   # malformed: skip
        if not uuid:
            self.malformed += 1
            return
        buf = self._buffers.get(uuid)
        if buf is None:
            buf = self._buffers[uuid] = _Buffer(self.clock())
        if buf.first_offset is None:
            buf.first_offset = (p, off)
        tid = tracing.trace_id_of(rec)
        if tid is not None:
            self.traced_records += 1
            buf.traced += 1
            if len(buf.trace_ids) < _TRACE_IDS_PER_SPAN:
                buf.trace_ids.append(tid)
        if t is None:
            # Timeless producer: index seconds per trace, matching the HTTP
            # path's convention (app._validate_payload), not the partition
            # offset (which interleaves across uuids).
            t = float(len(buf.points))
        point = {"lat": lat, "lon": lon, "time": t}
        if "accuracy" in rec:   # same optional field the HTTP path keeps
            try:
                acc = float(rec["accuracy"])
                if acc >= 0 and math.isfinite(acc):
                    point["accuracy"] = acc
                # negative OR non-finite would 400 the whole flush at
                # _validate_payload, and match-before-drop would retry
                # that 400 forever — drop the FIELD, keep the point
                # (it is advisory weighting)
            except (TypeError, ValueError):
                pass
        buf.points.append(point)

    def _flush(self, uuids: list[str]) -> int:
        payloads = [{"uuid": u, "trace": self._buffers[u].points}
                    for u in uuids]
        # inherited trace context (bounded) gathered BEFORE the buffers
        # are dropped: the worker_match span below carries them
        span_args: dict = {}
        if self._tracer.enabled:
            ids: list = []
            traced = 0
            for u in uuids:
                b = self._buffers[u]
                traced += b.traced
                if len(ids) < _TRACE_IDS_PER_SPAN:
                    ids.extend(b.trace_ids[:_TRACE_IDS_PER_SPAN
                                           - len(ids)])
            if traced:
                span_args = {"trace_ids": ids, "traced": traced}
        # Match BEFORE dropping buffers: if the matcher or publisher raises,
        # the points stay buffered and keep holding the commit floor down —
        # a supervisor retrying step() re-flushes instead of losing them.
        with self._tracer.span("worker_match", **span_args):
            results = self.app.report_many(payloads)
        for u in uuids:
            self._buffers.pop(u, None)
        n = 0
        rows: list[int] = []
        speeds: list[float] = []
        queues: list[float] = []
        for res in results:
            reports = res["reports"]
            n += len(reports)
            for r in reports:
                dur = r["t1"] - r["t0"]
                if dur <= 0:
                    continue
                rows.append(self._row_of.get(int(r["id"]), -1))
                speeds.append(r["length"] / dur)
                queues.append(r["queue_length"])
        rows_arr = np.asarray(rows, np.int32)
        self.hist.update(rows_arr, np.asarray(speeds, np.float64))
        self.qhist.update(rows_arr, np.asarray(queues, np.float64))
        return n

    def _commit(self) -> None:
        """Advance committed offsets to the oldest still-buffered record
        (shared floor rule — streaming/state.commit_floor)."""
        from reporter_tpu_torch.streaming.state import commit_floor
        self.committed = commit_floor(
            self._consumed,
            (b.first_offset for b in self._buffers.values()
             if b.first_offset is not None))

    # ---- partition membership ---------------------------------------------

    def adopt_partition(self, partition: int, offset: int) -> None:
        """Start consuming ``partition`` at ``offset``: the previous
        owner's committed floor, so a rebalanced partition replays
        exactly the previous owner's unflushed tail (at-least-once,
        zero loss). Adopting an already-owned partition is a caller
        bug."""
        sc = self.config.streaming
        p = int(partition)
        if p < 0 or p >= sc.num_partitions:
            raise ValueError(f"partition {p} out of range "
                             f"0..{sc.num_partitions - 1}")
        if p in self.partitions:
            raise ValueError(f"partition {p} already owned")
        self.partitions = sorted(self.partitions + [p])
        self.committed[p] = int(offset)
        self._consumed[p] = int(offset)

    def release_partition(self, partition: int, flush: bool = True) -> int:
        """Stop consuming ``partition``. ``flush=True`` is the graceful
        handoff: its buffered rows go through the matcher first so the
        final committed floor covers them. ``flush=False`` is the
        lost-lease path: buffered rows are DISCARDED (the new owner
        replays them from the table's floor; publishing here would
        duplicate reports). Returns the number of points discarded
        (always 0 on the flush path). uuid-hash routing pins a
        vehicle's records to one partition, so ``first_offset[0]``
        identifies every affected buffer."""
        p = int(partition)
        if p not in self.partitions:
            return 0
        mine = [u for u, b in self._buffers.items()
                if b.first_offset is not None and b.first_offset[0] == p]
        dropped = 0
        if flush and mine:
            self._flush(mine)
        else:
            for u in mine:
                dropped += len(self._buffers.pop(u).points)
        self.partitions = [q for q in self.partitions if q != p]
        self._commit()
        return dropped

    def flush_histograms(self) -> int:
        """Publish the per-segment speed-histogram DELTA since the last
        flush (BASELINE config 5: "online per-segment speed
        histograms … periodic flush to datastore path"). Returns the number
        of segments flushed. One shared implementation with the columnar
        pipeline — streaming/state.py."""
        from reporter_tpu_torch.streaming.state import flush_histogram_delta
        return flush_histogram_delta(self)

    # ---- observability ---------------------------------------------------

    def stats(self) -> dict[str, Any]:
        out = {
            "steps": self.steps,
            "malformed": self.malformed,
            "lag": sum(self.queue.end_offset(p) - self.committed[p]
                       for p in self.partitions),
            "buffered_uuids": len(self._buffers),
            "buffered_points": sum(len(b.points)
                                   for b in self._buffers.values()),
            "published": self.app.publisher.published,
            "hist_rows": int(len(self.hist.nonzero_rows())),
            "qhist_rows": int(len(self.qhist.nonzero_rows())),
            "overrun": int(self.overrun),
            "traced_records": int(self.traced_records),
            **self.app.stats,
        }
        overload = getattr(self.queue, "overload_stats", None)
        if overload is not None:
            out.update(overload())
        return out

    # ---- checkpoint / resume ----------------------------------------------

    def checkpoint(self, path: str) -> None:
        """Snapshot offsets + uuid cache + histograms to one file (shared
        schema with the columnar pipeline — streaming/state.py: buffers
        are derived state, the offset log is the truth)."""
        from reporter_tpu_torch.streaming.state import save_checkpoint
        save_checkpoint(path, self.committed, self.app.cache.dump(),
                        self.hist.snapshot(), self._hist_flushed,
                        self.qhist.snapshot(), self._qhist_flushed)

    def restore(self, path: str) -> None:
        """Reset to a checkpoint; consumption resumes at the committed
        offsets, replaying the unflushed tail (at-least-once: records whose
        uuid was flushed after the snapshot may produce duplicate reports,
        never lost ones)."""
        from reporter_tpu_torch.streaming.state import load_checkpoint
        state = load_checkpoint(path, self)
        self.committed = list(state["committed"])
        self._consumed = list(state["committed"])
        self._buffers = {}
        outage = max(0.0, time.time() - float(state.get("saved_at", time.time())))
        self.app.cache.load(state["cache"], extra_age=outage)
