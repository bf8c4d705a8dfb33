"""Shared stream-worker state: the histogram delta flush, the commit
floor, the overrun skip and the checkpoint file.

Counterpart: reporter_tpu/streaming/state.py, with the same npz schema
(``state`` JSON bytes, ``hist``, ``hist_flushed``, ``qhist``,
``qhist_flushed``), so a checkpoint written by the JAX worker restores
into the port's and the other way round. Both pipeline flavors (the dict
StreamPipeline and the columnar ColumnarStreamPipeline) speak this one
implementation; they are duck-typed over the attribute surface used
here."""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Sequence

import numpy as np

from reporter_tpu_torch import faults


def commit_floor(consumed: Sequence[int],
                 holds: "Iterable[tuple[int, int]]") -> list:
    """Committed offsets = the consumer's read position clamped below
    every HOLD — ONE implementation for both pipeline flavors so the
    at-least-once floor rule cannot drift between them.

    A hold (partition, offset) is anything whose loss a crash must be
    able to replay: the oldest record in a per-uuid buffer (dict
    pipeline), the oldest unflushed log row (columnar), and — pipelined —
    the oldest record of any wave whose publish attempt hasn't completed.
    A checkpoint stores exactly this floor, so restoring replays every
    record that had not made it out the far side of the publisher."""
    floor = list(consumed)
    for p, off in holds:
        if off < floor[p]:
            floor[p] = off
    return floor


def poll_with_overrun_skip(pl, poll, p: int, max_records: int):
    """Poll partition ``p`` from pl._consumed[p], absorbing a drop-oldest
    overrun — ONE implementation of the broker-shed protocol for both
    pipeline flavors (the twin of commit_floor, and for the same reason).

    A LookupError from below the retention floor normally means
    unrecoverable data loss and re-raises; but when the broker exposes
    ``retention_floor`` and the floor has genuinely advanced past our
    read position, the records were SHED by an overload policy: skip to
    the floor, count the gap in ``pl.overrun`` (explicit, never silent),
    and poll again. ``poll(p, offset, max_records)`` is the pipeline's
    poll callable; returns its result."""
    while True:
        try:
            return poll(p, pl._consumed[p], max_records)
        except LookupError:
            floor_fn = getattr(pl.queue, "retention_floor", None)
            if floor_fn is None:
                raise
            floor = int(floor_fn(p))
            if floor <= pl._consumed[p]:
                raise              # not an overrun: a real offset bug
            pl.overrun += floor - pl._consumed[p]
            pl._consumed[p] = floor


def flush_histogram_delta(pl) -> int:
    """Publish the per-segment speed + queue histogram DELTA since the
    last flush (BASELINE config 5). Returns the number
    of segments flushed. The baseline advances only on successful
    publish, so a failed POST retries the same delta next interval.

    ``pl``: any pipeline with hist/qhist, _hist_flushed/_qhist_flushed,
    _hist_flush_at, clock, config, _osmlr_ids, publisher, hist_flushes.
    """
    snap = pl.hist.snapshot()
    qsnap = pl.qhist.snapshot()
    delta = snap - pl._hist_flushed
    qdelta = qsnap - pl._qhist_flushed
    rows = np.nonzero(delta.sum(axis=1))[0]
    qrows = np.nonzero(qdelta.sum(axis=1))[0]
    pl._hist_flush_at = pl.clock()
    if not len(rows) and not len(qrows):
        return 0
    payload = {
        "mode": pl.config.service.mode,
        "bin_edges_mps": list(pl.config.streaming.speed_bins),
        "histograms": [
            {"segment_id": int(pl._osmlr_ids[r]),
             "counts": delta[r].astype(int).tolist()}
            for r in rows
        ],
        "queue_bin_edges_m": list(pl.config.streaming.queue_bins),
        "queue_histograms": [
            {"segment_id": int(pl._osmlr_ids[r]),
             "counts": qdelta[r].astype(int).tolist()}
            for r in qrows
        ],
    }
    if pl.publisher.publish_json(payload):
        pl._hist_flushed = snap
        pl._qhist_flushed = qsnap
        pl.hist_flushes += 1
        # Count any segment with a published delta (speed OR queue):
        # callers use 0 to mean "nothing flushed / publish failed".
        return int(len(np.union1d(rows, qrows)))
    return 0


def save_checkpoint(path: str, committed: list, cache_dump: dict,
                    hist_snap, hist_flushed, qhist_snap,
                    qhist_flushed) -> None:
    """One-file snapshot: offsets + uuid cache + both histograms.

    Buffers are NOT stored: committed offsets sit at the oldest unflushed
    record, so replaying from them reconstructs every buffer exactly —
    the buffer is derived state, the log is the truth.

    ATOMIC: the snapshot is written to a tmp file, fsync'd, and renamed
    over the old one — a worker killed mid-checkpoint (the chaos leg
    SIGKILLs exactly here sometimes) leaves either the old complete
    snapshot or the new complete snapshot, never a torn npz that a
    restart would crash parsing. The ``checkpoint`` fault site fires
    between write and rename: the simulated death the contract covers."""
    state = {
        "committed": committed,
        "cache": cache_dump,
        "saved_at": time.time(),   # wall clock: outage spans processes
    }
    if not path.endswith(".npz"):
        path += ".npz"   # savez appends it; normalize so restore matches
    tmp = path + ".tmp.npz"        # savez would append .npz to a bare tmp
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            state=np.frombuffer(json.dumps(state).encode(), dtype=np.uint8),
            hist=hist_snap,
            hist_flushed=hist_flushed,
            qhist=qhist_snap,
            qhist_flushed=qhist_flushed)
        f.flush()
        os.fsync(f.fileno())
    faults.fire("checkpoint")      # injected mid-checkpoint death: tmp is
    #                                on disk, the rename never happens —
    #                                the previous snapshot must survive
    os.replace(tmp, path)


def load_checkpoint(path: str, pl) -> dict:
    """Restore histograms + flush baselines into ``pl`` (hist, qhist,
    _hist_flushed, _qhist_flushed) and return the JSON state
    {committed, cache, saved_at}. Handles pre-queue / pre-baseline
    checkpoints the way the original restore() did."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        state = json.loads(bytes(z["state"]).decode())
        pl.hist.load(z["hist"])
        if "hist_flushed" in z.files:
            pl._hist_flushed = z["hist_flushed"]
        else:   # older checkpoint: re-flush everything (at-least-once)
            pl._hist_flushed = np.zeros_like(pl.hist.snapshot())
        if "qhist" in z.files:
            pl.qhist.load(z["qhist"])
            pl._qhist_flushed = z["qhist_flushed"]
        else:   # pre-queue checkpoint: start the queue track empty
            pl.qhist.load(np.zeros_like(pl.qhist.snapshot()))
            pl._qhist_flushed = pl.qhist.snapshot()
    return state
