"""The streaming worker's entry point.

    python -m reporter_tpu_torch.streaming --tiles metro.npz --broker-dir ./broker
        [--checkpoint worker.ckpt] [--partitions 0 1] [--config conf.json]
        [--poll-interval 0.05] [--max-steps N] [--exit-on-drain]
        [--stdin-format auto|json|csv] [--columnar] [--device cuda|cpu]

Counterpart: reporter_tpu/streaming/__main__.py, with its flags, its
behaviour and its exit JSON, and ``--device`` (``cuda`` by default). One
matcher worker: restore the checkpoint if present, consume the durable
broker log from the committed offsets (replaying any unflushed tail),
flush ripe traces through the matcher on the device, publish reports and
histogram deltas to the configured datastore (``DATASTORE_URL``), and
checkpoint on SIGTERM / SIGINT and every ``--checkpoint-interval``
seconds. ``--tiles`` takes a ``.npz`` either package wrote; the broker
directory's format (records or columnar) is read from its ``meta.json``,
and a new directory takes the columnar format with ``--columnar``.
Several workers share one broker directory by owning disjoint
``--partitions`` with a checkpoint each. ``--stdin-format`` also reads
raw payloads from stdin, one per line, normalized into the broker before
consuming.

One difference in the loop: while a wave or a POST is in flight and the
lag has not moved, it pauses ``_BUSY_WAIT_S`` per step instead of
spinning (the JAX worker spins, which starves the match thread here).

Not ported, and raising NotImplementedError: ``--lease-dir`` (elastic
partition leases, ``distributed/lease.py``) and ``--snapshot-dir`` (the
metrics snapshot spool, ``distributed/aggregate.py``), both ROADMAP queue
1's ``distributed/`` item; an SLO plane enabled by ``RTPU_SLO`` (item
1e). The exit JSON's ``lease`` and ``slo`` are null and its ``link`` the
JAX worker's disabled form.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time

log = logging.getLogger("reporter_tpu_torch.streaming.worker")

_BUSY_WAIT_S = 0.002     # the loop's pause while a wave or POST is in flight


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.streaming",
        description="reporter_tpu_torch streaming matcher worker")
    ap.add_argument("--tiles", required=True, help="compiled tileset .npz")
    ap.add_argument("--broker-dir", required=True,
                    help="durable ingest log directory (shared by workers)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path (restored on start if present)")
    ap.add_argument("--checkpoint-interval", type=float, default=30.0)
    ap.add_argument("--partitions", type=int, nargs="*", default=None,
                    help="partition subset this worker owns (default: all)")
    ap.add_argument("--config", default=None, help="JSON config path")
    ap.add_argument("--poll-interval", type=float, default=0.05)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after N steps; default: run until signalled")
    ap.add_argument("--exit-on-drain", action="store_true",
                    help="exit once the owned partitions' lag reaches 0 "
                         "(a pre-staged broker)")
    ap.add_argument("--stdin-format", default=None,
                    help="also read raw payloads from stdin, normalized "
                         "via ProbeFormatter ('auto'|'json'|'csv')")
    ap.add_argument("--columnar", action="store_true",
                    help="use the columnar worker (streaming/columnar.py); "
                         "over a record broker its polls pay a per-record "
                         "packing shim")
    ap.add_argument("--device", default="cuda",
                    help="device of the matcher and the histograms: cuda "
                         "(default) or cpu")
    ap.add_argument("--snapshot-dir",
                    default=os.environ.get("RTPU_TOPO_SNAPSHOT_DIR") or None,
                    help="not ported (ROADMAP queue 1, distributed/)")
    ap.add_argument("--lease-dir",
                    default=os.environ.get("RTPU_LEASE_DIR") or None,
                    help="not ported (ROADMAP queue 1, distributed/)")
    ap.add_argument("--member",
                    default=os.environ.get("RTPU_TOPO_MEMBER") or None,
                    help="this worker's member name in the exit report "
                         "(default worker-<pid>)")
    return ap


def _refuse_unported(args) -> None:
    from reporter_tpu_torch.utils.tracing import env_flag

    if args.lease_dir:
        raise NotImplementedError(
            "--lease-dir (elastic partition leases, distributed/lease.py) "
            "is not ported: ROADMAP queue 1, item distributed/")
    if args.snapshot_dir:
        raise NotImplementedError(
            "--snapshot-dir (the metrics snapshot spool, "
            "distributed/aggregate.py) is not ported: ROADMAP queue 1, "
            "item distributed/")
    raw = os.environ.get("RTPU_SLO", "")
    if raw.strip() and env_flag(raw, strict=True):
        raise NotImplementedError(
            "RTPU_SLO enables the SLO plane (obs/slo.py), which is not "
            "ported: ROADMAP queue 1 item 1e")


def main(argv: "list[str] | None" = None) -> int:
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    member = args.member or f"worker-{os.getpid()}"
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from reporter_tpu_torch import faults
    from reporter_tpu_torch.config import Config
    from reporter_tpu_torch.streaming.durable_queue import (
        DurableIngestQueue, read_broker_format)
    from reporter_tpu_torch.streaming.pipeline import StreamPipeline
    from reporter_tpu_torch.tiles.tileset import TileSet

    t0 = time.perf_counter()
    config = Config.load(args.config)   # JSON file + env overrides
    ts = TileSet.load(args.tiles)
    # Broker directories are format-specific (meta.json pins it): reopen
    # with the class that wrote them; a new directory takes the columnar
    # format iff this worker is columnar.
    existing_fmt = read_broker_format(args.broker_dir)
    use_columnar_broker = (existing_fmt == "columnar"
                           or (existing_fmt is None and args.columnar))
    if use_columnar_broker:
        from reporter_tpu_torch.streaming.durable_columnar import (
            DurableColumnarIngestQueue)

        queue = DurableColumnarIngestQueue(args.broker_dir,
                                           config.streaming.num_partitions)
    else:
        queue = DurableIngestQueue(args.broker_dir,
                                   config.streaming.num_partitions)
    if args.columnar:
        from reporter_tpu_torch.streaming.columnar import (
            ColumnarStreamPipeline)

        pipe = ColumnarStreamPipeline(ts, config, queue=queue,
                                      partitions=args.partitions,
                                      device=args.device)
    else:
        pipe = StreamPipeline(ts, config, queue=queue,
                              partitions=args.partitions,
                              device=args.device)
    if args.checkpoint and os.path.exists(
            args.checkpoint if args.checkpoint.endswith(".npz")
            else args.checkpoint + ".npz"):
        pipe.restore(args.checkpoint)
        log.info("restored checkpoint %s (committed=%s)",
                 args.checkpoint, pipe.committed)
    matcher = getattr(pipe, "matcher", None) or pipe.app.matcher
    log.info("worker %s on %s (%d edges), device %s, %s pipeline over a %s "
             "broker, ready in %.2f s (tiles, broker, staging)", member,
             ts.name, ts.num_edges, matcher.device,
             "columnar" if args.columnar else "dict",
             "columnar" if use_columnar_broker else "record",
             time.perf_counter() - t0)

    if args.stdin_format:
        from reporter_tpu_torch.streaming.formatter import ProbeFormatter

        fmt = ProbeFormatter(args.stdin_format)
        if use_columnar_broker:
            # normalize stdin in batches so the log stores column frames,
            # not one frame per record
            n = fmt.format_stream_columns((line for line in sys.stdin),
                                          queue)
        else:
            n = fmt.format_stream((line for line in sys.stdin), queue)
        log.info("stdin feed: %d records normalized, %d dropped",
                 n, fmt.stats()["dropped"])

    stop = {"now": False}

    def _handle(signum, frame):
        stop["now"] = True

    signal.signal(signal.SIGINT, _handle)
    signal.signal(signal.SIGTERM, _handle)

    reports = steps = 0
    last_ckpt = t_loop = time.monotonic()
    stall, prev_lag = 0, None
    try:
        while not stop["now"]:
            reports += pipe.step()
            steps += 1
            if args.checkpoint and (time.monotonic() - last_ckpt
                                    >= args.checkpoint_interval):
                pipe.checkpoint(args.checkpoint)
                last_ckpt = time.monotonic()
            if args.max_steps is not None and steps >= args.max_steps:
                break
            st = pipe.stats()
            moved = st["lag"] != prev_lag
            busy = st.get("inflight_waves", 0) or st.get("publish_pending", 0)
            prev_lag = st["lag"]
            if args.exit_on_drain:
                # drained = lag 0, or a lag pinned by a sub-threshold
                # buffered tail with nothing in flight (the commit floor
                # sits below buffered rows by design; the drain below
                # flushes them)
                if st["lag"] == 0:
                    break
                if not moved and not busy:
                    stall += 1
                    if stall >= 3:
                        break
                else:
                    stall = 0
            elif st["lag"] == 0:
                time.sleep(args.poll_interval)
            if busy and not moved:
                # a wave or a POST is in flight and nothing moved: yield
                # to the match and publisher threads instead of spinning
                # (the match thread queues its launches from Python, and
                # a spinning loop takes the interpreter lock from it)
                time.sleep(_BUSY_WAIT_S)
    except faults.InjectedCrash:
        # a chaos plan simulating process death behaves like one: no
        # drain, no final checkpoint, no exit report (os._exit skips the
        # finally below on purpose)
        log.error("injected crash: dying hard")
        os._exit(17)
    finally:
        log.info("stepped %d times in %.2f s", steps,
                 time.monotonic() - t_loop)
        t_drain = time.perf_counter()
        reports += pipe.drain()
        pipe.flush_histograms()
        if getattr(pipe.publisher, "dead_letter_pending", 0):
            # an outage that covered the last wave leaves batches spooled
            # with no later success to replay them: try once at shutdown
            pipe.publisher.replay_dead_letters()
        if args.checkpoint:
            pipe.checkpoint(args.checkpoint)
        close = getattr(pipe, "close", None)
        if close is not None:       # pipelined worker: stop the executor
            close()                 # and the publisher thread
        queue.close()
        log.info("drained in %.2f s", time.perf_counter() - t_drain)
        from reporter_tpu_torch.utils import tracing

        tr = tracing.tracer()
        if tr.enabled and tr.dump_dir:
            try:
                tr.dump(path=os.path.join(tr.dump_dir,
                                          f"ring_{member}.json"),
                        reason="worker_exit")
            except OSError as exc:
                log.warning("exit trace dump failed: %s", exc)
    st = pipe.stats()
    # link health is not ported (ROADMAP queue 1 item 1f): the JAX
    # worker's disabled form
    link = {"rtt_ms": None, "mbps": None, "mood": None,
            "samples": 0, "probes": 0, "dead_probes": 0}
    qh = matcher.quality.health()
    quality = {k: qh.get(k) for k in
               ("enabled", "window_waves", "drifted", "drift_events",
                "empty_match_rate", "breakage_rate",
                "discontinuity_rate", "violation_rate",
                "rejection_rate", "unmatched_point_rate")}
    plan = faults.active()
    fault_stats = None
    if plan is not None:
        fs = plan.stats()
        fault_stats = {"calls": int(sum(fs["calls"].values())),
                       "fired": {s: int(n) for s, n in fs["fired"].items()
                                 if n}}
    print(json.dumps({"steps": steps, "reports": reports,
                      "committed": list(pipe.committed),
                      "member": member,
                      "faults": fault_stats, "lease": None,
                      "slo": None,
                      "link": link, "quality": quality,
                      **{k: v for k, v in st.items()
                         if k in ("lag", "published", "malformed",
                                  "hist_rows", "qhist_rows",
                                  "buffered_points", "publish_retried",
                                  "dead_lettered", "dead_letter_pending",
                                  "dispatch_timeouts",
                                  "traced_records")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
