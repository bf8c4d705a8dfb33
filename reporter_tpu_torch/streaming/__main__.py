"""The streaming worker's entry point.

    python -m reporter_tpu_torch.streaming --tiles metro.npz --broker-dir ./broker
        [--checkpoint worker.ckpt] [--partitions 0 1] [--config conf.json]
        [--poll-interval 0.05] [--max-steps N] [--exit-on-drain]
        [--stdin-format auto|json|csv] [--columnar] [--device cuda|cpu]
        [--snapshot-dir DIR] [--snapshot-interval S] [--member NAME]
        [--lease-dir DIR] [--lease-ttl S]

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

The topology flags (distributed/): ``--snapshot-dir`` spools an atomic
metrics snapshot every ``--snapshot-interval`` seconds for the
supervisor (env twins ``RTPU_TOPO_SNAPSHOT_DIR``,
``RTPU_TOPO_SNAPSHOT_INTERVAL_S``; ``--member`` / ``RTPU_TOPO_MEMBER``
names the file). ``--lease-dir`` replaces the static ``--partitions``
with epoch-fenced partition leases from the table there (env twins
``RTPU_LEASE_DIR``, ``RTPU_LEASE_TTL_S``): the worker starts owning
nothing, adopts what the table assigns at its committed floors, hands
off gracefully when revoked, and under ``--exit-on-drain`` drains
GLOBALLY (every partition's floor at its end offset). Lease mode is
dict-only, as in the JAX worker. The SLO plane (obs/slo.py) runs unless
``RTPU_SLO`` is false; its alert ledger lives in the snapshot directory.

One difference in the loop: while a wave or a POST is in flight and the
lag has not moved, it pauses ``_BUSY_WAIT_S`` per step instead of
spinning (the JAX worker spins, which starves the match thread here).
The exit JSON's ``link`` is the process link-health sampler's window
(utils/linkhealth.py); beside the JAX worker's keys it carries the sweep
kernel's launches since the worker was ready (``launches``, by
``arm@kK``), those of the tuner's calibration (``calibration_launches``),
the plan served (``plan``) and the wall-clock times at which the worker
was ready and done (``ready_unix_s``, ``exit_unix_s``).
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
    # the topology's flags: env twins let the supervisor configure the
    # workers it spawns without rebuilding their command lines; explicit
    # flags win
    ap.add_argument("--snapshot-dir",
                    default=os.environ.get("RTPU_TOPO_SNAPSHOT_DIR") or None,
                    help="spool per-worker metrics snapshots here "
                         "(atomic tmp+fsync+rename; env twin "
                         "RTPU_TOPO_SNAPSHOT_DIR)")
    ap.add_argument("--snapshot-interval", type=float,
                    default=float(os.environ.get(
                        "RTPU_TOPO_SNAPSHOT_INTERVAL_S") or 1.0),
                    help="seconds between snapshot spools (env twin "
                         "RTPU_TOPO_SNAPSHOT_INTERVAL_S; default 1)")
    ap.add_argument("--member",
                    default=os.environ.get("RTPU_TOPO_MEMBER") or None,
                    help="this worker's topology member name (snapshot "
                         "file and trace-dump naming; env twin "
                         "RTPU_TOPO_MEMBER; default worker-<pid>)")
    ap.add_argument("--lease-dir",
                    default=os.environ.get("RTPU_LEASE_DIR") or None,
                    help="partition lease-table directory "
                         "(distributed/lease.py): take partitions from "
                         "epoch-fenced leases instead of --partitions "
                         "(env twin RTPU_LEASE_DIR)")
    ap.add_argument("--lease-ttl", type=float,
                    default=float(os.environ.get("RTPU_LEASE_TTL_S")
                                  or 5.0),
                    help="lease time-to-live in seconds; renewals run at "
                         "~ttl/4 (env twin RTPU_LEASE_TTL_S; default 5)")
    return ap


def main(argv: "list[str] | None" = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    member = args.member or f"worker-{os.getpid()}"
    if args.lease_dir and args.partitions is not None:
        ap.error("--lease-dir and --partitions are mutually exclusive: "
                 "the lease table owns partition assignment")
    if args.lease_dir and args.columnar:
        ap.error("--lease-dir requires the dict worker for now: the "
                 "columnar pipeline's in-flight wave holds make "
                 "mid-wave partition handoff a separate contract "
                 "(DISTRIBUTED.md 'Partition leasing')")
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
        # lease mode starts owning NOTHING: the first sync() below adopts
        # whatever the table assigns, at its committed floors
        pipe = StreamPipeline(ts, config, queue=queue,
                              partitions=([] if args.lease_dir
                                          else args.partitions),
                              device=args.device)
    if args.checkpoint and os.path.exists(
            args.checkpoint if args.checkpoint.endswith(".npz")
            else args.checkpoint + ".npz"):
        pipe.restore(args.checkpoint)
        log.info("restored checkpoint %s (committed=%s)",
                 args.checkpoint, pipe.committed)
    # the worker's matcher registry is the one every layer feeds: the
    # snapshot spool exports it, so the supervisor's merge sees the
    # series /stats and /metrics would serve in-process
    matcher = getattr(pipe, "matcher", None) or pipe.app.matcher
    from reporter_tpu_torch.ops import dense_candidates as dc

    # the tuner calibrated (or read its cache) while the matcher was
    # built; the launches after this point are the stream's
    calibrated = dict(dc.SWEEP_LAUNCHES)
    ready_unix_s = time.time()
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

    runner = None
    if args.lease_dir:
        from reporter_tpu_torch.distributed.lease import (LeaseRunner,
                                                          LeaseTable)

        table = LeaseTable(args.lease_dir,
                           num_partitions=config.streaming.num_partitions,
                           ttl_s=args.lease_ttl, metrics=matcher.metrics)
        runner = LeaseRunner(table, member, pipe)
        runner.sync(force=True)
        log.info("lease member %s: partitions %s", member,
                 sorted(runner.epochs))

    # SLO plane: burn-rate evaluation over this worker's own registry,
    # ticked from the main loop (self-throttled). The alert ledger rides
    # the snapshot directory, so the supervisor finds every member's
    # alerts beside its metrics snapshots.
    from reporter_tpu_torch.obs import slo as obs_slo

    slo_eval = None
    if obs_slo.enabled():
        ledger = None
        if args.snapshot_dir:
            from reporter_tpu_torch.utils.eventlog import EventLog

            ledger = EventLog(os.path.join(args.snapshot_dir,
                                           f"alerts_{member}.jsonl"))
        slo_eval = obs_slo.SloEvaluator(matcher.metrics, ledger=ledger)

    stop = {"now": False}

    def _handle(signum, frame):
        stop["now"] = True

    signal.signal(signal.SIGINT, _handle)
    signal.signal(signal.SIGTERM, _handle)

    def _spool_snapshot(seq: int, st: dict) -> None:
        from reporter_tpu_torch.distributed import aggregate

        # an in-worker fault plan's stats ride the snapshot as gauges, so
        # the supervisor's merged registry shows them per member even
        # when the incarnation dies before printing an exit report
        plan = faults.active()
        if plan is not None:
            fs = plan.stats()
            matcher.metrics.gauge("fault_calls",
                                  float(sum(fs["calls"].values())))
            matcher.metrics.gauge("fault_fired",
                                  float(sum(fs["fired"].values())))
        try:
            aggregate.write_snapshot(
                aggregate.snapshot_path(args.snapshot_dir, member),
                matcher.metrics, member, seq=seq,
                stats={k: st.get(k) for k in
                       ("lag", "published", "malformed", "reports",
                        "dispatch_timeouts", "dead_letter_pending")})
        except OSError as exc:
            # a full or unwritable spool disk degrades observability; it
            # never takes the matcher down with it
            log.warning("snapshot spool failed: %s", exc)

    reports = steps = snap_seq = 0
    last_ckpt = last_snap = t_loop = time.monotonic()
    stall, prev_lag = 0, None
    try:
        while not stop["now"]:
            if runner is not None:
                runner.sync()
            reports += pipe.step()
            if runner is not None:
                runner.push_commits()
            steps += 1
            if slo_eval is not None:
                slo_eval.tick()    # self-throttled; cheap on the hot loop
            if args.checkpoint and (time.monotonic() - last_ckpt
                                    >= args.checkpoint_interval):
                pipe.checkpoint(args.checkpoint)
                last_ckpt = time.monotonic()
            if args.max_steps is not None and steps >= args.max_steps:
                break
            st = pipe.stats()
            if args.snapshot_dir and (time.monotonic() - last_snap
                                      >= args.snapshot_interval):
                snap_seq += 1
                _spool_snapshot(snap_seq, st)
                last_snap = time.monotonic()
            moved = st["lag"] != prev_lag
            busy = st.get("inflight_waves", 0) or st.get("publish_pending", 0)
            prev_lag = st["lag"]
            if args.exit_on_drain and runner is not None:
                # lease mode drains GLOBALLY: end offsets against the
                # TABLE's floors over every partition. A worker owning
                # nothing idles rather than exits (a dead peer's
                # partitions can still rebalance onto it); a lag pinned
                # by a sub-threshold buffered tail is force-flushed so
                # the floor can reach the end offsets, and serving goes
                # on
                if st["lag"] == 0:
                    stall = 0
                    if runner.lag() == 0:
                        break
                    time.sleep(args.poll_interval)
                elif not moved and not busy:
                    stall += 1
                    if stall >= 3:
                        reports += pipe.step(force_flush=True)
                        runner.push_commits()
                        stall = 0
                else:
                    stall = 0
            elif args.exit_on_drain:
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
        # finally below on purpose); the next owner replays this
        # worker's unflushed tail from the committed floor
        log.error("injected crash: dying hard")
        os._exit(17)
    finally:
        log.info("stepped %d times in %.2f s", steps,
                 time.monotonic() - t_loop)
        t_drain = time.perf_counter()
        reports += pipe.drain()
        pipe.flush_histograms()
        if runner is not None:
            # graceful exit: fenced final floors and release, so the
            # partitions are adoptable at once (no TTL wait)
            runner.push_commits()
            runner.shutdown()
        if getattr(pipe.publisher, "dead_letter_pending", 0):
            # an outage that covered the last wave leaves batches spooled
            # with no later success to replay them: try once at shutdown
            pipe.publisher.replay_dead_letters()
        if args.checkpoint:
            pipe.checkpoint(args.checkpoint)
        if args.snapshot_dir:
            # the last spool comes AFTER the drain: the supervisor's last
            # view of this worker covers everything it published
            _spool_snapshot(snap_seq + 1, pipe.stats())
        close = getattr(pipe, "close", None)
        if close is not None:       # pipelined worker: stop the executor
            close()                 # and the publisher thread
        queue.close()
        log.info("drained in %.2f s", time.perf_counter() - t_drain)
        from reporter_tpu_torch.utils import tracing

        tr = tracing.tracer()
        if tr.enabled and tr.dump_dir:
            # per-process ring dump for distributed/stitch.py, named by
            # member so the stitcher can label the track
            try:
                tr.dump(path=os.path.join(tr.dump_dir,
                                          f"ring_{member}.json"),
                        reason="worker_exit")
            except OSError as exc:
                log.warning("exit trace dump failed: %s", exc)
    st = pipe.stats()
    # link-health counters: the process sampler ran in-process all along
    # (started by the dict pipeline's app); the exit report is where a
    # supervisor reads them after the worker is gone
    from reporter_tpu_torch.utils import linkhealth

    if linkhealth.enabled():
        s = linkhealth.sampler()
        link = {**s.window(), "probes": int(s.probes_total),
                "dead_probes": int(s.dead_probes_total)}
    else:
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
    lease_stats = None if runner is None else dict(runner.stats)
    # the SLO roll-up: a last forced tick, so a short-lived worker's burn
    # state covers its whole run
    slo_block = None
    if slo_eval is not None:
        slo_eval.tick(force=True)
        slo_block = slo_eval.exit_block()
    # a wide instance's key (a K past SWEEP_KS) appears at its first launch
    launches = {f"{a}@k{k}": n - calibrated.get((a, k), 0)
                for (a, k), n in dc.SWEEP_LAUNCHES.items()
                if n > calibrated.get((a, k), 0)}
    print(json.dumps({"steps": steps, "reports": reports,
                      "committed": list(pipe.committed),
                      "member": member,
                      "faults": fault_stats, "lease": lease_stats,
                      "slo": slo_block,
                      "link": link, "quality": quality,
                      **{k: v for k, v in st.items()
                         if k in ("lag", "published", "malformed",
                                  "hist_rows", "qhist_rows",
                                  "buffered_points", "publish_retried",
                                  "dead_lettered", "dead_letter_pending",
                                  "dispatch_timeouts",
                                  "traced_records")},
                      "launches": launches,
                      "calibration_launches": {
                          f"{a}@k{k}": n
                          for (a, k), n in calibrated.items() if n},
                      "plan": (matcher.tuned_plan.label
                               if matcher.tuned_plan is not None else None),
                      "ready_unix_s": ready_unix_s,
                      "exit_unix_s": time.time()}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
