"""Streaming demo of the PyTorch / CUDA port: durable broker → pipeline →
histograms → recovery.

    python examples/torch_streaming_demo.py [--device cuda|cpu]

The counterpart of examples/streaming_demo.py on reporter_tpu_torch.
Probes land in a file-backed partitioned log (DurableIngestQueue, the
broker); a StreamPipeline worker buffers them per vehicle, flushes ripe
traces through the batched matcher on the device, accumulates per-segment
speed and queue-length histograms in device memory, and checkpoints. The
second half simulates a worker crash: a fresh pipeline over the same log
directory restores the checkpoint and replays the unflushed tail, at
least once, nothing lost. Runs on the card unless ``--device cpu`` is
given.
"""

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from reporter_tpu_torch import (  # noqa: E402
    CompilerParams,
    Config,
    compile_network,
    generate_city,
)
from reporter_tpu_torch.netgen.traces import synthesize_fleet  # noqa: E402
from reporter_tpu_torch.streaming import (  # noqa: E402
    DurableIngestQueue,
    StreamPipeline,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the matcher and the histograms "
                         "(default cuda)")
    args = ap.parse_args(argv)

    ts = compile_network(generate_city("tiny"),
                         CompilerParams(osmlr_max_length=250.0))
    workdir = tempfile.mkdtemp(prefix="reporter_torch_stream_")
    try:
        run(ts, workdir, args.device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run(ts, workdir: str, device: str) -> None:
    log_dir = os.path.join(workdir, "broker")
    ckpt = os.path.join(workdir, "worker.ckpt")

    captured = []

    def transport(url, body):           # datastore stand-in
        captured.append(json.loads(body))
        return 200

    cfg = Config()
    cfg = dataclasses.replace(
        cfg,
        service=dataclasses.replace(cfg.service,
                                    datastore_url="http://datastore"),
        # a big flush threshold keeps the late drives below BUFFERED when
        # the worker dies (the first batch flushes via force_flush)
        streaming=dataclasses.replace(cfg.streaming, flush_min_points=100))

    # ---- producer side: probes → partitioned durable log ----------------
    queue = DurableIngestQueue(log_dir, cfg.streaming.num_partitions)
    fleet = synthesize_fleet(ts, 8, num_points=60, seed=4)

    def points_of(p, lo, hi):
        return [{"uuid": p.uuid, "lat": float(la), "lon": float(lo_),
                 "time": float(t)}
                for (lo_, la), t in zip(p.lonlat[lo:hi], p.times[lo:hi])]

    for p in fleet[:5]:                       # five full drives up front
        for r in points_of(p, 0, 60):
            queue.append(r)
    print(f"produced 300 records into {queue.num_partitions} partitions "
          f"(lag {queue.lag([0] * queue.num_partitions)})")

    # ---- matcher worker: consume → match → publish → checkpoint ---------
    pipe = StreamPipeline(ts, cfg, queue=queue, transport=transport,
                          device=device)
    n = pipe.step(force_flush=True)
    flushed = pipe.flush_histograms()
    pipe.checkpoint(ckpt)
    print(f"worker on {device} flushed {n} reports; {flushed} "
          "segments of speed+queue histogram deltas published; "
          "checkpointed")

    # Late records arrive, under flush_min_points per vehicle, so step()
    # consumes them into buffers WITHOUT flushing. Then the worker dies
    # with those drives only in (a) its buffers and (b) the log.
    for p in fleet[5:]:
        for r in points_of(p, 0, 60):
            queue.append(r)
    pipe.step()
    assert pipe.stats()["buffered_points"] > 0   # genuinely unflushed
    queue.close()
    del pipe                              # the crash

    # ---- recovery: same log dir + checkpoint → replay the tail ----------
    queue2 = DurableIngestQueue(log_dir, cfg.streaming.num_partitions)
    pipe2 = StreamPipeline(ts, cfg, queue=queue2, transport=transport,
                           device=device)
    pipe2.restore(ckpt)
    n2 = pipe2.drain()
    stats = pipe2.stats()
    print(f"restarted worker replayed the unflushed tail: {n2} reports, "
          f"lag {stats['lag']}, hist rows {stats['hist_rows']}")
    hist_payloads = [p for p in captured if "queue_histograms" in p]
    print(f"datastore saw {len(captured)} POSTs "
          f"({len(hist_payloads)} histogram flushes)")
    queue2.close()


if __name__ == "__main__":
    main()
