"""StreamWorker: a background thread driving a StreamPipeline.

Counterpart: reporter_tpu/streaming/worker.py. Each worker owns a
pipeline (and through it a disjoint partition subset); a host can run
several as threads. A worker that dies leaves its partitions' committed
offsets behind; a replacement pipeline over those partitions, restored
from the checkpoint, replays the unflushed tail (the consumer-group
rebalance analog, tested in tests/test_torch_streaming.py).
"""

from __future__ import annotations

import threading
import time

from reporter_tpu_torch.streaming.pipeline import StreamPipeline


class StreamWorker:
    """Drives pipeline.step() until stopped; drains on stop by default."""

    def __init__(self, pipeline: StreamPipeline, poll_interval: float = 0.02,
                 name: str | None = None):
        self.pipeline = pipeline
        self.poll_interval = float(poll_interval)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=name or f"stream-worker-{id(self) & 0xFFFF:04x}")
        self.reports = 0
        self.errors = 0

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "StreamWorker":
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            # Still inside step() (e.g. a cold-compile batch): draining here
            # would race the worker thread through the non-thread-safe
            # pipeline. The loop will exit after the in-flight step.
            return
        if drain:
            self.reports += self.pipeline.drain()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    # ---- loop ------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                n = self.pipeline.step()
                self.reports += n
            except Exception:
                # Keep the worker alive (supervisor semantics): unflushed
                # buffers hold the commit floor, so the next step retries.
                self.errors += 1
                n = 0
            if n == 0:
                time.sleep(self.poll_interval)
