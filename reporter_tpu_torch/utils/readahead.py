"""Single-thread read-ahead executor for the scheduler's prepare-ahead.

Counterpart: reporter_tpu/utils/readahead.py (``ReadAheadWorker``,
``Ticket``). The batch scheduler hands a closed batch's pure host
prepare (cache merge, Trace build, padding, ``prepare_many``) to this
worker while earlier batches occupy the card. One daemon thread per
worker: prepare is CPU-bound Python, so the win is overlapping host work
with the device wait, not host-host parallelism.

The one lock guards only the task deque; submitted callables run outside
it. A ticket resolves through its own ``threading.Event``.
``close()`` fails every never-started ticket with ``ReadAheadClosed`` so
a consumer waiting on a ticket after shutdown gets a loud error, never a
hang; tasks already running complete normally.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable

from reporter_tpu_torch.utils import locks


class ReadAheadClosed(RuntimeError):
    """Ticket failed because the worker was closed before it ran."""


class Ticket:
    """Handle for one submitted prepare task. ``result()`` blocks until
    the task ran (or the worker closed) and re-raises the task's error
    in the caller's thread — the prepare exception surfaces on the wave
    that would have consumed the prepare, which is exactly where the
    serial loop would have raised it."""

    __slots__ = ("_done", "_result", "_error")

    def __init__(self) -> None:
        self._done = threading.Event()
        self._result: Any = None
        self._error: "BaseException | None" = None

    def _resolve(self, result: Any = None,
                 error: "BaseException | None" = None) -> None:
        self._result = result
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: "float | None" = None) -> Any:
        if not self._done.wait(timeout=timeout):
            raise TimeoutError("read-ahead ticket not resolved in time")
        if self._error is not None:
            raise self._error
        return self._result


class ReadAheadWorker:
    """One daemon thread draining a FIFO of prepare callables."""

    def __init__(self, name: str = "readahead") -> None:
        self._cv = locks.named_condition("readahead.tasks")
        self._tasks: "deque[tuple[Ticket, Callable[[], Any]]]" = deque()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def submit(self, fn: Callable[[], Any]) -> Ticket:
        t = Ticket()
        with self._cv:
            if self._closed:
                raise ReadAheadClosed("read-ahead worker is closed")
            self._tasks.append((t, fn))
            self._cv.notify()
        return t

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._tasks:
                    if self._closed:
                        return
                    self._cv.wait()
                ticket, fn = self._tasks.popleft()
            # run OUTSIDE the condition: the lock guards the deque only
            try:
                ticket._resolve(result=fn())
            except BaseException as exc:  # resolve, never kill the thread
                ticket._resolve(error=exc)

    def close(self, timeout: "float | None" = 5.0) -> None:
        """Stop accepting work, fail queued-but-unstarted tickets, join
        the thread (bounded — a task wedged on a dead link must not
        wedge shutdown; the thread is a daemon). Idempotent."""
        with self._cv:
            if self._closed:
                pending: "list[Ticket]" = []
            else:
                self._closed = True
                pending = [t for t, _ in self._tasks]
                self._tasks.clear()
            self._cv.notify_all()
        for t in pending:
            t._resolve(error=ReadAheadClosed(
                "read-ahead worker closed before task ran"))
        self._thread.join(timeout=timeout)
