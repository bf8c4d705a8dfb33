"""Bounded execution of work that can hang.

Counterpart: reporter_tpu/utils/watchdog.py. The body runs on a fresh
daemon thread and the caller waits at most ``timeout`` seconds. On
timeout the stuck thread is abandoned (a daemon: it never blocks exit)
and counted, so a caller can open a circuit breaker at ``cap`` and
degrade at once instead of pinning one more thread and payload per retry.
A body that lands after it was abandoned un-counts itself and its result
is discarded; a body whose injected stall ends after the caller gave up
never runs at all, so a late completion cannot race the caller's retry.

Shared by the matcher's device dispatch (``dispatch_timeout_s``) and the
quality audit's oracle worker (quality/audit.py). An exception of the
body (a CUDA build or launch error among them) is re-raised in the
caller, never turned into a timeout.
"""

from __future__ import annotations

import threading
from typing import Callable

from reporter_tpu_torch import faults
from reporter_tpu_torch.utils import locks

TIMED_OUT = object()    # the body was abandoned (a body may return None)


class AbandonedThreadWatchdog:
    """The abandoned-thread ledger and the guarded call.

    ``lock`` guards only the counter and each call's abandoned / finished
    handshake: callers must never hold their own data locks around
    ``run()``, whose body may stall for minutes."""

    def __init__(self, cap: int = 4, thread_name: str = "watchdog"):
        self.lock = locks.named_lock("watchdog.ledger")
        self.abandoned = 0
        self.cap = cap
        self.thread_name = thread_name

    @property
    def tripped(self) -> bool:
        """True while the breaker is open: ``cap`` abandoned bodies are
        still stuck, so degrade without spawning another."""
        with self.lock:
            return self.abandoned >= self.cap

    def run(self, fn: Callable, timeout: float, fault_site: str = ""):
        """``fn()`` on a daemon thread, waited for at most ``timeout``
        seconds: its result (its exception re-raised) when it lands in
        time, else ``TIMED_OUT``. ``fault_site`` fires inside the guarded
        body, so an injected hang stalls where a real one would."""
        box: dict = {}
        done = threading.Event()
        state = {"abandoned": False, "finished": False}

        def _run():
            try:
                if fault_site:
                    faults.fire(fault_site)
                with self.lock:
                    gave_up = state["abandoned"]
                if gave_up:
                    return      # abandoned while stalled: never run fn
                box["out"] = fn()
            except BaseException as exc:    # noqa: BLE001 - relayed below
                box["exc"] = exc
            finally:
                with self.lock:
                    state["finished"] = True
                    if state["abandoned"]:      # the stall cleared
                        self.abandoned -= 1
                done.set()

        threading.Thread(target=_run, daemon=True,
                         name=self.thread_name).start()
        finished = done.wait(timeout)
        if not finished:
            with self.lock:
                if not state["finished"]:       # really stuck: abandon it
                    state["abandoned"] = True
                    self.abandoned += 1
                else:
                    finished = True     # landed in the timeout race window
        if not finished:
            return TIMED_OUT
        if "exc" in box:
            raise box["exc"]
        return box["out"]
