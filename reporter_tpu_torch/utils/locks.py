"""Named locks: THE spelling for every lock in reporter_tpu_torch.

Counterpart: reporter_tpu/utils/locks.py (``named_lock``,
``named_rlock``, ``named_condition``). Each takes a stable class name
(``"scheduler.stats"``) so a lock's role reads at its construction site,
and returns the plain ``threading`` primitive. The JAX package's lockdep
checker (order edges, blocking calls under a lock) is not ported yet
(ROADMAP queue 1 item 8); the names are the ones it will key on.
"""

from __future__ import annotations

import threading
from typing import Any


def named_lock(name: str) -> "Any":
    """A mutex of lock class ``name`` (a plain ``threading.Lock``)."""
    del name
    return threading.Lock()


def named_rlock(name: str) -> "Any":
    del name
    return threading.RLock()


def named_condition(name: str, lock: "Any | None" = None) -> "Any":
    """A condition bound to ``lock`` (a named_lock result) or to a fresh
    lock of class ``name``."""
    del name
    return threading.Condition(lock)
