"""Device profiling hook: a ``torch.profiler`` trace of a window.

Counterpart: reporter_tpu/utils/profiling.py (``jax.profiler`` there)::

    from reporter_tpu_torch.utils.profiling import device_trace
    with device_trace("traces/"):          # a no-op when the dir is falsy
        matcher.match_many(traces)

The capture records the host's operators and, on a card, the CUDA
runtime calls and kernels (``ProfilerActivity.CPU`` and ``CUDA``), and is
written into the directory as a Chrome trace
(``rtt_trace_<pid>_<n>.json``, loadable in ui.perfetto.dev or
chrome://tracing). ``REPORTER_TPU_TRACE_DIR`` turns on every
``device_trace(None)`` call site without a code change: the matcher wraps
each ``match_many`` batch in one. With it unset the context does nothing
but read the variable.

The profiler is a process-global singleton (a second profile cannot start
while one runs), and the serving scheduler overlaps ``match_many`` calls
from several threads. So only the first entrant starts a capture; a
nested or concurrent entry runs untraced (its work still lands in the
active capture). The ``profiling.trace`` lock guards that decision.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Iterator

from reporter_tpu_torch.utils import locks

_ENV_DIR = "REPORTER_TPU_TRACE_DIR"

_trace_lock = locks.named_lock("profiling.trace")
_trace_active = False
_seq = itertools.count()


@contextlib.contextmanager
def device_trace(trace_dir: "str | None" = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``trace_dir`` (falsy: ``$REPORTER_TPU_TRACE_DIR``; unset too: a
    no-op). Nested or concurrent entries while a capture runs are
    no-ops."""
    global _trace_active
    target = trace_dir or os.environ.get(_ENV_DIR, "")
    if not target:
        yield
        return
    with _trace_lock:
        owner = not _trace_active
        _trace_active = True
    if not owner:
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(target, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            target, f"rtt_trace_{os.getpid()}_{next(_seq)}.json"))
    finally:
        with _trace_lock:
            _trace_active = False


def annotate(name: str):
    """A named span inside a device_trace (``record_function``); outside
    a capture a no-op context, so a hot path may carry one for free."""
    if not _trace_active:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)
