"""Shared fixtures and the gate of the port's tests (tests/test_torch_*.py).

Importing this module arms the port's lockdep (reporter_tpu_torch/utils/
locks.py) BEFORE any reporter_tpu_torch module with locks is imported:
arming is creation-time, and five port modules create a named lock at
import. So every tests/test_torch_*.py imports from here first, above
its reporter_tpu_torch imports (tests/test_torch_imports.py checks the
order).

The gate, imported into each test module by name:

- ``_torch_gate`` (autouse, per test): no new lockdep violation of the
  port during the test, no lock-order edge outside the port's contract
  (reporter_tpu_torch/analysis/concurrency_contract.py: extend with a
  dated justification, or unnest), and no leak of the port's process
  globals (reporter_tpu_torch/analysis/global_state.py);
- ``_torch_module_gate`` (autouse, per module): a backstop over the
  whole ledger, for violations outside any test's window (module
  fixtures, imports at collection).

It runs without the JAX package (the card runs some of these files with
``--noconftest``).
"""

import pytest
import torch

from reporter_tpu_torch.analysis import concurrency_contract as _contract
from reporter_tpu_torch.utils import locks as _locks

LOCKDEP = _locks.arm(blocking_allow=set(_contract.BLOCKING_ALLOW))

# the leak detector's lazy imports create locks: after arming
from reporter_tpu_torch.analysis import global_state as _gs  # noqa: E402


def _unknown_edges(edges):
    return [e for e in edges if e not in _contract.LOCK_ORDER_EDGES]


_checked = [0, 0]     # the ledger's violations and edges reported so far


@pytest.fixture(scope="module", autouse=True)
def _torch_module_gate():
    """Each violation and unknown edge is reported once, by the first
    module to end after it landed (a collection-time one by the first
    module of the process)."""
    yield
    snap = LOCKDEP.snapshot()
    v0, e0 = _checked
    _checked[:] = [len(snap["violations"]), len(snap["edges"])]
    fresh = snap["violations"][v0:]
    assert not fresh, (
        "port lockdep violations recorded since the previous module ended "
        "(module fixtures and imports included):\n"
        + "\n".join(map(str, fresh)))
    unknown = _unknown_edges(list(snap["edges"])[e0:])
    assert not unknown, (
        f"port lock-order edges outside the contract: {unknown}")


@pytest.fixture(autouse=True)
def _torch_gate():
    pre = _gs.snapshot()
    v0, e0 = LOCKDEP.counts()
    yield
    problems = _gs.diff(pre, _gs.snapshot())
    problems.extend(f"port lockdep violation: {v}"
                    for v in LOCKDEP.violations[v0:])
    # only the edges first observed during this test (insertion order)
    unknown = _unknown_edges(list(LOCKDEP.snapshot()["edges"])[e0:])
    if unknown:
        problems.append(
            f"port lock-order edges outside the contract: {unknown}: add "
            "them to reporter_tpu_torch/analysis/concurrency_contract."
            "LOCK_ORDER_EDGES with a dated justification, or unnest")
    assert not problems, "\n".join(problems)


@pytest.fixture(scope="module")
def few_torch_threads():
    """Cap PyTorch's intra-op threads for a module: the port's CPU tests
    are small, and the suite runs several workers side by side, whose
    timing-sensitive tests suffer from idle-spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_link_sampler():
    """A process link-health sampler of this test's own: the sampler is
    process-global, and a dispatch timeout noted on it leaves its mood
    dead for every later test of the worker process (the gate's mood
    check)."""
    from reporter_tpu_torch.utils import linkhealth

    with linkhealth._global_lock:
        prev = linkhealth._global
    linkhealth.configure(None)
    try:
        yield
    finally:
        with linkhealth._global_lock:
            mine = linkhealth._global
        if mine is not None:
            mine.stop()
        linkhealth.configure(prev)
