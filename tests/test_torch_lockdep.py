"""The port's lockdep runtime (reporter_tpu_torch/utils/locks.py): each
detector fires on a seeded violation and stays quiet on its clean twin,
as tests/test_static_analysis.py holds the JAX package's. Seeded cases
run on private ``Lockdep`` instances (``use(dep)`` for the patched
calls), so nothing reaches the process ledger the gate checks.

Also: the test process is armed (tests/_torch_support.py), the port's
locks created at import are instrumented, the blocking-call patches are
the port's own, and with both packages armed a sleep under a port lock
is seen by the port (the two runtimes' wrappers chain)."""

from __future__ import annotations

import importlib
import threading
import time

import pytest
import torch

from _torch_support import (  # noqa: F401  (the port's gate: first)
    LOCKDEP, _torch_gate, _torch_module_gate)
from reporter_tpu_torch.analysis import concurrency_contract as contract
from reporter_tpu_torch.utils import locks


def _kinds(dep):
    return [v["kind"] for v in dep.violations]


# ---------------------------------------------------------------------------
# lock order

def test_ab_ba_inversion_is_caught():
    dep = locks.Lockdep()
    a = locks.NamedLock("syn.A", dep=dep)
    b = locks.NamedLock("syn.B", dep=dep)
    with a:
        with b:
            pass
    with b:
        with a:                      # the inversion
            pass
    v = next(v for v in dep.violations if v["kind"] == "lock-order")
    assert v["edge"] == ("syn.B", "syn.A")


def test_consistent_order_is_clean():
    dep = locks.Lockdep()
    a = locks.NamedLock("ok.A", dep=dep)
    b = locks.NamedLock("ok.B", dep=dep)
    for _ in range(3):
        with a:
            with b:
                pass
    assert dep.violations == []
    assert ("ok.A", "ok.B") in dep.edges


def test_transitive_cycle_is_caught():
    dep = locks.Lockdep()
    a, b, c = (locks.NamedLock(f"syn3.{x}", dep=dep) for x in "ABC")
    for outer, inner in ((a, b), (b, c)):
        with outer:
            with inner:
                pass
    assert dep.violations == []
    with c:
        with a:                      # A→B→C→A
            pass
    assert "lock-order" in _kinds(dep)


def test_an_inverting_edge_is_not_inserted():
    dep = locks.Lockdep()
    a, b, x = (locks.NamedLock(f"np.{n}", dep=dep) for n in "ABX")
    for outer, inner in ((a, b), (x, b), (b, a)):
        with outer:
            with inner:
                pass
    assert len(dep.violations) == 1
    assert ("np.B", "np.A") not in dep.edges
    with a:                          # innocent: a fresh edge
        with x:
            pass
    assert len(dep.violations) == 1


def test_same_class_nesting_is_caught():
    dep = locks.Lockdep()
    l1 = locks.NamedLock("cls.same", dep=dep)
    l2 = locks.NamedLock("cls.same", dep=dep)
    with l1:
        with l2:                     # two instances, one class
            pass
    assert any(v["kind"] == "lock-order" and v["edge"][0] == v["edge"][1]
               for v in dep.violations)


def test_two_classes_nested_once_are_clean():
    dep = locks.Lockdep()
    with locks.NamedLock("cls.one", dep=dep):
        with locks.NamedLock("cls.two", dep=dep):
            pass
    assert dep.violations == []


def test_rlock_reentry_is_not_flagged():
    dep = locks.Lockdep()
    rl = locks.NamedLock("re.R", dep=dep, reentrant=True)
    with rl:
        with rl:
            pass
        assert rl.locked()
    assert not rl.locked()
    assert dep.violations == []


def test_plain_lock_reentry_shape_is_flagged():
    """The twin of the RLock case: a non-reentrant class acquired under
    itself is the self-deadlock shape (the attempt is recorded before
    it would block; a try-acquire keeps the test from hanging)."""
    dep = locks.Lockdep()
    lk = locks.NamedLock("re.plain", dep=dep)
    other = locks.NamedLock("re.plain", dep=dep)
    with lk:
        assert other.acquire(blocking=False)
        other.release()
    assert any(v["edge"] == ("re.plain", "re.plain")
               for v in dep.violations)


# ---------------------------------------------------------------------------
# blocking calls under a lock

def test_sleep_under_a_lock_is_caught():
    dep = locks.Lockdep()
    lk = locks.NamedLock("syn.sleepy", dep=dep)
    with locks.use(dep):
        with lk:
            time.sleep(0)
    assert any(v["kind"] == "blocking-under-lock"
               and v["call"] == "time.sleep" for v in dep.violations)


def test_sleep_outside_a_lock_is_clean():
    dep = locks.Lockdep()
    lk = locks.NamedLock("syn.fine", dep=dep)
    with locks.use(dep):
        with lk:
            pass
        time.sleep(0)
    assert dep.violations == []


@pytest.mark.parametrize("call,label", [
    (lambda t: t.cpu(), "torch.Tensor.cpu"),
    (lambda t: t.item(), "torch.Tensor.item")])
def test_device_wait_under_a_lock_is_caught(call, label):
    dep = locks.Lockdep()
    lk = locks.NamedLock("syn.device", dep=dep)
    t = torch.ones(1)
    with locks.use(dep):
        with lk:
            call(t)
    assert [v["call"] for v in dep.violations] == [label]


@pytest.mark.parametrize("call", [lambda t: t.cpu(), lambda t: t.item()])
def test_device_wait_outside_a_lock_is_clean(call):
    dep = locks.Lockdep()
    lk = locks.NamedLock("syn.device_ok", dep=dep)
    t = torch.ones(1)
    with locks.use(dep):
        with lk:
            u = t + 1                # queued work under the lock: fine
        assert call(u) is not None
    assert dep.violations == []


def test_the_allowlist_waives_a_pair():
    dep = locks.Lockdep(blocking_allow={("syn.waived", "time.sleep")})
    lk = locks.NamedLock("syn.waived", dep=dep)
    with locks.use(dep):
        with lk:
            time.sleep(0)
    assert dep.violations == []


def test_the_allowlist_is_per_call():
    dep = locks.Lockdep(blocking_allow={("syn.waived2", "time.sleep")})
    lk = locks.NamedLock("syn.waived2", dep=dep)
    with locks.use(dep):
        with lk:
            torch.ones(1).item()     # another call: not waived
    assert [v["call"] for v in dep.violations] == ["torch.Tensor.item"]


# ---------------------------------------------------------------------------
# condition variables

def test_foreign_condvar_wait_is_caught():
    dep = locks.Lockdep()
    outer = locks.NamedLock("syn.outer", dep=dep)
    cv = locks.NamedCondition("syn.cv", dep=dep)
    with outer:
        with cv:
            cv.wait(timeout=0.001)   # releases cv only; outer stays held
    assert any(v["call"] == "wait:syn.cv" and "syn.outer" in v["held"]
               for v in dep.violations)


def test_own_condvar_wait_is_clean():
    dep = locks.Lockdep()
    cv = locks.NamedCondition("syn.solo_cv", dep=dep)
    with cv:
        cv.wait(timeout=0.001)
    assert dep.violations == []
    with cv:
        assert dep.held() == ("syn.solo_cv",)
    assert dep.held() == ()


def test_wait_for_predicate_runs_with_its_lock_visible():
    dep = locks.Lockdep()
    cv = locks.NamedCondition("wf.cv", dep=dep)
    inner = locks.NamedLock("wf.inner", dep=dep)

    def pred():
        assert "wf.cv" in dep.held()
        with inner:
            pass
        return True

    with cv:
        assert cv.wait_for(pred, timeout=1.0)
    assert ("wf.cv", "wf.inner") in dep.edges
    assert dep.violations == [] and dep.held() == ()


def test_condvar_still_wakes_a_waiter():
    dep = locks.Lockdep()
    cv = locks.NamedCondition("syn.wake", dep=dep)
    got = []

    def waiter():
        with cv:
            got.append(cv.wait(timeout=5.0))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        cv.notify_all()
    t.join(timeout=5.0)
    assert got == [True] and dep.violations == []


def test_try_acquire_semantics():
    dep = locks.Lockdep()
    lk = locks.NamedLock("syn.try", dep=dep)
    assert lk.acquire(blocking=False)
    assert not lk.acquire(blocking=False)
    lk.release()
    assert dep.held() == ()


# ---------------------------------------------------------------------------
# arming in the test process

def test_the_test_process_is_armed():
    assert locks.armed() and LOCKDEP is locks.global_dep()
    for label, (mod, owner, attr) in locks.BLOCKING_CALLS.items():
        obj = importlib.import_module(mod)
        for part in filter(None, owner.split(".")):
            obj = getattr(obj, part)
        assert getattr(getattr(obj, attr), locks.MARK, None) == label


_IMPORT_TIME_LOCKS = [
    ("reporter_tpu_torch.faults", "_lock"),
    ("reporter_tpu_torch.utils.tracing", "_env_lock"),
    ("reporter_tpu_torch.utils.linkhealth", "_buffers_lock"),
    ("reporter_tpu_torch.utils.linkhealth", "_global_lock"),
    ("reporter_tpu_torch.quality.audit", "_global_lock"),
    ("reporter_tpu_torch.utils.profiling", "_trace_lock"),
]


@pytest.mark.parametrize("module,attr", _IMPORT_TIME_LOCKS)
def test_locks_created_at_import_are_instrumented(module, attr):
    """Arming is creation-time: these locks exist from their module's
    import on, so every port test file imports _torch_support first."""
    lk = getattr(importlib.import_module(module), attr)
    assert isinstance(lk, locks.NamedLock), (module, attr, lk)


def test_a_plain_process_gets_plain_locks():
    """Unarmed (no arm(), no RTPU_LOCKDEP), named_lock is the stdlib
    primitive: production pays nothing."""
    import os
    import subprocess
    import sys

    code = ("from reporter_tpu_torch.utils import locks, tracing\n"
            "import threading\n"
            "assert not locks.armed()\n"
            "assert type(locks.named_lock('x')) is type(threading.Lock())\n"
            "assert type(tracing._env_lock) is type(threading.Lock())\n")
    env = {k: v for k, v in os.environ.items() if k != "RTPU_LOCKDEP"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_env_arming_equals_programmatic_arming():
    import os
    import subprocess
    import sys

    code = ("import time\n"
            "from reporter_tpu_torch.utils import locks\n"
            "lk = locks.named_lock('env.armed')\n"
            "assert isinstance(lk, locks.NamedLock)\n"
            "with lk:\n"
            "    time.sleep(0)\n"
            "v = locks.global_dep().violations\n"
            "assert [x['call'] for x in v] == ['time.sleep'], v\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env={**os.environ, "RTPU_LOCKDEP": "1"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_both_packages_armed_see_a_sleep_under_a_port_lock():
    """The JAX package's conftest arms its lockdep first and wraps
    time.sleep; the port's wrapper chains over it, so a sleep under a
    port lock reaches the port's ledger (and the JAX ledger stays quiet:
    no JAX lock is held)."""
    jlocks = pytest.importorskip("reporter_tpu.utils.locks")
    jlocks.arm()
    assert getattr(time.sleep, "__lockdep_label__", None) == "time.sleep" \
        or getattr(time.sleep.__rtt_lockdep_orig__, "__lockdep_label__",
                   None) == "time.sleep"
    dep = locks.Lockdep()
    jdep = jlocks.Lockdep()
    lk = locks.NamedLock("both.port", dep=dep)
    with locks.use(dep), jlocks.use(jdep):
        with lk:
            time.sleep(0)
    assert [v["call"] for v in dep.violations] == ["time.sleep"]
    assert jdep.violations == []
    # and the JAX lock under its own runtime still sees it
    jlk = jlocks.NamedLock("both.jax", dep=jdep)
    with locks.use(dep), jlocks.use(jdep):
        with jlk:
            time.sleep(0)
    assert [v["call"] for v in jdep.violations] == ["time.sleep"]
    assert len(dep.violations) == 1


# ---------------------------------------------------------------------------
# the contract

def test_the_contract_is_acyclic_and_dated():
    contract.validate()


def test_a_cyclic_or_undated_contract_is_refused(monkeypatch):
    monkeypatch.setitem(contract.LOCK_ORDER_EDGES, ("zz.a", "zz.b"),
                        "2026-10-17 synthetic")
    monkeypatch.setitem(contract.LOCK_ORDER_EDGES, ("zz.b", "zz.a"),
                        "2026-10-17 synthetic")
    with pytest.raises(AssertionError, match="cycle"):
        contract.validate()
    monkeypatch.delitem(contract.LOCK_ORDER_EDGES, ("zz.b", "zz.a"))
    monkeypatch.setitem(contract.BLOCKING_ALLOW, ("zz.a", "time.sleep"),
                        "no date")
    with pytest.raises(AssertionError, match="date"):
        contract.validate()


def test_the_process_ledger_keeps_to_the_contract():
    snap = LOCKDEP.snapshot()
    assert not [e for e in snap["edges"]
                if e not in contract.LOCK_ORDER_EDGES]
    assert snap["violations"] == []


def test_every_port_lock_class_is_known_to_the_jax_contract_or_ours():
    """The port's named lock classes cover the JAX package's set (the
    profiling hook brought profiling.trace): read from the sources."""
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(r"named_(?:lock|rlock|condition)\(\s*\"([a-z_.]+)\"")

    def classes(pkg):
        out = set()
        for d, _, names in os.walk(os.path.join(root, pkg)):
            for n in names:
                if n.endswith(".py"):
                    with open(os.path.join(d, n)) as f:
                        out |= set(pat.findall(f.read()))
        return out

    port, jax = classes("reporter_tpu_torch"), classes("reporter_tpu")
    assert jax <= port, sorted(jax - port)
    assert port - jax == {"linkhealth.buffers", "matcher.counters"}
