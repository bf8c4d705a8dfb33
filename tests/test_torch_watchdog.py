"""The dispatch watchdog's contract (reporter_tpu_torch/utils/watchdog.py)
held side by side with the JAX package's (reporter_tpu/utils/watchdog.py),
and the ``dispatch`` / ``backfill`` fault sites of the port's faults.py
against the JAX package's grammar. Bodies wait on events, not sleeps,
except where a hang is the point; every outcome is exact (tolerance 0:
counts, sentinels and parsed rules)."""

import threading

import pytest

from reporter_tpu import faults as jfaults
from reporter_tpu.utils import watchdog as jwatchdog
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
from reporter_tpu_torch import faults
from reporter_tpu_torch.utils import watchdog

PAIRS = {"jax": (jwatchdog, jfaults), "port": (watchdog, faults)}


@pytest.fixture(params=sorted(PAIRS))
def impl(request):
    return PAIRS[request.param]


def test_result_and_exception_relay(impl):
    wd_mod, _ = impl
    wd = wd_mod.AbandonedThreadWatchdog(cap=2)
    assert wd.run(lambda: 41 + 1, 5.0) == 42
    assert wd.run(lambda: None, 5.0) is None     # None is a legal result

    def boom():
        raise KeyError("inside")

    with pytest.raises(KeyError, match="inside"):
        wd.run(boom, 5.0)
    assert wd.abandoned == 0 and not wd.tripped


def test_timeout_abandons_counts_and_uncounts_the_zombie(impl):
    wd_mod, _ = impl
    wd = wd_mod.AbandonedThreadWatchdog(cap=2, thread_name="t")
    release = [threading.Event(), threading.Event()]
    landed = [threading.Event(), threading.Event()]

    def body(i):
        release[i].wait(10.0)
        landed[i].set()
        return i

    assert wd.run(lambda: body(0), 0.05) is wd_mod.TIMED_OUT
    assert wd.abandoned == 1 and not wd.tripped
    assert wd.run(lambda: body(1), 0.05) is wd_mod.TIMED_OUT
    assert wd.abandoned == 2 and wd.tripped          # the breaker at cap
    release[0].set()
    assert landed[0].wait(10.0)
    for _ in range(1000):                # the zombie un-counts itself
        if wd.abandoned == 1:
            break
        threading.Event().wait(0.01)
    assert wd.abandoned == 1 and not wd.tripped
    release[1].set()
    assert landed[1].wait(10.0)
    for _ in range(1000):
        if wd.abandoned == 0:
            break
        threading.Event().wait(0.01)
    assert wd.abandoned == 0


def test_fault_fires_inside_the_guarded_body(impl):
    """An injected hang stalls the body before fn runs; once abandoned,
    fn never runs at all (a late body must not race the retry)."""
    wd_mod, fmod = impl
    wd = wd_mod.AbandonedThreadWatchdog(cap=4)
    ran = []
    with fmod.use(fmod.FaultPlan.parse("dispatch:hang(0.3)@0")):
        out = wd.run(lambda: ran.append(1), 0.05, fault_site="dispatch")
        assert out is wd_mod.TIMED_OUT and wd.abandoned == 1
        # the second call is outside the window: runs at once
        assert wd.run(lambda: 7, 5.0, fault_site="dispatch") == 7
    for _ in range(300):
        if wd.abandoned == 0:
            break
        threading.Event().wait(0.01)
    assert wd.abandoned == 0 and ran == []


def test_crash_at_the_site_is_relayed_not_a_timeout(impl):
    wd_mod, fmod = impl
    wd = wd_mod.AbandonedThreadWatchdog()
    with fmod.use(fmod.FaultPlan.parse("dispatch:crash@0")):
        with pytest.raises(fmod.InjectedCrash):
            wd.run(lambda: 1, 5.0, fault_site="dispatch")
    assert wd.abandoned == 0


@pytest.mark.parametrize("spec", [
    "dispatch:hang(1.5)@1", "dispatch:hang(5)@0-", "dispatch:crash@1",
    "dispatch:fail@2-4~0.5", "backfill:crash@2", "backfill:crash@0-",
    "backfill:fail@1;dispatch:hang(0.4)@0"])
def test_dispatch_and_backfill_specs_parse_as_in_the_jax_package(spec):
    got = faults.FaultPlan.parse(spec, seed=3)
    ref = jfaults.FaultPlan.parse(spec, seed=3)
    assert {s: [r.__dict__ for r in rs] for s, rs in got.rules.items()} == \
        {s: [r.__dict__ for r in rs] for s, rs in ref.rules.items()}


@pytest.mark.parametrize("site", ["dispatch", "backfill"])
def test_seeded_schedule_equals_the_jax_package(site):
    def outcomes(fmod):
        plan = fmod.FaultPlan.parse(f"{site}:fail@0-~0.4", seed=17)
        out = []
        for _ in range(64):
            try:
                plan.fire(site)
                out.append(False)
            except fmod.InjectedFault:
                out.append(True)
        return out, plan.stats()["fired"][site]

    assert outcomes(faults) == outcomes(jfaults)


@pytest.mark.parametrize("spec,match", [
    ("backfill:torn@0", "broker-site kind"),
    ("dispatch:torn@1", "broker-site kind"),
    ("dispatch:hang@0", "positive duration"),
    ("backfill:crash(2)@0", "duration only applies"),
    ("dispatch:hang(1)@3-3", "empty call window"),
    ("dispatch:stall@0", "unknown fault kind")])
def test_bad_specs_reject_as_in_the_jax_package(spec, match):
    with pytest.raises(ValueError, match=match):
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError, match=match):
        faults.FaultPlan.parse(spec)


def test_fleet_promote_raises_naming_the_site():
    """The fleet's page-in site (fleet/residency.py): both packages parse
    a plan naming it to the same rules, and list it in the same place."""
    spec = "fleet_promote:hang(1)@0"
    got, want = ({site: [(r.kind, r.lo, r.hi, r.seconds, r.p) for r in rs]
                  for site, rs in mod.FaultPlan.parse(spec).rules.items()}
                 for mod in (faults, jfaults))
    assert got == want == {"fleet_promote": [("hang", 0, 1, 1.0, 1.0)]}
    assert faults.SITES == jfaults.SITES
