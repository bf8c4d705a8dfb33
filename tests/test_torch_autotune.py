"""The port's sweep levers and per-metro tuner against the JAX package's:
``MatcherParams.with_env_overrides``, the plan encoding, ``calibrate``
under injected timings, the calibration batch, the plan cache and
``resolve_plan``'s gates, and a CPU matcher pinned to each arm. Every
comparison here is exact (tolerance 0): fields, bytes, reports, records.
The port has no launch-width rung (``sweep_nj_cap`` / ``RTPU_NJ_CAP``):
its plans carry the JAX default rung, 128, and it rejects the variable.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams, Config
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.matcher import autotune as jautotune
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from reporter_tpu.config import SWEEP_NJ_CAP_RUNGS
from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.matcher import autotune
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.matcher.autotune import CANDIDATE_ARMS, TunedPlan
from reporter_tpu_torch.tiles.tileset import TileSet
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")
_SWEEP_FIELDS = ("sweep_subcull", "sweep_lowp", "sweep_mxu", "sweep_autotune")


@pytest.fixture(scope="module")
def tiles():
    """(JAX tile, the port's TileSet over the same arrays)."""
    jts = compile_network(generate_city("tiny", seed=31),
                          CompilerParams(reach_radius=400.0))
    arrays = {f: getattr(jts, f) for f in _ARRAY_FIELDS}
    return jts, TileSet.from_arrays(jts.name, jts.meta.origin_lonlat, arrays)


# ---------------------------------------------------------------------------
# the sweep levers from the environment

_ENVS = [
    {},
    {"RTPU_SWEEP_SUBCULL": "0"},
    {"RTPU_SWEEP_SUBCULL": "yes"},
    {"RTPU_SWEEP_SUBCULL": " "},
    {"RTPU_SWEEP_SUBCULL": "maybe"},
    {"RTPU_SWEEP_LOWP": "bf16"},
    {"RTPU_SWEEP_LOWP": ""},
    {"RTPU_SWEEP_LOWP": "fp8"},
    {"RTPU_SWEEP_MXU": "1"},
    {"RTPU_SWEEP_MXU": "on", "RTPU_SWEEP_LOWP": "bf16"},
    {"RTPU_SWEEP_MXU": "1", "RTPU_SWEEP_SUBCULL": "0"},
    {"RTPU_SWEEP_LOWP": "bf16", "RTPU_SWEEP_SUBCULL": "off"},
    {"RTPU_SWEEP_MXU": "2"},
    {"RTPU_NJ_CAP": "64"},
    {"RTPU_NJ_CAP": "256", "RTPU_SWEEP_AUTOTUNE": "true"},
    {"RTPU_NJ_CAP": "100"},
    {"RTPU_NJ_CAP": "wide"},
    {"RTPU_SWEEP_AUTOTUNE": "0"},
    {"RTPU_SWEEP_AUTOTUNE": "nope"},
]


@pytest.mark.parametrize("base", [{}, {"sweep_subcull": False}])
@pytest.mark.parametrize("env", _ENVS, ids=lambda e: json.dumps(e) or "{}")
def test_with_env_overrides_matches_reference(env, base):
    def run(cls):
        try:
            p = cls(**base).with_env_overrides(env)
        except ValueError as exc:
            return "ValueError: " + str(exc)
        return {f: getattr(p, f) for f in _SWEEP_FIELDS}

    got, want = run(MatcherParams), run(JMatcherParams)
    if "RTPU_NJ_CAP" in env:        # a rung the CUDA kernel does not have
        assert got.startswith("ValueError: RTPU_NJ_CAP="), got
        assert "no launch-width rung" in got
    else:
        assert got == want


@pytest.mark.parametrize("kw", [
    dict(sweep_lowp="fp16"), dict(sweep_lowp="bf16", sweep_subcull=False),
    dict(sweep_mxu=True, sweep_subcull=False)], ids=["lowp_fp16", "bf16_no_subcull", "mxu_no_subcull"])
def test_field_levers_are_checked_like_config_validate(kw):
    """The JAX package rejects these in Config.validate; the port, which
    has no Config, in with_env_overrides (SegmentMatcher calls it)."""
    with pytest.raises(ValueError):
        Config(matcher=JMatcherParams(**kw)).validate()
    with pytest.raises(ValueError):
        MatcherParams(**kw).with_env_overrides({})


# ---------------------------------------------------------------------------
# plan encoding and calibration

@pytest.mark.parametrize("arm,lowp", CANDIDATE_ARMS)
def test_plan_array_round_trips_like_reference(arm, lowp):
    for src in ("default", "measured", "cache", "staged", "timeout"):
        p = TunedPlan(arm=arm, lowp=lowp, source=src)
        jp = jautotune.TunedPlan(arm=arm, lowp=lowp,
                                 nj_cap=autotune.PLAN_NJ_CAP, source=src)
        arr = autotune.plan_array(p)
        assert arr.tobytes() == jautotune.plan_array(jp).tobytes()
        assert autotune.plan_from_array(arr) == p
        assert jautotune.plan_from_array(arr) == jp
        assert autotune.plan_json(p) == jautotune.plan_json(jp)
        jover = jp.params_overrides()
        assert jover.pop("sweep_nj_cap") == autotune.PLAN_NJ_CAP
        assert p.params_overrides() == jover
        assert p.label == jp.label


def test_plan_from_array_rejects_what_the_reference_rejects():
    good = autotune.plan_array(TunedPlan(source="measured"))
    bad_v, bad_cap, bad_combo = good.copy(), good.copy(), good.copy()
    bad_v[0] += 1
    bad_cap[3] = 100
    bad_combo[1], bad_combo[2] = 0, 1          # block + bf16
    for leaf in (None, good.tolist(), good[:4], bad_v, bad_cap, bad_combo,
                 good):
        got = autotune.plan_from_array(leaf)
        want = jautotune.plan_from_array(leaf)
        assert (got is None) == (want is None)
        if got is not None:
            assert autotune.plan_json(got) == jautotune.plan_json(want)
    # a JAX plan at another launch-width rung: the port has no such rung
    for cap in SWEEP_NJ_CAP_RUNGS:
        other = good.copy()
        other[3] = cap
        assert jautotune.plan_from_array(other) is not None
        assert (autotune.plan_from_array(other) is None) == \
            (cap != autotune.PLAN_NJ_CAP)


def _timer(costs_ms, fail_mxu=False):
    def measure(plan):
        if fail_mxu and plan.arm == "mxu":
            raise RuntimeError("mxu launch failed")
        return costs_ms.get(plan.label, 1.0) / 1e3
    return measure


# the JAX tuner at the port's one launch-width rung
_JRUNG = dict(rungs=(autotune.PLAN_NJ_CAP,), default_cap=autotune.PLAN_NJ_CAP)


@pytest.mark.parametrize("costs,fail_mxu", [
    ({"mxu+bf16@128": 0.4, "subcull@128": 0.8, "block@128": 2.0}, False),
    ({"block@128": 0.1}, False),
    ({"subcull+bf16@128": 0.3, "mxu@128": 0.3, "block@128": 0.9}, False),
    ({}, False),
    ({"mxu+bf16@128": 0.1, "subcull@128": 0.5}, True),
], ids=["mxu_bf16", "block", "bf16_ties_mxu", "ties", "mxu_fails"])
def test_calibrate_matches_reference(costs, fail_mxu):
    plan, rep = autotune.calibrate(_timer(costs, fail_mxu))
    jplan, jrep = jautotune.calibrate(_timer(costs, fail_mxu), **_JRUNG)
    assert autotune.plan_json(plan) == jautotune.plan_json(jplan)
    assert rep == jrep


def test_calibrate_all_failed_is_the_default():
    def boom(plan):
        raise RuntimeError("no card")

    plan, rep = autotune.calibrate(boom)
    jplan, jrep = jautotune.calibrate(boom, **_JRUNG)
    assert plan == TunedPlan() and autotune.plan_json(plan) == \
        jautotune.plan_json(jplan)
    assert rep == jrep


def test_calibration_batch_and_fingerprint_byte_equal(tiles):
    jts, ts = tiles
    got = autotune.calibration_batch(ts)
    want = jautotune.calibration_batch(jts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert autotune.tile_fingerprint(ts) == jautotune.tile_fingerprint(jts)


# ---------------------------------------------------------------------------
# the plan cache and the resolution order

def test_cache_round_trip_and_corruption_misses(tmp_path, tiles):
    _, ts = tiles
    d = str(tmp_path)
    fp = autotune.tile_fingerprint(ts)
    plan = TunedPlan(arm="mxu", lowp="bf16", source="measured")
    autotune.store_cached_plan(plan, {"candidates": {}}, fp, "cuda:x", d)
    got = autotune.load_cached_plan(fp, "cuda:x", d)
    assert got is not None and got.label == plan.label
    assert got.source == "cache"
    assert autotune.load_cached_plan(fp, "cuda:y", d) is None
    assert autotune.load_cached_plan("feedbeef", "cuda:x", d) is None
    path = autotune._cache_path(d, fp, "cuda:x")
    for bad in ("{not json", "[]", json.dumps({"plan_version": 1,
                                              "plan": {"arm": "warp"}})):
        with open(path, "w") as f:
            f.write(bad)
        assert autotune.load_cached_plan(fp, "cuda:x", d) is None


_STORE_LOOP = """
import sys
from reporter_tpu_torch.matcher import autotune
arm, lowp = sys.argv[2], sys.argv[3]
report = {"candidates": {f"c{i}": {"ms": float(i)} for i in range(300)}}
for _ in range(150):
    autotune.store_cached_plan(autotune.TunedPlan(arm=arm, lowp=lowp,
                                                  source="measured"),
                               report, "fp", "cuda:0", sys.argv[1])
"""


def test_cache_store_is_whole_under_concurrent_writers(tmp_path):
    """The workers of a topology start at once and, with a cold cache,
    each calibrates and stores its plan: several threads and two
    processes storing plans together leave one whole, readable plan and
    no temp file."""
    import subprocess
    import sys
    import threading

    d = str(tmp_path / "cache")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _STORE_LOOP, d, arm, lowp],
        env=dict(os.environ, PYTHONPATH=root))
        for arm, lowp in (("mxu", "bf16"), ("block", "off"))]
    report = {"candidates": {f"c{i}": {"ms": float(i)} for i in range(300)}}
    arms = [a for a in CANDIDATE_ARMS]
    torn = []

    def store(i):
        arm, lowp = arms[i % len(arms)]
        for _ in range(150):
            autotune.store_cached_plan(TunedPlan(arm=arm, lowp=lowp,
                                                 source="measured"),
                                       report, "fp", "cuda:0", d)
            if os.path.exists(autotune._cache_path(d, "fp", "cuda:0")) \
                    and autotune.load_cached_plan("fp", "cuda:0", d) is None:
                torn.append(i)

    threads = [threading.Thread(target=store, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
        assert not th.is_alive()
    for proc in procs:
        assert proc.wait(timeout=120) == 0
    assert not torn                       # every read saw a whole plan
    got = autotune.load_cached_plan("fp", "cuda:0", d)
    assert got is not None and (got.arm, got.lowp) in CANDIDATE_ARMS
    with open(autotune._cache_path(d, "fp", "cuda:0")) as f:
        assert json.load(f)["candidates"] == report["candidates"]
    assert os.listdir(d) == [os.path.basename(
        autotune._cache_path(d, "fp", "cuda:0"))]


def test_cache_dir_honours_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("RTPU_AUTOTUNE_CACHE", str(tmp_path))
    assert autotune.cache_dir() == str(tmp_path)
    monkeypatch.delenv("RTPU_AUTOTUNE_CACHE")
    assert autotune.cache_dir().endswith(
        os.path.join(".cache", "reporter_tpu_torch", "autotune"))


def test_resolve_measures_once_then_serves_the_cache(tmp_path, tiles):
    _, ts = tiles
    calls = {"n": 0}

    def counting(plan):
        calls["n"] += 1
        return _timer({"block@128": 0.1})(plan)

    p1, i1 = autotune.resolve_plan(MatcherParams(), ts, counting,
                                   directory=str(tmp_path), backend="cuda",
                                   devkey="v")
    assert i1["source"] == "measured" and p1.label == "block@128"
    # the port measures each arm once: it has no launch-width rung
    assert calls["n"] == len(CANDIDATE_ARMS)
    assert i1["calibration_dispatches"] == \
        len(CANDIDATE_ARMS) * (autotune.CAL_DISPATCHES + 1)
    p2, i2 = autotune.resolve_plan(MatcherParams(), ts, counting,
                                   directory=str(tmp_path), backend="cuda",
                                   devkey="v")
    assert i2["source"] == "cache" and p2.label == p1.label
    assert calls["n"] == len(CANDIDATE_ARMS)


def test_resolve_gates_off_explicit_and_cpu(tiles):
    _, ts = tiles

    def boom(_):
        raise AssertionError("the tuner measured where it must not")

    assert autotune.resolve_plan(MatcherParams(sweep_autotune=False), ts,
                                 boom, backend="cuda") == (None, {"source": "off"})
    for knobs in (dict(sweep_mxu=True, sweep_lowp="bf16"),
                  dict(sweep_subcull=False), dict(sweep_lowp="bf16"),
                  dict(sweep_mxu=True)):
        plan, info = autotune.resolve_plan(MatcherParams(**knobs), ts, boom,
                                           backend="cuda")
        assert plan is None and info["source"] == "explicit", knobs
        jplan, jinfo = jautotune.resolve_plan(
            JMatcherParams(candidate_backend="dense", **knobs), ts, {}, boom,
            backend="tpu")
        assert jinfo == info
    assert autotune.resolve_plan(MatcherParams(), ts, boom,
                                 backend="cpu") == (None, {"source": "cpu"})


# ---------------------------------------------------------------------------
# a CPU matcher pinned to each arm

_PINS = {"block": dict(sweep_subcull=False), "sub": {},
         "sub_bf16": dict(sweep_lowp="bf16"), "mxu": dict(sweep_mxu=True),
         "mxu_bf16": dict(sweep_mxu=True, sweep_lowp="bf16")}


@pytest.fixture(scope="module")
def golden_pair():
    with open(os.path.join(_FIX, "golden_traces.json")) as f:
        fx = json.load(f)
    jts = compile_network(generate_city(fx[0]["city"]),
                          CompilerParams(**fx[0]["compiler"]))
    arrays = {f: getattr(jts, f) for f in _ARRAY_FIELDS}
    ts = TileSet.from_arrays(jts.name, jts.meta.origin_lonlat, arrays)
    fleet = synthesize_fleet(jts, 24, num_points=60, seed=9)
    traces = [JTrace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]
    jm = JSegmentMatcher(jts, Config(
        matcher_backend="jax",
        matcher=JMatcherParams(candidate_backend="dense")))
    want = [[r.to_json() for r in x] for x in jm.match_many(traces)]
    return ts, traces, want


@pytest.mark.parametrize("arm", list(_PINS))
def test_pinned_cpu_matcher_records_equal_reference(golden_pair, arm):
    ts, traces, want = golden_pair
    m = SegmentMatcher(ts, MatcherParams(sweep_autotune=False, **_PINS[arm]),
                       device="cpu")
    assert m.tuned_plan is None and m.tuned_report == {"source": "off"}
    assert m.tuned_plan_array() is None
    assert {k: getattr(m.params, k) for k in _PINS[arm]} == _PINS[arm]
    got = m.match_many([Trace(t.uuid, t.xy, t.times) for t in traces])
    assert [[r.to_json() for r in x] for x in got] == want
    assert sum(len(x) for x in want) > 50


def test_matcher_raises_when_an_arm_fails_calibration(golden_pair,
                                                     monkeypatch, tmp_path):
    """calibrate skips an arm that raised; the matcher must not then serve
    another arm quietly."""
    ts, _, _ = golden_pair
    real = autotune.resolve_plan

    def on_a_card(params, ts, measure, backend=None, **guard):
        return real(params, ts, _timer({"subcull@128": 0.5}, fail_mxu=True),
                    directory=str(tmp_path), backend="cuda", devkey="cuda:t",
                    **guard)

    monkeypatch.setattr(autotune, "resolve_plan", on_a_card)
    with pytest.raises(RuntimeError, match="mxu@128.*mxu launch failed"):
        SegmentMatcher(ts, device="cpu")
    # with every arm measured the same call serves the winner
    monkeypatch.setattr(autotune, "resolve_plan",
                        lambda p, t, m, backend=None, **guard:
                        real(p, t, _timer({"block@128": 0.1}),
                             directory=str(tmp_path / "ok"), backend="cuda",
                             devkey="cuda:t", **guard))
    m = SegmentMatcher(ts, device="cpu")
    assert m.tuned_plan.label == "block@128" and not m.params.sweep_subcull


def test_default_cpu_matcher_does_not_tune(golden_pair, monkeypatch):
    ts, _, _ = golden_pair
    m = SegmentMatcher(ts, device="cpu")
    assert m.tuned_plan is None and m.tuned_report == {"source": "cpu"}
    assert dataclasses.asdict(m.params) == dataclasses.asdict(MatcherParams())
    monkeypatch.setenv("RTPU_SWEEP_LOWP", "bf16")
    m = SegmentMatcher(ts, device="cpu")
    assert m.params.sweep_lowp == "bf16"
    assert m.tuned_report == {"source": "explicit"}


# ---------------------------------------------------------------------------
# the guard: each candidate's measurement under the watchdog


def _stalling(calls, seconds=0.5):
    def measure(plan):
        calls["n"] += 1
        time.sleep(seconds)
        return 0.001
    return measure


def test_watchdog_timeout_degrades_to_static_default(tiles, tmp_path):
    """A measurement that stalls past the per-candidate bound aborts the
    whole calibration to the default plan, source "timeout", not cached:
    construction degrades, never hangs (tests/test_autotune.py)."""
    from reporter_tpu.utils.watchdog import (
        AbandonedThreadWatchdog as JWatchdog)
    from reporter_tpu_torch.utils.watchdog import AbandonedThreadWatchdog

    jts, ts = tiles
    out = {}
    for name, wd in (("jax", JWatchdog(cap=4, thread_name="t-jax")),
                     ("port", AbandonedThreadWatchdog(cap=4,
                                                      thread_name="t-port"))):
        calls = {"n": 0}
        d = tmp_path / name
        t0 = time.perf_counter()
        if name == "jax":
            plan, info = jautotune.resolve_plan(
                JMatcherParams(candidate_backend="dense"), jts, {},
                _stalling(calls), watchdog=wd, timeout_s=0.05,
                directory=str(d), backend="tpu", devkey="t")
            pj = jautotune.plan_json(plan)
        else:
            plan, info = autotune.resolve_plan(
                MatcherParams(), ts, _stalling(calls), watchdog=wd,
                timeout_s=0.05, directory=str(d), backend="cuda",
                devkey="t")
            pj = autotune.plan_json(plan)
        elapsed = time.perf_counter() - t0
        assert elapsed < 0.45, name          # not the 0.5 s stall
        assert calls["n"] == 1, name         # aborted at the first stall
        assert wd.abandoned == 1, name
        assert not d.exists() or not os.listdir(d), name   # nothing cached
        out[name] = (pj, info)
    (jpj, jinfo), (ppj, pinfo) = out["jax"], out["port"]
    assert ppj["source"] == jpj["source"] == "timeout"
    assert (ppj["arm"], ppj["lowp"]) == (jpj["arm"], jpj["lowp"])
    assert pinfo["source"] == jinfo["source"] == "timeout"
    assert pinfo["note"] == jinfo["note"]
    assert "aborted" in pinfo["note"]
    for key in ("candidates", "errors", "measured",
                "calibration_dispatches"):
        assert pinfo[key] == jinfo[key], key


def test_watchdog_open_breaker_skips_measuring(tiles, tmp_path):
    from reporter_tpu.utils.watchdog import (
        AbandonedThreadWatchdog as JWatchdog)
    from reporter_tpu_torch.utils.watchdog import AbandonedThreadWatchdog

    jts, ts = tiles

    def never(plan):
        raise AssertionError("measured through an open breaker")

    jplan, jinfo = jautotune.resolve_plan(
        JMatcherParams(candidate_backend="dense"), jts, {}, never,
        watchdog=JWatchdog(cap=0), directory=str(tmp_path / "j"),
        backend="tpu", devkey="t")
    plan, info = autotune.resolve_plan(
        MatcherParams(), ts, never, watchdog=AbandonedThreadWatchdog(cap=0),
        directory=str(tmp_path / "p"), backend="cuda", devkey="t")
    assert plan.source == jplan.source == "timeout"
    assert info["note"] == jinfo["note"] == \
        "calibration aborted (watchdog breaker open) — static default"
    assert info["measured"] == jinfo["measured"] == 0


def test_guard_passes_a_result_and_an_error_through(tiles, tmp_path):
    """Under the watchdog a measurement that lands in time is the same
    calibration as without it; an arm's error is recorded, not a
    timeout."""
    from reporter_tpu_torch.utils.watchdog import AbandonedThreadWatchdog

    _, ts = tiles
    costs = {"mxu+bf16@128": 0.1, "subcull+bf16@128": 0.2,
             "subcull@128": 0.5}
    guarded = autotune.resolve_plan(
        MatcherParams(), ts, _timer(costs, fail_mxu=True),
        watchdog=AbandonedThreadWatchdog(), timeout_s=30.0,
        directory=str(tmp_path / "g"), backend="cuda", devkey="t")
    bare = autotune.resolve_plan(
        MatcherParams(), ts, _timer(costs, fail_mxu=True),
        directory=str(tmp_path / "b"), backend="cuda", devkey="t")
    assert guarded[0] == bare[0] and guarded[0].label == "subcull+bf16@128"
    for key in ("candidates", "errors", "measured", "winner"):
        assert guarded[1][key] == bare[1][key], key
    assert "mxu@128" in guarded[1]["errors"]


def test_matcher_passes_its_watchdog_and_serves_the_default(
        golden_pair, monkeypatch, tmp_path):
    """A matcher whose calibration hangs returns within the bound, with
    source "timeout", the default params, nothing cached, its records
    those of an untuned matcher; the abandoned measurement counts on the
    matcher's own watchdog until it lands."""
    ts, traces, want = golden_pair
    real = autotune.resolve_plan
    seen = {}

    def on_a_card(params, ts_, measure, backend=None, **guard):
        seen.update(guard)
        return real(params, ts_, _stalling({"n": 0}, 1.0),
                    directory=str(tmp_path), backend="cuda",
                    devkey="cuda:t", **guard)

    monkeypatch.setattr(autotune, "resolve_plan", on_a_card)
    monkeypatch.setattr(autotune, "CAL_TIMEOUT_S", 0.1)
    t0 = time.perf_counter()
    m = SegmentMatcher(ts, device="cpu")
    assert time.perf_counter() - t0 < 0.9
    assert seen["watchdog"] is m._watchdog and seen["timeout_s"] == 0.1
    assert m._watchdog.abandoned == 1
    assert m.tuned_plan is None and m.tuned_report["source"] == "timeout"
    assert dataclasses.asdict(m.params) == dataclasses.asdict(MatcherParams())
    assert not os.listdir(tmp_path)
    got = m.match_many([Trace(t.uuid, t.xy, t.times) for t in traces])
    assert [[r.to_json() for r in x] for x in got] == want
    deadline = time.perf_counter() + 10.0
    while m._watchdog.abandoned and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert m._watchdog.abandoned == 0       # it landed and un-counted


def test_no_fault_plan_names_the_autotune_site():
    """The JAX tuner hands the watchdog a site "autotune" that its
    faults.SITES lacks; neither package's plan can name it."""
    from reporter_tpu import faults as jfaults
    from reporter_tpu_torch import faults

    for mod in (jfaults, faults):
        assert "autotune" not in mod.SITES
        with pytest.raises(ValueError, match="unknown fault site"):
            mod.FaultPlan.parse("autotune:hang(1)@0")
