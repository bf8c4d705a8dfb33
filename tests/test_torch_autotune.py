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

    def on_a_card(params, ts, measure, backend=None):
        return real(params, ts, _timer({"subcull@128": 0.5}, fail_mxu=True),
                    directory=str(tmp_path), backend="cuda", devkey="cuda:t")

    monkeypatch.setattr(autotune, "resolve_plan", on_a_card)
    with pytest.raises(RuntimeError, match="mxu@128.*mxu launch failed"):
        SegmentMatcher(ts, device="cpu")
    # with every arm measured the same call serves the winner
    monkeypatch.setattr(autotune, "resolve_plan", lambda p, t, m, backend=None:
                        real(p, t, _timer({"block@128": 0.1}),
                             directory=str(tmp_path / "ok"), backend="cuda",
                             devkey="cuda:t"))
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
