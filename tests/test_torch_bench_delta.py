"""The port's regression sentinel over two chip_smoke.py logs
(reporter_tpu_torch/analysis/bench_delta.py): seeded log pairs for each
attribution (regression, link-attributable, link-unknown, a changed card
or power limit), schema drift, repeated tags, non-phase lines, the
runtime coverage check and the CLI's exit 0; and its link and direction
rules held against the JAX package's (reporter_tpu/analysis/
bench_delta.py) where the two share them."""

import json
import os
import subprocess
import sys

import pytest

from reporter_tpu.analysis import bench_delta as jbd
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
from reporter_tpu_torch.analysis import bench_delta as bd

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
CARD_450 = "NVIDIA H100 80GB HBM3, 450.00 W"


def _line(tag, card=CARD, **fields):
    return f"[{tag}] [{card}] " + json.dumps(fields)


def _link(mood="healthy", rtt=0.2, mbps=9000.0, card=CARD):
    return _line("link", card, degraded_rtt_ms=5.0, samples=[
        {"rtt_ms": rtt, "mbps": mbps, "mood": mood} for _ in range(5)])


def _log(batch_ms=200.0, kernel_ms=0.2, errors=0, link=True, card=CARD,
         mood="healthy", rtt=0.2, extra=(), preamble=True):
    lines = []
    if preamble:          # the card line and other prints are not phases
        lines += [card, "chip_smoke: building ...", "{\"kernels\": []}"]
    lines += [
        _line("device", card, torch="2.x", name="H100", count=1, at_s=0.1),
        _line("kernel:sub", card, metro="sf", arm="sub", k=8, points=131072,
              ms=kernel_ms, ms_back_to_back=kernel_ms * 0.9,
              bound_ms=0.026, at_s=1.0),
        _line("main", card, metro="sf", traces=1024, batch_ms_median=batch_ms,
              stage_ms={"prepare": 9.0, "walk": 20.0}, records_equal=True,
              probes_per_s=122880 / batch_ms * 1e3, at_s=2.0),
        _line("main", card, metro="organic", traces=1024,
              batch_ms_median=180.0, at_s=3.0),
        _line("watchdog", card, metro="sf", errors=errors, at_s=4.0),
    ]
    if link:
        lines.append(_link(mood, rtt, card=card))
    lines += list(extra)
    return "\n".join(lines)


def _diff(old, new, **kw):
    return bd.compare(bd.parse_log(old), bd.parse_log(new), **kw)


def _paths(rows):
    return {r["path"]: r["verdict"] for r in rows}


# ---------------------------------------------------------------------------
# parsing

def test_phase_lines_are_parsed_and_others_skipped():
    log = bd.parse_log(_log() + "\nTraceback (most recent call last):\n"
                       "[broken] [x] {not json\n[nojson] [x] [1, 2]\n")
    assert log["lines"] == 6
    assert log["skipped"] == 3 + 3       # preamble, traceback, two bad
    assert log["cards"] == [CARD]
    assert set(log["tags"].values()) == {"device", "kernel:sub", "main",
                                         "watchdog", "link"}


def test_repeated_tags_are_keyed_by_identity_then_order():
    text = "\n".join([
        _line("main", metro="sf", batch_ms_median=1.0),
        _line("main", metro="organic", batch_ms_median=2.0),
        _line("kernel:k", metro="sf", arm="sub", k=8, ms=0.2),
        _line("kernel:k", metro="sf", arm="sub", k=12, ms=0.3),
        _line("gates", seconds=40.0),
        _line("gates", seconds=41.0)])
    keys = list(bd.parse_log(text)["phases"])
    assert keys == ["main[metro=sf]", "main[metro=organic]",
                    "kernel:k[metro=sf,arm=sub,k=8]",
                    "kernel:k[metro=sf,arm=sub,k=12]", "gates", "gates#2"]


def test_identical_logs_compare_flat():
    d = _diff(_log(), _log())
    assert d["compared"] > 0
    assert d["compared"] == d["flat"]
    assert not (d["regressions"] or d["link_attributable"]
                or d["card_drift"] or d["improved"])
    assert d["only_old_keys"] == d["only_new_keys"] == 0


# ---------------------------------------------------------------------------
# attribution

def test_same_link_worse_batch_and_kernel_are_regressions():
    d = _diff(_log(), _log(batch_ms=300.0, kernel_ms=0.4))
    got = _paths(d["regressions"])
    assert got["main[metro=sf].batch_ms_median"] == "regression"
    assert got["kernel:sub[metro=sf,arm=sub,k=8].ms"] == "regression"
    assert got["main[metro=sf].probes_per_s"] == "regression"
    assert d["link"]["drifted"] is False
    assert not d["link_attributable"] and not d["card_drift"]


def test_a_changed_link_excuses_end_to_end_numbers_only():
    d = _diff(_log(), _log(batch_ms=300.0, kernel_ms=0.4, mood="degraded"))
    assert d["link"]["drifted"] is True
    link = _paths(d["link_attributable"])
    assert link["main[metro=sf].batch_ms_median"] == "link-attributable"
    # a kernel time on the card is link-free: still a regression
    assert _paths(d["regressions"]) == {
        "kernel:sub[metro=sf,arm=sub,k=8].ms": "regression",
        "kernel:sub[metro=sf,arm=sub,k=8].ms_back_to_back": "regression"}


def test_a_moved_round_trip_is_drift_within_one_mood():
    d = _diff(_log(), _log(batch_ms=300.0, rtt=0.5))
    assert d["link"]["drifted"] is True
    assert "main[metro=sf].batch_ms_median" in _paths(d["link_attributable"])


def test_a_log_without_link_line_is_link_unknown():
    d = _diff(_log(link=False), _log(batch_ms=300.0))
    assert d["link"]["drifted"] is None
    assert _paths(d["link_attributable"])[
        "main[metro=sf].batch_ms_median"] == "link-unknown"


def test_a_changed_power_limit_is_drift_across_calls():
    d = _diff(_log(), _log(batch_ms=300.0, kernel_ms=0.4, card=CARD_450))
    assert d["card"] == {"old": CARD, "new": CARD_450, "changed": True}
    assert not d["regressions"] and not d["link_attributable"]
    assert _paths(d["card_drift"])[
        "kernel:sub[metro=sf,arm=sub,k=8].ms"] == "card-drift"
    assert "drift across calls" in bd.render(d)


def test_zero_baseline_counter_and_improvement_and_threshold():
    d = _diff(_log(), _log(errors=3, batch_ms=150.0, kernel_ms=0.21))
    reg = {r["path"]: r for r in d["regressions"]}
    assert reg["watchdog[metro=sf].errors"]["delta_pct"] is None
    assert d["regressions"][0]["path"] == "watchdog[metro=sf].errors"
    assert d["improved"] >= 2          # batch and probes/s
    # 5% on the kernel: below the 10% threshold, flat
    assert "kernel:sub[metro=sf,arm=sub,k=8].ms" not in reg


def test_a_stage_inherits_its_containers_direction():
    old = _line("main", metro="sf", stage_ms={"walk": 10.0})
    new = _line("main", metro="sf", stage_ms={"walk": 30.0})
    d = _diff(old, new)
    assert _paths(d["regressions"]) == {
        "main[metro=sf].stage_ms.walk": "regression"}


def test_schema_drift_is_counted_never_a_regression():
    new = _log(extra=[_line("examples", seconds=20.0),
                      _line("main", metro="sf+r", batch_ms_median=1e9)])
    old = _log(extra=[_line("api", seconds=1.0)])
    d = _diff(old, new)
    assert d["only_new_keys"] == 2 and d["only_old_keys"] == 1
    assert not d["regressions"]
    # a field added to a shared line is drift too
    d = _diff(_line("main", metro="sf", batch_ms_median=1.0),
              _line("main", metro="sf", batch_ms_median=1.0, walk_ms=99.0))
    assert d["only_new_keys"] == 1 and not d["regressions"]


def test_neutral_fields_and_subtrees_are_never_compared():
    old = _line("main", metro="sf", traces=1024, at_s=1.0,
                checks={"x_ms": 1.0}, records_equal=True)
    new = _line("main", metro="sf", traces=4096, at_s=900.0,
                checks={"x_ms": 9.0}, records_equal=False)
    d = _diff(old, new)
    assert d["compared"] == 0 and not d["regressions"]


# ---------------------------------------------------------------------------
# the runtime coverage check ([bench_delta]'s)

def test_unclassified_numeric_fields_are_named():
    text = "\n".join([
        _line("main", metro="sf", batch_ms_median=1.0, traces=3,
              mystery_metric_xyz=3.5, flag=True, label="x",
              padding_by_bucket={"128": 4}, launches_by_path={"sf:x": 2},
              nested={"inner_unknown": 1}),
        _link()])
    got = bd.unclassified_fields(bd.parse_log(text))
    assert got == [("inner_unknown", "main[metro=sf].nested.inner_unknown"),
                   ("mystery_metric_xyz", "main[metro=sf].mystery_metric_xyz")]


@pytest.mark.parametrize("key,want", [
    ("batch_ms_median", -1), ("ms", -1), ("latency_ms_p99", -1),
    ("seconds", -1), ("construct_s", -1), ("gxx_seconds", -1),
    ("records_per_s", 1), ("probes_per_s", 1), ("copy_mb_per_s_p50", 1),
    ("speedup_vs_1", 1), ("vs_soak_x", 1), ("agreement", 1),
    ("launches", -1), ("calibration_launches", -1), ("max_abs_err", -1),
    ("edge_set_mismatches", -1), ("candidates_ms_by_arm", -1),
    ("at_s", 0), ("timeout_s", 0), ("traces", 0), ("k", 0), ("128", 0),
    ("bound_by", 0), ("records_equal", 0)])
def test_directions_of_the_ports_field_names(key, want):
    assert bd.classify_direction(key) == want


# ---------------------------------------------------------------------------
# against the JAX package

@pytest.mark.parametrize("old,new", [
    (None, {"mood": "healthy"}),
    ({"mood": "healthy", "rtt_ms": 0.2, "mbps": 9000.0},
     {"mood": "degraded", "rtt_ms": 0.2, "mbps": 9000.0}),
    ({"mood": "healthy", "rtt_ms": 0.2, "mbps": 9000.0},
     {"mood": "healthy", "rtt_ms": 0.29, "mbps": 6500.0}),
    ({"mood": "healthy", "rtt_ms": 0.2, "mbps": 9000.0},
     {"mood": "healthy", "rtt_ms": 0.31, "mbps": 9000.0}),
    ({"mood": "healthy", "rtt_ms": 0.2, "mbps": 9000.0},
     {"mood": "healthy", "rtt_ms": 0.2, "mbps": 5000.0}),
    ({"mood": "healthy", "rtt_ms": None, "mbps": None},
     {"mood": "healthy", "rtt_ms": 0.2, "mbps": 9000.0})])
def test_link_drift_is_the_jax_rule(old, new):
    assert bd.link_drifted(old, new) == jbd.link_drifted(old, new)


@pytest.mark.parametrize("key", [
    "batch_ms", "device_ms", "errors", "speedup", "dispatch_timeout",
    "seconds_unknown_xyz", "mystery"])
def test_shared_suffixes_classify_as_the_jax_module_does(key):
    assert bd.classify_direction(key) == jbd.classify_direction(key)


def test_the_verdicts_match_the_jax_sentinels():
    """The same move under the same link conditions gets the same verdict
    from both sentinels: the JAX one over two composites, the port's
    over two logs."""
    def jdoc(ms, mood):
        return {"value": 1.0, "detail": {
            "link_health": {"mood": mood, "rtt_ms": 0.2, "mbps": 9000.0},
            "request_latency_ms": ms}}

    def plog(ms, mood):
        return "\n".join([_line("serve", metro="sf", latency_ms_p50=ms),
                          _link(mood)])

    for mood in ("healthy", "degraded"):
        j = jbd.compare(jdoc(100.0, "healthy"), jdoc(150.0, mood))
        p = _diff(plog(100.0, "healthy"), plog(150.0, mood))
        jv = [r["verdict"] for r in j["regressions"] + j["link_attributable"]]
        pv = [r["verdict"] for r in p["regressions"] + p["link_attributable"]]
        assert len(jv) == len(pv) == 1
        assert (jv[0] == "regression") == (pv[0] == "regression")


# ---------------------------------------------------------------------------
# the command line

def test_cli_renders_and_exits_zero(tmp_path):
    a, b = tmp_path / "a.log", tmp_path / "b.log"
    a.write_text(_log())
    b.write_text(_log(batch_ms=300.0, card=CARD_450))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "reporter_tpu_torch.analysis.bench_delta",
         str(a), str(b), "--threshold", "5"], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "threshold 5.0%" in proc.stdout
    assert "card changed=True" in proc.stdout
    assert "main[metro=sf].batch_ms_median" in proc.stdout
    assert "[card-drift]" in proc.stdout
    assert bd.main([str(a), str(a)]) == 0
