"""The port's lint (reporter_tpu_torch/analysis/lint_rules.py), its leak
detector and its lock contract, both directions:

  1. the repo gate: no unwaived finding over reporter_tpu_torch/ and
     chip_smoke.py, every waiver dated, the contract valid;
  2. each rule fires on a seeded violation;
  3. and passes its clean twin.
"""

from __future__ import annotations

import ast
import os
import re

import pytest

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, fresh_link_sampler)
from reporter_tpu_torch.analysis import concurrency_contract as contract
from reporter_tpu_torch.analysis import global_state, lint_rules
from reporter_tpu_torch.analysis.lint_rules import lint_source, run_lint

_REPO: "list | None" = None


def _repo_findings():
    global _REPO
    if _REPO is None:
        _REPO = run_lint()
    return _REPO


def _rules_of(findings):
    return {f.rule for f in findings if not f.waived}


# ---------------------------------------------------------------------------
# 1. the repo gate

def test_lint_has_no_unwaived_finding():
    unwaived = [f for f in _repo_findings() if not f.waived]
    assert not unwaived, "\n".join(map(str, unwaived))


def test_lint_waivers_are_dated():
    dated = re.compile(r"20\d\d-\d\d-\d\d")
    for f in _repo_findings():
        if f.waived:
            assert dated.search(f.justification), f


def test_lint_targets_are_the_port_and_its_script():
    rels = {p.replace(lint_rules.REPO_ROOT, "").lstrip("/")
            for p in lint_rules.iter_targets()}
    assert "chip_smoke.py" in rels
    assert "reporter_tpu_torch/analysis/lint_rules.py" in rels
    assert not any(r.startswith("reporter_tpu/") for r in rels)


def test_the_contract_validates():
    contract.validate()


def test_the_absent_rules_are_listed_not_faked():
    assert set(lint_rules.ABSENT_RULES) == {"jit-shape-len"}
    assert not set(lint_rules.ABSENT_RULES) & (
        set(lint_rules.RULES) | set(lint_rules.CROSS_RULES))


# ---------------------------------------------------------------------------
# env-flag

@pytest.mark.parametrize("bad", [
    "import os\nif os.environ.get(\"RTPU_SYNTH_FLAG\"):\n    x = 1\n",
    "import os\non = os.environ.get(\"REPORTER_SYNTH\", \"\") == \"1\"\n",
    "def f(e):\n    raw = e[\"RTPU_SYNTH\"].strip().lower()\n"
    "    if raw in (\"1\", \"true\"):\n        return True\n"])
def test_env_flag_catches_adhoc_parses(bad):
    assert "env-flag" in _rules_of(lint_source(bad))


@pytest.mark.parametrize("good", [
    "import os\nfrom reporter_tpu_torch.utils.tracing import env_flag\n"
    "on = env_flag(os.environ.get(\"RTPU_SYNTH_FLAG\"))\n",
    "def f(env):\n    n = None\n"
    "    if n is None and env.get(\"RTPU_SYNTH_N\"):\n"
    "        n = int(env[\"RTPU_SYNTH_N\"])\n    return n\n"])
def test_env_flag_passes_the_one_parser_and_presence_gates(good):
    assert "env-flag" not in _rules_of(lint_source(good))


# ---------------------------------------------------------------------------
# lock-blocking

@pytest.mark.parametrize("bad", [
    "import time\ndef f(self):\n    with self._lock:\n        time.sleep(1)\n",
    "def f(self, t):\n    with self._lock:\n        return t.cpu()\n",
    "def f(self, t):\n    with self._stats_lock:\n        return t.item()\n",
    "import torch\ndef f(self):\n    with self._lock:\n"
    "        torch.cuda.synchronize()\n",
    "def f(self):\n    with self._stats_lock:\n        self._other_cv.wait()\n",
    "def f(self):\n    with self._lock:\n"
    "        self._other_cv.wait_for(lambda: True)\n"])
def test_lock_blocking_catches_each_call(bad):
    assert "lock-blocking" in _rules_of(lint_source(bad))


@pytest.mark.parametrize("good", [
    "def f(self):\n    with self._cv:\n        self._cv.wait()\n",
    "def f(self, t):\n    with self._lock:\n        x = t + 1\n"
    "    return x.cpu()\n"])
def test_lock_blocking_passes_clean_bodies(good):
    assert "lock-blocking" not in _rules_of(lint_source(good))


def test_a_waiver_needs_a_reason():
    bad = ("import time\ndef f(self):\n    with self._lock:\n"
           "        # lint: allow[lock-blocking]\n        time.sleep(1)\n")
    assert any(f.rule == "lock-blocking" and not f.waived
               for f in lint_source(bad))
    ok = bad.replace("allow[lock-blocking]",
                     "allow[lock-blocking] 2026-10-17 synthetic reason")
    assert "lock-blocking" not in _rules_of(lint_source(ok))


# ---------------------------------------------------------------------------
# wire-fork

def test_wire_fork_catches_a_wire_body_outside_match_py():
    bad = "def wire_from_q8_fast(d, o, lens, tables):\n    return tables\n"
    assert "wire-fork" in _rules_of(lint_source(
        bad, path="reporter_tpu_torch/parallel/rogue.py"))


def test_wire_fork_passes_match_py():
    good = "def wire_from_f32(points, lengths, tables):\n    return tables\n"
    assert "wire-fork" not in _rules_of(lint_source(
        good, path="reporter_tpu_torch/ops/match.py"))


# ---------------------------------------------------------------------------
# staged-layout

def test_staged_layout_catches_a_partial_member_set():
    bad = "out = {}\nout[\"seg_pack\"] = 1\nout[\"seg_sweep\"] = 2\n"
    found = [f for f in lint_source(bad) if f.rule == "staged-layout"]
    assert found and "seg_coarse" in found[0].message
    assert "layout v3" in found[0].message


def test_staged_layout_passes_the_whole_set():
    from reporter_tpu_torch.tiles.tileset import _DENSE_LAYOUT_KEYS

    assert {"seg_sweep", "seg_coarse"} <= set(_DENSE_LAYOUT_KEYS)
    good = "\n".join(f"out[\"{k}\"] = 1" for k in _DENSE_LAYOUT_KEYS)
    assert "staged-layout" not in _rules_of(lint_source(good))


# ---------------------------------------------------------------------------
# dead-import, dead-private

def test_dead_import_is_caught_and_a_live_one_is_not():
    found = lint_source("import os\nimport sys\n\nprint(os.getpid())\n")
    dead = [f.message for f in found if f.rule == "dead-import"]
    assert len(dead) == 1 and "'sys'" in dead[0]


def test_dead_private_is_caught():
    bad = ("_DEAD_CONST = 7\n\ndef _dead_fn(x):\n    return x\n\n"
           "_LIVE = 1\nprint(_LIVE)\n")
    dead = {f.message.split("'")[1] for f in lint_source(bad)
            if f.rule == "dead-private"}
    assert dead == {"_DEAD_CONST", "_dead_fn"}


@pytest.mark.parametrize("good", [
    "_K = 3\nPUBLIC = 9\n__dunder__ = 1\n\ndef use():\n    return _K\n",
    "_HOOK = 1\nx = globals()[\"_HOOK\"]\n",
    "# lint: allow[dead-private] 2026-10-17 synthetic keep\n_KEPT = 1\n"])
def test_dead_private_passes_live_and_waived(good):
    assert "dead-private" not in _rules_of(lint_source(good))


# ---------------------------------------------------------------------------
# env-table and metric-inventory (README blocks)

def _module(source: str):
    return lint_rules._Module("synthetic.py", source, ast.parse(source),
                              source.splitlines())


_ENV = ("<!-- torch-env-table:begin -->\n{rows}\n"
        "<!-- torch-env-table:end -->\n")
_INV = ("<!-- torch-metric-inventory:begin -->\n{rows}\n"
        "<!-- torch-metric-inventory:end -->\n")


def test_env_table_catches_both_directions(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text(_ENV.format(rows="- `RTPU_DEAD_ROW`"))
    src = "import os\nx = os.environ.get(\"RTPU_SYNTH_UNDOC\")\n"
    msgs = [f.message for f in lint_rules._rule_env_table(
        [_module(src)], str(readme))]
    assert any("RTPU_SYNTH_UNDOC" in m and "no row" in m for m in msgs)
    assert any("RTPU_DEAD_ROW" in m and "dead row" in m for m in msgs)


def test_env_table_passes_a_documented_read(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text(_ENV.format(rows="- `RTPU_SYNTH_DOC`: a knob"))
    src = "import os\nx = os.environ.get(\"RTPU_SYNTH_DOC\")\n"
    assert lint_rules._rule_env_table([_module(src)], str(readme)) == []


def test_env_table_rows_outside_the_block_do_not_count(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text("| `RTPU_SYNTH_DOC` | the JAX table |\n"
                      + _ENV.format(rows=""))
    src = "import os\nx = os.environ.get(\"RTPU_SYNTH_DOC\")\n"
    assert lint_rules._rule_env_table([_module(src)], str(readme))
    readme.write_text("no block\n")
    assert lint_rules._rule_env_table([_module(src)], str(readme))


def test_metric_inventory_catches_both_directions(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text(_INV.format(rows="- `probes`"))
    src = "def f(self):\n    self.metrics.count(\"synthetic_undoc\")\n"
    msgs = [f.message for f in lint_rules._rule_metric_inventory(
        [_module(src)], str(readme))]
    assert any("synthetic_undoc" in m for m in msgs)
    assert any("'probes'" in m and "dead row" in m for m in msgs)


def test_metric_inventory_passes_documented_registrations(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text(_INV.format(
        rows="- `syn_a`, `syn_b`, `syn_c`, `syn_d_seconds`"))
    src = ("from reporter_tpu_torch.utils.metrics import labeled\n"
           "def f(self, m, reg):\n    m.count(\"syn_a\")\n"
           "    reg.gauge(labeled(\"syn_b\", metro=\"sf\"), 1)\n"
           "    self.metrics.observe(\"syn_c\", 0.1)\n"
           "    with self.metrics.stage(\"syn_d\"):\n        pass\n")
    assert lint_rules._rule_metric_inventory([_module(src)],
                                             str(readme)) == []


@pytest.mark.parametrize("rule", ["env-table", "metric-inventory"])
def test_the_readme_blocks_are_clean(rule):
    bad = [f for f in _repo_findings() if f.rule == rule and not f.waived]
    assert not bad, "\n".join(map(str, bad))


# ---------------------------------------------------------------------------
# bench-coverage: chip_smoke.py's printed fields against bench_delta.py

def _coverage(tmp_path, script: str):
    from reporter_tpu_torch.analysis.bench_delta import coverage_findings

    (tmp_path / "chip_smoke.py").write_text(script)
    return coverage_findings(root=str(tmp_path))


def _forward(found):
    return [f for f in found if "dead row" not in f.message]


_SMOKE = ("def phase(tag, card, **fields):\n    pass\n\n"
          "def run(card, n, m):\n")


def test_bench_coverage_catches_an_unclassified_field(tmp_path):
    found = _forward(_coverage(
        tmp_path, _SMOKE + "    phase('x', card, mystery_metric_xyz=n, "
                           "traces=4)\n"))
    assert [f.rule for f in found] == ["bench-coverage"]
    assert "'mystery_metric_xyz'" in found[0].message
    assert found[0].path == "chip_smoke.py" and found[0].line == 5


def test_bench_coverage_passes_classified_neutral_and_non_numeric(tmp_path):
    found = _forward(_coverage(tmp_path, _SMOKE + (
        "    ok = n == m\n"
        "    phase('x', card, batch_ms=n, records_per_s=m, traces=4,\n"
        "          records_equal=ok, arm=f'{n}', stage_ms={'walk': n},\n"
        "          checks={'anything': n}, flag=not n, label='sf')\n")))
    assert found == []


def test_bench_coverage_follows_a_local_dict_and_flags_an_opaque_one(
        tmp_path):
    clean = _SMOKE + ("    d = {'batch_ms': n}\n    d['traces'] = 4\n"
                      "    d.update(walk_ms=m)\n    phase('x', card, **d)\n")
    assert _forward(_coverage(tmp_path, clean)) == []
    hidden = _SMOKE + ("    d = {'batch_ms': n}\n    d['mystery_xyz'] = m\n"
                       "    phase('x', card, **d)\n")
    assert "'mystery_xyz'" in _forward(_coverage(tmp_path, hidden))[0].message
    for bad in ("    phase('x', card, **m)\n",
                "    d = {}\n    d[str(n)] = m\n    phase('x', card, **d)\n",
                "    phase('x', card, **{k: n for k in m})\n"):
        found = _forward(_coverage(tmp_path, _SMOKE + bad))
        assert len(found) == 1 and "AST cannot name" in found[0].message, bad


def test_bench_coverage_reverse_finds_a_dead_neutral_entry(tmp_path):
    from reporter_tpu_torch.analysis.bench_delta import NEUTRAL_KEYS

    assert "touches" in NEUTRAL_KEYS
    dead = {f.message.split("'")[1] for f in _coverage(
        tmp_path, _SMOKE + "    phase('x', card, clients=n)\n")
        if "dead row" in f.message}
    assert "touches" in dead and "clients" not in dead
    alive = {f.message.split("'")[1] for f in _coverage(
        tmp_path, _SMOKE + "    phase('x', card, clients=n, touches=m)\n")
        if "dead row" in f.message}
    assert "touches" not in alive


def test_bench_coverage_missing_script_is_loud(tmp_path):
    from reporter_tpu_torch.analysis.bench_delta import coverage_findings

    found = coverage_findings(root=str(tmp_path))
    assert len(found) == 1 and "failed to load" in found[0].message


def test_bench_coverage_on_the_repo_reports_every_opaque_call_waived():
    cov = [f for f in _repo_findings() if f.rule == "bench-coverage"]
    assert cov and all(f.waived for f in cov)
    assert all("AST cannot name" in f.message for f in cov)
    # the two **fields calls of [mesh:dp] and [build:exact_shape] among them
    with open(os.path.join(lint_rules.REPO_ROOT, "chip_smoke.py")) as f:
        src = f.read().splitlines()
    lines = {src[f.line - 1].strip() for f in cov}
    assert any(ln.startswith('phase("mesh:dp"') for ln in lines)
    assert any(ln.startswith('phase("build:exact_shape"') for ln in lines)


# ---------------------------------------------------------------------------
# the leak detector (the gate's engine)

def test_leak_detector_sees_a_tracer_leak_and_its_restore():
    from reporter_tpu_torch.utils import tracing

    pre = global_state.snapshot()
    tr = tracing.tracer()
    was = tr.enabled
    tr.configure(enabled=not was)
    try:
        assert any("tracer.enabled" in p for p in global_state.diff(
            pre, global_state.snapshot()))
    finally:
        tr.configure(enabled=was)
    assert global_state.diff(pre, global_state.snapshot()) == []


def test_leak_detector_sees_an_installed_fault_plan():
    from reporter_tpu_torch import faults

    pre = global_state.snapshot()
    with faults.use(faults.FaultPlan.parse("publish:fail@0", seed=1)):
        assert any("faults plan" in p for p in global_state.diff(
            pre, global_state.snapshot()))
    assert global_state.diff(pre, global_state.snapshot()) == []


def test_leak_detector_sees_an_env_mutation(monkeypatch):
    pre = global_state.snapshot()
    monkeypatch.setenv("RTPU_SYNTH_LEAK", "1")
    assert any("RTPU_SYNTH_LEAK" in p for p in global_state.diff(
        pre, global_state.snapshot()))


def test_leak_detector_sees_an_slo_evaluator_left_installed():
    from reporter_tpu_torch.obs import slo

    pre = global_state.snapshot()
    prev = slo.active()
    slo.install(object())
    try:
        assert any("SLO evaluator" in p for p in global_state.diff(
            pre, global_state.snapshot()))
    finally:
        slo.install(prev)
    assert global_state.diff(pre, global_state.snapshot()) == []


def test_leak_detector_sees_a_dead_sampler_and_a_swap(fresh_link_sampler):
    """The sampler's mood is held as well as its identity: a dispatch
    timeout noted on the process sampler leaves it dead (the leak behind
    the port's test-order failure); a swapped sampler is a leak too."""
    from reporter_tpu_torch.utils import linkhealth

    s = linkhealth.LinkHealthSampler(probe=lambda n: (0.001, 9000.0))
    linkhealth.configure(s)
    s.sample_once()
    pre = global_state.snapshot()
    assert pre["linkhealth.mood"] == "healthy"
    assert global_state.diff(pre, global_state.snapshot()) == []
    linkhealth.note_dispatch_timeout()
    assert any("mood 'healthy' -> 'dead'" in p for p in global_state.diff(
        pre, global_state.snapshot()))
    linkhealth.configure(linkhealth.LinkHealthSampler(
        probe=lambda n: (0.001, 9000.0)))
    assert any("swapped" in p for p in global_state.diff(
        pre, global_state.snapshot()))


def test_leak_detector_allows_a_first_sampler():
    pre = {**global_state.snapshot(), "linkhealth.sampler": None,
           "linkhealth.mood": None}

    class _S:
        def latest(self):
            return type("L", (), {"mood": "cpu"})()

    post = {**pre, "linkhealth.sampler": _S(), "linkhealth.mood": "cpu"}
    assert global_state.diff(pre, post) == []
    post["linkhealth.mood"] = "dead"
    assert global_state.diff(pre, post)
