"""``python -m reporter_tpu_torch.analysis --slo``: the static validator
of the port's committed SLO specs.

Counterpart: reporter_tpu/analysis/slo_contract.py, over the port's
``obs/slo.DEFAULT_SLOS``. The burn-rate engine trusts its specs: a window
pair ordered backwards alerts on noise, a burn threshold above the
maximum can never fire, a latency threshold off the
``HISTOGRAM_BUCKETS`` grid measures the wrong objective, and a metric
nothing registers burns zero forever. All four are spec bugs, rejected
here. Rules (each seeded with a violation and a clean twin in
tests/test_torch_slo_contract.py):

  slo-shape    objective strictly in (0, 1); kind one of ratio / latency /
               gauge with that kind's fields (ratio: bad and total
               counters; latency: series and ``threshold_s`` on the
               HISTOGRAM_BUCKETS grid; gauge: a series and ceiling > 0);
               spec names unique.
  slo-windows  every (fast, slow, threshold) pair has fast < slow
               STRICTLY and positive durations; at least one pair.
  slo-burn     1 < threshold <= 1/(1 - objective).
  slo-metric   every registry series a spec reads is in README's port
               metric inventory block (``<!-- torch-metric-inventory
               -->``; ``_count`` / ``_sum`` / ``_total`` resolve to their
               base series).
"""

from __future__ import annotations

import os

from reporter_tpu_torch.analysis.lint_rules import Finding, inventory_tokens
from reporter_tpu_torch.utils.metrics import HISTOGRAM_BUCKETS

_SPEC_PATH = "reporter_tpu_torch/obs/slo.py"
_KINDS = ("ratio", "latency", "gauge")
# suffixes the exposition derives from a base series (_with_suffix /
# histogram exports): a spec may reference the derived name, the
# inventory documents the base
_DERIVED_SUFFIXES = ("_count", "_sum", "_total")


def _shape_findings(spec) -> "list[str]":
    msgs: "list[str]" = []
    if not (0.0 < spec.objective < 1.0):
        msgs.append(f"objective {spec.objective!r} must lie strictly in "
                    "(0, 1): 1.0 has zero error budget (every burn "
                    "divides by it) and 0 objectives nothing")
    if spec.kind not in _KINDS:
        msgs.append(f"unknown kind {spec.kind!r} (one of {_KINDS})")
        return msgs
    if spec.kind == "ratio" and not (spec.bad and spec.total):
        msgs.append("ratio spec needs non-empty bad= and total= counter "
                    "name tuples")
    if spec.kind == "latency":
        if not spec.series:
            msgs.append("latency spec needs series= (an observation "
                        "series name)")
        if spec.threshold_s not in HISTOGRAM_BUCKETS:
            msgs.append(
                f"threshold_s {spec.threshold_s!r} is not on the "
                "HISTOGRAM_BUCKETS grid: off-grid thresholds silently "
                "measure the nearest bucket's objective instead "
                f"(grid: {HISTOGRAM_BUCKETS})")
    if spec.kind == "gauge":
        if not spec.gauge:
            msgs.append("gauge spec needs gauge= (a gauge series name)")
        if spec.ceiling <= 0:
            msgs.append(f"gauge ceiling {spec.ceiling!r} must be > 0")
    return msgs


def _window_findings(spec) -> "list[str]":
    msgs: "list[str]" = []
    if not spec.windows:
        msgs.append("spec has no window pairs: it can never alert")
    for fast, slow, _thr in spec.windows:
        if fast <= 0 or slow <= 0:
            msgs.append(f"window pair ({fast}, {slow}) has a "
                        "non-positive duration")
        elif not fast < slow:
            msgs.append(
                f"window pair ({fast}, {slow}) must have fast < slow "
                "STRICTLY: the slow window is the sustained-burn "
                "confirmation; equal or inverted windows collapse the "
                "multi-window guard to a single noisy window")
    return msgs


def _burn_findings(spec) -> "list[str]":
    msgs: "list[str]" = []
    budget = spec.budget()
    if budget <= 0:
        return msgs  # already a slo-shape finding
    max_burn = 1.0 / budget
    for fast, slow, thr in spec.windows:
        if thr <= 1.0:
            msgs.append(
                f"pair ({fast}, {slow}) burn threshold {thr} <= 1 "
                "alerts while still INSIDE budget: thresholds are "
                "multiples of exactly-on-budget burn")
        elif thr > max_burn:
            msgs.append(
                f"pair ({fast}, {slow}) burn threshold {thr} exceeds "
                f"the maximum possible burn 1/(1-objective) = "
                f"{max_burn:g} (all-bad traffic): it can never fire")
    return msgs


def _documented(name: str, tokens: "dict[str, int]") -> bool:
    if name in tokens:
        return True
    for suf in _DERIVED_SUFFIXES:
        if name.endswith(suf) and name[:-len(suf)] in tokens:
            return True
    return False


def validate_specs(specs, readme_path: "str | None" = None,
                   ) -> "list[Finding]":
    """All findings for ``specs``; ``readme_path=None`` skips the
    inventory cross-check (pure-shape validation for unit tests)."""
    out: "list[Finding]" = []
    seen: "dict[str, int]" = {}
    for spec in specs:
        if spec.name in seen:
            out.append(Finding(
                "slo-shape", _SPEC_PATH, 1,
                f"duplicate spec name {spec.name!r}: gauge sampling "
                "and per-spec gauges key on the name; duplicates alias"))
        seen.setdefault(spec.name, 1)
        for rule, fn in (("slo-shape", _shape_findings),
                         ("slo-windows", _window_findings),
                         ("slo-burn", _burn_findings)):
            for msg in fn(spec):
                out.append(Finding(rule, _SPEC_PATH, 1,
                                   f"spec {spec.name!r}: {msg}"))
    if readme_path is not None:
        try:
            with open(readme_path) as f:
                readme = f.readlines()
        except OSError:
            readme = []
        tokens, found = inventory_tokens(readme)
        if not found:
            out.append(Finding(
                "slo-metric", "README.md", 1,
                "no torch-metric-inventory block in README: the SLO "
                "metric cross-check has nothing to check against"))
        else:
            for spec in specs:
                for name in spec.metric_names():
                    if not _documented(name, tokens):
                        out.append(Finding(
                            "slo-metric", _SPEC_PATH, 1,
                            f"spec {spec.name!r} reads metric {name!r} "
                            "but README's metric inventory has no such "
                            "row: an SLO over a series nothing "
                            "registers burns zero forever"))
    return out


def main() -> int:
    from reporter_tpu_torch.obs.slo import DEFAULT_SLOS

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    findings = validate_specs(DEFAULT_SLOS,
                              os.path.join(root, "README.md"))
    for f in findings:
        print(f)
    print(f"slo contract: {len(DEFAULT_SLOS)} spec(s), "
          f"{len(findings)} finding(s)")
    return 1 if findings else 0
