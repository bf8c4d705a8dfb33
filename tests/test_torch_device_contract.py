"""The port's device contract (reporter_tpu_torch/analysis/
device_contract.py): every rule fires on a seeded violation and passes
its clean twin, and the whole CPU matrix (3 wire entries x 5 arms x 3
layouts x {single, mesh}, the scatters and the staging cases) has no
unwaived finding. On
the card the same audit runs under sync-debug "error" (the gpu case in
tests/test_torch_kernels_gpu.py, chip_smoke.py's [analysis:device])."""

import pytest
import torch

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.analysis import device_contract as dcon
from reporter_tpu_torch.analysis.lint_rules import Finding

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_CPU = torch.device("cpu")
_SITE = ("tests/synthetic.py", 1)

_FINDINGS: "list | None" = None
_STATS: dict = {}


def _matrix():
    global _FINDINGS
    if _FINDINGS is None:
        _FINDINGS = dcon.run_device_contract("cpu", stats=_STATS)
    return _FINDINGS


def _rules(found):
    return {f.rule for f in found if not f.waived}


# ---------------------------------------------------------------------------
# the repo gate

def test_the_cpu_matrix_has_no_unwaived_finding():
    unwaived = [f for f in _matrix() if not f.waived]
    assert not unwaived, "\n".join(map(str, unwaived))


def test_the_matrix_is_whole():
    cases = dcon.audit_cases()
    assert len(cases) == 3 * 5 * 3 * 2
    labels = {c.label for c in cases}
    assert {"f32/block/compact/single", "q8/mxu_bf16/packed/mesh",
            "q16/sub_bf16/full/mesh"} <= labels
    _matrix()
    # and the three scatters, the five staging cases, the ranked-path
    # lattice and a grid batch
    assert _STATS["cases"] == len(cases) + 3 + 5 + 2
    assert _STATS["aten_ops"] > 0


def test_cpu_waivers_are_dated_and_cpu_only():
    import re

    for key, why in dcon.CPU_WAIVERS.items():
        assert re.search(r"20\d\d-\d\d-\d\d", why), key
    waived = [f for f in _matrix() if f.waived]
    assert waived and all(f.rule == "device-f64" and
                          f.path.endswith("dense_candidates.py")
                          for f in waived)


def test_a_cpu_waiver_names_a_function_not_a_file():
    f64_site = next(f for f in _matrix() if f.rule == "device-f64")
    other = Finding("device-f64", f64_site.path, 1, "synthetic")
    dcon._apply_cpu_waivers([other])
    assert not other.waived          # line 1 is in no waived function


def test_the_absent_rule_is_listed():
    assert set(dcon.ABSENT_RULES) == {"device-nested-jit"}


# ---------------------------------------------------------------------------
# seeded violations and clean twins

def test_float64_is_caught():
    x = torch.ones(8)
    _, found, _ = dcon.audit(lambda: (x.double() * 2).float(), "seed",
                             _CPU, _SITE)
    assert "device-f64" in _rules(found)


def test_float32_and_int64_are_clean():
    x = torch.ones(8)
    _, found, ops = dcon.audit(
        lambda: (x * 2, torch.arange(8, dtype=torch.int64) << 3), "twin",
        _CPU, _SITE)
    assert found == [] and ops >= 2


@pytest.mark.parametrize("bad", [
    lambda x: x.sum().item(),
    lambda x: int(x.sum()),
    lambda x: x.nonzero(),
    lambda x: x[x > 0],
    lambda x: torch.masked_select(x, x > 0),
    lambda x: torch.repeat_interleave(x.long()),
    lambda x: torch.unique(x)])
def test_a_host_sync_is_caught(bad):
    x = torch.arange(8, dtype=torch.float32)
    _, found, _ = dcon.audit(lambda: bad(x), "seed", _CPU, _SITE)
    assert "device-sync" in _rules(found)


@pytest.mark.parametrize("good", [
    lambda x: x.sum(),
    lambda x: torch.where(x > 0, x, 0.0),
    lambda x: x[torch.arange(4)],
    lambda x: torch.repeat_interleave(x.long().clamp(0, 2), output_size=13),
    lambda x: torch.full((), 0.25, dtype=torch.float32) * x])
def test_device_side_equivalents_are_clean(good):
    x = torch.arange(8, dtype=torch.float32)
    _, found, _ = dcon.audit(lambda: good(x), "twin", _CPU, _SITE)
    assert found == []


def test_a_raise_is_a_trace_finding():
    def boom():
        raise RuntimeError("synthetic failure")

    out, found, _ = dcon.audit(boom, "seed", _CPU, _SITE)
    assert out is None and [f.rule for f in found] == ["device-trace"]
    assert "synthetic failure" in found[0].message


@pytest.mark.parametrize("layout,wire", [
    ("compact", torch.zeros((2, 2, 16), dtype=torch.uint16)),
    ("full", torch.zeros((2, 3, 16), dtype=torch.uint16)),
    ("packed", torch.zeros((2, 1, 16), dtype=torch.uint32))])
def test_the_pinned_wire_passes(layout, wire):
    assert dcon.check_wire(wire, layout, "twin", _SITE) == []


@pytest.mark.parametrize("layout,wire", [
    ("compact", torch.zeros((2, 2, 16), dtype=torch.int32)),
    ("compact", torch.zeros((2, 3, 16), dtype=torch.uint16)),
    ("full", torch.zeros((2, 2, 16), dtype=torch.uint16)),
    ("packed", torch.zeros((2, 1, 16), dtype=torch.int64)),
    ("packed", (torch.zeros((2, 1, 16), dtype=torch.uint32),) * 2)])
def test_a_wrong_wire_is_caught(layout, wire):
    found = dcon.check_wire(wire, layout, "seed", _SITE)
    assert [f.rule for f in found] == ["device-wire-dtype"]


def test_a_float64_in_a_wire_entry_is_attributed_to_its_line():
    """A seeded widening inside the port's code is named at the port's
    line (the waiver grammar's anchor)."""
    from reporter_tpu_torch.ops import match

    _, found, _ = dcon.audit(
        lambda: match._valid(torch.full((2,), 3, dtype=torch.float64), 4),
        "seed", _CPU, _SITE)
    assert any(f.rule == "device-f64" and f.path.endswith("ops/match.py")
               for f in found)


# ---------------------------------------------------------------------------
# the gate's device: the card unless the caller asks for the CPU

_NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                              reason="holds the refusal on a host without "
                                     "a card")


@_NO_CARD
@pytest.mark.parametrize("call", ["run_device_contract", "main",
                                  "compute_manifest", "check"])
def test_the_gate_defaults_to_the_card_and_raises_without_one(call):
    from reporter_tpu_torch.analysis import compile_manifest as cm

    fn = getattr(dcon if call in dcon.__all__ else cm, call)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


@_NO_CARD
def test_the_cli_device_gate_defaults_to_the_card(monkeypatch):
    import runpy
    import sys

    monkeypatch.setattr(sys, "argv", ["analysis", "--device"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_module("reporter_tpu_torch.analysis", run_name="__main__")


def test_the_json_gate_prints_the_audit_and_the_manifest(monkeypatch,
                                                         capsys):
    """``--device --on cpu --json``: two JSON lines, exit 0 on the clean
    matrix; an unwaived finding makes it exit 1 with the finding in the
    audit's line. The matrix is the one this module ran once."""
    import json

    found = list(_matrix())

    def cached(device, stats=None):
        stats.update(_STATS)
        return found

    monkeypatch.setattr(dcon, "run_device_contract", cached)
    assert dcon.main("cpu", as_json=True) == 0
    dev, man = map(json.loads, capsys.readouterr().out.splitlines())
    assert dev["gate"] == "device" and dev["device"] == "cpu"
    assert dev["cases"] == _STATS["cases"] and dev["unwaived"] == []
    assert man["gate"] == "manifest" and man["problems"] == []
    assert man["manifest"]["sweep_ks"] and "ptxas" not in man["manifest"]
    found.append(Finding("device-f64", *_SITE, "seeded"))
    assert dcon.main("cpu", as_json=True) == 1
    dev, _ = map(json.loads, capsys.readouterr().out.splitlines())
    assert len(dev["unwaived"]) == 1 and "seeded" in dev["unwaived"][0]
