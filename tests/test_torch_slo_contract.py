"""The port's SLO spec validator (reporter_tpu_torch/analysis/
slo_contract.py): the committed DEFAULT_SLOS are clean against README's
port metric inventory, and each rule fires on a seeded violation and
passes its clean twin (tests/test_slo.py holds the JAX package's)."""

import os

import pytest

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
from reporter_tpu_torch.analysis.slo_contract import main, validate_specs
from reporter_tpu_torch.obs.slo import DEFAULT_SLOS, SloSpec

_README = os.path.join(os.path.dirname(__file__), os.pardir, "README.md")
_TWIN = SloSpec("twin", "ratio", 0.999, bad=("b",), total=("t",))


def test_committed_specs_are_clean():
    assert validate_specs(DEFAULT_SLOS, _README) == []
    assert main() == 0


@pytest.mark.parametrize("spec,rule", [
    (SloSpec("s", "ratio", 1.0, bad=("b",), total=("t",)), "slo-shape"),
    (SloSpec("s", "weird", 0.99), "slo-shape"),
    (SloSpec("s", "ratio", 0.99), "slo-shape"),
    (SloSpec("s", "latency", 0.99, series="x", threshold_s=0.3),
     "slo-shape"),
    (SloSpec("s", "gauge", 0.99, gauge="g", ceiling=0.0), "slo-shape"),
    (SloSpec("s", "ratio", 0.999, bad=("b",), total=("t",),
             windows=((720.0, 60.0, 6.0),)), "slo-windows"),
    (SloSpec("s", "ratio", 0.999, bad=("b",), total=("t",),
             windows=((60.0, 60.0, 6.0),)), "slo-windows"),
    (SloSpec("s", "ratio", 0.999, bad=("b",), total=("t",),
             windows=()), "slo-windows"),
    (SloSpec("s", "ratio", 0.999, bad=("b",), total=("t",),
             windows=((60.0, 720.0, 0.5),)), "slo-burn"),
    (SloSpec("s", "ratio", 0.999, bad=("b",), total=("t",),
             windows=((60.0, 720.0, 5000.0),)), "slo-burn"),
])
def test_seeded_violation_and_clean_twin(spec, rule):
    assert any(f.rule == rule for f in validate_specs([spec]))
    assert validate_specs([_TWIN]) == []


def test_duplicate_names_are_caught():
    dup = [SloSpec("same", "ratio", 0.999, bad=("b",), total=("t",)),
           SloSpec("same", "gauge", 0.99, gauge="g", ceiling=1.0)]
    assert any(f.rule == "slo-shape" and "duplicate" in f.message
               for f in validate_specs(dup))


def test_metrics_are_read_from_the_port_block(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text("<!-- torch-metric-inventory:begin -->\n"
                      "- `http_requests`\n"
                      "<!-- torch-metric-inventory:end -->\n")
    spec = SloSpec("s", "ratio", 0.999, bad=("nonexistent_series",),
                   total=("http_requests",))
    assert any(f.rule == "slo-metric" and "nonexistent_series" in f.message
               for f in validate_specs([spec], str(readme)))
    ok = SloSpec("s", "ratio", 0.999, bad=("http_requests_count",),
                 total=("http_requests",))
    assert validate_specs([ok], str(readme)) == []
    # the JAX package's block is not the port's: no vacuous pass
    readme.write_text("<!-- metric-inventory:begin -->\n"
                      "| `http_requests` |\n<!-- metric-inventory:end -->\n")
    assert any(f.rule == "slo-metric"
               for f in validate_specs([ok], str(readme)))
