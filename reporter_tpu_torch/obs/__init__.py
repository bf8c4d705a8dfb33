"""The SLO plane: declarative error-budget objectives and multi-window
burn-rate alerting over the metrics registry (see obs/slo.py).

Counterpart: reporter_tpu/obs/__init__.py, with the same exports."""

from reporter_tpu_torch.obs.slo import (DEFAULT_SLOS, SloEvaluator, SloSpec,
                                        active, enabled, install,
                                        window_scale)

__all__ = ["DEFAULT_SLOS", "SloEvaluator", "SloSpec", "active",
           "enabled", "install", "window_scale"]
