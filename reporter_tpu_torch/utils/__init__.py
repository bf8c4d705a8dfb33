"""Host-side utilities of the serving front-end: locks, metrics, span
tracing and the read-ahead worker."""

from reporter_tpu_torch.utils.metrics import MetricsRegistry, StageTimer

__all__ = ["MetricsRegistry", "StageTimer"]
