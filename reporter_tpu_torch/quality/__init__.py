"""Online match-quality telemetry: per-batch signals (signals.py) and the
per-metro window with its drift sentinel (monitor.py). The JAX package's
sampled shadow-oracle audit (quality/audit.py) waits for the
reference_cpu oracle (ROADMAP queue 1 item 1c)."""

from reporter_tpu_torch.quality.monitor import QualityMonitor
from reporter_tpu_torch.quality.signals import QualitySignals, extract

__all__ = ["QualitySignals", "extract", "QualityMonitor"]
