"""Online match-quality telemetry: per-batch signals (signals.py), the
per-metro window with its drift sentinel (monitor.py) and the sampled
shadow-oracle audit against the reference_cpu oracle (audit.py)."""

from reporter_tpu_torch.quality.audit import ShadowAuditor
from reporter_tpu_torch.quality.monitor import QualityMonitor
from reporter_tpu_torch.quality.signals import QualitySignals, extract

__all__ = ["QualitySignals", "extract", "QualityMonitor", "ShadowAuditor"]
