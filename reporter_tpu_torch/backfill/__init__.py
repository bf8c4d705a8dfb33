"""Open-loop batch backfill: a durable spool replayed into device-resident
per-segment aggregates (engine.py, aggregate.py)."""

from reporter_tpu_torch.backfill.aggregate import (AggregateStore,
                                                   SpeedTodHistogram,
                                                   TurnCounts,
                                                   harvest_aggregates)
from reporter_tpu_torch.backfill.engine import BackfillConfig, BackfillEngine

__all__ = ["AggregateStore", "BackfillConfig", "BackfillEngine",
           "SpeedTodHistogram", "TurnCounts", "harvest_aggregates"]
