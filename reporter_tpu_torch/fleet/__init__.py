"""Many metros on one card (counterpart: reporter_tpu/fleet/).

  residency.py   FleetResidency: the registry of metros, the ledger of
                 staged bytes, the pinned cold tier, LRU paging with a
                 watermark and pins, counted and traced promotions
  router.py      FleetRouter: the metro router over the paged fleet,
                 per-metro SLOs, every dispatch under a lease
"""

from reporter_tpu_torch.fleet.residency import (FleetCapacityError,
                                                FleetConfig, FleetResidency)
from reporter_tpu_torch.fleet.router import (FleetRouter, MetroSLO,
                                             make_fleet_router)

__all__ = [
    "FleetCapacityError",
    "FleetConfig",
    "FleetResidency",
    "FleetRouter",
    "MetroSLO",
    "make_fleet_router",
]
