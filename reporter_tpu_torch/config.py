"""Matcher and tile-compiler parameters.

Counterpart: reporter_tpu/config.py (MatcherParams, CompilerParams). Only
the fields this port reads are kept; their names and defaults are the
JAX package's, so one parameter set means the same thing in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class MatcherParams:
    """HMM map-matching parameters (Meili's documented defaults)."""

    sigma_z: float = 4.07          # GPS noise std-dev (m), emission model
    beta: float = 3.0              # transition scale (m)
    search_radius: float = 50.0    # candidate search radius (m)
    max_candidates: int = 8        # top-K candidates per point
    sweep_subcull: bool = True     # dense sweep: per-slice bbox culling
    #                                inside each segment block (the
    #                                two-level kernel arm); False = the
    #                                whole-block arm. Same results either way.
    breakage_distance: float = 2000.0  # farther consecutive points break the chain
    max_route_distance_factor: float = 5.0  # route > factor*gc ⇒ disallowed
    interpolation_distance: float = 10.0    # closer points are interpolated
    backward_slack: float = 10.0   # same-edge backward jitter counted as zero (m)
    max_device_batch: int = 4096   # traces per device dispatch

    def replace(self, **kw: Any) -> "MatcherParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CompilerParams:
    """Offline tile-compiler parameters (the dense layout needs no grid)."""

    reach_radius: float = 600.0    # reachability precompute radius (m)
    reach_max: int = 128           # max reachable targets kept per node row
    osmlr_max_length: float = 1000.0  # OSMLR chaining target length (m)
