"""Matcher and tile-compiler parameters.

Counterpart: reporter_tpu/config.py (MatcherParams, CompilerParams). Only
the fields this port reads are kept; their names and defaults are the
JAX package's, so one parameter set means the same thing in both.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any

def env_flag(value: "str | None", strict: bool = False) -> bool:
    """The boolean parse of the RTPU_* switches (the JAX package's
    utils/tracing.env_flag). Unset, blank and 0/false/off/no are False.
    ``strict=True`` raises ValueError on a token outside the recognized
    true/false sets instead of reading it as True: a mistyped kernel
    lever must fail loudly, or an A/B run measures an arm against itself."""
    if not value:
        return False
    tok = value.strip().lower()
    if strict and tok not in ("", "0", "false", "off", "no",
                              "1", "true", "on", "yes"):
        raise ValueError(f"unrecognized boolean env value {value!r}; "
                         "use 0/1 (or true/false, on/off, yes/no)")
    return tok not in ("", "0", "false", "off", "no")


def _env_bool(e, name: str) -> bool:
    try:
        return env_flag(e[name], strict=True)
    except ValueError:
        raise ValueError(f"{name}={e[name]!r}: use 0/1") from None


@dataclass(frozen=True)
class MatcherParams:
    """HMM map-matching parameters (Meili's documented defaults)."""

    sigma_z: float = 4.07          # GPS noise std-dev (m), emission model
    beta: float = 3.0              # transition scale (m)
    search_radius: float = 50.0    # candidate search radius (m)
    max_candidates: int = 8        # top-K candidates per point
    sweep_subcull: bool = True     # dense sweep: per-slice bbox culling
    #                                inside each segment block (the
    #                                two-level kernel arms); False = the
    #                                whole-block arm. Same results either way.
    sweep_lowp: str = "off"        # "bf16": a bf16 coarse point-to-segment
    #                                filter gates the exact pass per slice
    #                                (CUDA cores); with sweep_mxu it picks
    #                                the tensor-core operand type instead
    #                                (bf16; "off" = tf32). Same results.
    sweep_mxu: bool = False        # dense sweep: tensor-core coarse pass
    #                                (point-to-line d² from the pack's feat
    #                                rows, mma.sync) gates the exact pass
    #                                per slice. Needs sweep_subcull. Same
    #                                results.
    sweep_autotune: bool = True    # SegmentMatcher construction on the card
    #                                times every legal sweep arm on the
    #                                metro's own tables and serves the
    #                                fastest (matcher/autotune.py), unless a
    #                                sweep lever above is set away from its
    #                                default. False = the levers as given.
    breakage_distance: float = 2000.0  # farther consecutive points break the chain
    max_route_distance_factor: float = 5.0  # route > factor*gc ⇒ disallowed
    interpolation_distance: float = 10.0    # closer points are interpolated
    backward_slack: float = 10.0   # same-edge backward jitter counted as zero (m)
    max_device_batch: int = 4096   # traces per device dispatch

    def replace(self, **kw: Any) -> "MatcherParams":
        return dataclasses.replace(self, **kw)

    def with_env_overrides(self, env: "dict[str, str] | None" = None,
                           ) -> "MatcherParams":
        """The sweep levers from the environment; only set variables apply.
        RTPU_SWEEP_SUBCULL=0|1, RTPU_SWEEP_LOWP=off|bf16, RTPU_SWEEP_MXU=0|1,
        RTPU_SWEEP_AUTOTUNE=0|1. A bad value or an illegal combination
        raises ValueError, as the JAX package's does; so does a sweep_lowp
        outside off/bf16 given as a field (its Config.validate checks).
        RTPU_NJ_CAP, the JAX sweep's launch-width rung, raises too: the
        CUDA kernel walks each chunk's compacted hit list and has no such
        rung, so the setting would change nothing."""
        e = os.environ if env is None else env
        kw: dict[str, Any] = {}
        if "RTPU_SWEEP_SUBCULL" in e:
            kw["sweep_subcull"] = _env_bool(e, "RTPU_SWEEP_SUBCULL")
        if "RTPU_SWEEP_LOWP" in e:
            lowp = e["RTPU_SWEEP_LOWP"] or "off"
            if lowp not in ("off", "bf16"):
                raise ValueError(
                    f"RTPU_SWEEP_LOWP={lowp!r}: use 'off' or 'bf16'")
            kw["sweep_lowp"] = lowp
        if "RTPU_SWEEP_MXU" in e:
            kw["sweep_mxu"] = _env_bool(e, "RTPU_SWEEP_MXU")
        if "RTPU_NJ_CAP" in e:
            raise ValueError(
                f"RTPU_NJ_CAP={e['RTPU_NJ_CAP']!r}: the CUDA sweep has no "
                "launch-width rung (it walks each chunk's compacted hit "
                "list); unset it")
        if "RTPU_SWEEP_AUTOTUNE" in e:
            kw["sweep_autotune"] = _env_bool(e, "RTPU_SWEEP_AUTOTUNE")
        out = dataclasses.replace(self, **kw) if kw else self
        if out.sweep_lowp not in ("off", "bf16"):
            raise ValueError(f"unknown sweep_lowp {out.sweep_lowp!r}; "
                             "use 'off' or 'bf16'")
        if out.sweep_lowp == "bf16" and not out.sweep_subcull:
            raise ValueError(
                "sweep_lowp='bf16' requires sweep_subcull=True — the "
                "whole-block kernel has no low-precision pass")
        if out.sweep_mxu and not out.sweep_subcull:
            raise ValueError(
                "sweep_mxu=True requires sweep_subcull=True — the "
                "whole-block kernel has no matmul coarse pass")
        return out


@dataclass(frozen=True)
class CompilerParams:
    """Offline tile-compiler parameters (the dense layout needs no grid)."""

    reach_radius: float = 600.0    # reachability precompute radius (m)
    reach_max: int = 128           # max reachable targets kept per node row
    osmlr_max_length: float = 1000.0  # OSMLR chaining target length (m)
