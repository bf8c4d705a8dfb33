"""Per-metro choice of the dense sweep's kernel arm, measured on the card.

Counterpart: reporter_tpu/matcher/autotune.py, whose names and encodings
are kept, so a plan means the same thing (and a staged plan vector
decodes the same) in both packages. Every arm returns the same
candidates, bit for bit, so the choice is a pure speed decision:
measure, pick, persist.

The plan space is every legal (arm, lowp) pair in ``CANDIDATE_ARMS``.
The JAX tuner also measures the winning arm at each launch-width rung of
its narrow-grid sweep; the CUDA kernel walks each chunk's compacted hit
list and has no such rung, so a port plan carries the constant
``PLAN_NJ_CAP`` in that slot of its label and vector.

Resolution (``resolve_plan``): explicit sweep levers always win, and a
matcher on the CPU, or on the grid candidate backend, does not tune (no
kernel arms to choose among); else the
on-disk cache keyed on tile fingerprint × device name, then a short
calibration of ``CAL_DISPATCHES`` timed dispatches per candidate.
``calibrate`` and ``resolve_plan`` take the measure callable, so the
selection logic runs under injected timings on the CPU. (The JAX
package also reads a plan staged in the device tables by its fleet
pager; the port has no fleet pager yet.)

The guard: given a ``watchdog`` (the matcher passes its dispatch
watchdog, utils/watchdog.py), each candidate's measurement runs on the
watchdog's thread, bounded by ``timeout_s`` (``CAL_TIMEOUT_S``). A
timeout, or a breaker already open, aborts the whole calibration
(``CalibrationAborted``): the static default plan serves, with source
"timeout", and is neither cached nor applied, so a hung measurement
degrades matcher construction instead of hanging it. The watchdog
cannot cancel a CUDA call: an abandoned measurement runs on, its result
discarded. The JAX tuner names a fault site "autotune" to the watchdog,
which its ``faults.SITES`` does not hold: no plan can name it (parse
rejects it in both packages), and under any active plan the JAX body
raises at the unknown site, which its calibration records as a failed
candidate. The port passes no fault site; a hang comes from the
measurement itself.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass
from typing import Callable

import numpy as np

from reporter_tpu_torch.config import MatcherParams

PLAN_VERSION = 1

# the launch-width slot of the JAX package's plans: its default rung
PLAN_NJ_CAP = 128

# encoding tables of the i32 plan vector (append, never reorder: a
# persisted plan must decode the same forever)
_ARM_NAMES = ("block", "subcull", "mxu")
_LOWP_NAMES = ("off", "bf16")
_SOURCE_NAMES = ("default", "measured", "cache", "staged", "timeout",
                 "cpu", "explicit", "off")

# every legal (arm, lowp) pair, in tie-break order: the static default
# first, so equal timings keep the default
CANDIDATE_ARMS = (
    ("subcull", "off"),
    ("subcull", "bf16"),
    ("block", "off"),
    ("mxu", "off"),
    ("mxu", "bf16"),
)

# timed dispatches per candidate (one untimed warm-up dispatch precedes
# them: on the card it builds the kernel library at first use)
CAL_DISPATCHES = 4

# the guard's bound on one candidate's measurement (s): above the first
# use's kernel build, which the watchdog cannot tell from a hang
CAL_TIMEOUT_S = 120.0

# calibration batch [B, T]: a scheduler trace rung × a matcher bucket
CAL_BATCH_SHAPE = (128, 64)


class CalibrationAborted(RuntimeError):
    """A calibration measurement was abandoned (a watchdog timeout or an
    open breaker): the whole calibration aborts and the static default
    plan serves."""


@dataclass(frozen=True)
class TunedPlan:
    """One point of the plan space. The defaults are MatcherParams' sweep
    levers, so ``TunedPlan()`` is the static default."""

    arm: str = "subcull"
    lowp: str = "off"
    source: str = "default"

    @property
    def label(self) -> str:
        """Compact form, e.g. ``mxu+bf16@128`` (the JAX package's)."""
        tail = "+bf16" if self.lowp == "bf16" else ""
        return f"{self.arm}{tail}@{PLAN_NJ_CAP}"

    def params_overrides(self) -> "dict[str, object]":
        """The ``MatcherParams.replace`` kwargs that apply this plan."""
        return {
            "sweep_subcull": self.arm != "block",
            "sweep_lowp": self.lowp,
            "sweep_mxu": self.arm == "mxu",
        }


def default_plan(source: str = "default") -> TunedPlan:
    return TunedPlan(source=source)


def plan_array(plan: TunedPlan) -> np.ndarray:
    """The plan as the i32[5] vector ``[plan_version, arm, lowp, nj_cap,
    source]``."""
    return np.asarray([PLAN_VERSION, _ARM_NAMES.index(plan.arm),
                       _LOWP_NAMES.index(plan.lowp), PLAN_NJ_CAP,
                       _SOURCE_NAMES.index(plan.source)], np.int32)


def plan_from_array(arr) -> "TunedPlan | None":
    """Decode a plan vector; None when it is not a host numpy array, is
    malformed, is of another plan version, or names a launch-width rung
    other than ``PLAN_NJ_CAP`` (a JAX plan the port cannot serve as is)."""
    if not isinstance(arr, np.ndarray) or arr.shape != (5,) \
            or arr.dtype.kind not in "iu":
        return None
    v, arm, lowp, cap, src = (int(x) for x in arr)
    if v != PLAN_VERSION:
        return None
    if not (0 <= arm < len(_ARM_NAMES) and 0 <= lowp < len(_LOWP_NAMES)
            and 0 <= src < len(_SOURCE_NAMES)):
        return None
    if cap != PLAN_NJ_CAP:
        return None
    plan = TunedPlan(arm=_ARM_NAMES[arm], lowp=_LOWP_NAMES[lowp],
                     source=_SOURCE_NAMES[src])
    if (plan.arm, plan.lowp) not in CANDIDATE_ARMS:
        return None
    return plan


def plan_json(plan: "TunedPlan | None") -> "dict | None":
    if plan is None:
        return None
    return {"arm": plan.arm, "lowp": plan.lowp, "nj_cap": PLAN_NJ_CAP,
            "source": plan.source, "label": plan.label}


_DEFAULTS = MatcherParams()


def explicit_knobs(params: MatcherParams) -> bool:
    """True when a sweep lever is set away from its default: explicit
    levers always win over the tuner. A lever set to its default reads as
    not set; pin the default arm with ``sweep_autotune=False``."""
    return (params.sweep_subcull != _DEFAULTS.sweep_subcull
            or params.sweep_lowp != _DEFAULTS.sweep_lowp
            or params.sweep_mxu != _DEFAULTS.sweep_mxu)


def calibrate(measure: Callable[[TunedPlan], "float | None"],
              ) -> "tuple[TunedPlan, dict]":
    """Pick the fastest legal plan from measured per-candidate times.

    ``measure(plan) -> seconds`` (lower is better); None or an exception
    skips that candidate, and an exception is recorded under
    ``report["errors"]`` (the matcher on the card raises on any);
    ``CalibrationAborted`` aborts the whole calibration to the static
    default with source "timeout". Ties break toward the earlier
    candidate."""
    report: dict = {"candidates": {}, "errors": {}, "measured": 0}

    def timed(plan: TunedPlan) -> "float | None":
        try:
            dt = measure(plan)
        except CalibrationAborted:
            raise
        except Exception as exc:  # noqa: BLE001 — recorded, not raised
            report["errors"][plan.label] = repr(exc)[:200]
            return None
        if dt is None:
            return None
        report["measured"] += 1
        report["candidates"][plan.label] = {
            "device_ms_per_dispatch": round(dt * 1e3, 3)}
        return dt

    best: "tuple[float, TunedPlan] | None" = None
    try:
        for arm, lowp in CANDIDATE_ARMS:
            plan = TunedPlan(arm=arm, lowp=lowp, source="measured")
            dt = timed(plan)
            if dt is not None and (best is None or dt < best[0]):
                best = (dt, plan)
    except CalibrationAborted as exc:
        report["note"] = f"calibration aborted ({exc}) — static default"
        return default_plan(source="timeout"), report
    if best is None:
        report["note"] = "every candidate failed — static default"
        return default_plan(), report
    report["winner"] = best[1].label
    return best[1], report


def tile_fingerprint(ts) -> str:
    """Content fingerprint of the geometry the plan depends on (the
    segment arrays) and of the kernel's blocking constants."""
    from reporter_tpu_torch.ops import dense_candidates as dc

    h = hashlib.sha256()
    h.update(f"{ts.name}|{ts.num_edges}|{len(ts.seg_len)}"
             f"|{dc._SBLK}|{dc._SUB}|v{PLAN_VERSION}".encode())
    for arr in (ts.seg_a, ts.seg_b):
        h.update(np.ascontiguousarray(arr, np.float32).tobytes())
    return h.hexdigest()[:24]


def device_key() -> str:
    """What makes a measured plan portable: the card's name, or cpu."""
    import torch

    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name()}"
    return "cpu"


def cache_dir() -> str:
    """RTPU_AUTOTUNE_CACHE, else a per-user cache directory."""
    if "RTPU_AUTOTUNE_CACHE" in os.environ:
        return os.environ["RTPU_AUTOTUNE_CACHE"]
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "reporter_tpu_torch", "autotune")


def _cache_path(directory: str, fingerprint: str, devkey: str) -> str:
    dev = "".join(c if c.isalnum() else "_" for c in devkey)
    return os.path.join(directory, f"{fingerprint}-{dev}.json")


def load_cached_plan(fingerprint: str, devkey: str,
                     directory: "str | None" = None) -> "TunedPlan | None":
    """A previously measured plan for this (tile, device), or None. A
    corrupt or foreign file reads as a miss, never an error."""
    path = _cache_path(directory or cache_dir(), fingerprint, devkey)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("plan_version") != PLAN_VERSION:
        return None
    p = doc.get("plan") or {}
    try:
        plan = TunedPlan(arm=p["arm"], lowp=p["lowp"], source="cache")
    except (KeyError, TypeError):
        return None
    if (plan.arm, plan.lowp) not in CANDIDATE_ARMS:
        return None
    return plan


def store_cached_plan(plan: TunedPlan, report: dict, fingerprint: str,
                      devkey: str, directory: "str | None" = None) -> None:
    """Persist a measured plan (atomic replace; a read-only cache
    directory is not an error). Each writer takes its own temp file in
    the cache directory: the workers of a topology start at once and,
    with a cold cache, each calibrates and stores; a shared temp name
    would let one write truncate another's and a torn document be
    renamed into the cache."""
    directory = directory or cache_dir()
    path = _cache_path(directory, fingerprint, devkey)
    doc = {"plan_version": PLAN_VERSION, "device": devkey,
           "fingerprint": fingerprint, "plan": plan_json(plan),
           "candidates": report.get("candidates", {}),
           "errors": report.get("errors", {})}
    try:
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                                   suffix=".tmp", dir=directory)
    except OSError:
        return
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def resolve_plan(params: MatcherParams, ts,
                 measure: Callable[[TunedPlan], "float | None"],
                 watchdog=None, timeout_s: float = CAL_TIMEOUT_S,
                 directory: "str | None" = None,
                 backend: "str | None" = None,
                 devkey: "str | None" = None,
                 ) -> "tuple[TunedPlan | None, dict]":
    """(plan to apply | None, info). None means the tuner does not act
    (off, explicit levers, a CPU or grid matcher) and the params serve as they
    are; ``info["source"]`` says why. ``watchdog`` (an
    AbandonedThreadWatchdog) bounds each candidate's measurement by
    ``timeout_s``; a timeout or an open breaker gives the default plan
    with source "timeout", not cached. ``backend`` is the matcher's
    device type ("cuda" or "cpu"; None = cuda when a card is present)."""
    import time

    if not params.sweep_autotune:
        return None, {"source": "off"}
    if explicit_knobs(params):
        return None, {"source": "explicit"}
    if backend is None:
        import torch

        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if backend == "cpu" or params.candidate_backend == "grid":
        # the JAX package's short-circuit: the grid gather has no kernel
        # arms to tune (it reports the same source)
        return None, {"source": "cpu"}

    fingerprint = tile_fingerprint(ts)
    if devkey is None:
        devkey = device_key()
    cached = load_cached_plan(fingerprint, devkey, directory)
    if cached is not None:
        return cached, {"source": "cache", "device": devkey}

    def guarded(plan: TunedPlan) -> "float | None":
        if watchdog is None:
            return measure(plan)
        from reporter_tpu_torch.utils.watchdog import TIMED_OUT

        if watchdog.tripped:
            raise CalibrationAborted("watchdog breaker open")
        out = watchdog.run(lambda: measure(plan), timeout_s)
        if out is TIMED_OUT:
            raise CalibrationAborted(
                f"candidate {plan.label} exceeded {timeout_s:.0f}s")
        return out

    t0 = time.perf_counter()
    plan, report = calibrate(guarded)
    info = {"source": plan.source, "device": devkey,
            "calibration_seconds": round(time.perf_counter() - t0, 2),
            "calibration_dispatches":
                report["measured"] * (CAL_DISPATCHES + 1),
            **report}
    if plan.source == "measured":
        store_cached_plan(plan, report, fingerprint, devkey, directory)
    return plan, info


def calibration_batch(ts, shape: "tuple[int, int]" = CAL_BATCH_SHAPE,
                      seed: int = 1234):
    """Deterministic synthetic probe batch over the metro's own geometry:
    seeded random walks (~8 m steps) from sampled node positions, in the
    q16 infeed form (i16 quanta, f32 origins, i32 lens)."""
    from reporter_tpu_torch.ops.match import OFFSET_QUANTUM

    B, T = shape
    rng = np.random.default_rng(seed)
    n = max(1, len(ts.node_xy))
    base = np.asarray(ts.node_xy, np.float64)[rng.integers(0, n, B)]
    steps = rng.normal(0.0, 8.0, (B, T, 2))
    steps[:, 0] = 0.0
    walk = base[:, None, :] + np.cumsum(steps, axis=1)
    origins = walk[:, 0, :].astype(np.float32)
    dq = np.round((walk.astype(np.float32) - origins[:, None, :])
                  / np.float32(OFFSET_QUANTUM))
    pts_q = np.clip(dq, -32768, 32767).astype(np.int16)
    lens = np.full(B, T, np.int32)
    return pts_q, origins, lens
