"""Configuration: matcher, compiler and service parameters.

Counterpart: reporter_tpu/config.py (MatcherParams, CompilerParams,
ServiceConfig, Config). Field names, defaults and environment variables
are the JAX package's, so one parameter set means the same thing in
both, and ``Config.load`` / ``from_json`` read a JSON config the JAX
package wrote. A field whose feature the port does not have yet raises
NotImplementedError naming its ROADMAP item when set away from its
default; it is never ignored:

  MatcherParams.candidate_backend="grid"       queue 1 item 5
  CompilerParams cell_size / cell_capacity /
  index_radius (the spatial grid)              queue 1 item 5

``StreamingConfig`` is the JAX package's, field for field; it has no
environment variables there either.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any

from reporter_tpu_torch.utils.tracing import env_flag

__all__ = ["MatcherParams", "CompilerParams", "ServiceConfig",
           "StreamingConfig", "Config", "env_flag"]

_MODES = ("auto", "bicycle", "foot")


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
    candidate_backend: str = "auto"  # "auto" and "dense" run the dense
    #                                sweep (this port's only candidate
    #                                backend); "grid" raises
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
    sweep_nj_cap: int = 128        # the JAX sweep's launch-width rung; the
    #                                CUDA sweep has none, so only the
    #                                default is taken
    dispatch_timeout_s: float = 0.0   # the dispatch watchdog: 0 = off,
    #                                   else a dispatch past this many
    #                                   seconds is abandoned
    dispatch_fallback: str = "retry"  # what a timed-out dispatch degrades
    #                                   to: "retry" raises DispatchTimeout,
    #                                   "reference_cpu" serves the batch
    #                                   from the exact-Dijkstra oracle

    def __post_init__(self):
        if self.candidate_backend not in ("auto", "dense", "grid"):
            raise ValueError(f"unknown candidate_backend "
                             f"{self.candidate_backend!r}; use 'auto', "
                             "'dense' or 'grid'")
        if self.candidate_backend == "grid":
            raise NotImplementedError(
                "candidate_backend='grid' (the cell-row gather over the "
                "spatial grid) is not ported: ROADMAP queue 1 item 5")
        if self.sweep_nj_cap != 128:
            raise ValueError(
                f"sweep_nj_cap={self.sweep_nj_cap}: the CUDA sweep has no "
                "launch-width rung (it walks each chunk's compacted hit "
                "list); leave it at 128")
        if self.dispatch_fallback not in ("retry", "reference_cpu"):
            raise ValueError(f"unknown dispatch_fallback "
                             f"{self.dispatch_fallback!r}; use 'retry' or "
                             "'reference_cpu'")
        if self.dispatch_timeout_s < 0:
            raise ValueError("dispatch_timeout_s must be >= 0")

    def replace(self, **kw: Any) -> "MatcherParams":
        return dataclasses.replace(self, **kw)

    def with_env_overrides(self, env: "dict[str, str] | None" = None,
                           ) -> "MatcherParams":
        """The sweep levers from the environment; only set variables apply.
        RTPU_SWEEP_SUBCULL=0|1, RTPU_SWEEP_LOWP=off|bf16, RTPU_SWEEP_MXU=0|1,
        RTPU_SWEEP_AUTOTUNE=0|1, RTPU_DISPATCH_TIMEOUT_S (seconds) and
        RTPU_DISPATCH_FALLBACK=retry|reference_cpu. A bad
        value or an illegal combination
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
        if "RTPU_DISPATCH_TIMEOUT_S" in e:
            kw["dispatch_timeout_s"] = float(e["RTPU_DISPATCH_TIMEOUT_S"])
        if "RTPU_DISPATCH_FALLBACK" in e:
            kw["dispatch_fallback"] = e["RTPU_DISPATCH_FALLBACK"] or "retry"
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


    @classmethod
    def preset(cls, mode: str) -> "MatcherParams":
        """Mode-keyed matcher preset (the JAX package's values): slower
        modes narrow the radius and tighten chain breakage and route
        deviation. Serve a mode with tiles compiled for it
        (compile_network(net, mode=...))."""
        if mode == "auto":
            return cls()
        if mode == "bicycle":
            return cls(search_radius=40.0, breakage_distance=1200.0,
                       max_route_distance_factor=4.0)
        if mode == "foot":
            return cls(search_radius=30.0, breakage_distance=400.0,
                       max_route_distance_factor=3.0,
                       interpolation_distance=5.0)
        raise ValueError(f"unknown mode {mode!r}; one of {list(_MODES)}")


# the compiler's spatial-grid fields and their defaults: the dense layout
# builds no grid, so only the defaults are taken
_GRID_DEFAULTS = {"cell_size": 64.0, "cell_capacity": 64,
                  "index_radius": 50.0}


@dataclass(frozen=True)
class CompilerParams:
    """Offline tile-compiler parameters (the dense layout needs no grid).

    ``cell_size``, ``cell_capacity`` and ``index_radius`` size the JAX
    package's spatial grid; they are kept so one JSON config reads in
    both packages, and a value away from the default raises (the grid
    backend, ROADMAP queue 1 item 5). ``use_native`` builds the node-space
    reach rows with the C++ builder of the host library (built by g++ at
    first use; a failed build raises); False picks the Python builder.
    The tables are the same either way."""

    cell_size: float = 64.0
    cell_capacity: int = 64
    index_radius: float = 50.0
    reach_radius: float = 600.0    # reachability precompute radius (m)
    reach_max: int = 128           # max reachable targets kept per node row
    osmlr_max_length: float = 1000.0  # OSMLR chaining target length (m)
    use_native: bool = True

    def __post_init__(self):
        for name, default in _GRID_DEFAULTS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"CompilerParams.{name}={getattr(self, name)!r}: the "
                    "spatial grid (grid candidate backend) is not ported: "
                    "ROADMAP queue 1 item 5")


@dataclass(frozen=True)
class ServiceConfig:
    """Service wiring: every field, default and environment variable of the
    JAX package's ServiceConfig."""

    datastore_url: str = ""        # empty ⇒ publishing disabled (logged only)
    port: int = 8002
    threads: int = 4
    cache_ttl: float = 60.0        # per-uuid partial-trace cache TTL (s)
    cache_max_uuids: int = 100_000
    min_segment_length: float = 0.0
    mode: str = "auto"             # report transport mode tag
    # Request batching (service/scheduler.py). "scheduler" = continuous
    # in-flight batching: deadline batch close, trace-count padding, up
    # to max_inflight_batches batches in flight. "combine" = the
    # queue-and-combine leader (one batch in flight), kept for A/B runs.
    batching: str = "scheduler"
    batch_close_ms: float = 5.0    # a partial batch closes this many ms
    #                                after its oldest request was admitted
    #                                (the SLO deadline: a lone request is
    #                                never stuck waiting for peers)
    max_batch_traces: int = 256    # close-by-size threshold (traces)
    max_inflight_batches: int = 2  # device batches allowed in flight —
    #                                one worker thread each
    admission_queue_limit: int = 8192  # queued traces admitted before the
    #                                    service sheds with 503 (bounded
    #                                    memory; counted rejections)
    # Prepare-ahead: the scheduler runs a closed batch's pure host prepare
    # (cache merge, Trace build, padding, the matcher's prepare_many) on a
    # read-ahead thread while earlier batches occupy the card. Stateful
    # steps (cache retain, publish) stay in batch order, so reports are
    # the serial loop's. False = the serial loop (the A/B arm).
    pipeline_prepare: bool = True
    # Publisher resilience (service/datastore.py). Defaults: one attempt,
    # failures counted and dropped; retries and the dead-letter spool are
    # deployment policy.
    publish_retries: int = 0       # extra POST attempts per batch after
    #                                the first fails (bounded exponential
    #                                backoff with deterministic jitter —
    #                                faults.backoff_schedule)
    publish_backoff_ms: float = 50.0    # backoff base (doubles per retry)
    publish_backoff_cap_ms: float = 2000.0  # backoff ceiling
    publish_backoff_jitter: float = 0.1     # +[0, jitter)x seeded jitter
    # Span tracing / flight recorder (utils/tracing.py). The recorder is
    # process-global; these knobs only ever turn it ON: an env-enabled
    # recorder (RTPU_TRACE=1) is never disabled by a component
    # constructed with the defaults.
    trace: bool = False            # record host-side spans (batch, match,
    #                                publish). Off = one attribute read
    #                                per call site
    trace_ring: int = 4096         # flight-recorder span capacity
    trace_dir: str = ""            # non-empty ⇒ post-mortem Chrome-trace
    #                                dumps are written here automatically
    #                                on dead-letter, admission-shed and
    #                                quality-drift events (and on demand
    #                                via tracing.tracer().dump())
    dead_letter_dir: str = ""      # non-empty ⇒ batches that exhaust their
    #                                retries are SPOOLED to disk and
    #                                replayed automatically after the next
    #                                successful POST — an outage sheds to
    #                                disk, not to /dev/null. ONE DIR PER
    #                                PROCESS: the spool file carries no
    #                                inter-process locking

    def with_env_overrides(self, env: dict[str, str] | None = None) -> "ServiceConfig":
        """Apply env vars on top of this config; only set variables override."""
        e = os.environ if env is None else env
        kw: dict[str, Any] = {}
        if "DATASTORE_URL" in e:
            kw["datastore_url"] = e["DATASTORE_URL"]
        if "REPORTER_PORT" in e:
            kw["port"] = int(e["REPORTER_PORT"])
        if "THREAD_POOL_COUNT" in e:
            kw["threads"] = int(e["THREAD_POOL_COUNT"])
        if "PARTIAL_TRACE_TTL" in e:
            kw["cache_ttl"] = float(e["PARTIAL_TRACE_TTL"])
        if "REPORTER_MODE" in e:
            kw["mode"] = e["REPORTER_MODE"]
        if "REPORTER_BATCHING" in e:
            kw["batching"] = e["REPORTER_BATCHING"]
        if "REPORTER_BATCH_CLOSE_MS" in e:
            kw["batch_close_ms"] = float(e["REPORTER_BATCH_CLOSE_MS"])
        if "REPORTER_MAX_INFLIGHT" in e:
            kw["max_inflight_batches"] = int(e["REPORTER_MAX_INFLIGHT"])
        if "DATASTORE_RETRIES" in e:
            kw["publish_retries"] = int(e["DATASTORE_RETRIES"])
        if "DATASTORE_BACKOFF_MS" in e:
            kw["publish_backoff_ms"] = float(e["DATASTORE_BACKOFF_MS"])
        if "DATASTORE_DEAD_LETTER_DIR" in e:
            kw["dead_letter_dir"] = e["DATASTORE_DEAD_LETTER_DIR"]
        if "RTPU_PIPELINE_PREPARE" in e:
            try:
                kw["pipeline_prepare"] = env_flag(
                    e["RTPU_PIPELINE_PREPARE"], strict=True)
            except ValueError:
                raise ValueError(
                    f"RTPU_PIPELINE_PREPARE={e['RTPU_PIPELINE_PREPARE']!r}: "
                    "expected a boolean (1/0/true/false/yes/no/on/off)")
        if "RTPU_TRACE" in e:
            kw["trace"] = env_flag(e["RTPU_TRACE"])
        if "RTPU_TRACE_RING" in e:
            kw["trace_ring"] = int(e["RTPU_TRACE_RING"])
        if "RTPU_TRACE_DIR" in e:
            kw["trace_dir"] = e["RTPU_TRACE_DIR"]
        return dataclasses.replace(self, **kw) if kw else self

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "ServiceConfig":
        return cls().with_env_overrides(env)


@dataclass(frozen=True)
class StreamingConfig:
    """Streaming-ingest wiring (streaming/): partition count and the
    matcher worker's flush policy ("when enough points or time have
    gathered, match the buffered trace")."""

    num_partitions: int = 4        # uuid-hash partitions of the broker
    poll_max_records: int = 4096   # records consumed per partition per step
    flush_min_points: int = 16     # buffered points per uuid that trigger a match
    flush_max_age: float = 30.0    # seconds a buffer may age before forced flush
    speed_bins: tuple[float, ...] = (0., 2.5, 5., 7.5, 10., 12.5, 15., 17.5,
                                     20., 25., 30., 40.)  # m/s histogram edges
    queue_bins: tuple[float, ...] = (0., 10., 25., 50., 100., 200.,
                                     400.)  # meters-of-queue histogram edges
    hist_flush_interval: float = 60.0  # seconds between per-segment
    #                                    histogram flushes to the datastore
    #                                    (0 = manual flush only)
    # Pipelined flush (columnar worker): flush waves in flight on the
    # device while the main loop keeps consuming and the publisher thread
    # POSTs completed waves. 0 = the sequential consume, match, publish
    # loop (the dict worker's only shape); 1 = double buffering.
    pipeline_depth: int = 1
    # Adaptive wave sizing (columnar worker, opt-in): the effective
    # flush_min_points grows while broker lag rises and decays toward
    # wave_target_latency once caught up; flush_min_points is the start.
    wave_autotune: bool = False
    wave_min_points: int = 16          # controller floor (points/vehicle)
    wave_max_points: int = 960         # controller ceiling
    wave_target_latency: float = 2.0   # p50 probe-to-report target (s)


@dataclass(frozen=True)
class Config:
    """Top-level structured config (the JAX package's Config)."""

    matcher: MatcherParams = field(default_factory=MatcherParams)
    compiler: CompilerParams = field(default_factory=CompilerParams)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    streaming: StreamingConfig = field(default_factory=StreamingConfig)
    matcher_backend: str = "torch"  # "torch" (the device path; the JAX
    #                                package's "jax" reads as "torch") or
    #                                "reference_cpu" (the exact-Dijkstra
    #                                oracle, host only)

    def __post_init__(self):
        if self.matcher_backend == "jax":
            object.__setattr__(self, "matcher_backend", "torch")

    @classmethod
    def for_mode(cls, mode: str, **kw: Any) -> "Config":
        """Config serving one transport mode: the mode's MatcherParams
        preset and the service mode tag (see MatcherParams.preset)."""
        p = MatcherParams.preset(mode)
        svc = dataclasses.replace(kw.pop("service", ServiceConfig()),
                                  mode=mode)
        return cls(matcher=p, service=svc, **kw)

    def validate(self) -> "Config":
        """Cross-section invariants, as the JAX package's; the features the
        port does not have raise NotImplementedError."""
        m = self.matcher
        if m.sweep_lowp not in ("off", "bf16"):
            raise ValueError(f"unknown matcher.sweep_lowp {m.sweep_lowp!r}; "
                             "use 'off' or 'bf16'")
        if m.sweep_lowp == "bf16" and not m.sweep_subcull:
            raise ValueError(
                "matcher.sweep_lowp='bf16' requires sweep_subcull=True — "
                "the whole-block kernel has no low-precision pass")
        if m.sweep_mxu and not m.sweep_subcull:
            raise ValueError(
                "matcher.sweep_mxu=True requires sweep_subcull=True — "
                "the whole-block kernel has no matmul coarse pass")
        if self.matcher_backend not in ("torch", "reference_cpu"):
            raise ValueError(
                f"unknown matcher_backend {self.matcher_backend!r}")
        svc = self.service
        if svc.mode not in _MODES:
            raise ValueError(f"unknown service.mode {svc.mode!r}; one of "
                             f"{list(_MODES)}")
        if svc.batching not in ("scheduler", "combine"):
            raise ValueError(f"unknown service.batching {svc.batching!r}; "
                             "use 'scheduler' or 'combine'")
        if svc.batch_close_ms <= 0:
            raise ValueError("service.batch_close_ms must be > 0")
        if svc.max_batch_traces < 1 or svc.max_inflight_batches < 1:
            raise ValueError("service.max_batch_traces and "
                             "service.max_inflight_batches must be >= 1")
        if svc.admission_queue_limit < 1:
            raise ValueError("service.admission_queue_limit must be >= 1")
        if svc.publish_retries < 0:
            raise ValueError("service.publish_retries must be >= 0")
        if svc.publish_backoff_ms <= 0 or svc.publish_backoff_cap_ms <= 0:
            raise ValueError("service.publish_backoff_ms and "
                             "publish_backoff_cap_ms must be > 0")
        if svc.publish_backoff_jitter < 0:
            raise ValueError("service.publish_backoff_jitter must be >= 0")
        if svc.trace_ring < 1:
            raise ValueError("service.trace_ring must be >= 1")
        s = self.streaming
        if s.num_partitions < 1 or s.poll_max_records < 1 \
                or s.flush_min_points < 1:
            raise ValueError(
                "streaming num_partitions / poll_max_records / "
                "flush_min_points must all be >= 1")
        if s.flush_max_age <= 0:
            raise ValueError("streaming.flush_max_age must be > 0")
        if s.pipeline_depth < 0:
            raise ValueError("streaming.pipeline_depth must be >= 0")
        if not (1 <= s.wave_min_points <= s.wave_max_points):
            raise ValueError(
                "streaming wave bounds need 1 <= wave_min_points "
                "<= wave_max_points")
        if s.wave_target_latency <= 0:
            raise ValueError("streaming.wave_target_latency must be > 0")
        for bins in ("speed_bins", "queue_bins"):
            edges = getattr(s, bins)
            if len(edges) < 1 or list(edges) != sorted(set(edges)):
                raise ValueError(f"streaming.{bins} must be strictly "
                                 "ascending")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        streaming = dict(raw.get("streaming", {}))
        for bins in ("speed_bins", "queue_bins"):
            if bins in streaming:
                streaming[bins] = tuple(streaming[bins])
        return cls(
            matcher=MatcherParams(**raw.get("matcher", {})),
            compiler=CompilerParams(**raw.get("compiler", {})),
            service=ServiceConfig(**raw.get("service", {})),
            streaming=StreamingConfig(**streaming),
            matcher_backend=raw.get("matcher_backend", "torch"),
        )

    @classmethod
    def load(cls, path: "str | None" = None) -> "Config":
        """Load from a JSON file if given and present; environment
        variables that are set override the file's service and matcher
        sections (the JAX package's precedence)."""
        if path and os.path.exists(path):
            with open(path) as f:
                cfg = cls.from_json(f.read())
        else:
            cfg = cls()
        cfg = dataclasses.replace(cfg,
                                  service=cfg.service.with_env_overrides(),
                                  matcher=cfg.matcher.with_env_overrides())
        return cfg.validate()
