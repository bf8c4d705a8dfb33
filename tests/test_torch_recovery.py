"""The dispatch watchdog on the port's serving paths, against the JAX
package's (tests/test_recovery.py's watchdog cases, on the port).

The port's columnar pipeline (pipelined, read-ahead prepare, on
``device="cpu"``) is fed a 6-vehicle fleet under a fault plan:

  - ``dispatch:hang(5)@1`` with a 2 s timeout releases exactly one
    wave, and the retried stream's published rows equal the
    uninterrupted run's, and the JAX package's uninterrupted run's (the
    JAX test's 0.4 s timeout leaves a CPU dispatch of tens of ms too
    little margin on a loaded host);
  - under a permanent hang, ``dispatch_fallback="reference_cpu"`` serves
    every wave from the oracle: rows equal to the JAX run's under the
    same plan, no wave released, the fallbacks counted;

then the matcher's breaker (past ``cap`` abandoned dispatches it
degrades at once, with the JAX matcher's counters) and a hung /report's
503, whose body equals the JAX app's. Rows are compared exactly
(tolerance 0); the JAX side runs ``candidate_backend="dense"``.
"""

import io
import json

import pytest

from reporter_tpu import faults as jfaults
from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.config import ServiceConfig as JServiceConfig
from reporter_tpu.config import StreamingConfig as JStreamingConfig
from reporter_tpu.matcher.api import DispatchTimeout as JDispatchTimeout
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.service.app import make_app as jmake_app
from reporter_tpu.streaming.columnar import (
    ColumnarIngestQueue as JColumnarIngestQueue)
from reporter_tpu.streaming.columnar import (
    ColumnarStreamPipeline as JColumnarStreamPipeline)
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads,
    fresh_link_sampler)
from reporter_tpu_torch import faults
from reporter_tpu_torch.config import (Config, MatcherParams, ServiceConfig,
                                       StreamingConfig)
from reporter_tpu_torch.matcher.api import (DispatchTimeout, SegmentMatcher,
                                            Trace)
from reporter_tpu_torch.service.app import make_app
from reporter_tpu_torch.streaming.columnar import (ColumnarIngestQueue,
                                                   ColumnarStreamPipeline)
from reporter_tpu_torch.tiles.tileset import TileSet

# a dispatch timeout notes "dead" on the process link sampler: each test
# scopes its own (the port gate holds the sampler's mood)
pytestmark = pytest.mark.usefixtures("few_torch_threads",
                                     "fresh_link_sampler")


@pytest.fixture(scope="module")
def jtiles():
    return compile_network(generate_city("tiny"),
                           JCompilerParams(reach_radius=500.0,
                                           osmlr_max_length=250.0))


@pytest.fixture(scope="module")
def tiles(jtiles):
    return TileSet.from_arrays(jtiles.name, jtiles.meta.origin_lonlat,
                               {f: getattr(jtiles, f) for f in _ARRAY_FIELDS})


@pytest.fixture(scope="module")
def fleet(jtiles):
    return synthesize_fleet(jtiles, 6, num_points=60, seed=9)


def _record_chunks(fleet, k=10):
    """Round-robin arrival: every vehicle's point i before any i + 1."""
    n = len(fleet[0].times)
    for lo in range(0, n, k):
        out = []
        for p in fleet:
            for i in range(lo, min(lo + k, n)):
                (lon, lat), t = p.lonlat[i], p.times[i]
                out.append({"uuid": p.uuid, "lat": float(lat),
                            "lon": float(lon), "time": float(t)})
        yield out


def _drive(pkg, ts, fleet, plan=None, timeout_s=0.0, fallback="retry"):
    """The fleet through a pipelined columnar pipeline of package ``pkg``
    ("jax" or "port") under a fault plan → (sorted published report
    rows, the pipeline's stats, the matcher's dispatch_fallback count)."""
    if pkg == "jax":
        fmod = jfaults
        queue = JColumnarIngestQueue(4)
        cfg = JConfig(
            matcher_backend="jax",
            matcher=JMatcherParams(candidate_backend="dense",
                                   dispatch_timeout_s=timeout_s,
                                   dispatch_fallback=fallback),
            service=JServiceConfig(datastore_url="http://sink.invalid/"),
            streaming=JStreamingConfig(flush_min_points=20,
                                       hist_flush_interval=0.0,
                                       pipeline_depth=1))
        make = JColumnarStreamPipeline
        kw = {}
    else:
        fmod = faults
        queue = ColumnarIngestQueue(4)
        cfg = Config(
            matcher=MatcherParams(dispatch_timeout_s=timeout_s,
                                  dispatch_fallback=fallback),
            service=ServiceConfig(datastore_url="http://sink.invalid/"),
            streaming=StreamingConfig(flush_min_points=20,
                                      hist_flush_interval=0.0,
                                      pipeline_depth=1))
        make = ColumnarStreamPipeline
        kw = {"device": "cpu"}
    captured: list = []
    pipe = make(ts, cfg, queue=queue,
                transport=lambda u, b: (captured.append(b), 200)[1], **kw)
    with fmod.use(fmod.FaultPlan.parse(plan) if plan else None):
        for batch in _record_chunks(fleet):
            queue.append_many(batch)
            pipe.step()
        for _ in range(30):
            pipe.step()
            st = pipe.stats()
            if (queue.lag(pipe.committed) == 0
                    and st["buffered_points"] == 0):
                break
        pipe.step(force_flush=True)
    st = pipe.stats()
    fallbacks = pipe.matcher.metrics.value("dispatch_fallback")
    pipe.close()
    rows = []
    for body in captured:
        for r in json.loads(body)["reports"]:
            rows.append((r["id"], -1 if r["next_id"] is None else
                         r["next_id"], round(r["t0"], 3), round(r["t1"], 3),
                         round(r["length"], 2)))
    return sorted(rows), st, fallbacks


def test_dispatch_timeout_releases_one_wave_and_retry_is_exact(
        jtiles, tiles, fleet):
    jrows, jst, _ = _drive("jax", jtiles, fleet)
    rows0, st0, _ = _drive("port", tiles, fleet)
    assert len(rows0) > 0 and st0["dispatch_timeouts"] == 0
    assert rows0 == jrows
    rows1, st1, _ = _drive("port", tiles, fleet, plan="dispatch:hang(5)@1",
                           timeout_s=2.0)
    assert st1["dispatch_timeouts"] == 1
    assert rows1 == rows0 == jrows        # none lost, none duplicated


def test_permanent_hang_falls_back_to_the_oracle(jtiles, tiles, fleet):
    plan = "dispatch:hang(5)@0-"
    jrows, jst, jfb = _drive("jax", jtiles, fleet, plan=plan, timeout_s=0.2,
                             fallback="reference_cpu")
    rows, st, fb = _drive("port", tiles, fleet, plan=plan, timeout_s=0.2,
                          fallback="reference_cpu")
    assert len(rows) > 0 and rows == jrows
    # no wave was released: each degraded inline, counted
    assert st["dispatch_timeouts"] == jst["dispatch_timeouts"] == 0
    assert fb == jfb > 0


def test_breaker_opens_past_cap(jtiles, tiles, fleet):
    """Four abandoned dispatches still stuck: the fifth degrades at once
    (breaker open, counted as a timeout too), as the JAX matcher does."""
    def run(pkg):
        if pkg == "jax":
            fmod, exc = jfaults, JDispatchTimeout
            m = JSegmentMatcher(jtiles, JConfig(
                matcher_backend="jax", matcher=JMatcherParams(
                    candidate_backend="dense", dispatch_timeout_s=0.05)))
            traces = [JTrace(p.uuid, p.xy.astype("float32"), p.times)
                      for p in fleet[:2]]
        else:
            fmod, exc = faults, DispatchTimeout
            m = SegmentMatcher(tiles, Config(matcher=MatcherParams(
                dispatch_timeout_s=0.05)), device="cpu")
            traces = [Trace(p.uuid, p.xy.astype("float32"), p.times)
                      for p in fleet[:2]]
        out = []
        with fmod.use(fmod.FaultPlan.parse("dispatch:hang(3)@0-")):
            for _ in range(5):
                with pytest.raises(exc, match="wave released for retry"):
                    m.match_many(traces)
                out.append((m._watchdog.abandoned, m._watchdog.tripped,
                            m.metrics.value("dispatch_timeout"),
                            m.metrics.value("dispatch_breaker_open")))
        return out

    got = run("port")
    assert got == run("jax")
    assert got[-1] == (4, True, 5, 1)


def _post(app, body):
    raw = json.dumps(body).encode()
    status: list = []
    env = {"REQUEST_METHOD": "POST", "PATH_INFO": "/report",
           "CONTENT_LENGTH": str(len(raw)), "wsgi.input": io.BytesIO(raw)}
    data = b"".join(app(env, lambda s, h: status.append(s)))
    return status[0], json.loads(data)


def test_hung_report_answers_503_as_the_jax_app(jtiles, tiles):
    body = {"uuid": "u1", "trace": [
        {"lat": 0.001 * i, "lon": 0.001 * i, "time": float(i)}
        for i in range(4)]}
    japp = jmake_app(jtiles, JConfig(
        matcher_backend="jax",
        matcher=JMatcherParams(candidate_backend="dense",
                               dispatch_timeout_s=0.2),
        service=JServiceConfig(batching="combine")))
    app = make_app(tiles, Config(
        matcher=MatcherParams(dispatch_timeout_s=0.2),
        service=ServiceConfig(batching="combine")), device="cpu")
    with jfaults.use(jfaults.FaultPlan.parse("dispatch:hang(5)@0-")):
        want = _post(japp, body)
    with faults.use(faults.FaultPlan.parse("dispatch:hang(5)@0-")):
        got = _post(app, body)
    assert got[0].startswith("503") and got == want
    assert app.matcher.metrics.value("dispatch_timeout") == 1
    japp.close()
    app.close()


def test_error_inside_the_guarded_dispatch_is_raised_not_degraded(tiles,
                                                                  fleet):
    """An error of the guarded body (a crash at the site here; a CUDA
    build or launch error on the card) reaches the caller as itself,
    even with the oracle fallback configured: only a timeout degrades."""
    m = SegmentMatcher(tiles, Config(matcher=MatcherParams(
        dispatch_timeout_s=5.0, dispatch_fallback="reference_cpu")),
        device="cpu")
    traces = [Trace(p.uuid, p.xy.astype("float32"), p.times)
              for p in fleet[:2]]
    with faults.use(faults.FaultPlan.parse("dispatch:crash@0")):
        with pytest.raises(faults.InjectedCrash):
            m.match_many(traces)
    assert m.metrics.value("dispatch_fallback") == 0
    assert m.metrics.value("dispatch_timeout") == 0
    assert m._watchdog.abandoned == 0 and m._fallback is None
