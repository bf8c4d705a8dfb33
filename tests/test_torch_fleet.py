"""The port's fleet residency (reporter_tpu_torch/fleet/) on the CPU.

Ports tests/test_fleet.py class by class (TestStackAndDispatchEdges
stays with the multi-GPU item, and TestLabeledMetrics with the metrics
module): the ledger, LRU paging with the watermark, pins and leases, the
capacity edges, the wire bytes of a fleet-resident metro equal to a
dedicated matcher's through evict → promote, the unstaged guard on every
device entry, the staged layout's version check, the page-in watchdog
and the fleet router. Then parity with the JAX package at tolerance 0,
the JAX side pinned to ``candidate_backend="dense"`` (on a CPU backend
its "auto" takes the grid): the shared ``host_tables`` members byte for
byte, records through paging, the paging decisions of one touch
sequence, the router's responses, /health keys and series names, and
``MetroSLO.apply``.

The metros are compiled by the JAX package and handed to the port as
numpy (``TileSet.from_arrays`` with the whole TileMeta). The port stages
on ``device="cpu"``, where nothing is pinned and a promotion places the
cold tier's CPU tensors; the pinned copy is
tests/test_torch_kernels_gpu.py's. The watchdog cases use the port's
wider timeouts (a 2 s bound, a 5 s hang; ROADMAP queue 3): 0.2 s can
expire on a healthy CPU transfer under six test workers.
"""

import dataclasses
import io
import json
import threading
import time

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_probe
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS as J_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch import faults
from reporter_tpu_torch.config import Config, MatcherParams
from reporter_tpu_torch.fleet import (FleetCapacityError, FleetConfig,
                                      FleetResidency, FleetRouter,
                                      MetroSLO, make_fleet_router)
from reporter_tpu_torch.matcher import autotune
from reporter_tpu_torch.matcher.api import (SegmentMatcher, TablesUnstaged,
                                            Trace)
from reporter_tpu_torch.service.scheduler import ServiceOverloaded
from reporter_tpu_torch.tiles.tileset import (STAGED_LAYOUT_VERSION,
                                              TileSet, check_staged_layout,
                                              place_tables, staged_nbytes)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CFG = Config()
JCFG = JConfig(matcher_backend="jax",
               matcher=JMatcherParams(candidate_backend="dense"))
TIMEOUT_S = 2.0      # the page-in bound of the watchdog cases
HANG = "fleet_promote:hang(5.0)@0"


def _jmetro(i: int, nx: int = 6, ny: int = 6):
    """tests/test_fleet.py's tiny metros at distinct centres (routing
    needs disjoint boxes), compiled by the JAX package."""
    net = generate_city("tiny", nx=nx, ny=ny, seed=20 + i,
                        center=(-120.0 + i * 0.5, 37.0))
    net.name = f"m{i}"
    return compile_network(net, JCompilerParams(reach_radius=500.0))


def _port(jts) -> TileSet:
    return TileSet.from_arrays(jts.name, jts.meta,
                               {f: getattr(jts, f) for f in J_FIELDS})


def _metro(i: int, nx: int = 6, ny: int = 6) -> TileSet:
    return _port(_jmetro(i, nx, ny))


def _bytes(ts: TileSet) -> int:
    return staged_nbytes(ts.host_tables("dense"))


def _fleet(metros, fleet=None, **kw) -> FleetResidency:
    return FleetResidency(metros, CFG, fleet, device="cpu", **kw)


def _payload(ts, seed=5, n=40):
    return synthesize_probe(ts, seed=seed, num_points=n,
                            gps_sigma=3.0).to_report_json()


def _wire_bytes(m, traces) -> bytes:
    """The wire tensors of these traces, in submission order."""
    _, inflight = m._submit_many(traces)
    return b"".join(w.cpu().numpy().tobytes() for _, w in inflight)


def _records(recs):
    return [[r.to_json() for r in x] for x in recs]


def wsgi_call(app, method, path, payload=None):
    body = json.dumps(payload).encode() if payload is not None else b""
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    captured = {}

    def start_response(status, headers):
        captured["status"] = int(status.split()[0])
        captured["headers"] = dict(headers)

    data = b"".join(app(environ, start_response))
    if captured["headers"]["Content-Type"].startswith("text/plain"):
        return captured["status"], data.decode()
    return captured["status"], (json.loads(data) if data else None)


@pytest.fixture(scope="module")
def jmetros():
    return [_jmetro(i) for i in range(3)]


@pytest.fixture(scope="module")
def metros(jmetros):
    return [_port(t) for t in jmetros]


@pytest.fixture(scope="module")
def staged_bytes(metros):
    """Each metro's staged bytes: the dense layout's device members."""
    return [_bytes(ts) for ts in metros]


class TestResidencyLedger:
    def test_registers_cold(self, metros):
        fr = _fleet(metros)
        assert fr.resident_bytes == 0
        assert fr.resident_names == []
        occ = fr.occupancy()
        assert occ["registered_metros"] == 3
        assert occ["resident_metros"] == 0
        assert occ["capacity_bytes"] == 0          # unbounded default

    def test_promote_on_touch_ledger_exact(self, metros, staged_bytes):
        fr = _fleet(metros)
        with fr.lease("m0") as m:
            assert m.table_bytes == staged_bytes[0]
        assert fr.resident_names == ["m0"]
        assert fr.resident_bytes == staged_bytes[0]
        with fr.lease("m1"):
            pass
        assert fr.resident_bytes == staged_bytes[0] + staged_bytes[1]
        occ = fr.occupancy()
        assert occ["promotions"] == 2 and occ["demotions"] == 0
        assert occ["metros"]["m0"]["staged_bytes"] == staged_bytes[0]
        fr.promote("m0")                  # the second touch: a hit
        assert fr.metrics.value('fleet_hits{metro="m0"}') == 1
        assert fr.metrics.value('fleet_misses{metro="m0"}') == 1

    def test_lru_eviction_respects_recency(self, metros, staged_bytes):
        budget = staged_bytes[0] + staged_bytes[1] + staged_bytes[2] // 2
        fr = _fleet(metros, FleetConfig(max_resident_bytes=budget,
                                        evict_watermark=1.0))
        fr.promote("m0")
        fr.promote("m1")
        fr.promote("m0")              # m1 is now LRU
        fr.promote("m2")              # needs room: evicts m1, not m0
        assert fr.resident_names == ["m0", "m2"]
        occ = fr.occupancy()
        assert occ["metros"]["m1"]["demotions"] == 1
        assert fr.metrics.value('fleet_evictions{metro="m1"}') == 1

    def test_watermark_drains_below_budget(self, metros, staged_bytes):
        budget = sum(staged_bytes)      # all three fit exactly
        fr = _fleet(metros, FleetConfig(max_resident_bytes=budget,
                                        evict_watermark=0.5))
        for n in ("m0", "m1", "m2"):
            fr.promote(n)
        assert len(fr.resident_names) == 3
        fr.set_capacity(budget - 1)     # drains below half the budget
        assert fr.resident_bytes <= (budget - 1) * 0.5
        assert fr.resident_names == ["m2"]          # LRU drained first

    def test_pinned_never_lru_evicted(self, metros, staged_bytes):
        budget = staged_bytes[0] + staged_bytes[1] // 2
        fr = _fleet(metros, FleetConfig(max_resident_bytes=budget,
                                        evict_watermark=1.0, pins=("m0",)))
        fr.promote("m0")
        with pytest.raises(FleetCapacityError):
            fr.promote("m1")           # the only candidate is pinned
        assert fr.resident_names == ["m0"]
        assert fr.metrics.value('fleet_promote_failures{metro="m1"}') == 1
        assert issubclass(FleetCapacityError, ServiceOverloaded)
        fr.demote("m0")                # the pin shields from LRU only
        assert fr.resident_names == []
        fr.promote("m1")
        assert fr.resident_names == ["m1"]

    def test_lease_blocks_eviction(self, metros, staged_bytes):
        budget = staged_bytes[0] + staged_bytes[1] // 2
        fr = _fleet(metros, FleetConfig(max_resident_bytes=budget,
                                        evict_watermark=1.0,
                                        promote_wait_s=0.0))
        with fr.lease("m0"):
            with pytest.raises(FleetCapacityError):
                fr.promote("m1")
            assert fr.resident_names == ["m0"]
        fr.promote("m1")               # lease released: m0 evictable
        assert fr.resident_names == ["m1"]

    def test_promote_waits_for_lease_release(self, metros, staged_bytes):
        """A promotion blocked only by a lease waits for it; one blocked
        by a pin sheds at once."""
        budget = staged_bytes[0] + staged_bytes[1] // 2
        fr = _fleet(metros, FleetConfig(max_resident_bytes=budget,
                                        evict_watermark=1.0,
                                        promote_wait_s=30.0))
        release, up = threading.Event(), threading.Event()

        def hold():
            with fr.lease("m0"):
                up.set()
                release.wait(60)

        t = threading.Thread(target=hold)
        t.start()
        assert up.wait(30)
        timer = threading.Timer(0.2, release.set)
        timer.start()
        fr.promote("m1")               # waits ~0.2 s, then evicts m0
        t.join(60)
        assert fr.resident_names == ["m1"]
        assert fr.metrics.value('fleet_promote_waits{metro="m1"}') >= 1
        fr2 = _fleet(metros, FleetConfig(max_resident_bytes=budget,
                                         evict_watermark=1.0, pins=("m0",),
                                         promote_wait_s=30.0))
        fr2.promote("m0")
        t0 = time.perf_counter()
        with pytest.raises(FleetCapacityError):
            fr2.promote("m1")
        assert time.perf_counter() - t0 < 5.0

    def test_promotion_does_not_stall_other_metros(self, metros,
                                                   monkeypatch):
        """The fleet lock guards the ledger only: a cold metro's staging
        build runs while a hot metro's lease comes and goes."""
        fr = _fleet(metros)
        fr.promote("m0")
        orig = TileSet.host_tables
        building = threading.Event()

        def slow(ts_self, backend="dense"):
            building.set()
            time.sleep(1.0)
            return orig(ts_self, backend)

        monkeypatch.setattr(TileSet, "host_tables", slow)
        t = threading.Thread(target=fr.promote, args=("m1",))
        t.start()
        assert building.wait(30)
        t0 = time.perf_counter()
        with fr.lease("m0"):
            pass
        hot_lease_s = time.perf_counter() - t0
        t.join(30)
        assert "m1" in fr.resident_names
        assert hot_lease_s < 0.5, hot_lease_s

    def test_concurrent_touches_promote_once(self, metros, monkeypatch):
        fr = _fleet(metros)
        orig = TileSet.host_tables

        def slow(ts_self, backend="dense"):
            time.sleep(0.4)
            return orig(ts_self, backend)

        monkeypatch.setattr(TileSet, "host_tables", slow)
        got: list = []

        def touch():
            with fr.lease("m2") as m:
                got.append(m)

        threads = [threading.Thread(target=touch) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert len(got) == 4 and all(m is got[0] for m in got)
        occ = fr.occupancy()["metros"]["m2"]
        assert occ["promotions"] == 1
        assert fr.resident_bytes == occ["staged_bytes"]

    def test_demote_under_lease_refused(self, metros):
        fr = _fleet(metros)
        with fr.lease("m0"):
            with pytest.raises(RuntimeError, match="in.*flight"):
                fr.demote("m0")
        fr.demote("m0")
        assert fr.resident_names == []

    def test_unbounded_budget_never_pages(self, metros):
        fr = _fleet(metros)
        for n in ("m0", "m1", "m2"):
            fr.promote(n)
        assert len(fr.resident_names) == 3
        assert fr.occupancy()["demotions"] == 0
        assert fr.occupancy()["occupancy_frac"] is None

    def test_validation_errors(self, metros):
        with pytest.raises(ValueError, match="duplicate"):
            _fleet([metros[0], metros[0]])
        with pytest.raises(ValueError, match="pins for unknown"):
            _fleet(metros, FleetConfig(pins=("atlantis",)))
        with pytest.raises(ValueError, match="configs for unknown"):
            _fleet(metros, configs={"atlantis": CFG})
        with pytest.raises(ValueError, match="watermark"):
            FleetConfig(evict_watermark=0.0).validate()
        with pytest.raises(ValueError, match="max_resident_bytes"):
            FleetConfig(max_resident_bytes=-1).validate()
        with pytest.raises(ValueError, match="promote_wait_s"):
            FleetConfig(promote_wait_s=-1.0).validate()
        with pytest.raises(ValueError, match="promote_timeout_s"):
            FleetConfig(promote_timeout_s=-1.0).validate()
        with pytest.raises(ValueError, match="torch"):
            FleetResidency(metros, Config(matcher_backend="reference_cpu"),
                           device="cpu")
        with pytest.raises(ValueError, match="matcher_backend='torch'"):
            _fleet(metros, configs={
                "m0": Config(matcher_backend="reference_cpu")})
        with pytest.raises(KeyError, match="unknown metro"):
            _fleet(metros).promote("atlantis")

    def test_cuda_fleet_without_a_card_raises(self, metros):
        """The entry point's default device is the card: without one it
        raises, never staging on the CPU quietly."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetResidency(metros, CFG)
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetResidency(metros, CFG, device="cuda")

    def test_per_metro_config_stages_its_own_layout(self, metros,
                                                    staged_bytes):
        """A per-metro candidate_backend stages the tables its own
        matcher reads (the grid's cell_pack, not the segment pack)."""
        cfg_grid = dataclasses.replace(
            CFG, matcher=MatcherParams(candidate_backend="grid"))
        fr = _fleet(metros, configs={"m0": cfg_grid})
        fr.promote("m0")
        fr.promote("m1")
        occ = fr.occupancy()["metros"]
        want_grid = staged_nbytes(metros[0].host_tables("grid"))
        assert occ["m0"]["staged_bytes"] == want_grid != staged_bytes[0]
        assert occ["m1"]["staged_bytes"] == staged_bytes[1]
        assert "cell_pack" in fr.matcher("m0").tables

    def test_env_overrides(self):
        fc = FleetConfig().with_env_overrides({
            "RTPU_FLEET_MAX_BYTES": "1e6",
            "RTPU_FLEET_WATERMARK": "0.7",
            "RTPU_FLEET_PINS": "m0, m2",
            "RTPU_FLEET_PROMOTE_WAIT": "1.5",
            "RTPU_FLEET_PROMOTE_TIMEOUT": "2.5"})
        assert fc.max_resident_bytes == 1_000_000
        assert fc.evict_watermark == 0.7
        assert fc.pins == ("m0", "m2")
        assert fc.promote_wait_s == 1.5
        assert fc.promote_timeout_s == 2.5
        fc2 = FleetConfig(pins=("m1",)).with_env_overrides(
            {"RTPU_FLEET_PINS": "m1,m0"})
        assert fc2.pins == ("m1", "m0")


class TestCapacityEdges:
    @pytest.fixture(scope="class")
    def sized(self):
        small = [_metro(20), _metro(21)]
        big = _metro(22, nx=12, ny=12)
        return small, big, [_bytes(ts) for ts in (*small, big)]

    def test_oversized_metro_sheds_without_mass_eviction(self, sized):
        small, big, (s0, s1, sb) = sized
        assert sb > s0 + s1            # big alone is over the budget
        fr = _fleet([*small, big], FleetConfig(max_resident_bytes=s0 + s1,
                                               evict_watermark=1.0))
        for ts in small:
            fr.promote(ts.name)
        with pytest.raises(FleetCapacityError,
                           match="exceed the fleet budget"):
            fr.promote(big.name)
        assert fr.resident_names == sorted(ts.name for ts in small)
        assert fr.occupancy()["demotions"] == 0

    def test_watermark_unreachable_evicts_minimally(self, sized):
        small, big, (s0, s1, sb) = sized
        cap = sb + max(s0, s1)          # big and one small fit together
        assert cap * 0.5 < sb <= cap    # the watermark's share cannot
        fr = _fleet([*small, big], FleetConfig(max_resident_bytes=cap,
                                               evict_watermark=0.5))
        for ts in small:
            fr.promote(ts.name)
        fr.promote(big.name)
        occ = fr.occupancy()
        assert occ["demotions"] == 1   # only the LRU small one
        assert big.name in fr.resident_names
        assert len(fr.resident_names) == 2


class TestBitIdentity:
    def test_wire_bytes_match_dedicated_through_paging(self, metros,
                                                       staged_bytes):
        ts = metros[0]
        traces = [Trace.from_json(_payload(ts, seed=s), ts)
                  for s in (5, 6, 7)]
        want = _wire_bytes(SegmentMatcher(ts, CFG, device="cpu"), traces)
        budget = staged_bytes[0] + staged_bytes[1] // 2
        fr = _fleet(metros, FleetConfig(max_resident_bytes=budget,
                                        evict_watermark=1.0))
        with fr.lease("m0") as m:
            assert _wire_bytes(m, traces) == want
        fr.promote("m1")               # evicts m0
        assert fr.resident_names == ["m1"]
        assert fr.occupancy()["metros"]["m0"]["demotions"] == 1
        assert not m.tables_staged and m.table_bytes == 0
        with fr.lease("m0") as m2:     # promoted back
            assert m2.tables_staged
            assert _wire_bytes(m2, traces) == want
        assert m2 is m and fr.matcher("m0") is m   # the matcher survives

    def test_unstaged_dispatch_fails_loudly(self, metros):
        ts = metros[0]
        m = SegmentMatcher(ts, CFG, device="cpu")
        m.unstage_tables()
        assert not m.tables_staged and m.table_bytes == 0
        with pytest.raises(TablesUnstaged, match="unstaged"):
            m.match_many([Trace.from_json(_payload(ts), ts)])
        assert issubclass(TablesUnstaged, RuntimeError)

    def test_paging_guards_the_oracle(self, metros):
        ref = SegmentMatcher(metros[0], Config(
            matcher_backend="reference_cpu"))
        assert not ref.tables_staged and ref.table_bytes == 0
        with pytest.raises(ValueError, match="matcher_backend='torch'"):
            ref.unstage_tables()
        with pytest.raises(ValueError, match="matcher_backend='torch'"):
            ref.restage_tables({})
        with pytest.raises(ValueError, match="matcher_backend='torch'"):
            SegmentMatcher(metros[0], Config(
                matcher_backend="reference_cpu"), staged_tables={})

    def test_unstaged_guard_covers_every_device_entry(self, metros,
                                                      monkeypatch):
        """match, match_many (one trace and several), matched_points,
        match_topk, submit_prepared, the submit loop and the calibration
        raise the named error, none a failure on None."""
        ts = metros[0]
        m = SegmentMatcher(ts, CFG, device="cpu")
        payloads = [_payload(ts, seed=s) for s in (5, 6)]
        traces = [Trace.from_json(p, ts) for p in payloads]
        prepared = m.prepare_many(traces)
        m.unstage_tables()
        entries = {
            "match": lambda: m.match(payloads[0]),
            "match_many": lambda: m.match_many(traces),
            "match_many_prepared": lambda: m.match_many(traces, prepared),
            "matched_points": lambda: m.matched_points(traces[0]),
            "match_topk": lambda: m.match_topk(traces[0]),
            "submit_prepared": lambda: m.submit_prepared(prepared.slices[0]),
            "_submit_many": lambda: m._submit_many(traces),
        }
        for name, call in entries.items():
            with pytest.raises(TablesUnstaged, match="unstaged"):
                call()

        def measure_once(params, ts_, measure, **kw):
            measure(autotune.TunedPlan())
            return None, {"source": "test"}

        monkeypatch.setattr(autotune, "resolve_plan", measure_once)
        with pytest.raises(TablesUnstaged, match="unstaged"):
            m._autotune_resolve({})

    def test_one_table_capture_per_batch(self, metros, monkeypatch):
        """A batch reads the tables once: a restage between its slices
        does not reach the slices after it."""
        ts = metros[0]
        m = SegmentMatcher(ts, MatcherParams(max_device_batch=1),
                           device="cpu")
        traces = [Trace.from_json(_payload(ts, seed=s), ts)
                  for s in (5, 6, 7)]
        first = m.tables
        seen, real = [], m.submit_prepared

        def spy(ps, tables=None):
            seen.append(tables)
            m.tables = {}              # a restage behind the batch's back
            return real(ps, tables)

        monkeypatch.setattr(m, "submit_prepared", spy)
        m.match_many(traces)
        assert len(seen) == 3 and all(t is first for t in seen)


class TestStagedLayoutVersion:
    def test_host_tables_carry_the_tag(self, metros):
        for backend in ("dense", "auto", "grid"):
            host = metros[0].host_tables(backend)
            assert int(host["staged_layout"]) == STAGED_LAYOUT_VERSION
            assert ("tuned_plan" in host) == (backend != "grid")
            check_staged_layout(host)
            placed = place_tables(host, "cpu")
            # the tag and the plan stay host values
            assert placed["staged_layout"] is host["staged_layout"]
            check_staged_layout(placed)
        with pytest.raises(ValueError, match="candidate_backend"):
            metros[0].host_tables("both")

    def test_untagged_dict_fails_on_restage(self, metros):
        m = SegmentMatcher(metros[0], CFG, device="cpu")
        stale = dict(metros[0].host_tables("dense"))
        stale.pop("staged_layout")
        m.unstage_tables()
        with pytest.raises(ValueError, match="staged_layout"):
            m.restage_tables(place_tables(stale, "cpu"))
        assert not m.tables_staged      # refused, not half staged
        m.restage_tables(place_tables(metros[0].host_tables("dense"), "cpu"))
        assert m.tables_staged

    def test_wrong_version_and_missing_member_fail(self, metros):
        good = metros[0].host_tables("dense")
        with pytest.raises(ValueError, match="layout v1"):
            check_staged_layout(dict(good, staged_layout=np.int32(1)))
        for member in ("seg_feat", "seg_sweep", "tuned_plan"):
            torn = dict(good)
            torn.pop(member)
            with pytest.raises(ValueError, match=member):
                check_staged_layout(torn)
        check_staged_layout(good)

    def test_a_jax_built_dict_is_refused(self, jmetros):
        """The JAX package's dense dict carries a current tag and lacks
        the port's seg_sweep and seg_coarse: refused by name."""
        jhost = jmetros[0].host_tables("dense")
        with pytest.raises(ValueError, match="seg_sweep.*seg_coarse"):
            check_staged_layout(jhost)
        with pytest.raises(ValueError, match="seg_sweep"):
            SegmentMatcher(_port(jmetros[0]), CFG, device="cpu",
                           staged_tables=place_tables(jhost, "cpu"))

    def test_untagged_injection_fails_at_construction(self, metros):
        stale = dict(metros[0].host_tables("dense"))
        stale.pop("staged_layout")
        with pytest.raises(ValueError, match="staged_layout"):
            SegmentMatcher(metros[0], CFG, device="cpu",
                           staged_tables=place_tables(stale, "cpu"))

    def test_staged_plan_resolves_before_the_cache(self, metros, tmp_path):
        """A measured plan riding the host vector resolves as "staged"
        and measures nothing; a default vector falls through to the
        cache, whose plan is stamped back; stamp_cached_plan writes it
        ahead of staging."""
        ts = metros[0]
        params = MatcherParams()

        def never(plan):
            raise AssertionError("measured")

        host = ts.host_tables("dense")
        host["tuned_plan"] = autotune.plan_array(
            autotune.TunedPlan(arm="mxu", lowp="bf16", source="measured"))
        plan, info = autotune.resolve_plan(params, ts, never,
                                           backend="cuda", devkey="card",
                                           directory=str(tmp_path),
                                           tables=host)
        assert (plan.arm, plan.lowp, plan.source) == ("mxu", "bf16",
                                                      "staged")
        assert info == {"source": "staged"}
        fresh = ts.host_tables("dense")
        assert np.array_equal(fresh["tuned_plan"],
                              autotune.default_plan_array())
        cached = autotune.TunedPlan(arm="block", source="measured")
        devkey = autotune.device_key()
        autotune.store_cached_plan(cached, {}, autotune.tile_fingerprint(ts),
                                   devkey, str(tmp_path))
        plan, info = autotune.resolve_plan(params, ts, never, backend="cuda",
                                           devkey=devkey,
                                           directory=str(tmp_path),
                                           tables=fresh)
        assert (plan.arm, info["source"]) == ("block", "cache")
        assert autotune.plan_from_array(fresh["tuned_plan"]).source == "cache"
        ahead = ts.host_tables("dense")
        stamped = autotune.stamp_cached_plan(ts, ahead, params,
                                             str(tmp_path))
        assert (stamped.arm, stamped.source) == ("block", "cache")
        plan, info = autotune.resolve_plan(params, ts, never, backend="cuda",
                                           devkey="another card",
                                           directory=str(tmp_path),
                                           tables=ahead)
        assert (plan.arm, info["source"]) == ("block", "staged")
        grid = ts.host_tables("grid")
        assert autotune.stamp_cached_plan(ts, grid, params,
                                          str(tmp_path)) is None
        assert autotune.stamp_cached_plan(
            ts, ts.host_tables("dense"), params.replace(sweep_autotune=False),
            str(tmp_path)) is None


class TestPromoteWatchdog:
    def test_timeout_sheds_rolls_back_and_recovers(self, metros):
        fr = _fleet(metros, FleetConfig(promote_timeout_s=TIMEOUT_S))
        with faults.use(faults.FaultPlan.parse(HANG)):
            with pytest.raises(ServiceOverloaded, match="exceeded"):
                fr.promote("m0")
            assert fr.resident_bytes == 0
            assert fr.resident_names == []
            assert fr.occupancy()["metros"]["m0"]["promotions"] == 0
            assert fr.metrics.value(
                'fleet_promote_timeouts{metro="m0"}') == 1
            with fr.lease("m0") as m:  # call 1: no rule, it promotes
                assert m.tables_staged
        assert fr.resident_names == ["m0"]

    def test_waiters_unblock_when_promotion_sheds(self, metros):
        fr = _fleet(metros, FleetConfig(promote_timeout_s=TIMEOUT_S))
        results: dict = {}

        def promoter():
            try:
                fr.promote("m1")
            except ServiceOverloaded as exc:
                results["promoter"] = exc

        def waiter():
            with fr.lease("m1") as m:
                results["waiter"] = m.tables_staged

        with faults.use(faults.FaultPlan.parse(HANG)):
            a = threading.Thread(target=promoter)
            a.start()
            deadline = time.monotonic() + 30
            while not fr._metros["m1"].promoting:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            b = threading.Thread(target=waiter)
            b.start()                   # parks on the condvar
            a.join(30)
            b.join(30)
        assert isinstance(results["promoter"], ServiceOverloaded)
        assert results["waiter"] is True
        assert fr.resident_names == ["m1"]

    def test_breaker_opens_at_abandoned_cap(self, metros):
        fr = _fleet(metros, FleetConfig(promote_timeout_s=TIMEOUT_S))
        with fr._watchdog.lock:
            fr._watchdog.abandoned = fr._watchdog.cap
        with pytest.raises(ServiceOverloaded, match="breaker open"):
            fr.promote("m0")
        assert fr.metrics.value("fleet_promote_breaker_open") == 1
        assert fr.metrics.value('fleet_promote_timeouts{metro="m0"}') == 1
        with fr._watchdog.lock:
            fr._watchdog.abandoned = 0
        fr.promote("m0")
        assert fr.resident_names == ["m0"]

    def test_doomed_promotion_sheds_immediately(self):
        """A promoter parked in its own capacity wait holds no bytes: a
        promotion that cannot fit once every transient frees sheds now,
        not after promote_wait_s."""
        a, b = _metro(10), _metro(11)
        big = _metro(12, nx=12, ny=12)
        sa, sb, sc = (_bytes(t) for t in (a, b, big))
        cap = sa + (3 * sb) // 4
        assert cap < sc <= cap + sb, (sa, sb, sc)
        fr = _fleet([a, b, big], FleetConfig(
            max_resident_bytes=cap, evict_watermark=1.0,
            promote_wait_s=3.0))
        fr.promote(a.name)
        shed_s: dict = {}

        def promote_b():
            fr.promote(b.name)          # parks: a is leased

        with fr.lease(a.name):
            t = threading.Thread(target=promote_b)
            t.start()
            deadline = time.monotonic() + 30
            while not fr.metrics.value(
                    f'fleet_promote_waits{{metro="{b.name}"}}'):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            t0 = time.perf_counter()
            with pytest.raises(FleetCapacityError):
                fr.promote(big.name)
            shed_s["big"] = time.perf_counter() - t0
        t.join(30)
        assert shed_s["big"] < 1.0, shed_s
        assert fr.resident_names == [b.name]


class TestFleetRouter:
    @pytest.fixture(scope="class")
    def router(self, metros, staged_bytes):
        r = FleetRouter(
            metros, CFG, transport=lambda u, b: 200,
            fleet=FleetConfig(
                max_resident_bytes=(staged_bytes[0] + staged_bytes[1]
                                    + staged_bytes[2] // 2),
                evict_watermark=1.0),
            slos={"m0": MetroSLO(deadline_ms=2.0, queue_limit=64),
                  "m1": MetroSLO(pinned=True)}, device="cpu")
        yield r
        r.close()

    def test_geo_routing_with_paging(self, router, metros):
        for ts in metros:               # 3 metros through a 2-metro budget
            out = router.report_one(_payload(ts))
            assert out["metro"] == ts.name
        occ = router.residency.occupancy()
        assert occ["promotions"] >= 3
        assert occ["demotions"] >= 1
        assert occ["resident_metros"] == 2
        assert "m1" in router.residency.resident_names     # pinned

    def test_slo_maps_to_scheduler_config(self, router, metros):
        c0 = router._configs["m0"]
        assert c0.service.batch_close_ms == 2.0
        assert c0.service.admission_queue_limit == 64
        assert "m1" in router.residency.fleet.pins
        with pytest.raises(ValueError, match="SLOs for unknown"):
            FleetRouter([metros[0]], CFG, slos={"nope": MetroSLO()},
                        device="cpu")
        reserved = _metro(9)
        reserved.name = "fleet"
        with pytest.raises(ValueError, match="reserved"):
            FleetRouter([reserved], CFG, device="cpu")

    def test_batch_groups_by_metro(self, router, metros):
        payloads = [_payload(metros[2], seed=8), _payload(metros[0], seed=9),
                    _payload(metros[2], seed=10)]
        outs = router.report_many(payloads)
        assert [o["metro"] for o in outs] == ["m2", "m0", "m2"]

    def test_results_match_dedicated_app(self, router, metros):
        from reporter_tpu_torch.service.app import ReporterApp

        for ts in metros:
            p = _payload(ts, seed=11)
            want_app = ReporterApp(ts, CFG, transport=lambda u, b: 200,
                                   device="cpu")
            want = want_app.report_one(p)
            got = router.report_one(p)
            want_app.close()
            assert got.pop("metro") == ts.name
            assert got == want

    def test_injected_matcher_must_wrap_the_tileset(self, metros):
        from reporter_tpu_torch.service.app import ReporterApp

        m = SegmentMatcher(metros[0], CFG, device="cpu")
        with pytest.raises(ValueError, match="same tileset"):
            ReporterApp(metros[1], CFG, matcher=m)
        app = ReporterApp(metros[0], CFG, matcher=m)
        assert app.matcher is m
        app.close()

    def test_health_stats_metrics_surfaces(self, router):
        status, h = wsgi_call(router, "GET", "/health")
        assert status == 200
        assert h["fleet"]["registered_metros"] == 3
        assert h["fleet"]["resident_metros"] == 2
        assert set(h["fleet"]["metros"]) == {"m0", "m1", "m2"}
        status, s = wsgi_call(router, "GET", "/stats")
        assert status == 200 and "fleet" in s
        assert s["fleet"]["occupancy"]["promotions"] >= 3
        status, txt = wsgi_call(router, "GET", "/metrics")
        assert 'rtpu_fleet_promotions{metro="m0"}' in txt
        assert "rtpu_fleet_resident_bytes_total" in txt
        assert "# TYPE rtpu_fleet_promote_seconds histogram" in txt
        assert txt.count("# TYPE rtpu_fleet_promotions counter") == 1

    def test_unroutable_404_names_known_metros(self, router):
        before = router.metrics.value("router_unroutable")
        status, body = wsgi_call(router, "POST", "/report", {
            "uuid": "x", "trace": [{"lat": -45.0, "lon": 100.0}]})
        assert status == 404
        assert body["known_metros"] == ["m0", "m1", "m2"]
        assert router.metrics.value("router_unroutable") == before + 1
        status, body = wsgi_call(router, "POST", "/report", {
            "uuid": "x", "metro": "atlantis",
            "trace": [{"lat": 37.0, "lon": -120.0}]})
        assert status == 400

    def test_concurrent_mixed_traffic_with_paging(self, router, metros):
        """Leases make promotion and dispatch atomic against eviction:
        nine threads over three metros and a two-metro budget."""
        errors: list = []

        def worker(i):
            ts = metros[i % 3]
            try:
                out = router.report_one(_payload(ts, seed=30 + i))
                assert out["metro"] == ts.name
            except Exception as e:     # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors

    def test_package_exports(self):
        import reporter_tpu_torch

        assert reporter_tpu_torch.FleetResidency is FleetResidency
        assert reporter_tpu_torch.FleetConfig is FleetConfig
        assert reporter_tpu_torch.MetroSLO is MetroSLO
        assert reporter_tpu_torch.make_fleet_router is make_fleet_router
        with pytest.raises(AttributeError):
            reporter_tpu_torch.NoSuchThing


# ---------------------------------------------------------------------------
# parity with the JAX package, tolerance 0

# the staged members both packages stage; the others are listed, not
# compared
SHARED = ("edge_len", "reach_row", "reach_to", "reach_dist", "seg_pack",
          "seg_bbox", "seg_sub", "seg_feat")
ONLY_JAX = ("edge_osmlr",)
ONLY_PORT = ("seg_sweep", "seg_coarse")


def test_shared_host_tables_byte_equal(jmetros, tmp_path):
    """(a) The port's host_tables of the tile the JAX package saved
    equal the JAX host_tables byte for byte on every shared member
    (the grid's cell_pack too); the members only one side stages are
    the listed ones."""
    jts = jmetros[0]
    path = str(tmp_path / "m0.npz")
    jts.save(path)
    pts = TileSet.load(path)
    jhost, phost = jts.host_tables("dense"), pts.host_tables("dense")
    keys = set(jhost) - {"staged_layout", "tuned_plan"}
    assert keys - set(phost) == set(ONLY_JAX)
    assert set(phost) - set(jhost) == set(ONLY_PORT)
    for k in SHARED:
        assert phost[k].dtype == jhost[k].dtype, k
        assert phost[k].tobytes() == jhost[k].tobytes(), k
    assert int(phost["staged_layout"]) == int(jhost["staged_layout"])
    assert phost["tuned_plan"].tobytes() == jhost["tuned_plan"].tobytes()
    jgrid, pgrid = jts.host_tables("grid"), pts.host_tables("grid")
    assert pgrid["cell_pack"].tobytes() == jgrid["cell_pack"].tobytes()


def test_records_through_paging_equal_the_jax_fleet(jmetros, metros,
                                                    staged_bytes):
    """(b) A fleet-resident metro's records after evict → promote equal
    the JAX FleetResidency's and the JAX dedicated matcher's."""
    from reporter_tpu.fleet import FleetConfig as JFleetConfig
    from reporter_tpu.fleet import FleetResidency as JFleetResidency
    from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
    from reporter_tpu.matcher.api import Trace as JTrace

    payloads = [_payload(jmetros[0], seed=s, n=60) for s in (5, 6, 7, 8)]
    jtraces = [JTrace.from_json(p, jmetros[0]) for p in payloads]
    ptraces = [Trace.from_json(p, metros[0]) for p in payloads]
    jstaged = [sum(v.nbytes for v in t.host_tables("dense").values())
               for t in jmetros]
    want = _records(JSegmentMatcher(jmetros[0], JCFG).match_many(jtraces))
    jfr = JFleetResidency(jmetros, JCFG, JFleetConfig(
        max_resident_bytes=jstaged[0] + jstaged[1] // 2,
        evict_watermark=1.0))
    pfr = _fleet(metros, FleetConfig(
        max_resident_bytes=staged_bytes[0] + staged_bytes[1] // 2,
        evict_watermark=1.0))
    got = {}
    for name, fr, traces in (("jax", jfr, jtraces), ("port", pfr, ptraces)):
        with fr.lease("m0"):
            pass
        fr.promote("m1")               # evicts m0
        assert fr.resident_names == ["m1"]
        with fr.lease("m0") as m:
            got[name] = _records(m.match_many(traces))
    assert got["port"] == got["jax"] == want
    assert sum(len(r) for r in want)


def _occ_state(fr):
    occ = fr.occupancy()
    return {"resident": fr.resident_names,
            "promotions": occ["promotions"], "demotions": occ["demotions"],
            "evictions": {n: int(fr.metrics.value(
                f'fleet_evictions{{metro="{n}"}}')) for n in fr.names},
            "failures": {n: int(fr.metrics.value(
                f'fleet_promote_failures{{metro="{n}"}}'))
                for n in fr.names}}


def test_paging_decisions_equal_the_jax_fleet(jmetros, metros):
    """(c) One touch sequence, each package's budget the same multiple
    of its own staged bytes (and the same pin): the same resident sets,
    promotions, demotions, evictions and FleetCapacityErrors after every
    touch, a budget change included."""
    from reporter_tpu.fleet import FleetCapacityError as JFleetCapacityError
    from reporter_tpu.fleet import FleetConfig as JFleetConfig
    from reporter_tpu.fleet import FleetResidency as JFleetResidency

    jstaged = [sum(v.nbytes for v in t.host_tables("dense").values())
               for t in jmetros]
    pstaged = [_bytes(t) for t in metros]

    def budget(s, frac):
        return int((s[0] + s[1] + s[2] // 2) * frac)

    frs = {"jax": JFleetResidency(jmetros, JCFG, JFleetConfig(
               max_resident_bytes=budget(jstaged, 1.0), evict_watermark=1.0,
               promote_wait_s=0.0, pins=("m2",))),
           "port": _fleet(metros, FleetConfig(
               max_resident_bytes=budget(pstaged, 1.0), evict_watermark=1.0,
               promote_wait_s=0.0, pins=("m2",)))}
    staged = {"jax": jstaged, "port": pstaged}
    steps = ["m0", "m1", "m0", "m2", "m1", "m0", ("cap", 0.6), "m1",
             ("demote", "m2"), "m1", "m0", ("cap", 1.0), "m2", "m1",
             ("lease", "m0", "m1"), "m0"]
    trail = {}
    for name, fr in frs.items():
        trail[name] = []
        for step in steps:
            outcome = "ok"
            try:
                if isinstance(step, str):
                    fr.promote(step)
                elif step[0] == "cap":
                    fr.set_capacity(budget(staged[name], step[1]))
                elif step[0] == "demote":
                    fr.demote(step[1])
                else:                   # a touch under another's lease
                    with fr.lease(step[1]):
                        try:
                            fr.promote(step[2])
                        except (FleetCapacityError,
                                JFleetCapacityError):
                            outcome = "capacity"
            except (FleetCapacityError, JFleetCapacityError):
                outcome = "capacity"
            trail[name].append((step, outcome, _occ_state(fr)))
    assert trail["port"] == trail["jax"]
    outcomes = [o for _, o, _ in trail["port"]]
    assert "capacity" in outcomes and trail["port"][-1][2]["demotions"]


def test_router_responses_health_and_series_equal_the_jax_router(
        jmetros, metros, staged_bytes):
    """(d) The same requests through the JAX FleetRouter and the port's
    give equal responses; /health's fleet block and occupancy keys and
    the rtpu_fleet_* series names are equal, and the paging counts."""
    from reporter_tpu.fleet import FleetConfig as JFleetConfig
    from reporter_tpu.fleet import FleetRouter as JFleetRouter
    from reporter_tpu.fleet import MetroSLO as JMetroSLO

    jstaged = [sum(v.nbytes for v in t.host_tables("dense").values())
               for t in jmetros]

    def cap(s):
        return s[0] + s[1] + s[2] // 2

    jr = JFleetRouter(jmetros, JCFG, transport=lambda u, b: 200,
                      fleet=JFleetConfig(max_resident_bytes=cap(jstaged),
                                         evict_watermark=1.0),
                      slos={"m1": JMetroSLO(pinned=True)})
    pr = FleetRouter(metros, CFG, transport=lambda u, b: 200,
                     fleet=FleetConfig(max_resident_bytes=cap(staged_bytes),
                                       evict_watermark=1.0),
                     slos={"m1": MetroSLO(pinned=True)}, device="cpu")
    try:
        payloads = [_payload(jmetros[i % 3], seed=40 + i) for i in range(7)]
        payloads[3]["metro"] = "m2"
        for p in payloads:
            assert pr.report_one(p) == jr.report_one(p)
        many = [payloads[0], payloads[5], payloads[2]]
        assert pr.report_many(many) == jr.report_many(many)
        far = {"uuid": "x", "trace": [{"lat": -45.0, "lon": 100.0}]}
        assert wsgi_call(pr, "POST", "/report", far) == \
            wsgi_call(jr, "POST", "/report", far)
        ph, jh = pr.health(), jr.health()
        assert set(ph) == set(jh)
        assert set(ph["fleet"]) == set(jh["fleet"])
        assert set(ph["quality"]) == set(jh["quality"])
        for n in ("m0", "m1", "m2"):
            assert set(ph["fleet"]["metros"][n]) == \
                set(jh["fleet"]["metros"][n])
        for key in ("resident_metros", "registered_metros", "promotions",
                    "demotions", "evict_watermark"):
            assert ph["fleet"][key] == jh["fleet"][key], key
        assert {n: (v["resident"], v["pinned"], v["promotions"],
                    v["demotions"]) for n, v in ph["fleet"]["metros"].items()
                } == {n: (v["resident"], v["pinned"], v["promotions"],
                          v["demotions"])
                      for n, v in jh["fleet"]["metros"].items()}
        assert set(pr.stats()) == set(jr.stats())

        def fleet_series(txt):
            return sorted({line.split()[0].split("{")[0]
                           for line in txt.splitlines()
                           if line.startswith("rtpu_fleet_")})

        assert fleet_series(pr.render_prometheus()) == \
            fleet_series(jr.render_prometheus())
    finally:
        jr.close()
        pr.close()


@pytest.mark.parametrize("slo", [
    dict(), dict(deadline_ms=2.0), dict(queue_limit=64),
    dict(max_inflight=3, pinned=True),
    dict(deadline_ms=7.5, queue_limit=16, max_inflight=1)])
def test_metro_slo_apply_equals_the_jax_slo(slo):
    """(e) MetroSLO.apply gives the JAX SLO's service config."""
    from reporter_tpu.config import Config as JBase
    from reporter_tpu.fleet import MetroSLO as JMetroSLO

    got = dataclasses.asdict(MetroSLO(**slo).apply(Config()).service)
    want = dataclasses.asdict(JMetroSLO(**slo).apply(JBase()).service)
    assert got == want
