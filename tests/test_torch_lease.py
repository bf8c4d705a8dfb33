"""The port's partition lease table (reporter_tpu_torch/distributed/
lease.py) against the JAX package's, on the CPU.

Tolerance 0 throughout. A JAX and a port ``LeaseTable``, each in its own
directory, take the same seeded sequence of acquire, renew, commit,
release and ``apply_plan`` under one fake clock: every outcome is equal
and ``leases.json`` and ``lease_events.jsonl`` end byte-equal. A table
written by one package is operated by the other. ``plan_rebalance`` is
equal on 300 seeded states. Then the protocol over the pipelines: two
``StreamPipeline(device="cpu")`` workers with ``LeaseRunner``s over one
durable broker hand two partitions off mid-stream, publish what the JAX
package's pipelines publish in the same choreography, and cover the
reports of an uninterrupted pipeline over the partitions that never
moved; a zombie's stale-epoch commit raises ``StaleLeaseError``; a lost
lease discards its rows and the next owner replays them; the
expiry-to-takeover gap feeds the ``lease_reacquire`` SLO's series.
"""

import json
import threading
from collections import Counter

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.config import ServiceConfig as JServiceConfig
from reporter_tpu.config import StreamingConfig as JStreamingConfig
from reporter_tpu.distributed import lease as jlease
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_probe
from reporter_tpu.streaming import StreamPipeline as JStreamPipeline
from reporter_tpu.streaming.durable_queue import (
    DurableIngestQueue as JDurableIngestQueue)
from reporter_tpu.tiles.compiler import compile_network as jcompile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from reporter_tpu_torch.config import Config, ServiceConfig, StreamingConfig
from reporter_tpu_torch.distributed import lease
from reporter_tpu_torch.distributed.lease import (LeaseError, LeaseRunner,
                                                  LeaseTable,
                                                  StaleLeaseError,
                                                  plan_rebalance)
from reporter_tpu_torch.streaming import DurableIngestQueue, StreamPipeline
from reporter_tpu_torch.tiles.tileset import TileSet
from reporter_tpu_torch.utils.metrics import MetricsRegistry
from _torch_support import few_torch_threads  # noqa: F401

MEMBERS = ("a", "b", "c")
N_PART = 6


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def _outcome(fn):
    """(kind, value) of one call: its result, or the error's type and
    (for a fencing rejection) the rejected partitions."""
    try:
        return "ok", fn()
    except jlease.StaleLeaseError as exc:
        return "stale", exc.partitions
    except StaleLeaseError as exc:
        return "stale", exc.partitions
    except (jlease.LeaseError, LeaseError) as exc:
        return "error", type(exc).__name__


def _script(seed, n=160):
    """A seeded sequence of table operations (op, args), clock steps
    included; epochs and offsets are drawn near the plausible ones, so
    both live and stale commits and releases occur."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        op = rng.choice(["acquire", "renew", "commit", "release", "plan",
                         "tick"], p=[.25, .2, .25, .1, .1, .1])
        m = str(rng.choice(MEMBERS))
        p = int(rng.integers(N_PART + (1 if rng.random() < .03 else 0)))
        if op == "tick":
            out.append(("tick", float(rng.choice([0.1, 0.3, 6.0],
                                                 p=[.45, .45, .1]))))
        elif op in ("acquire", "renew"):
            out.append((op, m, p))
        elif op == "commit":
            # mostly the partition's owner ("@owner"), so floors move
            m = "@owner" if rng.random() < .6 else m
            out.append((op, m, p, int(rng.integers(-1, 2)),
                        int(rng.integers(-3, 12))))
        elif op == "release":
            out.append((op, m, p, int(rng.integers(-1, 1)),
                        int(rng.integers(0, 12))))
        else:
            out.append((op, float(rng.choice([3.0, 10.0])),
                        bool(rng.random() < .5)))
    return out


def _apply(table, mod, clock, step):
    op = step[0]
    if op == "acquire":
        return _outcome(lambda: table.acquire(step[1], step[2]))
    if op == "renew":
        return _outcome(lambda: table.renew(step[1]))
    st = table.state()
    if op == "plan":
        running = {"a", "b"} if step[2] else None
        plan = mod.plan_rebalance(st, clock(), step[1], running=running)
        table.apply_plan(plan)
        return "ok", plan
    _, m, p, de, off = step
    ent = st["partitions"].get(str(p), {"epoch": 0, "committed": 0,
                                        "owner": None})
    if m == "@owner":
        m = ent["owner"] or "a"
    epoch = int(ent["epoch"]) + de
    if op == "commit":
        return _outcome(lambda: table.commit(
            m, p, epoch, int(ent["committed"]) + off))
    return _outcome(lambda: table.release(
        m, p, epoch, floor=int(ent["committed"]) + off))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_script_same_files(tmp_path, seed):
    clock = FakeClock()
    jt = jlease.LeaseTable(str(tmp_path / "j"), N_PART, ttl_s=5.0,
                           clock=clock)
    pt = LeaseTable(str(tmp_path / "p"), N_PART, ttl_s=5.0, clock=clock)
    for step in _script(seed):
        if step[0] == "tick":
            clock.now += step[1]
            continue
        assert _apply(pt, lease, clock, step) == \
            _apply(jt, jlease, clock, step), step
    for name in ("leases.json", "lease_events.jsonl"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert pt.floors() == jt.floors() and pt.events() == jt.events()
    kinds = {e["event"] for e in pt.events()}
    assert {"acquire", "commit", "commit_rejected"} <= kinds


@pytest.mark.parametrize("first", ["jax", "port"])
def test_table_written_by_one_package_operated_by_the_other(tmp_path,
                                                            first):
    clock = FakeClock()
    a_cls, b_cls = ((jlease.LeaseTable, LeaseTable) if first == "jax"
                    else (LeaseTable, jlease.LeaseTable))
    path = str(tmp_path / "t")
    ta = a_cls(path, 4, ttl_s=5.0, clock=clock)
    e0 = ta.acquire("a", 0)
    ta.commit("a", 0, e0, 7)
    ta.acquire("a", 1)
    tb = b_cls(path, ttl_s=5.0, clock=clock)        # reopen: infers 4
    assert tb.num_partitions == 4 and tb.floors() == [7, 0, 0, 0]
    assert tb.acquire("b", 0) is None               # a's live lease holds
    clock.now += 6.0                                # a's leases expire
    e0b = tb.acquire("b", 0)
    assert e0b == e0 + 1
    with pytest.raises((StaleLeaseError, jlease.StaleLeaseError)):
        ta.commit("a", 0, e0, 9)                    # the zombie is fenced
    tb.commit("b", 0, e0b, 9)
    assert ta.floors() == tb.floors() == [9, 0, 0, 0]
    assert ta.events() == tb.events()
    kinds = [e["event"] for e in tb.events()]
    assert kinds.count("commit_rejected") == 1


def _random_state(rng):
    n = int(rng.integers(1, 9))
    now = 1000.0
    members = {}
    for m in ("a", "b", "c", "d")[:int(rng.integers(0, 5))]:
        members[m] = {"heartbeat": now - float(rng.choice([0.0, 3.0,
                                                          20.0]))}
    names = list(members) + ["dead"]
    parts = {}
    for p in range(n):
        owner = (str(rng.choice(names)) if rng.random() < .6 else None)
        parts[str(p)] = {
            "owner": owner, "epoch": int(rng.integers(0, 4)),
            "expires": now + float(rng.choice([-1.0, 5.0])),
            "committed": int(rng.integers(0, 50)),
            "assigned": (str(rng.choice(names)) if rng.random() < .3
                         else None),
            "revoke": bool(owner is not None and rng.random() < .2)}
    return {"version": 1, "num_partitions": n, "members": members,
            "partitions": parts}, now


def test_plan_rebalance_equal_on_seeded_states():
    rng = np.random.default_rng(2024)
    moved = 0
    for _ in range(300):
        st, now = _random_state(rng)
        for running in (None, {"a", "c"}):
            for ttl in (2.0, 10.0):
                got = plan_rebalance(json.loads(json.dumps(st)), now, ttl,
                                     running=running)
                want = jlease.plan_rebalance(json.loads(json.dumps(st)),
                                             now, ttl, running=running)
                assert got == want
                moved += bool(got["assign"] or got["revoke"])
    assert moved > 100


def test_racing_threads_exactly_one_wins(tmp_path):
    path = str(tmp_path / "l")
    LeaseTable(path, 1)
    results, barrier = {}, threading.Barrier(4)

    def racer(name, cls):
        tbl = cls(path)
        barrier.wait()
        results[name] = tbl.acquire(name, 0)

    threads = [threading.Thread(target=racer, args=(
        f"w{i}", (LeaseTable, jlease.LeaseTable)[i % 2])) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
        assert not th.is_alive()
    assert sum(e is not None for e in results.values()) == 1


def test_lease_reacquire_gap_observed(tmp_path):
    reg = MetricsRegistry()
    clock = FakeClock()
    table = LeaseTable(str(tmp_path / "lease"), 2, ttl_s=2.0, clock=clock,
                       metrics=reg)
    assert table.acquire("a", 0) is not None
    clock.now += 14.0                        # expires at +2 s
    assert table.acquire("b", 0) is not None
    c = reg.export()["counters"]
    assert c["lease_reacquire_seconds_count"] == 1.0
    assert c["lease_reacquire_seconds_total"] == pytest.approx(12.0)
    assert table.acquire("b", 0) is not None   # own renewal: no sample
    assert reg.export()["counters"]["lease_reacquire_seconds_count"] == 1.0


# ---------------------------------------------------------------------------
# LeaseRunner over the port's pipelines


@pytest.fixture(scope="module")
def lease_env():
    """The JAX streaming tests' tile (short OSMLR segments), the port's
    copy of it, and a time-major firehose of 8 vehicles x 60 points."""
    jts = jcompile_network(generate_city("tiny"), JCompilerParams(
        reach_radius=500.0, osmlr_max_length=200.0))
    ts = TileSet.from_arrays(jts.name, jts.meta.origin_lonlat,
                             {f: getattr(jts, f) for f in _ARRAY_FIELDS})
    fleet = [synthesize_probe(jts, seed=40 + s, num_points=60,
                              gps_sigma=3.0) for s in range(8)]
    recs = [{"uuid": p.uuid, "lat": float(p.lonlat[t, 1]),
             "lon": float(p.lonlat[t, 0]), "time": float(p.times[t])}
            for t in range(60) for p in fleet]
    return jts, ts, recs


def _pipe(ts, queue, published, clock, **over):
    kw = dict(num_partitions=4, flush_min_points=16)
    kw.update(over)
    return StreamPipeline(ts, Config(
        service=ServiceConfig(datastore_url="http://ds.test/"),
        streaming=StreamingConfig(**kw)), queue=queue,
        transport=lambda u, b: published.append(json.loads(b)) or 200,
        clock=clock, partitions=[], device="cpu")


def _jpipe(jts, queue, published, clock):
    return JStreamPipeline(jts, JConfig(
        matcher=JMatcherParams(candidate_backend="dense"),
        service=JServiceConfig(datastore_url="http://ds.test/"),
        streaming=JStreamingConfig(num_partitions=4, flush_min_points=16)),
        queue=queue,
        transport=lambda u, b: published.append(json.loads(b)) or 200,
        clock=clock, partitions=[])


def _keys(bodies):
    return Counter((r["id"], r["next_id"], round(r["t0"], 2),
                    round(r["t1"], 2))
                   for b in bodies for r in b.get("reports", ()))


def _handoff(mods, make_pipe, tiles, recs, tmp_path):
    """Two leased workers over one durable broker: a takes every
    partition and streams the first tranche; b joins, the planner
    revokes two partitions toward it, a hands them off (flush, fenced
    final floor, release) and b adopts them at the committed floors;
    both stream the second tranche and drain. → (a's bodies, b's
    bodies, the table, the queue, the plan)."""
    queue_cls, table_cls, runner_cls, planner = mods
    q = queue_cls(str(tmp_path / "broker"), 4)
    q.append_many(recs[:len(recs) // 2])
    lclock = FakeClock(5000.0)
    table = table_cls(str(tmp_path / "leases"), 4, ttl_s=30.0, clock=lclock)
    pub_a, pub_b = [], []
    pa = make_pipe(tiles, q, pub_a, FakeClock())
    pb = make_pipe(tiles, q, pub_b, FakeClock())
    ra, rb = runner_cls(table, "a", pa), runner_cls(table, "b", pb)
    assert ra.sync(force=True) and sorted(ra.epochs) == [0, 1, 2, 3]
    for _ in range(4):
        pa.step()
        ra.push_commits()
    assert not rb.sync(force=True)
    plan = planner(table.state(), now=lclock(), member_ttl_s=60.0)
    assert len(plan["revoke"]) == 2
    table.apply_plan(plan)
    assert ra.sync(force=True) and ra.stats["revoked"] == 2
    assert rb.sync(force=True) and rb.stats["acquired"] == 2
    q.append_many(recs[len(recs) // 2:])
    for _ in range(8):
        for pipe, runner in ((pa, ra), (pb, rb)):
            pipe.step()
            runner.push_commits()
    for pipe, runner in ((pa, ra), (pb, rb)):
        pipe.drain()
        runner.push_commits()
    assert table.floors() == [q.end_offset(p) for p in range(4)]
    assert ra.lag() == 0 and rb.lag() == 0
    assert ra.stats["stale_commits"] == rb.stats["stale_commits"] == 0
    return pub_a, pub_b, table, q, plan


@pytest.mark.usefixtures("few_torch_threads")
def test_handoff_equals_jax_and_covers_kept_partitions(lease_env, tmp_path):
    """The handoff on the port's pipelines publishes what the JAX
    package's publishes, body for body, and leaves the same lease events.
    The uninterrupted reports of the partitions that never moved are all
    published. The per-uuid partial-trace cache does not move with a
    partition (neither package moves it), so a report whose segment spans
    the handoff may be lost or altered: those are not held."""
    jts, ts, recs = lease_env
    pa_pub, pb_pub, table, q, plan = _handoff(
        (DurableIngestQueue, LeaseTable, LeaseRunner, plan_rebalance),
        _pipe, ts, recs, tmp_path / "port")
    ja_pub, jb_pub, jtable, jq, jplan = _handoff(
        (JDurableIngestQueue, jlease.LeaseTable, jlease.LeaseRunner,
         jlease.plan_rebalance), _jpipe, jts, recs, tmp_path / "jax")
    assert plan == jplan
    assert pa_pub == ja_pub and pb_pub == jb_pub
    assert table.events() == jtable.events()
    # a zombie holding a's old epoch of a handed-off partition is fenced
    gone = sorted(plan["revoke"])[0]
    old = [e for e in table.events() if e["event"] == "acquire"
           and e["member"] == "a" and e["partition"] == gone][0]["epoch"]
    with pytest.raises(StaleLeaseError):
        table.commit("a", gone, old, table.committed(gone) + 1)
    assert table.committed(gone) == q.end_offset(gone)
    q.close()
    jq.close()
    # the uninterrupted run of the kept partitions, fed the same tranches
    kept = sorted(set(range(4)) - set(plan["revoke"]))
    whole: list = []
    qw = DurableIngestQueue(str(tmp_path / "whole"), 4)
    qw.append_many(recs[:len(recs) // 2])
    pw = _pipe(ts, qw, whole, FakeClock())
    for p in kept:
        pw.adopt_partition(p, 0)
    for _ in range(4):
        pw.step()
    qw.append_many(recs[len(recs) // 2:])
    for _ in range(8):
        pw.step()
    pw.drain()
    qw.close()
    want = _keys(whole)
    assert sum(want.values()) > 0
    assert not (want - _keys(pa_pub + pb_pub))


@pytest.mark.usefixtures("few_torch_threads")
def test_lost_lease_discards_and_next_owner_replays(lease_env, tmp_path):
    _, ts, recs = lease_env
    lclock = FakeClock(5000.0)
    table = LeaseTable(str(tmp_path / "leases"), 4, ttl_s=5.0, clock=lclock)
    q = DurableIngestQueue(str(tmp_path / "broker"), 4)
    q.append_many(recs)
    published: list = []
    pa = _pipe(ts, q, published, FakeClock(), flush_min_points=10 ** 6)
    ra = LeaseRunner(table, "a", pa)
    ra.sync(force=True)
    old = dict(ra.epochs)
    for _ in range(4):
        pa.step()
        ra.push_commits()
    assert pa.stats()["buffered_points"] > 0
    lclock.now += 6.0                        # every lease expires
    ra.sync(force=True)
    assert ra.stats["lost"] == 4 and ra.stats["discarded_points"] > 0
    assert not published                     # dropped, not published
    with pytest.raises(StaleLeaseError):
        table.commit("a", 0, old[0], q.end_offset(0))
    assert table.floors() == [0, 0, 0, 0]
    pb = _pipe(ts, q, published, FakeClock())
    rb = LeaseRunner(table, "b", pb)
    rb.sync(force=True)
    assert rb.stats["acquired"] == 4
    for _ in range(8):
        pb.step()
        rb.push_commits()
    pb.drain()
    rb.push_commits()
    assert table.floors() == [q.end_offset(p) for p in range(4)]
    assert published
    q.close()
