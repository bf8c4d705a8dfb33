"""The port's streaming worker entry point, ``python -m
reporter_tpu_torch.streaming`` (tests/test_streaming_cli.py's cases on
the port), on the CPU.

As subprocesses with ``--device cpu``: the dict worker over a pre-staged
durable broker with ``--exit-on-drain`` and a checkpoint, its reports at
a local datastore equal to an in-process pipeline's over a copy of the
same directory; the columnar worker fed by ``--stdin-format csv`` into a
fresh (columnar) broker; and the dict worker fed ``--stdin-format json``.
In-process (``main``): the checkpoint restart, partition subsets, the
columnar worker over a record broker, the broker format read from the
directory, the exit JSON's keys; the topology's flags: ``--lease-dir``
draining a broker through the lease table, ``--snapshot-dir`` writing a
snapshot the JAX package reads, the default SLO block with the JAX
worker's keys, ``RTPU_SLO=bogus`` raising as the JAX gate does, and the
JAX parser's two lease-mode refusals.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from reporter_tpu_torch.config import CompilerParams, Config, ServiceConfig
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.streaming import (ColumnarStreamPipeline,
                                          DurableIngestQueue, StreamPipeline)
from reporter_tpu_torch.streaming.__main__ import main
from reporter_tpu_torch.tiles.compiler import compile_network
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120.0       # the bound of a worker subprocess (s)


@pytest.fixture(scope="module")
def worker_env(tmp_path_factory):
    d = tmp_path_factory.mktemp("worker")
    ts = compile_network(generate_city("tiny"),
                         CompilerParams(osmlr_max_length=250.0))
    tiles = ts.save(str(d / "tiles.npz"))
    fleet = synthesize_fleet(ts, 4, num_points=60, seed=9)
    return {"dir": d, "tiles": tiles, "fleet": fleet, "ts": ts}


def _records(fleet):
    return [{"uuid": p.uuid, "lat": float(la), "lon": float(lo),
             "time": float(t)}
            for p in fleet for (lo, la), t in zip(p.lonlat, p.times)]


def _stage(path, fleet):
    q = DurableIngestQueue(path, Config().streaming.num_partitions)
    for r in _records(fleet):
        q.append(r)
    ends = [q.end_offset(p) for p in range(q.num_partitions)]
    q.close()
    return ends


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


class _Sink(BaseHTTPRequestHandler):
    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        with self.server.lock:
            self.server.bodies.append(json.loads(body))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture
def datastore():
    """A local datastore on a free port: (url, the POSTed bodies)."""
    srv = HTTPServer(("127.0.0.1", 0), _Sink)
    srv.bodies, srv.lock = [], threading.Lock()
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/store", srv.bodies
    srv.shutdown()
    srv.server_close()
    th.join(WAIT)


def _run(args, url, stdin=None):
    env = dict(os.environ, PYTHONPATH=ROOT, DATASTORE_URL=url)
    return subprocess.run(
        [sys.executable, "-m", "reporter_tpu_torch.streaming", *args,
         "--device", "cpu"], input=stdin, capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=WAIT)


def _rows(bodies):
    return sorted(json.dumps(r, sort_keys=True)
                  for b in bodies for r in b.get("reports", ()))


def test_worker_subprocess_drains_broker_like_in_process(worker_env,
                                                         datastore):
    url, bodies = datastore
    d = worker_env["dir"]
    broker, ckpt = str(d / "sub_broker"), str(d / "sub.ckpt")
    ends = _stage(broker, worker_env["fleet"])
    shutil.copytree(broker, broker + "_copy")
    proc = _run(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--checkpoint", ckpt, "--exit-on-drain"], url)
    assert proc.returncode == 0, proc.stderr
    out = _last_json(proc.stdout)
    assert out["lag"] == 0 and out["committed"] == ends
    assert out["reports"] > 0 and out["published"] == out["reports"]
    assert out["lease"] is None
    assert set(out["slo"]) == {"active", "alerts_total", "ticks",
                               "budget_remaining"}
    assert os.path.exists(ckpt + ".npz")
    assert "ready" in proc.stderr and "drained in" in proc.stderr
    # the same pipeline in-process over a copy of the directory
    cap = []
    q = DurableIngestQueue(broker + "_copy")
    pipe = StreamPipeline(worker_env["ts"], Config(service=ServiceConfig(
        datastore_url="http://x/")), queue=q,
        transport=lambda u, b: cap.append(json.loads(b)) or 200,
        device="cpu")
    while True:
        n = pipe.step()
        if pipe._consumed == ends and n == 0:
            break
    pipe.drain()
    q.close()
    assert _rows(bodies) == _rows(cap) and _rows(cap)
    assert sum(1 for b in bodies if "histograms" in b) == 1


def test_worker_subprocess_columnar_stdin_csv(worker_env, datastore):
    url, bodies = datastore
    broker = str(worker_env["dir"] / "sub_col")
    lines = "".join(f"{p.uuid},{la},{lo},{t}\n"
                    for p in worker_env["fleet"]
                    for (lo, la), t in zip(p.lonlat, p.times))
    proc = _run(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--stdin-format", "csv", "--columnar", "--exit-on-drain"],
                url, stdin=lines)
    assert proc.returncode == 0, proc.stderr
    out = _last_json(proc.stdout)
    assert out["lag"] == 0 and out["reports"] > 0 and out["malformed"] == 0
    assert out["dispatch_timeouts"] == 0
    assert os.path.exists(os.path.join(broker, "p0.colog"))
    assert len(_rows(bodies)) == out["published"] == out["reports"]


def test_worker_subprocess_stdin_json(worker_env, datastore):
    url, bodies = datastore
    lines = "".join(json.dumps(r) + "\n"
                    for r in _records(worker_env["fleet"]))
    lines += "not json\n"
    proc = _run(["--tiles", worker_env["tiles"], "--broker-dir",
                 str(worker_env["dir"] / "sub_json"), "--stdin-format",
                 "json", "--exit-on-drain"], url, stdin=lines)
    assert proc.returncode == 0, proc.stderr
    out = _last_json(proc.stdout)
    assert out["lag"] == 0 and out["reports"] > 0
    assert "1 dropped" in proc.stderr


def _main(args, capsys):
    assert main([*args, "--device", "cpu"]) == 0
    return _last_json(capsys.readouterr().out)


def test_worker_consumes_broker_and_checkpoints(worker_env, capsys):
    d = worker_env["dir"]
    broker, ckpt = str(d / "broker"), str(d / "worker.ckpt")
    _stage(broker, worker_env["fleet"])
    out = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--checkpoint", ckpt, "--max-steps", "3"], capsys)
    assert out["lag"] == 0 and out["reports"] > 0
    # restart: restores the checkpoint, nothing new to replay
    out2 = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                  "--checkpoint", ckpt, "--max-steps", "1"], capsys)
    assert out2["lag"] == 0 and out2["reports"] == 0


def test_worker_partition_subset(worker_env, capsys):
    d = worker_env["dir"]
    broker = str(d / "broker3")
    ends = _stage(broker, worker_env["fleet"])
    P = Config().streaming.num_partitions
    total = 0
    for subset in ([0, 1], list(range(2, P))):
        out = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                     "--max-steps", "2", "--partitions",
                     *map(str, subset)], capsys)
        assert out["lag"] == 0
        assert [out["committed"][p] for p in subset] == \
            [ends[p] for p in subset]
        total += out["reports"]
    assert total > 0


def test_worker_columnar_over_record_broker_cross_checkpoint(worker_env,
                                                             capsys):
    d = worker_env["dir"]
    broker, ckpt = str(d / "broker4"), str(d / "col.ckpt")
    _stage(broker, worker_env["fleet"])
    out = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--checkpoint", ckpt, "--max-steps", "3", "--columnar"],
                capsys)
    assert out["lag"] == 0 and out["reports"] > 0
    # the dict worker restarts on the columnar checkpoint: one schema
    out2 = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                  "--checkpoint", ckpt, "--max-steps", "1"], capsys)
    assert out2["lag"] == 0 and out2["reports"] == 0


def test_worker_columnar_broker_autodetect(worker_env, capsys, monkeypatch):
    broker = str(worker_env["dir"] / "broker5")
    lines = "".join(f"{p.uuid},{la},{lo},{t}\n"
                    for p in worker_env["fleet"]
                    for (lo, la), t in zip(p.lonlat, p.times))
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    out = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--max-steps", "2", "--stdin-format", "csv", "--columnar"],
                capsys)
    assert out["lag"] == 0 and out["reports"] > 0
    assert os.path.exists(os.path.join(broker, "p0.colog"))
    # the dict worker over the columnar broker: the format is read from
    # the directory, and the columnar broker's dict poll serves it
    out2 = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                  "--max-steps", "1"], capsys)
    assert out2["lag"] == 0


def test_worker_exit_json_keys(worker_env, capsys, monkeypatch):
    broker = str(worker_env["dir"] / "broker_exitjson")
    _stage(broker, worker_env["fleet"])
    out = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--max-steps", "2", "--member", "w-test"], capsys)
    # the process link-health sampler's window (the JAX worker's keys):
    # a CPU worker has no host-card path, so no reading
    assert set(out["link"]) == {"rtt_ms", "mbps", "mood", "samples",
                                "probes", "dead_probes"}
    assert out["link"]["rtt_ms"] is None and out["link"]["mbps"] is None
    assert out["link"]["mood"] in (None, "cpu")
    monkeypatch.setenv("RTPU_LINK_PROBE", "0")
    off = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--max-steps", "1", "--member", "w-test"], capsys)
    assert off["link"] == {"rtt_ms": None, "mbps": None, "mood": None,
                           "samples": 0, "probes": 0, "dead_probes": 0}
    for key in ("enabled", "window_waves", "drifted", "drift_events",
                "empty_match_rate", "violation_rate"):
        assert key in out["quality"], key
    for key in ("steps", "reports", "committed", "faults", "lease", "slo",
                "lag", "published", "malformed", "hist_rows", "qhist_rows",
                "buffered_points", "traced_records"):
        assert key in out, key
    assert out["member"] == "w-test" and out["faults"] is None


def test_columnar_pipeline_over_durable_columnar_copy(worker_env, tmp_path):
    """The columnar pipeline over a copied columnar log equals the one
    over the original: the copy is the log."""
    from reporter_tpu_torch.streaming import (DurableColumnarIngestQueue,
                                              pack_records)

    recs = _records(worker_env["fleet"])
    a = str(tmp_path / "a")
    q = DurableColumnarIngestQueue(a)
    for lo in range(0, len(recs), 50):
        q.append_columns(pack_records(recs[lo:lo + 50]))
    q.close()
    shutil.copytree(a, a + "_copy")
    rows = []
    for path in (a, a + "_copy"):
        cap = []
        qc = DurableColumnarIngestQueue(path)
        pipe = ColumnarStreamPipeline(
            worker_env["ts"], Config(service=ServiceConfig(
                datastore_url="http://x/")), queue=qc,
            transport=lambda u, b, c=cap: c.append(json.loads(b)) or 200,
            device="cpu")
        pipe.step()
        pipe.drain()
        pipe.close()
        qc.close()
        rows.append(_rows(cap))
    assert rows[0] == rows[1] and rows[0]


# ---------------------------------------------------------------------------
# the topology's flags: leases, the snapshot spool, the SLO plane


def test_lease_dir_drains_the_broker(worker_env, tmp_path, capsys):
    """One leased worker takes every orphaned partition from a fresh
    table, drains the broker globally, and hands everything back at
    exit with the table's floors at the end offsets."""
    from reporter_tpu_torch.distributed.lease import LeaseTable

    broker, leases = str(tmp_path / "b"), str(tmp_path / "leases")
    ends = _stage(broker, worker_env["fleet"])
    out = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--lease-dir", leases, "--lease-ttl", "30",
                 "--member", "w-lease", "--exit-on-drain"], capsys)
    assert out["lease"] == {"acquired": 4, "lost": 0, "revoked": 4,
                            "stale_commits": 0, "discarded_points": 0}
    assert out["lag"] == 0 and out["committed"] == ends
    assert out["reports"] > 0
    table = LeaseTable(leases)
    assert table.floors() == ends
    st = table.state()
    assert all(ent["owner"] is None for ent in st["partitions"].values())
    assert "w-lease" in st["members"]


def test_snapshot_dir_is_read_by_the_jax_package(worker_env, tmp_path,
                                                 capsys, monkeypatch):
    from reporter_tpu.distributed import aggregate as jaggregate

    monkeypatch.setenv("RTPU_SLO_SCALE", "0.01")
    broker, snaps = str(tmp_path / "b"), str(tmp_path / "snaps")
    _stage(broker, worker_env["fleet"])
    out = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--snapshot-dir", snaps, "--snapshot-interval", "0",
                 "--member", "w-snap", "--exit-on-drain"], capsys)
    doc = jaggregate.read_snapshot(jaggregate.snapshot_path(snaps, "w-snap"))
    assert doc is not None and doc["member"] == "w-snap"
    assert doc["seq"] >= 2 and doc["stats"]["lag"] == 0
    assert doc["stats"]["published"] == out["published"]
    assert doc["metrics"]["counters"]["probes"] > 0
    assert set(jaggregate.load_dir(snaps)) == {"w-snap"}
    merged = jaggregate.merge_registry(jaggregate.load_dir(snaps))
    assert merged.value("traces") == doc["metrics"]["counters"]["traces"]
    assert out["slo"]["ticks"] >= 1


def test_default_exit_slo_block_has_the_jax_keys(worker_env, tmp_path,
                                                 capsys, monkeypatch):
    from reporter_tpu.obs.slo import SloEvaluator as JSloEvaluator
    from reporter_tpu.utils.metrics import MetricsRegistry as JRegistry

    monkeypatch.delenv("RTPU_SLO", raising=False)
    broker = str(tmp_path / "b")
    _stage(broker, worker_env["fleet"][:2])
    out = _main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--exit-on-drain"], capsys)
    want = JSloEvaluator(JRegistry(), enabled_override=True)
    want.tick(force=True)
    assert set(out["slo"]) == set(want.exit_block())
    assert set(out["slo"]["budget_remaining"]) == \
        set(want.exit_block()["budget_remaining"])
    assert out["slo"]["ticks"] >= 1 and out["lease"] is None
    # the sweep's launches: a CPU matcher launches no kernel
    assert out["launches"] == {} and out["plan"] is None
    assert out["ready_unix_s"] <= out["exit_unix_s"]


def test_slo_gate_typo_raises_like_jax(worker_env, tmp_path, monkeypatch):
    monkeypatch.setenv("RTPU_SLO", "bogus")
    broker = str(tmp_path / "b")
    _stage(broker, worker_env["fleet"][:1])
    with pytest.raises(ValueError):
        main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
              "--max-steps", "1", "--device", "cpu"])
    monkeypatch.setenv("RTPU_SLO", "0")          # disabled: runs, no block
    assert main(["--tiles", worker_env["tiles"], "--broker-dir", broker,
                 "--max-steps", "1", "--device", "cpu"]) == 0


@pytest.mark.parametrize("extra", [["--partitions", "0"], ["--columnar"]])
def test_lease_dir_refusals_are_the_jax_parser_errors(worker_env, tmp_path,
                                                      capsys, extra):
    """--lease-dir with --partitions, and with --columnar (lease mode is
    dict-only): the JAX parser's usage error, exit status 2, before any
    work."""
    from reporter_tpu.streaming.__main__ import main as jmain

    args = ["--tiles", worker_env["tiles"], "--broker-dir",
            str(tmp_path / "b"), "--lease-dir", str(tmp_path / "l"), *extra]
    errs = []
    for fn in (main, jmain):
        with pytest.raises(SystemExit) as ei:
            fn(args)
        assert ei.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0].split(": ", 1)[1] == errs[1].split(": ", 1)[1]
    assert "--lease-dir" in errs[0]
    assert not os.path.exists(tmp_path / "b")       # refused before work
