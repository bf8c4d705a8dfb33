"""Topology supervisor: N worker subprocesses run, watched, restarted and
observed as one unit.

Counterpart: reporter_tpu/distributed/supervisor.py (``MemberSpec``,
``ReportSink``, ``worker_member``, ``Supervisor``), with the same
behaviour, events and endpoints; its workers are the port's
``python -m reporter_tpu_torch.streaming``. The parent an operator runs
over DISTRIBUTED.md's scale-out design (several workers over one broker
directory, disjoint partition subsets):

  - spawns the members (N worker subprocesses) plus a fake datastore
    sink (``ReportSink``) and its own WSGI face, as one unit with one
    workdir;
  - tails each member's spooled metrics snapshot
    (distributed/aggregate.py; workers write them atomically when
    ``RTPU_TOPO_SNAPSHOT_DIR`` is set: no inter-process HTTP, so a
    wedged member cannot stall the scrape);
  - detects member DEATH (a SIGKILL, an OOM kill, a crash: any nonzero
    or signal exit while not asked to stop), counts it, stamps it into
    the topology event log (``topology_events.jsonl``), dumps ONE
    flight-recorder post-mortem per death, and restarts the member per
    policy (``max_restarts`` each);
  - serves ``/metrics`` (the merged exposition: counters summed, labeled
    series unioned, fixed-bucket histograms summed bucket-wise, gauges
    worker-labeled), ``/health`` (per-member liveness, restart counts,
    snapshot lag) and ``/slo`` over stdlib WSGI.

Its own bookkeeping publishes into its own registry (``topo_*``), merged
into the exposition as member "supervisor".

Elastic membership: with a ``lease_dir`` the supervisor drives the
partition-lease rebalancer (distributed/lease.py) from its monitor loop:
a join (``add_member``), a leave (``remove_member``) or a lease expiry
orphans partitions, and the planner reassigns them to the least-loaded
live workers. All lease-table I/O runs outside the supervisor's locks.

SLO plane: the supervisor evaluates the same
:data:`~reporter_tpu_torch.obs.slo.DEFAULT_SLOS` the workers do, over the
merged export: burn is linear over counters and buckets, so the
topology's burn is one number equal to the per-worker sum. Its alert
ledger is ``alerts.jsonl`` in the workdir.

The member table rides ``supervisor.members``, the sink counter
``supervisor.sink``, the event log the shared ``eventlog.append``; all
are leaf locks: spawning, post-mortems, gauge publication and snapshot
merging run outside them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any

from reporter_tpu_torch.distributed import aggregate
from reporter_tpu_torch.obs import slo as obs_slo
from reporter_tpu_torch.utils import eventlog, locks, metrics, tracing

__all__ = ["MemberSpec", "Supervisor", "ReportSink", "worker_member"]

# env keys the supervisor sets for its workers (documented in README's
# env table; streaming/__main__.py reads them as CLI-flag twins)
ENV_SNAPSHOT_DIR = "RTPU_TOPO_SNAPSHOT_DIR"
ENV_SNAPSHOT_INTERVAL = "RTPU_TOPO_SNAPSHOT_INTERVAL_S"
ENV_MEMBER = "RTPU_TOPO_MEMBER"


@dataclasses.dataclass
class MemberSpec:
    """One supervised subprocess: the command line plus env overrides
    merged over the supervisor's base env at every (re)spawn."""

    name: str
    cmd: "list[str]"
    env: "dict[str, str] | None" = None


class _Member:
    """Runtime state of one member (guarded by supervisor.members)."""

    __slots__ = ("spec", "proc", "deaths", "restarts", "clean_exits",
                 "started_at", "stdout_tail", "exit_report", "stopping",
                 "respawning")

    def __init__(self, spec: MemberSpec):
        self.spec = spec
        self.proc: "subprocess.Popen | None" = None
        self.deaths = 0
        self.restarts = 0
        self.clean_exits = 0
        self.started_at = 0.0
        self.stdout_tail: "str" = ""
        self.exit_report: "dict | None" = None
        self.stopping = False
        # death claimed, replacement not yet spawned — drained() must
        # read this window as NOT drained
        self.respawning = False


class ReportSink:
    """The fake datastore of a topology: a threaded HTTP sink counting
    every POSTed report row (and keeping the multiset key the recovery
    accounting uses), so workers publish somewhere real without an
    external service. ``url`` is what DATASTORE_URL gets. ``t_first`` /
    ``t_last`` are ``time.perf_counter`` stamps."""

    def __init__(self):
        from collections import Counter
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._lock = locks.named_lock("supervisor.sink")
        self.reports: "Any" = Counter()
        self.rows = 0
        self.posts = 0
        self.t_first: "float | None" = None
        self.t_last: "float | None" = None
        sink = self

        class _H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    body = {}
                now = time.perf_counter()
                with sink._lock:
                    for r in body.get("reports", ()):
                        key = (r.get("id"), r.get("next_id"),
                               round(float(r.get("t0", 0.0)), 2),
                               round(float(r.get("t1", 0.0)), 2))
                        sink.reports[key] += 1
                        sink.rows += 1
                    sink.posts += 1
                    if sink.t_first is None:
                        sink.t_first = now
                    sink.t_last = now
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):      # keep supervisor output clean
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}/"

    def stats(self) -> dict:
        with self._lock:
            return {"rows": self.rows, "posts": self.posts,
                    "t_first": self.t_first, "t_last": self.t_last}

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def worker_member(name: str, tiles: str, broker_dir: str, workdir: str,
                  partitions: "list[int] | None" = None,
                  columnar: bool = False,
                  config: "str | None" = None,
                  exit_on_drain: bool = True,
                  extra_args: "list[str] | None" = None,
                  env: "dict[str, str] | None" = None,
                  lease_dir: "str | None" = None,
                  lease_ttl_s: "float | None" = None) -> MemberSpec:
    """MemberSpec for one ``streaming.__main__`` matcher worker of the
    port, the standard member of a topology. Each worker gets its own
    checkpoint under the workdir (restarts replay from its committed
    offsets). The worker's device comes from its own ``--device`` flag
    through ``extra_args`` (``cuda`` when absent). With ``lease_dir`` the worker takes its
    partitions from the lease table instead of a static ``partitions``
    list (the two are mutually exclusive)."""
    if lease_dir and partitions is not None:
        raise ValueError("lease_dir and a static partitions list are "
                         "mutually exclusive (the lease table owns "
                         "assignment)")
    cmd = [sys.executable, "-m", "reporter_tpu_torch.streaming",
           "--tiles", tiles, "--broker-dir", broker_dir,
           "--checkpoint", os.path.join(workdir, f"{name}.ckpt"),
           "--checkpoint-interval", "0.5", "--poll-interval", "0.01"]
    if columnar:
        cmd.append("--columnar")
    if config:
        cmd += ["--config", config]
    if exit_on_drain:
        cmd.append("--exit-on-drain")
    if partitions is not None:
        cmd += ["--partitions"] + [str(p) for p in partitions]
    if lease_dir:
        cmd += ["--lease-dir", lease_dir, "--member", name]
        if lease_ttl_s is not None:
            cmd += ["--lease-ttl", str(lease_ttl_s)]
    cmd += list(extra_args or ())
    return MemberSpec(name=name, cmd=cmd, env=env)


class Supervisor:
    """Spawn, watch, restart, aggregate. See the module docstring."""

    def __init__(self, members: "list[MemberSpec]", workdir: str,
                 restart: bool = True, max_restarts: int = 2,
                 poll_s: float = 0.05,
                 start_sink: bool = True,
                 base_env: "dict[str, str] | None" = None,
                 lease_dir: "str | None" = None,
                 rebalance_interval_s: float = 0.25):
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.snapshot_dir = os.path.join(workdir, "snapshots")
        self.events_path = os.path.join(workdir, "topology_events.jsonl")
        self.restart = bool(restart)
        self.max_restarts = int(max_restarts)
        self.poll_s = float(poll_s)
        self._members_lock = locks.named_lock("supervisor.members")
        self._events = eventlog.EventLog(self.events_path)
        self._members: "dict[str, _Member]" = {
            s.name: _Member(s) for s in members}
        self._base_env = dict(base_env or {})
        self._stop = threading.Event()
        self._stopped = False
        self._monitor: "threading.Thread | None" = None
        self._http_server = None
        self.sink = ReportSink() if start_sink else None
        # the supervisor's own registry: merged into the exposition as
        # member "supervisor", so liveness/restart counters arrive in
        # the same scrape as the fleet series
        self.metrics = metrics.MetricsRegistry()
        self.started_at: "float | None" = None
        # Elastic membership: the lease table must already
        # exist (its creator fixes num_partitions); opening it here
        # fails fast on a misconfigured dir. All table I/O runs outside
        # the supervisor locks.
        self._lease_table = None
        self._rebalance_interval = float(rebalance_interval_s)
        self._last_rebalance = 0.0
        if lease_dir is not None:
            from reporter_tpu_torch.distributed.lease import LeaseTable
            self._lease_table = LeaseTable(lease_dir)
        # Round-24 SLO plane: the same committed specs the workers run,
        # evaluated over the MERGED export — topology-wide burn is one
        # number. sample_gauges=False: members already folded their own
        # gauge levels into the synthetic sample counters, and the merge
        # carries them; sampling the worker-labeled merged gauges here
        # would double-count.
        self.alerts_path = os.path.join(workdir, "alerts.jsonl")
        self.slo: "obs_slo.SloEvaluator | None" = None
        if obs_slo.enabled():
            self.slo = obs_slo.SloEvaluator(
                self.metrics,
                source=lambda: self.merged_registry().export(),
                ledger=eventlog.EventLog(self.alerts_path),
                sample_gauges=False)

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "Supervisor":
        self.started_at = time.time()
        self._event("topology_start",
                    members=sorted(self._members),
                    restart=self.restart, max_restarts=self.max_restarts)
        for name in sorted(self._members):
            self._spawn(name, reason="start")
        self._publish_gauges()
        self._stop.clear()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="topology-supervisor")
        self._monitor.start()
        return self

    def _member_env(self, spec: MemberSpec) -> dict:
        env = dict(os.environ)
        # a `python -m reporter_tpu_torch.streaming` member must import
        # the package whatever the supervisor's cwd: prepend the
        # directory that holds this very package
        import reporter_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(reporter_tpu_torch.__file__)))
        env["PYTHONPATH"] = (pkg_root + os.pathsep
                             + env.get("PYTHONPATH", "")).rstrip(
                                 os.pathsep)
        env[ENV_SNAPSHOT_DIR] = self.snapshot_dir
        env[ENV_MEMBER] = spec.name
        env.setdefault(ENV_SNAPSHOT_INTERVAL, "0.5")
        if self.sink is not None:
            # SET, not setdefault: when the supervisor owns a sink, an
            # inherited operator DATASTORE_URL must not silently
            # redirect the topology's reports to a REAL datastore
            # (base_env/spec.env below stay the deliberate overrides)
            env["DATASTORE_URL"] = self.sink.url
        env.update(self._base_env)
        env.update(spec.env or {})
        return env

    def _spawn(self, name: str, reason: str) -> None:
        """(Re)spawn one member. Popen is a patched blocking entry
        point: it must never run under a named lock, so the
        table update happens after the process exists. A respawn that
        races stop() (the monitor mid-Popen while the caller tears
        down) must not leak a live worker nothing will ever terminate:
        the stopped flag is re-checked under the lock AFTER the Popen,
        and a loser child is killed instead of installed."""
        m = self._members[name]
        if self._stopped or m.stopping:
            with self._members_lock:
                m.respawning = False
            return
        proc = subprocess.Popen(
            m.spec.cmd, env=self._member_env(m.spec),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        with self._members_lock:
            if self._stopped or m.stopping:
                m.respawning = False
                install = False
            else:
                m.proc = proc
                m.started_at = time.time()
                m.respawning = False
                install = True
        if not install:
            proc.kill()
            proc.communicate()
            self._event("member_spawn_aborted", member=name,
                        reason="stopping")
            return
        self._event("member_spawn", member=name, pid=proc.pid,
                    reason=reason)

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_s)

    def poll_once(self) -> None:
        """One supervision pass (the monitor thread's body, ALSO called
        directly by deterministic tests and smoke runs while the
        monitor runs): reap exits, classify death-vs-clean-exit,
        restart per policy, refresh gauges. Exits are CLAIMED under the
        members lock (``m.proc is proc`` then cleared) so two
        concurrent passes can never double-count one death, spawn two
        replacements onto the same partitions, or double-dump the
        post-mortem."""
        with self._members_lock:
            items = list(self._members.items())
        respawn: "list[str]" = []
        for name, m in items:
            proc = m.proc
            if proc is None or proc.poll() is None:
                continue
            died = proc.returncode != 0 and not m.stopping
            with self._members_lock:
                if m.proc is not proc:
                    continue            # another pass claimed this exit
                m.proc = None
                if died and self.restart \
                        and m.restarts < self.max_restarts:
                    m.respawning = True
            rc = proc.returncode
            tail = ""
            if proc.stdout is not None:
                try:
                    tail = proc.stdout.read() or ""
                except (OSError, ValueError):
                    tail = ""
                proc.stdout.close()
            report = _last_json_line(tail)
            with self._members_lock:
                m.stdout_tail = tail[-4096:]
                if report is not None:
                    m.exit_report = report
                if died:
                    m.deaths += 1
                    allow = m.respawning
                    if allow:
                        m.restarts += 1
                else:
                    m.clean_exits += 1
                    allow = False
            # event log + post-mortem + counters OUTSIDE the table lock
            if died:
                self.metrics.count("topo_deaths")
                self._event("member_death", member=name, pid=proc.pid,
                            returncode=rc, will_restart=allow,
                            uptime_s=round(time.time() - m.started_at, 3))
                # one death transition, one flight-recorder dump (the
                # one-event-one-dump rule); bounded + no-op unless
                # tracing is configured with a dump dir
                tracing.post_mortem("worker_death", failing=name,
                                    member=name, returncode=rc)
                if allow:
                    respawn.append(name)
                else:
                    self._event("restart_budget_exhausted", member=name,
                                deaths=m.deaths, restarts=m.restarts)
            else:
                self._event("member_exit", member=name, pid=proc.pid,
                            returncode=rc)
        for name in respawn:
            self.metrics.count("topo_restarts")
            self._spawn(name, reason="restart")
        self._maybe_rebalance()
        if self.slo is not None:
            self.slo.tick()         # self-throttled; outside all locks
        self._publish_gauges()

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful teardown: SIGTERM members (their CLI checkpoints and
        drains on it), join, stop the monitor/sink/HTTP face.
        IDEMPOTENT — error-path finallys may call it after a normal
        stop: the repeat is a safe no-op that still leaves an audit
        event (silent no-ops hid double-teardown
        bugs)."""
        if self._stopped:
            self._event("stop_noop")
            return
        self._stopped = True
        with self._members_lock:
            items = list(self._members.items())
            for _, m in items:
                m.stopping = True
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=max(1.0, self.poll_s * 4))
        for name, m in items:
            proc = m.proc
            if proc is None:
                continue
            proc.terminate()
            try:
                out, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            report = _last_json_line(out or "")
            with self._members_lock:
                m.proc = None
                m.stdout_tail = (out or "")[-4096:]
                if report is not None:
                    m.exit_report = report
        self._event("topology_stop")
        if self._http_server is not None:
            self._http_server.shutdown()
            self._http_server.server_close()
            self._http_server = None
        if self.sink is not None:
            self.sink.close()

    # ---- elastic membership ---------------------------------------------

    def add_member(self, spec: MemberSpec, reason: str = "join") -> None:
        """Join a new member to a RUNNING topology. With a lease table
        the newcomer heartbeats, the next rebalance pass revokes
        surplus partitions toward it, and it picks them up at their
        committed floors — scale-out under live load."""
        if self._stopped:
            raise RuntimeError("supervisor is stopped")
        with self._members_lock:
            if spec.name in self._members:
                raise ValueError(f"member {spec.name!r} already exists")
            self._members[spec.name] = _Member(spec)
        self._event("member_join", member=spec.name)
        self._spawn(spec.name, reason=reason)
        self._publish_gauges()

    def remove_member(self, name: str,
                      timeout: float = 30.0) -> "dict | None":
        """Graceful leave: SIGTERM the member (its CLI hands off leased
        partitions and checkpoints on it), wait, and let the normal
        claim path reap the exit. The member's history stays in the
        table. No-op (with an event) for an unknown name. Returns the
        member's exit report, if it printed one."""
        with self._members_lock:
            m = self._members.get(name)
            if m is not None:
                m.stopping = True
                proc = m.proc
        if m is None:
            self._event("member_remove_noop", member=name)
            return None
        self._event("member_leave", member=name)
        if proc is not None and proc.poll() is None:
            proc.terminate()
        self.wait_member(name, timeout=timeout)
        self.poll_once()
        self._publish_gauges()
        with self._members_lock:
            return m.exit_report

    def _maybe_rebalance(self) -> None:
        if self._lease_table is None or self._stopped:
            return
        now = time.monotonic()
        if now - self._last_rebalance < self._rebalance_interval:
            return
        self._last_rebalance = now
        self.rebalance_once()

    def rebalance_once(self) -> dict:
        """One planner pass over the lease table (public so tests and
        smoke runs can force one deterministically). The table
        transaction takes its own leaf lock and the planner is pure;
        the members lock is held only to snapshot the process table.
        Members whose heartbeat is older than 2× the lease TTL read as
        dead — and the supervisor's own process table SHORTENS that:
        a member it watched die stops receiving assignments
        immediately, not at heartbeat expiry."""
        table = self._lease_table
        if table is None:
            return {}
        from reporter_tpu_torch.distributed.lease import plan_rebalance
        with self._members_lock:
            running = {name for name, m in self._members.items()
                       if m.proc is not None and m.proc.poll() is None}
        st = table.state()
        now = table.clock()
        orphans = sum(1 for ent in st["partitions"].values()
                      if ent["owner"] is None
                      or now > float(ent["expires"]))
        self.metrics.gauge("topo_lease_orphans", float(orphans))
        plan = plan_rebalance(st, now, member_ttl_s=table.ttl_s * 2.0,
                              running=running)
        if plan["assign"] or plan["revoke"] or plan["clear"]:
            table.apply_plan(plan)
        if plan["assign"] or plan["revoke"]:
            self.metrics.count("topo_rebalances")
            self._event(
                "rebalance",
                assign={str(p): m
                        for p, m in sorted(plan["assign"].items())},
                revoke={str(p): m
                        for p, m in sorted(plan["revoke"].items())})
        return plan

    # ---- chaos hooks -----------------------------------------------------

    def kill_member(self, name: str) -> "int | None":
        """A REAL SIGKILL (no drain, no checkpoint flush) — the
        topology leg's mid-soak fault. The monitor sees an unexpected
        death and runs the normal detect→count→post-mortem→restart
        path; nothing is pre-acknowledged here. Killing an unknown or
        already-exited member is a safe no-op that records an event."""
        with self._members_lock:
            m = self._members.get(name)
            proc = m.proc if m is not None else None
        if proc is None or proc.poll() is not None:
            self._event("kill_noop", member=name)
            return None
        proc.kill()
        return proc.pid

    def wait_member(self, name: str, timeout: float = 60.0) -> bool:
        """Block until a member's process object exits (poll-based; the
        monitor thread still owns the reaping)."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            with self._members_lock:
                m = self._members.get(name)
                proc = m.proc if m is not None else None
            if proc is None or proc.poll() is not None:
                return True
            time.sleep(0.01)
        return False

    def drained(self) -> bool:
        """Every member is done (no live process, no pending restart) —
        the topology's natural end under --exit-on-drain. A member
        whose death is claimed-but-not-respawned, or whose exited
        process hasn't been reaped yet but WILL be restarted, reads as
        NOT drained: a caller tearing down in that window would race
        the monitor's replacement spawn."""
        with self._members_lock:
            for m in self._members.values():
                if m.respawning:
                    return False
                proc = m.proc
                if proc is None:
                    continue
                if proc.poll() is None:
                    return False        # still running
                if proc.returncode != 0 and not m.stopping \
                        and self.restart \
                        and m.restarts < self.max_restarts:
                    return False        # unreaped death, restart pending
            return True

    # ---- observability ---------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        """Append one line to the topology event log (the shared
        EventLog spelling: append+flush, torn-tail truncation at
        reopen)."""
        self._events.append({"t": round(time.time(), 3), "event": kind,
                             **fields})

    def events(self) -> "list[dict]":
        return self._events.read()

    def _publish_gauges(self) -> None:
        with self._members_lock:
            alive = sum(1 for m in self._members.values()
                        if m.proc is not None and m.proc.poll() is None)
            total = len(self._members)
        self.metrics.gauge("topo_members", total)
        self.metrics.gauge("topo_members_alive", alive)

    def exit_reports(self) -> "dict[str, dict | None]":
        """member → the last JSON line its most recent incarnation
        printed at exit (the worker CLI's stats report), or None while
        alive / when it died without one (a SIGKILLed member's report
        is its RESTARTED incarnation's)."""
        with self._members_lock:
            return {name: m.exit_report
                    for name, m in self._members.items()}

    def snapshots(self) -> "dict[str, dict]":
        return aggregate.load_dir(self.snapshot_dir)

    def merged_registry(self):
        """Fleet registry = member snapshots + the supervisor's own
        export (member "supervisor")."""
        snaps = self.snapshots()
        exports = {m: (doc.get("metrics") or {})
                   for m, doc in snaps.items()}
        exports["supervisor"] = self.metrics.export()
        return metrics.merge_exports(exports)

    def metrics_text(self) -> str:
        return self.merged_registry().render_prometheus()

    def health(self) -> dict:
        snaps = self.snapshots()
        members: "dict[str, dict]" = {}
        with self._members_lock:
            items = list(self._members.items())
        now = time.time()
        snap_health = aggregate.member_health(snaps, now=now)
        for name, m in items:
            proc = m.proc
            members[name] = {
                "alive": bool(proc is not None and proc.poll() is None),
                "pid": (proc.pid if proc is not None else None),
                "deaths": m.deaths,
                "restarts": m.restarts,
                "clean_exits": m.clean_exits,
                **snap_health.get(name, {"snapshot_age_s": None,
                                         "seq": None}),
            }
        out: "dict[str, Any]" = {
            "status": ("ok" if all(v["alive"] or v["clean_exits"]
                                   for v in members.values())
                       else "degraded"),
            "members": members,
            "deaths_total": int(self.metrics.value("topo_deaths")),
            "restarts_total": int(self.metrics.value("topo_restarts")),
            "uptime_seconds": (None if self.started_at is None
                               else round(now - self.started_at, 3)),
        }
        if self.sink is not None:
            out["sink"] = self.sink.stats()
        if self.slo is not None:
            out["slo"] = self.slo.health()
        return out

    # ---- WSGI face -------------------------------------------------------

    def wsgi(self, environ: dict, start_response):
        """The supervisor's observability endpoint: GET /metrics (the
        merged Prometheus exposition) and GET /health (liveness +
        restart counts + snapshot lag)."""
        path = environ.get("PATH_INFO", "/")
        if environ.get("REQUEST_METHOD") != "GET":
            return _respond(start_response, "405 Method Not Allowed",
                            b"{}", "application/json")
        if path == "/metrics":
            return _respond(start_response, "200 OK",
                            self.metrics_text().encode(),
                            "text/plain; version=0.0.4")
        if path == "/health":
            return _respond(start_response, "200 OK",
                            json.dumps(self.health()).encode(),
                            "application/json")
        if path == "/slo":
            body = (self.slo.status() if self.slo is not None
                    else {"enabled": False})
            return _respond(start_response, "200 OK",
                            json.dumps(body).encode(),
                            "application/json")
        return _respond(start_response, "404 Not Found", b"{}",
                        "application/json")

    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Start the WSGI face on a daemon thread; returns the server
        (its bound port at ``server.server_address[1]``)."""
        from wsgiref.simple_server import (WSGIRequestHandler, WSGIServer,
                                           make_server)

        from socketserver import ThreadingMixIn

        class _Srv(ThreadingMixIn, WSGIServer):
            daemon_threads = True

        class _Quiet(WSGIRequestHandler):
            def log_message(self, *a):
                pass

        self._http_server = make_server(host, port, self.wsgi,
                                        server_class=_Srv,
                                        handler_class=_Quiet)
        threading.Thread(target=self._http_server.serve_forever,
                         daemon=True).start()
        return self._http_server


def _last_json_line(text: str) -> "dict | None":
    for line in reversed(text.strip().splitlines()):
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(doc, dict):
            return doc
    return None


def _respond(start_response, status: str, body: bytes, ctype: str):
    start_response(status, [("Content-Type", ctype),
                            ("Content-Length", str(len(body)))])
    return [body]
