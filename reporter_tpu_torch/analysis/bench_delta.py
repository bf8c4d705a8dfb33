"""Run-over-run diff of two ``chip_smoke.py`` logs: the port's regression
sentinel.

    python -m reporter_tpu_torch.analysis.bench_delta old.log new.log \\
        [--threshold 10]

Counterpart: reporter_tpu/analysis/bench_delta.py, which diffs two
BENCH_DETAIL composites. The port commits no capture: its numbers are
the phase lines ``chip_smoke.py`` prints, ``[tag] [card] {json}`` (its
``phase``). Every other line of a log is skipped, and a tag may repeat
(one line per metro, K, arm ...): a line is keyed by its tag and the
identity fields it carries (``IDENTITY_KEYS``), with ``#n`` on a key
that still repeats.

The walk is the JAX module's: every numeric leaf both logs share whose
key names a known direction (``classify_direction``, suffix rules over
the port's own field names) is compared; keys only one side has are
counted as schema drift, never called regressions; fields of no known
direction (configs, counts, identities) are skipped, never guessed. A
leaf whose own key names no direction (a stage, arm or path name) takes
the direction of the key that holds it (``stage_ms.walk``). Each worse
delta past the threshold is attributed:

  card-drift          the two logs name different cards or power limits
                      (the card line, ``name, power.limit``): hosts and
                      cards differ between calls (PERF.md's header), so
                      the delta is drift across calls, never a regression;
  regression          worse on a metric the host-to-card link cannot
                      excuse (kernel and host-only times, correctness
                      counts), or on a link-sensitive one whose two runs
                      saw the same link;
  link-attributable   a link-sensitive metric (batch, request, stream and
                      copy times and rates) whose two runs' ``[link]``
                      samples differ: the mood changed, or the median
                      round trip or bandwidth moved past the band;
  link-unknown        link-sensitive and worse, but a log has no
                      ``[link]`` line: flagged, not blamed.

The sentinel reports and exits 0 always, as the JAX one does: a noisy
host must not turn a diff into a gate. ``coverage_findings`` is the
port's lint rule ``bench-coverage`` (analysis/lint_rules.py): every field
``chip_smoke.py`` can print with a number must classify or be neutral,
and every neutral entry must name a field still printed. chip_smoke.py's
``[bench_delta]`` phase is its runtime twin over the run's own lines.
"""

from __future__ import annotations

import ast
import json
import os
import re
import statistics
from typing import Any

__all__ = ["parse_log", "compare", "render", "classify_direction",
           "is_link_sensitive", "link_drifted", "link_of",
           "unclassified_fields", "coverage_findings", "main"]

PHASE_LINE = re.compile(r"^\[([^\]]+)\] \[([^\]]*)\] (\{.*\})\s*$")

# identity fields: a phase line's key carries them (tag[metro=sf,k=8])
IDENTITY_KEYS = ("metro", "arm", "k", "mode", "kind", "workers",
                 "pipeline_depth", "backend")

# ---------------------------------------------------------------------------
# direction classification: suffix rules over the LEAF key, narrow on
# purpose (an unclassified field is skipped, never guessed)

_HIGHER_SUFFIXES = (
    "_per_s", "per_s_p50", "per_s_own_busy", "mbps", "speedup",
    "speedup_vs_1", "vs_soak_x",
)
_LOWER_SUFFIXES = (
    # times: milliseconds, seconds
    "_ms", "ms_p50", "ms_p99", "ms_max", "ms_min", "ms_median",
    "_seconds", "_s", "ms_at_instance_k", "ms_back_to_back",
    # counts that are worse when up: kernel launches, mismatches, errors
    "launches", "launch_calls", "cuda_kernels", "mismatches", "errors",
    "violations", "unknown_edges", "unwaived", "findings", "max_abs_err",
    "timeouts", "reports_missing", "duplicate_reports", "disagreement",
    "dispatch_timeout", "dispatch_fallback", "banned_turns",
    "traces_differing_from_dense", "over_dense", "over_sweep",
    "mib_max", "x_single_in_turns", "slice_1024_x", "ms_per_call",
    "launches_per_batch", "mismatches_off_threshold", "peak_bytes",
    # quality and loss counters (the JAX module's, and the audit's and
    # the reach audit's): worse when up, 0 the healthy baseline
    "_miss_rate", "_missed", "disagreement_rate", "breakage_rate",
    "discontinuity_rate", "empty_match_rate", "rejection_rate",
    "unmatched_point_rate", "violation_rate", "drift_events",
    "dead_lettered", "dead_letter_pending", "replay_tax_records",
    "publish_retried", "duty_pct", "unmatched_share",
)
# whole keys, where a suffix would catch too much ("lag" in "flag")
_HIGHER_EXACT = {"agreement"}   # (mean_disagreement is lower: a suffix)
_LOWER_EXACT = {"ms", "seconds", "match_s_total", "serve_s_auditor_off",
                "ratio", "memory_drop_over_staged_max",
                "memory_rise_over_copy_max", "this_process_reserved_mib",
                "dead_probes", "lag", "banned", "unrouted"}
# whole subtrees that are descriptors or measurement conditions, pruned
# before any leaf is classified (matched as exact path segments)
NEUTRAL_SUBTREES = frozenset({
    "link",              # the [link] line: the normalizer, never compared
    "bench_delta",       # the sentinel's own line
    "sources",           # [build]: ptxas figures and per-library records
    "ptxas",             # compile descriptors ([analysis:manifest])
    "launch",            # launch shapes ([analysis:manifest])
    "arms",              # [gates:rows]: each gate's vote and pass tallies
    "host_cpu",          # the host's model and core count
    "process_sampler",   # the link sampler's bookkeeping
    "window", "window_since_watchdog", "first_note", "latest",
    "samples",           # link samples (conditions)
    "health_link",       # a /health link block (conditions)
    "config",            # echoed configurations
    "checks",            # named booleans and their evidence
    "occupancy",         # fleet paging bookkeeping
    "exits",             # per-member exit echoes
    "inflight_hist", "padding_by_bucket",   # bucket tallies
    "device",            # the [device] line: versions and the card
})
# leaf keys that are workloads, configurations, identities or bookkeeping,
# never a claim: matched exactly, before the suffix rules. Both directions
# are held (coverage_findings): every numeric field chip_smoke.py prints
# classifies or sits here, and every entry here names a printed field.
NEUTRAL_KEYS = {
    # identities, names and versions
    "metro", "arm", "k", "mode", "kind", "workers", "pipeline_depth",
    "backend", "plan", "plans", "source", "tuned_arm", "tuned_plan",
    "tuned_instance", "instance", "instance_k", "app_plan", "golden_plan",
    "result", "fastest_here", "fastest_back_to_back", "name", "torch", "cuda",
    "identity", "note", "error", "body", "answer", "trace_file",
    "unknown_metro_error", "far_known_metros", "resident_after",
    "metrics_fleet_series", "process_rows", "moved_partitions",
    "stable_partitions", "end_offsets", "slice_shape", "cold_build",
    "cold_cache", "cache_files", "hung_thread", "mesh",
    # workload sizes and configured limits
    "traces", "probes", "points", "records", "reports", "chunks", "grid",
    "edges", "nodes", "blocks", "line_segments", "seg_pack_columns",
    "vehicles", "rounds", "clients", "requests", "plain_points", "bucket",
    "count", "cells", "capacity", "dims", "shards", "devices", "metros",
    "partition", "tiles", "threads", "report_many_traces", "cpu_uuids",
    "cpu_requests", "points_sent", "traces_checked", "slice_traces",
    "slices", "checkpoint_round", "batch_traces", "fetch_records",
    "wire_traces", "traces_per_metro", "long_points", "ab_rounds",
    "cycles", "fleet_submitters", "explicit_metro_clients",
    "clients_by_metro", "killed_partition", "restrictions",
    "banned_turn_pairs", "from_edges", "rows", "ways", "shared_road_edges",
    "bicycle_edges", "reach_max", "capacity_start", "default_budget",
    "budget_share", "slack", "total_memory", "gate", "scale", "stamped",
    "real_blocks", "blocks_per_shard", "osmlr_pad", "allocator_bound",
    "max", "mean", "zero_share", "counter",
    # the run's clock and configured limits
    "at_s", "timeout_s", "hang_s", "injected_hang_s", "margin_s", "ttl_s",
    "window_s", "dispatch_timeout_s", "period_s", "search_radius",
    "ready_unix_s", "exit_unix_s",
    # kernel work descriptors (bound_ms and ms carry the claims)
    "exact_pairs", "coarse_pairs", "bytes", "coarse_rate_flops",
    "lattice_pairs", "operations", "bound_by", "linear_scan_operations",
    # the ranked-path lattice's and the grid kernel's work descriptors
    "r", "active_steps", "chain_starts", "cells_read",
    # the Viterbi kernel's launch plan (ops/hmm.viterbi_plan)
    "traces_per_cta", "threads_per_trace", "chunk", "levels",
    "vote_share", "gate_share", "plain_gate_share", "mean_hit_blocks",
    "checked_chunks_taken_later", "device_busy_share", "card_busy_share",
    "busy_samples",
    # table and file sizes: descriptors of the tile, not claims
    "table_bytes", "device_table_bytes", "dense_table_bytes",
    "cell_pack_bytes", "tile_bytes", "tile_hbm_bytes", "hbm_bytes",
    "osmlr_binary_bytes", "osmlr_geojson_bytes", "staged_bytes",
    "staged_total", "ledger_resident_bytes", "capacity_bytes",
    "copy_bytes_min", "copy_bytes_max", "trace_bytes",
    "cuda_allocated_bytes_after_construct", "memory_allocated_rise",
    "memory_drops", "reach_truncated_nodes", "truncated_nodes",
    "overflow", "candidates", "osmlr_segments", "segments",
    "segments_kept", "kanon_dropped",
    # tallies whose value is set by the phase's design (counts, codes);
    # their phase's checks hold them, the times and rates are the claims
    "calibration_dispatches", "request_segments", "batches",
    "submissions", "mean_occupancy", "padded_traces", "deferred",
    "max_inflight_seen", "stats_traces", "stats_probes", "status",
    "slo_status", "slo_ticks", "health_slo", "reports_served",
    "reports_at_datastore", "first_uuids_reports", "sigint_exit_code",
    "exit_code", "returncode", "exit", "waves", "wave_buckets",
    "max_inflight_waves", "reports_before", "reports_after",
    "uninterrupted_reports", "in_process_reports", "hist_bodies",
    "hist_segments", "reference_reports", "rows_at_kill", "lag_at_kill",
    "checkpoint_committed_at_kill", "post_mortems", "deaths", "restarts",
    "sink_rows", "sink_posts", "merged_counters", "merged_buckets",
    "processes", "unsynced", "events", "traced_ids", "cross_pid_tracks",
    "flow_events", "broker_dwell_spans", "supervisor_ticks",
    "worker_blocks", "lease_events", "rebalances", "stable_reports",
    "moved_reports_not_published", "reports_at_sink", "agree_m",
    "total_m", "oracle_records", "card_records", "dijkstra_searches",
    "dijkstra_hits", "clean_waves", "hang_waves", "waves_released",
    "dispatch_breaker_open", "retry_status", "retry_segments",
    "records_spool", "resume", "steps", "scheduler_by_metro",
    "far_status", "unknown_metro_status", "metrics_router_unroutable",
    "health_unroutable", "health_metros", "kafka", "durable",
    "dispatch_timeout_notes", "abandoned_at_return",
    "abandoned_count_after", "wrong_mode_status", "cases", "paths",
    "refused_points", "converted", "dispatches", "wire_entries",
    "touches", "promotions", "demotions", "evictions", "paged_metros",
    "rolled_back", "recovered", "single_slices", "aten_ops", "problems",
    "staging_cases",
    "sweep_exact_kernels", "sweep_exact_spans", "running",
    "full_run_holds_first_uuids_reports", "drained", "tile", "dp",
    # stream, backfill, audit, reach-audit and kernel-gate bookkeeping
    "flushes", "hist_rows", "qhist_rows", "malformed", "reports_published",
    "kept_segments", "partitions", "records_total", "short_traces",
    "audit_calls", "audit_rate", "audit_skips", "audited_batches",
    "audited_traces", "busy_share", "spread_pct_of_median",
    "pairs_accepted_exact", "pairs_considered", "steps_accepted_exact",
    "steps_considered", "node_coverage_m", "transitions",
    "via_private_rows", "matched_share", "observations", "osmlr_rows",
    "gate_first_group_share_of_voted", "gate_tolerance",
    # [api], [examples]
    "names", "wrong", "jax_modules", "example", "missing_markers",
    "stdout_lines",
    # launch shapes ([build:exact_shape], kernels/build.exact_shape)
    "smem_bytes", "ctas_per_sm", "sms", "depth", "gate_group",
    "grid_at_512_chunks",
}

# numbers the host-to-card link cannot move: device-only kernel times,
# host-only work, correctness counts (matched anywhere in the path)
_LINK_FREE = re.compile(
    r"^(kernel|build|tiles|gates|grid:native|pbf|analysis|capacity"
    r"|reach_audit|restrict:tiles|modes:tiles|lockdep)[\[.:]"
    r"|bound_ms|plain_ms|back_to_back|prepass|walk|prepare|python|numpy"
    r"|oracle|mismatch|errors|violation|findings|unwaived|launches"
    r"|agreement|disagreement|timeouts|missing|duplicate|max_abs_err"
    r"|banned")


def classify_direction(key: str) -> int:
    """+1 higher-is-better, -1 lower-is-better, 0 not a compared metric."""
    k = key.lower()
    if _neutral_key(k):
        return 0
    k = re.sub(r"_by_[a-z0-9_]+$", "", k)   # candidate_ms_by_arm → _ms
    if k in _HIGHER_EXACT:
        return 1
    if k in _LOWER_EXACT:
        return -1
    for s in _HIGHER_SUFFIXES:
        if k.endswith(s):
            return 1
    for s in _LOWER_SUFFIXES:
        if k.endswith(s):
            return -1
    return 0


def _neutral_key(leaf: str) -> bool:
    """On the neutral list, or a pure-digit key (bucket labels)."""
    return leaf.lower() in NEUTRAL_KEYS or leaf.isdigit()


def _neutral_segment(key: str) -> bool:
    """A phase key (``tag[ident]#n``), a field or a list item of a neutral
    subtree."""
    return re.sub(r"(\[[^\]]*\])?(#\d+)?$", "", str(key)) \
        in NEUTRAL_SUBTREES


def resolve(keys: "tuple[str, ...]") -> "tuple[int, bool]":
    """(direction, neutral) of a leaf from its chain of keys, the leaf's
    last. The leaf's own key decides if it classifies or is on the
    neutral list; a key that names neither (a stage, arm, metro, path or
    bucket) defers to the nearest key above it that does, so
    ``stage_ms.walk`` is a time and ``edges.sf`` a count. A leaf nothing
    decides is unclassified: ``(0, False)`` (a bucket digit alone is
    neutral, as in the JAX module)."""
    for key in reversed(keys):
        d = classify_direction(key)
        if d:
            return d, False
        if key.lower() in NEUTRAL_KEYS:
            return 0, True
    return 0, bool(keys) and keys[-1].isdigit()


def is_link_sensitive(path: str) -> bool:
    """Does the host-to-card link sit in this number? Kernel times on
    the card, host-only work and correctness counts cannot hide behind
    the link's mood; every end-to-end time and rate can."""
    return not _LINK_FREE.search(path)


# ---------------------------------------------------------------------------
# the logs

def _numeric(x: Any) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def parse_log(text: str) -> dict:
    """{"phases": {key: fields}, "tags": {key: tag}, "cards": [card, ...],
    "lines": phase lines, "skipped": other lines}."""
    phases: "dict[str, dict]" = {}
    tags: "dict[str, str]" = {}
    cards: "list[str]" = []
    n_phase = n_skip = 0
    for line in text.splitlines():
        m = PHASE_LINE.match(line.strip())
        if not m:
            n_skip += 1
            continue
        try:
            fields = json.loads(m.group(3))
        except ValueError:
            n_skip += 1
            continue
        if not isinstance(fields, dict):
            n_skip += 1
            continue
        tag, card = m.group(1), m.group(2)
        n_phase += 1
        if card not in cards:
            cards.append(card)
        ident = ",".join(f"{k}={fields[k]}" for k in IDENTITY_KEYS
                         if isinstance(fields.get(k), (str, int))
                         and not isinstance(fields.get(k), bool))
        key = f"{tag}[{ident}]" if ident else tag
        base, n = key, 1
        while key in phases:
            n += 1
            key = f"{base}#{n}"
        phases[key] = fields
        tags[key] = tag
    return {"phases": phases, "tags": tags, "cards": cards,
            "lines": n_phase, "skipped": n_skip}


def link_of(log: dict) -> "dict | None":
    """The ``[link]`` line's samples as one condition: the median round
    trip and bandwidth and the most common mood. None without the line
    (or without a usable sample)."""
    for key, tag in log["tags"].items():
        if tag != "link":
            continue
        samples = [s for s in log["phases"][key].get("samples") or []
                   if isinstance(s, dict) and s.get("mood") is not None]
        if not samples:
            return None
        moods = [s["mood"] for s in samples]

        def med(name):
            vals = [s[name] for s in samples if _numeric(s.get(name))]
            return statistics.median(vals) if vals else None
        return {"mood": max(set(moods), key=moods.count),
                "rtt_ms": med("rtt_ms"), "mbps": med("mbps"),
                "samples": len(samples)}
    return None


def link_drifted(old: "dict | None", new: "dict | None",
                 rtt_band: float = 1.5,
                 mbps_band: float = 1.5) -> "bool | None":
    """Did the link move enough between the runs to excuse a
    link-sensitive delta? None: a side has no ``[link]`` line. A mood
    change always counts; otherwise the round trip or the bandwidth
    moving past its band, either way."""
    if not old or not new or old.get("mood") is None \
            or new.get("mood") is None:
        return None
    if old["mood"] != new["mood"]:
        return True
    for key, band in (("rtt_ms", rtt_band), ("mbps", mbps_band)):
        a, b = old.get(key), new.get(key)
        if a and b and (a / b > band or b / a > band):
            return True
    return False


def _walk(old: Any, new: Any, path: str, keys: "tuple[str, ...]",
          rows: list, counts: dict) -> None:
    if isinstance(old, dict) and isinstance(new, dict):
        o = {str(k): v for k, v in old.items()}
        n = {str(k): v for k, v in new.items()}
        for k in sorted(set(o) | set(n)):
            if _neutral_segment(k):
                continue
            p = f"{path}.{k}" if path else k
            if k not in o:
                counts["only_new"] += 1
            elif k not in n:
                counts["only_old"] += 1
            else:
                _walk(o[k], n[k], p, keys + (k,), rows, counts)
        return
    if isinstance(old, list) and isinstance(new, list):
        for i in range(min(len(old), len(new))):
            _walk(old[i], new[i], f"{path}[{i}]", keys, rows, counts)
        if len(old) != len(new):
            counts["only_old" if len(old) > len(new)
                   else "only_new"] += abs(len(old) - len(new))
        return
    if not (_numeric(old) and _numeric(new)) or not keys:
        return
    direction, _ = resolve(keys)
    if direction == 0:
        return
    counts["compared"] += 1
    if old == new:
        counts["flat"] += 1
        return
    delta_pct = (None if old == 0
                 else round((new - old) / abs(old) * 100.0, 2))
    rows.append({"path": path, "old": old, "new": new,
                 "delta_pct": delta_pct, "direction": direction,
                 "link_sensitive": is_link_sensitive(path)})


def compare(old_log: dict, new_log: dict,
            threshold_pct: float = 10.0) -> dict:
    """Diff two parsed logs (parse_log); see the module docstring for the
    verdicts."""
    old_link, new_link = link_of(old_log), link_of(new_log)
    drifted = link_drifted(old_link, new_link)
    old_card = old_log["cards"][0] if old_log["cards"] else None
    new_card = new_log["cards"][0] if new_log["cards"] else None
    card_changed = (old_card is not None and new_card is not None
                    and old_card != new_card)
    rows: "list[dict]" = []
    counts = {"compared": 0, "flat": 0, "only_old": 0, "only_new": 0}
    # a phase only one log has is schema drift; a tag may name a neutral
    # subtree ([link], [device])
    o, n = old_log["phases"], new_log["phases"]
    for key in sorted(set(o) | set(n)):
        if _neutral_segment(key):
            continue
        if key not in o:
            counts["only_new"] += 1
        elif key not in n:
            counts["only_old"] += 1
        else:
            _walk(o[key], n[key], key, (), rows, counts)
    regressions: "list[dict]" = []
    link_attrib: "list[dict]" = []
    card_drift: "list[dict]" = []
    improved = 0
    for r in rows:
        d = r["delta_pct"]
        if d is None:
            worse = (r["new"] - r["old"]) * r["direction"] < 0
            big = True
        else:
            worse = d * r["direction"] < 0
            big = abs(d) >= threshold_pct
        if not big:
            counts["flat"] += 1
            continue
        if not worse:
            improved += 1
            r["verdict"] = "improved"
        elif card_changed:
            r["verdict"] = "card-drift"
            card_drift.append(r)
        elif r["link_sensitive"] and drifted is None:
            r["verdict"] = "link-unknown"
            link_attrib.append(r)
        elif r["link_sensitive"] and drifted:
            r["verdict"] = "link-attributable"
            link_attrib.append(r)
        else:
            r["verdict"] = "regression"
            regressions.append(r)

    def _sev(r):
        return (0 if r["delta_pct"] is None else 1,
                -abs(r["delta_pct"] or 0.0))

    for lst in (regressions, link_attrib, card_drift):
        lst.sort(key=_sev)
    return {
        "threshold_pct": threshold_pct,
        "link": {"old": old_link, "new": new_link, "drifted": drifted},
        "card": {"old": old_card, "new": new_card,
                 "changed": card_changed},
        "phase_lines": {"old": old_log["lines"], "new": new_log["lines"]},
        "compared": counts["compared"],
        "flat": counts["flat"],
        "improved": improved,
        "only_old_keys": counts["only_old"],
        "only_new_keys": counts["only_new"],
        "regressions": regressions,
        "link_attributable": link_attrib,
        "card_drift": card_drift,
    }


def render(delta: dict) -> str:
    """The human-readable table (the CLI's face)."""
    out = [
        f"compared {delta['compared']} metric leaves over "
        f"{delta['phase_lines']['old']} / {delta['phase_lines']['new']} "
        f"phase lines (threshold {delta['threshold_pct']}%): "
        f"{len(delta['regressions'])} regression(s), "
        f"{len(delta['link_attributable'])} link-attributable or "
        f"link-unknown, {len(delta['card_drift'])} card drift, "
        f"{delta['improved']} improved, {delta['flat']} flat; schema "
        f"drift: {delta['only_old_keys']} old-only / "
        f"{delta['only_new_keys']} new-only keys",
        f"old: card={delta['card']['old']}  link={delta['link']['old']}",
        f"new: card={delta['card']['new']}  link={delta['link']['new']}  "
        f"link drifted={delta['link']['drifted']}  card changed="
        f"{delta['card']['changed']}"]

    def _table(title, rows):
        if not rows:
            out.append(f"{title}: none")
            return
        out.append(title + ":")
        w = max(len(r["path"]) for r in rows)
        for r in rows:
            arrow = "^" if r["direction"] > 0 else "v"
            pct = ("   0->n " if r["delta_pct"] is None
                   else f"{r['delta_pct']:>+8.1f}")
            out.append(f"  {r['path']:<{w}}  {r['old']:>14g} -> "
                       f"{r['new']:>14g}  {pct}%  (better={arrow}) "
                       f"[{r['verdict']}]")

    _table("REGRESSIONS", delta["regressions"])
    _table("link-attributable / link-unknown", delta["link_attributable"])
    _table("drift across calls (card or power limit changed)",
           delta["card_drift"])
    return "\n".join(out)


# ---------------------------------------------------------------------------
# coverage: the runtime face (one log) and the lint's (chip_smoke.py's AST)

def unclassified_fields(log: dict) -> "list[tuple[str, str]]":
    """(leaf, example path) of every numeric leaf of ``log`` outside the
    neutral subtrees that nothing classifies or neutralizes (``resolve``):
    the fields ``compare`` would skip in silence."""
    out: "dict[str, str]" = {}

    def rec(x, path, keys):
        if isinstance(x, dict):
            for k, v in x.items():
                k = str(k)
                if not _neutral_segment(k):
                    rec(v, f"{path}.{k}" if path else k, keys + (k,))
        elif isinstance(x, list):
            for i, v in enumerate(x):
                rec(v, f"{path}[{i}]", keys)
        elif _numeric(x) and keys and resolve(keys) == (0, False):
            out.setdefault(keys[-1], path)

    for key, fields in log["phases"].items():
        if not _neutral_segment(key):
            rec(fields, key, ())
    return sorted(out.items())


_NON_NUMERIC_CALLS = {"bool", "str", "all", "any", "isinstance", "repr",
                      "type", "json_records", "equal", "array_equal",
                      "startswith", "endswith", "join", "format"}
# names a boolean or text field carries by the script's convention (the
# lint's source heuristic alone: the runtime check reads real values)
_BOOL_NAME = re.compile(r"(_equal|_eq|_ok|_identical|_bit_equal)(_|$)"
                        r"|^(equal|same|only|every|one|cover|covers)_"
                        r"|_(active|fired|refused|held|tagged|drained)$")


def _maybe_numeric(node: ast.AST, env: "dict[str, bool] | None" = None,
                   ) -> bool:
    """False where the expression evidently prints no number (a bool, a
    string, None, or a local name only ever bound to one); True where it
    may."""
    env = env or {}
    if isinstance(node, ast.Constant):
        return _numeric(node.value)
    if isinstance(node, (ast.Compare, ast.JoinedStr)):
        return False
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return False
    if isinstance(node, ast.BoolOp):
        return any(_maybe_numeric(v, env) for v in node.values)
    if isinstance(node, ast.IfExp):
        return _maybe_numeric(node.body, env) \
            or _maybe_numeric(node.orelse, env)
    if isinstance(node, ast.Name):
        return env.get(node.id, True)
    if isinstance(node, ast.Call):
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else "")
        return name not in _NON_NUMERIC_CALLS
    return True


def _name_env(fn: ast.AST) -> "dict[str, bool]":
    """name → may it hold a number, over a function's simple assignments
    (a name bound any other way may)."""
    env: "dict[str, bool]" = {}
    bound_else: "set[str]" = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            env[name] = env.get(name, False) or _maybe_numeric(node.value)
            continue
        if isinstance(node, ast.arguments):
            bound_else.update(
                a.arg for a in node.posonlyargs + node.args
                + node.kwonlyargs + [node.vararg, node.kwarg] if a)
            continue
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                               ast.comprehension, ast.NamedExpr)):
            targets = [node.target]
        elif isinstance(node, ast.With):
            targets = [i.optional_vars for i in node.items
                       if i.optional_vars is not None]
        else:
            continue
        for t in targets:
            bound_else.update(e.id for e in ast.walk(t)
                              if isinstance(e, ast.Name))
    for name in bound_else:
        env[name] = True
    return env


def _local_dicts(fn: ast.AST) -> "dict[str, list]":
    """name → the (key, value node, line) of every dict a function builds
    by name: ``x = {...}`` / ``x = dict(...)`` displays, ``x["k"] = v``
    stores and ``x.update(k=v)`` calls. A name also bound another way is
    left out (its keys cannot be read)."""
    keys: "dict[str, list]" = {}
    other: "set[str]" = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    v = node.value
                    if isinstance(v, ast.Dict) and all(
                            isinstance(k, ast.Constant) for k in v.keys):
                        keys.setdefault(t.id, []).extend(
                            (k.value, val, node.lineno)
                            for k, val in zip(v.keys, v.values))
                    elif isinstance(v, ast.Call) and isinstance(
                            v.func, ast.Name) and v.func.id == "dict" \
                            and not v.args and all(
                                kw.arg for kw in v.keywords):
                        keys.setdefault(t.id, []).extend(
                            (kw.arg, kw.value, node.lineno)
                            for kw in v.keywords)
                    else:
                        other.add(t.id)
                elif isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name):
                    if isinstance(t.slice, ast.Constant):
                        keys.setdefault(t.value.id, []).append(
                            (t.slice.value, node.value, node.lineno))
                    else:       # a key computed at run time
                        other.add(t.value.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    other.update(e.id for e in ast.walk(t)
                                 if isinstance(e, ast.Name))
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "update" \
                and isinstance(node.func.value, ast.Name):
            name = node.func.value.id
            if node.args:
                other.add(name)
            for kw in node.keywords:
                if kw.arg:
                    keys.setdefault(name, []).append(
                        (kw.arg, kw.value, node.lineno))
                else:
                    other.add(name)
        elif isinstance(node, (ast.For, ast.comprehension)):
            tgt = node.target
            for e in ast.walk(tgt):
                if isinstance(e, ast.Name):
                    other.add(e.id)
    return {k: v for k, v in keys.items() if k not in other}


def printed_fields(source: str):
    """The fields chip_smoke.py's ``phase(...)`` calls print, read from
    its AST: (name, may it be a number, line) of every keyword argument,
    of every key of a dict display passed (nested too) and of every key
    of a local dict passed as ``**name``; and (line, expression) of every
    ``**`` argument whose keys cannot be read."""
    tree = ast.parse(source)
    fields: "list[tuple[str, bool, int]]" = []
    opaque: "list[tuple[int, str]]" = []
    env: "dict[str, bool]" = {}

    def add(name, value, line, inherited=False):
        if not isinstance(value, ast.Dict):
            # a field whose container names its direction takes it
            fields.append((name, not inherited
                           and _maybe_numeric(value, env)
                           and not _BOOL_NAME.search(name), line))
            return
        fields.append((name, False, line))
        if _neutral_segment(name):
            return
        # the container decides for keys that name nothing themselves
        decided = inherited or (bool(name) and (
            classify_direction(name) != 0 or _neutral_key(name)))
        for k, v in zip(value.keys, value.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                add(k.value, v, line, decided)
            elif k is None:
                opaque.append((line, ast.unparse(v)))

    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        local = None
        env = _name_env(fn)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name) and node.func.id == "phase"):
                continue
            tag = node.args[0] if node.args else None
            if isinstance(tag, ast.Constant) and _neutral_segment(tag.value):
                continue          # a neutral line ([link], [device])
            for kw in node.keywords:
                if kw.arg is not None:
                    add(kw.arg, kw.value, node.lineno)
                    continue
                if local is None:
                    local = _local_dicts(fn)
                v = kw.value
                if isinstance(v, ast.Dict):
                    add("", v, node.lineno)
                elif isinstance(v, ast.Name) and v.id in local:
                    for name, val, _ in local[v.id]:
                        if isinstance(name, str):
                            add(name, val, node.lineno)
                else:
                    opaque.append((node.lineno, ast.unparse(v)))
    # a phase call nested in several functions is seen once per function
    seen = set()
    fields = [f for f in fields if (f[0], f[2]) not in seen
              and not seen.add((f[0], f[2]))]
    opaque = sorted(set(opaque))
    return [f for f in fields if f[0]], opaque


def _key_names(source: str) -> "set[str]":
    """Every string key a source file writes into a dict (displays,
    ``dict(k=...)``, ``x["k"] = ...``) or passes as a keyword: the names
    a printed nested field can carry."""
    out: "set[str]" = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Dict):
            out.update(k.value for k in node.keys
                       if isinstance(k, ast.Constant)
                       and isinstance(k.value, str))
        elif isinstance(node, ast.Call):
            out.update(kw.arg for kw in node.keywords if kw.arg)
            # dict(zip(("a", "b"), values))
            if getattr(node.func, "id", "") == "zip" and node.args and \
                    isinstance(node.args[0], (ast.Tuple, ast.List)):
                out.update(e.value for e in node.args[0].elts
                           if isinstance(e, ast.Constant)
                           and isinstance(e.value, str))
        elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str):
            out.add(node.slice.value)
    return out


def coverage_findings(root: "str | None" = None,
                      script: str = "chip_smoke.py"):
    """The lint rule ``bench-coverage`` over ``script``'s phase calls, both
    ways: every printed field that may be a number must classify or be
    neutral (a field of a neutral subtree is skipped), and every
    ``NEUTRAL_KEYS`` / ``NEUTRAL_SUBTREES`` entry must name a field the
    script or the port's modules still write. A ``**`` argument whose
    keys the AST cannot read is a finding of its own (the runtime twin,
    chip_smoke.py's ``[bench_delta]``, reads the printed line)."""
    from reporter_tpu_torch.analysis.lint_rules import REPO_ROOT, Finding

    root = root or REPO_ROOT
    path = os.path.join(root, script)
    try:
        with open(path) as f:
            source = f.read()
        fields, opaque = printed_fields(source)
    except (OSError, SyntaxError) as exc:
        return [Finding("bench-coverage", script, 1,
                        f"{script} failed to load ({type(exc).__name__}: "
                        f"{exc}): the coverage contract cannot be checked")]
    out = []
    if not fields and not opaque:
        out.append(Finding(
            "bench-coverage", script, 1,
            f"no phase(...) field found in {script}: the coverage "
            "contract must not pass vacuously"))
    subtree_names = {n for n, _, _ in fields if _neutral_segment(n)}
    reported = set()
    for name, numeric, line in fields:
        if name in reported or _neutral_segment(name) or not numeric \
                or _neutral_key(name) or classify_direction(name):
            continue
        reported.add(name)
        out.append(Finding(
            "bench-coverage", script, line,
            f"printed field {name!r} may be a number but neither "
            "classifies by suffix nor is neutral: bench_delta would skip "
            "it in silence; add a direction suffix or a NEUTRAL_KEYS "
            "entry in reporter_tpu_torch/analysis/bench_delta.py"))
    for line, expr in opaque:
        out.append(Finding(
            "bench-coverage", script, line,
            f"phase(**{expr}) prints fields the AST cannot name: build "
            "the dict as a local display, or waive with why the runtime "
            "check ([bench_delta]) covers it"))
    # reverse: every neutral entry still names a field somewhere
    written = {n for n, _, _ in fields} | subtree_names
    pkg = os.path.join(root, "reporter_tpu_torch")
    sources = [source]
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if fn.endswith(".py") and fn != "bench_delta.py":
                try:
                    with open(os.path.join(dirpath, fn)) as f:
                        sources.append(f.read())
                except OSError:
                    continue
    for src in sources:
        try:
            written |= _key_names(src)
        except SyntaxError:
            continue
    tags = set(re.findall(r"phase\(\s*f?[\"']([a-z_:]+)", source))
    here = os.path.relpath(os.path.abspath(__file__), root)
    with open(os.path.abspath(__file__)) as f:
        own = f.read().splitlines()

    def _line_of(token: str) -> int:
        pat = f'"{token}"'
        for i, ln in enumerate(own, 1):
            if pat in ln:
                return i
        return 1

    for entry in sorted(NEUTRAL_KEYS | NEUTRAL_SUBTREES):
        if entry in written or entry in tags:
            continue
        out.append(Finding(
            "bench-coverage", here, _line_of(entry),
            f"neutral entry {entry!r} names no field {script} or the "
            "port's modules write: dead row; delete it"))
    return out


def main(argv: "list[str] | None" = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.analysis.bench_delta",
        description="diff of the phase lines of two chip_smoke.py logs")
    ap.add_argument("old", help="the baseline run's log")
    ap.add_argument("new", help="the candidate run's log")
    ap.add_argument("--threshold", type=float, default=10.0,
                    help="delta %% below which a move is flat (default 10)")
    args = ap.parse_args(argv)
    with open(args.old, errors="replace") as f:
        old = parse_log(f.read())
    with open(args.new, errors="replace") as f:
        new = parse_log(f.read())
    print(render(compare(old, new, threshold_pct=args.threshold)))
    return 0            # a sentinel reports; it never gates


if __name__ == "__main__":
    raise SystemExit(main())
