"""The port's device-program contract: an aten-level audit of every wire
entry.

Counterpart: reporter_tpu/analysis/device_contract.py, which walks the
jaxprs of the JAX wire programs. The port has no jaxpr, so each audit
case RUNS its program at a tiny [B, T] under a
``torch.utils._python_dispatch.TorchDispatchMode`` that records every
aten op, and on a card also under ``torch.cuda.set_sync_debug_mode(
"error")``. The matrix: wire entry (``ops.match.wire_from_f32`` /
``_q16`` / ``_q8``) x the sweep's five arms (``block``, ``sub``,
``sub_bf16``, ``mxu``, ``mxu_bf16``, at K = 8) x wire layout (compact u16
[B, 2, T]; full u16 [B, 3, T] and packed u32 [B, 1, T] on tables whose
edge count is past ``_COMPACT_WIRE_EDGES``) x path (one device; the
mesh's ``DpWireMatcher.run`` over two shards), plus the streaming
histogram's and backfill's scatters (``streaming/histogram._accumulate``,
``ops/aggregate._scatter_add``, single and per mesh partial), the
ranked-path lattice behind ``match_topk`` (``ops/hmm.viterbi_topk_paths``
and ``viterbi_kbest_paths`` on staged candidates: on a card the
kernels of ``kernels/lattice.cu``) and a grid matcher's batch (the f32
wire entry with ``candidate_backend="grid"``: on a card
``kernels/grid.cu``). Inputs are
staged on the device before each case's window: the window holds the
device program, as the JAX audit traces the jitted body and not its
``device_put``. The staging cases then hold the host-to-card copies
themselves (``device.host_to_device``: pinned, ``non_blocking``, as
``device_put`` does not block): each window runs from host arrays, the
matcher's prepare and dispatch of a batch (``SegmentMatcher.
_submit_many``, up to the queued wire), the mesh's ``DpWireMatcher.stage``
with its run, ``SpeedHistogram.update`` and ``FixedGridCounts.add``
(single and over a mesh). Rules:

  device-f64         a float64 tensor in or out of any op of the case.
                     The port builds wire bits and gather indices in
                     int64 (``ops/match._pack_wire``, ``ops/hmm``):
                     PyTorch's indexing idiom, so int64 is not a finding.
  device-sync        an op that makes the host wait for the card:
                     ``aten._local_scalar_dense`` (``.item()``, ``int(t)``),
                     the data-dependent shapes (``nonzero``,
                     ``masked_select``, boolean indexing, ``unique``,
                     ``repeat_interleave`` without ``output_size``) and a
                     copy from the card to the host; on a card, anything
                     ``set_sync_debug_mode("error")`` raises on. The torch
                     twin of the JAX ``device-callback`` rule.
  device-wire-dtype  the entry's output is not exactly one u16 [B, 2, T],
                     u16 [B, 3, T] or u32 [B, 1, T] tensor of its layout.
  device-trace       a case that raises (its error is the finding).

Not ported: ``device-nested-jit`` (a jit nested in ``shard_map``) has no
torch meaning: the port has neither, and its mesh program is a loop of
the one set of wire entries.

Findings name the port's source line the op was issued from, so the lint
waiver grammar applies: ``# lint: allow[device-f64] YYYY-MM-DD reason`` on
or above the line. ``CPU_WAIVERS`` waives a finding on the CPU only, for
code that runs on the CPU alone (the plain versions of the CUDA kernels).

Run: ``python -m reporter_tpu_torch.analysis --device`` (with the compile
manifest, analysis/compile_manifest.py) audits the card, as every entry
point of the port runs on ``cuda`` unless the caller asks for the CPU
(``--on cpu``; without a card ``--on cuda`` raises);
tests/test_torch_device_contract.py runs the CPU matrix; chip_smoke.py's
``[analysis:device]`` runs the card's as ``--device --json``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import time

from reporter_tpu_torch.analysis.lint_rules import (Finding, REPO_ROOT,
                                                    _apply_waivers, _dedupe,
                                                    _load)

__all__ = ["run_device_contract", "audit", "check_wire", "AuditCase",
           "audit_cases", "main", "RULES", "ABSENT_RULES", "CPU_WAIVERS"]

RULES = ("device-f64", "device-sync", "device-wire-dtype", "device-trace")
ABSENT_RULES = {
    "device-nested-jit": "no jit and no shard_map in the port: the mesh "
                         "program is a loop of the one set of wire "
                         "entries",
}

ARMS = ("block", "sub", "sub_bf16", "mxu", "mxu_bf16")
ENTRIES = ("f32", "q16", "q8")
LAYOUTS = ("compact", "full", "packed")
PATHS = ("single", "mesh")

# (rule, repo-relative path, function) → dated reason: waived on the CPU
# only, where the function is the plain version of a CUDA kernel
CPU_WAIVERS = {
    ("device-f64", "reporter_tpu_torch/ops/dense_candidates.py",
     "sqrt_f32"): "2026-10-17 the correctly rounded f32 square root's CPU "
        "branch (PyTorch's CPU sqrt is not correctly rounded, so it "
        "rounds through float64); on a card sqrt_f32 is torch.sqrt in f32, "
        "and [analysis:device] there audits the same cases with no "
        "float64",
}

# the audit's shapes: tiny (the op structure does not depend on [B, T])
_B, _T = 2, 16
_K = 8
_MESH_SHARDS = 2
# edge count for the big layouts (> ops.match._COMPACT_WIRE_EDGES)
_E_BIG = 50_000
_BIG_MAX_EDGE_LEN = 500.0
_EDGE_MEMBERS = ("edge_len", "reach_row")

_SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique",
             "_unique2", "unique_dim", "unique_consecutive"}


class AuditCase:
    """One cell of the audit matrix."""

    __slots__ = ("entry", "arm", "layout", "path")

    def __init__(self, entry: str, arm: str, layout: str, path: str):
        self.entry, self.arm, self.layout, self.path = (entry, arm, layout,
                                                        path)

    @property
    def label(self) -> str:
        return f"{self.entry}/{self.arm}/{self.layout}/{self.path}"


def audit_cases() -> "list[AuditCase]":
    return [AuditCase(*c) for c in itertools.product(ENTRIES, ARMS, LAYOUTS,
                                                     PATHS)]


# ---------------------------------------------------------------------------
# the recorder

def _rel(path: str) -> str:
    rel = os.path.relpath(path, REPO_ROOT)
    return rel if not rel.startswith("..") else path


def _site() -> "tuple[str, int, str]":
    """(path, line, function) of the innermost port frame outside this
    package's analysis (the op's issuing line), or ("?", 1, "")."""
    f = sys._getframe(2)
    sep = os.sep
    try:
        while f is not None:
            fn = f.f_code.co_filename
            if f"reporter_tpu_torch{sep}" in fn \
                    and f"{sep}analysis{sep}" not in fn:
                return _rel(fn), f.f_lineno, f.f_code.co_name
            f = f.f_back
        return "?", 1, ""
    finally:
        del f


def _tensors(x):
    import torch
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _sync_reason(func, args, kwargs, out) -> "str | None":
    """Why ``func`` makes the host wait for the card, or None."""
    import torch

    name = func.overloadpacket.__name__
    if name in _SYNC_OPS:
        return f"aten.{name} (a host read of device data)"
    if name == "repeat_interleave" and kwargs.get("output_size") is None \
            and (len(args) < 3 or args[2] is None):
        return "aten.repeat_interleave without output_size (its size is "\
               "read back)"
    if name in ("index", "index_put", "index_put_") and len(args) > 1:
        idx = args[1] if isinstance(args[1], (list, tuple)) else ()
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in idx):
            return f"aten.{name} with a boolean mask (a nonzero inside)"
    if name in ("_to_copy", "copy_"):
        srcs = [t for t in _tensors(args) if t.device.type != "cpu"]
        dsts = [t for t in _tensors(out) if t.device.type == "cpu"]
        if srcs and dsts:
            return "a copy from the card to the host"
    return None


def _recorder():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        """Records (rule, message, site) per offending aten op."""

        def __init__(self):
            super().__init__()
            self.hits: "list[tuple[str, str, tuple]]" = []
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            import torch

            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.ops += 1
            if any(t.dtype == torch.float64
                   for t in _tensors((args, kwargs, out))):
                self.hits.append((
                    "device-f64", f"float64 tensor at {func}", _site()))
            why = _sync_reason(func, args, kwargs, out)
            if why:
                self.hits.append(("device-sync", why, _site()))
            return out

    return Recorder()


@contextlib.contextmanager
def _sync_debug(device):
    """``set_sync_debug_mode("error")`` around a case on a card."""
    if device.type != "cuda":
        yield
        return
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def audit(fn, label: str, device, anchor: "tuple[str, int]"):
    """Run ``fn()`` once under the recorder (and on a card under
    sync-debug "error") → (its result or None, findings, ops recorded).
    A raise becomes a device-trace finding (device-sync where sync debug
    raised), at ``anchor``."""
    rec = _recorder()
    findings: "list[Finding]" = []
    out = None
    try:
        with _sync_debug(device), rec:
            out = fn()
    except Exception as exc:   # noqa: BLE001 - the finding carries it
        msg = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}" \
            if str(exc) else type(exc).__name__
        rule = "device-sync" if "synchroniz" in msg else "device-trace"
        findings.append(Finding(rule, anchor[0], anchor[1],
                                f"audit case {label} raised: {msg}"))
    for rule, why, (path, line, func) in rec.hits:
        findings.append(Finding(
            rule, path, line,
            f"{why} in {func}() ({label}): "
            + ("pin the dtype; the wire programs carry u16 / u32 / i8 / "
               "i16 / f32 only" if rule == "device-f64" else
               "a host round trip inside the device program; hoist it "
               "out of the wire path")))
    return out, findings, rec.ops


_WIRE_EXPECT = {"compact": ("uint16", 2), "full": ("uint16", 3),
                "packed": ("uint32", 1)}


def check_wire(out, layout: str, label: str,
               site: "tuple[str, int]") -> "list[Finding]":
    """The end-to-end dtype pin: exactly one [B, lanes, T] tensor of the
    layout's pinned dtype (a ShardedWire's shards each)."""
    import torch

    want_dtype, want_lanes = _WIRE_EXPECT[layout]
    sharded = hasattr(out, "shards")
    outs = out.shards if sharded else \
        list(out) if isinstance(out, (list, tuple)) else [out]
    ok = (sharded or len(outs) == 1) and all(
        isinstance(w, torch.Tensor) and w.dtype == getattr(torch, want_dtype)
        and w.dim() == 3 and int(w.shape[1]) == want_lanes for w in outs)
    if ok:
        return []
    got = [f"{getattr(w, 'dtype', type(w).__name__)}"
           f"{list(getattr(w, 'shape', ()))}" for w in outs]
    return [Finding(
        "device-wire-dtype", site[0], site[1],
        f"wire output of {label} is {got}, expected one {want_dtype}"
        f"[B,{want_lanes},T] tensor: the {layout} layout's pinned wire "
        "format")]


# ---------------------------------------------------------------------------
# the cases

def _tiny_tileset():
    from reporter_tpu_torch.config import CompilerParams
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.tiles.compiler import compile_network

    return compile_network(generate_city("tiny"),
                           CompilerParams(reach_radius=400.0))


def _big(tables: dict) -> dict:
    """The tables of a metro past the compact range: the edge-indexed
    members padded to _E_BIG rows (the layout follows edge_len's
    length)."""
    import torch

    out = dict(tables)
    for k in _EDGE_MEMBERS:
        t = tables[k]
        pad = torch.zeros((_E_BIG - t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        out[k] = torch.cat([t, pad])
    return out


def _arm_params(arm: str):
    from reporter_tpu_torch.config import MatcherParams

    levers = {"block": dict(sweep_subcull=False), "sub": {},
              "sub_bf16": dict(sweep_lowp="bf16"),
              "mxu": dict(sweep_mxu=True),
              "mxu_bf16": dict(sweep_mxu=True, sweep_lowp="bf16")}[arm]
    return MatcherParams(candidate_backend="dense", max_candidates=_K,
                         sweep_autotune=False, **levers)


def _inputs(ts):
    """Host arrays of each entry for _B probe traces of _T points: f32
    points, i16 quanta from per-trace origins, their i8 steps, lengths."""
    import numpy as np

    from reporter_tpu_torch.netgen.traces import synthesize_probe
    from reporter_tpu_torch.ops.match import OFFSET_QUANTUM

    pts = np.stack([synthesize_probe(ts, seed=s, num_points=_T,
                                     gps_sigma=3.0).xy[:_T]
                    for s in range(_B)]).astype(np.float32)
    origins = pts[:, 0].copy()
    q16 = np.round((pts - origins[:, None]) / OFFSET_QUANTUM).astype(
        np.int16)
    q8 = np.diff(q16.astype(np.int32), axis=1, prepend=q16[:, :1]).clip(
        -128, 127).astype(np.int8)
    lens = np.full(_B, _T, np.int32)
    return {"f32": (pts, lens), "q16": (q16, origins, lens),
            "q8": (q8, origins, lens)}


def _entry_site(entry: str) -> "tuple[str, int]":
    import inspect

    from reporter_tpu_torch.ops import match

    fn = getattr(match, f"wire_from_{entry}")
    return "reporter_tpu_torch/ops/match.py", inspect.getsourcelines(fn)[1]


def _run_case(case: AuditCase, ts, tables: dict, host: dict, device):
    """(the case's program as a no-argument callable, its staged inputs
    built before the window)."""
    import torch

    from reporter_tpu_torch.ops import match
    from reporter_tpu_torch.parallel.dp_e2e import DpWireMatcher
    from reporter_tpu_torch.parallel.mesh import make_mesh

    params = _arm_params(case.arm)
    spec = (match.wire_spec(_E_BIG, _BIG_MAX_EDGE_LEN)
            if case.layout == "packed" else None)
    tb = tables["compact" if case.layout == "compact" else "big"]
    arrays = host[case.entry]
    if case.path == "single":
        args = [torch.from_numpy(a).to(device) for a in arrays]
        impl = getattr(match, f"wire_from_{case.entry}")
        return lambda: impl(*args, tb, params, None, spec, ts.meta)
    mesh = make_mesh(dp=_MESH_SHARDS, devices=[device] * _MESH_SHARDS)
    dpm = DpWireMatcher(mesh, ts, params, spec)
    dpm.tables = {d: tb for d in dpm.tables}
    staged = dpm.stage(arrays, None)
    return lambda: dpm.run(case.entry, staged)


def _scatter_cases(device) -> "list[tuple[str, object, tuple]]":
    """(label, program, anchor) of the histogram and backfill scatters:
    the device halves on staged indices, single and per mesh partial."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import aggregate as agg
    from reporter_tpu_torch.parallel.mesh import make_mesh
    from reporter_tpu_torch.streaming import histogram as hg

    rng = np.random.default_rng(0)
    hist = hg.SpeedHistogram(64, (0.0, 5.0, 10.0, 20.0), device=device)
    hidx = torch.from_numpy(rng.integers(0, 64 * 4, 512)).to(device)
    hupd = torch.ones(512, dtype=torch.int32, device=device)
    size = 4096
    grid = agg.FixedGridCounts(size, device=device)
    mesh_grid = agg.FixedGridCounts(
        size, mesh=make_mesh(dp=_MESH_SHARDS,
                             devices=[device] * _MESH_SHARDS))
    gidx = torch.from_numpy(rng.integers(0, size, agg._CAP)).to(device)
    gupd = torch.ones(agg._CAP, dtype=torch.int32, device=device)

    def mesh_scatter():
        for part in mesh_grid._parts:
            agg._scatter_add(part, gidx, gupd)

    return [
        ("histogram/scatter",
         lambda: hg._accumulate(hist._hist, hidx, hupd),
         ("reporter_tpu_torch/streaming/histogram.py", 1)),
        ("backfill/scatter",
         lambda: agg._scatter_add(grid._parts[0], gidx, gupd),
         ("reporter_tpu_torch/ops/aggregate.py", 1)),
        ("backfill/scatter-mesh", mesh_scatter,
         ("reporter_tpu_torch/ops/aggregate.py", 1)),
    ]


def _staging_cases(device, ts, host) -> "list[tuple[str, object, tuple]]":
    """(label, program, anchor) of the cases whose window starts from host
    arrays: every staging site of the main path, through its own entry.
    (``match_topk`` stages through the same helper, but its window would
    end in its harvest's copy to the host.)"""
    import numpy as np

    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.ops import aggregate as agg
    from reporter_tpu_torch.parallel.dp_e2e import DpWireMatcher
    from reporter_tpu_torch.parallel.mesh import make_mesh
    from reporter_tpu_torch.streaming import histogram as hg

    pts, _ = host["f32"]
    # one trace with per-point accuracy: its scale is staged too
    acc = np.linspace(3.0, 12.0, pts.shape[1]).astype(np.float32)
    traces = [Trace(uuid=f"t{i}", xy=p, times=np.arange(len(p), dtype=float),
                    accuracy=acc if i == 0 else None)
              for i, p in enumerate(pts)]
    matcher = SegmentMatcher(ts, _arm_params("sub"), device=device)
    matcher._staged()
    dpm = DpWireMatcher(make_mesh(dp=_MESH_SHARDS,
                                  devices=[device] * _MESH_SHARDS),
                        ts, _arm_params("sub"), None)
    rng = np.random.default_rng(1)
    hist = hg.SpeedHistogram(64, (0.0, 5.0, 10.0, 20.0), device=device)
    rows = rng.integers(0, 64, 512).astype(np.int32)
    speeds = rng.uniform(0.0, 30.0, 512)
    size = 4096
    grid = agg.FixedGridCounts(size, device=device)
    mesh_grid = agg.FixedGridCounts(
        size, mesh=make_mesh(dp=_MESH_SHARDS,
                             devices=[device] * _MESH_SHARDS))
    idx = rng.integers(0, size, 3 * agg._CAP)
    return [
        ("staging/matcher", lambda: matcher._submit_many(traces)[1],
         ("reporter_tpu_torch/matcher/api.py", 1)),
        ("staging/mesh", lambda: dpm.run("f32", dpm.stage(host["f32"], None)),
         ("reporter_tpu_torch/parallel/dp_e2e.py", 1)),
        ("staging/histogram", lambda: hist.update(rows, speeds),
         ("reporter_tpu_torch/streaming/histogram.py", 1)),
        ("staging/backfill", lambda: grid.add(idx),
         ("reporter_tpu_torch/ops/aggregate.py", 1)),
        ("staging/backfill-mesh", lambda: mesh_grid.add(idx),
         ("reporter_tpu_torch/ops/aggregate.py", 1)),
    ]


def _ranked_grid_cases(device, ts, host) -> "list[tuple[str, object, tuple]]":
    """(label, program, anchor) of the ranked-path lattice behind
    ``match_topk`` (its device half on staged candidates: the terminal
    completions and the exact list Viterbi, each the keep mask, the
    forward pass and the backtrack) and of a grid matcher's batch (the
    f32 wire entry with ``candidate_backend="grid"`` on staged points)."""
    import dataclasses

    import torch

    from reporter_tpu_torch.ops import hmm, match
    from reporter_tpu_torch.tiles.tileset import tables_from_numpy

    pts, lens = host["f32"]
    dense = tables_from_numpy(ts.arrays(), device)
    p = _arm_params("sub")
    pj = torch.from_numpy(pts[:1]).to(device)
    vj = torch.ones(pj.shape[:2], dtype=torch.bool, device=device)
    c = match.batch_candidates(pj, vj, dense, p, ts.meta)
    cands = match.CandidateSet(*(x[0] for x in c))
    args = (cands, pj[0], vj[0], dense, p.sigma_z, p.beta,
            p.max_route_distance_factor, p.breakage_distance,
            p.backward_slack, p.interpolation_distance)

    def lattice():
        return (hmm.viterbi_topk_paths(*args),
                hmm.viterbi_kbest_paths(*args, num_paths=p.max_candidates))

    grid = tables_from_numpy(ts.arrays(), device, candidate_backend="grid")
    gp = dataclasses.replace(p, candidate_backend="grid")
    gpts = torch.from_numpy(pts).to(device)
    glens = torch.from_numpy(lens).to(device)
    return [
        ("topk/lattice", lattice, ("reporter_tpu_torch/ops/hmm.py", 1)),
        ("grid/wire", lambda: match.wire_from_f32(
            gpts, glens, grid, gp, None, None, ts.meta),
         _entry_site("f32")),
    ]


def _merge_across_cases(findings: "list[Finding]") -> "list[Finding]":
    """One finding per (rule, path, line): shared code is hit by most
    cells; the first case's message survives with a count of the rest."""
    merged: "dict[tuple, Finding]" = {}
    extra: "dict[tuple, int]" = {}
    for f in findings:
        key = (f.rule, f.path, f.line)
        if key in merged:
            extra[key] = extra.get(key, 0) + 1
        else:
            merged[key] = f
    for key, n in extra.items():
        merged[key].message += f" [{n} more hits of this site]"
    return list(merged.values())


def _function_at(path: str, line: int) -> str:
    """The name of the innermost function holding ``line`` of ``path``."""
    import ast

    mod = _load(os.path.join(REPO_ROOT, path), REPO_ROOT)
    best = ""
    for node in ast.walk(mod.tree) if mod is not None else ():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.lineno <= line <= (node.end_lineno or node.lineno):
            best = node.name
    return best


def _apply_cpu_waivers(findings: "list[Finding]") -> None:
    for f in findings:
        if f.waived:
            continue
        why = CPU_WAIVERS.get((f.rule, f.path, _function_at(f.path, f.line)))
        if why:
            f.waived, f.justification = True, why


def run_device_contract(device="cuda", cases=None,
                        stats: "dict | None" = None) -> "list[Finding]":
    """Audit the matrix (``cases``: audit_cases() by default) and the
    scatters on ``device`` (``cuda`` unless the caller asks for the CPU;
    raises without a card) → waiver-applied findings. ``stats`` (a dict)
    receives the counts of cases (the staging cases among them) and of
    aten ops recorded."""
    import torch

    from reporter_tpu_torch.device import resolve_device
    from reporter_tpu_torch.tiles.tileset import tables_from_numpy

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ts = _tiny_tileset()
    compact = tables_from_numpy(ts.arrays(), device)
    tables = {"compact": compact, "big": _big(compact)}
    host = _inputs(ts)
    findings: "list[Finding]" = []
    n_cases = n_ops = 0
    for case in audit_cases() if cases is None else cases:
        site = _entry_site(case.entry)
        try:
            fn = _run_case(case, ts, tables, host, device)
        except Exception as exc:   # noqa: BLE001 - the finding carries it
            findings.append(Finding(
                "device-trace", site[0], site[1],
                f"audit case {case.label} failed to stage: "
                f"{type(exc).__name__}: {str(exc)[:160]}"))
            continue
        out, found, ops = audit(fn, case.label, device, site)
        n_cases += 1
        n_ops += ops
        findings.extend(found)
        if out is not None:
            findings.extend(check_wire(out, case.layout, case.label, site))
    staging = _staging_cases(device, ts, host)
    for label, fn, anchor in (*_scatter_cases(device), *staging,
                              *_ranked_grid_cases(device, ts, host)):
        _, found, ops = audit(fn, label, device, anchor)
        n_cases += 1
        n_ops += ops
        findings.extend(found)
    findings = _dedupe(_merge_across_cases(findings))
    by_path: "dict[str, list[Finding]]" = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    for path, group in by_path.items():
        mod = _load(os.path.join(REPO_ROOT, path), REPO_ROOT) \
            if os.path.exists(os.path.join(REPO_ROOT, path)) else None
        if mod is not None:
            _apply_waivers(mod, group)
    if device.type == "cpu":
        _apply_cpu_waivers(findings)
    if stats is not None:
        stats.update(cases=n_cases, aten_ops=n_ops,
                     staging_cases=len(staging))
    return findings


def main(device: str = "cuda", as_json: bool = False) -> int:
    """The ``--device`` gate on ``device`` (``cuda`` unless the caller asks
    for the CPU): the audit matrix, then the compile manifest. Prints the
    findings and a summary, or with ``as_json`` two JSON lines (the
    audit's seconds, counts and findings; the manifest's seconds,
    problems and figures). Exit 1 on any unwaived finding or manifest
    drift."""
    from reporter_tpu_torch.analysis import compile_manifest

    t0 = time.perf_counter()
    stats: dict = {}
    findings = run_device_contract(device, stats=stats)
    t1 = time.perf_counter()
    manifest = compile_manifest.compute_manifest(device)
    problems = compile_manifest.check(device, computed=manifest)
    t2 = time.perf_counter()
    unwaived = [f for f in findings if not f.waived]
    if as_json:
        print(json.dumps({"gate": "device", "device": str(device),
                          "seconds": t1 - t0, **stats,
                          "findings": [str(f) for f in findings],
                          "unwaived": [str(f) for f in unwaived]}))
        print(json.dumps({"gate": "manifest", "seconds": t2 - t1,
                          "problems": problems, "manifest": manifest}))
    else:
        for f in findings:
            print(f)
        for p in problems:
            print(f"compile-manifest: {p}")
        print(f"device contract ({device}): {stats['cases']} audit cases, "
              f"{stats['aten_ops']} aten ops, {len(findings)} finding(s), "
              f"{len(unwaived)} unwaived; manifest "
              f"{'DRIFTED' if problems else 'pinned'}")
    return 1 if (unwaived or problems) else 0
