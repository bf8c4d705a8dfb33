"""Time the ranked-path lattice for several checkouts, in turns, on one
card.

    python3 scripts/lattice_ab.py [--reps N] [--out PATH]
        [--cases K[@RADIUS] ...] [--lattice-only] ROOT [ROOT ...]

Runs each ROOT in turn and then the ROOTs in reverse (A B B A for two),
each in a process of its own with that checkout's root first on
``sys.path``, so that two versions of the lattice are compared within
one call on one card. Each process compiles the sf tile, makes the seeded
1024-point probe that chip_smoke.py's [kernel:lattice] runs, and for
each case (``--cases``: K at the matcher's default radius, or K@RADIUS
in m, each with R = 1 and R = K; by default 8 and 64@150, so K = 8 at 50
m and K = 64 at 150 m) makes its candidates as ``match_topk`` does (a
matcher at that
K, no tuning) and times the public entry that case takes
(``hmm.viterbi_topk_paths`` at R = 1, ``hmm.viterbi_kbest_paths`` with
``num_paths=R`` else: the keep mask, the forward, the ranking and the
backtrack), so that checkouts whose wrappers differ compare alike:

- ``call_ms``: one call, CUDA events, median of N;
- ``keep_device_ms``, ``forward_device_ms``, ``backtrack_device_ms``:
  each lattice kernel's device time a launch (the profiler's, over N
  calls); ``kernels``: the device records a call;
- ``peak_bytes``: the call's peak allocation;
- ``sha256``: the call's paths, scores and flags, so the versions'
  results can be held equal.

Then the keep mask of 64 traces at once (``keep_b64``: the probe and 63
shifted copies of it, one launch of ``hmm._keep_mask_cuda``), and the
grid backend's candidates (``candidates.find_candidates``, one launch of
the grid kernel) of the 131,072 points chip_smoke.py's [kernel:grid] runs
(``synthesize_fleet`` seed 0: 1024 traces of 120 points, each padded to
128 with its first point) at K = 8 (50 m) and K = 64 (150 m, on a tile
compiled with that index radius): the cases ``grid_k8`` and
``grid_k64``, each with the same fields (``keep_device_ms`` and
``grid_device_ms`` the kernels').

Then ``terminal_ms`` / ``exact_ms`` (and every run, ``*_runs_ms``) and
their ``*_peak_bytes``: a ``match_topk`` of each form at K = 64 (150 m)
on the probe, the host's clock, median of N.

``--lattice-only`` leaves out the keep mask of 64 traces, the grid
cases and the ``match_topk`` calls.

Each process prints one JSON line; the script prints them, the card's
``nvidia-smi`` name and power limit, and last one JSON line with the
medians per root, the spread of the ``match_topk`` runs and, for two
roots, the first's medians over the second's. Needs one card; imports
nothing of JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_RUN = r"""
import hashlib, json, statistics, sys, time
root, reps = sys.argv[1], int(sys.argv[2])
cases = [(int(c.partition("@")[0]),
          float(c.partition("@")[2]) if c.partition("@")[2] else None)
         for c in sys.argv[3].split(",")]
lattice_only = sys.argv[4] == "1"
sys.path.insert(0, root)
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from reporter_tpu_torch.config import CompilerParams, Config, MatcherParams
from reporter_tpu_torch.kernels import build
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet, synthesize_probe
from reporter_tpu_torch.ops import candidates as cand
from reporter_tpu_torch.ops import hmm
from reporter_tpu_torch.ops import match as match_ops
from reporter_tpu_torch.tiles.compiler import compile_network

assert build.__file__.startswith(root), build.__file__
# a kernel's key → the prefix of its device records' names (every
# instance of it)
KERNELS = {"keep": "lattice_keep_kernel", "forward": "lattice_forward_kernel",
           "backtrack": "lattice_backtrack", "grid": "grid_candidates_kernel"}


def cuda_ms(fn, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn):
    # each lattice kernel's device ms a launch, and the device records a
    # call; a launch's time is its total over its records' count, which
    # holds where the profiler drops a window's first records
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    run = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for name, prefix in KERNELS.items():
        hits = [e for e in run if prefix in e.key]
        n = sum(e.count for e in hits)
        out[f"{name}_device_ms"] = (
            sum(e.self_device_time_total for e in hits) / 1e3 / n
            if n else None)
    out["kernels"] = sum(e.count for e in run) / reps
    return out


def peak(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


ts = compile_network(generate_city("sf"))
pr = synthesize_probe(ts, seed=7, num_points=1024)
xy = pr.xy.astype(np.float32)
out = {"root": root, "cases": {}}
for k, radius in cases:
    rs = (1, k)
    levers = {} if radius is None else {"search_radius": radius}
    m = SegmentMatcher(ts, MatcherParams(sweep_autotune=False,
                                         max_candidates=k, **levers))
    p = m.params
    pts = torch.from_numpy(xy).cuda()
    valid = torch.ones(len(xy), dtype=torch.bool, device="cuda")
    c = match_ops.batch_candidates(pts[None], valid[None], m.tables, p,
                                   m.ts.meta)
    tc = match_ops.CandidateSet(*(x[0] for x in c))
    args = (tc, pts, valid, m.tables, p.sigma_z, p.beta,
            p.max_route_distance_factor, p.breakage_distance,
            p.backward_slack, p.interpolation_distance)
    for R in rs:
        if R == 1:
            call = lambda: hmm.viterbi_topk_paths(*args)
        else:
            call = lambda: hmm.viterbi_kbest_paths(*args, num_paths=R)
        res = call()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for x in res:
            h.update(x.cpu().numpy().tobytes())
        at = "" if radius in (None, 150.0) else f"_{radius:g}m"
        out["cases"][f"k{k}_r{R}{at}"] = {
            "call_ms": cuda_ms(call), **device_ms(call),
            "peak_bytes": peak(call), "sha256": h.hexdigest()}
if lattice_only:
    print(json.dumps(out))
    sys.exit(0)
p = MatcherParams()
kp = torch.from_numpy(xy).cuda()
kp = torch.stack([kp + 7.0 * i for i in range(64)])
kv = torch.ones(kp.shape[:2], dtype=torch.bool, device="cuda")
call = lambda: hmm._keep_mask_cuda(kp, kv, p.interpolation_distance)
res = call()
torch.cuda.synchronize()
out["cases"]["keep_b64"] = {
    "call_ms": cuda_ms(call), **device_ms(call), "peak_bytes": peak(call),
    "sha256": hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()}
fleet = synthesize_fleet(ts, 1024, num_points=120, seed=0)
gpts = np.zeros((len(fleet), 128, 2), np.float32)
for i, f in enumerate(fleet):
    gpts[i, :len(f.xy)] = f.xy
    gpts[i, len(f.xy):] = f.xy[0]
gpts = torch.from_numpy(gpts.reshape(-1, 2)).cuda()
for k, radius in ((8, None), (64, 150.0)):
    compiler = CompilerParams() if radius is None else CompilerParams(
        index_radius=radius)
    tsg = ts if radius is None else compile_network(generate_city("sf"),
                                                    compiler)
    levers = {} if radius is None else {"search_radius": radius}
    gm = SegmentMatcher(tsg, Config(compiler=compiler, matcher=MatcherParams(
        candidate_backend="grid", max_candidates=k, **levers)))
    call = (lambda gm=gm, tsg=tsg, k=k: cand.find_candidates(
        gpts, gm.tables, tsg.meta, gm.params.search_radius, k))
    res = call()
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in res:
        h.update(x.cpu().numpy().tobytes())
    out["cases"][f"grid_k{k}"] = {
        "call_ms": cuda_ms(call), **device_ms(call),
        "peak_bytes": peak(call), "sha256": h.hexdigest()}
wide = SegmentMatcher(ts, MatcherParams(sweep_autotune=False,
                                        max_candidates=64,
                                        search_radius=150.0))
tr = Trace(uuid="probe", xy=xy, times=pr.times)
for form, exact in (("terminal", False), ("exact", True)):
    wide.match_topk(tr, exact=exact)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wide.match_topk(tr, exact=exact)
        times.append((time.perf_counter() - t0) * 1e3)
    out[f"{form}_ms"] = statistics.median(times)
    out[f"{form}_runs_ms"] = times
    out[f"{form}_peak_bytes"] = peak(lambda: wide.match_topk(tr,
                                                             exact=exact))
print(json.dumps(out))
"""

_KEYS = ("call_ms", "keep_device_ms", "forward_device_ms",
         "backtrack_device_ms", "grid_device_ms", "kernels", "peak_bytes")
_RATIO_KEYS = ("call_ms", "keep_device_ms", "forward_device_ms",
               "backtrack_device_ms", "grid_device_ms")
_CALL_KEYS = ("terminal_ms", "terminal_peak_bytes", "exact_ms",
              "exact_peak_bytes")


def _median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts of the repo")
    ap.add_argument("--reps", type=int, default=20, help="timed runs")
    ap.add_argument("--out", help="also write every result line here")
    ap.add_argument("--cases", nargs="*", default=["8", "64@150"],
                    help="K or K@RADIUS (m) per case, each at R = 1 and K")
    ap.add_argument("--lattice-only", action="store_true",
                    help="only the cases: no keep_b64, grid or match_topk")
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    results = []
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, "-c", _RUN, root,
                               str(args.reps), ",".join(args.cases),
                               "1" if args.lattice_only else "0"], cwd=root,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        print(json.dumps(res), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    cases = list(results[0]["cases"])
    equal = all(len({r["cases"][c]["sha256"] for r in results}) == 1
                for c in cases)
    medians, spread = {}, {}
    for root in roots:
        mine = [r for r in results if r["root"] == root]
        medians[root] = {c: {key: _median(r["cases"][c][key] for r in mine)
                             for key in _KEYS} for c in cases}
        if args.lattice_only:
            continue
        for key in _CALL_KEYS:
            medians[root][key] = statistics.median(r[key] for r in mine)
        spread[root] = {form: [min(min(r[f"{form}_runs_ms"]) for r in mine),
                               max(max(r[f"{form}_runs_ms"]) for r in mine)]
                        for form in ("terminal", "exact")}
    summary = {"card": card, "order": [r["root"] for r in results],
               "results_equal": equal, "medians": medians,
               "match_topk_min_max_ms": spread}
    if len(roots) == 2:
        a, b = roots
        summary["ratio_first_over_second"] = {
            c: {key: (medians[a][c][key] / medians[b][c][key]
                      if medians[a][c][key] and medians[b][c][key]
                      else None)
                for key in _RATIO_KEYS} for c in cases}
    if args.out:
        with open(args.out, "w") as f:
            for res in results:
                f.write(json.dumps(res) + "\n")
            f.write(json.dumps(summary) + "\n")
    print(json.dumps(summary))
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
