"""The ranked-path lattice's forward kernel, its time by phase on one card:
kernels/lattice.cu with clock64() marks, on the 1024-point probe that
chip_smoke.py's [kernel:lattice] runs.

    python3 scripts/lattice_profile.py [--out PATH] [--cases K[@RADIUS] ...]

The source marks its own phases (``RTT_PROFILE_START``, ``RTT_MARK(k)``
after each phase, ``RTT_PROFILE_END`` where a counting thread leaves the
kernel; all three are empty in the build). A copy of it is made with
the three defined as clock64() counters: the first producer thread adds
its phases (the wait for a free buffer, the staging, the rows' masks,
the control sequence, the lookups) and the first merge thread its own
(the wait for a full buffer, a step's first pick, the barrier that ORs
the columns, the other picks and the level, the closing barrier, the
level's copy out and own argmin; in the wide instance, past K = 64: the
looked-up columns' first pass, the OR barrier, the other columns and the
trees' picks, the closing barrier, the own state and an inactive step's
copy out).

The copy is built by kernels/build.py with its flags and loaded in place
of the checkout's library. For each case (``--cases``: K at the
matcher's default radius, or K@RADIUS in m; by default 8 and 64@150),
at R = 1 and R = K, it makes the probe's candidates as match_topk
does (a matcher at that K, no tuning), checks the instrumented forward's
five outputs bit-equal to the plain version's (``_lattice_prep`` +
``_forward_list_plain``, and ``active``) on the card, then prints one JSON
line: each phase's cycles per step and per active step, its share of its
thread's whole, and the instrumented call's time (CUDA events, median of
5). Needs one card; imports nothing of JAX.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

_NPHASE = 12
_PHASES = ("buffer_wait", "staging", "masks", "control", "lookups",
           "full_wait", "first_pick", "barrier_or", "picks_level",
           "barrier_close", "copy_out")
_PRODUCER_PHASES = 5            # the first producer thread's; then the merge
_WHO = ("is_producer && ptid == 0", "!is_producer && mtid == 0")


def _profile_source(src):
    """The source with its three profile macros defined as counters."""
    head = (f"__device__ unsigned long long g_prof[{_NPHASE}];\n"
            "extern \"C\" int rtt_prof(unsigned long long* out) {\n"
            "  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
            f"  unsigned long long z[{_NPHASE}] = {{0}};\n"
            "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n")
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    cond = " || ".join(f"({w})" for w in _WHO)
    defs = {
        "RTT_PROFILE_START": f"unsigned long long _acc[{_NPHASE}] = {{0}}; "
                             "unsigned long long _pt = clock64();",
        "RTT_MARK(k)": "{ const unsigned long long _n = clock64(); "
                       "_acc[k] += _n - _pt; _pt = _n; }",
        "RTT_PROFILE_END": f"if ({cond}) for (int q = 0; q < {_NPHASE}; "
                           "++q) atomicAdd(&g_prof[q], _acc[q]);"}
    for macro, body in defs.items():
        line = f"#define {macro}\n"
        if src.count(line) != 1:
            raise SystemExit(f"lattice.cu: no empty `#define {macro}`")
        src = src.replace(line, f"#define {macro} {body}\n")
    return src


def _load_profiled(build):
    """Build the profiled copy of the checkout's source into its build
    directory and make it the library the wrappers launch → its
    ``rtt_prof`` entry (copies the counts out and zeroes them)."""
    source = build.LATTICE_SOURCE
    out_dir = build._BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "lattice_profile.cu"
    cu.write_text(_profile_source(source.read_text()))
    for h in source.parent.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    build.LATTICE_SOURCE = cu
    lib = build._single_lib(cu, build._LATTICE_SIGNATURES)
    prof = lib.rtt_prof
    prof.argtypes = [ctypes.c_void_p]
    prof.restype = ctypes.c_int
    return prof


def _time(fn, reps):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result line here")
    ap.add_argument("--cases", nargs="*", default=["8", "64@150"],
                    help="K or K@RADIUS (m) per case, each at R = 1 and K")
    args = ap.parse_args()
    cases = []
    for case in args.cases:
        k, _, radius = case.partition("@")
        cases.append((int(k), float(radius) if radius else None))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.matcher.api import SegmentMatcher
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.netgen.traces import synthesize_probe
    from reporter_tpu_torch.ops import hmm
    from reporter_tpu_torch.ops import match as match_ops
    from reporter_tpu_torch.tiles.compiler import compile_network

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t0 = time.perf_counter()
    prof = _load_profiled(build)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ts = compile_network(generate_city("sf"))
    xy = synthesize_probe(ts, seed=7, num_points=1024).xy
    lines = []
    for k, radius in cases:
        rs = (1, k)
        levers = {} if radius is None else {"search_radius": radius}
        m = SegmentMatcher(ts, MatcherParams(sweep_autotune=False,
                                             max_candidates=k, **levers))
        p = m.params
        pts = torch.from_numpy(np.asarray(xy, np.float32)).cuda()
        valid = torch.ones(len(xy), dtype=torch.bool, device="cuda")
        c = match_ops.batch_candidates(pts[None], valid[None], m.tables,
                                       p, m.ts.meta)
        cands = match_ops.CandidateSet(*(x[0] for x in c))
        keep = hmm._keep_mask_batched(pts[:, :, None], valid[:, None],
                                      p.interpolation_distance)[:, 0]
        consts = (p.sigma_z, p.beta, p.max_route_distance_factor,
                  p.breakage_distance, p.backward_slack)
        prep = hmm._lattice_prep(cands, pts, keep, m.tables, *consts)
        n_act = int(prep[1].sum())
        for R in rs:
            def call():
                return hmm._forward_list_cuda(cands, pts, keep, m.tables,
                                              *consts, R)
            got = call()
            want = (*hmm._forward_list_plain(*prep, R), prep[1])
            torch.cuda.synchronize()
            if len(got) != len(want) or not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"the profiled forward differs at K={k}, "
                                 f"R={R}")
            counts = (ctypes.c_ulonglong * _NPHASE)()
            prof(counts)                            # reset
            ms = _time(call, 5)
            torch.cuda.synchronize()
            prof(counts)                            # 2 warm-up + 5 timed
            calls = 7
            T = int(pts.shape[0])
            share = {}
            for qs in (range(_PRODUCER_PHASES),
                       range(_PRODUCER_PHASES, len(_PHASES))):
                tot = sum(counts[q] for q in qs) or 1
                share.update({_PHASES[q]: counts[q] / tot for q in qs})
            rec = {"k": k, "r": R, "search_radius": p.search_radius,
                   "steps": T, "active_steps": n_act,
                   "card": card, "ms_instrumented": ms, "calls": calls,
                   "cycles_per_step": {ph: counts[q] / (calls * T)
                                       for q, ph in enumerate(_PHASES)},
                   "cycles_per_active_step": {
                       ph: counts[q] / (calls * max(n_act, 1))
                       for q, ph in enumerate(_PHASES)},
                   "share_of_thread": share}
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    print(json.dumps({"seconds": time.perf_counter() - t0, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
