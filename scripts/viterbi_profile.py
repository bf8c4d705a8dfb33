"""The Viterbi kernel's time by phase on one card: the committed
kernels/viterbi.cu with clock64() marks, on the first wire slice of the
sf fleet.

    python3 scripts/viterbi_profile.py [--out PATH] [--cases K[@RADIUS] ...]

The source is copied with eight phase counters added (text anchors at
the barriers that end each phase, in viterbi_decode_kernel and, where
the source has it, viterbi_decode_wide_kernel; an anchor missing from
the source stops the script): thread 0 of each trace adds the cycles
between the barriers to eight counters (staging, the rows' masks, the
control sequence, the lookups, the recurrence, the carry, the
backtrack, the fill; in the wide kernel the lookups and the recurrence
of each pass of a chunk, so the two interleave), summed over the batch
at the end. The copy is built by kernels/build.py with its flags and
loaded in place of the committed library. For each case (``--cases``:
K at the matcher's default radius, or K@RADIUS in m; by default 8 and
64@150), as ``scripts/wire_entry_ab.py`` makes the inputs (the seeded
1024-trace sf
fleet, a matcher at that K, the first slice of ``plan_submit``: 1024
traces x 128 points), it checks the instrumented decode bit-equal to
``hmm._viterbi_plain`` on the card, then prints one JSON line: each
phase's cycles per trace and per step, its share of the whole, and the
instrumented call's time (CUDA events). Needs one card; imports nothing
of JAX.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_MARK = "if (tid == 0) {{ const unsigned long long _n = clock64(); " \
    "_acc[{k}] += _n - _pt; _pt = _n; }}\n"
# the mark of phase k goes right after its anchor (the group's barrier
# that ends the phase)
_SYNC = "    group_sync(bar, tpt);\n"
_PROFILE_MARKS = [
    (_SYNC + "    // the rows' looked-up slots", 0, 0),
    (_SYNC + "\n    // ---- 2. the control sequence (thread 0)\n", 1,
     len(_SYNC)),
    ("      s_misc[1] = pairs;\n    }\n" + _SYNC, 2, None),
    ("        s_trans[at[u]] = trans;\n      }\n    }\n" + _SYNC, 3, None),
    ("        c_len[k] = c_len[a];\n      }\n    }\n" + _SYNC, 5, None),
]
# the wide kernel's marks, where the source has it: (anchor, phase, the
# mark before the anchor rather than after)
_WIDE_MARKS = [
    ("    __syncthreads();\n    // the rows' looked-up slots (row 0 the "
     "carry), a row a warp at once:\n", 0, False),
    ("      if (lane == 0) s_cnt[r] = count;\n    }\n    __syncthreads();\n",
     1, False),
    ("      s_misc[1] = pairs;\n    }\n    __syncthreads();\n", 2, False),
    ("      __syncthreads();\n\n      // the steps, in order, while their "
     "pairs are in this pass\n", 3, False),
    ("      if (f_hi >= npairs && !more) break;\n", 4, True),
    ("        c_len[k] = c_len[a];\n      }\n    }\n    __syncthreads();\n",
     5, False),
    ("  // ---- 6. the chosen candidates, then the interpolation fill, as\n",
     6, True),
]
PROFILE_PHASES = ("staging", "masks", "control", "lookups", "recurrence",
                  "carry", "backtrack", "fill")


def _profile_source(src):
    """The committed source with the eight phase counters."""
    head = ("__device__ unsigned long long g_prof[8];\n"
            "extern \"C\" int rtt_prof(unsigned long long* out) {\n"
            "  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
            "  unsigned long long z[8] = {0};\n"
            "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n")
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    decl = ("  unsigned long long _acc[8] = {0};\n"
            "  unsigned long long _pt = clock64();\n")
    start = ("  const int sub = tid % G;     // its slice of the previous "
             "candidates\n")
    assert src.count(start) == 1
    src = src.replace(start, start + decl)
    wide = "viterbi_decode_wide_kernel" in src
    if wide:
        wstart = ("  const WideLayout L = make_wide_layout(K, C, T, P, "
                  "p.levels_here != 0);\n")
        assert src.count(wstart) == 1
        src = src.replace(wstart, wstart + decl)
        for anchor, k, before in _WIDE_MARKS:
            assert src.count(anchor) == 1, anchor
            mark = _MARK.format(k=k)
            src = src.replace(anchor, mark + anchor if before
                              else anchor + mark)
    for anchor, k, at in _PROFILE_MARKS:
        assert src.count(anchor) == 1, anchor
        at = len(anchor) if at is None else at
        src = src.replace(anchor, anchor[:at] + _MARK.format(k=k)
                          + anchor[at:])
    for anchor, k in (
            ("    // ---- the last active point's candidates become the carry "
             "row\n", 4),
            ("  // ---- 6. the chosen candidates, then the interpolation fill: "
             "a valid\n", 6)):
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, _MARK.format(k=k) + anchor)
    # the fill's end: each kernel's last lines
    end = "      pok = true;\n    }\n  }\n}\n"
    assert src.count(end) == (2 if wide else 1)
    return src.replace(end, "      pok = true;\n    }\n  }\n"
                       + _MARK.format(k=7)
                       + "  if (tid == 0) for (int q = 0; q < 8; ++q) "
                       "atomicAdd(&g_prof[q], _acc[q]);\n}\n")


def _load_profiled():
    """Build the profiled copy of the source into the build directory
    and make it the library the port's decode launches → its
    ``rtt_prof`` entry (copy the counters out, then zero them)."""
    from reporter_tpu_torch.kernels import build

    src = _profile_source(build.VITERBI_SOURCE.read_text())
    out_dir = Path(ROOT) / "reporter_tpu_torch" / "_build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "viterbi_profile.cu"
    cu.write_text(src)
    for h in build.VITERBI_SOURCE.parent.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    build.VITERBI_SOURCE = cu
    prof = build._viterbi_lib().rtt_prof
    prof.argtypes = [ctypes.c_void_p]
    prof.restype = ctypes.c_int
    return prof


def _inputs(k, radius):
    import numpy as np
    import torch
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.ops import match as match_ops
    from reporter_tpu_torch.tiles.compiler import compile_network

    ts = compile_network(generate_city("sf"))
    fleet = synthesize_fleet(ts, 1024, num_points=120, seed=0)
    traces = [Trace(uuid=q.uuid, xy=q.xy.astype(np.float32), times=q.times)
              for q in fleet]
    levers = {} if radius is None else {"search_radius": radius}
    m = SegmentMatcher(ts, MatcherParams(sweep_autotune=False,
                                         max_candidates=k, **levers))
    work, sliced = m.plan_submit(traces)
    ps = m.prepare_submit_slice(traces, work, *sliced[0])
    if ps.mode == 0:
        bpts = torch.from_numpy(ps.pts).cuda()
    else:
        q = torch.from_numpy(ps.payload).cuda().to(torch.int32)
        if ps.mode == 2:
            q = torch.cumsum(q, 1, dtype=torch.int32)
        bpts = (torch.from_numpy(ps.origins).cuda()[:, None, :]
                + q.to(torch.float32) * match_ops.OFFSET_QUANTUM)
    bval = match_ops._valid(torch.from_numpy(ps.lens).cuda(), bpts.shape[1])
    p = m.params
    cands = match_ops.batch_candidates(bpts, bval, m.tables, p)
    return (cands, bpts, bval, m.tables, p.sigma_z, p.beta,
            p.max_route_distance_factor, p.breakage_distance,
            p.backward_slack, p.interpolation_distance)


def _time(fn, reps):
    import torch

    for _ in range(3):
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
                    help="K or K@RADIUS (m) per case")
    args = ap.parse_args()
    cases = []
    for case in args.cases:
        k, _, radius = case.partition("@")
        cases.append((int(k), float(radius) if radius else None))
    import torch
    from reporter_tpu_torch.ops import hmm

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t0 = time.perf_counter()
    prof = _load_profiled()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = []
    for k, radius in cases:
        args_k = _inputs(k, radius)
        want = hmm._viterbi_plain(*args_k)
        got = hmm.viterbi_decode_batched(*args_k)
        torch.cuda.synchronize()
        if not all(torch.equal(getattr(got, f), getattr(want, f))
                   for f in got._fields):
            raise SystemExit(f"the profiled kernel differs at K={k}")
        counts = (ctypes.c_ulonglong * 8)()
        prof(counts)                                # reset
        ms = _time(lambda: hmm.viterbi_decode_batched(*args_k), 1)
        torch.cuda.synchronize()
        # _time ran 3 warm-up calls and one timed: four calls counted
        prof(counts)
        B, T, _ = (int(x) for x in args_k[0].edge.shape)
        total = sum(counts)
        plan = hmm.viterbi_plan(B, T, k)
        rec = {"k": k, "search_radius": radius or "default", "card": card,
               "kernel": plan.get("kernel", "viterbi_decode_kernel<I>"),
               "plan": plan, "ms_instrumented": ms, "calls": 4,
               "cycles_per_trace": {ph: counts[q] / (4 * B)
                                    for q, ph in enumerate(PROFILE_PHASES)},
               "cycles_per_step": {ph: counts[q] / (4 * B * T)
                                   for q, ph in enumerate(PROFILE_PHASES)},
               "share": {ph: counts[q] / total
                         for q, ph in enumerate(PROFILE_PHASES)}}
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
