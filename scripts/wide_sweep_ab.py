"""Time the sweep kernel past K = 16 for several checkouts, in turns, on one
card.

    python3 scripts/wide_sweep_ab.py [--reps N] [--ks 16,20,24,32,48,64]
        [--out PATH] ROOT [ROOT ...]

Runs each ROOT in turn and then the ROOTs in reverse (A B B A for two),
each in a process of its own with that checkout's root first on
``sys.path``, so that two versions of the port's wide instances are
compared within one call on one card. Each process builds the sweep at
K = 16 and the wide library, compiles the sf tile, makes the seeded
1024-trace fleet that chip_smoke.py matches (131,072 points), runs the
cull pre-pass at a 150 m search radius (where most sf points hold more
than 16 edges within reach) and calls ``sweep_topk`` in every arm at each
K, recording:

- ``ms``: CUDA events around one call, median of N calls each alone;
- ``ms_back_to_back``: per call, N calls between two events;
- the instance's launch shape (``build.exact_shape``: dynamic shared
  memory, CTAs per SM, ring depth) and where it keeps its lists
  (``dense_candidates.list_plan`` where the checkout has it);
- ``sha256``: the outputs' bytes per K (edge, offset, dist), which must
  be equal across arms and across checkouts.

Each process prints one JSON line; the script prints them, the card's
``nvidia-smi`` name and power limit, and last one JSON line with the
medians per root, each wide K's ratio to K = 16 of the same process, and
whether every output agreed. Needs one card; imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_RUN = r"""
import hashlib, json, statistics, sys
from concurrent.futures import ThreadPoolExecutor
root, reps, ks = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, root)
import numpy as np
import torch
from reporter_tpu_torch.kernels import build
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.ops import dense_candidates as dc
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import tables_from_numpy

assert build.__file__.startswith(root), build.__file__
ks = [int(k) for k in ks.split(",")]
with ThreadPoolExecutor(2) as pool:
    list(pool.map(lambda k: build.build(build.EXACT_SOURCE, k),
                  sorted({build.library_key(k) for k in ks})))
RADIUS = 150.0
ts = compile_network(generate_city("sf"))
tab = tables_from_numpy(ts.arrays(), "cuda")
fleet = synthesize_fleet(ts, 1024, num_points=120, seed=0)
pts = np.zeros((len(fleet), 128, 2), np.float32)
for i, p in enumerate(fleet):
    pts[i, :len(p.xy)] = p.xy
    pts[i, len(p.xy):] = p.xy[0]
pts = torch.from_numpy(pts.reshape(-1, 2)).cuda()
n = pts.shape[0]
nchunks = n // dc._P
fpts, fval = dc._fill_invalid(
    pts, torch.ones(n, dtype=torch.bool, device="cuda"), nchunks)
ids, nhits = dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], RADIUS,
                                 nchunks)


def cuda_ms(fn, reps, warmup=2):
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


def launch_ms(fn, runs):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


out, digest = {}, {}
for k in ks:
    for code, arm in enumerate(dc.SWEEP_ARMS):
        def run(a=arm, k=k):
            return dc.sweep_topk(fpts, ids, nhits, tab["seg_sweep"],
                                 tab["seg_sub"], tab["seg_coarse"], RADIUS,
                                 k, a)
        got = run()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in got:
            h.update(t.cpu().numpy().tobytes())
        digest.setdefault(k, set()).add(h.hexdigest())
        sh = build.exact_shape(code, k)
        plan = dc.list_plan(arm, k)[0] if hasattr(dc, "list_plan") else (
            "wide" if dc.is_wide(k) else "register")
        out.setdefault(arm, {})[k] = {
            "ms": cuda_ms(run, reps), "ms_back_to_back": launch_ms(run, reps),
            "smem_bytes": sh["smem_bytes"], "ctas_per_sm": sh["ctas_per_sm"],
            "depth": sh["depth"], "lists": plan}
print(json.dumps({"root": root, "arms": out,
                  "sha256": {k: sorted(v) for k, v in digest.items()}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts of the repo")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls per arm and K")
    ap.add_argument("--ks", default="16,20,24,32,48,64",
                    help="top-K widths, the first the register yardstick")
    ap.add_argument("--out", help="also write every result line here")
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    results = []
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, "-c", _RUN, root,
                               str(args.reps), args.ks], cwd=root,
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
    ks = [k for k in args.ks.split(",")]
    base = ks[0]
    digests = {k: {d for r in results for d in r["sha256"][k]} for k in ks}
    medians, ratios = {}, {}
    for root in roots:
        mine = [r for r in results if r["root"] == root]
        for arm in mine[0]["arms"]:
            for k in ks:
                rec = {key: statistics.median(r["arms"][arm][k][key]
                                              for r in mine)
                       for key in ("ms", "ms_back_to_back")}
                rec.update({key: mine[0]["arms"][arm][k][key] for key in (
                    "smem_bytes", "ctas_per_sm", "depth", "lists")})
                medians.setdefault(root, {}).setdefault(arm, {})[k] = rec
            for k in ks[1:]:
                ratios.setdefault(root, {}).setdefault(arm, {})[k] = {
                    key: statistics.median(
                        r["arms"][arm][k][key] / r["arms"][arm][base][key]
                        for r in mine)
                    for key in ("ms", "ms_back_to_back")}
    summary = {"card": card, "order": [r["root"] for r in results],
               "outputs_equal": all(len(v) == 1 for v in digests.values()),
               "medians": medians, "ratio_to_k": base, "ratios": ratios}
    if args.out:
        with open(args.out, "w") as f:
            for res in results:
                f.write(json.dumps(res) + "\n")
            f.write(json.dumps(summary) + "\n")
    print(json.dumps(summary))
    return 0 if summary["outputs_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
