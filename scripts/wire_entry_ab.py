"""Time the port's wire entry and batch for several checkouts, in turns, on
one card.

    python3 scripts/wire_entry_ab.py [--reps N] [--out PATH] ROOT [ROOT ...]

Runs each ROOT in turn and then the ROOTs in reverse (A B B A for two),
each in a process of its own with that checkout's root first on
``sys.path``, so that two versions of the port are compared within one
call on one card. Each process builds the sweep at K = 8, compiles the sf
tile, makes the seeded 1024-trace fleet that chip_smoke.py matches, pins a
matcher to the ``sub`` arm (no tuning: every checkout runs the same
instance) and times, each run alone and after warm-up runs:

- ``wire_entry_ms``: ``submit_prepared`` of the batch's first slice
  (``plan_submit``'s; ``slice_traces`` says its size), the candidates,
  Viterbi and wire pack, CUDA events, median of N;
- ``viterbi_ms``: ``viterbi_decode_batched`` on that slice's candidates,
  CUDA events, median of N;
- ``batch_ms``: ``match_many`` of the 1024 traces, the host's clock,
  median of 5;
- ``kernels``: the CUDA kernels of one wire entry (``torch.profiler``);
- ``wire_sha256``: the wire's bytes, so the versions' outputs can be held
  equal.

Each process prints one JSON line; the script prints them, the card's
``nvidia-smi`` name and power limit, and last one JSON line with the
medians per root. Needs one card; imports nothing of JAX.
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
sys.path.insert(0, root)
import numpy as np
import torch
from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.kernels import build
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.ops import match as match_ops
from reporter_tpu_torch.ops.hmm import viterbi_decode_batched
from reporter_tpu_torch.tiles.compiler import compile_network
from torch.profiler import ProfilerActivity, profile

assert build.__file__.startswith(root), build.__file__
build.build(build.EXACT_SOURCE, 8)
ts = compile_network(generate_city("sf"))
fleet = synthesize_fleet(ts, 1024, num_points=120, seed=0)
traces = [Trace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
          for p in fleet]
m = SegmentMatcher(ts, MatcherParams(sweep_autotune=False))
work, sliced = m.plan_submit(traces)
ps = m.prepare_submit_slice(traces, work, *sliced[0])
if ps.mode == 0:
    bpts = torch.from_numpy(ps.pts).cuda()
else:                           # the wire entries' integer decode
    q = torch.from_numpy(ps.payload).cuda().to(torch.int32)
    if ps.mode == 2:
        q = torch.cumsum(q, 1, dtype=torch.int32)
    bpts = (torch.from_numpy(ps.origins).cuda()[:, None, :]
            + q.to(torch.float32) * match_ops.OFFSET_QUANTUM)
bval = match_ops._valid(torch.from_numpy(ps.lens).cuda(), bpts.shape[1])
p = m.params
cands = match_ops.batch_candidates(bpts, bval, m.tables, p)
vit_args = (p.sigma_z, p.beta, p.max_route_distance_factor,
            p.breakage_distance, p.backward_slack, p.interpolation_distance)


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


wire = m.submit_prepared(ps).cpu().numpy()
wire_ms = cuda_ms(lambda: m.submit_prepared(ps), reps)
vit_ms = cuda_ms(lambda: viterbi_decode_batched(cands, bpts, bval, m.tables,
                                                *vit_args), reps)
m.match_many(traces)
batch = []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.match_many(traces)
    torch.cuda.synchronize()
    batch.append((time.perf_counter() - t0) * 1e3)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    m.submit_prepared(ps)
    torch.cuda.synchronize()
kernels = sum(e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA)
print(json.dumps({"root": root, "wire_entry_ms": wire_ms, "viterbi_ms": vit_ms,
                  "batch_ms": statistics.median(batch), "batch_runs_ms": batch,
                  "kernels": kernels, "slice_traces": len(ps.ws),
                  "mode": ps.mode,
                  "wire_sha256": hashlib.sha256(wire.tobytes()).hexdigest()}))
"""

_KEYS = ("wire_entry_ms", "viterbi_ms", "batch_ms", "kernels")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts of the repo")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed runs of the wire entry and the Viterbi")
    ap.add_argument("--out", help="also write every result line here")
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    results = []
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, "-c", _RUN, root,
                               str(args.reps)], cwd=root, capture_output=True,
                              text=True, timeout=900)
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
    summary = {"card": card, "order": [r["root"] for r in results],
               "wire_equal": len({r["wire_sha256"] for r in results}) == 1,
               "medians": {root: {key: statistics.median(
                   r[key] for r in results if r["root"] == root)
                   for key in _KEYS} for root in roots}}
    if args.out:
        with open(args.out, "w") as f:
            for res in results:
                f.write(json.dumps(res) + "\n")
            f.write(json.dumps(summary) + "\n")
    print(json.dumps(summary))
    return 0 if summary["wire_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
