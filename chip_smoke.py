"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (reporter_tpu_torch) at full size and holds
every CUDA kernel of it against its plain PyTorch version, in phases:

  1. device   — require CUDA; print the card's name and power limit;
  2. build    — nvcc-build kernels/sweep_exact.cu (all five arms, one
                source, sm_90a) into reporter_tpu_torch/_build/; the
                ptxas figures of every kernel instance and each arm's
                launch shape (threads, ring depth, dynamic shared memory,
                CTAs per SM, SMs, grid);
  3. tiles    — compile the synthetic "sf" metro (~5.3k directed edges);
  4. kernel   — 1024 traces x 120 points padded to the 128 bucket
                (131,072 points) through all five sweep arms (block, sub,
                sub_bf16, mxu, mxu_bf16, each an instance of
                sweep_exact.cu's kernel) and
                through _dense_plain on the card: edge, offset and dist
                must be bit-equal; CUDA-event times of each, as the median
                of single launches (``ms``, the yardstick of every earlier
                run) and per launch in a back-to-back run
                (``ms_back_to_back``). The ring-fed arms' chunk order
                kernel against _chunk_order. The work spread over chunks
                and warps. The kernel's slice
                votes against the plain vote; for the coarse arms, its gate
                decisions (a debug launch) against the plain gates: equal
                for the bf16 filter; for the tensor-core pass different
                only within 1e-3 of the threshold; the vote and gate shares
                of (warp, slice) pairs, and for each gated arm the share
                of voted tiles whose gate passed in its first group of
                columns (which must all have been swept);
     gates    — the same checks on parallel streets 500 m apart, where
                every coarse gate culls: the gate share must be below the
                vote share, so a gate that admits every slice (a wrong
                mma fragment layout) fails here;
  5. main     — with a fresh autotune cache, SegmentMatcher(ts) calibrates
                every arm and serves the fastest (no calibration error
                allowed); match_many on the 1024 traces with it and with a
                matcher pinned to each arm (records all equal); one
                match(request). Each of these runs is its own launch
                window (counts set to 0 just before, read just after): the
                calibration must launch every arm, each served run only
                the arm it serves;
     breakdown — one slice's sweep per arm, Viterbi and pack timed alone
                beside the calibration's per-arm times, and the device busy
                share of one wire entry (torch.profiler);
     reference — golden fixture ids on the card, and card-vs-CPU records
                on a small batch;
  6. summary  — the kernels JSON line, the card line, and the final
                {"ok": true, "device": {...}} line.

Any failed phase raises and the script exits non-zero without the final
line. Every time printed carries the card name and power limit.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# peak rates of one H100 SXM (dense, no sparsity) at its full 700 W limit
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores (data sheet)
H100_BF16_FLOPS = 133.8e12    # bf16 outside the tensor cores (NVIDIA Hopper
#                               architecture white paper, H100 SXM5 table)
H100_TF32_TC_FLOPS = 495e12   # tf32 tensor cores (data sheet)
H100_BF16_TC_FLOPS = 989e12   # bf16 tensor cores (data sheet)
H100_HBM_BYTES_S = 3.35e12    # HBM3 bandwidth (data sheet)
SWEEP_OPS_PER_PAIR = 24       # f32 operations per exactly swept (point, column) pair
BF16_OPS_PER_PAIR = 18        # the bf16 filter per pair: 17 bf16 operations + a min
MMA_OPS_PER_PAIR = 16         # the tensor-core pass per pair: 8 multiply-adds
N_TRACES, N_POINTS, BUCKET = 1024, 120, 128
GATE_REL_TOL = 1e-3           # tensor-core vs plain gate: decisions may differ
#                               only where the plain minimum is this close
#                               (relative) to the threshold (summation order)

# arm → (MatcherParams levers, the TPU kernel it replaces)
ARMS = {
    "block": (dict(sweep_subcull=False),
              "reporter_tpu/ops/dense_candidates.py:389"),
    "sub": ({}, "reporter_tpu/ops/dense_candidates.py:433"),
    "sub_bf16": (dict(sweep_lowp="bf16"),
                 "reporter_tpu/ops/dense_candidates.py:567"),
    "mxu": (dict(sweep_mxu=True), "reporter_tpu/ops/dense_candidates.py:521"),
    "mxu_bf16": (dict(sweep_mxu=True, sweep_lowp="bf16"),
                 "reporter_tpu/ops/dense_candidates.py:549"),
}
PLAN_ARMS = {"block": "block", "subcull": "sub", "subcull+bf16": "sub_bf16",
             "mxu": "mxu", "mxu+bf16": "mxu_bf16"}


def phase(tag: str, card: str, **fields) -> None:
    print(f"[{tag}] [{card}] " + json.dumps(fields), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed runs,
    each timed alone (the host's time to issue it included)."""
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


def launch_ms(fn, runs: int = 20) -> float:
    """Milliseconds per call of ``fn`` in a back-to-back run of ``runs``
    calls between two CUDA events, after a warm-up call."""
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


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name: the
    innermost length-prefixed identifier that ends in "_kernel" (a hash's
    digits may run into its length), then its ILi..E arguments (e.g.
    sweep_exact_kernel<3>)."""
    found = None
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            ident = mangled[m.end():m.end() + int(m.group()[i:])]
            if ident.endswith("_kernel") and ident[:1].isalpha() \
                    and (found is None or len(ident) < len(found)):
                found = ident
    if found is None:
        return mangled
    rest = mangled[mangled.rindex(found) + len(found):]
    args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0]) \
        if rest.startswith("I") else []
    return found + (f"<{','.join(args)}>" if args else "")


def ptxas_figures(log: str) -> list:
    """Per kernel of a ptxas -v log: its name and template arguments,
    registers, static shared memory and spill bytes."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            out.append({"kernel": kernel_name(m.group(1))})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[-1]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def fleet_points(fleet):
    pts = np.zeros((len(fleet), BUCKET, 2), np.float32)
    for i, p in enumerate(fleet):
        pts[i, :len(p.xy)] = p.xy
        pts[i, len(p.xy):] = p.xy[0]
    return pts.reshape(-1, 2)


def kernel_gates(dc, arm, fpts, ids, nhits, pack, sub, feat, coarse, radius,
                 k, sweep):
    """The kernel's (warp, slice) vote and gate decisions (one debug
    launch) against the plain vote and gates; raises where they disagree
    beyond the stated tolerance. → (kernel decisions, plain gate or None,
    fields to print)."""
    log = torch.zeros((ids.shape[0], dc._P // 32, ids.shape[1]),
                      dtype=torch.int32, device="cuda")
    dc.sweep_topk(fpts, ids, nhits, sweep, sub, coarse, radius, k, arm,
                  gate_log=log)
    kg = dc.decode_gate_log(log)
    if not torch.equal(kg.vote, dc._slice_votes(
            fpts, ids, nhits, sub, dc.cull_radius(radius) ** 2)):
        raise SystemExit(f"arm {arm}: the kernel's slice votes differ from "
                         "the plain vote")
    if arm == "sub":
        return kg, None, {}, None
    if arm == "sub_bf16":
        pg = dc._coarse_bf16_gate(fpts, ids, nhits, pack, sub, radius)
        differ = pg.gate != kg.gate
        off, tol = differ, 0
    else:
        pg = dc._coarse_mxu_gate(fpts, ids, nhits, sub, feat, radius,
                                 "bf16" if arm == "mxu_bf16" else "off")
        differ = pg.gate != kg.gate
        off = differ & ((pg.cmin - pg.thr).abs() > GATE_REL_TOL * pg.thr)
        tol = f"relative {GATE_REL_TOL} of the threshold"
    if off.any():
        raise SystemExit(f"{arm} gate: {int(off.sum())} decisions differ "
                         f"from the plain gate beyond the tolerance {tol}")
    # bit 8 + s: slice s's gate passed in its first group of columns
    first = dc.decode_gate_log(log >> 8).vote
    if (first & ~kg.gate).any():
        raise SystemExit(f"{arm}: a gate passed early but was not swept")
    fields = {"gate_mismatches": int(differ.sum()),
              "gate_mismatches_off_threshold": int(off.sum()),
              "gate_tolerance": tol,
              "gate_first_group_share_of_voted":
                  int(first.sum()) / max(int(kg.vote.sum()), 1)}
    return kg, pg, fields, first


def order_phase(card, dc, build, fpts, ids, nhits, sweep, sub, radius, k):
    """The ring-fed call's chunk order kernel against its plain version,
    _chunk_order (tolerance 0), and the counter it zeroes: after the sweep
    it must hold nchunks + grid (each CTA fails one take)."""
    nchunks, nblocks = ids.shape
    order = torch.full((nchunks + 1,), -7, dtype=torch.int32, device="cuda")
    out = [torch.empty((nchunks * dc._P, k), dtype=dt, device="cuda")
           for dt in (torch.int32, torch.float32, torch.float32)]
    rc = dc.cull_radius(radius)
    build.launch_sweep_exact(fpts, ids, nhits, order, sweep, sub, None,
                             dc.SWEEP_ARMS.index("sub"), nchunks, nblocks,
                             radius * radius, rc * rc, radius, *out)
    sh = build.exact_shape(dc.SWEEP_ARMS.index("sub"))
    grid = min(nchunks, sh["ctas_per_sm"] * sh["sms"])
    equal = torch.equal(order[:nchunks], dc._chunk_order(nhits))
    counter = int(order[nchunks])
    phase("kernel:order", card, chunks=nchunks, equal_to_plain=equal,
          counter=counter, grid=grid)
    if not equal or counter != nchunks + grid:
        raise SystemExit("the chunk order kernel differs from _chunk_order "
                         f"(equal {equal}) or its counter ended at {counter}")


def spread_phase(card, dc, nhits, kg):
    """The work spread the exact kernel balances: hit blocks per chunk,
    and (from the sub arm's votes) voted (warp, slice) tiles per chunk
    and per (warp, hit block)."""
    per_chunk = kg.vote.sum(dim=(1, 2, 3)).float()
    hit = (torch.arange(kg.vote.shape[2], device="cuda")[None, :]
           < nhits[:, None])                             # [nc, slot]
    per_wb = kg.vote.sum(3).float()[hit[:, None, :].expand(
        -1, kg.vote.shape[1], -1)]
    phase("kernel:spread", card, chunks=int(nhits.numel()),
          hit_blocks_per_chunk={"max": int(nhits.max()),
                                "mean": float(nhits.float().mean())},
          voted_tiles_per_chunk={"max": int(per_chunk.max()),
                                 "mean": float(per_chunk.mean())},
          voted_slices_per_warp_block={"max": int(per_wb.max()),
                                       "mean": float(per_wb.mean()),
                                       "zero_share": float((per_wb == 0)
                                                           .float().mean())})


def kernel_phase(card, tab, pts, radius, k, dc, build):
    """Every arm against _dense_plain on the same points, its gate against
    the plain gate, its time and its bound; the work spread.
    → {arm: record}."""
    n = pts.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    nchunks = n // dc._P
    fpts, fval = dc._fill_invalid(pts, valid, nchunks)

    def prepass():
        return dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], radius,
                                   nchunks)

    ids, nhits = prepass()
    pack, sub, feat = tab["seg_pack"], tab["seg_sub"], tab["seg_feat"]
    sweep, co_tab = tab["seg_sweep"], tab["seg_coarse"]
    order_phase(card, dc, build, fpts, ids, nhits, sweep, sub, radius, k)
    ref = dc._dense_plain(pts, pack, radius, k)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: dc._dense_plain(pts, pack, radius, k), reps=3,
                       warmup=1)
    prepass_ms = cuda_ms(prepass, reps=20)
    nblocks = ids.shape[1]
    hit = torch.arange(nblocks, device="cuda")[None, :] < nhits[:, None]
    used = torch.zeros(nblocks, dtype=torch.bool, device="cuda")
    used[ids[hit].long()] = True
    n_used = int(used.sum())
    io_bytes = (pts.numel() * 4 + ids.numel() * 4 + nhits.numel() * 4
                + n * k * 12)
    slices = int(nhits.sum()) * (dc._P // 32) * (dc._SBLK // dc._SUB)
    tile = 32 * dc._SUB                       # pairs of one (warp, slice)
    arms = {}
    for arm in dc.SWEEP_ARMS:
        def run(a=arm):
            return dc.sweep_topk(fpts, ids, nhits, sweep, sub, co_tab,
                                 radius, k, a)
        got = run()
        torch.cuda.synchronize()
        mism = {f: int((g != r).sum()) for f, g, r in
                zip(("edge", "offset", "dist"), got, ref)}
        err = max(float((got[1] - ref[1]).abs().max()),
                  float((got[2] - ref[2]).abs().max()))
        if any(mism.values()):
            raise SystemExit(f"kernel arm {arm} disagrees with _dense_plain: {mism}")
        rec = {"mismatches": mism, "max_abs_err": err,
               "ms": cuda_ms(run, reps=20), "ms_back_to_back": launch_ms(run),
               "plain_ms": plain_ms}
        nbytes = io_bytes + n_used * dc.SP_NCOMP * dc._SBLK * 4
        if arm == "block":
            exact = int(nhits.sum()) * dc._SBLK * dc._P
            coarse, coarse_rate = 0, None
        else:
            kg, pg, fields, first = kernel_gates(
                dc, arm, fpts, ids, nhits, pack, sub, feat, co_tab, radius,
                k, sweep)
            if arm == "sub":
                spread_phase(card, dc, nhits, kg)
            nbytes += n_used * sub.shape[1] * 4
            exact = int(kg.gate.sum()) * tile
            coarse, coarse_rate = 0, None
            rec.update(vote_share=int(kg.vote.sum()) / slices,
                       gate_share=int(kg.gate.sum()) / slices, **fields)
            if pg is not None:
                rec["plain_gate_share"] = int(pg.gate.sum()) / slices
            if arm != "sub":
                # the pairs the gate's early exit leaves to test: a group
                # where it passed in its first, at least two where it
                # passed later, all 128 columns where it culled
                later = int((kg.gate & ~first).sum())
                culled = int((kg.vote & ~kg.gate).sum())
                group = build.exact_shape(
                    dc.SWEEP_ARMS.index(arm))["gate_group"]
                coarse = 32 * (int(first.sum()) * group + later * 2 * group
                               + culled * dc._SUB)
                coarse_rate = {"sub_bf16": H100_BF16_FLOPS,
                               "mxu": H100_TF32_TC_FLOPS,
                               "mxu_bf16": H100_BF16_TC_FLOPS}[arm]
                # the gate's table columns of every slice some warp voted
                # for: the feat rows, or the filter's five bf16 fields
                bs = torch.zeros((nblocks, dc._SBLK // dc._SUB),
                                 dtype=torch.bool, device="cuda")
                v = kg.vote.any(1)                         # [nc, slot, nsub]
                c, j, s = v.nonzero(as_tuple=True)
                bs[ids[c, j].long(), s] = True
                per_col = dc.SF_NCOMP * 4 if arm.startswith("mxu") \
                    else dc.FL_NCOMP * 2
                nbytes += int(bs.sum()) * dc._SUB * per_col
        t_exact = exact * SWEEP_OPS_PER_PAIR / H100_F32_FLOPS * 1e3
        t_coarse = (coarse * (BF16_OPS_PER_PAIR if arm == "sub_bf16"
                              else MMA_OPS_PER_PAIR) / coarse_rate * 1e3
                    if coarse else 0.0)
        # the bf16 filter shares the CUDA cores with the exact pass (times
        # add); the tensor cores may run beside them (the larger counts)
        t_ops = t_exact + t_coarse if arm == "sub_bf16" \
            else max(t_exact, t_coarse)
        t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
        rec.update(exact_pairs=exact, coarse_pairs=coarse, bytes=nbytes,
                   coarse_rate_flops=coarse_rate,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        arms[arm] = rec
        phase(f"kernel:{arm}", card, points=n, prepass_ms=prepass_ms,
              mean_hit_blocks=float(nhits.float().mean()), **rec)
    return arms


def gates_phase(card, dc, radius, k):
    """Parallel streets 500 m apart (8 m segments every 10 m) and 256
    patches of 32 points within 30 m of a centre: the coarse gates cull a
    share of the voted slices here (on sf the tensor-core gate admits every
    voted slice). Every arm bit-equal to _dense_plain; each coarse gate
    held to its plain version and required to cull."""
    x = np.arange(0.0, 4000.0, 10.0)
    y = np.arange(0.0, 4000.0, 500.0)
    a = np.stack(np.meshgrid(x, y), -1).reshape(-1, 2).astype(np.float32)
    b = (a + np.float32([8.0, 0.0])).astype(np.float32)
    sp = dc.build_seg_pack(a, b, np.arange(len(a), dtype=np.int32),
                           np.zeros(len(a), np.float32),
                           np.full(len(a), 8.0, np.float32))
    pack, bbox, sub, feat, sweep, coarse = (torch.from_numpy(v).cuda()
                                            for v in sp)
    rng = np.random.default_rng(4)
    centres = rng.uniform(0.0, 4000.0, (256, 1, 2))
    pts = torch.from_numpy((centres + rng.uniform(-30.0, 30.0, (256, 32, 2)))
                           .reshape(-1, 2).astype(np.float32)).cuda()
    nchunks = pts.shape[0] // dc._P
    fpts, fval = dc._fill_invalid(
        pts, torch.ones(pts.shape[0], dtype=torch.bool, device="cuda"),
        nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, bbox, radius, nchunks)
    ref = dc._dense_plain(pts, pack, radius, k)
    out = {}
    for arm in dc.SWEEP_ARMS:
        got = dc.sweep_topk(fpts, ids, nhits, sweep, sub, coarse, radius, k,
                            arm)
        mism = sum(int((g != r).sum()) for g, r in zip(got, ref))
        if mism:
            raise SystemExit(f"parallel streets: arm {arm} differs from "
                             f"_dense_plain in {mism} values")
        if arm in ("block", "sub"):
            continue
        kg, pg, fields, _ = kernel_gates(dc, arm, fpts, ids, nhits, pack,
                                         sub, feat, coarse, radius, k, sweep)
        vote, gate, plain = (int(kg.vote.sum()), int(kg.gate.sum()),
                             int(pg.gate.sum()))
        out[arm] = dict(voted=vote, gate_passed=gate, plain_gate_passed=plain,
                        **fields)
        if not (gate < vote and plain < vote):
            raise SystemExit(f"parallel streets: the {arm} gate culls "
                             f"nothing ({gate} and plain {plain} of {vote})")
    phase("gates:rows", card, points=int(pts.shape[0]),
          segments=len(a), arms=out)


def main_phase(card, ts, fleet, dc, MatcherParams, SegmentMatcher, Trace):
    """Construction (calibration), the tuned batch, one pinned matcher's
    batch per arm and one request, each its own launch window.
    → (tuned matcher, traces, records, launches by path, tuner report)."""
    from reporter_tpu_torch.matcher.autotune import CAL_DISPATCHES

    traces = [Trace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]

    def window(fn):
        """fn() with every launch count set to 0 just before it and read
        just after. → (fn's result, the counts)."""
        for key in dc.SWEEP_LAUNCHES:
            dc.SWEEP_LAUNCHES[key] = 0
        out = fn()
        return out, dict(dc.SWEEP_LAUNCHES)

    def only(counts, arm, what):
        if counts[arm] < 1 or any(n for a, n in counts.items() if a != arm):
            raise SystemExit(f"{what} should launch {arm} and no other arm: "
                             f"{counts}")

    t0 = time.perf_counter()
    m, cal = window(lambda: SegmentMatcher(ts))
    build_s = time.perf_counter() - t0
    rep = m.tuned_report
    cand_ms = {lab: c["device_ms_per_dispatch"]
               for lab, c in rep.get("candidates", {}).items()}
    phase("autotune", card, plan=m.tuned_plan and m.tuned_plan.label,
          source=rep.get("source"), construct_s=build_s,
          calibration_seconds=rep.get("calibration_seconds"),
          calibration_dispatches=rep.get("calibration_dispatches"),
          candidate_ms=cand_ms, errors=rep.get("errors"),
          calibration_launches=cal)
    if rep.get("errors") or rep.get("source") != "measured" \
            or m.tuned_plan is None or len(cand_ms) != len(dc.SWEEP_ARMS):
        raise SystemExit(f"calibration did not measure every arm: {rep}")
    # one warm-up and CAL_DISPATCHES timed launches of every arm
    if any(n != CAL_DISPATCHES + 1 for n in cal.values()):
        raise SystemExit(f"calibration launches: {cal}")
    tuned = PLAN_ARMS[m.tuned_plan.label.split("@")[0]]
    m.match_many(traces[:64])                     # warm the allocator
    m.stage_seconds = dict.fromkeys(m.stage_seconds, 0.0)
    m.point_counts = dict.fromkeys(m.point_counts, 0)
    t0 = time.perf_counter()
    recs, served = window(lambda: m.match_many(traces))
    batch_s = time.perf_counter() - t0
    only(served, tuned, "the tuned matcher's batch")
    st, pc = dict(m.stage_seconds), dict(m.point_counts)
    want = [[r.to_json() for r in x] for x in recs]
    pinned_s, pinned = {}, {}
    for arm, (levers, _) in ARMS.items():
        pm, built = window(lambda lv=levers: SegmentMatcher(
            ts, MatcherParams(sweep_autotune=False, **lv)))
        if any(built.values()) or pm.tuned_plan is not None:
            raise SystemExit(f"the matcher pinned to {arm} tuned: {built}")
        t0 = time.perf_counter()
        got, pinned[arm] = window(lambda pm=pm: pm.match_many(traces))
        pinned_s[arm] = time.perf_counter() - t0
        only(pinned[arm], arm, f"the matcher pinned to {arm}")
        if [[r.to_json() for r in x] for x in got] != want:
            raise SystemExit(f"the matcher pinned to {arm} differs from the "
                             "tuned matcher")
    answer, req = window(lambda: m.match(fleet[0].to_report_json()))
    only(req, tuned, "the request")
    by_path = {a: {"calibration": cal[a], "tuned_batch": served[a],
                   "pinned_batch": pinned[a][a], "request": req[a]}
               for a in dc.SWEEP_ARMS}
    n_rec = sum(len(r) for r in recs)
    phase("main", card, traces=len(traces), probes=N_TRACES * N_POINTS,
          tuned_arm=tuned,
          probes_per_s=N_TRACES * N_POINTS / batch_s, batch_ms=batch_s * 1e3,
          prepare_ms=st["prepare"] * 1e3, device_ms=st["device"] * 1e3,
          walk_ms=st["walk"] * 1e3, records=n_rec,
          unmatched_share=pc["unmatched"] / max(pc["points"], 1),
          pinned_batch_ms={a: s * 1e3 for a, s in pinned_s.items()},
          request_segments=len(answer["segments"]),
          launches_by_path=by_path)
    if not n_rec or not answer["segments"]:
        raise SystemExit("main path produced no records")
    for rs in recs:
        for r in rs:
            if not (np.isfinite(r.length) and np.isfinite(r.start_time)
                    and np.isfinite(r.end_time)):
                raise SystemExit(f"non-finite record {r}")
    return m, traces, recs, by_path, cand_ms


def breakdown_phase(card, m, ts, traces, cand_ms, MatcherParams):
    """Where the device time of one slice goes: the sweep (pre-pass +
    kernel) per arm, the Viterbi and the wire pack, each timed alone."""
    from reporter_tpu_torch.ops import match as match_ops
    from reporter_tpu_torch.ops.hmm import viterbi_decode_batched
    from torch.profiler import ProfilerActivity, profile

    work, sliced = m.plan_submit(traces)
    ps = m.prepare_submit_slice(traces, work, *sliced[0])
    if ps.mode == 0:
        bpts = torch.from_numpy(ps.pts).cuda()
    else:                          # the wire entries' integer decode
        q = torch.from_numpy(ps.payload).cuda().to(torch.int32)
        if ps.mode == 2:
            q = torch.cumsum(q, 1, dtype=torch.int32)
        bpts = (torch.from_numpy(ps.origins).cuda()[:, None, :]
                + q.to(torch.float32) * match_ops.OFFSET_QUANTUM)
    lens = torch.from_numpy(ps.lens).cuda()
    bval = match_ops._valid(lens, bpts.shape[1])
    p = m.params
    cands = match_ops.batch_candidates(bpts, bval, m.tables, p)
    vit_args = (p.sigma_z, p.beta, p.max_route_distance_factor,
                p.breakage_distance, p.backward_slack, p.interpolation_distance)
    vit = viterbi_decode_batched(cands, bpts, bval, m.tables, *vit_args)
    out = match_ops.MatchOutput(vit.edge, vit.offset, vit.chain_start,
                                vit.matched)
    cand_arm_ms = {}
    for arm, (levers, _) in ARMS.items():
        pa = MatcherParams(sweep_autotune=False, **levers)
        cand_arm_ms[arm] = cuda_ms(lambda pa=pa: match_ops.batch_candidates(
            bpts, bval, m.tables, pa), reps=10)
    stage_ms = {
        "viterbi": cuda_ms(lambda: viterbi_decode_batched(
            cands, bpts, bval, m.tables, *vit_args), reps=5, warmup=1),
        "pack": cuda_ms(lambda: match_ops._pack_wire(
            out, ts.num_edges, m.wire_spec), reps=5),
        "wire_entry": cuda_ms(lambda: m.submit_prepared(ps), reps=5,
                              warmup=1)}
    # device busy share of one wire entry: kernel time summed by the
    # profiler over the entry's wall time (None if the trace shows none)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.submit_prepared(ps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_run = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels_run)
    top = sorted(kernels_run, key=lambda e: -e.self_device_time_total)
    phase("breakdown", card, slice_traces=len(ps.ws), bucket=ps.b,
          mode=ps.mode, candidates_ms_by_arm=cand_arm_ms,
          calibration_ms_by_arm_128x64={PLAN_ARMS[lab.split("@")[0]]: v
                                        for lab, v in cand_ms.items()},
          fastest_here=min(cand_arm_ms, key=cand_arm_ms.get),
          **{f"{k}_ms": v for k, v in stage_ms.items()},
          device_busy_share=busy_us / wall_us if busy_us else None,
          device_kernel_launches=sum(e.count for e in kernels_run),
          top_device_ms={e.key[:60]: e.self_device_time_total / 1e3
                         for e in top[:5]})


def main() -> int:
    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port's modules: a copy of this script without the repo stops here
    from reporter_tpu_torch.config import CompilerParams, MatcherParams
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.ops import dense_candidates as dc
    from reporter_tpu_torch.tiles.compiler import compile_network
    from reporter_tpu_torch.tiles.tileset import tables_from_numpy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = smi.strip()
    print(card, flush=True)
    phase("device", card, torch=torch.__version__, cuda=torch.version.cuda,
          name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.load_sweep()
    built = {src: {"nvcc_seconds": log["seconds"],
                   "kernels": ptxas_figures(log["ptxas"])}
             for src, log in build.BUILD_LOG.items()}
    phase("build", card, seconds=time.perf_counter() - t0, sources=built)
    # the persistent grid is min(chunks, CTAs per SM x SMs); the kernel
    # phase runs 512 chunks
    shapes = {arm: build.exact_shape(code)
              for code, arm in enumerate(dc.SWEEP_ARMS)}
    for sh in shapes.values():
        sh["grid_at_512_chunks"] = min(512, sh["ctas_per_sm"] * sh["sms"])
    phase("build:exact_shape", card, **shapes)

    # ---- 3. tiles ---------------------------------------------------------
    t0 = time.perf_counter()
    ts = compile_network(generate_city("sf"))
    tab = tables_from_numpy(ts.arrays(), "cuda")
    phase("tiles", card, seconds=time.perf_counter() - t0,
          edges=ts.num_edges, line_segments=int(len(ts.seg_edge)),
          seg_pack_columns=int(tab["seg_pack"].shape[1]),
          blocks=int(tab["seg_bbox"].shape[0]))

    # ---- 4. kernel vs plain ----------------------------------------------
    fleet = synthesize_fleet(ts, N_TRACES, num_points=N_POINTS, seed=0)
    pts = torch.from_numpy(fleet_points(fleet)).cuda()      # [131072, 2]
    radius, k = MatcherParams().search_radius, MatcherParams().max_candidates
    arms = kernel_phase(card, tab, pts, radius, k, dc, build)
    gates_phase(card, dc, radius, k)

    # ---- 5. main path (calibration included), breakdown, reference -------
    with tempfile.TemporaryDirectory(prefix="rtt_autotune_") as cache:
        os.environ["RTPU_AUTOTUNE_CACHE"] = cache     # every run calibrates
        m, traces, recs, launches, cand_ms = main_phase(
            card, ts, fleet, dc, MatcherParams, SegmentMatcher, Trace)
        breakdown_phase(card, m, ts, traces, cand_ms, MatcherParams)

        here = os.path.dirname(os.path.abspath(__file__))
        with open(os.path.join(here, "tests", "fixtures",
                               "golden_traces.json")) as f:
            golden = json.load(f)
        gts = compile_network(generate_city(golden[0]["city"]),
                              CompilerParams(**golden[0]["compiler"]))
        gm = SegmentMatcher(gts)
        golden_ok = all([s["segment_id"] for s in gm.match(g["request"])["segments"]]
                        == g["expected_segment_ids"] for g in golden)
        small = traces[:32]
        cpu_recs = SegmentMatcher(ts, device="cpu").match_many(small)
        cpu_ok = ([[r.to_json() for r in x] for x in cpu_recs]
                  == [[r.to_json() for r in x] for x in recs[:32]])
        phase("reference", card, golden_fixture_ok=golden_ok,
              golden_plan=gm.tuned_plan and gm.tuned_plan.label,
              card_vs_cpu_records_equal=cpu_ok, traces_checked=len(small))
        if not (golden_ok and cpu_ok):
            raise SystemExit("reference check failed")

    # ---- 6. summary -------------------------------------------------------
    kernels = []
    for arm, (_, replaces) in ARMS.items():
        a = arms[arm]
        kernels.append({
            "name": f"sweep_topk_{arm}", "route": "cuda",
            "source": "reporter_tpu_torch/kernels/sweep_exact.cu",
            "replaces": replaces, "launches": sum(launches[arm].values()),
            "launches_by_path": launches[arm],
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "ms_back_to_back": a["ms_back_to_back"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
