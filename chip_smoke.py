"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (reporter_tpu_torch) at full size on two
metros, the synthetic grid city "sf" and the irregular "organic" metro,
and holds every CUDA kernel of it against its plain PyTorch version, and
the native host half against its Python forms, in phases:

  1. device   — require CUDA; print the card's name and power limit;
  2. build    — nvcc-build kernels/sweep_exact.cu once per top-K width of
                SWEEP_KS (the five arms at that K, sm_90a; the five nvcc
                started together) and g++-build the host library
                (native/prepare.cc, walker.cc) into reporter_tpu_torch/
                _build/, with the build times side by side; the ptxas
                figures of every kernel instance and each arm's launch
                shape at each K (threads, ring depth, dynamic shared
                memory, CTAs per SM, SMs, grid);
  3. tiles    — compile "sf" (~5.3k directed edges);
  4. kernel   — on sf, 1024 traces x 120 points padded to the 128 bucket
                (131,072 points) through all five sweep arms at K = 8
                (block, sub, sub_bf16, mxu, mxu_bf16) and through
                _dense_plain on the card: edge, offset and dist must be
                bit-equal; CUDA-event times of each, as the median of
                single launches (``ms``) and per launch in a back-to-back
                run (``ms_back_to_back``); bound, vote and gate shares.
                The chunk order kernel against _chunk_order; the work
                spread; each coarse gate's decisions (a debug launch)
                against its plain gate, equal for the bf16 filter, for the
                tensor-core pass different only within 1e-3 of the
                threshold, with the share of voted tiles whose gate passed
                in its first group of columns;
     kernel:k — every arm at every K of SWEEP_KS on the same 131,072
                points (512 chunks, more than the persistent grid at every
                K, so CTAs take second chunks), every arm equal to the
                others on all of them and bit-equal to _dense_plain at that
                K on 64 chunks: the first 32 and the last 32 the CTAs take
                (heaviest first, so these are taken after a CTA's first
                chunk); the same times and bounds;
     gates    — parallel streets 500 m apart, where every coarse gate
                culls: the gate share must be below the vote share;
  5. main     — with a fresh autotune cache, SegmentMatcher(ts) calibrates
                every arm and serves the fastest (no calibration error
                allowed); match_many on the 1024 traces, BATCH_RUNS times
                after a warm-up (median, min-max spread and stage
                medians: prepare, dispatch, device, walk), then once with
                a matcher pinned to each arm (records all equal); one
                match(request). Each of these runs is its own launch
                window (counts set to 0 just before, read just after): the
                calibration must launch every arm, each served run only
                the kernel instance it serves;
     walk     — on the tuned batch, the C walk through match_many, the
                Python walk (build_segments) and NativeWalker.walk of the
                same decoded arrays must give equal records (to_json(),
                tolerance 0), each walk timed; the C prepare against the
                numpy form (bytes equal, timed); and, in 256-trace slices,
                whether the harvest's walk overlaps the wait in .cpu();
     main:k   — at each other K, a tuned matcher (calibration launches
                every arm at that K) serves the 1024 traces (512 chunks of
                the sweep), whose first 16 records equal the CPU matcher's
                at that K;
     breakdown — one slice's sweep per arm, Viterbi and pack timed alone,
                and the device busy share of one wire entry
                (torch.profiler);
     reference — golden fixture ids on the card, and card-vs-CPU records
                on a small batch;
  6. organic  — generate_city("organic") (seed 11, 62,757 directed edges),
                compiled by the port (timed); its kernel phase (131,072
                fleet points, every arm equal to the others, bit-equal to
                _dense_plain on 64 chunks as in kernel:k, gate checks,
                shares), gates line, main phase (tuned matcher, BATCH_RUNS
                batches, records equal across it and five pinned
                matchers), walk phase (the three walks and the prepares,
                as on sf) and card-vs-CPU records on 32 traces, each line
                tagged metro=organic;
  7. summary  — the kernels JSON line (every arm at every K, the sources,
                the host library among them), the card line, and the
                final {"ok": true, "device": {...}} line.

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
from concurrent.futures import ThreadPoolExecutor

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
CHECK_CHUNKS = 64             # chunks held against _dense_plain where not
#                               all are (the plain sweep is slow): 16,384 points
BATCH_RUNS = 5                # timed match_many batches after the warm-up
MAIN_K_CPU_TRACES = 16        # traces of the main path at the other K also
#                               matched on the CPU
REFERENCE_TRACES = 32         # traces matched on both the card and the CPU
OVERLAP_SLICE = 256           # traces per slice of the overlap check
SOURCES = ("reporter_tpu_torch/kernels/sweep_exact.cu",
           "reporter_tpu_torch/kernels/topk.cuh",
           "reporter_tpu_torch/native/prepare.cc",
           "reporter_tpu_torch/native/walker.cc")
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
    fields to print, first-group passes or None)."""
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


def order_phase(card, dc, build, fpts, ids, nhits, sweep, sub, radius, k,
                metro):
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
    sh = build.exact_shape(dc.SWEEP_ARMS.index("sub"), k)
    grid = min(nchunks, sh["ctas_per_sm"] * sh["sms"])
    equal = torch.equal(order[:nchunks], dc._chunk_order(nhits))
    counter = int(order[nchunks])
    phase("kernel:order", card, metro=metro, chunks=nchunks,
          equal_to_plain=equal, counter=counter, grid=grid)
    if not equal or counter != nchunks + grid:
        raise SystemExit("the chunk order kernel differs from _chunk_order "
                         f"(equal {equal}) or its counter ended at {counter}")


def spread_phase(card, dc, nhits, kg, metro):
    """The work spread the exact kernel balances: hit blocks per chunk,
    and (from the sub arm's votes) voted (warp, slice) tiles per chunk
    and per (warp, hit block)."""
    per_chunk = kg.vote.sum(dim=(1, 2, 3)).float()
    hit = (torch.arange(kg.vote.shape[2], device="cuda")[None, :]
           < nhits[:, None])                             # [nc, slot]
    per_wb = kg.vote.sum(3).float()[hit[:, None, :].expand(
        -1, kg.vote.shape[1], -1)]
    phase("kernel:spread", card, metro=metro, chunks=int(nhits.numel()),
          hit_blocks_per_chunk={"max": int(nhits.max()),
                                "mean": float(nhits.float().mean())},
          voted_tiles_per_chunk={"max": int(per_chunk.max()),
                                 "mean": float(per_chunk.mean())},
          voted_slices_per_warp_block={"max": int(per_wb.max()),
                                       "mean": float(per_wb.mean()),
                                       "zero_share": float((per_wb == 0)
                                                           .float().mean())})


def check_rows(dc, nhits, n_chunks):
    """Point rows of ``n_chunks`` chunks: the first half in point order and
    the last half in the order the persistent CTAs take them
    (_chunk_order, heaviest first): with more chunks than the grid, those
    are taken by a CTA after its first. → (rows i64, chunk ids i64)."""
    order = dc._chunk_order(nhits).long()
    half = n_chunks // 2
    chunks = torch.unique(torch.cat([
        torch.arange(half, device="cuda"), order[-(n_chunks - half):]]))
    rows = (chunks[:, None] * dc._P
            + torch.arange(dc._P, device="cuda")[None, :]).reshape(-1)
    return rows, chunks


def kernel_phase(card, tab, pts, radius, k, dc, build, metro, tag="kernel",
                 check_chunks=None, plain_reps=3):
    """Every arm on the same points at top-K width k: equal to the first
    arm on all of them and bit-equal to _dense_plain on all of them, or
    on ``check_chunks`` chunks (check_rows); its gate against the plain
    gate, its time and its bound; the chunk order and the work spread
    (tag "kernel"). → {arm: record}."""
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
    if tag == "kernel":
        order_phase(card, dc, build, fpts, ids, nhits, sweep, sub, radius, k,
                    metro)
    if check_chunks is None:
        rows, chunks = torch.arange(n, device="cuda"), None
    else:
        rows, chunks = check_rows(dc, nhits, check_chunks)
    check_n = int(rows.numel())
    cpts = pts[rows]
    ref = dc._dense_plain(cpts, pack, radius, k)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: dc._dense_plain(cpts, pack, radius, k),
                       reps=plain_reps, warmup=1 if plain_reps > 1 else 0)
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
    arms, first_out = {}, None
    for arm in dc.SWEEP_ARMS:
        def run(a=arm):
            return dc.sweep_topk(fpts, ids, nhits, sweep, sub, co_tab,
                                 radius, k, a)
        got = run()
        torch.cuda.synchronize()
        mism = {f: int((g[rows] != r).sum()) for f, g, r in
                zip(("edge", "offset", "dist"), got, ref)}
        err = max(float((got[1][rows] - ref[1]).abs().max()),
                  float((got[2][rows] - ref[2]).abs().max()))
        if any(mism.values()):
            raise SystemExit(f"{metro} K={k}: kernel arm {arm} disagrees "
                             f"with _dense_plain: {mism}")
        if first_out is None:
            first_out = got
        elif not all(torch.equal(g, f) for g, f in zip(got, first_out)):
            raise SystemExit(f"{metro} K={k}: kernel arm {arm} differs from "
                             f"arm {dc.SWEEP_ARMS[0]} on {n} points")
        sh = build.exact_shape(dc.SWEEP_ARMS.index(arm), k)
        grid = min(nchunks, sh["ctas_per_sm"] * sh["sms"])
        rec = {"mismatches": mism, "max_abs_err": err,
               "ms": cuda_ms(run, reps=20), "ms_back_to_back": launch_ms(run),
               "plain_ms": plain_ms, "plain_points": check_n,
               "chunks": nchunks, "grid": grid}
        if chunks is not None:
            # checked chunks a CTA takes after its first (order position
            # at or past the grid)
            pos = torch.empty(nchunks, dtype=torch.long, device="cuda")
            pos[dc._chunk_order(nhits).long()] = torch.arange(
                nchunks, device="cuda")
            rec["checked_chunks_taken_later"] = int(
                (pos[chunks] >= grid).sum())
            if nchunks > grid and not rec["checked_chunks_taken_later"]:
                raise SystemExit(f"{metro} K={k} {arm}: no checked chunk is "
                                 "taken after a CTA's first")
        nbytes = io_bytes + n_used * dc.SP_NCOMP * dc._SBLK * 4
        if arm == "block":
            exact = int(nhits.sum()) * dc._SBLK * dc._P
            coarse, coarse_rate = 0, None
        else:
            kg, pg, fields, first = kernel_gates(
                dc, arm, fpts, ids, nhits, pack, sub, feat, co_tab, radius,
                k, sweep)
            if arm == "sub" and tag == "kernel":
                spread_phase(card, dc, nhits, kg, metro)
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
                    dc.SWEEP_ARMS.index(arm), k)["gate_group"]
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
        phase(tag if tag != "kernel" else f"kernel:{arm}", card, metro=metro,
              arm=arm, k=k, points=n, prepass_ms=prepass_ms,
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


class Windows:
    """Launch windows of the main path: ``run(path, fn)`` sets every
    instance's launch count to 0 just before fn() and reads them just
    after; the counts are kept per path."""

    def __init__(self, dc):
        self.dc = dc
        self.by_path: dict = {}

    def run(self, path, fn):
        for key in self.dc.SWEEP_LAUNCHES:
            self.dc.SWEEP_LAUNCHES[key] = 0
        out = fn()
        counts = dict(self.dc.SWEEP_LAUNCHES)
        self.by_path[path] = counts
        return out, counts


def only(counts, inst, what):
    """The run launched instance ``inst`` (arm, K) and no other."""
    if counts[inst] < 1 or any(n for i, n in counts.items() if i != inst):
        raise SystemExit(f"{what} should launch {inst} and no other "
                         f"instance: { {i: n for i, n in counts.items() if n} }")


def json_records(recs):
    return [[r.to_json() for r in x] for x in recs]


def timed_batches(m, traces):
    """A warm-up match_many, then BATCH_RUNS timed ones. → (the last
    run's records, fields: the batch's median, min-max spread and stage
    medians, in ms)."""
    m.match_many(traces)
    m.point_counts = dict.fromkeys(m.point_counts, 0)
    walls, stages, first = [], {k: [] for k in m.stage_seconds}, None
    for _ in range(BATCH_RUNS):
        m.stage_seconds = dict.fromkeys(m.stage_seconds, 0.0)
        t0 = time.perf_counter()
        recs = m.match_many(traces)
        walls.append(time.perf_counter() - t0)
        for key, v in m.stage_seconds.items():
            stages[key].append(v)
        if first is None:
            first = json_records(recs)
    if json_records(recs) != first:
        raise SystemExit("match_many gave different records on two runs")
    med = statistics.median(walls)
    probes = sum(len(t.xy) for t in traces)
    pc = m.point_counts
    return recs, {
        "batches": BATCH_RUNS, "batch_ms_median": med * 1e3,
        "batch_ms_min": min(walls) * 1e3, "batch_ms_max": max(walls) * 1e3,
        "spread_pct_of_median": (max(walls) - min(walls)) / med * 100,
        "probes_per_s": probes / med,
        **{f"{key}_ms": statistics.median(v) * 1e3
           for key, v in stages.items()},
        "unmatched_share": pc["unmatched"] / max(pc["points"], 1)}


def main_phase(card, ts, fleet, dc, win, metro, MatcherParams,
               SegmentMatcher, Trace, request=True):
    """Construction (calibration), the tuned batch timed BATCH_RUNS times,
    one pinned matcher's batch per arm and one request, each its own
    launch window. → (tuned matcher, traces, records, batch fields, tuner
    report's per-arm ms)."""
    from reporter_tpu_torch.matcher.autotune import CAL_DISPATCHES

    traces = [Trace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]
    t0 = time.perf_counter()
    m, cal = win.run(f"{metro}:calibration", lambda: SegmentMatcher(ts))
    build_s = time.perf_counter() - t0
    rep = m.tuned_report
    cand_ms = {lab: c["device_ms_per_dispatch"]
               for lab, c in rep.get("candidates", {}).items()}
    phase("autotune", card, metro=metro,
          plan=m.tuned_plan and m.tuned_plan.label,
          source=rep.get("source"), construct_s=build_s,
          calibration_seconds=rep.get("calibration_seconds"),
          calibration_dispatches=rep.get("calibration_dispatches"),
          candidate_ms=cand_ms, errors=rep.get("errors"),
          calibration_launches={a: n for (a, k), n in cal.items() if n})
    if rep.get("errors") or rep.get("source") != "measured" \
            or m.tuned_plan is None or len(cand_ms) != len(dc.SWEEP_ARMS):
        raise SystemExit(f"calibration did not measure every arm: {rep}")
    # one warm-up and CAL_DISPATCHES timed launches of every arm at K = 8
    if any(n != (CAL_DISPATCHES + 1 if k == 8 else 0)
           for (a, k), n in cal.items()):
        raise SystemExit(f"calibration launches: {cal}")
    tuned = PLAN_ARMS[m.tuned_plan.label.split("@")[0]]
    m.match_many(traces[:64])                     # warm the allocator
    (recs, fields), served = win.run(f"{metro}:tuned_batch",
                                     lambda: timed_batches(m, traces))
    only(served, (tuned, 8), f"{metro}: the tuned matcher's batches")
    want = json_records(recs)
    pinned_ms = {}
    for arm, (levers, _) in ARMS.items():
        pm, built = win.run(f"{metro}:pinned_build",
                            lambda lv=levers: SegmentMatcher(
                                ts, MatcherParams(sweep_autotune=False,
                                                  **lv)))
        if any(built.values()) or pm.tuned_plan is not None:
            raise SystemExit(f"the matcher pinned to {arm} tuned: {built}")
        t0 = time.perf_counter()
        got, counts = win.run(f"{metro}:pinned_batch:{arm}",
                              lambda pm=pm: pm.match_many(traces))
        pinned_ms[arm] = (time.perf_counter() - t0) * 1e3
        only(counts, (arm, 8), f"{metro}: the matcher pinned to {arm}")
        if json_records(got) != want:
            raise SystemExit(f"{metro}: the matcher pinned to {arm} differs "
                             "from the tuned matcher")
    n_req = None
    if request:
        answer, req = win.run(f"{metro}:request",
                              lambda: m.match(fleet[0].to_report_json()))
        only(req, (tuned, 8), "the request")
        n_req = len(answer["segments"])
        if not n_req:
            raise SystemExit("the request matched no segment")
    n_rec = recs.n_records
    phase("main", card, metro=metro, traces=len(traces),
          probes=sum(len(t.xy) for t in traces), tuned_arm=tuned,
          records=n_rec, pinned_batch_ms=pinned_ms,
          request_segments=n_req, result=type(recs).__name__, **fields)
    if not n_rec:
        raise SystemExit("main path produced no records")
    c = recs.columns
    if not (np.isfinite(c.length).all() and np.isfinite(c.start_time).all()
            and np.isfinite(c.end_time).all()):
        raise SystemExit(f"{metro}: non-finite record fields")
    return m, traces, recs, fields, cand_ms


def walk_phase(card, m, ts, traces, recs, fields, MatcherParams,
               SegmentMatcher, metro):
    """The three walks of the tuned batch (the C walk through match_many,
    the Python walk, NativeWalker.walk of the same decoded arrays), equal
    record for record; the C prepare against the numpy form; whether the
    harvest's walk overlaps the main thread's wait in .cpu() in
    OVERLAP_SLICE-trace slices."""
    from reporter_tpu_torch.matcher import native_prepare
    from reporter_tpu_torch.matcher.api import walk_python

    decoded = m._decode_many(traces)
    t0 = time.perf_counter()
    py = walk_python(ts, traces, decoded, m._route_fn,
                     m.params.backward_slack)
    py_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    direct = m._walk_decoded(traces, decoded)
    direct_ms = (time.perf_counter() - t0) * 1e3
    want = json_records(recs)
    equal = {"python_walk": json_records(py) == want,
             "native_walker_walk": json_records(direct) == want}
    work, sliced = m.plan_submit(traces)
    xys = [work[w][2] for w in sliced[0][1]]
    c_prep = native_prepare.prepare_slice(xys, sliced[0][0])
    np_prep = native_prepare.prepare_slice_python(xys, sliced[0][0])
    prep_equal = c_prep[0] == np_prep[0] and all(
        a.tobytes() == b.tobytes() for a, b in zip(c_prep[1:], np_prep[1:])
        if a is not None)
    prep_ms = {name: 1e3 * statistics.median(
        _seconds(lambda f=f: f(xys, sliced[0][0])) for _ in range(5))
        for name, f in (("c", native_prepare.prepare_slice),
                        ("numpy", native_prepare.prepare_slice_python))}
    # the overlap: slices of OVERLAP_SLICE traces, so the worker walks
    # slice k while the main thread waits on slice k + 1
    om = SegmentMatcher(ts, m.params.replace(max_device_batch=OVERLAP_SLICE,
                                             sweep_autotune=False))
    om.match_many(traces)
    om.stage_seconds = dict.fromkeys(om.stage_seconds, 0.0)
    orecs = om.match_many(traces)
    st = {k: v * 1e3 for k, v in om.stage_seconds.items()}
    serial = st["prepare"] + st["dispatch"] + st["device"] + st["walk"]
    phase("walk", card, metro=metro, records_equal=equal,
          walk_ms={"c_match_many_median": fields["walk_ms"],
                   "python": py_ms, "native_walker_walk": direct_ms},
          prepare_ms={"c": prep_ms["c"], "numpy": prep_ms["numpy"],
                      "bytes_equal": prep_equal, "mode": int(c_prep[0]),
                      "slice_traces": len(xys)},
          overlap={"slices": -(-len(traces) // OVERLAP_SLICE),
                   "stage_ms": st, "serial_sum_ms": serial,
                   "overlapped_ms": serial - st["wall"],
                   "records_equal": json_records(orecs) == want})
    if not (all(equal.values()) and prep_equal
            and json_records(orecs) == want):
        raise SystemExit(f"{metro}: the walks or the prepares differ")


def _seconds(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main_k_phase(card, ts, traces, dc, win, MatcherParams, SegmentMatcher,
                 cache):
    """The main path at every other K of SWEEP_KS: a tuned matcher (its
    calibration launches every arm at that K) serves the batch of
    ``traces`` (at 1024 traces, 512 sweep chunks: more than the grid);
    its first MAIN_K_CPU_TRACES records equal the CPU matcher's. The
    tuner's cache is keyed by tile and card, not K, so each K gets a
    fresh cache directory under ``cache`` (or it would reuse K = 8's
    plan and calibrate nothing)."""
    from reporter_tpu_torch.matcher.autotune import CAL_DISPATCHES

    for k in dc.SWEEP_KS:
        if k == 8:
            continue
        os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, f"k{k}")
        p = MatcherParams(max_candidates=k)
        m, cal = win.run(f"sf:k{k}:calibration",
                         lambda p=p: SegmentMatcher(ts, p))
        if m.tuned_plan is None or any(
                n != (CAL_DISPATCHES + 1 if kk == k else 0)
                for (a, kk), n in cal.items()):
            raise SystemExit(f"K={k}: calibration launches {cal}")
        tuned = PLAN_ARMS[m.tuned_plan.label.split("@")[0]]
        batch = traces
        t0 = time.perf_counter()
        recs, served = win.run(f"sf:k{k}:tuned_batch",
                               lambda m=m, b=batch: m.match_many(b))
        ms = (time.perf_counter() - t0) * 1e3
        only(served, (tuned, k), f"the tuned matcher at K={k}")
        small = batch[:MAIN_K_CPU_TRACES]
        cpu = SegmentMatcher(ts, p, device="cpu").match_many(small)
        equal = json_records(cpu) == json_records(recs[:MAIN_K_CPU_TRACES])
        phase("main:k", card, metro="sf", k=k, tuned_arm=tuned,
              traces=len(batch), batch_ms=ms, records=recs.n_records,
              card_vs_cpu_records_equal=equal, traces_checked=len(small))
        if not equal or not recs.n_records:
            raise SystemExit(f"K={k}: the card's records differ from the "
                             "CPU's, or there are none")
    os.environ["RTPU_AUTOTUNE_CACHE"] = cache


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


def organic_phase(card, dc, build, win, MatcherParams, SegmentMatcher, Trace,
                  generate_city, compile_network, tables_from_numpy,
                  synthesize_fleet, radius):
    """The irregular metro at full width: compile, kernel phase, gates
    line, main phase, walk phase and card-vs-CPU records, tagged
    metro=organic. → {arm: kernel record}."""
    t0 = time.perf_counter()
    net = generate_city("organic")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts = compile_network(net)
    compile_s = time.perf_counter() - t0
    tab = tables_from_numpy(ts.arrays(), "cuda")
    phase("tiles", card, metro="organic", generate_s=gen_s,
          compile_s=compile_s, edges=ts.num_edges, nodes=net.num_nodes,
          line_segments=int(len(ts.seg_edge)),
          seg_pack_columns=int(tab["seg_pack"].shape[1]),
          blocks=int(tab["seg_bbox"].shape[0]),
          reach_truncated_nodes=ts.stats["reach_truncated_nodes"])
    fleet = synthesize_fleet(ts, N_TRACES, num_points=N_POINTS, seed=0)
    pts = torch.from_numpy(fleet_points(fleet)).cuda()
    arms = kernel_phase(card, tab, pts, radius, 8, dc, build, "organic",
                        check_chunks=CHECK_CHUNKS, plain_reps=1)
    phase("gates", card, metro="organic", arms={
        a: {key: r.get(key) for key in (
            "vote_share", "gate_share", "plain_gate_share",
            "gate_mismatches", "gate_mismatches_off_threshold",
            "gate_tolerance", "gate_first_group_share_of_voted")}
        for a, r in arms.items() if a not in ("block", "sub")},
        fastest_back_to_back=min(arms, key=lambda a:
                                 arms[a]["ms_back_to_back"]))
    m, traces, recs, fields, _ = main_phase(
        card, ts, fleet, dc, win, "organic", MatcherParams, SegmentMatcher,
        Trace, request=False)
    walk_phase(card, m, ts, traces, recs, fields, MatcherParams,
               SegmentMatcher, "organic")
    small = traces[:REFERENCE_TRACES]
    cpu_recs = SegmentMatcher(ts, device="cpu").match_many(small)
    cpu_ok = json_records(cpu_recs) == json_records(recs[:REFERENCE_TRACES])
    phase("reference", card, metro="organic", card_vs_cpu_records_equal=cpu_ok,
          traces_checked=len(small))
    if not cpu_ok:
        raise SystemExit("organic: the card's records differ from the CPU's")
    return arms


def main() -> int:
    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port's modules: a copy of this script without the repo stops here
    from reporter_tpu_torch.config import CompilerParams, MatcherParams
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.native import build as native_build
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

    # ---- 2. build: every K's nvcc and the host library's g++ at once ------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        cuda_job = pool.submit(build.build_all)
        host_job = pool.submit(native_build.load)
        cuda_job.result()
        host_job.result()
    built = {lib: {"nvcc_seconds": log["seconds"],
                   "kernels": ptxas_figures(log["ptxas"])}
             for lib, log in build.BUILD_LOG.items()}
    # a library already built from the same sources (by an earlier run in
    # this checkout) is loaded, not rebuilt, and shows no build time
    phase("build", card, seconds=time.perf_counter() - t0, sources=built,
          host_library={"sources": list(SOURCES[2:]),
                        "gxx_seconds": native_build.BUILD_LOG.get("seconds")})
    # the persistent grid is min(chunks, CTAs per SM x SMs); the kernel
    # phase runs 512 chunks
    shapes = {}
    for k in dc.SWEEP_KS:
        for code, arm in enumerate(dc.SWEEP_ARMS):
            sh = build.exact_shape(code, k)
            sh["grid_at_512_chunks"] = min(512, sh["ctas_per_sm"] * sh["sms"])
            shapes[f"{arm}@k{k}"] = sh
    phase("build:exact_shape", card, **shapes)

    # ---- 3. tiles ---------------------------------------------------------
    t0 = time.perf_counter()
    ts = compile_network(generate_city("sf"))
    tab = tables_from_numpy(ts.arrays(), "cuda")
    phase("tiles", card, metro="sf", seconds=time.perf_counter() - t0,
          edges=ts.num_edges, line_segments=int(len(ts.seg_edge)),
          seg_pack_columns=int(tab["seg_pack"].shape[1]),
          blocks=int(tab["seg_bbox"].shape[0]))

    # ---- 4. kernel vs plain, at K = 8 and at every K -----------------------
    fleet = synthesize_fleet(ts, N_TRACES, num_points=N_POINTS, seed=0)
    pts = torch.from_numpy(fleet_points(fleet)).cuda()      # [131072, 2]
    radius = MatcherParams().search_radius
    arms = kernel_phase(card, tab, pts, radius, 8, dc, build, "sf")
    by_k = {k: kernel_phase(card, tab, pts, radius, k, dc, build, "sf",
                            tag="kernel:k", check_chunks=CHECK_CHUNKS)
            for k in dc.SWEEP_KS}
    gates_phase(card, dc, radius, 8)

    # ---- 5. main path (calibration included), walk, breakdown, reference -
    win = Windows(dc)
    with tempfile.TemporaryDirectory(prefix="rtt_autotune_") as cache:
        os.environ["RTPU_AUTOTUNE_CACHE"] = cache     # every run calibrates
        m, traces, recs, fields, cand_ms = main_phase(
            card, ts, fleet, dc, win, "sf", MatcherParams, SegmentMatcher,
            Trace)
        walk_phase(card, m, ts, traces, recs, fields, MatcherParams,
                   SegmentMatcher, "sf")
        main_k_phase(card, ts, traces, dc, win, MatcherParams, SegmentMatcher,
                     cache)
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
        small = traces[:REFERENCE_TRACES]
        cpu_recs = SegmentMatcher(ts, device="cpu").match_many(small)
        cpu_ok = json_records(cpu_recs) == json_records(
            recs[:REFERENCE_TRACES])
        phase("reference", card, golden_fixture_ok=golden_ok,
              golden_plan=gm.tuned_plan and gm.tuned_plan.label,
              card_vs_cpu_records_equal=cpu_ok, traces_checked=len(small))
        if not (golden_ok and cpu_ok):
            raise SystemExit("reference check failed")

        # ---- 6. the organic metro -----------------------------------------
        organic = organic_phase(card, dc, build, win, MatcherParams,
                                SegmentMatcher, Trace, generate_city,
                                compile_network, tables_from_numpy,
                                synthesize_fleet, radius)

    # ---- 7. summary -------------------------------------------------------
    kernels = []
    for arm, (_, replaces) in ARMS.items():
        for k in dc.SWEEP_KS:
            a = arms[arm] if k == 8 else by_k[k][arm]
            paths = {path: c[arm, k] for path, c in win.by_path.items()
                     if c[arm, k]}
            entry = {
                "name": f"sweep_topk_{arm}_k{k}", "route": "cuda",
                "source": SOURCES[0], "replaces": replaces,
                "launches": sum(paths.values()), "launches_by_path": paths,
                "points": len(pts), "plain_points": a["plain_points"],
                "max_abs_err": a["max_abs_err"], "ms": a["ms"],
                "ms_back_to_back": a["ms_back_to_back"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": None}
            if k == 8:
                o = organic[arm]
                entry["organic"] = {key: o[key] for key in (
                    "ms", "ms_back_to_back", "bound_ms", "bound_by",
                    "plain_ms", "plain_points", "max_abs_err")}
            if entry["launches"] < 1:
                raise SystemExit(f"{arm} at K={k} was never launched on the "
                                 "main path")
            kernels.append(entry)
    print(json.dumps({"kernels": kernels, "sources": list(SOURCES),
                      "host_library": {
                          "sources": list(SOURCES[2:]), "route": "g++",
                          "seconds": native_build.BUILD_LOG.get("seconds")}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
