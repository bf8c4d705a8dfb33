"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (reporter_tpu_torch) at full size and holds
every CUDA kernel of it against its plain PyTorch version, in phases:

  1. device   — require CUDA; print the card's name and power limit;
  2. build    — nvcc-build kernels/sweep.cu (sm_90a) into reporter_tpu_torch/_build/;
  3. tiles    — compile the synthetic "sf" metro (~5.3k directed edges);
  4. kernel   — 1024 traces x 120 points padded to the 128 bucket
                (131,072 points) through both arms of the sweep kernel and
                through _dense_plain on the card: edge, offset and dist
                must be bit-equal; CUDA-event medians of each;
  5. main     — SegmentMatcher.match_many on the 1024 traces (default
                two-level arm; the whole-block arm too, whose records must
                be equal), launch counts read around that run; one
                match(request);
     breakdown — one slice's sweep, Viterbi and pack timed alone, and the
                device busy share of one wire entry (torch.profiler);
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
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_F32_FLOPS = 67e12       # non-tensor f32 peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12   # HBM3 bandwidth, H100 SXM data sheet
SWEEP_OPS_PER_PAIR = 24      # f32 operations per swept (point, column) pair
N_TRACES, N_POINTS, BUCKET = 1024, 120, 128


def phase(tag: str, card: str, **fields) -> None:
    print(f"[{tag}] [{card}] " + json.dumps(fields), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed runs."""
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


def fleet_points(fleet):
    pts = np.zeros((len(fleet), BUCKET, 2), np.float32)
    for i, p in enumerate(fleet):
        pts[i, :len(p.xy)] = p.xy
        pts[i, len(p.xy):] = p.xy[0]
    return pts.reshape(-1, 2)


def swept_pairs(pts, ids, nhits, sub, rc2: float, dc) -> int:
    """(point, column) pairs the two-level arm sweeps on these inputs: per
    hit block and 128-column slice, the 32 points of every warp that has a
    point within the cull radius of the slice's bbox."""
    nchunks, nblocks = ids.shape
    hit = torch.arange(nblocks, device=ids.device)[None, :] < nhits[:, None]
    blk = torch.where(hit, ids, 0).long()                    # [nc, nb]
    quads = sub[blk].reshape(nchunks, 1, nblocks, -1, 4)     # [nc,1,nb,ns,4]
    p = pts.reshape(nchunks, dc._P, 2)[:, :, None, None, :]  # [nc,P,1,1,2]
    lo, hi = quads[..., 0:2], quads[..., 2:4]
    d = torch.clamp_min(torch.maximum(lo - p, p - hi), 0.0)
    near = ((d * d).sum(-1) <= rc2) & (lo <= hi).all(-1)     # [nc,P,nb,ns]
    warp_near = near.reshape(nchunks, dc._P // 32, 32, nblocks, -1).any(2)
    swept = warp_near & hit[:, None, :, None]
    return int(swept.sum()) * 32 * dc._SUB


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
    log = build.BUILD_LOG.get("sweep.cu", {})
    regs = [ln.strip() for ln in log.get("ptxas", "").splitlines()
            if "registers" in ln]
    phase("build", card, seconds=time.perf_counter() - t0,
          nvcc_seconds=log.get("seconds"), ptxas=regs)

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
    n = pts.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    radius, k = MatcherParams().search_radius, MatcherParams().max_candidates
    nchunks = n // dc._P
    fpts, fval = dc._fill_invalid(pts, valid, nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], radius,
                                     nchunks)
    pack, sub = tab["seg_pack"], tab["seg_sub"]
    ref = dc._dense_plain(pts, pack, radius, k)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: dc._dense_plain(pts, pack, radius, k), reps=3,
                       warmup=1)
    prepass_ms = cuda_ms(lambda: dc._chunk_block_ids(
        fpts, fval, tab["seg_bbox"], radius, nchunks), reps=20)
    rc = dc.cull_radius(radius)
    used = torch.zeros(ids.shape[1], dtype=torch.bool, device="cuda")
    hit = (torch.arange(ids.shape[1], device="cuda")[None, :]
           < nhits[:, None])
    used[ids[hit].long()] = True
    n_used = int(used.sum())
    io_bytes = (pts.numel() * 4 + ids.numel() * 4 + nhits.numel() * 4
                + n * k * 12)
    arms = {}
    for arm, arm_sub in (("sub", sub), ("block", None)):
        got = dc.sweep_topk(fpts, ids, nhits, pack, arm_sub, radius, k)
        torch.cuda.synchronize()
        mism = {f: int((g != r).sum()) for f, g, r in
                zip(("edge", "offset", "dist"), got, ref)}
        err = max(float((got[1] - ref[1]).abs().max()),
                  float((got[2] - ref[2]).abs().max()))
        ms = cuda_ms(lambda s=arm_sub: dc.sweep_topk(
            fpts, ids, nhits, pack, s, radius, k), reps=20)
        if arm == "sub":
            pairs = swept_pairs(fpts, ids, nhits, sub, rc * rc, dc)
            nbytes = io_bytes + n_used * (dc.SP_NCOMP * dc._SBLK * 4
                                          + sub.shape[1] * 4)
        else:
            pairs = int(nhits.sum()) * dc._SBLK * dc._P
            nbytes = io_bytes + n_used * dc.SP_NCOMP * dc._SBLK * 4
        ops = pairs * SWEEP_OPS_PER_PAIR
        t_ops, t_bytes = ops / H100_F32_FLOPS * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
        arms[arm] = {"mismatches": mism, "max_abs_err": err, "ms": ms,
                     "pairs": pairs, "ops": ops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        phase(f"kernel:{arm}", card, points=n, mismatches=mism,
              max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
              prepass_ms=prepass_ms, swept_pairs=pairs,
              mean_hit_blocks=float(nhits.float().mean()),
              bound_ms=arms[arm]["bound_ms"], bound_by=arms[arm]["bound_by"])
        if any(mism.values()):
            raise SystemExit(f"kernel arm {arm} disagrees with _dense_plain: {mism}")

    # ---- 5. main path -----------------------------------------------------
    traces = [Trace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]
    m_sub = SegmentMatcher(ts)
    m_block = SegmentMatcher(ts, MatcherParams(sweep_subcull=False))
    m_sub.match_many(traces[:64])                 # warm the allocator
    m_sub.stage_seconds = dict.fromkeys(m_sub.stage_seconds, 0.0)
    m_sub.point_counts = dict.fromkeys(m_sub.point_counts, 0)
    for key in dc.SWEEP_LAUNCHES:
        dc.SWEEP_LAUNCHES[key] = 0
    t0 = time.perf_counter()
    recs = m_sub.match_many(traces)
    batch_s = time.perf_counter() - t0
    st, pc = dict(m_sub.stage_seconds), dict(m_sub.point_counts)
    recs_block = m_block.match_many(traces)
    answer = m_sub.match(fleet[0].to_report_json())
    launches = dict(dc.SWEEP_LAUNCHES)
    n_rec = sum(len(r) for r in recs)
    phase("main", card, traces=len(traces), probes=N_TRACES * N_POINTS,
          probes_per_s=N_TRACES * N_POINTS / batch_s, batch_ms=batch_s * 1e3,
          prepare_ms=st["prepare"] * 1e3, device_ms=st["device"] * 1e3,
          walk_ms=st["walk"] * 1e3, records=n_rec,
          unmatched_share=pc["unmatched"] / max(pc["points"], 1),
          request_segments=len(answer["segments"]), launches=launches)
    if [[r.to_json() for r in x] for x in recs] != \
            [[r.to_json() for r in x] for x in recs_block]:
        raise SystemExit("whole-block arm records differ from the two-level arm")
    if not n_rec or not answer["segments"]:
        raise SystemExit("main path produced no records")
    if launches["sub"] < 1 or launches["block"] < 1:
        raise SystemExit(f"a kernel arm never launched on the main path: {launches}")
    for rs in recs:
        for r in rs:
            if not (np.isfinite(r.length) and np.isfinite(r.start_time)
                    and np.isfinite(r.end_time)):
                raise SystemExit(f"non-finite record {r}")

    # where the device time of one slice goes: sweep (pre-pass + kernel),
    # Viterbi, wire pack — each timed alone with CUDA events
    from reporter_tpu_torch.ops import match as match_ops
    from reporter_tpu_torch.ops.hmm import viterbi_decode_batched

    work, sliced = m_sub.plan_submit(traces)
    ps = m_sub.prepare_submit_slice(traces, work, *sliced[0])
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
    p = m_sub.params
    cands = match_ops.batch_candidates(bpts, bval, m_sub.tables, p)
    vit_args = (p.sigma_z, p.beta, p.max_route_distance_factor,
                p.breakage_distance, p.backward_slack, p.interpolation_distance)
    vit = viterbi_decode_batched(cands, bpts, bval, m_sub.tables, *vit_args)
    out = match_ops.MatchOutput(vit.edge, vit.offset, vit.chain_start,
                                vit.matched)
    stage_ms = {
        "candidates": cuda_ms(lambda: match_ops.batch_candidates(
            bpts, bval, m_sub.tables, p), reps=5),
        "viterbi": cuda_ms(lambda: viterbi_decode_batched(
            cands, bpts, bval, m_sub.tables, *vit_args), reps=5, warmup=1),
        "pack": cuda_ms(lambda: match_ops._pack_wire(
            out, ts.num_edges, m_sub.wire_spec), reps=5),
        "wire_entry": cuda_ms(lambda: m_sub.submit_prepared(ps), reps=5,
                              warmup=1)}
    # device busy share of one wire entry: kernel time summed by the
    # profiler over the entry's wall time (None if the trace shows none)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m_sub.submit_prepared(ps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_run = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels_run)
    top = sorted(kernels_run, key=lambda e: -e.self_device_time_total)
    phase("breakdown", card, slice_traces=len(ps.ws), bucket=ps.b,
          mode=ps.mode, **{f"{k}_ms": v for k, v in stage_ms.items()},
          device_busy_share=busy_us / wall_us if busy_us else None,
          device_kernel_launches=sum(e.count for e in kernels_run),
          top_device_ms={e.key[:60]: e.self_device_time_total / 1e3
                         for e in top[:5]})

    # reference checks: the repo's golden fixture on the card, and the
    # card against the plain CPU path on a small batch
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "fixtures", "golden_traces.json")) as f:
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
          card_vs_cpu_records_equal=cpu_ok, traces_checked=len(small))
    if not (golden_ok and cpu_ok):
        raise SystemExit("reference check failed")

    # ---- 6. summary -------------------------------------------------------
    kernels = []
    for arm, replaces in (
            ("sub", "reporter_tpu/ops/dense_candidates.py:433"),
            ("block", "reporter_tpu/ops/dense_candidates.py:389")):
        a = arms[arm]
        kernels.append({
            "name": f"sweep_topk_{arm}", "route": "cuda",
            "source": "reporter_tpu_torch/kernels/sweep.cu",
            "replaces": replaces, "launches": launches[arm],
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "plain_ms": plain_ms, "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
