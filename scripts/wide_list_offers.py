"""Count what the wide sweep's running lists do, per point, on sf.

    python3 scripts/wide_list_offers.py [--device cuda|cpu] [--traces N]
        [--radius M] [--ks 20,32]

The sweep kernel's wide instances (kernels/sweep_exact.cu, K past 16)
keep each point's top-K list in memory (kernels/topk.cuh, ``WideList``).
What such a list costs is set by the offers it receives: the in-radius
(point, column) pairs, in the order the kernel sweeps them. A CTA walks
its chunk's hit blocks in ascending order and each block's columns in
ascending order, and no arm skips a column within the radius, so a
point's offers are its in-radius columns in ascending column order. This
script computes them for the fleet ``chip_smoke.py`` matches (sf, 1024
traces of 120 points padded to 128 with the trace's first point, seed 0,
131,072 points) and replays the list's rules on every point at once
(plain PyTorch), counting per point:

- ``offers``: in-radius pairs; ``admitted``: those the admission bound
  (the K-th slot's (d², edge), in registers) lets through;
- ``held``: admitted offers of an edge the list holds; ``improved``: of
  those, a smaller d² (the entry moves up); ``new``: admitted new edges,
  ``evicting`` those that push the K-th entry out;
- ``scan_slots_linear``: slots the held-edge scan reads with no filter
  (each admitted offer scans to its edge or through all n filled slots);
  ``scan_slots_bloom``: the same behind the 64-bit Bloom mask of the
  edges entered (a new edge whose bit is clear scans nothing),
  ``scans_skipped`` those spared, ``scan_steps`` the scan's steps of 8
  slots;
- ``shifted_slots``: slots moved down one by insertions (new entries from
  the bottom slot, improved ones from their own); ``insert_steps`` the
  insertion's steps of 4 slots.

Counts only: no time. The last line is one JSON object with the means per
point at each K. Imports nothing of JAX; on ``cuda`` it needs one card.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

SCAN, MOVE = 8, 4            # topk.cuh's WideList::kScan, kMove
INT_MAX = 2 ** 31 - 1


def fleet_points(ts, traces: int, bucket: int = 128, points: int = 120):
    from reporter_tpu_torch.netgen.traces import synthesize_fleet

    fleet = synthesize_fleet(ts, traces, num_points=points, seed=0)
    pts = np.zeros((len(fleet), bucket, 2), np.float32)
    for i, p in enumerate(fleet):
        pts[i, :len(p.xy)] = p.xy
        pts[i, len(p.xy):] = p.xy[0]
    return pts.reshape(-1, 2)


def offers_of(dc, pts, pack, radius: float):
    """Per point, its in-radius offers in column order → (d2 [P, M], edge
    [P, M], count [P])."""
    d2, edge, _ = dc._block_geometry(pts[:, 0:1], pts[:, 1:2], pack)
    near = (edge >= 0) & (d2 <= float(radius) * float(radius))
    cols = torch.arange(d2.shape[1], device=d2.device)[None, :]
    order = torch.sort(torch.where(near, cols, cols + d2.shape[1]),
                       dim=1).values
    count = near.sum(1)
    m = max(int(count.max()), 1)
    take = order[:, :m] % d2.shape[1]
    return d2.gather(1, take), edge.gather(1, take), count


def before(d1, e1, d2, e2):
    return (d1 < d2) | ((d1 == d2) & (e1 < e2))


def replay(d2, edge, count, k: int) -> dict:
    """The wide list's rules over each row's offers → summed counters."""
    p, m = d2.shape
    dev = d2.device
    ld = torch.full((p, k), 1e30, dtype=torch.float32, device=dev)
    le = torch.full((p, k), INT_MAX, dtype=torch.int64, device=dev)
    n = torch.zeros(p, dtype=torch.int64, device=dev)
    seen = torch.zeros(p, dtype=torch.int64, device=dev)
    slot = torch.arange(k, device=dev)[None, :]
    rows = torch.arange(p, device=dev)
    tot = {key: torch.zeros((), dtype=torch.int64, device=dev) for key in (
        "offers", "admitted", "held", "improved", "new", "evicting",
        "scan_slots_linear", "scan_slots_bloom", "scans_skipped",
        "scan_steps", "shifted_slots", "insert_steps")}
    for t in range(m):
        active = t < count
        dd, ee = d2[:, t], edge[:, t].to(torch.int64)
        full = n == k
        admitted = active & (~full | before(dd, ee, ld[:, k - 1],
                                            le[:, k - 1]))
        hit = le == ee[:, None]
        held = admitted & hit.any(1)
        i = torch.where(held, hit.to(torch.int64).argmax(1), n)
        hd = ld[rows, i.clamp(max=k - 1)]
        improved = held & (dd < hd)
        new = admitted & ~held
        bit = ((ee * 2654435761) & 0xFFFFFFFF) >> 26
        maybe = ((seen >> bit) & 1).bool()
        scanned_bloom = torch.where(held, i + 1, torch.where(maybe, n, 0))
        # the bottom slot a new entry enters, or the improved one's own
        j0 = torch.where(new, torch.where(full, k - 1, n), i)
        moving = improved | new
        pos = (before(ld, le, dd[:, None], ee[:, None])
               & (slot < j0[:, None])).sum(1)
        shifted = torch.where(moving, j0 - pos, 0)
        steps = torch.where(moving & (j0 > 0), shifted // MOVE
                            + ((pos > 0) | (shifted % MOVE > 0)).long(), 0)
        adm = admitted.long()
        tot["offers"] += active.sum()
        tot["admitted"] += adm.sum()
        tot["held"] += held.sum()
        tot["improved"] += improved.sum()
        tot["new"] += new.sum()
        tot["evicting"] += (new & full).sum()
        tot["scan_slots_linear"] += (torch.where(held, i + 1, n) * adm).sum()
        tot["scan_slots_bloom"] += (scanned_bloom * adm).sum()
        tot["scans_skipped"] += (new & ~maybe).sum()
        tot["scan_steps"] += (((scanned_bloom + SCAN - 1) // SCAN)
                              * adm).sum()
        tot["shifted_slots"] += shifted.sum()
        tot["insert_steps"] += steps.sum()
        # the update: the entry into its slot, then the row re-sorted by
        # (d², edge) (a stable sort by edge, then by d²)
        at = torch.where(new, j0, i)
        put = torch.nonzero(moving).flatten()
        ld[put, at[put]] = dd[put]
        le[put, at[put]] = ee[put]
        n = n + (new & ~full).long()
        seen = torch.where(new, seen | (1 << bit), seen)
        o = torch.sort(le, dim=1, stable=True).indices
        ld, le = ld.gather(1, o), le.gather(1, o)
        o = torch.sort(ld, dim=1, stable=True).indices
        ld, le = ld.gather(1, o), le.gather(1, o)
    return {key: int(v) for key, v in tot.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traces", type=int, default=1024)
    ap.add_argument("--radius", type=float, default=150.0)
    ap.add_argument("--ks", default="20,32")
    ap.add_argument("--rows", type=int, default=4096,
                    help="points replayed at once")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("wide_list_offers: no CUDA device", file=sys.stderr)
        return 2
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.ops import dense_candidates as dc
    from reporter_tpu_torch.tiles.compiler import compile_network

    ts = compile_network(generate_city("sf"))
    sp = dc.build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                           ts.seg_len)
    pack = torch.from_numpy(sp.pack).to(args.device)
    pts = torch.from_numpy(fleet_points(ts, args.traces)).to(args.device)
    out = {"metro": "sf", "points": int(pts.shape[0]),
           "search_radius": args.radius, "per_point": {}}
    for k in (int(x) for x in args.ks.split(",")):
        tot: dict = {}
        for lo in range(0, pts.shape[0], args.rows):
            d2, edge, count = offers_of(dc, pts[lo:lo + args.rows], pack,
                                        args.radius)
            for key, v in replay(d2, edge, count, k).items():
                tot[key] = tot.get(key, 0) + v
        out["per_point"][k] = {key: v / pts.shape[0]
                               for key, v in tot.items()}
        print(f"K={k}: " + ", ".join(f"{key} {v / pts.shape[0]:.3f}"
                                     for key, v in tot.items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
