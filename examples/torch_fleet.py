"""Metro fleet residency demo of the PyTorch / CUDA port: many metros on
one card, LRU-paged.

    python examples/torch_fleet.py [--device cuda|cpu]

The counterpart of examples/fleet.py on reporter_tpu_torch. Builds three
tiny metros at distinct map locations, serves geo-routed traffic through
a FleetRouter whose memory budget only holds two of them, forces an
eviction and a re-promotion, and prints the occupancy report. Runs on the
card unless ``--device cpu`` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from reporter_tpu_torch import (  # noqa: E402
    CompilerParams,
    Config,
    FleetConfig,
    MetroSLO,
    compile_network,
    generate_city,
    make_fleet_router,
)
from reporter_tpu_torch.netgen.traces import synthesize_probe  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the metros are paged onto "
                         "(default cuda)")
    args = ap.parse_args(argv)

    # 1. three tiny metros at DISTINCT centers (geo routing reads each
    #    trace's first point against the metros' dilated bboxes)
    tilesets = []
    for i, name in enumerate(("alpha", "beta", "gamma")):
        net = generate_city("tiny", nx=6, ny=6, seed=30 + i,
                            center=(-122.0 + i * 1.0, 37.5))
        net.name = name
        tilesets.append(compile_network(net,
                                        CompilerParams(reach_radius=500.0)))
    per_metro = [sum(v.nbytes for v in ts.host_tables("auto").values())
                 for ts in tilesets]
    print("metros:", ", ".join(
        f"{ts.name} ({b / 1e3:.0f} kB staged)"
        for ts, b in zip(tilesets, per_metro)))

    # 2. a FleetRouter whose budget fits only TWO metros; 'alpha' gets a
    #    tight SLO and a residency pin (never LRU-evicted)
    router = make_fleet_router(
        tilesets, Config(),
        transport=lambda url, body: 200,
        fleet=FleetConfig(max_resident_bytes=per_metro[0] + per_metro[1]
                          + per_metro[2] // 2,
                          evict_watermark=1.0),
        slos={"alpha": MetroSLO(deadline_ms=5.0, pinned=True)},
        device=args.device)

    # 3. geo-routed traffic: each probe lands in its metro by bbox; the
    #    third metro's first request pages one of the others out
    for ts in tilesets:
        payload = synthesize_probe(ts, seed=7, num_points=40,
                                   gps_sigma=3.0).to_report_json()
        out = router.report_one(payload)
        print(f"  probe near {ts.name}: routed → {out['metro']}, "
              f"{len(out['segments'])} segments")
    occ = router.residency.occupancy()
    print(f"after first rotation: {occ['resident_metros']}/3 resident, "
          f"promotions={occ['promotions']} demotions={occ['demotions']}")

    # 4. force another eviction + promotion: beta and gamma now fight
    #    over the one unpinned slot (alpha is SLO-pinned)
    victim = [n for n in ("beta", "gamma")
              if n not in router.residency.resident_names][0]
    router.report_one(synthesize_probe(
        router.residency.tileset(victim), seed=8, num_points=40,
        gps_sigma=3.0).to_report_json())
    occ = router.residency.occupancy()
    print(f"touching cold '{victim}' paged again: "
          f"promotions={occ['promotions']} demotions={occ['demotions']}")

    # 5. the occupancy report (also served at GET /health under "fleet")
    print(f"occupancy report ({args.device}):")
    for name, m in occ["metros"].items():
        state = "hot " if m["resident"] else "cold"
        pin = " [pinned]" if m["pinned"] else ""
        print(f"  {state} {name}{pin}: {m['staged_bytes'] / 1e3:.0f} kB, "
              f"promotions={m['promotions']} demotions={m['demotions']}")
    print(f"ledger: {occ['resident_bytes'] / 1e3:.0f} kB of "
          f"{occ['capacity_bytes'] / 1e3:.0f} kB "
          f"({occ['occupancy_frac']:.0%})")
    router.close()


if __name__ == "__main__":
    main()
