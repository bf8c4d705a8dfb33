"""The tile pipeline's command line: build, synth, info, osmlr, convert.

Counterpart: reporter_tpu/tiles/__main__.py, with its subcommands, flags
and output lines. One compiler pass (tiles/compiler.compile_network:
graph, OSMLR chaining and association, grid, reach tables) replaces the
reference's chain of offline tools:

    python -m reporter_tpu_torch.tiles build --osm map.osm.pbf [--mode bicycle] -o metro.npz
    python -m reporter_tpu_torch.tiles synth --city sf -o sf.npz
    python -m reporter_tpu_torch.tiles info metro.npz
    python -m reporter_tpu_torch.tiles osmlr metro.npz [--binary] -o segments.geojson
    python -m reporter_tpu_torch.tiles convert map.osm map.osm.pbf

A built ``.npz`` equals the JAX package's build of the same input, array
for array, and either package loads it (TileSet.load). ``info`` prints
the JAX keys; its ``hbm_bytes`` is what the port's dense matcher stages
(tiles/capacity.dense_staged_bytes), where the JAX package prints the
bytes of every tile array. The CLI runs on the host only.
"""

from __future__ import annotations

import argparse
import json
import sys


def _params(args: argparse.Namespace):
    from reporter_tpu_torch.config import CompilerParams

    kw = {}
    for f in ("cell_size", "cell_capacity", "index_radius", "reach_radius",
              "reach_max", "osmlr_max_length"):
        v = getattr(args, f, None)
        if v is not None:
            kw[f] = v
    if getattr(args, "no_native", False):
        kw["use_native"] = False
    return CompilerParams(**kw)


def _add_compiler_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-o", "--output", required=True, help="output .npz path")
    p.add_argument("--cell-size", dest="cell_size", type=float)
    p.add_argument("--cell-capacity", dest="cell_capacity", type=int)
    p.add_argument("--index-radius", dest="index_radius", type=float)
    p.add_argument("--reach-radius", dest="reach_radius", type=float)
    p.add_argument("--reach-max", dest="reach_max", type=int)
    p.add_argument("--osmlr-max-length", dest="osmlr_max_length", type=float)
    p.add_argument("--no-native", dest="no_native", action="store_true",
                   help="force the pure-Python reach/grid builders")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m reporter_tpu_torch.tiles")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="compile an OSM extract (XML or PBF)")
    b.add_argument("--osm", required=True,
                   help="OSM file (.osm/.xml or .osm.pbf/.pbf)")
    b.add_argument("--name", default=None, help="tileset name")
    b.add_argument("--mode", default="auto",
                   choices=("auto", "bicycle", "foot"),
                   help="compile this mode's legal subgraph (default auto; "
                        "parsers keep every mode's ways, so one deployment "
                        "builds one tileset per served mode)")
    _add_compiler_flags(b)

    from reporter_tpu_torch.netgen.synthetic import CITY_PRESETS

    s = sub.add_parser("synth", help="compile a synthetic city")
    s.add_argument("--city", default="sf",
                   help="|".join(CITY_PRESETS) + " (netgen/synthetic.py)")
    s.add_argument("--seed", type=int, default=0)
    _add_compiler_flags(s)

    i = sub.add_parser("info", help="print a compiled tileset's stats")
    i.add_argument("path")

    g = sub.add_parser("osmlr",
                       help="export OSMLR segment definitions (GeoJSON, "
                            "or the compact binary tile with --binary)")
    g.add_argument("path", help="compiled tileset .npz")
    g.add_argument("-o", "--output", required=True,
                   help="output .geojson (or .osmlr with --binary) path")
    g.add_argument("--binary", action="store_true",
                   help="write the protobuf-wire binary segment tile "
                        "(tiles/osmlr_tiles.py) instead of GeoJSON")

    c = sub.add_parser("convert", help="convert an OSM XML extract to PBF")
    c.add_argument("xml", help="input .osm/.xml file")
    c.add_argument("pbf", help="output .osm.pbf path")
    c.add_argument("--raw", action="store_true",
                   help="write uncompressed blobs (debugging)")

    args = ap.parse_args(argv)

    if args.cmd == "osmlr":
        from reporter_tpu_torch.tiles.tileset import TileSet

        ts = TileSet.load(args.path)
        if args.binary:
            from reporter_tpu_torch.tiles.osmlr_tiles import write_osmlr_tile

            n = write_osmlr_tile(ts, args.output)
        else:
            from reporter_tpu_torch.tiles.osmlr_export import (
                export_osmlr_geojson)

            n = export_osmlr_geojson(ts, args.output)
        print(json.dumps({"written": args.output, "segments": n}))
        return 0

    if args.cmd == "convert":
        from reporter_tpu_torch.netgen.osm_xml import xml_elements
        from reporter_tpu_torch.netgen.pbf import write_osm_pbf

        node_pos, ways, relations = xml_elements(args.xml)
        write_osm_pbf(args.pbf, node_pos, ways, relations,
                      compress=not args.raw)
        print(json.dumps({"written": args.pbf, "nodes": len(node_pos),
                          "ways": len(ways), "relations": len(relations)}))
        return 0

    if args.cmd == "info":
        from reporter_tpu_torch.tiles.capacity import dense_staged_bytes
        from reporter_tpu_torch.tiles.tileset import TileSet

        ts = TileSet.load(args.path)
        print(json.dumps({
            "name": ts.name,
            "nodes": ts.num_nodes,
            "edges": ts.num_edges,
            "line_segments": int(len(ts.seg_edge)),
            "osmlr_segments": int(len(ts.osmlr_id)),
            "grid_cells": int(ts.grid.shape[0]),
            "hbm_bytes": sum(dense_staged_bytes(ts)),
            "meta": {"cell_size": ts.meta.cell_size,
                     "grid_dims": list(ts.meta.grid_dims),
                     "index_radius": ts.meta.index_radius},
            "stats": ts.stats,
        }, indent=2))
        return 0

    from reporter_tpu_torch.tiles.compiler import compile_network

    if args.cmd == "build":
        name = args.name or args.osm.rsplit("/", 1)[-1].split(".")[0]
        if args.osm.endswith(".pbf"):
            from reporter_tpu_torch.netgen.pbf import parse_osm_pbf

            net = parse_osm_pbf(args.osm, name=name)
        else:
            from reporter_tpu_torch.netgen.osm_xml import parse_osm_xml

            net = parse_osm_xml(args.osm, name=name)
    else:
        from reporter_tpu_torch.netgen.synthetic import generate_city

        net = generate_city(args.city, seed=args.seed)

    ts = compile_network(net, _params(args),
                         mode=getattr(args, "mode", None))
    ts.save(args.output)
    print(json.dumps({"written": args.output, "name": ts.name,
                      "stats": ts.stats}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
