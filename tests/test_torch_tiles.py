"""The port's network generator, tile compiler, seg pack and device tables
against the JAX package's (reporter_tpu), byte for byte."""

import numpy as np
import pytest
import torch

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.netgen.synthetic import generate_city as j_generate_city
from reporter_tpu.ops.dense_candidates import build_seg_pack as j_build_seg_pack
from reporter_tpu.tiles.compiler import compile_network as j_compile_network
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import CompilerParams
from reporter_tpu_torch.netgen.network import RoadNetwork, Way
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.ops.dense_candidates import build_seg_pack
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import (ARRAY_FIELDS, TileSet,
                                              tables_from_numpy)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_CASES = [("tiny", 11, {}),
          ("tiny", None, {"reach_radius": 500.0, "osmlr_max_length": 200.0}),
          ("sf", None, {})]


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name,seed", [("tiny", 11), ("tiny", None),
                                       ("sf", None)])
def test_generate_city_matches_reference(name, seed):
    a = generate_city(name, seed=seed)
    b = j_generate_city(name, seed=seed)
    assert _same(a.node_lonlat, b.node_lonlat)
    assert len(a.ways) == len(b.ways)
    for wa, wb in zip(a.ways, b.ways):
        assert (wa.way_id, wa.nodes, wa.oneway, wa.name, wa.speed_mps,
                wa.access_mask) == (wb.way_id, wb.nodes, wb.oneway, wb.name,
                                    wb.speed_mps, wb.access_mask)
        assert sorted(wa.geometry) == sorted(wb.geometry)
        for leg in wa.geometry:
            assert _same(wa.geometry[leg], wb.geometry[leg])


@pytest.mark.parametrize("name,seed,kw", _CASES)
def test_compile_network_matches_reference(name, seed, kw):
    ts = compile_network(generate_city(name, seed=seed), CompilerParams(**kw))
    ref = j_compile_network(j_generate_city(name, seed=seed),
                            JCompilerParams(use_native=False, **kw))
    bad = [f for f in ARRAY_FIELDS if not _same(getattr(ts, f), getattr(ref, f))]
    assert not bad, bad
    assert ts.meta.origin_lonlat == ref.meta.origin_lonlat


@pytest.mark.parametrize("name,seed,kw", _CASES)
def test_seg_pack_byte_equal(name, seed, kw):
    ref = j_compile_network(j_generate_city(name, seed=seed),
                            JCompilerParams(use_native=False, **kw))
    args = (ref.seg_a, ref.seg_b, ref.seg_edge, ref.seg_off, ref.seg_len)
    for block in (512, 128):
        a, b = build_seg_pack(*args, block=block), j_build_seg_pack(*args, block=block)
        assert _same(a.pack, b.pack)
        assert _same(a.bbox, b.bbox)
        assert _same(a.sub, b.sub)


def test_seg_pack_long_segments_byte_equal():
    """Multi-km edges are split into sub-spans the same way (the final
    piece keeps the original endpoint bit for bit)."""
    from reporter_tpu_torch.geometry import xy_to_lonlat

    xy = np.array([[-1000.0, 0.0], [1000.0, 0.0], [1000.0, 150.0],
                   [-1000.0, -150.0], [0.0, 140.0]])
    net = RoadNetwork(node_lonlat=xy_to_lonlat(xy, np.array([-122.3, 37.8])),
                      ways=[Way(way_id=1, nodes=[0, 1], speed_mps=29.0),
                            Way(way_id=2, nodes=[1, 2]),
                            Way(way_id=3, nodes=[0, 3]),
                            Way(way_id=4, nodes=[4, 1])])
    ts = compile_network(net, CompilerParams(reach_radius=400.0))
    assert float(ts.seg_len.max()) > 1000.0
    args = (ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off, ts.seg_len)
    a, b = build_seg_pack(*args), j_build_seg_pack(*args)
    assert (a.pack[6].view(np.int32) >= 0).sum() > len(ts.seg_edge)
    assert _same(a.pack, b.pack) and _same(a.bbox, b.bbox) and _same(a.sub, b.sub)


def test_tables_from_numpy_carries_reference_arrays():
    """The JAX package's tile arrays, handed across as numpy, arrive as
    torch tensors with the same dtypes and bytes; the pack's edge row
    keeps its int32 bit pattern."""
    ref = j_compile_network(j_generate_city("tiny"),
                            JCompilerParams(reach_radius=500.0))
    arrays = {f: getattr(ref, f) for f in ARRAY_FIELDS}
    tab = tables_from_numpy(arrays, "cpu")
    host = ref.host_tables("dense")
    for k in ("edge_len", "reach_to", "reach_dist", "seg_pack", "seg_bbox",
              "seg_sub", "seg_feat"):
        assert _same(tab[k].numpy(), host[k]), k
    assert _same(tab["reach_row"].numpy(), host["reach_row"])
    np.testing.assert_array_equal(tab["seg_pack"][6].view(torch.int32).numpy(),
                                  host["seg_pack"][6].view(np.int32))
    ts = TileSet.from_arrays(ref.name, ref.meta.origin_lonlat, arrays)
    assert all(_same(getattr(ts, f), arrays[f]) for f in ARRAY_FIELDS)


def test_restricted_tiles_are_refused():
    """No longer refused: a turn-restricted tile of the JAX package stages
    its R = N + F reach rows unchanged and keeps its banned pairs, and the
    port compiles the same restricted network to the same arrays."""
    from reporter_tpu.netgen.synthetic import (
        add_random_restrictions as j_add_random_restrictions)
    from reporter_tpu_torch.netgen.synthetic import add_random_restrictions

    ref = j_compile_network(j_add_random_restrictions(j_generate_city("tiny")),
                            JCompilerParams(reach_radius=500.0))
    assert len(ref.ban_from) and len(ref.reach_to) > ref.num_nodes
    arrays = {f: getattr(ref, f) for f in ARRAY_FIELDS}
    tab = tables_from_numpy(arrays, "cpu")
    assert _same(tab["reach_to"].numpy(), ref.reach_to)
    assert _same(tab["reach_row"].numpy(), ref.edge_reach_row)
    ts = TileSet.from_arrays("r", (0.0, 0.0), arrays)
    assert ts.ban_set == ref.ban_set
    got = compile_network(add_random_restrictions(generate_city("tiny")),
                          CompilerParams(reach_radius=500.0))
    bad = [f for f in ARRAY_FIELDS if not _same(getattr(got, f),
                                                getattr(ref, f))]
    assert not bad, bad


def test_synthesize_fleet_matches_reference():
    """Same tile, same seed: the same probes (points, times, truth)."""
    from reporter_tpu.netgen.traces import synthesize_fleet as j_fleet
    from reporter_tpu_torch.netgen.traces import synthesize_fleet

    ts = compile_network(generate_city("tiny"), CompilerParams(reach_radius=500.0))
    ref_ts = j_compile_network(j_generate_city("tiny"),
                               JCompilerParams(reach_radius=500.0))
    got, ref = synthesize_fleet(ts, 8, num_points=50, seed=3), \
        j_fleet(ref_ts, 8, num_points=50, seed=3)
    for a, b in zip(got, ref):
        assert a.uuid == b.uuid
        for f in ("lonlat", "xy", "times", "true_edges", "true_offsets",
                  "path_edges"):
            assert _same(getattr(a, f), getattr(b, f)), f
        assert a.to_report_json() == b.to_report_json()


def test_save_load_keeps_the_grid(tmp_path):
    """The port's save writes the grid and its metadata, and load keeps
    them: every array of the port's file (grid included) and the metadata
    equal the JAX package's compile of the same network, read by either
    package; a JAX-written file loads with its grid."""
    from reporter_tpu.tiles.tileset import TileSet as JTileSet

    ts = compile_network(generate_city("tiny"), CompilerParams())
    ref = j_compile_network(j_generate_city("tiny"), JCompilerParams())
    path = ts.save(str(tmp_path / "port"))
    jpath = str(tmp_path / "jax.npz")
    ref.save(jpath)
    for got in (TileSet.load(path), JTileSet.load(path), TileSet.load(jpath)):
        assert got.grid.shape[0] == ref.stats["grid_cells"] > 0
        assert tuple(got.meta) == tuple(ref.meta)
        for f in ARRAY_FIELDS:
            assert _same(getattr(got, f), getattr(ref, f)), f
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            if f != "_meta":
                assert _same(a[f], b[f]), f
