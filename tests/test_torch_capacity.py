"""The port's capacity planning (tiles/capacity.py) against the JAX
package's rule (reporter_tpu/tiles/capacity.py), for the port's layout.

The formula equals ``SegmentMatcher.table_bytes`` exactly (what the dense
matcher stages), on plain, restricted, long-segment and mode tiles. The
fixed share counts the per-edge and reach arrays the port stages, each
byte-equal to the JAX package's staged array; the JAX fixed share also
counts ``edge_osmlr``, which the port does not stage. Both strategies
and the over-budget raise follow the JAX rule on the same (shardable,
fixed, budget), with the JAX module's ``dense_staged_bytes`` swapped for
the port's by monkeypatch (the JAX module itself is not changed).
"""

import numpy as np
import pytest

import reporter_tpu.tiles.capacity as jcap
from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.netgen.synthetic import generate_city as j_generate_city
from reporter_tpu.tiles.compiler import compile_network as j_compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS as J_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import CompilerParams
from reporter_tpu_torch.geometry import xy_to_lonlat
from reporter_tpu_torch.matcher.api import SegmentMatcher
from reporter_tpu_torch.netgen.network import RoadNetwork, Way
from reporter_tpu_torch.netgen.synthetic import (add_random_restrictions,
                                                 assign_mode_access,
                                                 generate_city)
from reporter_tpu_torch.tiles import capacity
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import TileSet, tables_from_numpy

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _long_segments():
    xy = np.array([[-1000.0, 0.0], [1000.0, 0.0], [1000.0, 150.0],
                   [-1000.0, -150.0], [0.0, 140.0]])
    return RoadNetwork(
        node_lonlat=xy_to_lonlat(xy, np.array([-122.3, 37.8])),
        ways=[Way(way_id=1, nodes=[0, 1], speed_mps=29.0),
              Way(way_id=2, nodes=[1, 2]), Way(way_id=3, nodes=[0, 3]),
              Way(way_id=4, nodes=[4, 1])], name="long")


_TILES = {
    "tiny": lambda: compile_network(generate_city("tiny")),
    "sf": lambda: compile_network(generate_city("sf")),
    "sf+r": lambda: compile_network(add_random_restrictions(
        generate_city("sf"))),
    "long": lambda: compile_network(_long_segments(),
                                    CompilerParams(reach_radius=400.0)),
    "bicycle": lambda: compile_network(assign_mode_access(
        generate_city("tiny")), mode="bicycle"),
}


@pytest.fixture(scope="module", params=sorted(_TILES))
def ts(request):
    return _TILES[request.param]()


def test_formula_equals_table_bytes(ts):
    shardable, fixed = capacity.dense_staged_bytes(ts)
    m = SegmentMatcher(ts, device="cpu")
    assert shardable + fixed == m.table_bytes
    seg = ("seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
           "seg_coarse")
    assert shardable == sum(m.tables[k].numel() * m.tables[k].element_size()
                            for k in seg)
    plan = capacity.plan_staging(ts)
    assert plan.table_bytes == m.table_bytes and plan.strategy == "replicated"


@pytest.mark.parametrize("city", ["tiny", "sf"])
def test_fixed_share_equals_reference_arrays(city):
    """The fixed share's arrays are the JAX package's staged arrays, byte
    for byte; its sum is the JAX fixed share less edge_osmlr."""
    ref = j_compile_network(j_generate_city(city), JCompilerParams())
    ts = TileSet.from_arrays(ref.name, ref.meta,
                             {f: getattr(ref, f) for f in J_FIELDS})
    host = ref.host_tables("dense")
    tab = tables_from_numpy(ts.arrays(), "cpu")
    for k in ("edge_len", "reach_row", "reach_to", "reach_dist"):
        assert tab[k].numpy().tobytes() == host[k].tobytes(), k
    _, fixed = capacity.dense_staged_bytes(ts)
    _, jfixed = jcap.dense_staged_bytes(ref)
    assert fixed == jfixed - host["edge_osmlr"].nbytes
    assert fixed == sum(host[k].nbytes for k in ("edge_len", "reach_row",
                                                 "reach_to", "reach_dist"))


def test_budget_is_three_quarters_of_the_card():
    assert capacity.DEFAULT_HBM_BUDGET == 60 * 1024**3
    assert capacity.DEFAULT_HBM_BUDGET * 4 == 3 * 80 * 1024**3
    # the JAX package keeps the same share of its 16 GB chip
    assert jcap.DEFAULT_HBM_BUDGET * 4 == 3 * 16 * 1024**3


def _jax_plan(ts, budget, monkeypatch):
    monkeypatch.setattr(jcap, "dense_staged_bytes",
                        capacity.dense_staged_bytes)
    return jcap.plan_staging(ts, budget)


@pytest.mark.parametrize("frac", [1.0, 0.9, 0.75, 0.5])
def test_strategies_follow_the_reference_rule(frac, monkeypatch, recwarn):
    """Replicated within the budget, segment-sharded past it, the same
    plan as the JAX rule on the same (shardable, fixed, budget); no
    warning either way (the sharded plan runs through shard_tables, and
    the JAX rule warns of none)."""
    ts = _TILES["sf"]()
    shardable, fixed = capacity.dense_staged_bytes(ts)
    budget = fixed + int(frac * shardable)
    got = capacity.plan_staging(ts, budget)
    want = _jax_plan(ts, budget, monkeypatch)
    assert tuple(got) == tuple(want)
    assert got.to_json() == want.to_json()
    if frac < 1.0:
        assert got.strategy == "segment-sharded" and got.shards >= 2
        assert not [w for w in recwarn if "sharded" in str(w.message)]
    else:
        assert got.strategy == "replicated" and got.shards == 1


def test_impossible_budget_raises_as_the_reference(monkeypatch):
    ts = _TILES["tiny"]()
    _, fixed = capacity.dense_staged_bytes(ts)
    with pytest.raises(ValueError, match="replicated share"):
        capacity.plan_staging(ts, fixed - 1)
    with pytest.raises(ValueError, match="replicated share"):
        _jax_plan(ts, fixed - 1, monkeypatch)


def test_envelope_arithmetic(ts):
    plan = capacity.plan_staging(ts)
    assert plan.bytes_per_edge == plan.table_bytes / ts.num_edges
    assert plan.edge_capacity == int(plan.budget_bytes / plan.bytes_per_edge)
    assert plan.table_bytes == plan.shardable_bytes + plan.fixed_bytes
