"""The reach rows' order, which the Viterbi kernel (kernels/viterbi.cu)
and the C walker rely on: every row the port's compiler builds holds
strictly ascending target edge ids with the -1 padding at the end, so a
binary search of a row finds what the plain version's linear scan finds,
and ``host_tables`` (every staged dict's way to the card) refuses a row
that is not so.

The premise, on each tile the tests compile (tiny with its reach rows
from native/reach.cc, tiny with them from tiles/reach.py, a banned-turn
tile in edge space, a bicycle tile): for every row and every edge id of
the tile, and ids past them, the kernel's search (halving steps from the
largest power of two <= M, the entries read unsigned so -1 sorts last,
the hit kept where a probe equals the key), mirrored here in numpy,
gives the same gap as the plain ``_route``'s ``where(to == e, dist,
BIG).min()``. Tolerance 0.
"""

import numpy as np
import pytest

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
from reporter_tpu_torch.config import CompilerParams
from reporter_tpu_torch.netgen.synthetic import (add_random_restrictions,
                                                 generate_city)
from reporter_tpu_torch.ops.dense_candidates import BIG
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.reach import check_rows_ascending
from reporter_tpu_torch.tiles.tileset import host_tables, tables_from_numpy

_TILES = {
    "tiny": lambda: compile_network(generate_city("tiny")),
    "tiny_python_reach": lambda: compile_network(
        generate_city("tiny"), CompilerParams(use_native=False)),
    "tiny_banned_turns": lambda: compile_network(
        add_random_restrictions(generate_city("tiny")),
        CompilerParams(reach_radius=500.0)),
    "tiny_bicycle": lambda: compile_network(generate_city("tiny"),
                                            mode="bicycle"),
}


def _search_gap(to, dist, rows, keys):
    """The kernel's lookup of ``keys`` in rows ``rows`` (both [N]): the
    largest index whose entry is below the key by halving steps, a hit
    where a probe equals the key, its distance (at most BIG) or BIG."""
    m = to.shape[1]
    top = 1
    while top <= m // 2:
        top *= 2
    unsigned = to.astype(np.int64) & 0xFFFFFFFF
    key = keys.astype(np.int64)
    pos = np.full(keys.shape, -1, np.int64)
    hit = np.full(keys.shape, -1, np.int64)
    probes = 0
    step = top
    while step:
        idx = pos + step
        inside = idx < m
        v = unsigned[rows, np.minimum(idx, m - 1)]
        pos = np.where(inside & (v < key), idx, pos)
        hit = np.where(inside & (v == key), idx, hit)
        probes += 1
        step //= 2
    assert probes == int(np.ceil(np.log2(m + 1)))
    found = dist[rows, np.maximum(hit, 0)]
    return np.where(hit >= 0, np.minimum(np.float32(BIG), found),
                    np.float32(BIG)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(_TILES))
def test_a_binary_search_of_each_row_finds_the_linear_gap(name):
    ts = _TILES[name]()
    to = np.asarray(ts.reach_to, np.int32)
    dist = np.asarray(ts.reach_dist, np.float32)
    check_rows_ascending(to)
    n_rows, m = to.shape
    e = int(ts.num_edges)
    # every edge id, ids past them, and the largest i32 (above every
    # real id, below the -1 padding read unsigned)
    keys = np.concatenate([np.arange(e), [e, e + 1, 2 ** 31 - 1]])
    rows = np.repeat(np.arange(n_rows), len(keys))
    probe = np.tile(keys, n_rows)
    got = _search_gap(to, dist, rows, probe)
    want = np.where(to[rows] == probe[:, None], dist[rows],
                    np.float32(BIG)).min(axis=1)
    np.testing.assert_array_equal(got, want)
    # both kinds of probe occur: ids present in their row and absent
    present = (to[rows] == probe[:, None]).any(axis=1)
    assert present.sum() > n_rows and (~present).sum() > n_rows
    assert (want < BIG).sum() == present.sum()


def _tiny_arrays():
    return compile_network(generate_city("tiny")).arrays()


def _a_row_with_two_ids(to):
    r = int(np.flatnonzero((to >= 0).sum(axis=1) >= 2)[0])
    return r


def test_host_tables_takes_the_compiled_rows():
    arrays = _tiny_arrays()
    assert host_tables(arrays)["reach_to"] is not None
    assert tables_from_numpy(arrays, "cpu")["reach_to"].shape \
        == arrays["reach_to"].shape


@pytest.mark.parametrize("fault", ["two_ids_swapped", "padding_first"])
def test_host_tables_refuses_an_unsorted_row(fault):
    arrays = _tiny_arrays()
    to = arrays["reach_to"].copy()
    r = _a_row_with_two_ids(to)
    if fault == "two_ids_swapped":
        to[r, [0, 1]] = to[r, [1, 0]]
    else:                               # -1 before a real id
        to[r, 0] = -1
    bad = {**arrays, "reach_to": to}
    for backend in ("dense", "grid"):
        with pytest.raises(ValueError, match="ascend"):
            host_tables(bad, backend)
    with pytest.raises(ValueError, match="ascend"):
        tables_from_numpy(bad, "cpu")


def test_a_repeated_id_in_a_row_is_refused():
    """A row holds an id at most once (the plain version's masked minimum
    and the search's single hit agree only then)."""
    arrays = _tiny_arrays()
    to = arrays["reach_to"].copy()
    r = _a_row_with_two_ids(to)
    to[r, 1] = to[r, 0]
    with pytest.raises(ValueError, match="ascend"):
        check_rows_ascending(to)
