"""The sweep past K = 16 (the card's wide instance), on the CPU: the
port's plain path against the JAX package at top-K widths the register
instances do not hold.

Radius. At the default 50 m no point of sf has more than 16 distinct
edges within reach, so a list past 16 is never evicted from; at 150 m
most points have more (PERF.md §6, PR 19), so these cases do evict.

Tolerances. Candidates: ``_assert_close`` of test_torch_dense_candidates
.py at the case's K and radius (per point the same edges except within
1e-4 m of a cut; per shared edge |Δdist| and |Δoffset| <= 1e-3 m: XLA:CPU
contracts multiply-adds, the port does not). The JAX Pallas body in
interpret mode: the same. Records through match_many: tolerance 0
(``to_json()``), as tests/test_torch_matcher.py holds them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reporter_tpu.config import Config, MatcherParams
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.ops import dense_candidates as jdc
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
import test_torch_dense_candidates as tdc
from reporter_tpu_torch.config import MatcherParams as PMatcherParams
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.ops import dense_candidates as dc
from reporter_tpu_torch.tiles.tileset import TileSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

WIDE_RADIUS = 150.0


@pytest.fixture(scope="module")
def sf():
    return compile_network(generate_city("sf"))


def _points(ts, rng, n_fleet=4):
    """Every 8th node (d = 0 ties), points 148-152 m from segment
    midpoints (cuts at the radius) and a small fleet's points."""
    mid = ((ts.seg_a + ts.seg_b) * 0.5)[rng.choice(len(ts.seg_a), 96)]
    ang = rng.uniform(0, 2 * np.pi, len(mid))
    r = rng.uniform(148.0, 152.0, len(mid))[:, None]
    edge_pts = mid + np.stack([np.cos(ang), np.sin(ang)], 1) * r
    fleet = np.concatenate(
        [p.xy for p in synthesize_fleet(ts, n_fleet, num_points=40, seed=2)])
    return np.concatenate([ts.node_xy[::8], edge_pts, fleet]).astype(
        np.float32)


@pytest.mark.parametrize("k", [17, 24, 32, 43, 48, 64])
def test_wide_k_candidates_match_the_jax_package(sf, monkeypatch, k):
    """find_candidates_dense at K past the register widths on sf at 150 m
    (the CPU path is the plain sweep; on the card the same K runs the
    wide instance, held bit-equal to it in tests/test_torch_kernels_gpu
    .py) against the JAX package's (_dense_jnp on the CPU)."""
    pts = _points(sf, np.random.default_rng(k))
    sp = dc.build_seg_pack(sf.seg_a, sf.seg_b, sf.seg_edge, sf.seg_off,
                           sf.seg_len)
    ref = jdc.find_candidates_dense(jnp.asarray(pts), (jnp.asarray(sp.pack),
                                                       jnp.asarray(sp.bbox)),
                                    WIDE_RADIUS, k)
    got = dc.find_candidates_dense(torch.from_numpy(pts),
                                   tuple(torch.from_numpy(x) for x in sp),
                                   WIDE_RADIUS, k)
    assert got.edge.shape == (len(pts), k)
    filled = (got.edge >= 0).sum(1)
    assert int(filled.max()) > dc.SWEEP_KS[-1], "no list past 16 fills"
    monkeypatch.setattr(tdc, "K", k)
    monkeypatch.setattr(tdc, "RADIUS", WIDE_RADIUS)
    dd, do, flips = tdc._assert_close(
        [np.asarray(x) for x in (ref.edge, ref.offset, ref.dist)],
        [x.numpy() for x in (got.edge, got.offset, got.dist)])
    print(f"K={k}: max|Δdist| {dd:.3g} m, max|Δoffset| {do:.3g} m, "
          f"{flips} cut flips, {int((filled == k).sum())} full lists")


def test_list_plan_fits_the_card_up_to_each_arms_largest_k():
    """The instance that serves (arm, K), its CTA's dynamic shared memory
    and its ring's depth: the register instances up to 16 with the full
    ring; past it the lists in shared memory, the ring plus 12 B x 256 x
    K within the card's 232,448 B a CTA up to the arm's largest K (54 for
    block and sub, 47 for sub_bf16, 43 for the tensor-core arms), on the
    deepest ring at which two CTAs fit an SM, else the full ring; and from
    the next K on the scratch instance (the full ring alone), counted
    under its own key."""
    want = {"block": 54, "sub": 54, "sub_bf16": 47, "mxu": 43,
            "mxu_bf16": 43}
    two_ctas = {"block": 26, "sub": 26, "sub_bf16": 23, "mxu": 16,
                "mxu_bf16": 21}
    for arm in dc.SWEEP_ARMS:
        cap = dc.shared_max_k(arm)
        assert cap == want[arm]
        full, ring = dc.RING_DEPTH[arm], dc.ring_smem(arm)
        for k in range(1, 129):
            where, smem, depth = dc.list_plan(arm, k)
            assert smem <= dc.SMEM_PER_CTA and 2 <= depth <= full
            if k <= dc.SWEEP_KS[-1]:
                assert (where, smem, depth) == ("register", ring, full)
                assert dc.launch_key(arm, k) == (arm,
                                                 dc.sweep_instance_k(k))
            elif k <= cap:
                assert where == "shared"
                assert smem == dc.ring_smem(arm, depth) + 3072 * k
                assert dc.launch_key(arm, k) == (arm, k)
                # two CTAs an SM up to the arm's K, on the deepest ring
                # that leaves room for them; one on the full ring past it
                both = 2 * (smem + dc.CTA_RESERVED_SMEM) <= dc.SMEM_PER_SM
                assert both == (k <= two_ctas[arm])
                if both and depth < full:
                    deeper = dc.ring_smem(arm, depth + 1) + 3072 * k
                    assert 2 * (deeper + dc.CTA_RESERVED_SMEM) \
                        > dc.SMEM_PER_SM
                if not both:
                    assert depth == full
            else:
                assert (where, smem, depth) == ("scratch", ring, full)
                assert dc.launch_key(arm, k) == (f"{arm}:scratch", k)
        # the next K would not fit beside the full ring
        assert ring + 3072 * (cap + 1) > dc.SMEM_PER_CTA
    with pytest.raises(ValueError):
        dc.list_plan("sub", 0)
    with pytest.raises(ValueError):
        dc.list_plan("nope", 20)


def test_ring_bytes_match_the_pinned_launch_shapes():
    """RING_STAGE_BYTES and RING_DEPTH mirror the kernel's Ring<ARM>: the
    register instances' dynamic shared memory and depth in the compile
    manifest's golden block (pinned on the card), and the wide rows' ring
    and lists at the manifest's pinned K."""
    from reporter_tpu_torch.analysis import compile_manifest as cm

    for arm in dc.SWEEP_ARMS:
        for k in dc.SWEEP_KS:
            row = cm.GOLDEN["launch"][f"{arm}@k{k}"]
            assert (row["smem_bytes"], row["depth"]) == \
                (dc.ring_smem(arm), dc.RING_DEPTH[arm])
        row = cm.GOLDEN["launch"][f"{arm}@kwide"]
        assert (row["smem_bytes"], row["depth"]) == \
            dc.list_plan(arm, cm.WIDE_PIN_K)[1:]


def test_wide_k_matches_the_interpret_pallas_body(monkeypatch):
    """The JAX package's Pallas sweep (the two-level body, in interpret
    mode, as tests/test_torch_sweep_arms.py runs its arms) at K = 20 on
    the tiny city at 150 m, where lists past 16 fill, against the port."""
    from reporter_tpu.config import CompilerParams

    monkeypatch.setattr(jdc, "_INTERPRET", True)
    monkeypatch.setattr(jdc, "_SBLK", 128)
    monkeypatch.setattr(jdc, "_SUB", 64)
    monkeypatch.setattr(jdc, "_NJ_CAP", 8)
    ts = compile_network(generate_city("tiny", seed=11), CompilerParams())
    rng = np.random.default_rng(20)
    lo, hi = ts.node_xy.min(0), ts.node_xy.max(0)
    pts = np.concatenate([ts.node_xy[:64], rng.uniform(lo, hi, (64, 2))]
                         ).astype(np.float32)
    args = (ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off, ts.seg_len)
    jsp = jdc.build_seg_pack(*args, block=128)
    sp = dc.build_seg_pack(*args)
    k = 20
    ref = jdc.find_candidates_dense(jnp.asarray(pts),
                                    tuple(jnp.asarray(x) for x in jsp),
                                    WIDE_RADIUS, k)
    got = dc.find_candidates_dense(torch.from_numpy(pts),
                                   tuple(torch.from_numpy(x) for x in sp),
                                   WIDE_RADIUS, k)
    assert int((got.edge >= 0).sum(1).max()) > 16
    monkeypatch.setattr(tdc, "K", k)
    monkeypatch.setattr(tdc, "RADIUS", WIDE_RADIUS)
    tdc._assert_close(
        [np.asarray(x) for x in (ref.edge, ref.offset, ref.dist)],
        [x.numpy() for x in (got.edge, got.offset, got.dist)])


@pytest.mark.parametrize("k,radius", [(24, 120.0), (64, WIDE_RADIUS)],
                         ids=["k24-120m", "k64-150m"])
def test_match_many_wide_k_records_equal(sf, k, radius):
    """match_many on a few sf traces at max_candidates = 24 and a 120 m
    search radius (on the card, the lists in shared memory), and at 64
    and 150 m (past every arm's shared_max_k: on the card, the lists in
    the global scratch): the port's records equal the JAX matcher's
    (tolerance 0)."""
    if k == 64:
        assert all(dc.list_plan(arm, k)[0] == "scratch"
                   for arm in dc.SWEEP_ARMS)
    params = dict(max_candidates=k, search_radius=radius)
    jm = JSegmentMatcher(sf, Config(
        matcher_backend="jax",
        matcher=MatcherParams(candidate_backend="dense", **params)))
    arrays = {f: getattr(sf, f) for f in _ARRAY_FIELDS}
    ts = TileSet.from_arrays(sf.name, sf.meta.origin_lonlat, arrays)
    m = SegmentMatcher(ts, PMatcherParams(**params), device="cpu")
    fleet = synthesize_fleet(sf, 6, num_points=60, seed=24)
    traces = [JTrace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]
    ref = jm.match_many(traces)
    got = m.match_many([Trace(t.uuid, t.xy, t.times) for t in traces])
    assert len(got) == len(ref) == len(traces)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert [x.to_json() for x in g] == [x.to_json() for x in r], i
    assert sum(len(g) for g in got) > 0
