"""The batched Viterbi decode behind the kernel of kernels/viterbi.cu: the
plain version (what the kernel is held to on a card) against
reporter_tpu.ops.hmm.viterbi_decode_batched at the widths
tests/test_torch_hmm.py does not reach (K = 1, 16, 33 and 64), the
dispatch on the candidates' device, and the kernel's launch plan (its
fields at every K, its shared memory at every point bucket, where the
levels live, and the CTAs that cover a batch).

Candidate sets are made with numpy from a seed on the tiny tile: edges
drawn from the tile's near each point, offsets within each edge's length,
some slots invalid and some -1 (valid or not), slots repeated so the
lattice has exact cost ties, a chain break past the breakage distance,
padded tails and a trace with no valid point, interpolation on and off.
Tolerance 0 on all five fields. The kernel itself runs only on a card:
tests/test_torch_kernels_gpu.py holds it to the plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reporter_tpu.config import CompilerParams, MatcherParams
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.ops.candidates import CandidateSet as JCandidateSet
from reporter_tpu.ops.hmm import viterbi_decode_batched as j_viterbi
from reporter_tpu.tiles.compiler import compile_network
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.matcher.api import _BUCKETS
from reporter_tpu_torch.ops import hmm
from reporter_tpu_torch.ops.dense_candidates import BIG, CandidateSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_FIELDS = ("choice", "edge", "offset", "chain_start", "matched")
_ROUTE_KEYS = ("edge_len", "reach_row", "reach_to", "reach_dist")
B, T = 6, 40
# the first K whose wide candidate rows outgrow a CTA's shared memory: the
# Viterbi kernel's one ceiling (``viterbi_plan``)
PAST_SMEM_K = 3985


@pytest.fixture(scope="module")
def tile():
    ts = compile_network(generate_city("tiny"),
                         CompilerParams(reach_radius=500.0,
                                        osmlr_max_length=200.0))
    tab = ts.device_tables("dense")
    mid = 0.5 * (ts.node_xy[ts.edge_src] + ts.node_xy[ts.edge_dst])
    return ts, tab, mid.astype(np.float32)


def _case(tile, k, seed):
    """Points [B, T, 2], valid [B, T] and candidate fields [B, T, K]: per
    point the K edges whose midpoints lie nearest (a chain that reaches
    across the reach rows), offsets drawn within each edge, distances
    rounded to 0.5 m (equal emissions), then slots repeated, emptied
    (-1), marked invalid, or -1 yet valid."""
    ts, _, mid = tile
    rng = np.random.default_rng(seed)
    fleet = synthesize_fleet(ts, B, num_points=T, seed=seed)
    pts = np.stack([p.xy for p in fleet]).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, 25:] = False                     # padding at the tail
    pts[1, 25:] = pts[1, 0]
    valid[4] = False                          # a trace with no valid point
    pts[3, 20:] += np.float32(900.0)          # a jump: past the breakage
    d2 = ((pts[:, :, None, :] - mid[None, None]) ** 2).sum(-1)
    order = np.argsort(d2, axis=-1, kind="stable")[..., :k]
    edge = order.astype(np.int32)
    lens = ts.edge_len[edge].astype(np.float32)
    offset = (rng.random(edge.shape, np.float32) * lens).astype(np.float32)
    dist = np.round(np.sqrt(np.take_along_axis(d2, order, -1)) * 2) / 2
    dist = dist.astype(np.float32)
    cvalid = np.ones(edge.shape, bool)
    if k > 1:
        # exact ties: slot 1 repeats slot 0 on a third of the points
        rep = rng.random((B, T)) < 0.33
        for a in (edge, offset, dist):
            a[..., 1] = np.where(rep, a[..., 0], a[..., 1])
        hole = rng.random(edge.shape) < 0.15
        hole[..., 0] = False
        edge[hole] = -1
        dist[hole] = np.float32(BIG)
        cvalid[hole] = False
        cvalid[rng.random(edge.shape) < 0.1] = False
        # -1 yet valid: no route reaches it, its emission still counts
        edge[(rng.random(edge.shape) < 0.03) & cvalid] = -1
    cvalid[2, 10:14] = False                  # no candidate: inactive points
    return pts, valid, (edge, offset, dist, cvalid)


def _both(tile, pts, valid, cands, interp, breakage):
    _, tab, _ = tile
    p = MatcherParams()
    args = (p.sigma_z, p.beta, p.max_route_distance_factor, breakage,
            p.backward_slack, interp)
    ref = j_viterbi(JCandidateSet(*(jnp.asarray(x) for x in cands)),
                    jnp.asarray(pts), jnp.asarray(valid), tab, *args)
    ttab = {k: torch.from_numpy(np.array(tab[k])) for k in _ROUTE_KEYS}
    got = hmm.viterbi_decode_batched(
        CandidateSet(*(torch.from_numpy(x) for x in cands)),
        torch.from_numpy(pts), torch.from_numpy(valid), ttab, *args)
    return ref, got


@pytest.mark.parametrize("interp", [10.0, 0.0])
@pytest.mark.parametrize("k", [1, 16, 33, 64])
def test_plain_viterbi_matches_reference_at_every_width(tile, k, interp):
    pts, valid, cands = _case(tile, k, seed=k)
    ref, got = _both(tile, pts, valid, cands, interp, 150.0)
    for f in _FIELDS:
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f).numpy()
        assert have.dtype == want.dtype, f
        np.testing.assert_array_equal(have, want, err_msg=f)
    m = got.matched.numpy()
    assert m[0].any() and not m[4].any() and not m[1, 25:].any()
    # the jump breaks trace 3's chain where it lands
    assert got.chain_start.numpy()[3, 20]


def test_the_case_holds_cost_ties_and_breaks(tile):
    """The inputs do what the parity test relies on: repeated slots
    (equal emissions and transitions), several chains per trace."""
    pts, valid, cands = _case(tile, 16, seed=16)
    edge, offset, dist, cvalid = cands
    same = ((edge[..., 0] == edge[..., 1]) & (offset[..., 0] == offset[..., 1])
            & cvalid[..., 0] & cvalid[..., 1])
    assert same.sum() >= 20
    _, got = _both(tile, pts, valid, cands, 0.0, 150.0)
    assert int(got.chain_start.sum()) > B


def test_cpu_candidates_take_the_plain_version(tile):
    pts, valid, cands = _case(tile, 8, seed=3)
    _, tab, _ = tile
    ttab = {k: torch.from_numpy(np.array(tab[k])) for k in _ROUTE_KEYS}
    c = CandidateSet(*(torch.from_numpy(x) for x in cands))
    p = MatcherParams()
    args = (torch.from_numpy(pts), torch.from_numpy(valid), ttab, p.sigma_z,
            p.beta, p.max_route_distance_factor, p.breakage_distance,
            p.backward_slack, p.interpolation_distance)
    before = dict(hmm.VITERBI_LAUNCHES)
    got = hmm.viterbi_decode_batched(c, *args)
    want = hmm._viterbi_plain(c, *args)
    assert dict(hmm.VITERBI_LAUNCHES) == before      # no kernel launched
    for f in _FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_a_device_that_is_neither_card_nor_cpu_raises():
    c = CandidateSet(*(torch.empty((2, 3, 4), dtype=d, device="meta")
                       for d in (torch.int32, torch.float32, torch.float32,
                                 torch.bool)))
    with pytest.raises(ValueError, match="unsupported device"):
        hmm.viterbi_decode_batched(
            c, torch.empty((2, 3, 2), device="meta"),
            torch.empty((2, 3), dtype=torch.bool, device="meta"), {},
            4.07, 3.0, 5.0, 2000.0)


def _kernel_args(k, **over):
    """Arguments the kernel's wrapper checks before it builds or launches
    anything (CPU tensors stand in for the card's)."""
    c = CandidateSet(torch.zeros((2, 3, k), dtype=torch.int32),
                     torch.zeros((2, 3, k)), torch.zeros((2, 3, k)),
                     torch.zeros((2, 3, k), dtype=torch.bool))
    tab = {"edge_len": torch.ones(5),
           "reach_row": torch.zeros(5, dtype=torch.int32),
           "reach_to": torch.zeros((2, 128), dtype=torch.int32),
           "reach_dist": torch.zeros((2, 128))}
    tab.update(over)
    return (c, torch.zeros((2, 3, 2)), torch.ones((2, 3), dtype=torch.bool),
            tab, 4.07, 3.0, 5.0, 2000.0, 10.0, 0.0)


def test_the_kernel_wrapper_refuses_a_k_past_its_ceiling():
    """Past the shared memory's ceiling, before anything is built (K = 65
    and beyond 64 are the wide instances' now: test_the_launch_plan_
    refuses_a_width_outside_the_kernel)."""
    k = PAST_SMEM_K
    with pytest.raises(ValueError, match=f"K={k} .*shared memory"):
        hmm._viterbi_cuda(*_kernel_args(k))


@pytest.mark.parametrize("member,bad", [
    ("reach_row", torch.zeros(5, dtype=torch.int64)),
    ("reach_to", torch.zeros((2, 128))),
    ("edge_len", torch.ones(5, dtype=torch.float64)),
])
def test_the_kernel_wrapper_checks_the_tables(member, bad):
    with pytest.raises(ValueError, match=member):
        hmm._viterbi_cuda(*_kernel_args(8, **{member: bad}))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 48, 64])
def test_the_launch_plan_covers_k(k):
    plan = hmm.viterbi_plan(1024, 120, k)
    assert set(plan) == {"kernel", "instance", "traces_per_cta",
                         "threads_per_trace", "recurrence_threads", "chunk",
                         "pairs", "smem_bytes", "levels", "scratch_bytes"}
    assert plan["instance"] == 0 and plan["pairs"] == 0
    assert plan["kernel"] == "viterbi_decode_kernel"
    tpt, tpc = plan["threads_per_trace"], plan["traces_per_cta"]
    rt = plan["recurrence_threads"]
    cols = 1 << (k - 1).bit_length()     # the kernel's columns
    assert tpt % 32 == 0 and 64 <= tpt <= 128 and tpc * tpt == 128
    # the recurrence: one warp up to K = 16, else two lanes a column, as
    # the kernel takes it (whole warps, G = rt / columns lanes a column)
    assert rt % 32 == 0 and 32 <= rt <= tpt and rt % cols == 0
    group = rt // cols
    assert group in (2, 4, 8, 16, 32) and (rt == 32 or group == 2)
    # a chunk's lookups: at most about 2048 pairs, at least one step
    assert 1 <= plan["chunk"] <= 32
    assert plan["chunk"] * k * k <= 2048 or plan["chunk"] == 1
    assert plan["levels"] == "shared" and plan["scratch_bytes"] == 0
    assert plan["smem_bytes"] == tpc * hmm.viterbi_smem_bytes(
        120, k, plan["chunk"], True)


@pytest.mark.parametrize("k,tpt,rt,tpc,chunk", [
    (1, 64, 32, 2, 32), (4, 64, 32, 2, 32), (8, 64, 32, 2, 32),
    (16, 64, 32, 2, 8), (33, 128, 128, 1, 1), (64, 128, 128, 1, 1)])
def test_the_launch_plan_at_the_served_widths(k, tpt, rt, tpc, chunk):
    plan = hmm.viterbi_plan(1, 128, k)
    assert (plan["threads_per_trace"], plan["recurrence_threads"],
            plan["traces_per_cta"], plan["chunk"]) == (tpt, rt, tpc, chunk)


@pytest.mark.parametrize("t", _BUCKETS)
def test_the_launch_plan_fits_shared_memory_at_every_bucket(t):
    """At every K the kernel takes and every point bucket: the CTA's
    shared memory within the card's 227 KB and the plan's budget; the
    levels in the global scratch exactly where, beside the chunk, they
    would take the CTA past the budget."""
    for k in range(1, hmm.VITERBI_MAX_K + 1):
        plan = hmm.viterbi_plan(1024, t, k)
        tpc, chunk = plan["traces_per_cta"], plan["chunk"]
        assert plan["smem_bytes"] <= hmm.VITERBI_SMEM_BUDGET \
            <= hmm.VITERBI_SMEM_MAX == 232448, (k, t)
        with_levels = tpc * hmm.viterbi_smem_bytes(t, k, chunk, True)
        here = with_levels <= hmm.VITERBI_SMEM_BUDGET
        assert plan["levels"] == ("shared" if here else "global"), (k, t)
        if here:
            assert plan["smem_bytes"] == with_levels
            assert plan["scratch_bytes"] == 0
        else:
            assert plan["smem_bytes"] == tpc * hmm.viterbi_smem_bytes(
                t, k, chunk, False) < with_levels
            assert plan["scratch_bytes"] == 1024 * t * (k + 2)
    # the card tests take both paths: T = 1024 at K = 32 and 64 goes
    # global (K = 8 stays in shared memory), the served T = 128 stays in
    # shared memory
    if t == 1024:
        assert [hmm.viterbi_plan(3, t, k)["levels"] for k in (8, 32, 64)] \
            == ["shared", "global", "global"]
    if t == 128:
        assert {hmm.viterbi_plan(3, t, k)["levels"] for k in (1, 8, 64)} \
            == {"shared"}


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 127, 1023, 1024, 1025])
def test_the_launch_plan_covers_any_batch(b):
    """The batch moves nothing but the scratch: the kernel's grid is as
    many CTAs of traces_per_cta traces as cover B, the last one partly
    filled where B is not a multiple."""
    for k in (1, 4, 8, 9, 16, 17, 32, 33, 64):
        for t in (128, 1024):
            plan, one = hmm.viterbi_plan(b, t, k), hmm.viterbi_plan(1, t, k)
            assert {**plan, "scratch_bytes": 0} \
                == {**one, "scratch_bytes": 0}, (k, b, t)
            assert plan["scratch_bytes"] == b * one["scratch_bytes"]
            assert plan["traces_per_cta"] in (1, 2), (k, b)


@pytest.mark.parametrize("t", [100_000, 120_000, 250_000, 1_000_000])
def test_the_launch_plan_takes_any_length(t):
    """Past some 10,000 points the levels are global at every K, and
    then the CTA's shared memory does not grow with T (the backtrack's
    choices go to the output, not to shared memory): the same bytes as
    at T = 20,000, within the card's 227 KB, at any T."""
    for k in range(1, hmm.VITERBI_MAX_K + 1):
        plan, ref = hmm.viterbi_plan(3, t, k), hmm.viterbi_plan(3, 20_000, k)
        assert plan["levels"] == ref["levels"] == "global", (k, t)
        assert plan["smem_bytes"] == ref["smem_bytes"] \
            <= hmm.VITERBI_SMEM_BUDGET, (k, t)
        assert plan["scratch_bytes"] == 3 * t * (k + 2)


def _wide_plan_holds(b, t, k):
    """The wide kernel's plan at (B, T, K): instance 1 to K = 254, 2 from
    255; one trace a CTA of VITERBI_WIDE_THREADS, all in the recurrence;
    a chunk of as many steps as keep its candidate rows near
    VITERBI_WIDE_ROWS bytes (at least one, at most 32 and T); a pass of
    VITERBI_WIDE_PAIRS pairs, fewer only where the CTA would pass the
    card's shared memory; the levels in shared memory exactly where the
    CTA then fits the budget; the scratch the global levels' B * T *
    (word + K * backpointer) bytes."""
    plan = hmm.viterbi_plan(b, t, k)
    assert plan["instance"] == (1 if k <= 254 else 2)
    assert plan["kernel"] == "viterbi_decode_wide_kernel"
    assert (plan["traces_per_cta"], plan["threads_per_trace"],
            plan["recurrence_threads"]) == (1, hmm.VITERBI_WIDE_THREADS,
                                            hmm.VITERBI_WIDE_THREADS)
    chunk, pairs = plan["chunk"], plan["pairs"]
    assert chunk == max(1, min(32, t, hmm.VITERBI_WIDE_ROWS // (23 * k) - 1))
    here = hmm.viterbi_wide_smem_bytes(t, k, chunk, hmm.VITERBI_WIDE_PAIRS,
                                       True) <= hmm.VITERBI_SMEM_BUDGET
    assert plan["levels"] == ("shared" if here else "global")
    full = hmm.viterbi_wide_smem_bytes(t, k, chunk, hmm.VITERBI_WIDE_PAIRS,
                                       here)
    assert hmm.VITERBI_WIDE_MIN_PAIRS <= pairs <= hmm.VITERBI_WIDE_PAIRS
    assert (pairs == hmm.VITERBI_WIDE_PAIRS) == (
        full <= hmm.VITERBI_SMEM_MAX)
    assert plan["smem_bytes"] == hmm.viterbi_wide_smem_bytes(
        t, k, chunk, pairs, here) <= hmm.VITERBI_SMEM_MAX
    if pairs < hmm.VITERBI_WIDE_PAIRS:     # the most that fit
        assert hmm.viterbi_wide_smem_bytes(
            t, k, chunk, pairs + 4, here) > hmm.VITERBI_SMEM_MAX
    word, bp = 4, (1 if k <= 254 else 2)
    assert plan["scratch_bytes"] == (0 if here else b * t * (word + bp * k))
    return plan


@pytest.mark.parametrize("k", [0, 65, 128, 96, 256, 300, PAST_SMEM_K - 1,
                               PAST_SMEM_K])
def test_the_launch_plan_refuses_a_width_outside_the_kernel(k):
    """K = 0 and K whose candidate rows outgrow a CTA's shared memory
    (from PAST_SMEM_K) are refused; K = 65, 96, 128, 256, 300 and the
    last that fits, past instance 0's 64, are the wide instances'
    plans."""
    if 1 <= k < PAST_SMEM_K:
        assert k > hmm.VITERBI_MAX_K
        _wide_plan_holds(4, 4, k)
        return
    with pytest.raises(ValueError, match=f"K={k}"):
        hmm.viterbi_plan(4, 4, k)


@pytest.mark.parametrize("k", [65, 96, 128, 233, 234, 254, 255, 256, 300,
                               1000])
def test_the_wide_launch_plan_at_every_bucket(k):
    """Past K = 64 at every point bucket and B = 1, 3, 1024: the wide
    plan (``_wide_plan_holds``); a whole pass budget to K = 1000; the
    batch moves nothing but the scratch."""
    for t in _BUCKETS:
        one = _wide_plan_holds(1, t, k)
        for b in (3, 1024):
            plan = _wide_plan_holds(b, t, k)
            assert {**plan, "scratch_bytes": 0} == \
                {**one, "scratch_bytes": 0}
        assert plan["pairs"] == hmm.VITERBI_WIDE_PAIRS


@pytest.mark.parametrize("k,kernel,instance", [
    (64, "viterbi_decode_kernel", 0),
    (65, "viterbi_decode_wide_kernel", 1),
    (254, "viterbi_decode_wide_kernel", 1),
    (255, "viterbi_decode_wide_kernel", 2),
    (PAST_SMEM_K - 1, "viterbi_decode_wide_kernel", 2),
    (PAST_SMEM_K, None, None)])
def test_the_kernel_and_instance_at_each_boundary(k, kernel, instance):
    """Instance 0's kernel to K = 64; the wide kernel's u8 instance from
    65 to 254, its u16 one from 255 to the last K whose candidate rows
    leave a pass of VITERBI_WIDE_MIN_PAIRS beside them (3,984, where the
    pass is cut to what fits); past it the plan refuses, as before."""
    for t in (1, 128, 1024):
        if kernel is None:
            with pytest.raises(ValueError, match=f"K={k} .*shared memory"):
                hmm.viterbi_plan(3, t, k)
            continue
        plan = hmm.viterbi_plan(3, t, k)
        assert (plan["kernel"], plan["instance"]) == (kernel, instance)
        assert hmm.viterbi_instance(k) == instance
        if k == PAST_SMEM_K - 1:
            assert plan["chunk"] == 1 and plan["levels"] == "global"
            assert hmm.VITERBI_WIDE_MIN_PAIRS <= plan["pairs"] \
                < hmm.VITERBI_WIDE_PAIRS
            assert plan["smem_bytes"] <= hmm.VITERBI_SMEM_MAX


@pytest.mark.parametrize("k,chunk", [(65, 15), (96, 10), (128, 7),
                                     (254, 3), (255, 3), (512, 1),
                                     (1000, 1)])
def test_the_wide_chunk_and_pass_budget(k, chunk):
    """The wide chunk by its rows' bytes (23 a slot, about
    VITERBI_WIDE_ROWS a chunk), never past T; a pass of 4,096 pairs;
    shared levels at the served T = 128 to K = 96, global past it (the
    CTA then stays in about a quarter of an SM's shared memory)."""
    plan = hmm.viterbi_plan(1024, 128, k)
    assert (plan["chunk"], plan["pairs"]) == (chunk, 4096)
    assert hmm.viterbi_plan(1, 3, k)["chunk"] == min(chunk, 3)
    assert plan["levels"] == ("shared" if k <= 96 else "global")
    if k <= 128:
        assert plan["smem_bytes"] <= hmm.VITERBI_SMEM_BUDGET


def wide_recurrence(score, trans, prev_looked, next_looked, budget, off=0,
                    threads=128):
    """The wide kernel's recurrence for one step, as it walks its passes:
    the step's looked-up pairs (ii, jj) in that order from pair `off` of
    the chunk, looked up `budget` at a time; each pass gives every
    looked-up column jj its pairs there, G lanes a column (as many as
    `threads` cover, up to 32) each over ii = sub, sub + G, ... ascending,
    the (value, slot) pairs reduced lexicographically and kept over the
    passes. → {column slot j: (best, first argmin slot)}."""
    plist = np.flatnonzero(prev_looked)
    clist = np.flatnonzero(next_looked)
    npr, nc = len(plist), len(clist)
    pend = off + npr * nc
    G = 1
    while G < 32 and nc * G * 2 <= threads:
        G *= 2
    out = {}
    f_lo = (off // budget) * budget
    while f_lo < pend:
        f_hi = f_lo + budget
        lo_f, hi_f = max(off, f_lo) - off, min(pend, f_hi) - off
        first = off >= f_lo
        for jj in range(nc):
            ii_lo = -(-(lo_f - jj) // nc) if lo_f > jj else 0
            ii_hi = -(-(hi_f - jj) // nc) if hi_f > jj else 0
            lanes = []
            for sub in range(G):
                best, arg = np.float32(np.inf), len(score)
                for ii in range(ii_lo + sub, ii_hi, G):
                    i = plist[ii]
                    via = np.float32(score[i] + trans[i, clist[jj]])
                    if via < best:
                        best, arg = via, i
                lanes.append((best, arg))
            got = min(lanes)
            j = clist[jj]
            out[j] = got if first else min(got, out[j])
        f_lo = f_hi
    return out


@pytest.mark.parametrize("budget", [1, 5, 37, 4096])
@pytest.mark.parametrize("seed", range(4))
def test_the_wide_recurrence_equals_the_full_argmin(seed, budget):
    """The wide kernel's recurrence over looked-up pairs alone, in passes
    of `budget` pairs (a step straddling passes from any offset in the
    chunk), equals the plain version's step over all K: where the column
    connects (its best below BIG), the same best and first argmin; else
    not connected either way (a slot not looked up adds BIG to a score >=
    0). Scores and costs drawn from a few values, so ties abound."""
    rng = np.random.default_rng(seed)
    k = 65 + 8 * seed
    for trial in range(3):
        prev_looked = rng.random(k) < (0.1, 0.4, 0.7)[trial]
        next_looked = rng.random(k) < (0.4, 0.1, 0.7)[trial]
        score = rng.choice(np.float32([0.0, 0.5, 1.0, 2.5, BIG]), k)
        trans = rng.choice(np.float32([0.25, 0.5, 1.0, BIG]), (k, k))
        trans[~(prev_looked[:, None] & next_looked[None, :])] = BIG
        via = torch.from_numpy(score)[:, None] + torch.from_numpy(trans)
        best, arg = via.min(dim=0)
        got = wide_recurrence(score, trans, prev_looked, next_looked,
                              budget, off=int(rng.integers(0, 50)))
        for j in range(k):
            connected = bool(best[j] < BIG)
            if j in got:
                assert (got[j][0] < BIG) == connected, j
                if connected:
                    assert got[j] == (best[j].item(), int(arg[j])), j
            else:
                assert not connected, j
