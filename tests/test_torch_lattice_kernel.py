"""The ranked-path lattice of the port (ops/hmm.py's keep mask, list-Viterbi
forward pass and R-path backtrack, restructured to the contract of
kernels/lattice.cu) on the CPU.

- The port's ``viterbi_topk_paths``, ``viterbi_kbest_paths`` and
  ``interpolation_keep_mask`` against the JAX package's on the same
  candidates, at K in {1, 2, 8, 16} and R in {1, 2, K}, interpolation on
  and off, across a chain break, on an all-inactive trace and at T = 1:
  choices, validity and keep masks equal (tolerance 0), scores within
  tests/test_torch_topk.py's SCORE_RTOL (XLA:CPU may fuse the
  multiply-adds the port rounds one by one).
- numpy models of the kernels' algorithms held to the plain versions at
  tolerance 0: the K-way merge as a linear scan and as the forward
  kernel's loser tree against a stable sort on tie-heavy rows; the whole
  forward kernel (chunks of steps, the control sequence, each looked-up
  pair's transition by binary search of its reach row, the merge, the
  broken rule, each level's own argmin from the row heads) against
  ``_lattice_prep`` + ``_forward_list_plain``, and the ring-fed backtrack
  kernel against ``_backtrack_plain``, on real lattices.
- The keep-mask kernel's algorithm in numpy f32 (tiles, the tile's first
  kept point from the carried one, each valid point's next kept point by
  windows of 32, the chain marked by pointer doubling) against
  ``_keep_mask_batched`` on seeded traces: moving, standing still,
  standing then driving, sparse validity, points exactly at the
  interpolation distance, tiles of 16 and 2048 points.
- ``lattice_plan`` and ``backtrack_plan`` at every bucket length and K up
  to 64, and the wide instances' plans past it (K = 65, 96, 128, 256,
  300); the wrappers' refusals (K, R, dtype, shape, device), none of
  which needs nvcc.

The kernels themselves run on the card: tests/test_torch_kernels_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.netgen.synthetic import generate_city as j_generate_city
from reporter_tpu.netgen.traces import synthesize_probe
from reporter_tpu.ops import hmm as jhmm
from reporter_tpu.ops.candidates import CandidateSet as JCandidateSet
from reporter_tpu.ops.match import batch_candidates as j_batch_candidates
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.kernels import build
from reporter_tpu_torch.matcher.api import _BUCKETS, _bucket_len
from reporter_tpu_torch.ops import hmm
from reporter_tpu_torch.ops.dense_candidates import BIG, CandidateSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

SCORE_RTOL = 2e-6      # tests/test_torch_topk.py's
BREAKAGE = 300.0
# the first K whose wide candidate rows outgrow a CTA's shared memory: the
# forward kernel's one ceiling (``lattice_plan``)
PAST_SMEM_K = 2509
_TABLES = ("edge_len", "reach_row", "reach_to", "reach_dist")
F32 = np.float32


@pytest.fixture(scope="module")
def tile():
    """The ranked-path tests' tiny tile (tests/test_torch_topk.py's) and a
    JAX dense matcher on it; the port reads the JAX tables."""
    jts = j_compile_network_tiny()
    jm = JSegmentMatcher(jts, JConfig(matcher=JMatcherParams(
        candidate_backend="dense")))
    tab = {k: torch.from_numpy(np.array(jm._tables[k])) for k in _TABLES}
    return jts, jm, tab


def j_compile_network_tiny():
    from reporter_tpu.tiles.compiler import compile_network

    return compile_network(j_generate_city("tiny"),
                           JCompilerParams(reach_radius=500.0,
                                           osmlr_max_length=250.0))


def _trace(jts, kind: str):
    """(xy [n, 2] f32, valid [n]) of one case: a 40-point drive, two
    drives farther apart than BREAKAGE, a drive with every point invalid,
    one point, or a drive whose points 5, 10, ..., 35 and 32 are invalid
    (the first rows of chunks of 5 and 32 steps)."""
    if kind == "break":
        a = synthesize_probe(jts, seed=8, num_points=20, gps_sigma=2.0).xy
        b = synthesize_probe(jts, seed=31, num_points=20, gps_sigma=2.0).xy
        xy = np.concatenate([a, b])
        assert np.linalg.norm(a[-1] - b[0]) > BREAKAGE
    else:
        n = 1 if kind == "one" else 40
        xy = synthesize_probe(jts, seed=13, num_points=max(n, 2),
                              speed_mps=12.0, gps_sigma=3.0).xy[:n]
    valid = np.full(len(xy), kind != "inactive")
    if kind == "gaps":
        valid[5::5] = False
        valid[32] = False
    return xy.astype(F32), valid


def _lattice(jm, tab, xy, valid, k):
    """The JAX dense candidates of a trace padded to its bucket (a
    one-point trace: T = 1) at width k, as (JAX inputs, port inputs) of
    the lattice functions."""
    T = 1 if len(xy) == 1 else _bucket_len(len(xy))
    pts = np.zeros((1, T, 2), F32)
    pts[0, :len(xy)] = xy
    vp = np.zeros((1, T), bool)
    vp[0, :len(xy)] = valid
    params = dataclasses.replace(jm.params, max_candidates=k)
    c = [np.asarray(x[0]) for x in j_batch_candidates(
        jnp.asarray(pts), jnp.asarray(vp), jm._tables, jm.ts.meta, params)]
    jin = (JCandidateSet(*(jnp.asarray(x) for x in c)), jnp.asarray(pts[0]),
           jnp.asarray(vp[0]), jm._tables)
    pin = (CandidateSet(*(torch.from_numpy(np.array(x)) for x in c)),
           torch.from_numpy(pts[0]), torch.from_numpy(vp[0]), tab)
    return jin, pin


def _args(jm, interp):
    p = jm.params
    return (p.sigma_z, p.beta, p.max_route_distance_factor, BREAKAGE,
            p.backward_slack, interp)


def _equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=SCORE_RTOL)
    assert got[0].dtype == torch.int32


# (K, R, interpolation distance): R None is the terminal form
_PARITY = [(1, None, 10.0), (1, 1, 10.0),
           (2, None, 10.0), (2, 1, 10.0), (2, 2, 10.0),
           (8, None, 10.0), (8, None, 0.0), (8, 1, 10.0), (8, 2, 10.0),
           (8, 8, 10.0), (8, 2, 0.0), (8, 8, 0.0),
           (16, None, 10.0), (16, 1, 10.0), (16, 2, 10.0), (16, 16, 10.0),
           (16, 16, 0.0)]


@pytest.mark.parametrize("k,r,interp", _PARITY)
def test_lattice_equals_reference(tile, k, r, interp):
    """The terminal completions (R None) or the exact R best at width K
    on a 40-point drive: choices and validity equal, scores within
    SCORE_RTOL; the keep mask equal."""
    jts, jm, tab = tile
    xy, valid = _trace(jts, "drive")
    (jc, jp, jv, jtab), (pc, pp, pv, ptab) = _lattice(jm, tab, xy, valid, k)
    args = _args(jm, interp)
    np.testing.assert_array_equal(
        hmm.interpolation_keep_mask(pp, pv, interp).numpy(),
        np.asarray(jhmm.interpolation_keep_mask(jp, jv, interp)))
    if r is None:
        got = hmm.viterbi_topk_paths(pc, pp, pv, ptab, *args)
        want = jhmm.viterbi_topk_paths(jc, jp, jv, jtab, *args)
    else:
        got = hmm.viterbi_kbest_paths(pc, pp, pv, ptab, *args, num_paths=r)
        want = jhmm.viterbi_kbest_paths(jc, jp, jv, jtab, *args,
                                        num_paths=r)
    _equal(got, want)
    assert got[2].numpy().any()


@pytest.mark.parametrize("kind", ["break", "inactive", "one"])
@pytest.mark.parametrize("r", [None, 2])
def test_lattice_edge_cases_equal_reference(tile, kind, r):
    """A chain broken past BREAKAGE, a trace of invalid points only and
    a one-point trace, at K = 8: equal to the JAX package's."""
    jts, jm, tab = tile
    xy, valid = _trace(jts, kind)
    (jc, jp, jv, jtab), (pc, pp, pv, ptab) = _lattice(jm, tab, xy, valid, 8)
    args = _args(jm, 10.0)
    if r is None:
        got = hmm.viterbi_topk_paths(pc, pp, pv, ptab, *args)
        want = jhmm.viterbi_topk_paths(jc, jp, jv, jtab, *args)
    else:
        got = hmm.viterbi_kbest_paths(pc, pp, pv, ptab, *args, num_paths=r)
        want = jhmm.viterbi_kbest_paths(jc, jp, jv, jtab, *args,
                                        num_paths=r)
    _equal(got, want)
    assert got[2].numpy().any() == (kind != "inactive")


# ---- numpy models of the kernels' algorithms ------------------------------


def merge_select(score: np.ndarray, col: np.ndarray, r: int):
    """The forward kernel's selection for one column c: the R smallest of
    score[cp, q] + col[cp] by a K-way merge of the K rows (each
    ascending): R picks, each the first minimal row head, the winner's row
    then advancing (a spent row reads +inf). → (values [R], flat states
    cp * R + q [R])."""
    K, R = score.shape
    head = np.array([F32(score[cp, 0] + col[cp]) for cp in range(K)], F32)
    rank = np.zeros(K, int)
    vals, idx = [], []
    for _ in range(r):
        arg = 0
        best = F32(np.inf)
        for cp in range(K):
            if head[cp] < best:
                best, arg = head[cp], cp
        vals.append(best)
        idx.append(arg * R + rank[arg])
        if rank[arg] + 1 < R:
            rank[arg] += 1
            head[arg] = F32(score[arg, rank[arg]] + col[arg])
        else:
            head[arg] = F32(np.inf)
    return np.array(vals, F32), np.array(idx)


def _stable(score, col, r):
    via = (score + col[:, None]).astype(F32).reshape(-1)
    order = np.argsort(via, kind="stable")[:r]
    return via[order], order


def _rows(rng, K, R, kind):
    """Ascending rows [K, R]: tie-heavy small integers, rows equal to one
    another, rows of BIG, or restart rows [em, BIG, ...]."""
    if kind == "ties":
        s = np.sort(rng.integers(0, 4, (K, R)), axis=1).astype(F32)
    elif kind == "equal":
        s = np.tile(np.sort(rng.integers(0, 3, R)).astype(F32), (K, 1))
    elif kind == "big":
        s = np.sort(rng.integers(0, 3, (K, R)), axis=1).astype(F32)
        s[rng.random(K) < 0.5] = F32(BIG)
        s[:, R // 2:] = F32(BIG)
    else:
        s = np.full((K, R), BIG, F32)
        s[:, 0] = rng.integers(0, 3, K)
    return s


@pytest.mark.parametrize("kind", ["ties", "equal", "big", "restart"])
@pytest.mark.parametrize("k", [1, 2, 5, 8, 16, 33])
def test_merge_equals_the_stable_sort(k, kind):
    """The K-way merge picks what torch.sort(stable=True) / lax.top_k
    keep: the same values and flat states at R = 1, 2 and K, on rows with
    many equal sums across and within rows, BIG rows and restarts."""
    rng = np.random.default_rng(k * 7 + len(kind))
    for trial in range(20):
        for r in sorted({1, 2, k} & set(range(1, k + 1))):
            score = _rows(rng, k, r, kind)
            col = rng.integers(0, 3, k).astype(F32)
            col[rng.random(k) < 0.2] = F32(BIG)
            got = merge_select(score, col, r)
            want = _stable(score, col, r)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            # and the plain version's own torch sort
            t = torch.sort(torch.from_numpy(
                (score + col[:, None]).astype(F32).reshape(-1)),
                stable=True)
            np.testing.assert_array_equal(got[1], t.indices[:r].numpy())


@pytest.mark.parametrize("kind", ["ties", "equal", "big", "restart",
                                  "spent"])
@pytest.mark.parametrize("k", [1, 5, 7, 12, 64])
def test_tree_merge_equals_the_stable_sort(k, kind):
    """The loser tree's picks are the stable sort's (torch.sort(stable=
    True), lax.top_k): the same values and flat states wherever the value
    is below BIG, (BIG, -1) past it, at R = 1, 2 and K, on rows of equal
    heads, tie-heavy rows, BIG rows, restarts and rows that run out."""
    rng = np.random.default_rng(k * 11 + len(kind))
    for trial in range(6 if k == 64 else 20):
        for r in sorted({1, 2, k} & set(range(1, k + 1))):
            if kind == "spent":
                score = np.full((k, r), BIG, F32)
                score[:2] = np.sort(rng.integers(0, 3, (min(k, 2), r)),
                                    axis=1)
            else:
                score = _rows(rng, k, r, kind)
            col = rng.integers(0, 3, k).astype(F32)
            col[rng.random(k) < 0.2] = F32(BIG)
            vals, idx = tree_merge(score, col, r)
            want_v, want_i = _stable(score, col, r)
            low = want_v < BIG
            np.testing.assert_array_equal(vals[low], want_v[low])
            np.testing.assert_array_equal(idx[low], want_i[low])
            assert (vals[~low] == F32(BIG)).all() and (idx[~low] == -1).all()


def tree_merge(score: np.ndarray, col: np.ndarray, r: int):
    """The forward kernel's selection for one column at R > 1 (and any
    K): a loser tree over the K row heads, each head the key (f32 bits <<
    32 | cp << 6 | rank), K padded to a power of two with keys that lose
    every tie, built bottom-up (losers in the heap nodes, the winner
    returned); a pick takes the winner, advances its row (a spent row's
    key loses every tie) and replays its leaf-to-root path. Picks stop at
    the first value >= BIG: the rest are (BIG, -1). → (values [r], flat
    states cp * R + rank [r])."""
    K, R = score.shape
    N = 1 << max(K - 1, 0).bit_length() if K > 1 else 1
    spent = (1 << 64) - 1

    def key(v, cp, rank):
        bits = int(np.array(v, F32).view(np.uint32))
        return (bits << 32) | (cp << 6) | rank

    def head(cp, rank):
        return key(F32(score[cp, rank] + col[cp]), cp, rank)

    tree = [spent] * max(N, 1)

    def build(lo, n, node):
        if n == 1:
            return head(lo, 0) if lo < K else spent
        a = build(lo, n // 2, 2 * node)
        b = build(lo + n // 2, n // 2, 2 * node + 1)
        tree[node] = max(a, b)
        return min(a, b)

    x = build(0, N, 1)
    vals, idx = [], []
    done = False
    for q in range(r):
        v = np.array(x >> 32, np.uint32).view(F32)[()] if x != spent \
            else F32(np.inf)
        if done or not v < BIG:
            done = True
            vals.append(F32(BIG))
            idx.append(-1)
            continue
        cp, rank = (x & 0xffffffff) >> 6, x & 63
        vals.append(F32(v))
        idx.append(cp * R + rank)
        k = head(cp, rank + 1) if rank + 1 < R else spent
        node = (N + cp) >> 1
        while node >= 1:
            if tree[node] < k:
                tree[node], k = k, tree[node]
            node >>= 1
        x = k
    return np.array(vals, F32), np.array(idx)


def wide_tree_merge(score: np.ndarray, col: np.ndarray, looked: np.ndarray,
                    r: int):
    """The wide forward's selection for one looked-up column at R > 1: a
    loser tree over the looked-up previous rows alone (np leaves in row
    order, padded to a power of two N with keys that lose every tie),
    each head the key (f32 bits << 32 | ii << 16 | rank), ii the row's
    leaf (its place among the looked-up rows, which ascend, so ii orders
    as the row does), the winners built bottom-up, then each node's loser
    top-down; a pick takes the winner, advances its row and replays its
    leaf's path. Picks stop at the first value >= BIG: the rest are (BIG,
    -1). → (values [r], flat states [r])."""
    K, R = score.shape
    rows = np.flatnonzero(looked)
    npr = len(rows)
    N = 1 << max(npr - 1, 0).bit_length()
    spent = (1 << 64) - 1

    def key(v, ii, rank):
        bits = int(np.array(v, F32).view(np.uint32))
        return (bits << 32) | (int(ii) << 16) | rank

    def leaf(ii):
        return key(F32(score[rows[ii], 0] + col[rows[ii]]), ii, 0) \
            if ii < npr else spent

    tree = [spent] * (N + 1)

    def at(n):
        return leaf(n - N) if n >= N else tree[n]

    for n in range(N - 1, 0, -1):
        tree[n] = min(at(2 * n), at(2 * n + 1))
    x = tree[1] if N > 1 else leaf(0)
    for n in range(1, N):
        tree[n] = max(at(2 * n), at(2 * n + 1))
    vals, idx = [], []
    done = False
    for _ in range(r):
        v = np.array(x >> 32, np.uint32).view(F32)[()] if x != spent \
            else F32(np.inf)
        if done or not v < BIG:
            done = True
            vals.append(F32(BIG))
            idx.append(-1)
            continue
        ii, rank = (x >> 16) & 0xffff, x & 0xffff
        cp = rows[ii]
        vals.append(F32(v))
        idx.append(cp * R + rank)
        k = key(F32(score[cp, rank + 1] + col[cp]), ii, rank + 1) \
            if rank + 1 < R else spent
        node = (N + ii) >> 1
        while node >= 1:
            if tree[node] < k:
                tree[node], k = k, tree[node]
            node >>= 1
        x = k
    return np.array(vals, F32), np.array(idx)


def wide_first_pass(score: np.ndarray, col: np.ndarray,
                    looked: np.ndarray, lanes: int):
    """The wide forward's first pass for one looked-up column: `lanes`
    lanes, lane l over the looked-up rows ii = l, l + lanes, ... (the
    first minimal head of its rows), then the (value, row) pairs reduced
    lexicographically. → (best head, its row)."""
    rows = np.flatnonzero(looked)
    pairs = []
    for lane in range(lanes):
        best, arg = F32(np.inf), score.shape[0]
        for cp in rows[lane::lanes]:
            v = F32(score[cp, 0] + col[cp])
            if v < best:
                best, arg = v, cp
        pairs.append((best, arg))
    return min(pairs)


@pytest.mark.parametrize("kind", ["ties", "equal", "big", "restart",
                                  "spent"])
@pytest.mark.parametrize("k", [65, 96, 130])
def test_wide_merge_over_looked_up_rows_equals_the_stable_sort(k, kind):
    """The wide forward merges a column over its looked-up rows alone: a
    row not looked up adds BIG to every value of its row (its block entry
    is BIG), so its values sort after every value below BIG. The picks
    below BIG, their states and ties, and the first pass's best head and
    row (on 1, 2, 8 and 32 lanes), equal the stable sort over all K rows
    with BIG for the rows left out; past them (BIG, -1)."""
    rng = np.random.default_rng(k * 13 + len(kind))
    for trial in range(4):
        looked = rng.random(k) < (0.5 if trial % 2 else 0.15)
        looked[rng.integers(0, k)] = True
        for r in (1, 2, k):
            if kind == "spent":
                score = np.full((k, r), BIG, F32)
                score[:3] = np.sort(rng.integers(0, 3, (3, r)), axis=1)
            else:
                score = _rows(rng, k, r, kind)
            col = rng.integers(0, 3, k).astype(F32)
            col[rng.random(k) < 0.2] = F32(BIG)
            full = np.where(looked, col, F32(BIG)).astype(F32)
            want_v, want_i = _stable(score, full, r)
            low = want_v < BIG
            vals, idx = wide_tree_merge(score, col, looked, r)
            np.testing.assert_array_equal(vals[low], want_v[low])
            np.testing.assert_array_equal(idx[low], want_i[low])
            assert (vals[~low] == F32(BIG)).all() and (idx[~low] == -1).all()
            for lanes in (1, 2, 8, 32):
                best, arg = wide_first_pass(score, col, looked, lanes)
                if want_v[0] < BIG:
                    assert (best, arg * r) == (want_v[0], want_i[0])
                else:
                    assert not best < BIG


def _search(row: np.ndarray, key: int) -> int:
    """The kernels' binary search of an ascending reach row (-1 padding
    read as unsigned past every id): halving steps from the largest power
    of two <= M; the index of key, or -1."""
    M = len(row)
    top = 1 << (M.bit_length() - 1)
    pos, hit, step = -1, -1, top
    u = row.astype(np.int64) & 0xffffffff
    while step:
        at = pos + step
        if at < M:
            if u[at] < key:
                pos = at
            elif u[at] == key:
                hit = at
        step >>= 1
    return hit


def _transition(e1, len1, o1, e2, o2, gap, gc, beta, factor, slack):
    """route.cuh's transition_cost in f32, an operation at a time."""
    limit = F32(F32(factor * gc) + F32(10.0))
    cross = F32(F32(F32(len1 - o1) + gap) + o2)
    same = e1 == e2 and o2 >= F32(o1 - slack)
    direct = max(F32(o2 - o1), F32(0.0))
    route = min(direct, cross) if same else cross
    if route < BIG and route <= limit:
        return F32(abs(F32(route - gc)) / beta)
    return F32(BIG)


def forward_model(cands, pts, keep, tables, consts, R, chunk):
    """The forward kernel in numpy, chunk by chunk of ``chunk`` steps as
    its producer warps fill them: row 0 the carry (the last active
    point's candidates before the chunk), the control sequence (active,
    gc from the previous active point, prev_any, the step's looked-up
    pairs), each looked-up pair's transition by binary search of its
    reach row (the rest BIG); then the merge warps' steps: a column's
    first argmin at R = 1, its loser tree at R > 1, the broken rule from
    the columns' first picks, the carry and the level, each level's own
    state from the first minimal row head. → (scores, backptrs, started,
    own, active), as _forward_list_plain and _lattice_prep's active."""
    sigma_z, beta, factor, breakage, slack = consts
    beta, factor, breakage, slack = (F32(x) for x in (beta, factor,
                                                      breakage, slack))
    denom = F32(2.0 * sigma_z ** 2)
    ce, co, cd, cv = (np.asarray(x) for x in cands)
    T, K = ce.shape
    to, dist = np.asarray(tables["reach_to"]), np.asarray(tables["reach_dist"])
    row_of = np.asarray(tables["reach_row"])
    elen = np.asarray(tables["edge_len"])
    dv = np.where(cv, cd, F32(0.0)).astype(F32)
    em = np.where(cv, (dv * dv).astype(F32) / denom, F32(BIG)).astype(F32)
    cur = np.full((K, R), BIG, F32)
    scores = np.zeros((T, K * R), F32)
    backptrs = np.zeros((T, K * R), np.int32)
    started = np.zeros(T, bool)
    own = np.zeros(T, np.int32)
    active = np.zeros(T, bool)
    carry = -1                    # the last active step (its candidates)
    px, py = F32(pts[0, 0]), F32(pts[0, 1])
    prev_any = False
    own_cur = -1
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)
        # the control sequence, then the chunk's looked-up pairs' blocks
        trans = np.full((n, K, K), BIG, F32)
        flags = []
        for s in range(n):
            t = t0 + s
            act = bool(keep[t]) and bool(cv[t].any())
            gx, gy = F32(F32(pts[t, 0]) - px), F32(F32(pts[t, 1]) - py)
            gc = np.sqrt(F32(F32(gx * gx) + F32(gy * gy)))
            look = act and prev_any and gc <= breakage
            if look:
                for i in range(K):
                    if not (cv[carry, i] and ce[carry, i] >= 0):
                        continue
                    e1 = int(ce[carry, i])
                    r1 = int(row_of[e1])
                    for j in range(K):
                        if not (cv[t, j] and ce[t, j] >= 0):
                            continue
                        hit = _search(to[r1], int(ce[t, j]))
                        gap = min(F32(BIG), F32(dist[r1, hit])) \
                            if hit >= 0 else F32(BIG)
                        trans[s, i, j] = _transition(
                            e1, F32(elen[e1]), F32(co[carry, i]),
                            int(ce[t, j]), F32(co[t, j]), gap, gc, beta,
                            factor, slack)
            flags.append((act, look))
            active[t] = act
            if act:
                px, py = F32(pts[t, 0]), F32(pts[t, 1])
                prev_any, carry = True, t
        for s in range(n):
            t = t0 + s
            act, look = flags[s]
            if not act:
                scores[t] = cur.reshape(-1)
                backptrs[t] = np.arange(K * R)
                started[t], own[t] = False, own_cur
                continue
            nxt = np.full((K, R), BIG, F32)
            bp = np.full((K, R), -1, np.int32)
            picks = []
            for c in range(K):
                col = trans[s, :, c]
                if R == 1:
                    via = (cur[:, 0] + col).astype(F32)
                    arg = int(np.argmin(via))
                    picks.append((np.array([via[arg]], F32),
                                  np.array([arg])))
                else:
                    picks.append(tree_merge(cur, col, R))
            broken = not look or not any(v[0] < BIG for v, _ in picks)
            for c, (v, i) in enumerate(picks):
                if broken:
                    nxt[c, 0] = em[t, c]
                    continue
                for r in range(R):
                    if v[r] < BIG:
                        nxt[c, r] = F32(v[r] + em[t, c])
                        bp[c, r] = i[r]
            cur = nxt
            scores[t], backptrs[t] = cur.reshape(-1), bp.reshape(-1)
            heads = cur[:, 0]
            arg = int(np.argmin(heads))
            own_cur = arg * R if heads[arg] < BIG else -1
            started[t], own[t] = broken, own_cur
    return scores, backptrs, started, own, active


def backtrack_model(backptrs, started, active, own, seed, levels=64,
                    stages=4):
    """The backtrack kernel: a producer fills blocks of ``levels`` levels
    (tail first) into a ring of ``stages`` slots, a slot only once the
    walkers have freed it; the walkers read each level's flags and the
    row above from the slots (a block's started / active bytes copied from
    its 16-aligned span, as the bulk copies do), re-seed at a chain
    terminal, and free a block once the level below it is done. A slot
    overwritten while still in use is an error. → states [P, T]."""
    T, S = backptrs.shape
    G, NS = levels, stages
    J = -(-T // G)
    slots = [None] * NS            # (block, bp rows, own, started, active)
    free = [True] * NS
    issued = 0

    def fill(upto):
        nonlocal issued
        while issued < min(upto, J):
            slot = issued % NS
            if not free[slot]:
                return
            j = J - 1 - issued
            lo, hi = j * G, min(T, j * G + G)
            lo8, hi8 = lo & ~15, -(-hi // 16) * 16
            span = np.zeros(G + 32, bool), np.zeros(G + 32, bool)
            if hi8 <= T:                  # the bulk copy's aligned span
                span[0][:hi8 - lo8] = started[lo8:hi8]
                span[1][:hi8 - lo8] = active[lo8:hi8]
            else:                         # the loads of the block alone
                span[0][lo - lo8:hi - lo8] = started[lo:hi]
                span[1][lo - lo8:hi - lo8] = active[lo:hi]
            slots[slot] = (j, backptrs[lo:hi].copy(), own[lo:hi].copy(),
                           *span)
            free[slot] = False
            issued += 1

    out = np.zeros((len(seed), T), np.int32)
    nxt = np.array(seed, np.int64)
    nst = np.zeros(len(seed), bool)
    seq = 0
    fill(NS)
    for t in range(T - 1, -1, -1):
        if t < (J - 1 - seq) * G:
            seq += 1
            fill(seq + NS)
        j, bp, ow, st, ac = slots[seq % NS]
        assert j == t // G, "a slot was overwritten while in use"
        lo, lo8 = j * G, (j * G) & ~15
        if t + 1 < T:
            up = seq if (t + 1) // G == j else seq - 1
            uj, ubp = slots[up % NS][:2]
            assert uj == (t + 1) // G, "a slot was overwritten while in use"
            row = ubp[t + 1 - uj * G]
        for q in range(len(seed)):
            prop = -1
            if 0 <= nxt[q] < S:
                prop = nxt[q] if t == T - 1 else int(row[nxt[q]])
            choice = int(ow[t - lo]) if (nst[q] or nxt[q] < 0) else prop
            out[q, t] = choice if ac[t - lo8] else -1
            nxt[q], nst[q] = choice, bool(st[t - lo8])
        if t == lo + G - 1 and t + 1 < T:
            free[(seq - 1) % NS] = True  # the block above is done
            fill(seq + NS)
    return out


@pytest.mark.parametrize("kind", ["drive", "break", "one", "gaps"])
@pytest.mark.parametrize("k,r", [(1, 1), (2, 2), (8, 1), (8, 2), (8, 8),
                                 (16, 1), (16, 16)])
def test_kernel_models_equal_the_plain_versions(tile, k, r, kind):
    """The forward kernel's numpy model (chunks of the plan's C and of 5
    steps: T not a multiple of 5, a chain break at 20, inactive points on
    chunks' first rows) against _lattice_prep + _forward_list_plain, and
    the ring-fed backtrack's model against _backtrack_plain (the plan's
    ring and one of two slots of four levels), on the port's own lattice
    inputs: every output equal (tolerance 0), the rows of every level
    ascending (the merge's precondition)."""
    from reporter_tpu_torch.tiles.reach import check_rows_ascending

    jts, jm, tab = tile
    xy, valid = _trace(jts, kind)
    _, (pc, pp, pv, ptab) = _lattice(jm, tab, xy, valid, k)
    check_rows_ascending(ptab["reach_to"].numpy())
    p = jm.params
    consts = (p.sigma_z, p.beta, p.max_route_distance_factor, BREAKAGE,
              p.backward_slack)
    keep = hmm.interpolation_keep_mask(pp, pv, 10.0)
    em, active, prev_any, trans = hmm._lattice_prep(pc, pp, keep, ptab,
                                                    *consts)
    want = hmm._forward_list_plain(em, active, prev_any, trans, r)
    T = len(em)
    for chunk in sorted({hmm.lattice_plan(T, k, r)["chunk"], 5}):
        got = forward_model(pc, pp.numpy(), keep.numpy(), ptab, consts, r,
                            chunk)
        for g, w in zip(got, (*want, active)):
            np.testing.assert_array_equal(g, w.numpy())
    rows = want[0].numpy().reshape(T, k, r)
    assert (np.diff(rows, axis=2) >= 0).all()
    seed = torch.sort(want[0][-1], stable=True).indices[:max(r, k)]
    seed = torch.cat([seed, torch.tensor([-1])]).to(torch.int32)
    states = hmm._backtrack_plain(want[1], want[2], active, want[3], seed)
    plan = hmm.backtrack_plan(T, k * r, len(seed))
    for levels, stages in ((plan["levels"], plan["stages"]), (4, 2)):
        np.testing.assert_array_equal(
            backtrack_model(want[1].numpy(), want[2].numpy(),
                            active.numpy(), want[3].numpy(), seed.numpy(),
                            levels, stages), states.numpy())
    assert states.dtype == torch.int32 and states.shape == (len(seed), T)


# ---- the keep mask's chain -------------------------------------------------


def keep_model(pts: np.ndarray, vp: np.ndarray, interp: float,
               tile: int = 2048) -> np.ndarray:
    """lattice.cu's keep-mask kernel for one trace in numpy f32 (pts [T,
    2], vp [T]): tiles of ``tile`` points; the tile's first kept point,
    the first valid one at d² >= f32(interp)² from the carried last kept
    point (any valid one before a point was kept); next[i], the first
    valid j > i in the tile at d² >= d2_min from i, searched in windows
    of 32 as a warp's ballot takes it; the chain from the first kept
    point marked by pointer doubling (a marked u marks jump[u], then jump
    = jump o jump), every round on the round's start. → bool [T]."""
    d2_min = F32(F32(interp) * F32(interp))
    T = len(pts)
    out = np.zeros(T, bool)
    any_kept, last = False, None
    for t0 in range(0, T, tile):
        x, y = pts[t0:t0 + tile, 0], pts[t0:t0 + tile, 1]
        v = vp[t0:t0 + tile]
        n = len(x)

        if any_kept:
            dx, dy = (x - last[0]).astype(F32), (y - last[1]).astype(F32)
            far = (dx * dx + dy * dy).astype(F32) >= d2_min
            cand = v & far
        else:
            cand = v.copy()
        first = int(np.flatnonzero(cand)[0]) if cand.any() else n
        nxt = np.full(n, n, np.int64)
        for i in np.flatnonzero(v):
            for j0 in range(i + 1, n, 32):
                j = np.arange(j0, min(j0 + 32, n))
                dx, dy = (x[j] - x[i]).astype(F32), (y[j] - y[i]).astype(F32)
                ok = v[j] & ((dx * dx + dy * dy).astype(F32) >= d2_min)
                if ok.any():
                    nxt[i] = int(j[np.argmax(ok)])
                    break
        mark = np.zeros(n, bool)
        if first < n:
            mark[first] = True
        jump, span = nxt.copy(), 1
        while span < n:
            step = mark.copy()
            src = np.flatnonzero(mark & (jump < n))
            step[jump[src]] = True
            jump = np.where(jump < n, jump[np.minimum(jump, n - 1)], n)
            mark, span = step, span * 2
        out[t0:t0 + n] = mark
        if mark.any():
            i = int(np.flatnonzero(mark)[-1])
            last, any_kept = (x[i], y[i]), True
    return out


def _keep_traces(seed: int, t: int):
    """Seeded traces: a moving one (some steps under the distance), one
    standing still (jitter under half the distance), one standing then
    driving, sparse validity, and points on a 10 m grid (d² exactly at
    f32(10)² between neighbours)."""
    rng = np.random.default_rng(seed)
    moving = np.cumsum(rng.uniform(-9.0, 9.0, (t, 2)), axis=0)
    still = rng.uniform(-2.4, 2.4, (t, 2))
    both = np.concatenate([still[:t // 2],
                           still[t // 2 - 1] + np.cumsum(
                               rng.uniform(4.0, 12.0, (t - t // 2, 2)), 0)])
    grid = np.stack([10.0 * rng.integers(0, 4, t),
                     10.0 * rng.integers(0, 4, t)], 1)
    for xy in (moving, still, both, grid):
        yield (xy + 5000.0).astype(F32), rng.random(t) > 0.1
    yield (moving + 5000.0).astype(F32), rng.random(t) > 0.8


@pytest.mark.parametrize("tile", [16, 2048])
@pytest.mark.parametrize("t", [1, 7, 40, 333])
def test_keep_chain_model_equals_the_plain_mask(t, tile):
    """The keep kernel's chain of next kept points (the proof is in
    kernels/lattice.cu) equals the plain scan, across tiles (16 points)
    and within one (2048), interpolation at 10 m and 0.5 m."""
    for seed in range(3):
        for xy, vp in _keep_traces(seed + 10 * t, t):
            for interp in (10.0, 0.5):
                want = hmm._keep_mask_batched(
                    torch.from_numpy(xy)[:, :, None],
                    torch.from_numpy(vp)[:, None], interp)[:, 0].numpy()
                got = keep_model(xy, vp, interp, tile)
                np.testing.assert_array_equal(got, want)


# ---- the plan and the wrappers' refusals ----------------------------------


@pytest.mark.parametrize("t", _BUCKETS)
def test_lattice_plan_fits_shared_memory(t):
    """Every bucket length, K up to 64, R in {1, 2, K}: the forward's CTA
    of whole warps (a merge thread a column, 4 or 8 producer warps, at
    most 384 threads) whose shared memory fits the card's 227 KB, is the
    layout's at its chunk and does not grow with T; the backtrack's ring
    for the K * R states and the paths match_topk asks (K at R = 1, R
    else) fits too."""
    for k in range(1, hmm.LATTICE_MAX_K + 1):
        for r in sorted({1, 2, k} & set(range(1, k + 1))):
            plan = hmm.lattice_plan(t, k, r)
            assert plan["threads"] == 32 * (plan["merge_warps"]
                                            + plan["producer_warps"])
            assert k <= 32 * plan["merge_warps"] < k + 32
            assert plan["threads"] <= 384 and plan["chunk"] >= 1
            assert plan["smem_bytes"] <= hmm.VITERBI_SMEM_MAX
            assert plan == hmm.lattice_plan(1, k, r)
            assert plan["smem_bytes"] == hmm.lattice_smem_bytes(
                k, r, plan["chunk"])
            paths = k if r == 1 else r
            bt = hmm.backtrack_plan(t, k * r, paths)
            assert bt["smem_bytes"] <= hmm.VITERBI_SMEM_MAX
            assert bt["levels"] % 4 == 0 and bt["stages"] >= 2
            assert bt == hmm.backtrack_plan(1, k * r, paths)
            assert bt["smem_bytes"] == hmm.backtrack_smem_bytes(
                k * r, paths, bt["levels"], bt["stages"])
    assert hmm.lattice_plan(t, 64, 64) == {
        "chunk": 4, "producer_warps": 8, "merge_warps": 2, "threads": 320,
        "smem_bytes": 228256, "place": 0, "tree_bytes": 0,
        "scratch_bytes": 0}


def _wide_plan_holds(t, k, r):
    """The wide forward's plan at (T, K, R): 8 producer and 8 merge warps,
    shared bytes within the card's 227 KB and the layout's at its chunk
    and placement, the same at every T; at R = 1 the blocks in the global
    scratch at the shared instances' chunk formula; at R > 1 a trees'
    region of at least one column's tree at K leaves (in shared memory or
    the scratch), at most every column's, and the level's backpointers in
    shared memory only beside the carried rows; the rest in a scratch of
    lattice_scratch_bytes."""
    plan = hmm.lattice_plan(t, k, r)
    assert plan == hmm.lattice_plan(1, k, r)
    assert (plan["producer_warps"], plan["merge_warps"], plan["threads"]) \
        == (8, 8, 512)
    formula = max(1, 32768 // (k * k))
    assert 1 <= plan["chunk"] <= formula
    place, tree = plan["place"], plan["tree_bytes"]
    assert plan["smem_bytes"] == hmm.lattice_smem_bytes(
        k, r, plan["chunk"], place, tree) <= hmm.VITERBI_SMEM_MAX
    assert plan["scratch_bytes"] == hmm.lattice_scratch_bytes(
        k, r, plan["chunk"], place, tree)
    tree_min = 8 * (1 << (k - 1).bit_length())
    if place & hmm.LATTICE_PLACE_LEVEL:
        assert r > 1 and place & hmm.LATTICE_PLACE_ROWS
    if r == 1:
        assert not place & (hmm.LATTICE_PLACE_BLOCKS | hmm.LATTICE_PLACE_TREES
                            | hmm.LATTICE_PLACE_LEVEL) and tree == 0
        assert plan["chunk"] == formula or not hmm.lattice_smem_bytes(
            k, r, plan["chunk"] + 1) <= hmm.VITERBI_SMEM_MAX
    else:
        assert tree_min <= tree <= tree_min * min(k, 256) + 15
        assert tree % 16 == 0
    if place == (hmm.LATTICE_PLACE_BLOCKS | hmm.LATTICE_PLACE_ROWS
                 | hmm.LATTICE_PLACE_BEST | hmm.LATTICE_PLACE_TREES
                 | hmm.LATTICE_PLACE_LEVEL):
        assert plan["scratch_bytes"] == 0
    else:
        assert plan["scratch_bytes"] > 0
    return plan


@pytest.mark.parametrize("t,k,r", [(120, 0, 1), (120, 65, 1), (120, 8, 0),
                                   (120, 8, 9), (0, 8, 1),
                                   (120, PAST_SMEM_K, 1),
                                   (1, PAST_SMEM_K - 1, PAST_SMEM_K - 1),
                                   (1024, 96, 96),
                                   (1024, 128, 128), (120, 256, 1),
                                   (120, 300, 300)])
def test_lattice_plan_refuses(t, k, r):
    """The plan refuses K < 1, R outside 1..K, T < 1 and a K whose
    candidate rows outgrow a CTA's shared memory (from PAST_SMEM_K); a K
    past 64 below it (65, 96, 128, 256, 300 and the last that fits, each
    at R = 1 or R = K) is the wide instance's plan
    (``_wide_plan_holds``)."""
    if 1 <= k < PAST_SMEM_K and 1 <= r <= k and t >= 1:
        assert k > hmm.LATTICE_MAX_K
        _wide_plan_holds(t, k, r)
        return
    with pytest.raises(ValueError, match="lattice kernels take"
                       if k < PAST_SMEM_K else f"K={k} .*shared memory"):
        hmm.lattice_plan(t, k, r)


@pytest.mark.parametrize("k", [65, 96, 128, 256, 300])
def test_lattice_plan_takes_the_wide_widths(k):
    """Past K = 64, at R = 1, 2 and K and every bucket length: the wide
    instance's plan, and the backtrack's for the paths match_topk asks
    (a ring for the K-state levels of R = 1; levels of K * K states read
    in place past some 7,000 states)."""
    for t in _BUCKETS:
        for r in (1, 2, k):
            _wide_plan_holds(t, k, r)
            paths = k if r == 1 else r
            bt = hmm.backtrack_plan(t, k * r, paths)
            assert bt == hmm.backtrack_plan(1, k * r, paths)
            walkers = bt["threads"] // 32 - 1
            if r == 1:
                assert bt["instance"] == "ring"
            if bt["instance"] == "ring":
                assert 1 <= walkers <= hmm.LATTICE_MAX_WALKERS
                assert bt["ctas"] * 32 * walkers >= paths
                assert bt["smem_bytes"] == hmm.backtrack_smem_bytes(
                    k * r, 32 * walkers, bt["levels"], bt["stages"]) \
                    <= hmm.VITERBI_SMEM_MAX
            else:
                assert k * r > 7000 and bt["smem_bytes"] == 0
                assert bt["ctas"] * bt["threads"] >= paths
    # at K = R = 96 every array in shared memory (blocks, rows, first
    # pass, level, trees); at K = R = 128 the rows in the scratch, so the
    # level is written straight out; past 200 the blocks too
    every = (hmm.LATTICE_PLACE_BLOCKS | hmm.LATTICE_PLACE_ROWS
             | hmm.LATTICE_PLACE_BEST | hmm.LATTICE_PLACE_TREES
             | hmm.LATTICE_PLACE_LEVEL)
    assert hmm.lattice_plan(1024, 96, 96)["place"] == every
    assert hmm.lattice_plan(1024, 128, 128)["place"] == \
        every & ~hmm.LATTICE_PLACE_ROWS & ~hmm.LATTICE_PLACE_LEVEL
    assert hmm.lattice_plan(1024, 256, 256)["place"] == \
        hmm.LATTICE_PLACE_BEST | hmm.LATTICE_PLACE_TREES


@pytest.mark.parametrize("k,r,chunk,place,tree", [
    (65, 1, 7, 10, 0), (65, 65, 3, 31, 66560), (96, 1, 3, 10, 0),
    (96, 2, 1, 31, 98304), (96, 96, 1, 31, 36896), (128, 1, 2, 10, 0),
    (128, 128, 1, 13, 88096), (255, 2, 1, 30, 197088),
    (256, 256, 1, 12, 206304), (PAST_SMEM_K - 1, 1, 1, 0, 0)])
def test_lattice_wide_layout_at_each_width(k, r, chunk, place, tree):
    """The wide forward's chunk, placement and trees' region where the
    served and boundary widths land: at K = R = 96 every array in shared
    memory, the level's backpointers too, the trees' region of 36,896
    bytes (every column's tree at up to 64 leaves, 36 at 128); at K = 255,
    R = 2 the blocks in the scratch, the rows and the level in shared
    memory; at R = 1 the blocks in the scratch; at the last K that fits,
    nothing but the chunk's rows in shared memory."""
    plan = hmm.lattice_plan(1024, k, r)
    assert (plan["chunk"], plan["place"], plan["tree_bytes"]) == \
        (chunk, place, tree)
    assert (plan["scratch_bytes"] > 0) == (place != 31)
    if k == PAST_SMEM_K - 1:
        assert plan["smem_bytes"] == hmm.VITERBI_SMEM_MAX
        with pytest.raises(ValueError, match=f"K={k + 1} .*shared memory"):
            hmm.lattice_plan(1024, k + 1, r)


@pytest.mark.parametrize("t,s,p", [(120, 8, 0), (120, 8, 65), (120, 8, 257),
                                   (0, 8, 8), (120, 60000, 8),
                                   (120, 96, 96), (120, 128, 128),
                                   (120, 8, 2000), (120, 9216, 96),
                                   (120, 16384, 300)])
def test_backtrack_plan_refuses(t, s, p):
    """No paths or no levels are refused; P = 65, 96, 128, 257, 300 or
    2000 paths are the ring over CTAs of up to 31 walker warps (fewer
    where the ring would not fit beside their staging); levels too wide
    for two slots of four levels (60,000, 9,216 or 16,384 states) are
    read in place."""
    if p < 1 or t < 1:
        with pytest.raises(ValueError, match="kernel"):
            hmm.backtrack_plan(t, s, p)
        return
    bt = hmm.backtrack_plan(t, s, p)
    ring = hmm.backtrack_smem_bytes(s, 32, 4, 2) <= hmm.VITERBI_SMEM_MAX
    assert bt["instance"] == ("ring" if ring else "global")
    if ring:
        walkers = bt["threads"] // 32 - 1
        assert bt["ctas"] == -(-p // (32 * walkers))
        assert bt["threads"] == 32 + 32 * min(-(-p // 32), 31) or \
            bt["smem_bytes"] > 0
    else:
        assert bt["threads"] == min(1024, 32 * -(-p // 32))
        assert bt["ctas"] == -(-p // bt["threads"])


def _fwd_inputs(T=6, K=4, device="cpu"):
    """A lattice's inputs as the forward wrapper takes them: candidates
    [T, K], points [T, 2], the keep mask [T], reach tables and the
    matcher's constants."""
    cands = CandidateSet(
        torch.zeros((T, K), dtype=torch.int32, device=device),
        torch.zeros((T, K), dtype=torch.float32, device=device),
        torch.zeros((T, K), dtype=torch.float32, device=device),
        torch.ones((T, K), dtype=torch.bool, device=device))
    tables = {"edge_len": torch.ones(3, device=device),
              "reach_row": torch.zeros(3, dtype=torch.int32, device=device),
              "reach_to": torch.full((1, 4), -1, dtype=torch.int32,
                                     device=device),
              "reach_dist": torch.zeros((1, 4), device=device)}
    return (cands, torch.zeros((T, 2), device=device),
            torch.ones(T, dtype=torch.bool, device=device), tables,
            4.07, 3.0, 5.0, 300.0, 10.0)


def test_the_forward_wrapper_refuses_bad_k_and_r():
    """K past the shared memory's ceiling or R past K is refused before
    anything is built."""
    k = PAST_SMEM_K
    with pytest.raises(ValueError, match=f"K={k} .*shared memory"):
        hmm._forward_list_cuda(*_fwd_inputs(T=2, K=k), 1)
    with pytest.raises(ValueError, match="1 <= R <= K"):
        hmm._forward_list_cuda(*_fwd_inputs(K=4), 5)


def _outputs(T, K, R):
    return (torch.empty((T, K * R)), torch.empty((T, K * R),
                                                 dtype=torch.int32),
            torch.empty(T, dtype=torch.bool),
            torch.empty(T, dtype=torch.int32),
            torch.empty(T, dtype=torch.bool))


def test_the_lattice_launchers_refuse_dtype_shape_and_device():
    """Each launcher checks its tensors before it builds: a wrong dtype,
    a wrong shape, then (all else right) tensors off the card."""
    cands, pts, keep, tab, *consts = _fwd_inputs()
    plan = hmm.lattice_plan(6, 4, 2)
    out = _outputs(6, 4, 2)
    tabs = [tab[k] for k in ("edge_len", "reach_row", "reach_to",
                             "reach_dist")]

    def fwd(c, k=keep, R=2, o=out):
        build.launch_lattice_forward(*c, pts, k, *tabs, R, plan, *consts,
                                     None, *o)

    with pytest.raises(ValueError, match="expected dist as"):
        fwd(cands._replace(dist=cands.dist.double()))
    with pytest.raises(ValueError, match="expected offset as"):
        fwd(cands._replace(offset=cands.offset[:, :3]))
    with pytest.raises(ValueError, match="expected keep as"):
        fwd(cands, k=keep[:5])
    with pytest.raises(ValueError, match="expected scores as"):
        fwd(cands, R=3)
    with pytest.raises(ValueError, match="on the card"):
        fwd(cands)
    _, bp, st, own, act = out
    seed = torch.zeros(3, dtype=torch.int32)
    states = torch.empty((3, 6), dtype=torch.int32)
    bt_plan = hmm.backtrack_plan(6, 8, 3)
    with pytest.raises(ValueError, match="expected seed as"):
        build.launch_lattice_backtrack(bp, st, act, own, seed.long(),
                                       bt_plan, states)
    with pytest.raises(ValueError, match="expected out as"):
        build.launch_lattice_backtrack(bp, st, act, own, seed, bt_plan,
                                       states[:, :5])
    with pytest.raises(ValueError, match="on the card"):
        build.launch_lattice_backtrack(bp, st, act, own, seed, bt_plan,
                                       states)
    pts3 = torch.zeros((1, 6, 2))
    keep3 = torch.empty((1, 6), dtype=torch.bool)
    with pytest.raises(ValueError, match="expected valid_pt as"):
        build.launch_lattice_keep(pts3, act[None].int(), 10.0, keep3)
    with pytest.raises(ValueError, match="on the card"):
        build.launch_lattice_keep(pts3, act[None], 10.0, keep3)


def test_the_dispatch_refuses_other_devices():
    """A tensor that lies neither on a card nor on the CPU raises, as the
    batched decode's dispatch does."""
    args = _fwd_inputs(device="meta")
    act = args[2]
    with pytest.raises(ValueError, match="unsupported device"):
        hmm._forward_list(*args, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        hmm._backtrack(torch.empty((6, 4), dtype=torch.int32, device="meta"),
                       act, act, act.int(), act[:2].int())
    with pytest.raises(ValueError, match="unsupported device"):
        hmm.interpolation_keep_mask(torch.empty((6, 2), device="meta"), act,
                                    10.0)


def test_the_cpu_path_counts_no_launch(tile):
    """The plain versions run on the CPU and add nothing to
    LATTICE_LAUNCHES."""
    jts, jm, tab = tile
    xy, valid = _trace(jts, "drive")
    _, (pc, pp, pv, ptab) = _lattice(jm, tab, xy, valid, 8)
    before = dict(hmm.LATTICE_LAUNCHES)
    hmm.viterbi_kbest_paths(pc, pp, pv, ptab, *_args(jm, 10.0), num_paths=8)
    assert hmm.LATTICE_LAUNCHES == before
