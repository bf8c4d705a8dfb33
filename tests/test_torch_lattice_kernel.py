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
  tolerance 0: the forward kernel's K-way merge against a stable sort on
  tie-heavy rows, the whole forward kernel (merge, broken rule, each
  level's own argmin from the row heads) against ``_forward_list_plain``
  and the backtrack kernel against ``_backtrack_plain`` on real lattices.
- ``lattice_plan`` at every bucket length and K up to 64; the wrappers'
  refusals (K, R, dtype, shape, device), none of which needs nvcc.

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
    or one point."""
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


def forward_model(em, active, prev_any, trans, R):
    """The forward kernel step by step in numpy: the merge per column,
    the broken rule from the columns' first picks, the carry and level
    writes, each level's own state from the first minimal row head.
    → (scores, backptrs, started, own), as _forward_list_plain."""
    T, K = em.shape
    cur = np.full((K, R), BIG, F32)
    scores = np.zeros((T, K * R), F32)
    backptrs = np.zeros((T, K * R), np.int32)
    started = np.zeros(T, bool)
    own = np.zeros(T, np.int32)
    for t in range(T):
        nxt = cur.copy()
        bp = np.arange(K * R, dtype=np.int32).reshape(K, R)
        if active[t]:
            picks = [merge_select(cur, trans[t, :, c], R) for c in range(K)]
            broken = not any(v[0] < BIG for v, _ in picks) or not prev_any[t]
            for c, (v, i) in enumerate(picks):
                for r in range(R):
                    if broken:
                        nxt[c, r] = em[t, c] if r == 0 else BIG
                        bp[c, r] = -1
                    elif v[r] < BIG:
                        nxt[c, r] = F32(v[r] + em[t, c])
                        bp[c, r] = i[r]
                    else:
                        nxt[c, r] = BIG
                        bp[c, r] = -1
            started[t] = broken
        cur = nxt
        scores[t], backptrs[t] = cur.reshape(-1), bp.reshape(-1)
        heads = cur[:, 0]
        arg = int(np.argmin(heads))
        own[t] = arg * R if heads[arg] < BIG else -1
    return scores, backptrs, started, own


def backtrack_model(backptrs, started, active, own, seed):
    """The backtrack kernel: a path at a time, T levels down."""
    T, S = backptrs.shape
    out = np.zeros((len(seed), T), np.int32)
    for q, s in enumerate(seed):
        nxt, nst = int(s), False
        for t in range(T - 1, -1, -1):
            prop = -1
            if 0 <= nxt < S:
                prop = nxt if t == T - 1 else int(backptrs[t + 1, nxt])
            choice = int(own[t]) if (nst or nxt < 0) else prop
            out[q, t] = choice if active[t] else -1
            nxt, nst = choice, bool(started[t])
    return out


@pytest.mark.parametrize("kind", ["drive", "break", "one"])
@pytest.mark.parametrize("k,r", [(1, 1), (2, 2), (8, 1), (8, 2), (8, 8),
                                 (16, 1), (16, 16)])
def test_kernel_models_equal_the_plain_versions(tile, k, r, kind):
    """The forward and backtrack kernels' numpy models against the plain
    versions on the port's own lattice inputs: every output equal
    (tolerance 0), the rows of every level ascending (the merge's
    precondition)."""
    jts, jm, tab = tile
    xy, valid = _trace(jts, kind)
    _, (pc, pp, pv, ptab) = _lattice(jm, tab, xy, valid, k)
    p = jm.params
    keep = hmm.interpolation_keep_mask(pp, pv, 10.0)
    em, active, prev_any, trans = hmm._lattice_prep(
        pc, pp, keep, ptab, p.sigma_z, p.beta, p.max_route_distance_factor,
        BREAKAGE, p.backward_slack)
    want = hmm._forward_list_plain(em, active, prev_any, trans, r)
    got = forward_model(em.numpy(), active.numpy(), prev_any.numpy(),
                        trans.numpy(), r)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    rows = want[0].numpy().reshape(len(em), k, r)
    assert (np.diff(rows, axis=2) >= 0).all()
    seed = torch.sort(want[0][-1], stable=True).indices[:max(r, k)]
    seed = torch.cat([seed, torch.tensor([-1])]).to(torch.int32)
    states = hmm._backtrack_plain(want[1], want[2], active, want[3], seed)
    np.testing.assert_array_equal(
        backtrack_model(want[1].numpy(), want[2].numpy(), active.numpy(),
                        want[3].numpy(), seed.numpy()), states.numpy())
    assert states.dtype == torch.int32 and states.shape == (len(seed),
                                                            len(em))


# ---- the plan and the wrappers' refusals ----------------------------------


@pytest.mark.parametrize("t", _BUCKETS)
def test_lattice_plan_fits_shared_memory(t):
    """Every bucket length, K up to 64, R in {1, 2, K}: one CTA of a
    whole number of warps (at least K threads, at most 256) whose shared
    memory fits the card's 227 KB and does not grow with T."""
    for k in range(1, hmm.LATTICE_MAX_K + 1):
        for r in sorted({1, 2, k} & set(range(1, k + 1))):
            plan = hmm.lattice_plan(t, k, r)
            assert plan["threads"] % 32 == 0
            assert k <= plan["threads"] <= 256
            assert plan["smem_bytes"] <= hmm.VITERBI_SMEM_MAX
            assert plan["smem_bytes"] == hmm.lattice_plan(1, k, r)[
                "smem_bytes"] == hmm.lattice_smem_bytes(k, r)
    assert hmm.lattice_plan(t, 64, 64) == {"threads": 256,
                                           "smem_bytes": 119824}


@pytest.mark.parametrize("t,k,r", [(120, 0, 1), (120, 65, 1), (120, 8, 0),
                                   (120, 8, 9), (0, 8, 1)])
def test_lattice_plan_refuses(t, k, r):
    with pytest.raises(ValueError, match="lattice kernels take"):
        hmm.lattice_plan(t, k, r)


def _fwd_inputs(T=6, K=4, device="cpu"):
    return (torch.zeros((T, K), dtype=torch.float32, device=device),
            torch.ones(T, dtype=torch.bool, device=device),
            torch.ones(T, dtype=torch.bool, device=device),
            torch.zeros((T, K, K), dtype=torch.float32, device=device))


def test_the_forward_wrapper_refuses_bad_k_and_r():
    """K past 64 or R past K is refused before anything is built."""
    with pytest.raises(ValueError, match="1 <= K <= 64"):
        hmm._forward_list_cuda(*_fwd_inputs(K=65), 1)
    with pytest.raises(ValueError, match="1 <= R <= K"):
        hmm._forward_list_cuda(*_fwd_inputs(K=4), 5)


def _outputs(T, K, R):
    return (torch.empty((T, K * R)), torch.empty((T, K * R),
                                                 dtype=torch.int32),
            torch.empty(T, dtype=torch.bool),
            torch.empty(T, dtype=torch.int32))


def test_the_lattice_launchers_refuse_dtype_shape_and_device():
    """Each launcher checks its tensors before it builds: a wrong dtype,
    a wrong shape, then (all else right) tensors off the card."""
    em, act, pany, trans = _fwd_inputs()
    plan = hmm.lattice_plan(6, 4, 2)
    out = _outputs(6, 4, 2)
    with pytest.raises(ValueError, match="expected em as"):
        build.launch_lattice_forward(em.double(), act, pany, trans, 2, plan,
                                     *out)
    with pytest.raises(ValueError, match="expected trans as"):
        build.launch_lattice_forward(em, act, pany, trans[:, :3], 2, plan,
                                     *out)
    with pytest.raises(ValueError, match="expected scores as"):
        build.launch_lattice_forward(em, act, pany, trans, 3, plan, *out)
    with pytest.raises(ValueError, match="on the card"):
        build.launch_lattice_forward(em, act, pany, trans, 2, plan, *out)
    _, bp, st, own = out
    seed = torch.zeros(3, dtype=torch.int32)
    states = torch.empty((3, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected seed as"):
        build.launch_lattice_backtrack(bp, st, act, own, seed.long(), 128,
                                       states)
    with pytest.raises(ValueError, match="expected out as"):
        build.launch_lattice_backtrack(bp, st, act, own, seed, 128,
                                       states[:, :5])
    with pytest.raises(ValueError, match="on the card"):
        build.launch_lattice_backtrack(bp, st, act, own, seed, 128, states)
    pts = torch.zeros((1, 6, 2))
    keep = torch.empty((1, 6), dtype=torch.bool)
    with pytest.raises(ValueError, match="expected valid_pt as"):
        build.launch_lattice_keep(pts, act[None].int(), 10.0, keep)
    with pytest.raises(ValueError, match="on the card"):
        build.launch_lattice_keep(pts, act[None], 10.0, keep)


def test_the_dispatch_refuses_other_devices():
    """A tensor that lies neither on a card nor on the CPU raises, as the
    batched decode's dispatch does."""
    em, act, pany, trans = _fwd_inputs(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hmm._forward_list(em, act, pany, trans, 1)
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
