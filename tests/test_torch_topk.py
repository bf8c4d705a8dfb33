"""Ranked path interpretations on the port: the single-trace lattice
functions of ops/hmm.py and ``SegmentMatcher.match_topk``, against the JAX
package's (reporter_tpu) on the same candidates, and against the port's
own copy of the exact numpy list-Viterbi oracle of
tests/test_topk_oracle.py.

Tolerances: candidate choices (slots and paths), validity, chain starts,
edges and the allowed-transition pattern are equal (tolerance 0); costs
and scores within ``SCORE_RTOL`` relative, since XLA:CPU may fuse the
multiply-adds the port rounds one by one (ROADMAP queue 3): the largest
measured here is 1.97e-07. Against the oracle the JAX test's rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city as j_generate_city
from reporter_tpu.netgen.traces import synthesize_probe
from reporter_tpu.ops import hmm as jhmm
from reporter_tpu.ops.candidates import CandidateSet as JCandidateSet
from reporter_tpu.ops.match import batch_candidates as j_batch_candidates
from reporter_tpu.tiles.compiler import compile_network as j_compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS as J_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import Config, MatcherParams
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace, _bucket_len
from reporter_tpu_torch.ops import hmm
from reporter_tpu_torch.ops.dense_candidates import BIG, CandidateSet
from reporter_tpu_torch.ops.match import batch_candidates
from reporter_tpu_torch.tiles.tileset import TileSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

SCORE_RTOL = 2e-6
R_ORACLE = 6           # exact top-R the oracle tracks (>= alternates used)
FINITE = BIG / 2       # "allowed" threshold for f32 cost entries
_TABLES = ("edge_len", "reach_row", "reach_to", "reach_dist")


@pytest.fixture(scope="module")
def pair():
    """The oracle test's tile in both packages, a dense matcher each."""
    jts = j_compile_network(j_generate_city("tiny"),
                            JCompilerParams(reach_radius=500.0,
                                            osmlr_max_length=250.0))
    ts = TileSet.from_arrays(jts.name, jts.meta,
                             {f: getattr(jts, f) for f in J_FIELDS})
    jm = JSegmentMatcher(jts, JConfig(matcher=JMatcherParams(
        candidate_backend="dense")))
    return jts, jm, ts, SegmentMatcher(ts, device="cpu")


def _probe(jts, seed, n=14, speed=12.0, sigma=2.0):
    return synthesize_probe(jts, seed=seed, num_points=n, speed_mps=speed,
                            gps_sigma=sigma)


def _padded(xy):
    T = len(xy)
    pts = np.zeros((1, _bucket_len(T), 2), np.float32)
    pts[0, :T] = xy
    valid = np.zeros((1, pts.shape[1]), bool)
    valid[0, :T] = True
    return pts, valid


def _jax_lattice(jm, xy):
    """The JAX matcher's candidates for a padded trace, as numpy."""
    pts, valid = _padded(xy)
    c = j_batch_candidates(jnp.asarray(pts), jnp.asarray(valid), jm._tables,
                           jm.ts.meta, jm.params)
    return [np.asarray(x[0]) for x in c], pts[0], valid[0]


def _args(p, breakage=None):
    return (p.sigma_z, p.beta, p.max_route_distance_factor,
            p.breakage_distance if breakage is None else breakage,
            p.backward_slack, p.interpolation_distance)


def _both(jm, cands, pts, valid):
    """(JAX call inputs, port call inputs) for the same numpy lattice."""
    jin = (JCandidateSet(*(jnp.asarray(x) for x in cands)),
           jnp.asarray(pts), jnp.asarray(valid), jm._tables)
    tab = {k: torch.from_numpy(np.array(jm._tables[k])) for k in _TABLES}
    pin = (CandidateSet(*(torch.from_numpy(np.array(x)) for x in cands)),
           torch.from_numpy(pts), torch.from_numpy(valid), tab)
    return jin, pin


def test_lattice_functions_equal_reference(pair):
    """route_distance / transition_costs / emission_costs /
    interpolation_keep_mask on the same candidates: the same allowed
    pattern, costs within SCORE_RTOL, the same keep mask."""
    jts, jm, _, _ = pair
    p = jm.params
    cands, pts, valid = _jax_lattice(jm, _probe(jts, 5, 30).xy)
    (jc, jp, jv, jtab), (pc, pp, pv, ptab) = _both(jm, cands, pts, valid)
    keep = jhmm.interpolation_keep_mask(jp, jv, p.interpolation_distance)
    np.testing.assert_array_equal(
        hmm.interpolation_keep_mask(pp, pv, p.interpolation_distance).numpy(),
        np.asarray(keep))
    np.testing.assert_allclose(hmm.emission_costs(pc, p.sigma_z).numpy(),
                               np.asarray(jhmm.emission_costs(jc, p.sigma_z)),
                               rtol=SCORE_RTOL)
    act = np.nonzero(np.asarray(keep) & cands[3].any(axis=1))[0]
    assert len(act) >= 10
    for a, b in zip(act[:-1], act[1:]):
        gc = float(np.sqrt(((pts[b] - pts[a]) ** 2).sum()))
        want = np.asarray(jhmm.transition_costs(
            JCandidateSet(*(x[int(a)] for x in jc)),
            JCandidateSet(*(x[int(b)] for x in jc)), jnp.float32(gc), jtab,
            p.beta, p.max_route_distance_factor, p.backward_slack))
        got = hmm.transition_costs(
            CandidateSet(*(x[int(a)] for x in pc)),
            CandidateSet(*(x[int(b)] for x in pc)),
            torch.tensor(gc, dtype=torch.float32), ptab, p.beta,
            p.max_route_distance_factor, p.backward_slack).numpy()
        np.testing.assert_array_equal(got >= FINITE, want >= FINITE)
        np.testing.assert_allclose(got, want, rtol=SCORE_RTOL)
        route = hmm.route_distance(
            pc.edge[int(a)][:, None], pc.offset[int(a)][:, None],
            pc.edge[int(b)][None, :], pc.offset[int(b)][None, :], ptab,
            p.backward_slack).numpy()
        jroute = np.asarray(jhmm.route_distance(
            jc.edge[int(a)][:, None], jc.offset[int(a)][:, None],
            jc.edge[int(b)][None, :], jc.offset[int(b)][None, :], jtab,
            p.backward_slack))
        np.testing.assert_allclose(route, jroute, rtol=SCORE_RTOL)


@pytest.mark.parametrize("seed", [5, 8, 13, 27, 44])
@pytest.mark.parametrize("fn", ["viterbi_decode", "viterbi_topk_paths",
                                "viterbi_kbest_paths"])
def test_lattice_decoders_equal_reference(pair, seed, fn):
    """The best path, the terminal completions and the exact K best on
    the same 40-point lattice (the chain broken at 300 m): choices and
    validity equal, scores within SCORE_RTOL."""
    jts, jm, _, _ = pair
    cands, pts, valid = _jax_lattice(
        jm, _probe(jts, seed, 40, sigma=3.0).xy.astype(np.float32))
    (jc, jp, jv, jtab), (pc, pp, pv, ptab) = _both(jm, cands, pts, valid)
    args = _args(jm.params, breakage=300.0)
    kw = {"num_paths": 5} if fn == "viterbi_kbest_paths" else {}
    want = getattr(jhmm, fn)(jc, jp, jv, jtab, *args, **kw)
    got = getattr(hmm, fn)(pc, pp, pv, ptab, *args, **kw)
    if fn == "viterbi_decode":
        for f in want._fields:
            w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        return
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=SCORE_RTOL)
    assert got[2].numpy().any()


# ---- the port against its own exact list-Viterbi oracle -------------------


def _port_lattice(m: SegmentMatcher, xy: np.ndarray):
    """A padded trace's candidate lattice the way match_topk builds it:
    (candidates [T, K], points [T, 2], valid [T]) as torch tensors."""
    pts, valid = _padded(xy)
    pj, vj = torch.from_numpy(pts), torch.from_numpy(valid)
    c = batch_candidates(pj, vj, m.tables, m.params, m.ts.meta)
    return CandidateSet(*(x[0] for x in c)), pj[0], vj[0]


def _oracle_inputs(m, xy, breakage=None):
    """(em [A, K], trans blocks between consecutive active points, active
    indices), or None where the trace breaks (the oracle models one
    chain)."""
    p = m.params
    tc, pts, valid = _port_lattice(m, xy)
    keep = hmm.interpolation_keep_mask(pts, valid,
                                       p.interpolation_distance).numpy()
    em = hmm.emission_costs(tc, p.sigma_z).numpy()
    act = np.nonzero(keep & (em < FINITE).any(axis=1))[0]
    trans = []
    for a, b in zip(act[:-1], act[1:]):
        gc = float(np.sqrt(((pts[b] - pts[a]).numpy() ** 2).sum()))
        if gc > (p.breakage_distance if breakage is None else breakage):
            return None
        blk = hmm.transition_costs(
            CandidateSet(*(x[int(a)] for x in tc)),
            CandidateSet(*(x[int(b)] for x in tc)),
            torch.tensor(gc, dtype=torch.float32), m.tables, p.beta,
            p.max_route_distance_factor, p.backward_slack).numpy()
        if not (blk < FINITE).any():
            return None
        trans.append(blk)
    return em[act], trans, act, (tc, pts, valid)


def _oracle_topr(em: np.ndarray, trans: list, r: int):
    """Exact list-Viterbi (tests/test_topk_oracle.py's): per-state top-r
    (cost, path) lists, costs in f32 in the scan's association order.
    → (global top-r [(cost, path)] best first, {terminal slot: its best
    (cost, path)})."""
    A, K = em.shape
    cur = [[(np.float32(em[0, c]), (c,))] if em[0, c] < FINITE else []
           for c in range(K)]
    for t in range(1, A):
        nxt = []
        for c in range(K):
            if em[t, c] >= FINITE:
                nxt.append([])
                continue
            ext = []
            for cp in range(K):
                tr = trans[t - 1][cp, c]
                if tr >= FINITE:
                    continue
                for cost, path in cur[cp]:
                    ext.append((np.float32(
                        np.float32(cost + tr) + em[t, c]), path + (c,)))
            ext.sort(key=lambda x: x[0])
            nxt.append(ext[:r])
        cur = nxt
    final = sorted((x for lst in cur for x in lst), key=lambda x: x[0])
    per_terminal = {lst[0][1][-1]: lst[0] for lst in cur if lst}
    return final[:r], per_terminal


@pytest.fixture(scope="module")
def lattice(pair):
    """One unbroken 14-point trace: the oracle's inputs and the port's
    terminal completions and exact K best on it."""
    jts, _, _, m = pair
    p = m.params
    em, trans, act, (tc, pts, valid) = _oracle_inputs(
        m, _probe(jts, 5).xy.astype(np.float32))
    assert len(act) >= 8, "degenerate lattice"
    args = (tc, pts, valid, m.tables) + _args(p)
    topk = [x.numpy() for x in hmm.viterbi_topk_paths(*args)]
    kbest = [x.numpy() for x in hmm.viterbi_kbest_paths(
        *args, num_paths=R_ORACLE)]
    return {"em": em, "trans": trans, "act": act, "topk": topk,
            "kbest": kbest}


def test_best_path_is_global_optimum(lattice):
    top, _ = _oracle_topr(lattice["em"], lattice["trans"], 1)
    choices, scores, ok = lattice["topk"]
    assert ok[0]
    assert tuple(choices[0][lattice["act"]]) == top[0][1]
    np.testing.assert_allclose(scores[0], top[0][0], rtol=1e-4)


def test_alternates_are_exact_terminal_completions(lattice):
    _, per_terminal = _oracle_topr(lattice["em"], lattice["trans"], R_ORACLE)
    choices, scores, ok = lattice["topk"]
    n = 0
    for r in np.nonzero(ok)[0]:
        path = tuple(choices[r][lattice["act"]])
        cost, want = per_terminal[path[-1]]
        assert path == want, f"alternate {r}"
        np.testing.assert_allclose(scores[r], cost, rtol=1e-4)
        n += 1
    assert n >= 2


def test_true_kbest_dominates_terminal_completion(lattice):
    _, scores, ok = lattice["topk"]
    top, _ = _oracle_topr(lattice["em"], lattice["trans"],
                          min(int(ok.sum()), R_ORACLE))
    got = sorted(float(s) for s in scores[ok])
    assert got == [float(s) for s in scores[ok]]        # ascending
    for rank, (want, have) in enumerate(zip(top, got)):
        assert have >= want[0] - 1e-3, f"rank {rank}"


def test_kbest_matches_oracle_exactly(lattice):
    choices, scores, ok = lattice["kbest"]
    want, _ = _oracle_topr(lattice["em"], lattice["trans"], R_ORACLE)
    n = min(int(ok.sum()), len(want))
    assert n >= 3
    for r in range(n):
        np.testing.assert_allclose(scores[r], want[r][0], rtol=1e-4)
        assert tuple(choices[r][lattice["act"]]) == want[r][1], f"rank {r}"
    tc_scores = lattice["topk"][1][lattice["topk"][2]]
    for r in range(min(len(tc_scores), n)):
        assert scores[r] <= tc_scores[r] + 1e-3, f"rank {r}"


@pytest.mark.parametrize("seed", [13, 27, 44])
def test_kbest_matches_oracle_across_random_lattices(pair, seed):
    """tests/test_topk_oracle.py:288 on the port: every returned (score,
    path) of a fresh lattice per seed equals the oracle's."""
    jts, _, _, m = pair
    got = _oracle_inputs(m, _probe(jts, seed, 12, 13.0, 3.0).xy.astype(
        np.float32))
    if got is None:
        pytest.skip("trace broke: the oracle models one chain")
    em, trans, act, (tc, pts, valid) = got
    choices, scores, ok = (x.numpy() for x in hmm.viterbi_kbest_paths(
        tc, pts, valid, m.tables, *_args(m.params), num_paths=4))
    want, _ = _oracle_topr(em, trans, 4)
    n = min(int(ok.sum()), len(want))
    assert n >= 1
    for r in range(n):
        np.testing.assert_allclose(scores[r], want[r][0], rtol=1e-4)
        assert tuple(choices[r][act]) == want[r][1], f"rank {r}"


def test_kbest_rank0_equals_primary_decode_with_breakage(pair):
    """tests/test_topk_oracle.py:252 on the port: two stitched drives
    farther apart than the breakage distance; rank 0 of the list Viterbi
    reproduces viterbi_decode's choices exactly."""
    jts, _, _, m = pair
    pa = synthesize_probe(jts, seed=8, num_points=20, gps_sigma=2.0)
    pb = synthesize_probe(jts, seed=31, num_points=20, gps_sigma=2.0)
    xy = np.concatenate([pa.xy, pb.xy]).astype(np.float32)
    breakage = 300.0
    assert np.linalg.norm(pa.xy[-1] - pb.xy[0]) > breakage
    tc, pts, valid = _port_lattice(m, xy)
    args = (tc, pts, valid, m.tables) + _args(m.params, breakage)
    primary = hmm.viterbi_decode(*args)
    choices, scores, ok = hmm.viterbi_kbest_paths(*args, num_paths=4)
    assert bool(ok[0]) and int(primary.chain_start.sum()) >= 2
    np.testing.assert_array_equal(choices[0].numpy(), primary.choice.numpy())


# ---- SegmentMatcher.match_topk ---------------------------------------------


def _edges(ranked):
    return [[p.edge for p in pts] for _, pts in ranked]


@pytest.mark.parametrize("backend", ["dense", "grid"])
@pytest.mark.parametrize("exact", [False, True], ids=["terminal", "exact"])
def test_match_topk_equals_reference(pair, backend, exact):
    """match_topk of both packages' matchers (the same backend) on the
    same traces, one with per-point accuracy: the same ranked paths
    (edges per point), scores within SCORE_RTOL."""
    jts, _, ts, _ = pair
    jm = JSegmentMatcher(jts, JConfig(matcher=JMatcherParams(
        candidate_backend=backend)))
    pm = SegmentMatcher(ts, MatcherParams(candidate_backend=backend),
                        device="cpu")
    for seed in (5, 13):
        pr = _probe(jts, seed, 30, sigma=3.0)
        acc = (np.linspace(2.0, 12.0, len(pr.xy)).astype(np.float32)
               if seed == 13 else None)
        want = jm.match_topk(JTrace(uuid="u", xy=pr.xy.astype(np.float32),
                                    times=pr.times, accuracy=acc),
                             exact=exact)
        got = pm.match_topk(Trace(uuid="u", xy=pr.xy.astype(np.float32),
                                  times=pr.times, accuracy=acc), exact=exact)
        assert _edges(got) == _edges(want) and len(got) >= 2
        np.testing.assert_allclose([s for s, _ in got],
                                   [s for s, _ in want], rtol=SCORE_RTOL)


def test_match_topk_surface(pair):
    """Scores ascend; rank 0 of both forms is the same path (the global
    optimum); the exact form's scores dominate the terminal completions';
    the exact form returns max_candidates paths; a chain_start is never
    set."""
    jts, _, _, m = pair
    pr = _probe(jts, 5)
    tr = Trace(uuid="e", xy=pr.xy.astype(np.float32), times=pr.times)
    exact, approx = m.match_topk(tr, exact=True), m.match_topk(tr)
    assert exact and approx and len(exact) == m.params.max_candidates
    for ranked in (exact, approx):
        s = [x for x, _ in ranked]
        assert s == sorted(s)
        assert len(ranked[0][1]) == len(pr.xy)
        assert not any(p.chain_start for _, pts in ranked for p in pts)
    np.testing.assert_allclose(exact[0][0], approx[0][0], rtol=1e-4)
    assert _edges(exact)[0] == _edges(approx)[0]
    for (se, _), (sa, _) in zip(exact, approx):
        assert se <= sa + 1e-3


def test_match_topk_refuses_long_traces_and_the_oracle(pair):
    jts, _, ts, m = pair
    xy = np.zeros((1025, 2), np.float32)
    with pytest.raises(ValueError, match="1024"):
        m.match_topk(Trace(uuid="x", xy=xy, times=np.arange(1025.0)))
    oracle = SegmentMatcher(ts, Config(matcher_backend="reference_cpu"))
    pr = _probe(jts, 5)
    with pytest.raises(NotImplementedError):
        oracle.match_topk(Trace(uuid="x", xy=pr.xy.astype(np.float32),
                                times=pr.times))
