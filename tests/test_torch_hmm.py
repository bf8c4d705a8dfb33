"""The port's batched Viterbi against reporter_tpu.ops.hmm's, on the same
candidates (the JAX package's, handed across as numpy).

Tolerance 0: choice, edge, chain_start and matched are equal and the
offset bit-equal. (XLA:CPU rewrites the division by a constant into a
reciprocal multiply and fuses multiply-adds where the port rounds each
operation; on these inputs no lattice decision sits close enough to a
cost tie for that to change a choice.)
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reporter_tpu.config import CompilerParams, MatcherParams
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.ops.candidates import CandidateSet as JCandidateSet
from reporter_tpu.ops.dense_candidates import find_candidates_dense
from reporter_tpu.ops.hmm import viterbi_decode_batched as j_viterbi
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu_torch.ops.dense_candidates import CandidateSet
from reporter_tpu_torch.ops.hmm import viterbi_decode_batched
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def case():
    ts = compile_network(generate_city("tiny"),
                         CompilerParams(reach_radius=500.0,
                                        osmlr_max_length=200.0))
    tab = ts.device_tables("dense")
    B, T = 8, 64
    fleet = synthesize_fleet(ts, B, num_points=T, seed=9)
    pts = np.stack([p.xy for p in fleet]).astype(np.float32)
    pts[3, 30] += 900.0           # one far jump: a chain break mid-trace
    valid = np.ones((B, T), bool)
    valid[1, 40:] = False         # a short trace: padding at the tail
    pts[1, 40:] = pts[1, 0]
    c = find_candidates_dense(jnp.asarray(pts.reshape(-1, 2)),
                              (tab["seg_pack"], tab["seg_bbox"]), 50.0, 8)
    cands = [np.array(x).reshape(B, T, -1)
             for x in (c.edge, c.offset, c.dist, c.valid)]
    return tab, pts, valid, cands


@pytest.mark.parametrize("interp", [10.0, 0.0])
@pytest.mark.parametrize("breakage", [2000.0, 150.0])
def test_viterbi_matches_reference(case, interp, breakage):
    tab, pts, valid, cands = case
    p = MatcherParams()
    args = (p.sigma_z, p.beta, p.max_route_distance_factor, breakage,
            p.backward_slack, interp)
    jc = JCandidateSet(*(jnp.asarray(x) for x in cands))
    ref = j_viterbi(jc, jnp.asarray(pts), jnp.asarray(valid), tab, *args)
    ttab = {k: torch.from_numpy(np.array(tab[k]))
            for k in ("edge_len", "reach_row", "reach_to", "reach_dist")}
    got = viterbi_decode_batched(
        CandidateSet(*(torch.from_numpy(x) for x in cands)),
        torch.from_numpy(pts), torch.from_numpy(valid), ttab, *args)
    for f in ("choice", "edge", "chain_start", "matched", "offset"):
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f).numpy()
        assert have.dtype == want.dtype, f
        np.testing.assert_array_equal(have, want, err_msg=f)
    assert got.matched.any() and got.chain_start.sum() >= 8
