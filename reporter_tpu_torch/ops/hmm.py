"""HMM Viterbi decode over the candidate lattice, batched, in plain PyTorch.

Counterpart: reporter_tpu/ops/hmm.py::viterbi_decode_batched (and its
_keep_mask_batched). Cost model (negative log-likelihood up to constants):

  emission(c)      = dist(point, c)^2 / (2 * sigma_z^2)
  transition(c→c') = |route_dist(c, c') − gc_dist| / beta

with transitions disallowed when no route exists within the reach tables
or the route detour exceeds ``max_route_factor``. The JAX package's
``lax.scan`` loops become Python loops over T of [K, K, B] tensor steps,
kept batch-last as the reference lays them out so the two read alike.
Divisions are by 0-d tensors: a true division, never a multiplication by
a reciprocal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reporter_tpu_torch.ops.dense_candidates import BIG, CandidateSet, sqrt_f32


class ViterbiResult(NamedTuple):
    choice: torch.Tensor       # i32 [B, T] chosen candidate slot, -1 unmatched
    edge: torch.Tensor         # i32 [B, T] chosen edge id, -1 unmatched
    offset: torch.Tensor       # f32 [B, T] offset along chosen edge (m)
    chain_start: torch.Tensor  # bool [B, T] True where a new HMM chain begins
    matched: torch.Tensor      # bool [B, T]


def _keep_mask_batched(pts, vp, interp_distance: float):
    """Batch-last keep mask: pts [T, 2, B], vp [T, B] → bool [T, B]: False
    for points within ``interp_distance`` of the last kept point."""
    if interp_distance <= 0.0:
        return vp
    d2_min = torch.tensor(interp_distance, dtype=torch.float32,
                          device=pts.device) ** 2
    last_pt = pts[0]
    any_kept = torch.zeros_like(vp[0])
    keeps = []
    for t in range(pts.shape[0]):
        pt, v = pts[t], vp[t]
        d2 = ((pt - last_pt) ** 2).sum(dim=0)          # [B]
        keep = v & (~any_kept | (d2 >= d2_min))
        last_pt = torch.where(keep[None, :], pt, last_pt)
        any_kept = any_kept | keep
        keeps.append(keep)
    return torch.stack(keeps)


def viterbi_decode_batched(cands: CandidateSet, points, valid_pt, tables,
                           sigma_z: float, beta: float,
                           max_route_factor: float, breakage_distance: float,
                           backward_slack: float = 10.0,
                           interpolation_distance: float = 0.0,
                           ) -> ViterbiResult:
    """Whole-batch Viterbi: cands fields [B, T, K], points [B, T, 2],
    valid_pt [B, T] → ViterbiResult fields [B, T].

    Chains break where consecutive points are farther apart than
    ``breakage_distance`` or no transition is allowed. Inactive points
    (padding, interpolated, or no candidate in radius) pass the carry
    through with identity backpointers; interpolated points then inherit
    the last matched point's (edge, offset)."""
    B, T, K = cands.edge.shape
    dev = cands.edge.device
    f32 = torch.float32

    def scalar(x):
        return torch.tensor(x, dtype=f32, device=dev)

    big = scalar(BIG)
    ce = cands.edge.permute(1, 2, 0)                    # [T, K, B]
    co = cands.offset.permute(1, 2, 0)
    cd = cands.dist.permute(1, 2, 0)
    cv = cands.valid.permute(1, 2, 0)
    pts = points.permute(1, 2, 0)                       # [T, 2, B]
    vp = valid_pt.T                                     # [T, B]

    em = torch.where(cv, cd ** 2 / scalar(2.0 * sigma_z ** 2), big)
    keep = _keep_mask_batched(pts, vp, interpolation_distance)
    active = keep & cv.any(dim=1)                       # [T, B]
    identity_bp = torch.arange(K, dtype=torch.int32,
                               device=dev)[:, None].expand(K, B)
    k_iota = torch.arange(K, dtype=torch.int32, device=dev)

    edge_len = tables["edge_len"]
    reach_row = tables["reach_row"].long()
    reach_to = tables["reach_to"]
    reach_dist = tables["reach_dist"]
    beta_t = scalar(beta)
    slack = scalar(backward_slack)
    factor = scalar(max_route_factor)
    ten = scalar(10.0)

    def trans_block(pe, po, pv, e, o, v, gc):
        """[K, K, B] transition costs from the previous active point's
        candidates (pe, po, pv) to this point's (e, o, v)."""
        e1 = torch.clamp_min(pe, 0).long()              # [K, B]
        e2 = torch.clamp_min(e, 0)
        n1 = reach_row[e1]                              # edge → reach row
        rows_to = reach_to[n1]                          # [K, B, M]
        rows_d = reach_dist[n1]
        hit = rows_to[:, None] == e2[None, :, :, None]  # [K, K, B, M]
        gap = torch.where(hit, rows_d[:, None], big).amin(dim=-1)
        cross = (edge_len[e1] - po)[:, None] + gap + o[None, :]
        same = ((pe[:, None] == e[None, :])
                & (o[None, :] >= po[:, None] - slack))
        direct = torch.clamp_min(o[None, :] - po[:, None], 0.0)
        route = torch.where(same, torch.minimum(direct, cross), cross)
        route = torch.where((pe[:, None] >= 0) & (e[None, :] >= 0), route, big)
        cost = torch.abs(route - gc) / beta_t
        allowed = (route < BIG) & (route <= factor * gc + ten)
        allowed &= pv[:, None] & v[None, :]
        return torch.where(allowed, cost, big)

    score = torch.full((K, B), BIG, dtype=f32, device=dev)
    prev_pt = pts[0]
    prev_any = torch.zeros(B, dtype=torch.bool, device=dev)
    pe = torch.full((K, B), -1, dtype=torch.int32, device=dev)
    po = torch.zeros((K, B), dtype=f32, device=dev)
    pv = torch.zeros((K, B), dtype=torch.bool, device=dev)
    scores, backptrs, started = [], [], []
    for t in range(T):
        em_t, pt, act_t, e, o, v = em[t], pts[t], active[t], ce[t], co[t], cv[t]
        gc = sqrt_f32(((pt - prev_pt) ** 2).sum(dim=0))        # [B]
        trans = trans_block(pe, po, pv, e, o, v, gc)             # [K, K, B]
        trans = torch.where(gc <= breakage_distance, trans, big)

        via = score[:, None] + trans
        best_cost, best_prev = via.min(dim=0)                    # [K, B]
        best_prev = best_prev.to(torch.int32)
        connected = best_cost < BIG
        broken = ~connected.any(dim=0) | ~prev_any               # [B]
        new_score = torch.where(broken[None, :], em_t,
                                torch.where(connected, best_cost + em_t, big))
        backptr = torch.where(broken[None, :] | ~connected, -1, best_prev)

        act = act_t[None, :]
        score = torch.where(act, new_score, score)
        prev_pt = torch.where(act, pt, prev_pt)
        prev_any = act_t | prev_any
        pe = torch.where(act, e, pe)
        po = torch.where(act, o, po)
        pv = torch.where(act, v, pv)
        scores.append(score)
        backptrs.append(torch.where(act, backptr, identity_bp))
        started.append(act_t & broken)
    started_t = torch.stack(started)                             # [T, B]

    # backtrack: the slot chosen one level above, propagated down through
    # identity backpointers at inactive levels; a level is a chain terminal
    # when the level above started a new chain (or there is none above)
    nxt_choice = torch.full((B,), -1, dtype=torch.int32, device=dev)
    nxt_started = torch.ones(B, dtype=torch.bool, device=dev)
    bp_none = torch.full((K, B), -1, dtype=torch.int32, device=dev)
    choices = [None] * T
    for t in range(T - 1, -1, -1):
        score_t = scores[t]
        bp_next = backptrs[t + 1] if t + 1 < T else bp_none
        sel = k_iota[:, None] == torch.clamp_min(nxt_choice, 0)[None, :]
        prop = torch.where(sel, bp_next, 0).sum(dim=0, dtype=torch.int32)
        prop = torch.where(nxt_choice >= 0, prop, -1)
        min_t, own = score_t.min(dim=0)
        own = torch.where(min_t < BIG, own.to(torch.int32), -1)
        terminal = nxt_started | (nxt_choice < 0)
        choice_t = torch.where(terminal, own, prop).to(torch.int32)
        choices[t] = torch.where(active[t], choice_t, -1)
        nxt_choice, nxt_started = choice_t, started_t[t]
    choice = torch.stack(choices)                                # [T, B]

    safe = torch.clamp_min(choice, 0)
    matched = choice >= 0
    sel = k_iota[None, :, None] == safe[:, None, :]              # [T, K, B]
    edge = torch.where(matched, torch.where(sel, ce, 0).sum(
        dim=1, dtype=torch.int32), -1)
    offset = torch.where(matched, torch.where(sel, co, 0.0).sum(dim=1), 0.0)

    # interpolated points ride the matched path
    interp = vp & ~keep
    pe_ = torch.full((B,), -1, dtype=torch.int32, device=dev)
    po_ = torch.zeros(B, dtype=f32, device=dev)
    pok = torch.zeros(B, dtype=torch.bool, device=dev)
    out_e, out_o, out_m = [], [], []
    for t in range(T):
        e, o, m, ip = edge[t], offset[t], matched[t], interp[t]
        use = ip & pok & ~m
        out_e.append(torch.where(use, pe_, e))
        out_o.append(torch.where(use, po_, o))
        out_m.append(m | use)
        pe_ = torch.where(m, e, pe_)
        po_ = torch.where(m, o, po_)
        pok = pok | m

    return ViterbiResult(
        choice=choice.T.contiguous(),
        edge=torch.stack(out_e).T.to(torch.int32).contiguous(),
        offset=torch.stack(out_o).T.contiguous(),
        chain_start=started_t.T.contiguous(),
        matched=torch.stack(out_m).T.contiguous(),
    )
