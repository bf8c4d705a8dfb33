"""HMM Viterbi decode over the candidate lattice, in plain PyTorch.

Counterpart: reporter_tpu/ops/hmm.py: the batched decode of the main path
(``viterbi_decode_batched``, with its _keep_mask_batched) and the
single-trace lattice functions of ranked paths (``route_distance``,
``transition_costs``, ``emission_costs``, ``interpolation_keep_mask``,
``viterbi_decode``, ``viterbi_topk_paths`` and the exact list Viterbi
``viterbi_kbest_paths``). Cost model (negative log-likelihood up to
constants):

  emission(c)      = dist(point, c)^2 / (2 * sigma_z^2)
  transition(c→c') = |route_dist(c, c') − gc_dist| / beta

with transitions disallowed when no route exists within the reach tables
or the route detour exceeds ``max_route_factor``. The JAX package's
``lax.scan`` loops become Python loops over T of [K, K, B] tensor steps,
kept batch-last as the reference lays them out so the two read alike.
Divisions are by 0-d tensors: a true division, never a multiplication by
a reciprocal. Orders are the reference's: an argmin takes the first
minimal index, and where the JAX package sorts (``jnp.argsort``, stable)
or takes ``lax.top_k`` of negated costs (ties by ascending index), the
port sorts ascending with ``stable=True`` and slices; ``torch.topk``
promises no tie order.
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
    d2_min = torch.full((), interp_distance, dtype=torch.float32,
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
    c = _consts(cands.offset, beta, max_route_factor, backward_slack)
    big = c.big
    # reach rows indexed as int64 once, not at every step
    tables = {**tables, "reach_row": tables["reach_row"].long()}
    ce = cands.edge.permute(1, 2, 0)                    # [T, K, B]
    co = cands.offset.permute(1, 2, 0)
    cv = cands.valid.permute(1, 2, 0)
    pts = points.permute(1, 2, 0)                       # [T, 2, B]
    vp = valid_pt.T                                     # [T, B]

    em = emission_costs(cands, sigma_z).permute(1, 2, 0)
    keep = _keep_mask_batched(pts, vp, interpolation_distance)
    active = keep & cv.any(dim=1)                       # [T, B]
    identity_bp = torch.arange(K, dtype=torch.int32,
                               device=dev)[:, None].expand(K, B)
    k_iota = torch.arange(K, dtype=torch.int32, device=dev)

    score = torch.full((K, B), BIG, dtype=torch.float32, device=dev)
    prev_pt = pts[0]
    prev_any = torch.zeros(B, dtype=torch.bool, device=dev)
    pe = torch.full((K, B), -1, dtype=torch.int32, device=dev)
    po = torch.zeros((K, B), dtype=torch.float32, device=dev)
    pv = torch.zeros((K, B), dtype=torch.bool, device=dev)
    scores, backptrs, started = [], [], []
    for t in range(T):
        em_t, pt, act_t, e, o, v = em[t], pts[t], active[t], ce[t], co[t], cv[t]
        gc = sqrt_f32(((pt - prev_pt) ** 2).sum(dim=0))        # [B]
        # [K, K, B] from the previous active point's candidates
        trans = _transition(pe[:, None], po[:, None], pv[:, None], e[None],
                            o[None], v[None], gc, tables, c)
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
    edge, offset, matched = _interp_fill(edge, offset, matched, vp & ~keep)

    return ViterbiResult(
        choice=choice.T.contiguous(),
        edge=edge.T.to(torch.int32).contiguous(),
        offset=offset.T.contiguous(),
        chain_start=started_t.T.contiguous(),
        matched=matched.T.contiguous(),
    )


# ---- the cost model (both decodes) and the single-trace lattice -----------


class _Consts(NamedTuple):
    """The cost model's scalars as 0-d f32 tensors on the lattice's
    device, made once per decode (a Python float operand would be copied
    to the device at every use)."""

    big: torch.Tensor
    beta: torch.Tensor
    factor: torch.Tensor
    ten: torch.Tensor
    slack: torch.Tensor
    breakage: torch.Tensor


def _consts(like: torch.Tensor, beta: float = 1.0,
            max_route_factor: float = 1.0, backward_slack: float = 10.0,
            breakage_distance: float = 0.0) -> _Consts:
    def f32(x):
        return torch.full((), x, dtype=torch.float32, device=like.device)

    return _Consts(f32(BIG), f32(beta), f32(max_route_factor), f32(10.0),
                   f32(backward_slack), f32(breakage_distance))


def _first_argmin(x: torch.Tensor, iota: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis (int64), as
    ``jnp.argmin`` gives on every device; iota = arange(x.shape[-1])."""
    return torch.where(x == x.amin(dim=-1, keepdim=True), iota,
                       x.shape[-1]).amin(dim=-1)


def _route(e1, off1, e2, off2, tables, c: _Consts):
    e1s = torch.clamp_min(e1, 0).long()
    e2s = torch.clamp_min(e2, 0)
    n1 = tables["reach_row"][e1s].long()
    hit = tables["reach_to"][n1] == e2s[..., None]
    gap = torch.where(hit, tables["reach_dist"][n1], c.big).amin(dim=-1)
    cross = (tables["edge_len"][e1s] - off1) + gap + off2
    same = (e1 == e2) & (off2 >= off1 - c.slack)
    direct = torch.clamp_min(off2 - off1, 0.0)
    route = torch.where(same, torch.minimum(direct, cross), cross)
    return torch.where((e1 >= 0) & (e2 >= 0), route, c.big)


def _transition(e1, o1, v1, e2, o2, v2, gc, tables, c: _Consts):
    """Transition costs between candidate fields laid out to broadcast
    ([..., K, 1] from, [..., 1, K] to, gc [..., 1, 1])."""
    route = _route(e1, o1, e2, o2, tables, c)
    cost = torch.abs(route - gc) / c.beta
    allowed = (route < c.big) & (route <= c.factor * gc + c.ten)
    allowed &= v1 & v2
    return torch.where(allowed, cost, c.big)


def route_distance(e1, off1, e2, off2, tables, backward_slack: float = 10.0):
    """Network distance from candidate (e1, off1) to candidate (e2, off2),
    broadcast over leading dims: the reach row's gap from the end of e1
    to the start of e2 plus the remainders on both edges; the same-edge
    forward case (moving back by less than ``backward_slack`` counts as no
    progress) is the offset difference. BIG where unreachable."""
    return _route(e1, off1, e2, off2, tables,
                  _consts(off1, backward_slack=backward_slack))


def transition_costs(cands_t: CandidateSet, cands_u: CandidateSet, gc,
                     tables, beta: float, max_route_factor: float,
                     backward_slack: float = 10.0):
    """[K, K] transition cost block from point t's candidates to point
    u's; gc the 0-d straight-line distance between the two points. A
    route longer than ``max_route_factor`` * gc + 10 m is disallowed."""
    c = _consts(cands_t.offset, beta, max_route_factor, backward_slack)
    return _transition(cands_t.edge[:, None], cands_t.offset[:, None],
                       cands_t.valid[:, None], cands_u.edge[None, :],
                       cands_u.offset[None, :], cands_u.valid[None, :], gc,
                       tables, c)


def emission_costs(cands: CandidateSet, sigma_z: float):
    """[..., K] emission cost; BIG for invalid candidates."""
    c = cands.dist ** 2 / torch.full((), 2.0 * sigma_z ** 2,
                                         dtype=torch.float32,
                                         device=cands.dist.device)
    return torch.where(cands.valid, c, torch.full(
        (), BIG, dtype=torch.float32, device=c.device))


def interpolation_keep_mask(points, valid_pt, interp_distance: float):
    """bool [T]: False for points within ``interp_distance`` of the last
    kept point (they ride the matched path instead of voting): the
    batched mask of one trace."""
    return _keep_mask_batched(points[:, :, None], valid_pt[:, None],
                              interp_distance)[:, 0]


def _lattice_inputs(cands: CandidateSet, points, keep, tables, c: _Consts):
    """What the forward pass reads at every step, computed for all steps
    at once (none of it depends on the scores): → (active [T], any active
    point before t [T], the transition blocks [T, K, K] from the last
    active point before t, BIG past the breakage distance). Step t's
    block is the reference scan's, op for op: its previous point is the
    last active one (point 0 before any)."""
    T = cands.edge.shape[0]
    active = keep & cands.valid.any(dim=1)
    idx = torch.arange(T, device=points.device)
    run = torch.cummax(torch.where(active, idx, -1), dim=0).values
    prev_idx = torch.cat([idx[:1] * 0, torch.clamp_min(run[:-1], 0)])
    prev_any = torch.cat([active[:1] & False, run[:-1] >= 0])
    gc = sqrt_f32(((points - points[prev_idx]) ** 2).sum(dim=-1))
    trans = _transition(
        cands.edge[prev_idx][:, :, None], cands.offset[prev_idx][:, :, None],
        cands.valid[prev_idx][:, :, None], cands.edge[:, None, :],
        cands.offset[:, None, :], cands.valid[:, None, :],
        gc[:, None, None], tables, c)
    trans = torch.where((gc <= c.breakage)[:, None, None], trans, c.big)
    return active, prev_any, trans


def _forward_list(cands: CandidateSet, points, keep, tables,
                  sigma_z: float, beta: float, max_route_factor: float,
                  breakage_distance: float, backward_slack: float,
                  num_paths: int):
    """Forward list-Viterbi pass of ONE trace: the carry keeps the R =
    ``num_paths`` best path costs per candidate ([K, R], state s = c * R +
    r), and each step keeps, per candidate, the R smallest of (previous
    state) + transition, ties by ascending state (lax.top_k's order; at
    R = 1 the first argmin, the plain Viterbi). Inactive points pass the
    score through with identity backpointers. → (scores [T, K * R],
    backptrs [T, K * R], started [T], active [T])."""
    T, K = cands.edge.shape
    R = int(num_paths)
    dev = cands.edge.device
    c = _consts(points, beta, max_route_factor, backward_slack,
                breakage_distance)
    em = emission_costs(cands, sigma_z)                     # [T, K]
    active, prev_any, trans = _lattice_inputs(cands, points, keep, tables, c)
    identity_bp = torch.arange(K * R, dtype=torch.int32,
                               device=dev).reshape(K, R)
    restart_tail = torch.full((K, R - 1), BIG, dtype=torch.float32,
                              device=dev)
    score = torch.full((K, R), BIG, dtype=torch.float32, device=dev)
    scores, backptrs, started = [], [], []
    for t in range(T):
        em_t, act_t = em[t], active[t]
        # via[(cp, r), c] = score[cp, r] + trans[cp, c]; per c the R
        # smallest, ties by ascending flat index
        via = (score[:, :, None] + trans[t][:, None, :]).reshape(K * R, K)
        srt = torch.sort(via.T, dim=-1, stable=True)
        best_cost = srt.values[:, :R]
        idxs = srt.indices[:, :R].to(torch.int32)
        connected = best_cost < c.big
        broken = ~connected.any() | ~prev_any[t]
        restart = torch.cat([em_t[:, None], restart_tail], dim=1)
        new_score = torch.where(broken, restart, torch.where(
            connected, best_cost + em_t[:, None], c.big))
        backptr = torch.where(broken | ~connected, -1, idxs)
        score = torch.where(act_t, new_score, score)
        scores.append(score.reshape(K * R))
        backptrs.append(torch.where(act_t, backptr,
                                    identity_bp).reshape(K * R))
        started.append(act_t & broken)
    return (torch.stack(scores), torch.stack(backptrs), torch.stack(started),
            active)


def _backtrack(scores, backptrs, started, active, top, init, init_started):
    """Reverse pass of R paths at once through a lattice of S states per
    level (scores, backptrs [T, S]): ``top`` [R, S] stands for the
    backpointer row above the last level, ``init`` [R] for the choice
    there and ``init_started`` [R] for its chain flag. A level is a chain
    terminal where the level above started a new chain (or has no
    choice): it re-seeds from its own score's first argmin; otherwise it
    follows the backpointer of the choice above, through identity rows at
    inactive levels. → states [R, T], -1 at inactive levels."""
    T, S = scores.shape
    R = top.shape[0]
    iota = torch.arange(S, device=scores.device)
    nxt = init.long()
    nxt_started = init_started
    out = [None] * T
    for t in range(T - 1, -1, -1):
        bp_next = top if t == T - 1 else backptrs[t + 1].expand(R, -1)
        prop = torch.where(nxt >= 0, bp_next.gather(
            1, torch.clamp_min(nxt, 0)[:, None])[:, 0].long(), -1)
        score_t = scores[t]
        own = _first_argmin(score_t, iota)
        own = torch.where(score_t[own] < BIG, own, -1)
        terminal = nxt_started | (nxt < 0)
        choice = torch.where(terminal, own, prop)
        out[t] = torch.where(active[t], choice, -1)
        nxt, nxt_started = choice, started[t].expand(R)
    return torch.stack(out, dim=1)


def _interp_fill(edge, offset, matched, interp):
    """Interpolated points (valid, not voting) take the last matched
    point's (edge, offset); padding stays unmatched. Each [T, ...]."""
    pe = torch.full_like(edge[0], -1)
    po = torch.zeros_like(offset[0])
    pok = torch.zeros_like(matched[0])
    out_e, out_o, out_m = [], [], []
    for t in range(edge.shape[0]):
        e, o, m, ip = edge[t], offset[t], matched[t], interp[t]
        use = ip & pok & ~m
        out_e.append(torch.where(use, pe, e))
        out_o.append(torch.where(use, po, o))
        out_m.append(m | use)
        pe = torch.where(m, e, pe)
        po = torch.where(m, o, po)
        pok = pok | m
    return torch.stack(out_e), torch.stack(out_o), torch.stack(out_m)


def viterbi_decode(cands: CandidateSet, points, valid_pt, tables,
                   sigma_z: float, beta: float, max_route_factor: float,
                   breakage_distance: float, backward_slack: float = 10.0,
                   interpolation_distance: float = 0.0) -> ViterbiResult:
    """Viterbi over the candidate lattice of ONE trace: cands [T, K],
    points f32 [T, 2], valid_pt bool [T] → ViterbiResult fields [T]. The
    chain restarts where consecutive points are farther apart than
    ``breakage_distance`` or no transition is allowed. The batched decode
    of a batch of one."""
    res = viterbi_decode_batched(
        CandidateSet(*(x[None] for x in cands)), points[None],
        valid_pt[None], tables, sigma_z, beta, max_route_factor,
        breakage_distance, backward_slack, interpolation_distance)
    return ViterbiResult(*(x[0] for x in res))


def viterbi_topk_paths(cands: CandidateSet, points, valid_pt, tables,
                       sigma_z: float, beta: float, max_route_factor: float,
                       breakage_distance: float,
                       backward_slack: float = 10.0,
                       interpolation_distance: float = 0.0):
    """Ranked path interpretations of ONE trace by terminal completion:
    the final chain's K terminal candidates ranked by accumulated cost,
    each backtracked (earlier chains keep their best path). Rank 0 is the
    global optimum; each alternate is the optimal path ending at its
    terminal. → (choice [K, T] i32 candidate slots (-1 unmatched), score
    [K] f32, valid [K] bool), best first; tied scores keep slot order."""
    K = cands.edge.shape[1]
    keep = interpolation_keep_mask(points, valid_pt, interpolation_distance)
    scores, backptrs, started, active = _forward_list(
        cands, points, keep, tables, sigma_z, beta, max_route_factor,
        breakage_distance, backward_slack, 1)
    final = scores[-1]
    order = torch.sort(final, stable=True).indices
    rank_score = final[order]
    rank_valid = rank_score < BIG
    # the row above the last level points every state at the ranked slot
    top = order[:, None].to(torch.int32).expand(K, K)
    choices = _backtrack(scores, backptrs, started, active, top, order,
                         torch.zeros(K, dtype=torch.bool,
                                     device=final.device))
    choices = torch.where(rank_valid[:, None], choices, -1)
    return choices.to(torch.int32), rank_score, rank_valid


def viterbi_kbest_paths(cands: CandidateSet, points, valid_pt, tables,
                        sigma_z: float, beta: float, max_route_factor: float,
                        breakage_distance: float,
                        backward_slack: float = 10.0,
                        interpolation_distance: float = 0.0,
                        num_paths: int = 4):
    """The EXACT ``num_paths`` best paths of ONE trace's final chain (the
    list Viterbi of ``_forward_list``). Earlier chains keep their single
    best path. → (choice [R, T]
    i32 candidate slots (-1 unmatched), score [R] f32, valid [R] bool),
    best first."""
    R = int(num_paths)
    dev = cands.edge.device
    keep = interpolation_keep_mask(points, valid_pt, interpolation_distance)
    scores_t, backptrs_t, started, active = _forward_list(
        cands, points, keep, tables, sigma_z, beta, max_route_factor,
        breakage_distance, backward_slack, R)
    final = scores_t[-1]
    order = torch.sort(final, stable=True).indices[:R]      # best R states
    rank_score = final[order]
    rank_valid = rank_score < BIG
    top = order[:, None].to(torch.int32).expand(R, final.shape[0])
    states = _backtrack(scores_t, backptrs_t, started, active, top, order,
                        torch.zeros(R, dtype=torch.bool, device=dev))
    choices = torch.where(states >= 0, states // R, -1)
    choices = torch.where(rank_valid[:, None], choices, -1)
    return choices.to(torch.int32), rank_score, rank_valid
