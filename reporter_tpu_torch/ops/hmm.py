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
or the route detour exceeds ``max_route_factor``. On a card the batched
decode is one launch of the hand-written kernel ``kernels/viterbi.cu``
(the JAX package's four ``lax.scan`` loops in one program, bit-equal to
the plain version); on the CPU it is the plain version,
``_viterbi_plain``, whose ``lax.scan`` loops become Python loops over T
of [K, K, B] tensor steps, kept batch-last as the reference lays them
out so the two read alike. The single-trace ranked-path lattice
(``viterbi_topk_paths``, ``viterbi_kbest_paths``) runs its three scans
as the kernels of ``kernels/lattice.cu`` on a card (the keep mask, the
list-Viterbi forward pass and the R-path backtrack, one launch each,
bit-equal to their plain versions ``_keep_mask_batched``,
``_forward_list_plain`` and ``_backtrack_plain``, which the CPU runs);
what feeds them (the emissions, the transition blocks of every step at
once) is a fixed number of tensor operations on either device.
Divisions are by 0-d tensors: a true division, never a multiplication by
a reciprocal. Orders are the reference's: an argmin takes the first
minimal index, and where the JAX package sorts (``jnp.argsort``, stable)
or takes ``lax.top_k`` of negated costs (ties by ascending index), the
port sorts ascending with ``stable=True`` and slices; ``torch.topk``
promises no tie order.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from reporter_tpu_torch.ops.dense_candidates import BIG, CandidateSet, sqrt_f32

# The widest candidate list the Viterbi kernel takes (kMaxK in
# kernels/viterbi.cu: its per-step arrays in shared memory are this wide);
# the wrapper refuses a wider one on a card.
VITERBI_MAX_K = 64
# A CTA's shared memory on the card (sm_90: 227 KB), and the part the
# plan lets a CTA take with its levels there: a quarter, so four CTAs an
# SM; past it the levels go to the global scratch.
VITERBI_SMEM_MAX = 232448
VITERBI_SMEM_BUDGET = VITERBI_SMEM_MAX // 4
_VITERBI_WARPS = 4            # kMaxWarps: the reductions' words a trace

# Launches of the Viterbi kernel, keyed by the candidate width K (a key
# appears at its first launch: readers take a missing key as 0).
# viterbi_decode_batched adds one per launch, under _LAUNCH_LOCK, and
# nothing else does; chip_smoke.py resets and reads them around each
# main-path run, beside ops.dense_candidates.SWEEP_LAUNCHES.
VITERBI_LAUNCHES: "dict[int, int]" = {}
_LAUNCH_LOCK = threading.Lock()

# The widest candidate list the ranked-path lattice's forward kernel takes
# (kMaxK in kernels/lattice.cu); its path count R runs from 1 to K (the
# exact form runs R = max_candidates = K).
LATTICE_MAX_K = 64
LATTICE_BACKTRACK_THREADS = 128   # the backtrack's CTA: a path a thread
# Launches of the ranked-path lattice's kernels, keyed by kernel ("keep",
# "forward", "backtrack"; a key appears at its first launch). Each wrapper
# adds one per launch, under _LAUNCH_LOCK, and nothing else does;
# chip_smoke.py resets and reads them around each main-path run.
LATTICE_LAUNCHES: "dict[str, int]" = {}


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
    the last matched point's (edge, offset).

    On a card (the candidates' device) one launch of kernels/viterbi.cu
    (K up to VITERBI_MAX_K; a wider K, a failed build or a failed launch
    raises); on the CPU the plain version; any other device raises."""
    args = (cands, points, valid_pt, tables, sigma_z, beta,
            max_route_factor, breakage_distance, backward_slack,
            interpolation_distance)
    dev = cands.edge.device
    if dev.type == "cuda":
        return _viterbi_cuda(*args)
    if dev.type == "cpu":
        return _viterbi_plain(*args)
    raise ValueError(f"unsupported device {dev}")


def viterbi_smem_bytes(T: int, K: int, chunk: int, levels_here: bool) -> int:
    """Shared memory of one trace of the Viterbi kernel (``Layout`` in
    kernels/viterbi.cu, each array rounded up to 16 bytes): the chunk's
    transition blocks f32 [C, K, K] and candidate rows [(C + 1), K] (five
    4-byte fields, a flag and the looked-up slots' list; row 0 the carry)
    with a u64 mask a row, the scores, the step records, the
    reductions' words and, where ``levels_here``, the backtrack's choices
    i8 [T] and the levels (u16 words [T], u8 backpointers [T, K]); with
    the levels global nothing here grows with T. The launch checks this
    figure against the kernel's own layout."""
    def a16(n):
        return -(-n // 16) * 16

    rows = (chunk + 1) * K
    n = (a16(4 * chunk * K * K) + 5 * a16(4 * rows) + 2 * a16(rows)
         + a16(8 * (chunk + 1)) + a16(4 * K) + 5 * a16(4 * chunk)
         + 4 * a16(4 * _VITERBI_WARPS) + 3 * a16(chunk))
    if levels_here:
        n += a16(T) + a16(2 * T) + a16(T * K)
    return n


def viterbi_plan(B: int, T: int, K: int) -> dict:
    """The Viterbi kernel's launch at a batch of B traces of T points and
    K candidates, every field of which the launch passes to the kernel. A
    trace is a group of ``threads_per_trace`` threads (64, 128 past K =
    32), which all look up; the recurrence runs on the first
    ``recurrence_threads`` of them (one warp up to K = 16, else two lanes
    a column of the step's [K, K] block); ``traces_per_cta`` groups make
    a CTA of 128 threads, as many CTAs as cover B. A chunk of ``chunk``
    steps has its transition blocks looked up at once (at most about
    2048 pairs, of which the valid ones are searched). The levels
    (backpointers and a word a level) stay in shared memory (``levels``
    "shared") where the CTA then fits VITERBI_SMEM_BUDGET, else in a
    global scratch (``levels`` "global", ``scratch_bytes`` = B * T * (K +
    2) the wrapper allocates; 0 in shared memory), where the CTA's shared
    memory no longer grows with T. ``smem_bytes``: the CTA's dynamic
    shared memory. Raises past VITERBI_MAX_K."""
    if not 1 <= K <= VITERBI_MAX_K:
        raise ValueError(f"the Viterbi kernel takes 1 <= K <= "
                         f"{VITERBI_MAX_K} candidates, got K={K}")
    columns = 1 << (K - 1).bit_length()
    tpt = min(max(2 * columns, 64), 128)
    tpc = 128 // tpt
    chunk = max(1, min(32, 2048 // (K * K), T))
    here = tpc * viterbi_smem_bytes(T, K, chunk, True) \
        <= VITERBI_SMEM_BUDGET
    return {"traces_per_cta": tpc, "threads_per_trace": tpt,
            "recurrence_threads": min(tpt, max(32, 2 * columns)),
            "chunk": chunk,
            "smem_bytes": tpc * viterbi_smem_bytes(T, K, chunk, here),
            "levels": "shared" if here else "global",
            "scratch_bytes": 0 if here else B * T * (K + 2)}


def _viterbi_cuda(cands: CandidateSet, points, valid_pt, tables,
                  sigma_z: float, beta: float, max_route_factor: float,
                  breakage_distance: float, backward_slack: float,
                  interpolation_distance: float) -> ViterbiResult:
    """The batched decode as one launch of kernels/viterbi.cu on the
    current stream of the candidates' card: checks the tensors, allocates
    the outputs and, where the plan keeps the levels in global memory,
    the scratch, launches and counts the launch. Nothing here waits for
    the card.

    The kernel binary-searches each reach row: it takes the row order
    that ``tiles.tileset.host_tables`` holds every staged dict to (real
    target ids strictly ascending, the -1 padding at the end). It is not
    checked here, where reading the tables would wait for the card."""
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.utils import profiling

    B, T, K = (int(x) for x in cands.edge.shape)
    plan = viterbi_plan(B, T, K)
    dev = cands.edge.device
    ce, co, cd, cv = (x.contiguous() for x in cands)
    pts, vp = points.contiguous(), valid_pt.contiguous()
    tab = {k: tables[k].contiguous() for k in ("edge_len", "reach_row",
                                               "reach_to", "reach_dist")}
    E = tab["edge_len"].shape[0] if tab["edge_len"].dim() == 1 else -1
    R, M = tuple(tab["reach_to"].shape) if tab["reach_to"].dim() == 2 \
        else (-1, -1)
    checks = [("edge", ce, torch.int32, (B, T, K)),
              ("offset", co, torch.float32, (B, T, K)),
              ("dist", cd, torch.float32, (B, T, K)),
              ("valid", cv, torch.bool, (B, T, K)),
              ("points", pts, torch.float32, (B, T, 2)),
              ("valid_pt", vp, torch.bool, (B, T)),
              ("edge_len", tab["edge_len"], torch.float32, (E,)),
              ("reach_row", tab["reach_row"], torch.int32, (E,)),
              ("reach_to", tab["reach_to"], torch.int32, (R, M)),
              ("reach_dist", tab["reach_dist"], torch.float32, (R, M))]
    for name, t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"viterbi_decode_batched: expected {name} as "
                             f"{dtype} {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    choice = torch.empty((B, T), dtype=torch.int32, device=dev)
    edge = torch.empty((B, T), dtype=torch.int32, device=dev)
    offset = torch.empty((B, T), dtype=torch.float32, device=dev)
    start = torch.empty((B, T), dtype=torch.bool, device=dev)
    matched = torch.empty((B, T), dtype=torch.bool, device=dev)
    out = ViterbiResult(choice=choice, edge=edge, offset=offset,
                        chain_start=start, matched=matched)
    if B == 0 or T == 0:
        return out
    scratch = None if not plan["scratch_bytes"] else torch.empty(
        plan["scratch_bytes"], dtype=torch.uint8, device=dev)
    # a span of a device_trace capture (a no-op outside one)
    with profiling.annotate("viterbi_decode_kernel"):
        build.launch_viterbi(
            ce, co, cd, cv, pts, vp, tab["edge_len"], tab["reach_row"],
            tab["reach_to"], tab["reach_dist"], plan,
            2.0 * sigma_z ** 2, beta, max_route_factor, breakage_distance,
            backward_slack, interpolation_distance > 0.0,
            interpolation_distance, scratch, choice, edge, offset, start,
            matched)
    with _LAUNCH_LOCK:
        VITERBI_LAUNCHES[K] = VITERBI_LAUNCHES.get(K, 0) + 1
    return out


def _viterbi_plain(cands: CandidateSet, points, valid_pt, tables,
                   sigma_z: float, beta: float, max_route_factor: float,
                   breakage_distance: float, backward_slack: float = 10.0,
                   interpolation_distance: float = 0.0) -> ViterbiResult:
    """The plain version of the batched decode (the CPU's, and what the
    kernel is held to on a card): the JAX package's scans as Python loops
    over T."""
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
    batched mask of one trace. On a card one launch of the keep-mask
    kernel (kernels/lattice.cu); on the CPU the plain version; any other
    device raises. ``interp_distance <= 0`` keeps every valid point
    (``valid_pt`` itself, no launch)."""
    dev = points.device
    if dev.type == "cuda":
        return _keep_mask_cuda(points[None], valid_pt[None],
                               interp_distance)[0]
    if dev.type == "cpu":
        return _keep_mask_batched(points[:, :, None], valid_pt[:, None],
                                  interp_distance)[:, 0]
    raise ValueError(f"unsupported device {dev}")


def _count(key: str) -> None:
    with _LAUNCH_LOCK:
        LATTICE_LAUNCHES[key] = LATTICE_LAUNCHES.get(key, 0) + 1


def _keep_mask_cuda(points, valid_pt, interp_distance: float):
    """The keep mask of B traces (points f32 [B, T, 2], valid_pt bool
    [B, T]) as one launch of kernels/lattice.cu's keep-mask kernel on the
    card (``build.launch_lattice_keep`` checks the tensors): a thread a
    trace walks its T points in the plain version's operation order. →
    bool [B, T]."""
    from reporter_tpu_torch.kernels import build

    if interp_distance <= 0.0:
        return valid_pt
    keep = torch.empty(tuple(valid_pt.shape), dtype=torch.bool,
                       device=points.device)
    build.launch_lattice_keep(points.contiguous(), valid_pt.contiguous(),
                              float(interp_distance), keep)
    if keep.numel():
        _count("keep")
    return keep


def _lattice_inputs(cands: CandidateSet, points, keep, tables, c: _Consts):
    """What the forward pass reads at every step, computed for all steps
    at once (none of it depends on the scores): → (active [T], any active
    point before t [T], the transition blocks [T, K, K] from the last
    active point before t, BIG past the breakage distance). Step t's
    block is the reference scan's, op for op: its previous point is the
    last active one (point 0 before any). A fixed number of tensor
    operations on either device; ``_route`` holds [T, K, K, M]
    temporaries (M the reach row's width)."""
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


def _lattice_prep(cands: CandidateSet, points, keep, tables,
                  sigma_z: float, beta: float, max_route_factor: float,
                  breakage_distance: float, backward_slack: float):
    """The forward pass's inputs of ONE trace: → (emissions em [T, K],
    active [T], prev_any [T], transition blocks trans [T, K, K])."""
    c = _consts(points, beta, max_route_factor, backward_slack,
                breakage_distance)
    return (emission_costs(cands, sigma_z),
            *_lattice_inputs(cands, points, keep, tables, c))


def lattice_smem_bytes(K: int, R: int) -> int:
    """Shared memory of the forward kernel (``Layout`` in
    kernels/lattice.cu, each array rounded up to 16 bytes): the carried
    scores [K, R] and the staged step (transition block [K, K], emissions
    [K]) twice over, the merge's heads (values f32 and ranks u8 [K, K]),
    its picks (values f32 and states i32 [R, K | 1]) and the two flag
    words. Nothing grows with T. The launch checks this figure against
    the kernel's own layout."""
    def a16(n):
        return -(-n // 16) * 16

    pitch = K | 1
    return (2 * a16(4 * K * R) + 2 * a16(4 * K * K) + 2 * a16(4 * K)
            + a16(4 * K * K) + a16(K * K) + 2 * a16(4 * R * pitch) + a16(8))


def lattice_plan(T: int, K: int, R: int) -> dict:
    """The ranked-path lattice's forward launch at T steps, K candidates
    and R paths a state: one CTA of ``threads`` (64 to 256, with the
    carried state K * R: a column's merge a thread, the step's writes
    spread over all) and its dynamic shared memory ``smem_bytes``.
    Raises for K outside 1..LATTICE_MAX_K, R outside 1..K, or T < 1."""
    if not 1 <= K <= LATTICE_MAX_K:
        raise ValueError(f"the lattice kernels take 1 <= K <= "
                         f"{LATTICE_MAX_K} candidates, got K={K}")
    if not 1 <= R <= K:
        raise ValueError(f"the lattice kernels take 1 <= R <= K paths, got "
                         f"R={R} at K={K}")
    if T < 1:
        raise ValueError(f"the lattice kernels take T >= 1 steps, got T={T}")
    return {"threads": min(256, max(64, 32 * -(-(K * R) // 256))),
            "smem_bytes": lattice_smem_bytes(K, R)}


def _forward_list(em, active, prev_any, trans, num_paths: int):
    """The list-Viterbi forward pass of ONE trace: on a card one launch
    of the forward kernel (kernels/lattice.cu), on the CPU the plain
    version; any other device raises. See ``_forward_list_plain``."""
    dev = em.device
    if dev.type == "cuda":
        return _forward_list_cuda(em, active, prev_any, trans, num_paths)
    if dev.type == "cpu":
        return _forward_list_plain(em, active, prev_any, trans, num_paths)
    raise ValueError(f"unsupported device {dev}")


def _level_own(scores):
    """Each level's own first argmin over its states (scores [T, S]),
    -1 where its minimum is not below BIG: where a backtrack re-seeds at
    a chain terminal. → i32 [T]."""
    iota = torch.arange(scores.shape[1], device=scores.device)
    own = _first_argmin(scores, iota)
    return torch.where(scores.amin(dim=1) < BIG, own, -1).to(torch.int32)


def _forward_list_plain(em, active, prev_any, trans, num_paths: int):
    """The plain forward list-Viterbi pass of ONE trace (the CPU's, and
    what the kernel is held to on a card): em [T, K], active [T],
    prev_any [T] and the transition blocks [T, K, K] of
    ``_lattice_prep``. The carry keeps the R = ``num_paths`` best path
    costs per candidate ([K, R], state s = c * R + r), and each step
    keeps, per candidate, the R smallest of (previous state) +
    transition, ties by ascending state (lax.top_k's order; at R = 1 the
    first argmin, the plain Viterbi). Inactive points pass the score
    through with identity backpointers. → (scores f32 [T, K * R],
    backptrs i32 [T, K * R], started bool [T], own i32 [T]: each
    level's first argmin state, ``_level_own``)."""
    T, K = em.shape
    R = int(num_paths)
    dev = em.device
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
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
        connected = best_cost < big
        broken = ~connected.any() | ~prev_any[t]
        restart = torch.cat([em_t[:, None], restart_tail], dim=1)
        new_score = torch.where(broken, restart, torch.where(
            connected, best_cost + em_t[:, None], big))
        backptr = torch.where(broken | ~connected, -1, idxs)
        score = torch.where(act_t, new_score, score)
        scores.append(score.reshape(K * R))
        backptrs.append(torch.where(act_t, backptr,
                                    identity_bp).reshape(K * R))
        started.append(act_t & broken)
    scores = torch.stack(scores)
    return scores, torch.stack(backptrs), torch.stack(started), \
        _level_own(scores)


def _forward_list_cuda(em, active, prev_any, trans, num_paths: int):
    """The forward pass as one launch of kernels/lattice.cu's forward
    kernel on the current stream of em's card (one CTA, the plan's
    threads and shared memory): allocates the four outputs, launches
    (``build.launch_lattice_forward`` checks the tensors) and counts the
    launch. Nothing here waits for the card. The kernel's K-way merge reads each carried row as ascending,
    which every row the pass writes is (a best-first list plus one
    emission, a restart [em, BIG, ...] or the BIG start); it is not
    checked here."""
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.utils import profiling

    if em.dim() != 2:
        raise ValueError(f"the lattice forward kernel: expected em [T, K], "
                         f"got {tuple(em.shape)}")
    T, K = (int(x) for x in em.shape)
    R = int(num_paths)
    plan = lattice_plan(T, K, R)
    dev = em.device
    em, active, prev_any, trans = (x.contiguous() for x in
                                   (em, active, prev_any, trans))
    scores = torch.empty((T, K * R), dtype=torch.float32, device=dev)
    backptrs = torch.empty((T, K * R), dtype=torch.int32, device=dev)
    started = torch.empty((T,), dtype=torch.bool, device=dev)
    own = torch.empty((T,), dtype=torch.int32, device=dev)
    # a span of a device_trace capture (a no-op outside one)
    with profiling.annotate("lattice_forward_kernel"):
        build.launch_lattice_forward(em, active, prev_any, trans, R, plan,
                                     scores, backptrs, started, own)
    _count("forward")
    return scores, backptrs, started, own


def _backtrack(backptrs, started, active, own, seed):
    """The reverse pass of P paths at once: on a card one launch of the
    backtrack kernel (kernels/lattice.cu), on the CPU the plain version;
    any other device raises. See ``_backtrack_plain``."""
    dev = backptrs.device
    if dev.type == "cuda":
        return _backtrack_cuda(backptrs, started, active, own, seed)
    if dev.type == "cpu":
        return _backtrack_plain(backptrs, started, active, own, seed)
    raise ValueError(f"unsupported device {dev}")


def _backtrack_plain(backptrs, started, active, own, seed):
    """The plain reverse pass of P paths at once through a lattice of S
    states per level (backptrs [T, S], the level flags started and active
    [T], each level's own first argmin state [T]); ``seed`` [P] holds the
    state each path takes at the last level (the row above it points
    every state there), entered as no chain terminal. A level is a chain
    terminal where the level above started a new chain (or has no
    choice): it re-seeds from its own argmin; otherwise it follows the
    backpointer of the choice above, through identity rows at inactive
    levels. → states i32 [P, T], -1 at inactive levels."""
    T, S = backptrs.shape
    P = seed.shape[0]
    nxt = seed.long()
    nxt_started = torch.zeros(P, dtype=torch.bool, device=seed.device)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        if t == T - 1:
            prop = nxt
        else:
            prop = backptrs[t + 1][torch.clamp_min(nxt, 0)].long()
        prop = torch.where(nxt >= 0, prop, -1)
        terminal = nxt_started | (nxt < 0)
        choice = torch.where(terminal, own[t].long(), prop)
        out[t] = torch.where(active[t], choice, -1)
        nxt, nxt_started = choice, started[t].expand(P)
    return torch.stack(out, dim=1).to(torch.int32)


def _backtrack_cuda(backptrs, started, active, own, seed):
    """The reverse pass as one launch of kernels/lattice.cu's backtrack
    kernel (a path a thread, T levels down, CTAs of
    LATTICE_BACKTRACK_THREADS) on the current stream of the tensors'
    card: allocates the states, launches (``build.launch_lattice_
    backtrack`` checks the tensors) and counts the launch."""
    from reporter_tpu_torch.kernels import build

    states = torch.empty((seed.shape[0], backptrs.shape[0]),
                         dtype=torch.int32, device=backptrs.device)
    build.launch_lattice_backtrack(
        *(x.contiguous() for x in (backptrs, started, active, own, seed)),
        LATTICE_BACKTRACK_THREADS, states)
    if states.numel():
        _count("backtrack")
    return states


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
    [K] f32, valid [K] bool), best first; tied scores keep slot order.
    On a card the keep mask, the forward pass (R = 1) and the backtrack
    are one launch each of kernels/lattice.cu; on the CPU their plain
    versions; any other device raises."""
    keep = interpolation_keep_mask(points, valid_pt, interpolation_distance)
    em, active, prev_any, trans = _lattice_prep(
        cands, points, keep, tables, sigma_z, beta, max_route_factor,
        breakage_distance, backward_slack)
    scores, backptrs, started, own = _forward_list(em, active, prev_any,
                                                   trans, 1)
    final = scores[-1]
    order = torch.sort(final, stable=True).indices
    rank_score = final[order]
    rank_valid = rank_score < BIG
    # the row above the last level points every state at the ranked slot
    choices = _backtrack(backptrs, started, active, own,
                         order.to(torch.int32))
    return torch.where(rank_valid[:, None], choices, -1), rank_score, \
        rank_valid


def viterbi_kbest_paths(cands: CandidateSet, points, valid_pt, tables,
                        sigma_z: float, beta: float, max_route_factor: float,
                        breakage_distance: float,
                        backward_slack: float = 10.0,
                        interpolation_distance: float = 0.0,
                        num_paths: int = 4):
    """The EXACT ``num_paths`` best paths of ONE trace's final chain (the
    list Viterbi of ``_forward_list_plain``). Earlier chains keep their
    single best path. → (choice [R, T] i32 candidate slots (-1
    unmatched), score [R] f32, valid [R] bool), best first. On a card the
    keep mask, the forward pass and the backtrack are one launch each of
    kernels/lattice.cu (R up to K there); on the CPU their plain
    versions; any other device raises."""
    R = int(num_paths)
    keep = interpolation_keep_mask(points, valid_pt, interpolation_distance)
    em, active, prev_any, trans = _lattice_prep(
        cands, points, keep, tables, sigma_z, beta, max_route_factor,
        breakage_distance, backward_slack)
    scores, backptrs, started, own = _forward_list(em, active, prev_any,
                                                   trans, R)
    final = scores[-1]
    order = torch.sort(final, stable=True).indices[:R]      # best R states
    rank_score = final[order]
    rank_valid = rank_score < BIG
    states = _backtrack(backptrs, started, active, own,
                        order.to(torch.int32))
    choices = torch.where(states >= 0, states // R, -1)
    return torch.where(rank_valid[:, None], choices, -1).to(torch.int32), \
        rank_score, rank_valid
