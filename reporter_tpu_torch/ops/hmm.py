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
``_lattice_prep`` followed by ``_forward_list_plain``, and
``_backtrack_plain``, which the CPU runs): the forward kernel reads the
candidates and the reach tables and looks up each step's transition
block itself, as the batched decode's kernel does; on the CPU
``_lattice_prep`` builds every step's block at once (a fixed number of
tensor operations).
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

# The widest candidate list of the Viterbi kernel's instance 0 (kMaxK in
# kernels/viterbi.cu: a row's looked-up slots one 64-bit mask, u8 slots and
# backpointers); past it the wide kernel, instances 1 (K <= 254, u8
# backpointers) and 2 (u16), serves every K whose candidate rows fit a
# CTA's shared memory (to K = 3,984; the plan raises past it), one trace a
# CTA of VITERBI_WIDE_THREADS (kWideThreads).
VITERBI_MAX_K = 64
VITERBI_WIDE_THREADS = 128
# The wide kernel's chunk: as many steps as keep its candidate rows near
# VITERBI_WIDE_ROWS bytes (23 a slot); its pass: up to VITERBI_WIDE_PAIRS
# looked-up pairs' costs in shared memory, at least VITERBI_WIDE_MIN_PAIRS
# (a warp's worth).
VITERBI_WIDE_ROWS = 24576
VITERBI_WIDE_PAIRS = 4096
VITERBI_WIDE_MIN_PAIRS = 32
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

# The widest candidate list of the ranked-path lattice's forward kernel's
# shared-memory instances (kMaxK in kernels/lattice.cu); past it the wide
# instance serves every K whose candidate rows fit a CTA's shared memory
# (to K = 2,508; the plan raises past it); its path count R runs from 1
# to K (the exact form runs R = max_candidates = K).
LATTICE_MAX_K = 64
# The wide forward's placement (``place`` in its plan, kPlace* in
# kernels/lattice.cu): what stays in the CTA's shared memory, the rest in
# its global scratch.
LATTICE_PLACE_BLOCKS = 1      # the chunks' transition blocks
LATTICE_PLACE_ROWS = 2        # the carried rows
LATTICE_PLACE_TREES = 4       # the merge's loser trees
LATTICE_PLACE_BEST = 8        # each column's first-pass best and argmin
LATTICE_PLACE_LEVEL = 16      # the level's backpointers (R > 1, with rows)
# The backtrack's CTAs: a producer warp and up to LATTICE_MAX_WALKERS
# walker warps (kMaxWalkers in kernels/lattice.cu), as many CTAs as cover
# the paths.
LATTICE_MAX_WALKERS = 31
# Launches of the ranked-path lattice's kernels, keyed by kernel instance
# ("keep"; "forward", past LATTICE_MAX_K "forward:wide"; "backtrack" or
# "backtrack:global" by ``backtrack_key``; a key appears at its first
# launch). Each wrapper adds one per launch, under
# _LAUNCH_LOCK, and nothing else does; chip_smoke.py resets and reads
# them around each main-path run.
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
    (its instance by K: ``viterbi_plan``; a failed build or a failed
    launch raises); on the CPU the plain version; any other device
    raises."""
    args = (cands, points, valid_pt, tables, sigma_z, beta,
            max_route_factor, breakage_distance, backward_slack,
            interpolation_distance)
    dev = cands.edge.device
    if dev.type == "cuda":
        return _viterbi_cuda(*args)
    if dev.type == "cpu":
        return _viterbi_plain(*args)
    raise ValueError(f"unsupported device {dev}")


def _a16(n: int) -> int:
    """n bytes rounded up to 16, as the kernels' layouts take them."""
    return -(-n // 16) * 16


def viterbi_instance(K: int) -> int:
    """The Viterbi kernel's instance at K (``rtt_viterbi_decode`` in
    kernels/viterbi.cu): 0, ``viterbi_decode_kernel``, up to
    VITERBI_MAX_K; past it ``viterbi_decode_wide_kernel``, 1 while a slot
    fits a u8 beside its 0xff "none" (K <= 254), else 2 (u16
    backpointers)."""
    return 0 if K <= VITERBI_MAX_K else (1 if K < 255 else 2)


def viterbi_smem_bytes(T: int, K: int, chunk: int, levels_here: bool) -> int:
    """Shared memory of one trace group of instance 0 (``Layout`` in
    kernels/viterbi.cu, each array rounded up to 16 bytes): the chunk's
    transition blocks f32 [C, K, K], the candidate rows [(C + 1), K] (five
    4-byte fields, a flag and the looked-up slots' list) and one mask word
    a row, the scores, the step records, the reductions' words and, where
    ``levels_here``, the backtrack's choices [T] and the levels (u16 words
    [T], u8 backpointers [T, K]); with the levels global nothing here grows
    with T. The launch checks this figure against the kernel's own
    layout."""
    a16 = _a16
    rows = (chunk + 1) * K
    n = (a16(4 * chunk * K * K) + 5 * a16(4 * rows) + 2 * a16(rows)
         + a16(8 * (chunk + 1)) + a16(4 * K) + 5 * a16(4 * chunk)
         + 4 * a16(4 * _VITERBI_WARPS) + 3 * a16(chunk))
    if levels_here:
        n += a16(T) + a16(2 * T) + a16(T * K)
    return n


def viterbi_wide_smem_bytes(T: int, K: int, chunk: int, pairs: int,
                            levels_here: bool) -> int:
    """Shared memory of one trace of the wide kernel (``WideLayout`` in
    kernels/viterbi.cu, each array rounded up to 16 bytes): the pass's
    looked-up pairs' costs f32 [pairs], the candidate rows [(C + 1), K]
    (five 4-byte fields, a flag and the u16 list of looked-up slots) with
    ceil(K / 64) mask words a row, the scores and each column's best and
    argmin [K], each row's looked-up count, the step records, the
    reductions' words and, where ``levels_here``, the choices i32 [T], the
    words u32 [T] and the backpointers [T, K] (u8 to K = 254, else u16).
    The launch checks this figure against the kernel's own layout."""
    a16 = _a16
    rows = (chunk + 1) * K
    warps = VITERBI_WIDE_THREADS // 32
    n = (a16(4 * pairs) + 5 * a16(4 * rows) + a16(rows) + a16(2 * rows)
         + a16(8 * -(-K // 64) * (chunk + 1)) + 3 * a16(4 * K)
         + a16(4 * (chunk + 1)) + 5 * a16(4 * chunk) + 3 * a16(4 * warps)
         + 3 * a16(chunk))
    if levels_here:
        n += 2 * a16(4 * T) + a16((1 if K < 255 else 2) * T * K)
    return n


def viterbi_plan(B: int, T: int, K: int) -> dict:
    """The Viterbi kernel's launch at a batch of B traces of T points and
    K candidates, every field of which the launch passes to the kernel.
    ``kernel`` and ``instance``: ``viterbi_instance(K)``'s.

    Instance 0, ``viterbi_decode_kernel`` (K up to 64): a trace is a group
    of ``threads_per_trace`` threads (64, 128 past K = 32), which all look
    up; the recurrence runs on the first ``recurrence_threads`` of them
    (one warp up to K = 16, else two lanes a column of the step's [K, K]
    block); ``traces_per_cta`` groups make a CTA of 128 threads, as many
    CTAs as cover B. A chunk of ``chunk`` steps has its transition blocks
    looked up at once (at most about 2048 pairs of [K, K] blocks, of which
    the valid ones are searched); ``pairs`` 0.

    Instances 1 and 2, ``viterbi_decode_wide_kernel``: one trace a CTA of
    VITERBI_WIDE_THREADS, all of which look up and run the recurrence; a
    chunk of ``chunk`` steps (its candidate rows about VITERBI_WIDE_ROWS
    bytes, at most 32 steps) looked up in passes of ``pairs`` looked-up
    pairs (VITERBI_WIDE_PAIRS, fewer only where the CTA would not fit the
    card; at least VITERBI_WIDE_MIN_PAIRS), their costs kept compact in
    shared memory.

    Both: the levels (backpointers and a word a level) stay in shared
    memory (``levels`` "shared") where the CTA then fits
    VITERBI_SMEM_BUDGET, else in the global scratch (``levels``
    "global"), where the CTA's shared memory no longer grows with T.
    ``scratch_bytes``: the global levels, B * T * (word + K * backpointer)
    bytes (2 + K at instance 0, 4 + K or 4 + 2K wide), 0 where they stay
    in shared memory (the wrapper allocates it). ``smem_bytes``: the CTA's
    dynamic shared memory. Raises for K < 1, or where a wide K's candidate
    rows leave no room for a pass (past K = 3,984): the one ceiling."""
    if K < 1:
        raise ValueError(f"the Viterbi kernel takes K >= 1 candidates, got "
                         f"K={K}")
    inst = viterbi_instance(K)
    if inst == 0:
        chunk = max(1, min(32, 2048 // (K * K), T))
        columns = 1 << (K - 1).bit_length()
        tpt = min(max(2 * columns, 64), 128)
        tpc, rt = 128 // tpt, min(tpt, max(32, 2 * columns))
        here = tpc * viterbi_smem_bytes(T, K, chunk, True) \
            <= VITERBI_SMEM_BUDGET
        return {"kernel": "viterbi_decode_kernel", "instance": 0,
                "traces_per_cta": tpc, "threads_per_trace": tpt,
                "recurrence_threads": rt, "chunk": chunk, "pairs": 0,
                "smem_bytes": tpc * viterbi_smem_bytes(T, K, chunk, here),
                "levels": "shared" if here else "global",
                "scratch_bytes": 0 if here else B * T * (2 + K)}
    chunk = max(1, min(32, T, VITERBI_WIDE_ROWS // (23 * K) - 1))
    pairs = VITERBI_WIDE_PAIRS
    here = viterbi_wide_smem_bytes(T, K, chunk, pairs, True) \
        <= VITERBI_SMEM_BUDGET
    room = VITERBI_SMEM_MAX - viterbi_wide_smem_bytes(T, K, chunk, 0, here)
    pairs = min(pairs, room // 4)
    if pairs < VITERBI_WIDE_MIN_PAIRS:
        smem = viterbi_wide_smem_bytes(T, K, chunk, VITERBI_WIDE_MIN_PAIRS,
                                       here)
        raise ValueError(f"the Viterbi kernel's candidate rows at K={K} "
                         f"take {smem} bytes, over a CTA's "
                         f"{VITERBI_SMEM_MAX} of shared memory")
    bp = 1 if inst == 1 else 2
    return {"kernel": "viterbi_decode_wide_kernel", "instance": inst,
            "traces_per_cta": 1, "threads_per_trace": VITERBI_WIDE_THREADS,
            "recurrence_threads": VITERBI_WIDE_THREADS, "chunk": chunk,
            "pairs": pairs,
            "smem_bytes": viterbi_wide_smem_bytes(T, K, chunk, pairs, here),
            "levels": "shared" if here else "global",
            "scratch_bytes": 0 if here else B * T * (4 + bp * K)}


def _viterbi_cuda(cands: CandidateSet, points, valid_pt, tables,
                  sigma_z: float, beta: float, max_route_factor: float,
                  breakage_distance: float, backward_slack: float,
                  interpolation_distance: float) -> ViterbiResult:
    """The batched decode as one launch of kernels/viterbi.cu on the
    current stream of the candidates' card: checks the tensors, allocates
    the outputs and, where the plan keeps the levels in
    global memory, the scratch, launches and counts the launch. Nothing
    here waits for the card.

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
    card (``build.launch_lattice_keep`` checks the tensors): a CTA a
    trace marks the chain of kept points (each kept point's successor, the
    first later valid point far enough from it, by the plain version's
    operations; kernels/lattice.cu holds the proof). → bool [B, T]."""
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
    operations; ``_route`` holds [T, K, K, M] temporaries (M the reach
    row's width). The CPU's path, and what the forward kernel, which
    looks the blocks up itself, is held to on a card."""
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


def _tree_min(K: int) -> int:
    """One column's loser tree in the wide forward at the most leaves it
    can have (K looked-up rows up to a power of two N: N - 1 u64 nodes,
    counted as N)."""
    return 8 * (1 << (K - 1).bit_length())


def lattice_smem_bytes(K: int, R: int, chunk: int, place: int = 0,
                       tree_bytes: int = 0) -> int:
    """Shared memory of the forward kernel (``Layout`` in
    kernels/lattice.cu, each array rounded up to 16 bytes): two chunk
    buffers, each the chunk's transition blocks f32 [C, K, K] (in a wide
    instance, K > LATTICE_MAX_K, only where ``place`` has
    LATTICE_PLACE_BLOCKS), its candidate rows [(C + 1), K] (five 4-byte
    fields, a flag and the looked-up slots' list, u16 when wide) with
    ceil(K / 64) mask words a row, five 4-byte and three 1-byte fields a
    step and four words; then, in a shared instance, the carried scores
    [K, R | 1] twice (rows of odd pitch), at R > 1 the level's
    backpointers i32 [K, R | 1] and the merge's loser trees (u64 [N, W]: N
    = K up to a power of two, W = K up to a multiple of 16), and the own
    reduction's eight words; in the wide instance the carried scores where
    ``place`` has LATTICE_PLACE_ROWS, the level's backpointers i32 [K, R |
    1] where it has LATTICE_PLACE_LEVEL, each column's first-pass best and
    argmin [K] where it has LATTICE_PLACE_BEST, the reduction's 32 words,
    and the trees' region of ``tree_bytes`` where it has
    LATTICE_PLACE_TREES. Nothing grows with T. The launch checks this
    figure against the kernel's own layout."""
    a16 = _a16
    wide = K > LATTICE_MAX_K
    rows = (chunk + 1) * K
    blocks = not wide or place & LATTICE_PLACE_BLOCKS
    buf = ((a16(4 * chunk * K * K) if blocks else 0) + 5 * a16(4 * rows)
           + a16(rows) + a16((2 if wide else 1) * rows)
           + a16(8 * -(-K // 64) * (chunk + 1)) + 5 * a16(4 * chunk)
           + 3 * a16(chunk) + 16)
    rows_r = a16(4 * K * (R | 1))
    if wide:
        return (2 * buf
                + (2 * rows_r if place & LATTICE_PLACE_ROWS else 0)
                + (rows_r if place & LATTICE_PLACE_LEVEL else 0)
                + (2 * a16(4 * K) if place & LATTICE_PLACE_BEST else 0)
                + 4 * 2 * 2 * 8
                + (a16(tree_bytes) if place & LATTICE_PLACE_TREES else 0))
    if R == 1:
        return 2 * buf + 2 * rows_r + 32
    tree = 8 * (1 << (K - 1).bit_length()) * (-(-K // 16) * 16)
    return 2 * buf + 3 * rows_r + a16(tree) + 32


def lattice_scratch_bytes(K: int, R: int, chunk: int, place: int,
                          tree_bytes: int) -> int:
    """The wide forward's global scratch (``WideScratch`` in
    kernels/lattice.cu, each array rounded up to 16 bytes): what
    ``place`` leaves out of shared memory, of the two buffers' blocks f32
    [2, C, K, K], the carried scores [K, R | 1] twice, each column's
    first-pass best and argmin [K] and, at R > 1, the trees' region of
    ``tree_bytes``."""
    rows = _a16(4 * K * (R | 1))
    return ((0 if place & LATTICE_PLACE_BLOCKS
             else _a16(2 * chunk * K * K * 4))
            + (0 if place & LATTICE_PLACE_ROWS else 2 * rows)
            + (0 if place & LATTICE_PLACE_BEST else 2 * _a16(4 * K))
            + (_a16(tree_bytes) if R > 1
               and not place & LATTICE_PLACE_TREES else 0))


def lattice_plan(T: int, K: int, R: int) -> dict:
    """The ranked-path lattice's forward launch at T steps, K candidates
    and R paths a state, every field of which the launch passes to the
    kernel: one CTA of ``merge_warps`` and ``producer_warps`` (the chunks'
    staging, control sequence and lookups, a chunk ahead), ``threads`` in
    all; ``chunk`` steps a chunk; ``smem_bytes`` the CTA's dynamic shared
    memory, the same at every T.

    The shared instances (K up to LATTICE_MAX_K): a thread a column (K up
    to whole warps), 4 producer warps (8 past K = 16), a chunk of up to 32
    steps and about 32,768 looked-up pairs' room in the blocks [C, K, K],
    the most whose two buffers fit the card's shared memory with the rest
    of the layout (6 at K = 64 and R = 1, 4 at R = 64); the instance by R
    and K (the loser tree's depth at R > 1); ``place`` 0, ``tree_bytes``
    0, ``scratch_bytes`` 0.

    The wide instance (K > LATTICE_MAX_K): 8 merge and 8 producer warps;
    ``place`` the LATTICE_PLACE_* bits of what stays in shared memory. At
    R > 1 a pick reads its row's block entry, carry and tree nodes in a
    dependent chain, and each thread's picks fill its column's row of the
    level: the blocks, the carried rows, the columns' first pass, the
    level's backpointers (beside the rows only: the level is copied out
    of both, coalesced, once the step's picks are done, not written a
    pick at a time to scattered rows) and the trees in shared memory, at
    the largest chunk (up to the
    shared instances' formula) that leaves room for every column's tree
    at K leaves (else one step a chunk); the trees' region then takes the
    rest of the card's shared memory (``tree_bytes``, up to every
    column's tree at K leaves, at least one's); where that does not fit, each
    of them in that order where it fits beside the chunk's rows, the rest
    in the global scratch (the trees' region then holds every column's
    tree at K leaves). At R = 1 each block entry is read once, in
    independent loads: the blocks stay in the global scratch at the
    formula's chunk (the most lookups in flight), the rows and the first
    pass in shared memory where they fit. ``scratch_bytes``: what is left
    out (``lattice_scratch_bytes``).

    Raises for K < 1, R outside 1..K, T < 1, or a wide K whose candidate
    rows do not fit a CTA's shared memory (past K = 2,508): the one
    ceiling."""
    if K < 1:
        raise ValueError(f"the lattice kernels take K >= 1 candidates, got "
                         f"K={K}")
    if not 1 <= R <= K:
        raise ValueError(f"the lattice kernels take 1 <= R <= K paths, got "
                         f"R={R} at K={K}")
    if T < 1:
        raise ValueError(f"the lattice kernels take T >= 1 steps, got T={T}")
    chunk = max(1, min(32, 32768 // (K * K)))
    if K <= LATTICE_MAX_K:
        merge, producers = -(-K // 32), (4 if K <= 16 else 8)
        while chunk > 1 and lattice_smem_bytes(K, R, chunk) \
                > VITERBI_SMEM_MAX:
            chunk -= 1
        return {"chunk": chunk, "producer_warps": producers,
                "merge_warps": merge, "threads": 32 * (producers + merge),
                "smem_bytes": lattice_smem_bytes(K, R, chunk), "place": 0,
                "tree_bytes": 0, "scratch_bytes": 0}

    def fits(c, place, tree_bytes=0):
        return lattice_smem_bytes(K, R, c, place, tree_bytes) \
            <= VITERBI_SMEM_MAX

    trees, tree_min = LATTICE_PLACE_TREES, _tree_min(K)
    tree_all = tree_min * min(K, 32 * 8)
    every = (LATTICE_PLACE_BLOCKS | LATTICE_PLACE_ROWS | LATTICE_PLACE_BEST
             | LATTICE_PLACE_LEVEL)
    place, tree_bytes = 0, 0
    if R > 1:
        # the largest chunk beside every column's tree at K leaves, else
        # one step a chunk
        while chunk > 1 and not fits(chunk, every | trees, tree_all):
            chunk -= 1
        if fits(chunk, every | trees, tree_min):
            place = every | trees
        else:
            for bit in (LATTICE_PLACE_BLOCKS, LATTICE_PLACE_ROWS,
                        LATTICE_PLACE_BEST, LATTICE_PLACE_LEVEL, trees):
                if bit == LATTICE_PLACE_LEVEL and \
                        not place & LATTICE_PLACE_ROWS:
                    continue       # the level is copied out of the rows
                if fits(chunk, place | bit, tree_min if bit == trees
                        else 0):
                    place |= bit
        if place & trees:
            room = VITERBI_SMEM_MAX - lattice_smem_bytes(K, R, chunk,
                                                         place & ~trees)
            tree_bytes = min(tree_all, room) // 16 * 16
        else:
            tree_bytes = -(-tree_all // 16) * 16
    else:
        while chunk > 1 and not fits(chunk, 0):
            chunk -= 1
        for bit in (LATTICE_PLACE_ROWS, LATTICE_PLACE_BEST):
            if fits(chunk, place | bit):
                place |= bit
    smem = lattice_smem_bytes(K, R, chunk, place, tree_bytes)
    if smem > VITERBI_SMEM_MAX:
        raise ValueError(f"the lattice forward kernel's candidate rows at "
                         f"K={K} take {smem} bytes, over a CTA's "
                         f"{VITERBI_SMEM_MAX} of shared memory")
    return {"chunk": chunk, "producer_warps": 8, "merge_warps": 8,
            "threads": 512, "smem_bytes": smem, "place": place,
            "tree_bytes": tree_bytes,
            "scratch_bytes": lattice_scratch_bytes(K, R, chunk, place,
                                                   tree_bytes)}


def backtrack_smem_bytes(S: int, P: int, levels: int, stages: int) -> int:
    """Shared memory of the backtrack kernel's ring (``BtLayout`` in
    kernels/lattice.cu, each array rounded up to 16 bytes) for P paths a
    CTA: ``stages`` slots of ``levels`` levels (backpointer rows i32 [G,
    S], own i32 [G], the started and active bytes of the 16-aligned span
    round them), a full and a free mbarrier a slot, the walkers' staged
    choices i32 [32 a warp, 33]. The launch checks this figure against
    the kernel's own layout."""
    a16 = _a16
    slot = (a16(4 * levels * S) + a16(4 * levels) + 2 * a16(levels + 32))
    return (stages * slot + 2 * a16(8 * stages)
            + a16(4 * 33 * 32 * -(-P // 32)))


def backtrack_key(plan: dict) -> str:
    """The launch key of a backtrack plan's instance in LATTICE_LAUNCHES:
    "backtrack" for the ring, "backtrack:global" for the levels read in
    place."""
    return "backtrack:global" if plan["instance"] == "global" \
        else "backtrack"


def backtrack_plan(T: int, S: int, P: int) -> dict:
    """The backtrack's launch at T levels of S states and P paths.
    ``instance`` "ring": ``ctas`` CTAs of a producer warp and up to
    LATTICE_MAX_WALKERS walker warps (``threads``: ceil(P / 32) walkers,
    halved until the ring fits beside their staging), a ring of ``stages`` slots (4, else 3,
    else 2) of ``levels`` levels (a multiple of 4, at most 64: the most
    that fit), the levels streamed tail-first into it;
    ``smem_bytes`` its dynamic shared memory, the same at every T. Where
    a level is too wide for two slots of four levels, ``instance``
    "global": ``ctas`` CTAs of ``threads`` threads, a path each, reading
    the levels in place (no ring: levels, stages and smem_bytes 0).
    Raises for P < 1 or T < 1."""
    if P < 1:
        raise ValueError(f"the backtrack kernel takes P >= 1 paths, got "
                         f"P={P}")
    if T < 1:
        raise ValueError(f"the lattice kernels take T >= 1 steps, got T={T}")
    walkers = min(-(-P // 32), LATTICE_MAX_WALKERS)
    while True:
        for stages in (4, 3, 2):
            for levels in range(64, 0, -4):
                n = backtrack_smem_bytes(S, 32 * walkers, levels, stages)
                if n <= VITERBI_SMEM_MAX:
                    return {"instance": "ring", "levels": levels,
                            "stages": stages, "threads": 32 + 32 * walkers,
                            "ctas": -(-P // (32 * walkers)),
                            "smem_bytes": n}
        if walkers == 1:
            break
        walkers = -(-walkers // 2)     # fewer walkers' staging, more CTAs
    threads = min(1024, 32 * -(-P // 32))
    return {"instance": "global", "levels": 0, "stages": 0,
            "threads": threads, "ctas": -(-P // threads), "smem_bytes": 0}


def _forward_list(cands: CandidateSet, points, keep, tables,
                  sigma_z: float, beta: float, max_route_factor: float,
                  breakage_distance: float, backward_slack: float,
                  num_paths: int):
    """The list-Viterbi forward pass of ONE trace from its candidates
    [T, K], points [T, 2], keep mask [T] and the reach tables: on a card
    one launch of the forward kernel (kernels/lattice.cu), which looks up
    the transition blocks itself; on the CPU ``_lattice_prep`` then
    ``_forward_list_plain``; any other device raises. → (scores,
    backptrs, started, own) as ``_forward_list_plain``, then active
    bool [T]."""
    args = (cands, points, keep, tables, sigma_z, beta, max_route_factor,
            breakage_distance, backward_slack)
    dev = cands.edge.device
    if dev.type == "cuda":
        return _forward_list_cuda(*args, num_paths)
    if dev.type == "cpu":
        em, active, prev_any, trans = _lattice_prep(*args)
        return (*_forward_list_plain(em, active, prev_any, trans,
                                     num_paths), active)
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


def _forward_list_cuda(cands: CandidateSet, points, keep, tables,
                       sigma_z: float, beta: float, max_route_factor: float,
                       breakage_distance: float, backward_slack: float,
                       num_paths: int):
    """The forward pass as one launch of kernels/lattice.cu's forward
    kernel on the current stream of the candidates' card (one CTA, the
    plan's warps, chunk and shared memory): allocates the five outputs
    and, for the wide instance, its scratch, launches (``build.launch_lattice_forward`` checks the tensors) and
    counts the launch. Nothing here waits for the card; no [T, K, K]
    block is made. The kernel binary-searches each reach row in the order
    ``tiles.tileset.host_tables`` holds every staged dict to, and its
    K-way merge reads each carried row as ascending, which every row the
    pass writes is (a best-first list plus one emission, a restart [em,
    BIG, ...] or the BIG start); neither is checked here."""
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.utils import profiling

    if cands.edge.dim() != 2:
        raise ValueError(f"the lattice forward kernel: expected candidates "
                         f"[T, K], got {tuple(cands.edge.shape)}")
    T, K = (int(x) for x in cands.edge.shape)
    R = int(num_paths)
    plan = lattice_plan(T, K, R)
    dev = cands.edge.device
    ce, co, cd, cv = (x.contiguous() for x in cands)
    tab = [tables[k].contiguous() for k in ("edge_len", "reach_row",
                                            "reach_to", "reach_dist")]
    scores = torch.empty((T, K * R), dtype=torch.float32, device=dev)
    backptrs = torch.empty((T, K * R), dtype=torch.int32, device=dev)
    started = torch.empty((T,), dtype=torch.bool, device=dev)
    own = torch.empty((T,), dtype=torch.int32, device=dev)
    active = torch.empty((T,), dtype=torch.bool, device=dev)
    scratch = None if not plan["scratch_bytes"] else torch.empty(
        plan["scratch_bytes"], dtype=torch.uint8, device=dev)
    # a span of a device_trace capture (a no-op outside one)
    with profiling.annotate("lattice_forward_kernel"):
        build.launch_lattice_forward(
            ce, co, cd, cv, points.contiguous(), keep.contiguous(), *tab, R,
            plan, 2.0 * sigma_z ** 2, beta, max_route_factor,
            breakage_distance, backward_slack, scratch, scores, backptrs,
            started, own, active)
    _count("forward" if K <= LATTICE_MAX_K else "forward:wide")
    return scores, backptrs, started, own, active


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
    kernel (a path a thread, the levels streamed through shared memory or
    read in place: ``backtrack_plan``) on the current stream of the
    tensors' card: allocates the states, launches
    (``build.launch_lattice_backtrack`` checks the tensors) and counts
    the launch. The kernel's bulk copies read the four level arrays from
    16-aligned addresses: one that is not (a view) is cloned first."""
    from reporter_tpu_torch.kernels import build

    T, S = (int(x) for x in backptrs.shape)
    P = int(seed.shape[0])
    states = torch.empty((P, T), dtype=torch.int32, device=backptrs.device)
    if P == 0 or T == 0:
        return states
    plan = backtrack_plan(T, S, P)
    levels = []
    for x in (backptrs, started, active, own):
        x = x.contiguous()
        levels.append(x.clone() if x.data_ptr() % 16 else x)
    build.launch_lattice_backtrack(*levels, seed.contiguous(), plan, states)
    _count(backtrack_key(plan))
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
    scores, backptrs, started, own, active = _forward_list(
        cands, points, keep, tables, sigma_z, beta, max_route_factor,
        breakage_distance, backward_slack, 1)
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
    scores, backptrs, started, own, active = _forward_list(
        cands, points, keep, tables, sigma_z, beta, max_route_factor,
        breakage_distance, backward_slack, R)
    final = scores[-1]
    order = torch.sort(final, stable=True).indices[:R]      # best R states
    rank_score = final[order]
    rank_valid = rank_score < BIG
    states = _backtrack(backptrs, started, active, own,
                        order.to(torch.int32))
    choices = torch.where(states >= 0, states // R, -1)
    return torch.where(rank_valid[:, None], choices, -1).to(torch.int32), \
        rank_score, rank_valid
