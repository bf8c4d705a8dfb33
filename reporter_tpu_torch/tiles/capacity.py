"""Device-memory capacity planning for one card.

Counterpart: reporter_tpu/tiles/capacity.py. Decides, for a compiled
TileSet and a device memory budget, whether the matcher stages the whole
map on one card (replicated: no collective in candidate search) or the
segment table must be sharded over several.

It plans over the bytes the port's dense path stages
(``tables_from_numpy(..., "dense")``, which ``SegmentMatcher.table_bytes``
counts): the segment pack with its bboxes, slice quads, coarse-pass rows,
the exact arms' ``seg_sweep`` and the gates' ``seg_coarse`` (the
shardable share), and the per-edge and reach arrays (the fixed share,
which every shard's Viterbi needs). The JAX package's fixed share also
counts ``edge_osmlr``, which its layout stages and the port's does not
(the port's walk reads it on the host).

``DEFAULT_HBM_BUDGET`` is 60 GiB: three quarters of an H100's 80 GB,
leaving the rest to the allocator's workspace, the batch's temporaries
(the Viterbi's and the sweep's) and the wire arrays; the JAX package
keeps the same share of its chip. A segment-sharded plan runs through
``parallel.sharded_candidates.shard_tables`` over ``shards`` cards.
"""

from __future__ import annotations

from typing import NamedTuple

from reporter_tpu_torch.tiles.tileset import TileSet

# three quarters of one H100's 80 GB
DEFAULT_HBM_BUDGET = 60 * 1024**3


class StagingPlan(NamedTuple):
    strategy: str          # "replicated" | "segment-sharded"
    shards: int            # cards needed on the sharding axis (1 ⇒
    #                        replicated)
    table_bytes: int       # dense-path staged bytes, unsharded
    shardable_bytes: int   # the segment-table share (what sharding divides)
    fixed_bytes: int       # the share every card holds (reach + per-edge)
    budget_bytes: int
    bytes_per_edge: float  # table_bytes / directed edges
    edge_capacity: int     # directed edges that fit replicated in budget

    def to_json(self) -> dict:
        return {**self._asdict(),
                "bytes_per_edge": round(self.bytes_per_edge, 1)}


def dense_staged_bytes(ts: TileSet) -> "tuple[int, int]":
    """(shardable, fixed) device bytes of the port's dense tables, from
    shapes alone (rebuilding the Morton pack takes seconds at metro
    scale). Their sum equals ``SegmentMatcher(ts).table_bytes`` exactly.

    shardable: build_seg_pack's layout over S_pad packed columns (after
    the long-segment split) and S_pad / 512 blocks: seg_pack, seg_feat
    and seg_sweep, 8 f32 per column each; seg_bbox, 4 f32 per block;
    seg_sub, 4 f32 per slice; seg_coarse, CO_WORDS i32 per block.
    fixed: edge_len, edge_reach_row, reach_to, reach_dist."""
    from reporter_tpu_torch.ops.dense_candidates import (
        _SBLK, _SUB, CO_WORDS, SF_NCOMP, SP_NCOMP, SW_NCOMP, packed_columns)

    spad = packed_columns(ts.seg_len)
    nblocks = spad // _SBLK
    nsub = _SBLK // _SUB if _SUB and _SBLK % _SUB == 0 else 1
    shardable = ((SP_NCOMP + SF_NCOMP + SW_NCOMP) * spad
                 + nblocks * 4 * (1 + nsub) + nblocks * CO_WORDS) * 4
    fixed = int(ts.edge_len.nbytes + ts.edge_reach_row.nbytes
                + ts.reach_to.nbytes + ts.reach_dist.nbytes)
    return int(shardable), fixed


def plan_staging(ts: TileSet, budget_bytes: int = DEFAULT_HBM_BUDGET,
                 ) -> StagingPlan:
    """Staging plan for one card (or one shard axis). Raises ValueError
    when even a fully sharded layout cannot fit: the fixed share alone
    over budget (then shard by metro, parallel/multimetro, or narrow
    reach_max)."""
    shardable, fixed = dense_staged_bytes(ts)
    total = shardable + fixed
    per_edge = total / max(ts.num_edges, 1)
    capacity = int(budget_bytes / per_edge) if per_edge else 0
    if total <= budget_bytes:
        return StagingPlan("replicated", 1, total, shardable, fixed,
                           int(budget_bytes), per_edge, capacity)
    headroom = budget_bytes - fixed
    if headroom <= 0:
        raise ValueError(
            f"tileset {ts.name!r}: replicated share {fixed} B alone "
            f"exceeds the {budget_bytes} B budget — segment sharding "
            "cannot help; shard by metro or narrow reach_max")
    shards = -(-shardable // headroom)          # ceil division
    return StagingPlan("segment-sharded", int(shards), total, shardable,
                       fixed, int(budget_bytes), per_edge, capacity)
