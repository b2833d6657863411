"""Kafka-assigner compatibility mode: even, rack-aware full placement.

Port of ``cruise_control_tpu/analyzer/kafka_assigner.py`` (the reference's
``kafkaassigner/KafkaAssignerEvenRackAwareGoal.java``).  Unlike every other
goal this is a constructive assignment: walking replica positions
0..maxRF-1 (position 0 = leader) and, per position, giving each partition's
replica to the eligible broker with the fewest replicas already at that
position (ties to the lowest broker id), skipping brokers whose rack already
hosts an earlier position of the same partition.  Partitions are visited in
index order.

Each position pass is one call of :func:`ops.assign.even_assign`, which on
the card is one launch of the hand-written ``csrc/even_assign.cu`` (the JAX
package's per-position ``lax.scan``).  Excluded topics keep their placement
and pre-seed the per-position counts; dead and move-excluded brokers are never
destinations, and leadership-excluded brokers are barred from position 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.ops.assign import even_assign
from cruise_control_tpu_torch.ops.index import fresh_index_put, segment_min
from cruise_control_tpu_torch.ops.segments import segment_sums

I32 = torch.int32
_INT32_MAX = 2**31 - 1


def replica_positions(state: ClusterArrays) -> torch.Tensor:
    """i32[R] (i32[S, R] of a stack): position of each replica within its
    partition -- leader 0, followers 1.. in replica-row order; -1 for invalid
    rows.  A stack sorts as one: each lane's partitions are offset past the
    last lane's."""
    R = state.num_replicas
    dev = state.device
    rows = torch.arange(R, dtype=torch.int64, device=dev)
    lead = A.is_leader(state)
    part = torch.where(state.replica_valid, state.replica_partition, state.num_partitions).long()
    lanes = A.lanes_of(state)
    if lanes is not None:
        part = (torch.arange(lanes, device=dev)[:, None] * (state.num_partitions + 1) + part).reshape(-1)
        lead = lead.reshape(-1)
        rows = rows.repeat(lanes)
    # partition-major, leader first, then row order: one unique int64 key
    key = (part * 2 + (~lead).long()) * R + rows
    order = torch.argsort(key)
    ps = part[order]
    # rank within the partition group: index minus the group's first index
    n = ps.shape[0]
    flat = rows if lanes is None else torch.arange(n, dtype=torch.int64, device=dev)
    rank = flat - torch.searchsorted(ps, ps, right=False)
    pos = fresh_index_put(torch.empty(n, dtype=I32, device=dev), order, rank.to(I32))
    return torch.where(state.replica_valid, pos.view(state.replica_valid.shape), -1)


def even_rack_aware_assign(
    state: ClusterArrays, ctx, max_rf: int
) -> Tuple[ClusterArrays, torch.Tensor, torch.Tensor]:
    """The full placement mode: ``(new_state, num_moves, num_unassigned)``,
    the counts as 0-d int32 tensors (``[S]`` of a stack).

    ``num_unassigned`` counts replica slots for which even the relaxed
    (rack-ignoring) pass found no eligible broker; those replicas keep their
    old placement.  Leadership lands on the position-0 broker: the leader row
    is position 0, so ``partition_leader`` is unchanged and only brokers move.

    A stack (``model.arrays.stack_arrays``) is placed as the JAX package's
    vmap places it: every lane runs the same ``max_rf`` position passes, each
    pass one :func:`ops.assign.even_assign` call for every lane."""
    P, B = state.num_partitions, state.num_brokers
    dev = state.device
    L = A.lanes_of(state)
    lead = A.lane_shape(state)
    rp, rb = state.replica_partition, state.replica_broker
    pos = replica_positions(state)
    valid = state.replica_valid
    excluded_part = ctx.excluded_topics[state.partition_topic].contiguous()
    excluded_rep = valid & A.take(excluded_part, rp, L)
    # replicas per partition, and every position's counts pre-seeded with the
    # excluded topics' replicas: one integer segment-sum call each
    (rf,) = A.lane_segment_sums([valid], rp, P, L)
    seeded = excluded_rep & (pos >= 0) & (pos < max_rf)
    (counts,) = A.lane_segment_sums([seeded], torch.where(seeded, pos * B + rb, -1), max_rf * B, L)
    counts = counts.view(lead + (max_rf, B))
    if L is not None:
        counts = counts.transpose(0, 1).contiguous()   # [max_rf, S, B]: a pass's lanes contiguous
    chosen = torch.full(lead + (P, max_rf), -1, dtype=I32, device=dev)
    move_ok = state.broker_alive & ~ctx.excluded_for_replica_move
    rack = state.broker_rack.to(I32).contiguous()
    for p in range(max_rf):
        eligible = (move_ok & ~ctx.excluded_for_leadership) if p == 0 else move_ok
        even_assign(counts[p], chosen, p, rf, excluded_part, rack, eligible.contiguous())

    slot = torch.clamp(pos, 0, max_rf - 1)
    if L is None:
        pick = chosen[rp.long(), slot.long()]
    else:
        pick = A.take(chosen.flatten(-2), rp * max_rf + slot, L)
    movable = valid & (pos >= 0) & (pick >= 0)
    new_broker = torch.where(movable, pick, rb)
    moves = (new_broker != rb).sum(dim=-1, dtype=I32)
    # slots the passes should have filled but could not (no eligible broker
    # even with the rack rule relaxed): non-excluded replicas left in place
    should_fill = valid & (pos >= 0) & (pos < max_rf) & ~excluded_rep
    unassigned = (should_fill & (pick < 0)).sum(dim=-1, dtype=I32)

    new_state = state.replace(replica_broker=new_broker)
    if state.num_disks:
        # JBOD: a moved replica lands on the lowest alive disk of its new broker
        disk_ids = torch.arange(state.num_disks, dtype=I32, device=dev)
        first_alive = segment_min(
            torch.where(state.disk_alive, disk_ids, _INT32_MAX), state.disk_broker, B, L
        )
        first_alive = torch.where(first_alive == _INT32_MAX, -1, first_alive)
        moved = new_broker != rb
        new_disk = torch.where(moved, A.take(first_alive, new_broker.long(), L), state.replica_disk)
        new_state = new_state.replace(replica_disk=new_disk)
    return new_state, moves, unassigned
