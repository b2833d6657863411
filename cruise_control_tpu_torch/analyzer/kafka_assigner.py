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
from cruise_control_tpu_torch.ops.index import segment_min
from cruise_control_tpu_torch.ops.segments import segment_sums

I32 = torch.int32
_INT32_MAX = 2**31 - 1


def replica_positions(state: ClusterArrays) -> torch.Tensor:
    """i32[R]: position of each replica within its partition -- leader 0,
    followers 1.. in replica-row order; -1 for invalid rows."""
    R = state.num_replicas
    dev = state.device
    rows = torch.arange(R, dtype=torch.int64, device=dev)
    lead = A.is_leader(state)
    part = torch.where(state.replica_valid, state.replica_partition, state.num_partitions).long()
    # partition-major, leader first, then row order: one unique int64 key
    key = (part * 2 + (~lead).long()) * R + rows
    order = torch.argsort(key)
    ps = part[order]
    # rank within the partition group: index minus the group's first index
    rank = rows - torch.searchsorted(ps, ps, right=False)
    pos = torch.empty(R, dtype=I32, device=dev)
    pos[order] = rank.to(I32)
    return torch.where(state.replica_valid, pos, -1)


def even_rack_aware_assign(
    state: ClusterArrays, ctx, max_rf: int
) -> Tuple[ClusterArrays, torch.Tensor, torch.Tensor]:
    """The full placement mode: ``(new_state, num_moves, num_unassigned)``,
    the counts as 0-d int32 tensors.

    ``num_unassigned`` counts replica slots for which even the relaxed
    (rack-ignoring) pass found no eligible broker; those replicas keep their
    old placement.  Leadership lands on the position-0 broker: the leader row
    is position 0, so ``partition_leader`` is unchanged and only brokers move.
    """
    P, B = state.num_partitions, state.num_brokers
    dev = state.device
    rp, rb = state.replica_partition, state.replica_broker
    pos = replica_positions(state)
    valid = state.replica_valid
    excluded_part = ctx.excluded_topics[state.partition_topic].contiguous()
    excluded_rep = valid & excluded_part[rp]
    # replicas per partition, and every position's counts pre-seeded with the
    # excluded topics' replicas: one integer segment-sum call each
    (rf,) = segment_sums([valid], rp, P)
    seeded = excluded_rep & (pos >= 0) & (pos < max_rf)
    (counts,) = segment_sums([seeded], torch.where(seeded, pos * B + rb, -1), max_rf * B)
    counts = counts.view(max_rf, B)
    chosen = torch.full((P, max_rf), -1, dtype=I32, device=dev)
    move_ok = state.broker_alive & ~ctx.excluded_for_replica_move
    rack = state.broker_rack.to(I32).contiguous()
    for p in range(max_rf):
        eligible = (move_ok & ~ctx.excluded_for_leadership) if p == 0 else move_ok
        even_assign(counts[p], chosen, p, rf, excluded_part, rack, eligible.contiguous())

    pick = chosen[rp.long(), torch.clamp(pos, 0, max_rf - 1).long()]
    movable = valid & (pos >= 0) & (pick >= 0)
    new_broker = torch.where(movable, pick, rb)
    moves = (new_broker != rb).sum(dtype=I32)
    # slots the passes should have filled but could not (no eligible broker
    # even with the rack rule relaxed): non-excluded replicas left in place
    should_fill = valid & (pos >= 0) & (pos < max_rf) & ~excluded_rep
    unassigned = (should_fill & (pick < 0)).sum(dtype=I32)

    new_state = state.replace(replica_broker=new_broker)
    if state.num_disks:
        # JBOD: a moved replica lands on the lowest alive disk of its new broker
        disk_ids = torch.arange(state.num_disks, dtype=I32, device=dev)
        first_alive = segment_min(
            torch.where(state.disk_alive, disk_ids, _INT32_MAX), state.disk_broker, B
        )
        first_alive = torch.where(first_alive == _INT32_MAX, -1, first_alive)
        moved = new_broker != rb
        new_disk = torch.where(moved, first_alive[new_broker.long()], state.replica_disk)
        new_state = new_state.replace(replica_disk=new_disk)
    return new_state, moves, unassigned
