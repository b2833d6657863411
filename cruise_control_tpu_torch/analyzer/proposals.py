"""Execution proposals and placement diffing.

Port of ``cruise_control_tpu/analyzer/proposals.py``, the counterpart of ``executor/ExecutionProposal.java`` and ``AnalyzerUtils.getDiff``
(``analyzer/AnalyzerUtils.java:47,63``): after the solver finishes, the initial and
final placements are compared per partition and every difference becomes an
:class:`ExecutionProposal` with the old/new ordered replica lists (new leader first,
matching the reference's convention that ``newReplicas.get(0)`` is the new leader).

Diffing runs host-side on numpy copies of the tensors: it happens once per optimization,
far off the hot path, and needs the string/topic maps anyway.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.model.cluster import IndexMaps, TopicPartition


@dataclasses.dataclass(frozen=True)
class ExecutionProposal:
    """One partition's placement change (ExecutionProposal.java)."""

    tp: TopicPartition
    partition_size: float                 # DISK utilization, for movement strategies
    old_leader: Optional[int]             # broker id
    old_replicas: Tuple[int, ...]         # ordered broker ids, old leader first
    new_replicas: Tuple[int, ...]         # ordered broker ids, new leader first

    @property
    def new_leader(self) -> Optional[int]:
        return self.new_replicas[0] if self.new_replicas else None

    @property
    def replicas_to_add(self) -> Tuple[int, ...]:
        old = set(self.old_replicas)
        return tuple(b for b in self.new_replicas if b not in old)

    @property
    def replicas_to_remove(self) -> Tuple[int, ...]:
        new = set(self.new_replicas)
        return tuple(b for b in self.old_replicas if b not in new)

    @property
    def has_replica_action(self) -> bool:
        return set(self.old_replicas) != set(self.new_replicas)

    @property
    def has_leader_action(self) -> bool:
        return self.old_leader != self.new_leader

    @property
    def inter_broker_data_to_move(self) -> float:
        return self.partition_size * len(self.replicas_to_add)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _placement(
    state: ClusterArrays, maps: IndexMaps
) -> Tuple[Dict[int, List[Tuple[int, int]]], Dict[int, int]]:
    """partition -> [(replica_row, broker_index)] and partition -> leader broker index."""
    rp = _np(state.replica_partition)
    rb = _np(state.replica_broker)
    valid = _np(state.replica_valid)
    leader = _np(state.partition_leader)
    by_partition: Dict[int, List[Tuple[int, int]]] = {}
    for row in np.nonzero(valid)[0]:
        by_partition.setdefault(int(rp[row]), []).append((int(row), int(rb[row])))
    leader_broker = {
        p: int(rb[leader[p]]) if leader[p] >= 0 else -1 for p in range(len(leader))
    }
    return by_partition, leader_broker


def diff(
    initial: ClusterArrays, final: ClusterArrays, maps: IndexMaps
) -> List[ExecutionProposal]:
    """Placement differences between two snapshots of the same topology.

    Mirrors ``AnalyzerUtils.getDiff``: a proposal is emitted for every partition whose
    replica broker-set or leader changed.  Replica order: new leader first, then the
    remaining replicas in replica-row order (stable across the diff).
    """
    if initial.num_partitions != final.num_partitions or initial.num_replicas != final.num_replicas:
        raise ValueError("diff requires snapshots of the same topology")
    init_parts, init_leader = _placement(initial, maps)
    fin_parts, fin_leader = _placement(final, maps)

    # partition size = leader's disk utilization in the initial state
    eff_disk = _np(initial.base_load)[:, Resource.DISK]
    init_leader_row = _np(initial.partition_leader)

    proposals: List[ExecutionProposal] = []
    for p, tp in enumerate(maps.partitions):
        old = init_parts.get(p, [])
        new = fin_parts.get(p, [])
        old_brokers = [b for _, b in old]
        new_brokers = [b for _, b in new]
        old_lead = init_leader.get(p, -1)
        new_lead = fin_leader.get(p, -1)
        if set(old_brokers) == set(new_brokers) and old_lead == new_lead:
            continue

        def _ordered(pairs: List[Tuple[int, int]], leader_broker: int) -> Tuple[int, ...]:
            brokers = [b for _, b in pairs]
            if leader_broker in brokers:
                brokers.remove(leader_broker)
                brokers.insert(0, leader_broker)
            return tuple(maps.broker_ids[b] for b in brokers)

        lead_row = int(init_leader_row[p])
        if lead_row >= 0:
            size = float(eff_disk[lead_row])
        else:
            size = float(sum(eff_disk[row] for row, _ in old)) / max(len(old), 1)
        proposals.append(
            ExecutionProposal(
                tp=tp,
                partition_size=size,
                old_leader=maps.broker_ids[old_lead] if old_lead >= 0 else None,
                old_replicas=_ordered(old, old_lead),
                new_replicas=_ordered(new, new_lead),
            )
        )
    return proposals


def logdir_moves(
    initial: ClusterArrays, final: ClusterArrays, maps: IndexMaps
) -> Dict[Tuple[TopicPartition, int], str]:
    """Intra-broker logdir changes between two snapshots.

    {(topic-partition, broker_id) -> destination logdir} for every replica whose
    broker is unchanged but whose disk assignment moved — the executor feeds these
    to ``alter_replica_logdirs`` in its intra-broker phase
    (Executor.intraBrokerMoveReplicas, Executor.java:1679).
    """
    out: Dict[Tuple[TopicPartition, int], str] = {}
    if initial.num_disks == 0:
        return out
    rb0 = _np(initial.replica_broker)
    rb1 = _np(final.replica_broker)
    rd0 = _np(initial.replica_disk)
    rd1 = _np(final.replica_disk)
    rp = _np(final.replica_partition)
    valid = _np(final.replica_valid)
    changed = valid & (rb0 == rb1) & (rd0 != rd1) & (rd1 >= 0)
    for row in np.nonzero(changed)[0]:
        tp = maps.partitions[int(rp[row])]
        broker_id = maps.broker_ids[int(rb1[row])]
        _, logdir = maps.disks[int(rd1[row])]
        out[(tp, broker_id)] = logdir
    return out
