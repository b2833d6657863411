"""What the entries share: the program's objects built from a cell's numpy inputs,
and the program's claims of a delivered proposal.

This is the one place besides ``entries/<entry>.py`` that imports the
program, ``cruise_control_tpu_torch``: its public constructors
(``model.bridge.arrays_from_numpy``, ``model.arrays.stack_arrays``,
``GoalContext.build``, ``BalancingConstraint.default``) and, once the window
has closed, its snapshot (``analyzer.context.take_snapshot``) of each
delivered placement, which the reference's sums are held against.  A stack's
snapshot is taken twice: in lane form, as the batched solve takes each
round's snapshot and its final violation pass, and lane by lane inside the
program's lift (``analyzer.lanes.lift``), where the segment sums go through
the batching rule that a lifted round's counts take
(``ops.segments.stacked_segment_sums``).  Both are recomputed from the
delivered placement: the sums inside the captured goal graphs are not read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer import lanes as LN
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import GoalContext, pad_context_brokers, take_snapshot
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.model.bridge import arrays_from_numpy

from portbench.reference.compare import Claim
from portbench.reference.judge import Placement, Sums

FIELDS = (
    "replica_partition", "replica_broker", "replica_disk", "replica_valid", "base_load",
    "original_broker", "partition_topic", "partition_leader", "leadership_delta",
    "broker_rack", "broker_host", "broker_capacity", "broker_alive", "broker_new",
    "broker_demoted", "disk_broker", "disk_capacity", "disk_alive",
)


@dataclasses.dataclass
class Delivered:
    """One proposal as the window delivered it: the input it answers, its
    lane, the placement on the host, and the program's own report of it."""

    input_index: int
    lane: int
    placement: Placement
    violations: Dict[str, float]
    inter_broker_moves: int
    data_moved: float
    leadership_moves: int


@dataclasses.dataclass
class Call:
    """One entry call of the window: its proposals and the host waits it took."""

    input_index: int
    proposals: List[Delivered]
    num_host_syncs: int


def goal_ids(names: Sequence[str]) -> tuple:
    return tuple(G.GOAL_ID_BY_NAME[n] for n in names)


def constraint(c: Mapping, device) -> BalancingConstraint:
    """The configuration's balancing constraint as the program's object."""
    res = list(Resource)
    return BalancingConstraint.default(
        resource_balance_threshold={r: float(v) for r, v in zip(res, c["balance_threshold"])},
        resource_capacity_threshold={r: float(v) for r, v in zip(res, c["capacity_threshold"])},
        low_utilization_threshold={r: float(v) for r, v in zip(res, c["low_utilization_threshold"])},
        replica_balance_threshold=float(c["replica_balance_threshold"]),
        leader_replica_balance_threshold=float(c["leader_replica_balance_threshold"]),
        topic_replica_balance_threshold=float(c["topic_replica_balance_threshold"]),
        max_replicas_per_broker=int(c["max_replicas_per_broker"]),
        distribution_threshold_multiplier=float(c["distribution_threshold_multiplier"]),
        balance_margin=float(c["balance_margin"]),
        min_topic_leaders_per_broker=int(c["min_topic_leaders_per_broker"]),
        topic_replica_balance_min_gap=int(c["topic_replica_balance_min_gap"]),
        topic_replica_balance_max_gap=int(c["topic_replica_balance_max_gap"]),
        device=device,
    )


def context(arrays: Mapping, config: Mapping, device) -> GoalContext:
    B = arrays["broker_rack"].shape[-1]
    return GoalContext.build(
        int(arrays["num_topics"]), B, constraint=constraint(config["constraint"], device),
        min_leader_topic_ids=list(config["constraint"].get("min_topic_leader_topics", [])),
        device=device,
    )


def state(arrays: Mapping, device):
    """The program's ``ClusterArrays`` of one input's arrays."""
    return arrays_from_numpy(
        {k: arrays[k] for k in FIELDS}, num_racks=arrays["num_racks"],
        num_topics=arrays["num_topics"], num_hosts=arrays["num_hosts"], device=device,
    )


def stack(lanes: Sequence[Mapping], device):
    """The program's stack of a batched input's lanes, on the device in one copy a field."""
    return A.stack_arrays([state(a, "cpu") for a in lanes]).to(device)


def with_placement(base, replica_broker, replica_disk, partition_leader):
    """``base`` (a state or a stack) with a delivered placement in place."""
    dev = base.device
    return base.replace(
        replica_broker=torch.as_tensor(replica_broker, dtype=torch.int32).to(dev),
        replica_disk=torch.as_tensor(replica_disk, dtype=torch.int32).to(dev),
        partition_leader=torch.as_tensor(partition_leader, dtype=torch.int32).to(dev),
    )


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


SUMS = ("broker_load", "potential_nw_out", "leader_nw_in", "replica_counts", "leader_counts",
        "rack_counts", "topic_counts", "topic_leader_counts")


def snapshot_sums(st, ctx: GoalContext, heavy: bool, goals: Sequence[int], lifted: bool = False) -> List[Sums]:
    """The program's snapshot sums of ``st`` (one state, padded to the
    broker bucket as ``optimize`` pads it, or a stack in lane form, as the
    batched solve takes it), one :class:`Sums` a lane, at the real brokers.
    ``lifted``: a stack's snapshot taken lane by lane inside ``lanes.lift``."""
    lanes = A.lanes_of(st)
    B = st.num_brokers
    if lanes is None:
        bucket = A.broker_bucket(B)
        st, ctx = A.pad_brokers(st, bucket), pad_context_brokers(ctx, bucket)
    needs = G.violation_needs(goals)
    if lifted:
        def one(s, _):
            snap = take_snapshot(s, ctx, heavy, needs)
            return {k: getattr(snap, k) for k in SUMS if getattr(snap, k) is not None}

        fields = LN.lift(one, st, None)
    else:
        snap = take_snapshot(st, ctx, heavy, needs)
        fields = {k: getattr(snap, k) for k in SUMS}
    got = {k: (host(fields[k]) if fields.get(k) is not None else None) for k in SUMS}
    out = []
    for i in range(lanes or 1):
        one = {}
        for k, v in got.items():
            if v is None:
                one[k] = None
                continue
            v = v[i] if lanes is not None else v
            one[k] = v if k == "rack_counts" else v[:B]
        out.append(Sums(**one))
    return out


def claims(calls: Sequence[Call], base_states: Sequence, ctx: GoalContext, heavy: bool,
           goals: Sequence[int], lanes: Optional[int]) -> List[List[Claim]]:
    """Every delivered proposal's claims, call by call: its report and the
    program's snapshot sums of its placement (one snapshot a call, and for a
    stack one more inside the lift)."""
    out = []
    for call in calls:
        base = base_states[call.input_index]
        if lanes is None:
            (p,) = call.proposals
            st = with_placement(base, p.placement.replica_broker, p.placement.replica_disk,
                                p.placement.partition_leader)
        else:
            st = with_placement(
                base,
                np.stack([p.placement.replica_broker for p in call.proposals]),
                np.stack([p.placement.replica_disk for p in call.proposals]),
                np.stack([p.placement.partition_leader for p in call.proposals]),
            )
        sums = snapshot_sums(st, ctx, heavy, goals)
        lifted = snapshot_sums(st, ctx, heavy, goals, lifted=True) if lanes is not None else [None] * len(sums)
        out.append([
            Claim(violations=p.violations, inter_broker_moves=p.inter_broker_moves,
                  data_moved=p.data_moved, leadership_moves=p.leadership_moves, sums=s, lifted_sums=ls)
            for p, s, ls in zip(call.proposals, sums, lifted)
        ])
    return out


def delivered(input_index: int, lane: int, rb, rd, pl, result) -> Delivered:
    """A :class:`Delivered` from host arrays and the program's ``OptimizerResult``."""
    mv = result.movement
    return Delivered(
        input_index=input_index, lane=lane,
        placement=Placement(replica_broker=rb, replica_disk=rd, partition_leader=pl),
        violations=dict(result.violations_after),
        inter_broker_moves=int(mv.num_inter_broker_moves),
        data_moved=float(mv.inter_broker_data_to_move),
        leadership_moves=int(mv.num_leadership_moves),
    )
