"""Dense tensor form of the cluster model.

Port of ``cruise_control_tpu/model/arrays.py``: the topology flattens into
fixed-shape integer/float tensors, so every analyzer operation is a gather, a
segment sum or a scatter.  Leadership is an index array (``partition_leader``)
and a replica's effective load is ``base_load + is_leader * leadership_delta``,
so moving leadership changes one index and no load bookkeeping.

Axes: R = replicas (``replica_valid`` masks padding), P = partitions,
B = brokers, T = topics, D = disks (JBOD logdirs; D may be 0).  Integer
tensors are int32 and float tensors float32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.core.resources import (
    NUM_DERIVED_RESOURCES,
    NUM_RESOURCES,
    DerivedResource,
    Resource,
)
from cruise_control_tpu_torch.ops.index import lane_ids, scatter_set
from cruise_control_tpu_torch.ops.segments import segment_sum as _segment_sum
from cruise_control_tpu_torch.ops.segments import segment_sums as _segment_sums
from cruise_control_tpu_torch.ops.segments import stacked_segment_sums

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass
class ClusterArrays:
    """Flattened cluster state: a dataclass of tensors on one device."""

    # replica axis
    replica_partition: torch.Tensor   # i32[R]
    replica_broker: torch.Tensor      # i32[R]
    replica_disk: torch.Tensor        # i32[R], -1 when not JBOD
    replica_valid: torch.Tensor       # bool[R] padding / existence mask
    base_load: torch.Tensor           # f32[R, 4] follower-equivalent load
    original_broker: torch.Tensor     # i32[R] broker at snapshot time

    # partition axis
    partition_topic: torch.Tensor     # i32[P]
    partition_leader: torch.Tensor    # i32[P] replica index of current leader
    leadership_delta: torch.Tensor    # f32[P, 4] load that travels with leadership

    # broker axis
    broker_rack: torch.Tensor         # i32[B]
    broker_host: torch.Tensor         # i32[B]
    broker_capacity: torch.Tensor     # f32[B, 4]
    broker_alive: torch.Tensor        # bool[B]
    broker_new: torch.Tensor          # bool[B]
    broker_demoted: torch.Tensor      # bool[B]

    # disk axis (JBOD; zero-length tensors when not configured)
    disk_broker: torch.Tensor         # i32[D]
    disk_capacity: torch.Tensor       # f32[D]
    disk_alive: torch.Tensor          # bool[D]

    # static metadata
    num_racks: int = 0
    num_topics: int = 0
    num_hosts: int = 0

    # the sizes read the trailing axis: one state's, or every lane's of a
    # :func:`stack_arrays` stack

    @property
    def num_replicas(self) -> int:
        return self.replica_partition.shape[-1]

    @property
    def num_partitions(self) -> int:
        return self.partition_topic.shape[-1]

    @property
    def num_brokers(self) -> int:
        return self.broker_rack.shape[-1]

    @property
    def num_disks(self) -> int:
        return self.disk_broker.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.replica_broker.device

    def replace(self, **changes) -> "ClusterArrays":
        return dataclasses.replace(self, **changes)

    def to(self, device: DeviceLike) -> "ClusterArrays":
        dev = resolve_device(device)
        return self.replace(**{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    def replica_offline_mask(self) -> torch.Tensor:
        """bool[R] (bool[S, R] of a :func:`stack_arrays` stack): valid replicas
        on a dead broker or a dead JBOD disk."""
        dead_broker = ~torch.gather(self.broker_alive, -1, self.replica_broker.long())
        if self.disk_broker.shape[-1] > 0:
            on_disk = self.replica_disk >= 0
            disk_idx = torch.where(on_disk, self.replica_disk, 0).long()
            dead_disk = on_disk & ~torch.gather(self.disk_alive, -1, disk_idx)
        else:
            dead_disk = torch.zeros_like(dead_broker)
        return (dead_broker | dead_disk) & self.replica_valid


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


# ---------------------------------------------------------------------------
# Queries.
# ---------------------------------------------------------------------------


def is_leader(state: ClusterArrays) -> torch.Tensor:
    """bool[R] (bool[S, R] of a stack): whether each replica currently leads
    its partition."""
    lanes = lanes_of(state)
    return (
        take(state.partition_leader, state.replica_partition, lanes)
        == _iota(state.num_replicas, state.device)
    ) & state.replica_valid


def effective_load(state: ClusterArrays) -> torch.Tensor:
    """f32[R, 4] (f32[S, R, 4] of a stack): per-replica load given current
    leadership."""
    lead = is_leader(state)
    delta = take(state.leadership_delta, state.replica_partition, lanes_of(state))
    load = state.base_load + torch.where(lead[..., None], delta, 0.0)
    return torch.where(state.replica_valid[..., None], load, 0.0)


def broker_load(state: ClusterArrays) -> torch.Tensor:
    """f32[B, 4]: total utilization per broker."""
    return _segment_sum(effective_load(state), state.replica_broker, state.num_brokers)


def host_load(state: ClusterArrays) -> torch.Tensor:
    """f32[H, 4]: total utilization per host."""
    return _segment_sum(broker_load(state), state.broker_host, state.num_hosts)


def broker_replica_counts(state: ClusterArrays) -> torch.Tensor:
    """i32[B]: replicas hosted per broker."""
    return _segment_sums([state.replica_valid], state.replica_broker, state.num_brokers)[0]


def broker_leader_counts(state: ClusterArrays) -> torch.Tensor:
    """i32[B]: leader replicas per broker."""
    return _segment_sums([is_leader(state)], state.replica_broker, state.num_brokers)[0]


def potential_nw_out(state: ClusterArrays) -> torch.Tensor:
    """f32[B]: outbound network if every hosted replica became leader."""
    leader_nw_out = (
        state.base_load[:, Resource.NW_OUT]
        + state.leadership_delta[state.replica_partition, Resource.NW_OUT]
    )
    leader_nw_out = torch.where(state.replica_valid, leader_nw_out, 0.0)
    return _segment_sum(leader_nw_out, state.replica_broker, state.num_brokers)


def disk_load_terms(state: ClusterArrays):
    """``(du f32[R], disk i32[R])`` (``[S, R]`` each of a stack): each
    replica's disk use and the logdir it adds to in :func:`disk_load`
    (replicas off any logdir add 0 to disk 0)."""
    du = torch.where(state.replica_valid, state.base_load[..., Resource.DISK], 0.0)
    on_disk = state.replica_disk >= 0
    disk_idx = torch.where(on_disk, state.replica_disk, 0)
    return torch.where(on_disk, du, 0.0), disk_idx


def disk_load(state: ClusterArrays) -> torch.Tensor:
    """f32[D] (f32[S, D] of a stack): disk-space utilization per JBOD logdir."""
    lanes = lanes_of(state)
    if state.num_disks == 0:
        return torch.zeros(lane_shape(state) + (0,), dtype=F32, device=state.device)
    du, disk_idx = disk_load_terms(state)
    if lanes is None:
        return _segment_sum(du, disk_idx, state.num_disks)
    return lane_segment_sums([du], disk_idx, state.num_disks, lanes)[0]


def utilization_matrix(state: ClusterArrays) -> torch.Tensor:
    """f32[8, B]: the derived-resource utilization matrix (rows DISK, CPU,
    LEADER_NW_IN, FOLLOWER_NW_IN, NW_OUT, PNW_OUT, LEADER_REPLICAS, REPLICAS)."""
    eff = effective_load(state)
    lead = is_leader(state)
    B = state.num_brokers

    def seg(x):
        return _segment_sum(x, state.replica_broker, B)

    nw_in = eff[:, Resource.NW_IN]
    rows = torch.zeros((NUM_DERIVED_RESOURCES, B), dtype=F32, device=state.device)
    rows[DerivedResource.DISK] = seg(eff[:, Resource.DISK])
    rows[DerivedResource.CPU] = seg(eff[:, Resource.CPU])
    rows[DerivedResource.LEADER_NW_IN] = seg(torch.where(lead, nw_in, 0.0))
    rows[DerivedResource.FOLLOWER_NW_IN] = seg(torch.where(lead, 0.0, nw_in))
    rows[DerivedResource.NW_OUT] = seg(eff[:, Resource.NW_OUT])
    rows[DerivedResource.PNW_OUT] = potential_nw_out(state)
    rows[DerivedResource.LEADER_REPLICAS] = broker_leader_counts(state).to(F32)
    rows[DerivedResource.REPLICAS] = broker_replica_counts(state).to(F32)
    return rows


def topic_replica_counts_by_broker(state: ClusterArrays) -> torch.Tensor:
    """i32[B, T]: replicas of each topic on each broker."""
    topic = state.partition_topic[state.replica_partition]
    flat = state.replica_broker * state.num_topics + topic
    (counts,) = _segment_sums([state.replica_valid], flat, state.num_brokers * state.num_topics)
    return counts.reshape(state.num_brokers, state.num_topics)


def replicas_per_rack_per_partition(state: ClusterArrays) -> torch.Tensor:
    """i32[P, num_racks]: replica count of each partition in each rack."""
    rack = state.broker_rack[state.replica_broker]
    flat = state.replica_partition * state.num_racks + rack
    (counts,) = _segment_sums(
        [state.replica_valid], flat, state.num_partitions * state.num_racks
    )
    return counts.reshape(state.num_partitions, state.num_racks)


# ---------------------------------------------------------------------------
# Broker-axis bucketing.
# ---------------------------------------------------------------------------
#
# The broker axis is padded to a power-of-two ladder, as the JAX package does
# to share compiled programs; the port keeps the ladder so both packages solve
# the same padded problem (padding slots are dead, zero-capacity brokers that
# every kernel masks) and their placements compare one to one.

#: floor of the broker-shape bucket ladder
MIN_BROKER_BUCKET = 8


def broker_bucket(num_brokers: int) -> int:
    """Bucketed broker-axis size: next power of two >= ``num_brokers`` (min 8)."""
    n = max(int(num_brokers), MIN_BROKER_BUCKET)
    return 1 << (n - 1).bit_length()


def pad_brokers(state: ClusterArrays, num_brokers: int) -> ClusterArrays:
    """Pad the broker axis to ``num_brokers`` with inert slots: dead, zero
    capacity, a fresh host each and a round-robin rack.  Replica, partition
    and disk tensors are untouched."""
    B = state.num_brokers
    if num_brokers == B:
        return state
    if num_brokers < B:
        raise ValueError(f"pad_brokers: target {num_brokers} smaller than current {B}")
    pad = num_brokers - B
    dev = state.device
    extra = torch.arange(pad, dtype=I32, device=dev)
    false_pad = torch.zeros(pad, dtype=torch.bool, device=dev)
    return state.replace(
        broker_rack=torch.cat([state.broker_rack, (B + extra) % max(state.num_racks, 1)]),
        broker_host=torch.cat([state.broker_host, state.num_hosts + extra]),
        broker_capacity=torch.cat([
            state.broker_capacity,
            torch.zeros((pad, NUM_RESOURCES), dtype=F32, device=dev),
        ]),
        broker_alive=torch.cat([state.broker_alive, false_pad]),
        broker_new=torch.cat([state.broker_new, false_pad]),
        broker_demoted=torch.cat([state.broker_demoted, false_pad]),
        num_hosts=state.num_hosts + pad,
    )


def unpad_brokers(state: ClusterArrays, num_brokers: int, num_hosts: int) -> ClusterArrays:
    """Slice a broker-axis-padded state back to its logical size (the inverse
    of :func:`pad_brokers` while no replica moved onto a padding slot)."""
    if state.num_brokers == num_brokers:
        return state
    return state.replace(
        broker_rack=state.broker_rack[:num_brokers],
        broker_host=state.broker_host[:num_brokers],
        broker_capacity=state.broker_capacity[:num_brokers],
        broker_alive=state.broker_alive[:num_brokers],
        broker_new=state.broker_new[:num_brokers],
        broker_demoted=state.broker_demoted[:num_brokers],
        num_hosts=num_hosts,
    )


def stack_arrays(
    per: Sequence[ClusterArrays],
    goal_orders: Optional[Sequence[Sequence[int]]] = None,
) -> ClusterArrays:
    """Stack same-shape states into one with a leading scenario axis.

    Static fields must agree; ``goal_orders`` (one per state) must all be the
    same order, since one batched walk runs one goal sequence."""
    if not per:
        raise ValueError("stack_arrays needs at least one state")
    if goal_orders is not None:
        if len(goal_orders) != len(per):
            raise ValueError(
                f"stack_arrays: {len(per)} states but {len(goal_orders)} goal orders"
            )
        distinct = {tuple(int(g) for g in o) for o in goal_orders}
        if len(distinct) > 1:
            raise ValueError(
                f"stack_arrays: refusing to stack states with differing goal orders "
                f"{sorted(distinct)}; group states by goal order first"
            )
    fields = {}
    for f in dataclasses.fields(ClusterArrays):
        v0 = getattr(per[0], f.name)
        if not isinstance(v0, torch.Tensor):
            for k, p in enumerate(per):
                if getattr(p, f.name) != v0:
                    raise ValueError(
                        f"stack_arrays: static field {f.name!r} differs between "
                        f"state 0 ({v0!r}) and state {k} ({getattr(p, f.name)!r})"
                    )
            fields[f.name] = v0
            continue
        leaves = [getattr(p, f.name) for p in per]
        for k, leaf in enumerate(leaves):
            if leaf.shape != v0.shape:
                raise ValueError(
                    f"stack_arrays: leaf {f.name!r} shape mismatch: state 0 has "
                    f"{tuple(v0.shape)}, state {k} has {tuple(leaf.shape)}"
                )
        fields[f.name] = torch.stack(leaves)
    return ClusterArrays(**fields)


def index_arrays(states: ClusterArrays, i: int) -> ClusterArrays:
    """Select scenario ``i`` out of a :func:`stack_arrays` stack (views, no copy)."""
    return states.replace(**{
        f.name: getattr(states, f.name)[i]
        for f in dataclasses.fields(states)
        if isinstance(getattr(states, f.name), torch.Tensor)
    })


def num_lanes(states: ClusterArrays) -> int:
    """Lanes (scenarios) of a :func:`stack_arrays` stack (the sizes of
    ``ClusterArrays`` read the trailing axes, so they are every lane's)."""
    return states.replica_valid.shape[0]


# ---------------------------------------------------------------------------
# The lane axis.
# ---------------------------------------------------------------------------
#
# A stack evaluates as one program, as the JAX package's vmap does: every
# per-state operation takes a leading lane axis.  Elementwise operations
# broadcast over it; a gather takes each lane's own rows (:func:`take`); a
# segment reduction offsets each lane's ids past the last lane's segments
# (:func:`lane_ids`), so one kernel call covers every lane and each lane's
# rows keep their order.  The single-state forms (``lanes`` None) run the
# same operations as before the lane axis existed.


def lanes_of(state: ClusterArrays) -> Optional[int]:
    """The lane count of a :func:`stack_arrays` stack, None for one state."""
    return state.replica_valid.shape[0] if state.replica_valid.dim() == 2 else None


def lane_shape(state: ClusterArrays) -> tuple:
    """``()`` for one state, ``(S,)`` for a stack: the leading shape of
    every per-lane scalar."""
    return tuple(state.replica_valid.shape[:-1])


def is_shared(x: torch.Tensor) -> bool:
    """Whether ``x``'s lanes are one tensor expanded (stride 0 on the lane
    axis): the rollout's base leaves, the same for every pair."""
    return x.dim() > 1 and x.shape[0] > 1 and x.stride(0) == 0


def take(x: torch.Tensor, idx: torch.Tensor, lanes: Optional[int] = None) -> torch.Tensor:
    """``x[idx]`` along the state's first axis; for a stack (``lanes``) each
    lane's ``x[i][idx[i]]``, ``[S, *idx.shape[1:], *x.shape[2:]]``.  A lane
    axis that is one tensor expanded is gathered once, never copied per
    lane."""
    if lanes is None:
        return x[idx]
    xs, ids = is_shared(x), is_shared(idx)
    if xs and ids:
        out = x[0][idx[0]]
        return out.expand((lanes,) + tuple(out.shape))
    if ids:
        return x[:, idx[0]]
    if xs:
        return x[0][idx]
    lane = torch.arange(lanes, device=idx.device).view((lanes,) + (1,) * (idx.dim() - 1))
    return x[lane, idx]


def lane_segment_sums(
    columns: Sequence[torch.Tensor], seg: torch.Tensor, num_segments: int, lanes: Optional[int]
) -> List[torch.Tensor]:
    """:func:`ops.segments.segment_sums` of one state, or of every lane of a
    stack in ONE call: the columns ``[S, R, ...]`` flattened lane-major under
    :func:`lane_ids`, ``S * num_segments`` segments, each result
    ``[S, num_segments, ...]``."""
    if lanes is None:
        return _segment_sums(columns, seg, num_segments)
    return stacked_segment_sums(columns, seg, num_segments)


def replication_factors(states: ClusterArrays) -> torch.Tensor:
    """i32[P] of one state, or i32[S, P] of a stack: valid replicas of each
    partition, one integer segment-sum call (for a stack, every lane's: ids
    ``lane * P + partition``, ``S * P`` segments)."""
    (rf,) = lane_segment_sums(
        [states.replica_valid], states.replica_partition, states.num_partitions, lanes_of(states)
    )
    return rf


# ---------------------------------------------------------------------------
# Mutations (scatter updates returning a new state).
# ---------------------------------------------------------------------------


def _no_op_to_oob(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Entries < 0 become ``n`` so the drop-mode scatter discards them."""
    return torch.where(idx >= 0, idx, n)


def relocate_replicas(
    state: ClusterArrays,
    replica_idx: torch.Tensor,
    dst_broker: torch.Tensor,
    dst_disk: Optional[torch.Tensor] = None,
) -> ClusterArrays:
    """Move replicas to destination brokers; ``replica_idx < 0`` entries are
    no-ops.  A moved replica's logdir resets to -1 unless ``dst_disk`` names one."""
    idx = _no_op_to_oob(replica_idx, state.num_replicas)
    target_disk = dst_disk if dst_disk is not None else torch.full_like(replica_idx, -1)
    return state.replace(
        replica_broker=scatter_set(state.replica_broker, idx, dst_broker),
        replica_disk=scatter_set(state.replica_disk, idx, target_disk),
    )


def relocate_replica_disks(
    state: ClusterArrays, replica_idx: torch.Tensor, dst_disk: torch.Tensor
) -> ClusterArrays:
    """Move replicas between logdirs of their own broker (no-ops: idx < 0)."""
    idx = _no_op_to_oob(replica_idx, state.num_replicas)
    return state.replace(replica_disk=scatter_set(state.replica_disk, idx, dst_disk))


def relocate_leadership(
    state: ClusterArrays, partition_idx: torch.Tensor, dst_replica: torch.Tensor
) -> ClusterArrays:
    """Transfer partition leadership to a destination replica (no-ops: idx < 0)."""
    idx = _no_op_to_oob(partition_idx, state.num_partitions)
    return state.replace(
        partition_leader=scatter_set(state.partition_leader, idx, dst_replica)
    )


def swap_replicas(
    state: ClusterArrays, replica_a: torch.Tensor, replica_b: torch.Tensor
) -> ClusterArrays:
    """Exchange the brokers of two replicas (no-ops: either index < 0)."""
    ok = (replica_a >= 0) & (replica_b >= 0)
    n = state.num_replicas
    sa = torch.where(ok, replica_a, n)
    sb = torch.where(ok, replica_b, n)
    ba = state.replica_broker[torch.where(ok, replica_a, 0)]
    bb = state.replica_broker[torch.where(ok, replica_b, 0)]
    brokers = scatter_set(state.replica_broker, sa, bb)
    brokers = scatter_set(brokers, sb, ba)
    disks = scatter_set(state.replica_disk, sa, -1)
    disks = scatter_set(disks, sb, -1)
    return state.replace(replica_broker=brokers, replica_disk=disks)


def set_broker_state(
    state: ClusterArrays,
    broker_id: int,
    alive: Optional[bool] = None,
    new: Optional[bool] = None,
    demoted: Optional[bool] = None,
) -> ClusterArrays:
    """Update one broker's lifecycle flags."""
    out = state
    for name, value in (("broker_alive", alive), ("broker_new", new), ("broker_demoted", demoted)):
        if value is not None:
            t = getattr(out, name).clone()
            t[broker_id] = value
            out = out.replace(**{name: t})
    return out


def self_satisfied_state_hash(state: ClusterArrays) -> torch.Tensor:
    """Cheap content hash of the placement, for convergence detection."""
    h1 = (state.replica_broker.to(torch.int64) * 2654435761).sum()
    h2 = (state.partition_leader.to(torch.int64) * 40503).sum()
    return h1 ^ h2
