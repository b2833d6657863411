"""Declarative what-if scenarios over a base cluster, batched and bucketed.

Port of ``cruise_control_tpu/sim/scenario.py``.  A :class:`Scenario` names an
edit of the base :class:`ClusterArrays`: add empty brokers, decommission
(remove) or fail (kill) existing ones, drop a whole rack, scale the load
globally or per topic, scale capacities per resource, or (deep path only)
permute the goal priority list.

* Every scenario of a batch shares the base replica/partition axes and a
  bucketed broker axis (:func:`broker_bucket`): padding brokers are dead with
  zero capacity, so every evaluator masks them as it masks dead brokers.
* :func:`apply_scenario` builds one scenario on the CPU;
  :func:`build_batch` stacks a batch's scenarios leaf-wise (one leading
  scenario axis) and moves the stack to the device in ONE copy per leaf,
  not one copy of every leaf per scenario.

Broker verbs, as in the reference's endpoints:

* ``add_brokers`` -- new empty brokers (ADD_BROKER): alive, flagged new,
  capacity = the alive brokers' mean capacity x ``capacity_factors``, racks
  round-robin over the existing racks;
* ``remove_brokers`` -- planned decommission: dead, so their replicas are
  offline and must move, leadership untouched (the drain has not happened);
* ``kill_brokers`` / ``drop_rack`` -- failure: dead AND leadership already
  failed over to the lowest-index replica on a surviving broker (leaderless,
  -1, when none survives).
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple

import torch

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.model.arrays import (  # noqa: F401  (re-exported API)
    MIN_BROKER_BUCKET,
    ClusterArrays,
    broker_bucket,
)

F32 = torch.float32


def check_wire_keys(d: Mapping, allowed: Sequence[str], what: str) -> None:
    """Reject unknown keys in a wire-format dict: a typo'd key must never
    yield a confident verdict about an unmodified scenario."""
    unknown = sorted(set(d) - set(allowed))
    if unknown:
        raise ValueError(
            f"{what}: unknown key(s) {unknown}; allowed keys are "
            f"{sorted(allowed)}"
        )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One hypothetical edit of the base cluster (all fields optional)."""

    name: str = ""
    #: new empty brokers to add (ADD_BROKER semantics)
    add_brokers: int = 0
    #: broker ids to decommission (REMOVE_BROKER: dead, leadership untouched)
    remove_brokers: Tuple[int, ...] = ()
    #: broker ids that failed (dead + leadership already failed over)
    kill_brokers: Tuple[int, ...] = ()
    #: rack id whose brokers all failed (kill semantics)
    drop_rack: Optional[int] = None
    #: global load multiplier (all replicas and leadership deltas)
    load_factor: float = 1.0
    #: per-topic-id load multiplier, on top of ``load_factor``
    topic_load_factors: Tuple[Tuple[int, float], ...] = ()
    #: per-resource capacity multiplier [CPU, NW_IN, NW_OUT, DISK]
    capacity_factors: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    #: deep path only: run the full optimizer with this goal priority order
    goal_order: Optional[Tuple[int, ...]] = None

    def validate(self, base: ClusterArrays) -> None:
        B = base.num_brokers
        if self.add_brokers < 0:
            raise ValueError(f"{self.name or 'scenario'}: add_brokers < 0")
        if self.load_factor <= 0:
            raise ValueError(f"{self.name or 'scenario'}: load_factor must be > 0")
        if any(f <= 0 for f in self.capacity_factors):
            raise ValueError(f"{self.name or 'scenario'}: capacity_factors must be > 0")
        for b in tuple(self.remove_brokers) + tuple(self.kill_brokers):
            if not (0 <= int(b) < B):
                raise ValueError(f"{self.name or 'scenario'}: broker {b} out of range")
        if self.drop_rack is not None and not (0 <= int(self.drop_rack) < base.num_racks):
            raise ValueError(f"{self.name or 'scenario'}: rack {self.drop_rack} out of range")
        for t, f in self.topic_load_factors:
            if not (0 <= int(t) < base.num_topics):
                raise ValueError(f"{self.name or 'scenario'}: topic {t} out of range")
            if f <= 0:
                raise ValueError(f"{self.name or 'scenario'}: topic load factor must be > 0")

    # -- wire format (REST SIMULATE body) ------------------------------------

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "add_brokers": self.add_brokers,
            "remove_brokers": list(self.remove_brokers),
            "kill_brokers": list(self.kill_brokers),
            "drop_rack": self.drop_rack,
            "load_factor": self.load_factor,
            "topic_load_factors": {str(t): f for t, f in self.topic_load_factors},
            "capacity_factors": list(self.capacity_factors),
        }
        if self.goal_order is not None:
            d["goal_order"] = [G.GOAL_NAMES[g] for g in self.goal_order]
        return d

    _WIRE_KEYS = (
        "name", "add_brokers", "remove_brokers", "kill_brokers", "drop_rack",
        "load_factor", "topic_load_factors", "capacity_factors", "goal_order",
    )

    @classmethod
    def from_dict(cls, d: Mapping) -> "Scenario":
        check_wire_keys(d, cls._WIRE_KEYS, f"scenario {d.get('name', '')!r}")
        goal_order = None
        if d.get("goal_order"):
            ids = []
            for g in d["goal_order"]:
                if isinstance(g, str):
                    if g not in G.GOAL_ID_BY_NAME:
                        raise ValueError(f"unknown goal {g!r}")
                    ids.append(G.GOAL_ID_BY_NAME[g])
                else:
                    ids.append(int(g))
            goal_order = tuple(ids)
        tlf = d.get("topic_load_factors") or {}
        if isinstance(tlf, Mapping):
            tlf = tuple((int(t), float(f)) for t, f in sorted(tlf.items(), key=lambda kv: int(kv[0])))
        else:
            tlf = tuple((int(t), float(f)) for t, f in tlf)
        cf = d.get("capacity_factors") or (1.0, 1.0, 1.0, 1.0)
        return cls(
            name=str(d.get("name", "")),
            add_brokers=int(d.get("add_brokers", 0)),
            remove_brokers=tuple(int(b) for b in d.get("remove_brokers", ())),
            kill_brokers=tuple(int(b) for b in d.get("kill_brokers", ())),
            drop_rack=None if d.get("drop_rack") is None else int(d["drop_rack"]),
            load_factor=float(d.get("load_factor", 1.0)),
            topic_load_factors=tlf,
            capacity_factors=tuple(float(f) for f in cf),
            goal_order=goal_order,
        )


@dataclasses.dataclass
class ScenarioBatch:
    """S mutated clusters stacked leaf-wise into one ``ClusterArrays`` whose
    every tensor has a leading scenario axis; the static counts are shared."""

    states: ClusterArrays          # tensors are [S, ...], on the sweep's device
    scenarios: Tuple[Scenario, ...]
    #: (bucketed broker axis, replicas, partitions): the batch's shape key
    bucket: Tuple[int, int, int]
    base_brokers: int

    @property
    def size(self) -> int:
        return len(self.scenarios)

    @property
    def names(self) -> List[str]:
        return [s.name or f"scenario-{i}" for i, s in enumerate(self.scenarios)]


def apply_scenario(
    base: ClusterArrays, sc: Scenario, bucket_brokers: Optional[int] = None
) -> ClusterArrays:
    """One scenario as a broker-axis-padded state on the CPU.

    ``bucket_brokers`` (default :func:`broker_bucket` of brokers-after-add)
    fixes the padded broker axis, so differently-sized scenarios share one
    shape.  Float results are bitwise those of the JAX package's numpy."""
    base = base.to("cpu")
    sc.validate(base)
    B = base.num_brokers
    B_new = B + sc.add_brokers
    B_pad = broker_bucket(B_new) if bucket_brokers is None else int(bucket_brokers)
    if B_pad < B_new:
        raise ValueError(
            f"bucket_brokers={B_pad} smaller than brokers-after-add={B_new}"
        )

    # slots [B, B_new) are the added brokers, [B_new, B_pad) inert padding
    padded = A.pad_brokers(base, B_pad)
    cap_pad = padded.broker_capacity.clone()
    alive_pad = padded.broker_alive.clone()
    new_pad = padded.broker_new.clone()
    # the alive-mean capacity through numpy's mean, the reference's rounding
    cap = base.broker_capacity.numpy()
    alive = base.broker_alive.numpy()
    mean_cap = cap[alive].mean(axis=0) if alive.any() else cap.mean(axis=0)
    cap_pad[B:B_new] = torch.from_numpy(mean_cap)[None, :]
    alive_pad[B:B_new] = True
    new_pad[B:B_new] = True

    dead = torch.zeros(B_pad, dtype=torch.bool)
    dead[list(map(int, sc.remove_brokers))] = True
    killed = torch.zeros(B_pad, dtype=torch.bool)
    killed[list(map(int, sc.kill_brokers))] = True
    if sc.drop_rack is not None:
        killed[:B] |= padded.broker_rack[:B] == int(sc.drop_rack)
    alive_pad &= ~(dead | killed)

    cap_pad = cap_pad * torch.tensor(sc.capacity_factors, dtype=F32)[None, :]

    # global x per-topic factor on the follower-equivalent base load and the
    # leadership delta (the split is load-linear, so both scale alike)
    topic_factor = torch.ones(max(base.num_topics, 1), dtype=F32)
    for t, f in sc.topic_load_factors:
        topic_factor[int(t)] = f
    pfac = torch.tensor(sc.load_factor, dtype=F32) * topic_factor[base.partition_topic.long()]
    rfac = pfac[base.replica_partition.long()]
    base_load = base.base_load * rfac[:, None]
    delta = base.leadership_delta * pfac[:, None]

    # kill: leadership has failed over to the lowest-index valid replica on a
    # broker alive after the scenario (base-dead brokers cannot take it)
    leader = base.partition_leader
    if bool(killed.any()):
        rb = base.replica_broker.long()
        leader_broker = torch.where(leader >= 0, rb[leader.clamp(min=0).long()], -1)
        affected = (leader >= 0) & killed[leader_broker.clamp(min=0)] & (leader_broker >= 0)
        if bool(affected.any()):
            R, P = base.num_replicas, base.num_partitions
            surv = base.replica_valid & ~killed[rb] & base.broker_alive[rb]
            big = R + 1
            order = torch.where(surv, torch.arange(R, dtype=torch.int64), big)
            first = torch.full((P,), big, dtype=torch.int64).scatter_reduce(
                0, base.replica_partition.long(), order, "amin"
            )
            new_leader = torch.where(first < big, first, -1).to(torch.int32)
            leader = torch.where(affected, new_leader, leader)

    return padded.replace(
        base_load=base_load,
        partition_leader=leader,
        leadership_delta=delta,
        broker_capacity=cap_pad,
        broker_alive=alive_pad,
        broker_new=new_pad,
        disk_capacity=base.disk_capacity * torch.tensor(sc.capacity_factors[3], dtype=F32),
    )


def build_batch(
    base: ClusterArrays,
    scenarios: Sequence[Scenario],
    bucket_brokers: Optional[int] = None,
    device: DeviceLike = None,
) -> ScenarioBatch:
    """Stack S scenarios into one padded, bucketed ``ClusterArrays`` on
    ``device`` (``cuda`` unless ``device="cpu"``).

    The bucket is the largest brokers-after-add of the batch, rounded up the
    bucket ladder, or ``bucket_brokers`` (verdicts do not depend on it)."""
    dev = resolve_device(device)
    if not scenarios:
        raise ValueError("build_batch needs at least one scenario")
    scenarios = tuple(scenarios)
    base = base.to("cpu")
    B_need = max(base.num_brokers + s.add_brokers for s in scenarios)
    B_pad = broker_bucket(B_need) if bucket_brokers is None else int(bucket_brokers)
    per = [apply_scenario(base, s, bucket_brokers=B_pad) for s in scenarios]
    return ScenarioBatch(
        states=A.stack_arrays(per).to(dev),
        scenarios=scenarios,
        bucket=(B_pad, base.num_replicas, base.num_partitions),
        base_brokers=base.num_brokers,
    )
