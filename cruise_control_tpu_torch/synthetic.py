"""Synthetic cluster generation, direct to tensors.

Port of ``cruise_control_tpu/synthetic.py``, the counterpart of the reference's
randomized-test scaffolding
(``model/RandomCluster.java:53,102`` + ``common/TestConstants.java:89-91``): clusters
built from (racks, brokers, topics, partitions, replication factor) with uniform /
linear / exponential load distributions.  Unlike the reference (which builds the full
object graph), this generates the dense :class:`ClusterArrays` directly in numpy —
the 10k-broker/1M-replica benchmark inputs would take minutes through a Python object
model and take milliseconds here.  The numpy RNG stream is the JAX package's, so
the same spec and seed give equal arrays; only the final conversion (to torch
tensors on ``device``) differs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.core.resources import NUM_RESOURCES, Resource

# TestConstants.java:36-38,105-107
TYPICAL_CPU_CAPACITY = 100.0
LARGE_BROKER_CAPACITY = 300_000.0
MEDIUM_BROKER_CAPACITY = 200_000.0

UNIFORM = "uniform"
LINEAR = "linear"
EXPONENTIAL = "exponential"


@dataclasses.dataclass
class SyntheticSpec:
    """Scale + distribution knobs (ClusterProperty map equivalent)."""

    num_racks: int = 10
    num_brokers: int = 40
    num_topics: int = 100
    num_partitions: int = 1000           # total partitions across topics
    replication_factor: int = 3
    distribution: str = EXPONENTIAL      # TestConstants.Distribution
    # mean utilization as fraction of capacity, per resource
    mean_cpu: float = 0.2
    mean_disk: float = 0.3
    mean_nw_in: float = 0.2
    mean_nw_out: float = 0.15
    capacity_cpu: float = TYPICAL_CPU_CAPACITY
    capacity_disk: float = LARGE_BROKER_CAPACITY
    capacity_nw_in: float = LARGE_BROKER_CAPACITY
    capacity_nw_out: float = MEDIUM_BROKER_CAPACITY
    seed: int = 0
    #: place all replicas skewed onto the first ``skew_brokers`` brokers (0 = spread)
    skew_brokers: int = 0
    #: JBOD: logdirs per broker (0 = single-logdir, no disk axis) — the
    #: capacityJBOD.json shape; per-disk capacity = capacity_disk / disks
    disks_per_broker: int = 0
    #: skip the name/index dictionaries (IndexMaps) — at 3M replicas the Python
    #: tuple lists cost ~GBs and minutes; benchmarks that never emit proposals
    #: don't need them
    build_maps: bool = True


def _partition_loads(rng: np.random.Generator, spec: SyntheticSpec, n: int) -> np.ndarray:
    """f64[n, 4] leader-replica loads per partition under the chosen distribution."""
    means = np.array(
        [
            spec.mean_cpu * spec.capacity_cpu,
            spec.mean_nw_in * spec.capacity_nw_in,
            spec.mean_nw_out * spec.capacity_nw_out,
            spec.mean_disk * spec.capacity_disk,
        ]
    )
    # per-partition mean load so totals hit mean·capacity·num_brokers
    per = means * spec.num_brokers / max(n, 1)
    if spec.distribution == UNIFORM:
        w = rng.uniform(0.5, 1.5, size=n)
    elif spec.distribution == LINEAR:
        w = np.linspace(0.1, 1.9, n)
        rng.shuffle(w)
    elif spec.distribution == EXPONENTIAL:
        w = rng.exponential(1.0, size=n)
        w = np.clip(w, 0.05, 8.0)
        w /= w.mean()
    else:
        raise ValueError(f"unknown distribution {spec.distribution!r}")
    return np.outer(w, per)


def generate(spec: SyntheticSpec, device: DeviceLike = None):
    """Build a ``(ClusterArrays, IndexMaps)`` pair for the spec on ``device``.

    Placement is round-robin with a per-partition rotating offset (rack-aware by
    construction when racks >= RF), unless ``skew_brokers`` forces an unbalanced
    starting point for rebalance benchmarks.
    """
    from cruise_control_tpu_torch.model.bridge import arrays_from_numpy
    from cruise_control_tpu_torch.model.cluster import IndexMaps
    from cruise_control_tpu_torch.model.model_utils import (
        DEFAULT_CPU_WEIGHTS,
        follower_cpu_from_leader_load,
    )

    dev = resolve_device(device)

    rng = np.random.default_rng(spec.seed)
    B, P, rf = spec.num_brokers, spec.num_partitions, spec.replication_factor
    if rf > B:
        raise ValueError("replication factor exceeds broker count")
    R = P * rf

    broker_rack = np.arange(B, dtype=np.int32) % spec.num_racks
    partition_topic = (
        np.arange(P, dtype=np.int32) % spec.num_topics
    ).astype(np.int32)

    # placement: partition p gets brokers (base_p + k) mod B for k in 0..rf-1 —
    # consecutive brokers sit in consecutive racks (broker_rack = id % racks), so
    # replicas land in distinct racks whenever B % racks == 0 and rf ≤ racks.
    base = rng.integers(0, B, size=P, dtype=np.int32)
    offsets = np.arange(rf, dtype=np.int32)[None, :]
    if spec.skew_brokers > 0:
        # unbalanced start: confine placements to the first max(skew, rf) brokers
        m = max(spec.skew_brokers, rf)
        base = rng.integers(0, m, size=P, dtype=np.int32)
        placement = (base[:, None] + offsets) % m      # [P, rf]
    else:
        placement = (base[:, None] + offsets) % B      # [P, rf]

    leader_load = _partition_loads(rng, spec, P)        # [P, 4]
    follower_cpu = follower_cpu_from_leader_load(
        leader_load[:, Resource.NW_IN],
        leader_load[:, Resource.NW_OUT],
        leader_load[:, Resource.CPU],
        DEFAULT_CPU_WEIGHTS,
    )

    replica_partition = np.repeat(np.arange(P, dtype=np.int32), rf)
    replica_broker = placement.reshape(-1).astype(np.int32)
    base_load = np.zeros((R, NUM_RESOURCES), np.float32)
    # follower-equivalent base load: followers replicate (NW_IN, DISK) and burn
    # follower CPU; NW_OUT and the CPU surplus travel with leadership.
    base_load[:, Resource.CPU] = np.repeat(follower_cpu, rf)
    base_load[:, Resource.NW_IN] = np.repeat(leader_load[:, Resource.NW_IN], rf)
    base_load[:, Resource.DISK] = np.repeat(leader_load[:, Resource.DISK], rf)

    leadership_delta = np.zeros((P, NUM_RESOURCES), np.float32)
    leadership_delta[:, Resource.CPU] = leader_load[:, Resource.CPU] - follower_cpu
    leadership_delta[:, Resource.NW_OUT] = leader_load[:, Resource.NW_OUT]

    partition_leader = (np.arange(P, dtype=np.int32) * rf).astype(np.int32)

    capacity = np.tile(
        np.array(
            [spec.capacity_cpu, spec.capacity_nw_in, spec.capacity_nw_out, spec.capacity_disk],
            np.float32,
        ),
        (B, 1),
    )

    dpb = spec.disks_per_broker
    if dpb > 0:
        D = B * dpb
        disk_broker = np.repeat(np.arange(B, dtype=np.int32), dpb)
        disk_capacity = np.full(D, spec.capacity_disk / dpb, np.float32)
        disk_alive = np.ones(D, bool)
        # skew within the broker too: uneven logdir fill for the intra goals
        local = rng.integers(0, dpb, size=R).astype(np.int32)
        replica_disk = replica_broker * dpb + local
    else:
        D = 0
        disk_broker = np.zeros(0, np.int32)
        disk_capacity = np.zeros(0, np.float32)
        disk_alive = np.zeros(0, bool)
        replica_disk = np.full(R, -1, np.int32)

    state = arrays_from_numpy(
        {
            "replica_partition": replica_partition,
            "replica_broker": replica_broker,
            "replica_disk": replica_disk,
            "replica_valid": np.ones(R, bool),
            "base_load": base_load,
            "original_broker": replica_broker,
            "partition_topic": partition_topic,
            "partition_leader": partition_leader,
            "leadership_delta": leadership_delta,
            "broker_rack": broker_rack,
            "broker_host": np.arange(B, dtype=np.int32),
            "broker_capacity": capacity,
            "broker_alive": np.ones(B, bool),
            "broker_new": np.zeros(B, bool),
            "broker_demoted": np.zeros(B, bool),
            "disk_broker": disk_broker,
            "disk_capacity": disk_capacity,
            "disk_alive": disk_alive,
        },
        num_racks=spec.num_racks,
        num_topics=spec.num_topics,
        num_hosts=B,
        device=dev,
    )

    if not spec.build_maps:
        return state, None

    topic_names = [f"T{t}" for t in range(spec.num_topics)]
    partitions = [(topic_names[partition_topic[p]], int(p)) for p in range(P)]
    maps = IndexMaps(
        broker_ids=list(range(B)),
        broker_index={b: b for b in range(B)},
        rack_names=[str(r) for r in range(spec.num_racks)],
        rack_index={str(r): r for r in range(spec.num_racks)},
        host_names=[f"host-{b}" for b in range(B)],
        host_index={f"host-{b}": b for b in range(B)},
        topic_names=topic_names,
        topic_index={t: i for i, t in enumerate(topic_names)},
        partitions=partitions,
        partition_index={tp: i for i, tp in enumerate(partitions)},
        replicas=[
            (partitions[replica_partition[i]], int(replica_broker[i])) for i in range(R)
        ],
        disks=[(b, f"/logdir{k}") for b in range(B) for k in range(dpb)],
        disk_index={
            (b, f"/logdir{k}"): b * dpb + k
            for b in range(B)
            for k in range(dpb)
        },
    )
    return state, maps
