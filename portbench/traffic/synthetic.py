"""Synthetic clusters as plain numpy arrays: the benchmark's own frozen generator.

A frozen copy of the port's ``synthetic.generate`` (itself the counterpart of
upstream's ``RandomCluster.java`` with ``TestConstants.java``'s capacities),
kept here so that a later change to the program cannot move the inputs the
benchmark measures it on.  It returns one numpy array a ``ClusterArrays``
field, under the port's field names, and no index maps.  The arithmetic and
the random stream are the port's, so the same spec and seed give equal arrays
(``portbench/tests/test_portbench_traffic.py`` holds this).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

# resource axis, as the port orders it: CPU, NW_IN, NW_OUT, DISK
CPU, NW_IN, NW_OUT, DISK = range(4)
NUM_RESOURCES = 4

# ModelUtils.java's CPU weights: leader bytes in, leader bytes out, follower bytes in
CPU_WEIGHTS = (0.7, 0.15, 0.15)


def _partition_loads(rng: np.random.Generator, spec: Mapping, n: int) -> np.ndarray:
    """f64[n, 4] leader-replica loads per partition under the spec's distribution."""
    means = np.array([
        spec["mean_cpu"] * spec["capacity_cpu"],
        spec["mean_nw_in"] * spec["capacity_nw_in"],
        spec["mean_nw_out"] * spec["capacity_nw_out"],
        spec["mean_disk"] * spec["capacity_disk"],
    ])
    per = means * spec["num_brokers"] / max(n, 1)
    dist = spec["distribution"]
    if dist == "uniform":
        w = rng.uniform(0.5, 1.5, size=n)
    elif dist == "linear":
        w = np.linspace(0.1, 1.9, n)
        rng.shuffle(w)
    elif dist == "exponential":
        w = rng.exponential(1.0, size=n)
        w = np.clip(w, 0.05, 8.0)
        w /= w.mean()
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.outer(w, per)


def _follower_cpu(nw_in, nw_out, cpu):
    """CPU a follower burns, from its leader's load (ModelUtils.getFollowerCpuUtilFromLeaderLoad)."""
    a, b, c = CPU_WEIGHTS
    denom = a * nw_in + b * nw_out
    positive = denom > 0.0
    safe = np.where(positive, denom, 1.0)
    return np.where(positive, cpu * (c * nw_in) / safe, 0.0)


def generate(spec: Mapping, seed: int) -> Dict[str, np.ndarray]:
    """One cluster of the spec at ``seed``: a dict of numpy arrays under the
    port's ``ClusterArrays`` field names, plus ``num_racks``, ``num_topics``
    and ``num_hosts``.  Placement is round-robin from a random base per
    partition, confined to the first ``skew_brokers`` brokers when set."""
    rng = np.random.default_rng(seed)
    B, P, rf = spec["num_brokers"], spec["num_partitions"], spec["replication_factor"]
    if rf > B:
        raise ValueError("replication factor exceeds broker count")
    R = P * rf
    racks, topics = spec["num_racks"], spec["num_topics"]

    broker_rack = np.arange(B, dtype=np.int32) % racks
    partition_topic = (np.arange(P, dtype=np.int32) % topics).astype(np.int32)

    base = rng.integers(0, B, size=P, dtype=np.int32)
    offsets = np.arange(rf, dtype=np.int32)[None, :]
    skew = spec.get("skew_brokers", 0)
    if skew > 0:
        m = max(skew, rf)
        base = rng.integers(0, m, size=P, dtype=np.int32)
        placement = (base[:, None] + offsets) % m
    else:
        placement = (base[:, None] + offsets) % B

    leader_load = _partition_loads(rng, spec, P)
    follower_cpu = _follower_cpu(leader_load[:, NW_IN], leader_load[:, NW_OUT], leader_load[:, CPU])

    replica_partition = np.repeat(np.arange(P, dtype=np.int32), rf)
    replica_broker = placement.reshape(-1).astype(np.int32)
    base_load = np.zeros((R, NUM_RESOURCES), np.float32)
    base_load[:, CPU] = np.repeat(follower_cpu, rf)
    base_load[:, NW_IN] = np.repeat(leader_load[:, NW_IN], rf)
    base_load[:, DISK] = np.repeat(leader_load[:, DISK], rf)

    leadership_delta = np.zeros((P, NUM_RESOURCES), np.float32)
    leadership_delta[:, CPU] = leader_load[:, CPU] - follower_cpu
    leadership_delta[:, NW_OUT] = leader_load[:, NW_OUT]

    capacity = np.tile(
        np.array([spec["capacity_cpu"], spec["capacity_nw_in"], spec["capacity_nw_out"],
                  spec["capacity_disk"]], np.float32),
        (B, 1),
    )
    return {
        "replica_partition": replica_partition,
        "replica_broker": replica_broker,
        "replica_disk": np.full(R, -1, np.int32),
        "replica_valid": np.ones(R, bool),
        "base_load": base_load,
        "original_broker": replica_broker.copy(),
        "partition_topic": partition_topic,
        "partition_leader": (np.arange(P, dtype=np.int32) * rf).astype(np.int32),
        "leadership_delta": leadership_delta,
        "broker_rack": broker_rack,
        "broker_host": np.arange(B, dtype=np.int32),
        "broker_capacity": capacity,
        "broker_alive": np.ones(B, bool),
        "broker_new": np.zeros(B, bool),
        "broker_demoted": np.zeros(B, bool),
        "disk_broker": np.zeros(0, np.int32),
        "disk_capacity": np.zeros(0, np.float32),
        "disk_alive": np.zeros(0, bool),
        "num_racks": int(racks),
        "num_topics": int(topics),
        "num_hosts": int(B),
    }
