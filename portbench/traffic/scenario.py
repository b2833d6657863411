"""What-if scenarios over a base cluster, in plain numpy: the benchmark's frozen copy.

A frozen copy of the array arithmetic of the port's ``sim/scenario.py``
(``pad_brokers`` and ``apply_scenario``): add empty brokers, kill brokers
(dead, with leadership failed over to the lowest-index surviving replica),
scale the load.  Every scenario of a stack is padded to one broker bucket,
the next power of two of the largest broker count after the adds (at least
8): the padding brokers are dead with zero capacity.  The float arithmetic is
float32, as the port's, so the arrays are equal to the port's
(``portbench/tests/test_portbench_traffic.py``).

A traffic mix names its scenarios by a rule (``scenarios`` in
``portbench/traffic/mixes/<name>.json``): scenario ``i`` of ``count`` adds
``i % add_mod`` brokers, kills broker ``i % kill_mod`` when ``i % kill_every
== 0``, and scales every load by ``1 + load_step * i``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np

MIN_BROKER_BUCKET = 8


def broker_bucket(num_brokers: int) -> int:
    """The padded broker axis: the next power of two, at least 8."""
    n = max(int(num_brokers), MIN_BROKER_BUCKET)
    return 1 << (n - 1).bit_length()


def scenarios_from(rule: Mapping) -> List[dict]:
    """The scenarios of a traffic mix's rule, in order."""
    out = []
    for i in range(int(rule["count"])):
        kill = int(rule.get("kill_every", 0))
        out.append({
            "add_brokers": i % int(rule["add_mod"]) if rule.get("add_mod") else 0,
            "kill_brokers": [i % int(rule["kill_mod"])] if kill and i % kill == 0 else [],
            "load_factor": 1.0 + float(rule.get("load_step", 0.0)) * i,
        })
    return out


def pad_brokers(base: Mapping, bucket: int) -> Dict[str, np.ndarray]:
    """The base padded to ``bucket`` brokers with inert slots: dead, zero
    capacity, a fresh host each and a round-robin rack."""
    B = base["broker_rack"].shape[0]
    if bucket < B:
        raise ValueError(f"bucket {bucket} smaller than {B} brokers")
    pad = bucket - B
    extra = np.arange(pad, dtype=np.int32)
    out = dict(base)
    out["broker_rack"] = np.concatenate([base["broker_rack"], (B + extra) % max(base["num_racks"], 1)]).astype(np.int32)
    out["broker_host"] = np.concatenate([base["broker_host"], base["num_hosts"] + extra]).astype(np.int32)
    out["broker_capacity"] = np.concatenate([base["broker_capacity"], np.zeros((pad, 4), np.float32)])
    for k in ("broker_alive", "broker_new", "broker_demoted"):
        out[k] = np.concatenate([base[k], np.zeros(pad, bool)])
    out["num_hosts"] = int(base["num_hosts"]) + pad
    return out


def apply_scenario(base: Mapping, sc: Mapping, bucket: int) -> Dict[str, np.ndarray]:
    """One scenario of ``base`` as arrays padded to ``bucket`` brokers."""
    B = base["broker_rack"].shape[0]
    B_new = B + int(sc.get("add_brokers", 0))
    if bucket < B_new:
        raise ValueError(f"bucket {bucket} smaller than {B_new} brokers after the adds")
    padded = pad_brokers(base, bucket)
    cap = padded["broker_capacity"].copy()
    alive = padded["broker_alive"].copy()
    new = padded["broker_new"].copy()
    base_alive = base["broker_alive"]
    base_cap = base["broker_capacity"]
    mean_cap = base_cap[base_alive].mean(axis=0) if base_alive.any() else base_cap.mean(axis=0)
    cap[B:B_new] = mean_cap[None, :]
    alive[B:B_new] = True
    new[B:B_new] = True

    killed = np.zeros(bucket, bool)
    killed[[int(b) for b in sc.get("kill_brokers", ())]] = True
    alive &= ~killed

    factor = np.float32(sc.get("load_factor", 1.0))
    topic_factor = np.ones(max(int(base["num_topics"]), 1), np.float32)
    pfac = factor * topic_factor[base["partition_topic"].astype(np.int64)]
    rfac = pfac[base["replica_partition"].astype(np.int64)]
    base_load = base["base_load"] * rfac[:, None]
    delta = base["leadership_delta"] * pfac[:, None]

    leader = base["partition_leader"]
    if killed.any():
        rb = base["replica_broker"].astype(np.int64)
        lead_broker = np.where(leader >= 0, rb[np.maximum(leader, 0)], -1)
        affected = (leader >= 0) & killed[np.maximum(lead_broker, 0)] & (lead_broker >= 0)
        if affected.any():
            R, P = rb.shape[0], leader.shape[0]
            surv = base["replica_valid"] & ~killed[rb] & base_alive[rb]
            big = R + 1
            order = np.where(surv, np.arange(R, dtype=np.int64), big)
            first = np.full(P, big, np.int64)
            np.minimum.at(first, base["replica_partition"].astype(np.int64), order)
            new_leader = np.where(first < big, first, -1).astype(np.int32)
            leader = np.where(affected, new_leader, leader).astype(np.int32)

    padded.update(
        base_load=base_load.astype(np.float32),
        partition_leader=leader,
        leadership_delta=delta.astype(np.float32),
        broker_capacity=cap,
        broker_alive=alive,
        broker_new=new,
    )
    return padded
