"""A duck-typed facade that drives the JAX package's and the port's continuous
controllers (and fleets) on the same cluster, for ``test_torch_controller.py``
and ``test_torch_fleet.py``.

The cluster is the JAX controller bench's shape (``controller/bench.py``: 6
brokers in 2 racks, 48 partitions at RF 2, the same base load and capacities,
the same 4-goal list) built straight into a ``ClusterModel`` on each side
(the port's through ``torch_port_helpers.port_cluster_model``).  The monitor
is a dict of partition loads; a shift overloads the disk of every partition
the controller's tracked placement hosts on one broker, as the bench does.
Both controllers read one fake clock, so reaction latencies agree exactly.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, List

import numpy as np

from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.core.resources import Resource as JResource
from cruise_control_tpu.executor.journal import proposal_to_record as j_record
from cruise_control_tpu.model.cluster import ClusterModel as JClusterModel
from cruise_control_tpu.model.model_utils import (
    DEFAULT_CPU_WEIGHTS as J_WEIGHTS,
    follower_cpu_from_leader_load,
)
from cruise_control_tpu.monitor.loadmonitor import WindowDelta as JWindowDelta
from cruise_control_tpu_torch.executor.journal import proposal_to_record as p_record
from cruise_control_tpu_torch.model.model_utils import DEFAULT_CPU_WEIGHTS as P_WEIGHTS
from cruise_control_tpu_torch.monitor.loadmonitor import WindowDelta as PWindowDelta
from tests.torch_port_helpers import port_cluster_model

BROKERS = 6
RACKS = 2
PARTITIONS = 48
RF = 2
#: controller/bench.py:55 -- short to compile on the JAX side
GOALS = (JG.RACK_AWARE, JG.REPLICA_CAPACITY, JG.DISK_CAPACITY, JG.DISK_USAGE_DIST)
HARD = tuple(g for g in GOALS if g in JG.HARD_GOALS)
BASE_LOAD = (0.2, 50.0, 50.0, 10.0)
HOT_DISK = 1_000.0
CAPACITY = {JResource.CPU: 100.0, JResource.NW_IN: 1e6, JResource.NW_OUT: 1e6, JResource.DISK: 1e4}
#: one tick shape for every controller of a module (JAX compiles once)
TICK_CFG = dict(tick_interval_s=3_600.0, drift_threshold=1.0, max_rounds_per_tick=1)


class FakeClock:
    """A monotonic clock the test advances by hand."""

    def __init__(self, t: float = 1_000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def base_loads() -> Dict[tuple, tuple]:
    return {("T", p): BASE_LOAD for p in range(PARTITIONS)}


def jax_model(loads) -> JClusterModel:
    """The bench cluster with each replica's measured load: the leader's is
    the partition's, a follower's the follower-equivalent (no NW-out)."""
    model = JClusterModel()
    for b in range(BROKERS):
        model.create_broker(str(b % RACKS), b, CAPACITY)
    for p in range(PARTITIONS):
        tp = ("T", p)
        cpu, nw_in, nw_out, disk = loads[tp]
        fcpu = float(follower_cpu_from_leader_load(nw_in, nw_out, cpu, J_WEIGHTS))
        for i, b in enumerate([p % BROKERS, (p + 1) % BROKERS][:RF]):
            model.create_replica(b, tp, i, is_leader=(i == 0))
            model.set_replica_load(b, tp, [cpu, nw_in, nw_out, disk] if i == 0 else [fcpu, nw_in, 0.0, disk])
    return model


class Duck:
    """The facade seam a ``ContinuousController`` reads (``loop.py:86``)."""

    def __init__(self, port: bool, loads: dict, goals=GOALS, hard=HARD) -> None:
        self.port = port
        self.goal_ids = tuple(goals)
        self.hard_ids = tuple(hard)
        self.enable_heavy_goals = True
        self.constraint = None
        self.loads = loads
        self.listeners: List = []
        self.monitor = types.SimpleNamespace(
            current_partition_loads=lambda: dict(self.loads),
            cpu_weights=P_WEIGHTS if port else J_WEIGHTS,
            add_window_listener=self.listeners.append,
        )
        self.backend = types.SimpleNamespace(
            describe_cluster=lambda: types.SimpleNamespace(brokers={b: None for b in range(BROKERS)})
        )
        self.executor = None

    def cluster_model(self):
        model = jax_model(self.loads)
        return port_cluster_model(model) if self.port else model

    def push_delta(self, clock: FakeClock, window: int) -> None:
        cls = PWindowDelta if self.port else JWindowDelta
        delta = cls(window_id=window, ts_ms=window * 60_000, num_samples=PARTITIONS,
                    new_window=True, ingest_monotonic=clock())
        for fn in self.listeners:
            fn(delta)


def hot_partitions_on(controller, broker_idx: int):
    """The partitions the controller's TRACKED placement hosts on a broker."""
    rb = np.asarray(controller._state_host.replica_broker)
    rows = controller._valid_np & (rb == broker_idx)
    pids = sorted(set(controller._rp_np[rows].tolist()))
    return [controller._maps.partitions[p] for p in pids]


def shift(loads: dict, controller, victim: int, prev_hot) -> list:
    """Reset the previous hot set, overload the victim's partitions' disk."""
    for tp in prev_hot:
        loads[tp] = BASE_LOAD
    hot = hot_partitions_on(controller, victim)
    for tp in hot:
        loads[tp] = (0.2, 50.0, 50.0, HOT_DISK)
    return hot


def set_key(standing, port: bool):
    """A standing set as comparable plain data (every field but the wall
    clock's ``created_ms``)."""
    if standing is None:
        return None
    rec = p_record if port else j_record
    return (standing.version, standing.trigger, standing.drift, standing.reaction_s,
            standing.epoch, [rec(p) for p in standing.proposals])


def drift_key(report):
    return None if report is None else dataclasses.asdict(report)
