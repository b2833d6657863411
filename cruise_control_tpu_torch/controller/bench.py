"""Shared controller-bench harness: reaction latency + warm-tick budgets.

Port of ``cruise_control_tpu/controller/bench.py``, with the same pinned
workload.  The controller and the facade solve on ``device`` (``cuda``
unless ``device="cpu"``).  A tick's dispatch count is the port's host-sync
count: every ``*dispatches`` key has a ``*host_syncs`` twin with the same
number, and ``dispatch_budget`` stays the JAX package's (a fused step per
goal), which the port's one-sync-a-round ticks are not held to yet.
Compile events are ``nvcc`` kernel builds.

The workload: a seeded fake cluster, a warm controller, then K deterministic
load shifts.  Each shift targets the broker the controller's TRACKED
placement currently loads least-defensibly: the partitions hosted on a
rotating victim broker get their disk load pumped past the capacity
threshold, so wherever earlier ticks moved things, the shift provably
violates DiskCapacityGoal in the tracked state — every measured round
produces a drift-triggered tick and a published standing set.

Measured per shift: reaction latency (window delta landing → standing set
published, the ``Controller.reaction-latency-timer`` path), tick dispatches
(host syncs), and kernel builds attributed to the tick's flight record (ZERO
when warm: the warm start builds the kernels).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.backend.fake import FakeClusterBackend
from cruise_control_tpu_torch.controller.loop import (
    ContinuousController,
    ControllerConfig,
)
from cruise_control_tpu_torch.core.device import DeviceLike
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.executor import Executor
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.monitor import LoadMonitor
from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver
from cruise_control_tpu_torch.monitor.samples import BackendMetricSampler

#: pinned workload: the JAX harness's own, so the two packages' dicts compare
BROKERS = 6
RACKS = 2
PARTITIONS = 48
RF = 2
WINDOW_MS = 60_000
NUM_WINDOWS = 4
SHIFTS = 4
#: trimmed goal list (the bench gates the control loop, not goal math)
GOALS = (G.RACK_AWARE, G.REPLICA_CAPACITY, G.DISK_CAPACITY, G.DISK_USAGE_DIST)

BASE_LOAD = [0.2, 50.0, 50.0, 10.0]        # [CPU, NW_IN, NW_OUT, DISK]
HOT_DISK = 1_000.0
CAPACITY = {
    Resource.CPU: 100.0,
    Resource.NW_IN: 1e6,
    Resource.NW_OUT: 1e6,
    Resource.DISK: 1e4,
}


def build_cluster(wrap=None, device: DeviceLike = None):
    """(backend, monitor, cruise_control) for one pinned bench cluster —
    shared by the single-tenant harness below and the fleet bench, whose
    tenants each carry one of these.  ``wrap`` (e.g. ``lambda b:
    ChaosBackend(b, plan)``) interposes on the seeded backend before the
    monitor/facade see it — the chaos tests' hook.  The facade solves on
    ``device``."""
    backend = FakeClusterBackend()
    for b in range(BROKERS):
        backend.add_broker(b, rack=str(b % RACKS))
    for p in range(PARTITIONS):
        backend.create_partition(
            ("T", p),
            [p % BROKERS, (p + 1) % BROKERS][:RF],
            load=list(BASE_LOAD),
        )
    if wrap is not None:
        backend = wrap(backend)
    monitor = LoadMonitor(
        backend,
        BackendMetricSampler(backend),
        StaticCapacityResolver(CAPACITY),
        num_windows=NUM_WINDOWS,
        window_ms=WINDOW_MS,
    )
    cc = CruiseControl(
        backend,
        monitor,
        Executor(backend),
        goal_ids=GOALS,
        hard_ids=tuple(g for g in GOALS if g in G.HARD_GOALS),
        device=device,
    )
    return backend, monitor, cc


def warm_window_clock() -> int:
    """A window-aligned start time: unaligned wall time would let a fixed
    +10s offset cross a window boundary depending on WHEN the suite runs —
    the window-accounting assertions must be run-time independent."""
    now = int(time.time() * 1000)
    return now - now % WINDOW_MS


def build_harness(
    journal=None, config: ControllerConfig = None, wrap=None, device: DeviceLike = None
):
    """(backend, monitor, controller, now_ms) with a warmed window ring.  The
    controller is NOT warm-started — callers choose when to pay the kernel
    builds."""
    backend, monitor, cc = build_cluster(wrap=wrap, device=device)
    controller = ContinuousController(
        cc,
        journal=journal,
        config=config
        or ControllerConfig(
            tick_interval_s=3_600.0,   # cadence off: drift is the trigger
            drift_threshold=1.0,
        ),
        device=device,
    )
    monitor.add_window_listener(controller.on_window_delta)
    now = warm_window_clock()
    for w in range(NUM_WINDOWS + 2):
        monitor.sample_once(now_ms=now + w * WINDOW_MS)
    return backend, monitor, controller, now + (NUM_WINDOWS + 2) * WINDOW_MS


def hot_partitions_on(controller: ContinuousController, broker_idx: int):
    """The partitions the controller's TRACKED placement hosts on
    ``broker_idx`` — pumping exactly these guarantees the shift violates
    the disk-capacity goal in the state drift is measured on."""
    rb = controller._state.replica_broker.cpu().numpy()
    rows = controller._valid_np & (rb == broker_idx)
    pids = sorted(set(controller._rp_np[rows].tolist()))
    return [controller._maps.partitions[p] for p in pids]


def run_bench(shifts: int = SHIFTS, device: DeviceLike = None) -> Dict[str, object]:
    """The measurement record: reaction p50/p95 over ``shifts``
    drift-triggered ticks, the warm-tick dispatch (host-sync) ceiling, and
    the summed kernel builds of every measured tick's flight record."""
    from cruise_control_tpu_torch.obs import RECORDER

    backend, monitor, controller, now_ms = build_harness(device=device)

    t0 = time.monotonic()
    controller.warm_start()   # builds the kernels (on the card)
    warm_start_s = time.monotonic() - t0
    # one unmeasured shift settles the initial placement + drift baseline
    def _feed_shift(now: int) -> int:
        """Two windows: the shift's samples land in window w, the second
        sample opens w+1 so w becomes STABLE (the aggregator excludes the
        still-filling window) — the delta the listener pushes then carries
        the shifted loads."""
        now += WINDOW_MS
        monitor.sample_once(now_ms=now)
        now += WINDOW_MS
        monitor.sample_once(now_ms=now)
        return now

    prev_hot: List = []
    hot = hot_partitions_on(controller, 0)
    for tp in hot:
        backend.set_partition_load(tp, [0.2, 50.0, 50.0, HOT_DISK])
    now_ms = _feed_shift(now_ms)
    controller.maybe_tick()
    prev_hot = hot

    reactions: List[float] = []
    dispatches: List[int] = []
    compiles = 0
    published = 0
    for k in range(shifts):
        victim = (k + 1) % BROKERS
        for tp in prev_hot:
            backend.set_partition_load(tp, list(BASE_LOAD))
        hot = hot_partitions_on(controller, victim)
        for tp in hot:
            backend.set_partition_load(tp, [0.2, 50.0, 50.0, HOT_DISK])
        prev_hot = hot
        now_ms = _feed_shift(now_ms)
        standing = controller.maybe_tick()
        trace = next(iter(RECORDER.recent(1, kind="controller_tick")), None)
        if standing is not None:
            published += 1
            if standing.reaction_s is not None:
                reactions.append(standing.reaction_s)
        if trace is not None and not trace.attrs.get("skipped", True):
            dispatches.append(int(trace.attrs.get("num_dispatches", 0)))
            compiles += len(trace.compile_events)

    reactions.sort()

    def pct(q: float) -> float:
        if not reactions:
            return 0.0
        return reactions[min(int(q * len(reactions)), len(reactions) - 1)]

    return {
        "shifts": shifts,
        "published": published,
        "reaction_p50_s": round(pct(0.50), 4),
        "reaction_p95_s": round(pct(0.95), 4),
        # worst case: drift probe + tracked re-probe (candidate standing) +
        # one fused step per goal + the trailing violation fetch
        "warm_tick_dispatches": max(dispatches) if dispatches else 0,
        "warm_tick_host_syncs": max(dispatches) if dispatches else 0,
        "dispatch_budget": len(GOALS) + 3,
        "warm_compile_events": compiles,
        "warm_start_s": round(warm_start_s, 3),
        "brokers": BROKERS,
        "partitions": PARTITIONS,
    }
