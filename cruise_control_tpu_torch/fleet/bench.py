"""Shared fleet-bench harness: warm fleet-tick dispatch/compile census.

Port of ``cruise_control_tpu/fleet/bench.py``, with the same pinned workload.
The fleet solves on ``device`` (``cuda`` unless ``device="cpu"``).  Its
dispatch counts are the port's host syncs (``fleet/controller.py``): every
``*dispatches`` key has a ``*host_syncs`` twin with the same number, and
``dispatch_budget`` stays the JAX package's.  Compile events are ``nvcc``
kernel builds.

The workload: ``num_tenants`` copies of the pinned single-tenant bench
cluster (``controller/bench.py`` — same brokers, partitions, goal list), all
landing in ONE goal-order group.  After ``FleetController.warm()``, each
measured shift pumps every tenant's tracked placement past the
disk-capacity threshold so every tenant's lane is drift-triggered, then one
fleet tick runs.

Measured per shift, from the tick's attributes and its ``fleet_tick`` flight
record: the batched drift probe (ONE for the whole fleet), the tick's host
syncs, the kernel builds (ZERO when warm), and the tenants that publish.
"""

from __future__ import annotations

import time
from typing import Dict, List

from cruise_control_tpu_torch.controller.bench import (
    BASE_LOAD,
    BROKERS,
    GOALS,
    HOT_DISK,
    NUM_WINDOWS,
    PARTITIONS,
    SHIFTS,
    WINDOW_MS,
    build_cluster,
    hot_partitions_on,
    warm_window_clock,
)
from cruise_control_tpu_torch.core.device import DeviceLike
from cruise_control_tpu_torch.fleet.controller import FleetConfig, FleetController

#: pinned fleet width: the JAX harness's own, so the two packages' dicts compare
NUM_TENANTS = 32


def build_fleet_harness(
    num_tenants: int = NUM_TENANTS,
    journal_dir: str = None,
    config: FleetConfig = None,
    device: DeviceLike = None,
):
    """(fleet, backends, monitors, now_ms): ``num_tenants`` identical pinned
    clusters registered on one fleet on ``device``, every monitor's window
    ring warmed.  The fleet is NOT warmed — callers choose when to pay the
    kernel builds."""
    fleet = FleetController(
        config=config
        or FleetConfig(
            tick_interval_s=3_600.0,   # cadence off: drift is the trigger
            drift_threshold=1.0,
        ),
        journal_dir=journal_dir,
        device=device,
    )
    backends: List = []
    monitors: List = []
    for t in range(num_tenants):
        backend, monitor, cc = build_cluster(device=device)
        fleet.add_tenant(f"tenant{t:02d}", cc)
        backends.append(backend)
        monitors.append(monitor)
    now = warm_window_clock()
    for w in range(NUM_WINDOWS + 2):
        ts = now + w * WINDOW_MS
        for monitor in monitors:
            monitor.sample_once(now_ms=ts)
    return fleet, backends, monitors, now + (NUM_WINDOWS + 2) * WINDOW_MS


def run_bench(
    num_tenants: int = NUM_TENANTS, shifts: int = SHIFTS, device: DeviceLike = None
) -> Dict[str, object]:
    """The measurement record of ``shifts`` warm fleet ticks."""
    from cruise_control_tpu_torch.obs import RECORDER

    fleet, backends, monitors, now_ms = build_fleet_harness(num_tenants, device=device)

    t0 = time.monotonic()
    fleet.warm()   # warm_start per tenant + the kernel builds (on the card)
    warm_s = time.monotonic() - t0

    def _feed_shift(now: int) -> int:
        """Two windows per shift: the shifted samples land in window w, the
        second sample opens w+1 so w goes STABLE and every tenant's listener
        pushes a delta carrying the shifted loads."""
        now += WINDOW_MS
        for monitor in monitors:
            monitor.sample_once(now_ms=now)
        now += WINDOW_MS
        for monitor in monitors:
            monitor.sample_once(now_ms=now)
        return now

    def _pump(victim: int, prev: List[List]) -> List[List]:
        """Overload ``victim``'s tracked partitions on EVERY tenant (and cool
        the previous victims): every lane of the group drift-triggers."""
        hots = []
        for t, backend in enumerate(backends):
            for tp in prev[t] if prev else []:
                backend.set_partition_load(tp, list(BASE_LOAD))
            rt = fleet.tenant(fleet.tenant_names[t])
            hot = hot_partitions_on(rt.controller, victim)
            for tp in hot:
                backend.set_partition_load(tp, [0.2, 50.0, 50.0, HOT_DISK])
            hots.append(hot)
        return hots

    # one unmeasured shift settles initial placements + drift baselines
    prev_hot = _pump(0, [])
    now_ms = _feed_shift(now_ms)
    fleet.maybe_tick()

    tick_walls: List[float] = []
    dispatches: List[int] = []
    probe_dispatches: List[int] = []
    compiles = 0
    published = 0
    groups_seen = set()
    for k in range(shifts):
        prev_hot = _pump((k + 1) % BROKERS, prev_hot)
        now_ms = _feed_shift(now_ms)
        tw = time.monotonic()
        attrs = fleet.maybe_tick()
        tick_walls.append(time.monotonic() - tw)
        trace = next(iter(RECORDER.recent(1, kind="fleet_tick")), None)
        if attrs is not None:
            published += int(attrs.get("published", 0))
            dispatches.append(int(attrs.get("num_dispatches", 0)))
            probe_dispatches.append(int(attrs.get("probe_dispatches", 0)))
            groups_seen.add(int(attrs.get("groups", 0)))
        if trace is not None:
            compiles += len(trace.compile_events)

    tick_walls.sort()

    def pct(vals: List[float], q: float) -> float:
        if not vals:
            return 0.0
        return vals[min(int(q * len(vals)), len(vals) - 1)]

    return {
        "num_tenants": num_tenants,
        "shifts": shifts,
        "published": published,
        "groups": max(groups_seen) if groups_seen else 0,
        # identical tenants ⇒ ONE goal-order group ⇒ ONE batched probe per tick
        "warm_probe_dispatches": max(probe_dispatches) if probe_dispatches else 0,
        "warm_probe_host_syncs": max(probe_dispatches) if probe_dispatches else 0,
        # the probe's and the batched solve's host syncs for the one group
        "warm_tick_dispatches": max(dispatches) if dispatches else 0,
        "warm_tick_host_syncs": max(dispatches) if dispatches else 0,
        "dispatch_budget": len(GOALS) + 4,
        "warm_compile_events": compiles,
        "tenants_per_dispatch": (
            round(num_tenants / max(probe_dispatches), 2)
            if probe_dispatches and max(probe_dispatches)
            else 0.0
        ),
        "tick_wall_p50_s": round(pct(tick_walls, 0.50), 4),
        "tick_wall_p95_s": round(pct(tick_walls, 0.95), 4),
        "warm_s": round(warm_s, 3),
        "brokers": BROKERS,
        "partitions": PARTITIONS,
    }
