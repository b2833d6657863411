"""Capacity planner: minimum brokers for hard-goal satisfiability under load x f.

Port of ``cruise_control_tpu/sim/planner.py``.  Each candidate broker count is
a :class:`~cruise_control_tpu_torch.sim.scenario.Scenario` that adds empty
brokers or decommissions the highest-index alive ones, under a global load
factor; the smallest satisfiable count is found by batched bisection: every
round evaluates up to ``chunk`` candidates in one
:func:`~cruise_control_tpu_torch.sim.batch.fast_sweep` and narrows the
bracket around the satisfiability edge (monotone in the broker count: an
empty broker only adds capacity).  The result fills
:attr:`ProvisionRecommendation.sweep`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.optimizer import (
    OVERPROVISIONED_MIN_BROKERS,
    OVERPROVISIONED_MIN_EXTRA_RACKS,
    ProvisionRecommendation,
)
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.sim.batch import deep_sweep, fast_sweep
from cruise_control_tpu_torch.sim.scenario import Scenario, broker_bucket


@dataclasses.dataclass
class Probe:
    """One evaluated candidate broker count."""

    brokers: int
    satisfiable: bool
    min_brokers_needed: int


@dataclasses.dataclass
class CapacityPlan:
    """Outcome of one capacity bisection."""

    #: smallest alive-broker count with every hard goal satisfiable; None when
    #: even the largest probed count cannot satisfy them
    min_brokers: Optional[int]
    current_brokers: int
    load_factor: float
    probes: List[Probe]
    num_host_syncs: int
    duration_s: float
    recommendation: ProvisionRecommendation

    def to_dict(self) -> dict:
        return {
            "minBrokers": self.min_brokers,
            "currentBrokers": self.current_brokers,
            "loadFactor": self.load_factor,
            "numHostSyncs": self.num_host_syncs,
            "durationS": round(self.duration_s, 4),
            "probes": [dataclasses.asdict(p) for p in self.probes],
            "recommendation": {
                "status": self.recommendation.status,
                "message": self.recommendation.message,
                "numBrokersToAdd": self.recommendation.num_brokers_to_add,
                "numBrokersToRemove": self.recommendation.num_brokers_to_remove,
            },
        }


def _count_scenario(
    alive_desc: List[int], base_brokers_alive: int, count: int, load_factor: float
) -> Scenario:
    """The scenario with ``count`` alive brokers under ``load x load_factor``:
    counts above the current cluster add empty brokers, counts below
    decommission the highest-index alive brokers (the satisfiability test
    prices totals, not identities)."""
    if count >= base_brokers_alive:
        return Scenario(
            name=f"brokers={count}",
            add_brokers=count - base_brokers_alive,
            load_factor=load_factor,
        )
    return Scenario(
        name=f"brokers={count}",
        remove_brokers=tuple(alive_desc[: base_brokers_alive - count]),
        load_factor=load_factor,
    )


def plan_capacity(
    base: ClusterArrays,
    constraint: Optional[BalancingConstraint] = None,
    load_factor: float = 1.0,
    goal_ids: Sequence[int] = G.DEFAULT_GOAL_ORDER,
    hard_ids: Sequence[int] = G.HARD_GOALS,
    max_extra_brokers: Optional[int] = None,
    chunk: int = 64,
    deep_verify: bool = False,
    deep_window: int = 3,
    device: DeviceLike = None,
) -> CapacityPlan:
    """Bisect the broker count over :func:`fast_sweep` on ``device``
    (``cuda`` unless ``device="cpu"``).

    ``chunk`` bounds the scenarios per sweep; ``max_extra_brokers`` caps the
    search above the current count (default: double the cluster, floor 8).

    ``deep_verify`` re-checks the pinned edge with the full goal optimizer
    (the fast test is necessary conditions only): the ``deep_window`` counts
    from the edge up run as one :func:`deep_sweep`, extended upward once if
    the optimizer refutes all of them.  A verified count above the edge moves
    the plan up; if every probed count is refuted, the plan floor moves past
    them (``confirmed: false`` in ``sweep["deep_verify"]``), or to the
    unsatisfiable branch when the refutations reach the search cap."""
    dev = resolve_device(device)
    t0 = time.monotonic()
    base = base.to("cpu")
    alive = base.broker_alive.numpy()
    B0 = int(alive.sum())
    alive_desc = [int(b) for b in np.flatnonzero(alive)[::-1]]

    valid = base.replica_valid.numpy()
    rf_max = 1
    if valid.any():
        counts = np.bincount(base.replica_partition.numpy()[valid], minlength=base.num_partitions)
        rf_max = max(int(counts.max()), 1)

    lo = max(rf_max, 1)                       # below RF nothing is satisfiable
    extra = max_extra_brokers if max_extra_brokers is not None else max(B0, 8)
    hi = max(B0 + extra, lo)
    # the bucket holds the largest probe's whole broker axis: the base slots
    # (dead brokers keep theirs) plus the brokers the hi probe adds
    bucket = broker_bucket(base.num_brokers + max(hi - B0, 0))

    probes: List[Probe] = []
    syncs = 0

    def evaluate(counts: List[int]) -> List[Probe]:
        nonlocal syncs
        scs = [_count_scenario(alive_desc, B0, c, load_factor) for c in counts]
        sweep = fast_sweep(
            base, scs, constraint=constraint, goal_ids=goal_ids, hard_ids=hard_ids,
            bucket_brokers=bucket, device=dev,
        )
        syncs += sweep.num_host_syncs
        out = [
            Probe(c, v.satisfiable, v.min_brokers_needed)
            for c, v in zip(counts, sweep.scenarios)
        ]
        probes.extend(out)
        return out

    # batched bisection: each round evaluates <= chunk counts spanning the
    # bracket in one sweep, then narrows to the satisfiability edge
    lo_unsat, hi_sat = lo - 1, None
    span_lo, span_hi = lo, hi
    while span_hi - span_lo + 1 > 0:
        n = span_hi - span_lo + 1
        if n <= chunk:
            counts = list(range(span_lo, span_hi + 1))
        else:
            counts = sorted(
                {int(round(x)) for x in np.linspace(span_lo, span_hi, chunk)}
            )
        round_probes = evaluate(counts)
        sat_counts = [p.brokers for p in round_probes if p.satisfiable]
        unsat_counts = [p.brokers for p in round_probes if not p.satisfiable]
        if sat_counts:
            hi_sat = min(sat_counts) if hi_sat is None else min(hi_sat, min(sat_counts))
        if unsat_counts:
            below = [c for c in unsat_counts if hi_sat is None or c < hi_sat]
            if below:
                lo_unsat = max(lo_unsat, max(below))
        if hi_sat is None:
            break                              # nothing satisfiable up to hi
        if hi_sat - lo_unsat <= 1:
            break                              # edge pinned exactly
        span_lo, span_hi = lo_unsat + 1, hi_sat - 1

    min_brokers = hi_sat

    deep_meta: Optional[dict] = None
    if deep_verify and min_brokers is not None:
        deep_counts: List[int] = []
        deep_sat: List[bool] = []
        deep_syncs = 0
        win_lo = min_brokers
        for _ in range(2):
            counts = list(range(win_lo, min(win_lo + deep_window, hi + 1)))
            if not counts:
                break
            scs = [_count_scenario(alive_desc, B0, c, load_factor) for c in counts]
            deep = deep_sweep(
                base, scs, constraint=constraint, goal_ids=goal_ids, hard_ids=hard_ids,
                bucket_brokers=bucket, device=dev,
            )
            deep_syncs += deep.num_host_syncs
            deep_counts += counts
            deep_sat += [v.satisfiable for v in deep.scenarios]
            if any(deep_sat):
                break
            win_lo = counts[-1] + 1
        syncs += deep_syncs
        sat_counts = [c for c, s in zip(deep_counts, deep_sat) if s]
        deep_min = min(sat_counts) if sat_counts else None
        deep_meta = {
            "counts": deep_counts,
            "deep_min_brokers": deep_min,
            "num_host_syncs": deep_syncs,
            "confirmed": deep_min == min_brokers,
        }
        if deep_min is not None and deep_min > min_brokers:
            # the optimizer needs more than the necessary-conditions floor
            min_brokers = deep_min
        elif deep_min is None and deep_counts:
            # every probed count refuted: never recommend one of them
            min_brokers = deep_counts[-1] + 1 if deep_counts[-1] < hi else None

    racks_in_use = len(set(base.broker_rack.numpy()[alive].tolist()))
    sweep_meta = {
        "scenarios_evaluated": len(probes),
        "num_host_syncs": syncs,
        "load_factor": load_factor,
        "min_brokers": min_brokers,
        "current_brokers": B0,
        "bucket_brokers": bucket,
    }
    if deep_meta is not None:
        sweep_meta["deep_verify"] = deep_meta

    if min_brokers is None:
        needed = max((p.min_brokers_needed for p in probes), default=hi + 1)
        rec = ProvisionRecommendation(
            status="UNDER_PROVISIONED",
            violated_hard_goals=[],
            message=(
                f"hard goals unsatisfiable even at {hi} brokers under load × "
                f"{load_factor:g}; most constrained resource implies ≥ {needed} "
                f"brokers ({len(probes)} scenarios, {syncs} host syncs)"
            ),
            num_brokers_to_add=max(needed - B0, hi + 1 - B0),
            sweep=sweep_meta,
        )
    elif min_brokers > B0:
        rec = ProvisionRecommendation(
            status="UNDER_PROVISIONED",
            violated_hard_goals=[],
            message=(
                f"add {min_brokers - B0} broker(s): minimum satisfiable count "
                f"under load × {load_factor:g} is {min_brokers} (current {B0}; "
                f"{len(probes)} scenarios, {syncs} host syncs)"
            ),
            num_brokers_to_add=min_brokers - B0,
            sweep=sweep_meta,
        )
    else:
        floor = max(min_brokers, OVERPROVISIONED_MIN_BROKERS)
        surplus = B0 - floor
        if surplus > 0 and racks_in_use >= rf_max + OVERPROVISIONED_MIN_EXTRA_RACKS:
            rec = ProvisionRecommendation(
                status="OVER_PROVISIONED",
                violated_hard_goals=[],
                message=(
                    f"remove up to {surplus} broker(s): load × {load_factor:g} "
                    f"fits on {floor} of {B0} brokers "
                    f"({len(probes)} scenarios, {syncs} host syncs)"
                ),
                num_brokers_to_remove=surplus,
                sweep=sweep_meta,
            )
        else:
            rec = ProvisionRecommendation(
                status="RIGHT_SIZED",
                violated_hard_goals=[],
                message=(
                    f"right-sized: minimum satisfiable count under load × "
                    f"{load_factor:g} is {min_brokers} of {B0} brokers "
                    f"({len(probes)} scenarios, {syncs} host syncs)"
                ),
                sweep=sweep_meta,
            )

    return CapacityPlan(
        min_brokers=min_brokers,
        current_brokers=B0,
        load_factor=load_factor,
        probes=sorted(probes, key=lambda p: p.brokers),
        num_host_syncs=syncs,
        duration_s=time.monotonic() - t0,
        recommendation=rec,
    )
