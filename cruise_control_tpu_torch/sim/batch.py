"""Batched scenario evaluation: S hypothetical clusters on one device.

Port of ``cruise_control_tpu/sim/batch.py``.  Two depths over a
:class:`~cruise_control_tpu_torch.sim.scenario.ScenarioBatch`:

* :func:`fast_sweep` -- every scenario's cluster as it is: its per-goal
  violations and balancedness, whether SOME placement could satisfy the hard
  goals (the necessary conditions of ``provision_verdict``: capacity totals,
  replica-count caps, replication factor against alive brokers and racks),
  the broker count they imply, and the offline-movement floor;
* :func:`deep_sweep` -- the full goal walk on every scenario
  (``GoalOptimizer.batched_optimize``, one batch per goal order).

The JAX package evaluates the whole batch as one vmapped program.  Here each
lane's snapshot and violation count run lane after lane through the
single-cluster code (the same launches as inside a solve), while the sweep's
batch-wide sums take few calls for all lanes: the replication factor of every
(lane, partition) is one integer segment-sum call (the kernel of
``sim/batch.py:88`` in the JAX package), alive racks one segment max, and the
float totals go through ``ops.index.xla_sums`` with lane-offset windows -- the
order of XLA's reduce over the middle axis of a vmapped ``[S, n, k]`` sum,
which windows each lane as the unbatched reduce does -- in calls of at most
``ops.index.LANE_CALL_WINDOWS`` windows.  The totals decide
``satisfiable`` and ``min_brokers_needed`` at exactly the edge the planner
bisects to, so they must round as the reference does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import GoalContext
from cruise_control_tpu_torch.analyzer.optimizer import (
    MAX_BALANCEDNESS_SCORE,
    HostSyncs,
    balancedness_cost_by_goal,
    host_fetch,
    lane_violations,
)
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.ops.index import segment_max, xla_sums
from cruise_control_tpu_torch.sim.scenario import (
    Scenario,
    ScenarioBatch,
    apply_scenario,
    broker_bucket,
    build_batch,
)

I32 = torch.int32
F32 = torch.float32
_EPS = 1e-6


# -- the batch-wide sums --------------------------------------------------------------


def sweep_totals(states: ClusterArrays, ctx: GoalContext):
    """The float and count totals of every lane of a stack:
    ``(must-serve load f32[S, 4], usable capacity f32[S, 4], replication
    factors i32[S, P], offline mask bool[S, R], offline disk bytes f32[S])``.

    Must-serve load is every valid replica's follower-equivalent base plus
    each still-replicated partition's leadership delta once (placement-free,
    so it prices the rebalanced cluster); usable capacity is the alive
    brokers' capacity times the capacity thresholds.  Each float sum adds in
    the reference's order (module docstring)."""
    S, R = states.replica_valid.shape
    P = states.partition_topic.shape[1]
    B = states.broker_rack.shape[1]
    valid = states.replica_valid
    offline = states.replica_offline_mask()
    rf = A.replication_factors(states)
    load, off_bytes = xla_sums([
        torch.where(valid[..., None], states.base_load, 0.0).reshape(S * R, -1),
        torch.where(offline, states.base_load[..., Resource.DISK], 0.0).reshape(-1),
    ], lanes=S)
    (delta,) = xla_sums(
        [torch.where((rf > 0)[..., None], states.leadership_delta, 0.0).reshape(S * P, -1)], lanes=S
    )
    thr = ctx.constraint.resource_capacity_threshold
    (usable,) = xla_sums([
        (torch.where(states.broker_alive[..., None], states.broker_capacity, 0.0) * thr).reshape(S * B, -1)
    ], lanes=S)
    return load + delta, usable, rf, offline, off_bytes


def _sweep_reductions(states: ClusterArrays, ctx: GoalContext):
    """``(satisfiable bool[S], min alive brokers needed i32[S], offline
    moves i32[S], offline bytes f32[S])`` of every lane: the hard-goal
    necessary conditions (the vectorized core of ``provision_verdict``, with
    its alive-mean per-broker capacity) and the movement floor."""
    total, usable, rf, offline, off_bytes = sweep_totals(states, ctx)
    S = A.num_lanes(states)
    alive = states.broker_alive
    n_alive = torch.clamp(alive.sum(1, dtype=I32), min=1)
    cap_ok = (total <= usable * (1 + _EPS) + _EPS).all(dim=1)
    per_broker = usable / n_alive.to(F32)[:, None]
    needed_by_res = torch.ceil((total / torch.clamp(per_broker, min=1e-9)).amax(dim=1)).to(I32)

    n_replicas = states.replica_valid.sum(1, dtype=I32)
    max_per_broker = ctx.constraint.max_replicas_per_broker
    count_ok = n_replicas <= n_alive * max_per_broker
    needed_by_count = torch.ceil(
        n_replicas.to(F32) / torch.clamp(max_per_broker, min=1).to(F32)
    ).to(I32)

    rf_max = rf.amax(dim=1)
    racks = states.num_racks
    alive_racks = segment_max(
        alive.to(I32).reshape(-1), A.lane_ids(states.broker_rack, racks), S * racks
    ).view(S, racks).sum(1, dtype=I32)
    sat = cap_ok & count_ok & (rf_max <= n_alive) & (rf_max <= alive_racks)
    needed = torch.maximum(torch.maximum(needed_by_res, needed_by_count), rf_max)
    return sat, needed, offline.sum(1, dtype=I32), off_bytes


# -- shape accounting -------------------------------------------------------------------
#
# A sweep whose shape key was seen before is a bucket hit.  The JAX package
# counts these because a miss compiles; the port keeps the flag in the result.

_SEEN_SHAPES: set = set()


def _note_shape(key: tuple) -> bool:
    """Record the sweep shape; True when it was seen before."""
    hit = key in _SEEN_SHAPES
    _SEEN_SHAPES.add(key)
    return hit


# -- results ------------------------------------------------------------------------


@dataclasses.dataclass
class ScenarioVerdict:
    """Per-scenario outcome of a sweep."""

    name: str
    #: per-goal violating-entity counts of the hypothetical cluster AS-IS
    #: (fast path) or AFTER optimization (deep path)
    violations: Dict[str, float]
    hard_violations: float
    violated_hard_goals: List[str]
    balancedness: float
    #: whether SOME placement can satisfy every hard goal (fast path:
    #: necessary conditions; deep path: no residual hard violations)
    satisfiable: bool
    #: minimum alive brokers implied by the most constrained resource
    min_brokers_needed: int
    #: movement floor: replicas that MUST relocate (offline) and their disk data
    offline_moves: int
    offline_data_to_move: float
    #: deep path only: the full movement bill of the optimized plan
    movement: Optional[Dict[str, float]] = None
    provision_status: Optional[str] = None

    @property
    def verdict(self) -> str:
        if self.hard_violations > 0:
            return "HARD_VIOLATED" if self.satisfiable else "UNSATISFIABLE"
        return "OK" if self.satisfiable else "UNSATISFIABLE"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["verdict"] = self.verdict
        return d


@dataclasses.dataclass
class SweepResult:
    """Outcome of one sweep (fast or deep)."""

    scenarios: List[ScenarioVerdict]
    sweep_size: int
    bucket: Tuple[int, int, int]
    #: points in this sweep where the host waited on the device
    num_host_syncs: int
    #: the sweep's shape key was seen before
    bucket_hit: bool
    duration_s: float
    deep: bool = False
    #: deep path only: each scenario's optimized cluster, on the sweep's
    #: device (the JAX result keeps only the verdicts)
    states: Optional[List[ClusterArrays]] = None

    def to_dict(self) -> dict:
        return {
            "sweep": {
                "size": self.sweep_size,
                "bucketBrokers": self.bucket[0],
                "numHostSyncs": self.num_host_syncs,
                "bucketHit": self.bucket_hit,
                "durationS": round(self.duration_s, 4),
                "deep": self.deep,
            },
            "scenarios": [v.to_dict() for v in self.scenarios],
        }


def _verdicts(
    batch: ScenarioBatch,
    goal_ids: Tuple[int, ...],
    hard_ids: Tuple[int, ...],
    viol: np.ndarray,
    sat: np.ndarray,
    needed: np.ndarray,
    n_off: np.ndarray,
    off_bytes: np.ndarray,
) -> List[ScenarioVerdict]:
    costs = balancedness_cost_by_goal(list(goal_ids), set(hard_ids))
    names = G.GOAL_NAMES
    out: List[ScenarioVerdict] = []
    for i, label in enumerate(batch.names):
        per_goal = {names[g]: float(viol[i, g]) for g in goal_ids}
        violated_hard = [
            names[g] for g in hard_ids if g in goal_ids and viol[i, g] > 0
        ]
        score = MAX_BALANCEDNESS_SCORE - sum(
            costs[g] for g in goal_ids if viol[i, g] > 0
        )
        out.append(
            ScenarioVerdict(
                name=label,
                violations=per_goal,
                hard_violations=float(sum(viol[i, g] for g in hard_ids if g in goal_ids)),
                violated_hard_goals=violated_hard,
                balancedness=float(score),
                satisfiable=bool(sat[i]),
                min_brokers_needed=int(needed[i]),
                offline_moves=int(n_off[i]),
                offline_data_to_move=float(off_bytes[i]),
            )
        )
    return out


# -- public sweeps ------------------------------------------------------------------


def fast_sweep(
    base: ClusterArrays,
    scenarios: Sequence[Scenario],
    constraint: Optional[BalancingConstraint] = None,
    goal_ids: Sequence[int] = G.DEFAULT_GOAL_ORDER,
    hard_ids: Sequence[int] = G.HARD_GOALS,
    enable_heavy: bool = False,
    bucket_brokers: Optional[int] = None,
    device: DeviceLike = None,
) -> SweepResult:
    """Evaluate every scenario's cluster AS-IS on ``device`` (``cuda`` unless
    ``device="cpu"``): per-scenario violation counts (those of each mutated
    cluster evaluated on its own), balancedness, hard-goal satisfiability,
    the implied minimum broker count and the offline-movement floor.  One
    host fetch at the end."""
    t0 = time.monotonic()
    goal_ids = tuple(goal_ids)
    hard_ids = tuple(hard_ids)
    batch = build_batch(base, scenarios, bucket_brokers=bucket_brokers, device=device)
    states = batch.states
    ctx = GoalContext.build(
        base.num_topics, batch.bucket[0], constraint=constraint, device=states.device
    )
    hit = _note_shape((
        batch.size, batch.bucket, int(states.disk_broker.shape[-1]), goal_ids, enable_heavy,
    ))
    syncs = HostSyncs()
    viol = lane_violations(states, ctx, enable_heavy, goal_ids)
    viol, sat, needed, n_off, off_bytes = host_fetch(syncs, [viol, *_sweep_reductions(states, ctx)])
    return SweepResult(
        scenarios=_verdicts(batch, goal_ids, hard_ids, viol, sat, needed, n_off, off_bytes),
        sweep_size=batch.size,
        bucket=batch.bucket,
        num_host_syncs=syncs.count,
        bucket_hit=hit,
        duration_s=time.monotonic() - t0,
    )


def _verdict_from_result(name: str, state: ClusterArrays, result) -> ScenarioVerdict:
    """Map one scenario's post-optimization OptimizerResult to a verdict."""
    return ScenarioVerdict(
        name=name,
        violations=dict(result.violations_after),
        hard_violations=result.residual_hard_violations,
        violated_hard_goals=list(result.violated_hard_goals),
        balancedness=result.balancedness_score,
        satisfiable=not result.violated_hard_goals,
        min_brokers_needed=(
            int(state.broker_alive.sum())
            + result.provision.num_brokers_to_add
            - result.provision.num_brokers_to_remove
        ),
        offline_moves=result.movement.num_inter_broker_moves,
        offline_data_to_move=result.movement.inter_broker_data_to_move,
        movement=dataclasses.asdict(result.movement),
        provision_status=result.provision.status,
    )


def deep_sweep(
    base: ClusterArrays,
    scenarios: Sequence[Scenario],
    constraint: Optional[BalancingConstraint] = None,
    goal_ids: Sequence[int] = G.DEFAULT_GOAL_ORDER,
    hard_ids: Sequence[int] = G.HARD_GOALS,
    enable_heavy: bool = False,
    bucket_brokers: Optional[int] = None,
    batched: bool = True,
    device: DeviceLike = None,
) -> SweepResult:
    """Run the full goal optimizer on every scenario, on ``device`` (``cuda``
    unless ``device="cpu"``).

    ``batched=True``: scenarios sharing a goal order form one stack, moved to
    the device once and solved by one
    :meth:`~cruise_control_tpu_torch.analyzer.optimizer.GoalOptimizer.batched_optimize`
    (a custom ``goal_order`` forms its own group).  ``batched=False`` solves
    scenario after scenario, each a stack of one.  The two differ only in
    how many host copies they make until the solve has a lane axis: each lane
    already runs alone.  Verdicts carry the post-optimization violations, the
    movement bill and the optimizer's provision verdict: what the rebalanced
    hypothetical cluster would look like, where :func:`fast_sweep` says what
    it looks like as it is."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer

    t0 = time.monotonic()
    dev = resolve_device(device)
    goal_ids = tuple(goal_ids)
    hard_ids = tuple(hard_ids)
    scenarios = tuple(scenarios)
    if not scenarios:
        raise ValueError("deep_sweep needs at least one scenario")
    base = base.to("cpu")
    B_need = max(base.num_brokers + s.add_brokers for s in scenarios)
    B_pad = broker_bucket(B_need) if bucket_brokers is None else int(bucket_brokers)
    ctx = GoalContext.build(base.num_topics, B_pad, constraint=constraint, device=dev)

    if batched:
        by_order: Dict[Tuple[int, ...], List[int]] = {}
        for i, sc in enumerate(scenarios):
            by_order.setdefault(tuple(sc.goal_order or goal_ids), []).append(i)
        groups = list(by_order.items())
    else:
        groups = [(tuple(sc.goal_order or goal_ids), [i]) for i, sc in enumerate(scenarios)]

    syncs = 0
    verdicts: List[Optional[ScenarioVerdict]] = [None] * len(scenarios)
    finals: List[Optional[ClusterArrays]] = [None] * len(scenarios)
    all_hit = batched
    for order, idxs in groups:
        per = [apply_scenario(base, scenarios[i], bucket_brokers=B_pad) for i in idxs]
        if batched:
            all_hit &= _note_shape((
                "deep", len(idxs), B_pad, base.num_replicas, base.num_partitions, order,
                enable_heavy,
            ))
        # the state is already padded to the sweep's bucket
        opt = GoalOptimizer(
            goal_ids=order, hard_ids=hard_ids,
            enable_heavy_goals=enable_heavy, bucket_brokers=False, device=dev,
        )
        final, res = opt.batched_optimize(A.stack_arrays(per).to(dev), ctx)
        syncs += res.num_host_syncs
        for j, i in enumerate(idxs):
            finals[i] = A.index_arrays(final, j)
            verdicts[i] = _verdict_from_result(
                scenarios[i].name or f"scenario-{i}", per[j], res.results[j]
            )

    return SweepResult(
        scenarios=verdicts,
        sweep_size=len(scenarios),
        bucket=(B_pad, base.num_replicas, base.num_partitions),
        num_host_syncs=syncs,
        bucket_hit=all_hit,
        duration_s=time.monotonic() - t0,
        deep=True,
        states=finals,
    )
