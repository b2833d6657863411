"""GoalOptimizer: lexicographic multi-goal optimization over cluster tensors.

Port of the single-cluster path of ``cruise_control_tpu/analyzer/optimizer.py``
(the reference's ``GoalOptimizer.optimizations``, GoalOptimizer.java:435-524,
and ``AbstractGoal.optimize``, AbstractGoal.java:82-135):

* goals run in priority order; each goal's work is a sequence of batched
  round types ("phases") driven to convergence, cycled until a full pass
  applies nothing (at most :data:`MAX_GOAL_PASSES` passes);
* every applied action passed every prior goal's acceptance kernel against
  the pre-round state, so later goals never violate earlier ones;
* hard-goal failure is recorded per goal plus a provisioning verdict;
* KafkaAssignerEvenRackAwareGoal (which must come first) is a constructive
  full placement (:mod:`.kafka_assigner`), one step instead of rounds.

The JAX package compiles each phase into one ``lax.while_loop`` and each
goal, with its pass cycle, into one dispatch.  The port keeps that layout as
a carry, a body and a condition (:class:`PhaseCarry`, :func:`phase_body`,
:func:`phase_cond`), with two drivers of the same body:

* on the card (no ``spmd``), the device loop
  (:mod:`cruise_control_tpu_torch.analyzer.device_loop`): each phase's round
  is captured once into a CUDA graph and a goal is one graph launch whose
  WHILE nodes evaluate the conditions on the device; the rounds and moves
  come back with the solve's other scalars in one fetch;
* on the CPU, and on the sharded path (``spmd``: its gloo collectives stage
  through the host and cannot be captured), a Python loop that reads the
  condition once a round, one host synchronisation a round.

The result reports the host waits as ``num_host_syncs``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.acceptance import accept_all
from cruise_control_tpu_torch.analyzer.context import (
    GoalContext,
    pad_context_brokers,
    take_snapshot,
)
from cruise_control_tpu_torch.analyzer.goal_rounds import (
    GOAL_ROUNDS,
    offline_round,
    offline_round_relaxed,
)
from cruise_control_tpu_torch.analyzer.kafka_assigner import even_rack_aware_assign
from cruise_control_tpu_torch.analyzer.moves import admit, apply_moves, move_effects
from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal, diff as diff_proposals
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.model import stats as S
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.obs.profiler import PROFILER

FAST_MODE_MAX_ROUNDS = 64
#: cap on phase-cycle repetitions per goal; a pass that applies zero actions
#: ends the cycle early
MAX_GOAL_PASSES = 8


class OptimizationFailure(Exception):
    """A hard goal could not be satisfied (OptimizationFailureException)."""


#: KafkaCruiseControlUtils.java:102
MAX_BALANCEDNESS_SCORE = 100.0
#: AnalyzerConfig.java:375,385 — goal.balancedness.priority/strictness.weight
DEFAULT_PRIORITY_WEIGHT = 1.1
DEFAULT_STRICTNESS_WEIGHT = 1.5


def balancedness_cost_by_goal(
    goal_ids: Sequence[int],
    hard_ids,
    priority_weight: float = DEFAULT_PRIORITY_WEIGHT,
    strictness_weight: float = DEFAULT_STRICTNESS_WEIGHT,
) -> Dict[int, float]:
    """Cost of violating each goal, summing to MAX_BALANCEDNESS_SCORE
    (``KafkaCruiseControlUtils.balancednessCostByGoal``, :844)."""
    if not goal_ids:
        return {}
    costs: Dict[int, float] = {}
    weight = 1.0
    total = 0.0
    for gid in reversed(list(goal_ids)):
        cost = weight * (strictness_weight if gid in hard_ids else 1.0)
        costs[gid] = cost
        total += cost
        weight *= priority_weight
    return {g: MAX_BALANCEDNESS_SCORE * c / total for g, c in costs.items()}


@dataclasses.dataclass
class GoalReport:
    goal_id: int
    name: str
    is_hard: bool
    violations_before: float
    violations_after: float
    rounds: int
    moves_applied: int
    duration_s: float

    @property
    def satisfied(self) -> bool:
        return self.violations_after == 0


@dataclasses.dataclass
class ProvisionRecommendation:
    """UNDER/OVER_PROVISIONED verdict with numeric sizing (ProvisionResponse.java)."""

    status: str
    violated_hard_goals: List[str]
    message: str
    num_brokers_to_add: int = 0
    num_brokers_to_remove: int = 0
    #: capacity-sweep evidence (sim/planner.py): scenario and host-sync counts
    #: and the measured minimum broker count; None when no sweep backs it
    sweep: Optional[Dict[str, object]] = None


OVERPROVISIONED_MIN_BROKERS = 3
OVERPROVISIONED_MIN_EXTRA_RACKS = 2
OVERPROVISIONED_MAX_REPLICAS_PER_BROKER = 1500


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def provision_verdict(
    state: ClusterArrays, ctx: GoalContext, violated_hard: List[str]
) -> ProvisionRecommendation:
    """Size the cluster against its load: UNDER when hard goals are unsatisfied
    (recommend the broker deficit of the most constrained resource), OVER when
    the load fits on materially fewer brokers, else RIGHT_SIZED.  Host-side
    numpy; pass a CPU state to keep it off the device."""
    alive = _np(state.broker_alive)
    n_alive = max(int(alive.sum()), 1)
    rp = _np(state.replica_partition)
    rb = _np(state.replica_broker)
    rvalid = _np(state.replica_valid)
    lead = (_np(state.partition_leader)[rp] == np.arange(rp.shape[0], dtype=np.int64)) & rvalid
    eff = _np(state.base_load).astype(np.float32) + np.where(
        lead[:, None], _np(state.leadership_delta).astype(np.float32)[rp], 0.0
    )
    eff = np.where(rvalid[:, None], eff, 0.0)
    bload = np.zeros((state.num_brokers, eff.shape[1]), np.float32)
    np.add.at(bload, rb, eff)
    cap = _np(state.broker_capacity)
    thr = _np(ctx.constraint.resource_capacity_threshold)
    total_load = bload[alive].sum(axis=0)
    usable_per_broker = (cap[alive].mean(axis=0) if alive.any() else cap.mean(axis=0)) * thr
    needed_by_res = int(np.ceil((total_load / np.maximum(usable_per_broker, 1e-9)).max()))
    rf_max = 0
    if rvalid.any():
        counts = np.bincount(rp[rvalid], minlength=state.num_partitions)
        rf_max = int(counts.max())
    needed_by_count = int(np.ceil(rvalid.sum() / OVERPROVISIONED_MAX_REPLICAS_PER_BROKER))
    needed = max(needed_by_res, needed_by_count, rf_max, OVERPROVISIONED_MIN_BROKERS)

    if violated_hard:
        deficit = max(needed - n_alive, 1)
        return ProvisionRecommendation(
            status="UNDER_PROVISIONED",
            violated_hard_goals=violated_hard,
            message=(
                f"Add at least {deficit} broker(s): hard goals unsatisfiable: "
                + ", ".join(violated_hard)
            ),
            num_brokers_to_add=deficit,
        )

    racks_in_use = len(set(_np(state.broker_rack)[alive].tolist()))
    surplus = n_alive - needed
    if surplus > 0 and racks_in_use >= rf_max + OVERPROVISIONED_MIN_EXTRA_RACKS:
        return ProvisionRecommendation(
            status="OVER_PROVISIONED",
            violated_hard_goals=[],
            message=(
                f"Remove up to {surplus} broker(s): the load fits on {needed} "
                f"of {n_alive} alive brokers under the capacity thresholds."
            ),
            num_brokers_to_remove=surplus,
        )
    return ProvisionRecommendation(
        status="RIGHT_SIZED",
        violated_hard_goals=[],
        message="Cluster is right-sized for the configured hard goals.",
    )


@dataclasses.dataclass
class MovementStats:
    """Movement volume of a proposal set (OptimizerResult.java's
    numInterBrokerReplicaMovements / dataToMoveMB / ...), in DISK-load units."""

    num_inter_broker_moves: int = 0
    num_intra_broker_moves: int = 0
    num_leadership_moves: int = 0
    inter_broker_data_to_move: float = 0.0
    intra_broker_data_to_move: float = 0.0


def movement_stats(initial: ClusterArrays, final: ClusterArrays) -> MovementStats:
    """Diff two placements into movement volume (host-side, post-solve)."""
    valid = _np(initial.replica_valid) & _np(final.replica_valid)
    b0 = _np(initial.replica_broker)
    b1 = _np(final.replica_broker)
    d0 = _np(initial.replica_disk)
    d1 = _np(final.replica_disk)
    disk_load = _np(initial.base_load)[:, Resource.DISK]

    inter = valid & (b0 != b1)
    intra = valid & (b0 == b1) & (d0 != d1)
    # partitions whose leader ends on another broker; leaderless (-1) rows
    # must not index the replica arrays
    l0 = _np(initial.partition_leader)
    l1 = _np(final.partition_leader)
    has_leader = (l0 >= 0) & (l1 >= 0)
    lead_moved = has_leader & (b0[np.maximum(l0, 0)] != b1[np.maximum(l1, 0)])

    return MovementStats(
        num_inter_broker_moves=int(inter.sum()),
        num_intra_broker_moves=int(intra.sum()),
        num_leadership_moves=int(lead_moved.sum()),
        inter_broker_data_to_move=float(disk_load[inter].sum()),
        intra_broker_data_to_move=float(disk_load[intra].sum()),
    )


@dataclasses.dataclass
class OptimizerResult:
    """Counterpart of ``analyzer/OptimizerResult.java``."""

    goal_reports: List[GoalReport]
    violations_before: Dict[str, float]
    violations_after: Dict[str, float]
    stats_before: Dict[str, object]
    stats_after: Dict[str, object]
    proposals: List[ExecutionProposal]
    provision: ProvisionRecommendation
    total_moves: int
    duration_s: float
    movement: MovementStats = dataclasses.field(default_factory=MovementStats)
    #: points in this optimize where the host waited on the device
    num_host_syncs: int = 0
    #: the deadline (optimize.deadline.ms) expired mid-walk: the placement is
    #: the best-so-far state after the goals that did run
    degraded: bool = False

    @property
    def violated_hard_goals(self) -> List[str]:
        return [r.name for r in self.goal_reports if r.is_hard and not r.satisfied]

    @property
    def residual_soft_violations(self) -> float:
        return sum(r.violations_after for r in self.goal_reports if not r.is_hard)

    @property
    def residual_hard_violations(self) -> float:
        return sum(self.violations_after[n] for n in self.violated_hard_goals)

    @property
    def balancedness_score(self) -> float:
        """MAX minus the weighted cost of each violated goal (priority weight
        1.1 per level, strictness weight 1.5 for hard goals)."""
        ids = [r.goal_id for r in self.goal_reports]
        hard = {r.goal_id for r in self.goal_reports if r.is_hard}
        costs = balancedness_cost_by_goal(ids, hard)
        score = MAX_BALANCEDNESS_SCORE
        for r in self.goal_reports:
            if not r.satisfied:
                score -= costs[r.goal_id]
        return score


@dataclasses.dataclass
class IncrementalResult:
    """Outcome of one :meth:`GoalOptimizer.incremental_optimize` pass: only
    the goals violated in the input ran, each capped at ``max_rounds`` rounds
    a phase, from the current placement.  The violation vectors are numpy
    ``[NUM_GOALS]`` arrays indexed by goal id."""

    goals_run: List[str]
    violations_before: "object"       # np.ndarray [NUM_GOALS]
    violations_after: "object"        # np.ndarray [NUM_GOALS]
    total_moves: int
    total_rounds: int
    num_host_syncs: int
    duration_s: float

    @property
    def residual_violations(self) -> float:
        return float(self.violations_after.sum())


@dataclasses.dataclass
class BatchedIncrementalResult:
    """Outcome of one :meth:`GoalOptimizer.batched_incremental_optimize`
    pass: ``results[i]`` is lane *i*'s own result; ``goals_run`` is the union
    of drifted goals the walk ran and ``num_host_syncs`` counts the whole
    batch."""

    results: List[IncrementalResult]
    goals_run: List[str]
    batch_size: int
    num_host_syncs: int
    duration_s: float


@dataclasses.dataclass
class BatchedResult:
    """Outcome of one :meth:`GoalOptimizer.batched_optimize` call:
    ``results[i]`` is lane *i*'s result; ``num_host_syncs`` counts the whole
    batch, and each lane's result carries the same number."""

    results: List[OptimizerResult]
    batch_size: int
    num_host_syncs: int
    duration_s: float


class HostSyncs:
    """Counts the points where the host waits on the device.  ``runs`` holds
    the device-loop goals (``device_loop.GoalRun``) whose trip counts the next
    :func:`host_fetch` brings back with its own values."""

    def __init__(self) -> None:
        self.count = 0
        self.runs: list = []

    def tolist(self, t: torch.Tensor):
        self.count += 1
        return t.tolist()

    def wait(self, event: torch.cuda.Event) -> None:
        """Wait for the device to reach ``event`` (one counted wait)."""
        self.count += 1
        event.synchronize()

    def settle(self) -> None:
        """Fetch the trip counts of the device-loop goals still open (one
        counted fetch when there are any): a walk that stops early."""
        if self.runs:
            host_fetch(self, [])

    def state(self, state: ClusterArrays) -> ClusterArrays:
        """A CPU copy of ``state`` (one wait, then plain copies)."""
        if state.device.type == "cpu":
            return state
        self.count += 1
        return state.to("cpu")


def _np_mask(ids: Tuple[int, ...]) -> np.ndarray:
    """Host-side goal mask: acceptance skips disabled goals in Python."""
    m = np.zeros(G.NUM_GOALS, bool)
    if ids:
        m[list(ids)] = True
    return m


@dataclasses.dataclass
class PhaseCarry:
    """The carry of one phase's while loop, as in the JAX package: the state
    and int32 device scalars -- ``it`` (rounds run; it salts the proposers'
    tie-breaking), ``total`` (moves applied), ``streak`` (zero-move rounds in
    a row) and ``windows`` (the last round's rotation length)."""

    state: ClusterArrays
    it: torch.Tensor
    total: torch.Tensor
    streak: torch.Tensor
    windows: torch.Tensor


def phase_carry(state: ClusterArrays) -> PhaseCarry:
    """A phase's first carry: no rounds, no moves, one window."""
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    return PhaseCarry(state, zero, zero, zero, torch.ones_like(zero))


def phase_body(
    carry: PhaseCarry, ctx: GoalContext, *, round_fn: Callable, enable_heavy: bool,
    prior_mask: np.ndarray, admit_mask: np.ndarray, needs: frozenset, spmd=None,
) -> PhaseCarry:
    """One round of a phase (the JAX ``_phase_loop`` body): snapshot,
    propose, accept against the prior goals, admit, apply.  No host read and
    no host-to-device copy, so the device loop can capture it."""
    state = carry.state
    snap = take_snapshot(state, ctx, enable_heavy, needs, spmd)
    moves = round_fn(state, ctx, snap, prior_mask, carry.it)
    eff = move_effects(state, moves, snap)
    ok = moves.valid & accept_all(state, ctx, snap, moves, eff, prior_mask)
    keep = admit(state, ctx, snap, moves, ok, eff, admit_mask)
    n = keep.sum(dtype=torch.int32)
    state = apply_moves(state, moves, keep, spmd)
    windows = moves.windows.to(torch.int32) if moves.windows is not None else torch.ones_like(n)
    streak = torch.where(n > 0, torch.zeros_like(carry.streak), carry.streak + 1)
    return PhaseCarry(state, carry.it + 1, carry.total + n, streak, windows)


def phase_cond(carry: PhaseCarry, max_rounds: int) -> torch.Tensor:
    """bool: the phase runs another round (the JAX ``_phase_loop`` cond).
    With capped sources a zero-move round only proves its window stuck, so
    the phase stops after as many zero-move rounds in a row as the batch
    reports rotation ``windows``, or at ``max_rounds``."""
    return (carry.streak < carry.windows) & (carry.it < max_rounds)


def _phase_loop(
    state: ClusterArrays, ctx: GoalContext, *, round_fn: Callable, max_rounds: int,
    enable_heavy: bool, prior_ids: Tuple[int, ...], admit_ids: Tuple[int, ...],
    needs: frozenset, syncs: HostSyncs, spmd=None,
) -> Tuple[ClusterArrays, int, int]:
    """The host driver of one phase: ``(state, rounds, moves)``, rounds and
    moves as host ints.  It reads :func:`phase_cond` once a round, with the
    round and move counts (one host sync a round); the first test needs no
    read, since a fresh carry passes it whenever ``max_rounds > 0``.

    ``prior_ids`` gates single-action acceptance; ``admit_ids`` (normally prior
    plus the current goal) bounds the cumulative admission; ``needs`` names
    the optional snapshot groups the rounds read.

    ``spmd`` (parallel.spmd.SpmdInfo) runs the body on this rank's block of
    the replica axis: the snapshot merges its reductions in one fold over
    the ranks (and one min merge where a goal needs the per-group firsts),
    the proposers merge candidates through the rank mesh, the
    slot pipeline runs replicated on the row table and the apply writes
    owner-local rows.  The round's move count and windows come from
    replicated tensors, so every rank takes the same host-side decisions."""
    prior_mask = _np_mask(prior_ids)
    admit_mask = _np_mask(admit_ids)
    carry = phase_carry(state)
    go, it, total = max_rounds > 0, 0, 0
    while go:
        carry = phase_body(
            carry, ctx, round_fn=round_fn, enable_heavy=enable_heavy, prior_mask=prior_mask,
            admit_mask=admit_mask, needs=needs, spmd=spmd,
        )
        go, it, total = syncs.tolist(torch.stack([
            phase_cond(carry, max_rounds).to(torch.int32), carry.it, carry.total,
        ]))
    return carry.state, it, total


def _goal_step_fn(
    state: ClusterArrays, ctx: GoalContext, *, gid: int, round_fns, max_rounds: int,
    enable_heavy: bool, prior_ids, admit_ids, syncs: HostSyncs, spmd=None,
):
    """One goal on the host driver: its round-type phases cycled until a pass
    applies nothing (or MAX_GOAL_PASSES), plus its own violation count before
    and after (0-d tensors, left on the device).  Rounds and moves are host
    ints, known from the phases' per-round reads."""
    needs = _goal_needs(gid, prior_ids)
    snap0 = take_snapshot(state, ctx, enable_heavy, needs, spmd)
    before = G.violations_one(gid, state, ctx, snap0)
    rounds = moves = 0
    pass_moves, passes = 1, 0
    max_passes = _max_passes(round_fns)
    while pass_moves > 0 and passes < max_passes:
        pass_moves = 0
        for fn in round_fns:
            state, r, m = _phase_loop(
                state, ctx, round_fn=fn, max_rounds=max_rounds, enable_heavy=enable_heavy,
                prior_ids=prior_ids, admit_ids=admit_ids, needs=needs, syncs=syncs, spmd=spmd,
            )
            rounds += r
            moves += m
            pass_moves += m
        passes += 1
    snap1 = take_snapshot(state, ctx, enable_heavy, needs, spmd)
    after = G.violations_one(gid, state, ctx, snap1)
    return state, rounds, moves, before, after


def _goal_needs(gid: int, prior_ids) -> frozenset:
    """The snapshot groups a goal's rounds read: its own and its priors' acceptance."""
    return G.goal_snapshot_needs(gid) | G.prior_acceptance_needs(prior_ids)


def _goal_phases(gid: int, round_fns, prior_ids, admit_ids) -> list:
    """A goal's phases for the device loop: ``(round_fn, prior_ids,
    admit_ids, needs)`` each."""
    needs = _goal_needs(gid, prior_ids)
    return [(fn, tuple(prior_ids), tuple(admit_ids), needs) for fn in round_fns]


def _max_passes(round_fns) -> int:
    """The pass cycle's cap.  A single phase already ran to convergence: a
    second pass would be a zero-move rotation, so single-phase goals make one
    pass."""
    return 1 if len(round_fns) == 1 else MAX_GOAL_PASSES


def _goal_step_device(
    loops, state: ClusterArrays, ctx: GoalContext, *, gid: int, round_fns, max_rounds: int,
    enable_heavy: bool, prior_ids, admit_ids, syncs: HostSyncs,
):
    """One goal on the device driver (``device_loop.DeviceLoops``): the same
    phases and pass cycle as :func:`_goal_step_fn`, as one graph launch.
    Returns ``(state, rounds, moves, before, after)``, all but the state as
    0-d device tensors; the launch's trip counts wait in ``syncs.runs`` for
    the solve's next :func:`host_fetch`."""
    needs = _goal_needs(gid, prior_ids)
    before = G.violations_one(gid, state, ctx, take_snapshot(state, ctx, enable_heavy, needs))
    state, run = loops.run(
        state, ctx, _goal_phases(gid, round_fns, prior_ids, admit_ids), enable_heavy=enable_heavy, max_passes=_max_passes(round_fns),
        max_rounds=max_rounds, name=G.GOAL_NAMES[gid],
    )
    syncs.runs.append(run)
    after = G.violations_one(gid, state, ctx, take_snapshot(state, ctx, enable_heavy, needs))
    return state, run.rounds, run.moves, before, after


def _assigner_step_fn(state: ClusterArrays, ctx: GoalContext, *, max_rf: int, enable_heavy: bool):
    """KafkaAssignerEvenRackAwareGoal as one step: the constructive even,
    rack-aware placement plus the goal's own violations before and after.
    Returns ``(state, rounds, moves, before, after, unassigned)``, the last
    four as 0-d tensors; ``unassigned`` counts replica slots no eligible
    broker could take."""
    gid = G.KAFKA_ASSIGNER_RACK
    needs = G.goal_snapshot_needs(gid)
    before = G.violations_one(gid, state, ctx, take_snapshot(state, ctx, enable_heavy, needs))
    state, moves, unassigned = even_rack_aware_assign(state, ctx, max_rf=max_rf)
    after = G.violations_one(gid, state, ctx, take_snapshot(state, ctx, enable_heavy, needs))
    return state, 1, moves, before, after, unassigned


def _max_replication_factor(state: ClusterArrays, syncs: HostSyncs) -> int:
    """The largest replica count of any partition of a state, or of any lane
    of a stack (at least 1): the number of position passes of the
    kafka-assigner placement.  A batch's passes all run to its largest, as in
    the JAX package, where the position loop is one static bound for every
    lane; passes past a lane's own replication factor place nothing.  One host
    read."""
    rf = A.replication_factors(state)
    return max(syncs.tolist(rf.amax()) if rf.numel() else 0, 1)


def _violations_fn(state: ClusterArrays, ctx: GoalContext, enable_heavy: bool = False, subset=None, spmd=None):
    """f32[NUM_GOALS] of one state, f32[S, NUM_GOALS] of a stack: one
    snapshot and one violation pass."""
    snap = take_snapshot(state, ctx, enable_heavy, G.violation_needs(subset), spmd)
    return G.violations_all(state, ctx, snap, subset=subset)


def lane_violations(states: ClusterArrays, ctx: GoalContext, enable_heavy: bool, subset) -> torch.Tensor:
    """f32[S, NUM_GOALS]: the violation counts of every lane of a stack, left
    on the device -- ONE lane-form ``take_snapshot`` and ONE
    ``violations_all`` for the whole stack, the JAX package's vmapped
    ``_violations_b_fn``.  Each lane equals ``_violations_fn`` on that lane."""
    return _violations_fn(states, ctx, enable_heavy, subset)


def host_fetch(syncs: HostSyncs, values: Sequence) -> list:
    """Host values of a list of tensors and Python numbers: the numbers as
    they are, every tensor in ONE host fetch (through float64, which holds
    int32 and float32 exactly), each back as a numpy array of its own dtype
    and shape.

    The trip counts of the device-loop goals in ``syncs.runs`` ride along in
    the same fetch, and each goal's captured kernel calls are then added to
    the wrappers' counters and the census, times its trips."""
    runs, syncs.runs = syncs.runs, []
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    trips = [r.trips for r in runs]
    if not tensors and not trips:
        return list(values)
    flat = syncs.tolist(torch.cat([t.reshape(-1).to(torch.float64) for t in tensors + trips]))
    k = sum(t.numel() for t in tensors)
    for r in runs:
        n = r.trips.numel()
        r.account(flat[k:k + n])
        k += n
    out, k = [], 0
    for v in values:
        if isinstance(v, torch.Tensor):
            n = v.numel()
            dtype = np.dtype(str(v.dtype).replace("torch.", ""))
            out.append(np.asarray(flat[k:k + n], np.float64).astype(dtype).reshape(tuple(v.shape)))
            k += n
        else:
            out.append(v)
    return out


def _host_violations(syncs: HostSyncs, violations) -> np.ndarray:
    """A caller's violation vector or matrix as numpy (a tensor costs one fetch)."""
    if isinstance(violations, torch.Tensor):
        return host_fetch(syncs, [violations])[0]
    return np.asarray(violations)


class GoalOptimizer:
    """Runs a prioritized goal list over a cluster state.

    ``goal_ids`` defaults to the reference's default goal list
    (AnalyzerConfig.java:352-368) and ``hard_ids`` to its default hard goals
    (:337-344).  ``device`` is where the solve runs: ``cuda`` unless
    ``device="cpu"`` is passed; with no GPU and no explicit CPU it raises.
    """

    #: the rank mesh of a sharded solve (``parallel.solver``); None here
    mesh = None
    #: the replica-axis sharding of the solve in progress (parallel.spmd.SpmdInfo)
    _spmd = None

    def __init__(
        self,
        goal_ids: Sequence[int] = G.DEFAULT_GOAL_ORDER,
        hard_ids: Sequence[int] = G.HARD_GOALS,
        max_rounds_per_phase: int = 2000,
        enable_heavy_goals: bool = True,
        bucket_brokers: Optional[bool] = None,
        deadline_s: Optional[float] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.deadline_s = deadline_s
        self.enable_heavy_goals = enable_heavy_goals
        self.goal_ids = tuple(
            g for g in goal_ids if enable_heavy_goals or g not in G.HEAVY_GOALS
        )
        G.check_goal_ids(self.goal_ids)
        # the kafka-assigner goal is a full placement: anywhere but first it
        # would discard every earlier goal's work
        if G.KAFKA_ASSIGNER_RACK in self.goal_ids and self.goal_ids[0] != G.KAFKA_ASSIGNER_RACK:
            raise ValueError(
                "KafkaAssignerEvenRackAwareGoal must be the FIRST goal: it is a "
                "constructive full placement that would clobber prior goals' "
                f"optimizations (got position {self.goal_ids.index(G.KAFKA_ASSIGNER_RACK)})"
            )
        self.hard_ids = tuple(hard_ids)
        self.max_rounds_per_phase = max_rounds_per_phase
        # None = read CC_TPU_BUCKET_BROKERS at first use, never at construction
        self._bucket_brokers = None if bucket_brokers is None else bool(bucket_brokers)

    @property
    def bucket_brokers(self) -> bool:
        """Pad the broker axis to the power-of-two ladder
        (``model.arrays.broker_bucket``); padding is inert and results are
        identical.  On unless the constructor said otherwise or
        ``CC_TPU_BUCKET_BROKERS`` is ``0``, ``false`` or empty."""
        if self._bucket_brokers is None:
            env = os.environ.get("CC_TPU_BUCKET_BROKERS")
            self._bucket_brokers = env not in ("0", "false", "") if env is not None else True
        return self._bucket_brokers

    @bucket_brokers.setter
    def bucket_brokers(self, value: bool) -> None:
        self._bucket_brokers = bool(value)

    def _bucketed(self, state: ClusterArrays, ctx: GoalContext):
        """(padded state, padded ctx, restore fn) for the bucketed main path."""
        B = state.num_brokers
        bucket = A.broker_bucket(B) if self.bucket_brokers else B
        if bucket == B:
            return state, ctx, lambda s: s
        hosts = state.num_hosts
        return (
            A.pad_brokers(state, bucket),
            pad_context_brokers(ctx, bucket),
            lambda s: A.unpad_brokers(s, B, hosts),
        )

    def _max_rounds(self, ctx: GoalContext) -> int:
        """Round cap of every phase: fast mode trades quality for a bounded wall."""
        if ctx.fast_mode:
            return min(self.max_rounds_per_phase, FAST_MODE_MAX_ROUNDS)
        return self.max_rounds_per_phase

    def _whole(self, state: ClusterArrays) -> ClusterArrays:
        """The whole state of a solve in progress (a sharded solve gathers
        its ranks' blocks; single-device the state is whole already)."""
        return state

    def _device_loops(self):
        """The device driver of this solve's loops (``device_loop.DeviceLoops``),
        or None for the host driver: the device loop runs on the card unless
        the solve is sharded (``spmd``), whose collectives stage through the
        host and cannot be captured."""
        if self.device.type != "cuda" or self._spmd is not None:
            return None
        from cruise_control_tpu_torch.analyzer.device_loop import device_loops

        return device_loops(self.device)

    def _offline_repair(
        self, state: ClusterArrays, ctx: GoalContext, max_rounds: int, syncs: HostSyncs
    ) -> ClusterArrays:
        """The pre-phases that relocate offline replicas: the strict pass bounds
        cumulative admission by the hard goals, the relaxed pass by nothing.
        On the device driver both are one launch (one pass of two phases)."""
        hard_in_list = tuple(g for g in self.hard_ids if g in self.goal_ids)
        loops = self._device_loops()
        if loops is not None:
            phases = [(offline_round, (), hard_in_list, frozenset()), (offline_round_relaxed, (), (), frozenset())]
            state, run = loops.run(
                state, ctx, phases, enable_heavy=self.enable_heavy_goals, max_passes=1,
                max_rounds=max_rounds, name="offline_repair",
            )
            syncs.runs.append(run)
            return state
        for fn, aids in ((offline_round, hard_in_list), (offline_round_relaxed, ())):
            state, _, _ = _phase_loop(
                state, ctx, round_fn=fn, max_rounds=max_rounds,
                enable_heavy=self.enable_heavy_goals, prior_ids=(), admit_ids=aids,
                needs=frozenset(), syncs=syncs, spmd=self._spmd,
            )
        return state

    def _run_goal(
        self, gid: int, state: ClusterArrays, ctx: GoalContext, *, prior: Tuple[int, ...],
        max_rounds: int, max_rf: int, syncs: HostSyncs,
    ):
        """One goal of a walk, with ``prior`` the goals before it:
        ``(state, rounds, moves, before, after, unassigned)``.  ``before`` and
        ``after`` are 0-d device tensors; the device loop leaves ``rounds`` and
        ``moves`` on the device too, and so does the kafka-assigner step (a full
        placement mode, one step, ``max_rf`` position passes) with ``moves``
        and ``unassigned``; ``unassigned`` is None for every other goal."""
        if gid == G.KAFKA_ASSIGNER_RACK:
            return _assigner_step_fn(state, ctx, max_rf=max_rf, enable_heavy=self.enable_heavy_goals)
        loops = self._device_loops()
        if loops is not None:
            state, rounds, moves, before, after = _goal_step_device(
                loops, state, ctx, gid=gid, round_fns=GOAL_ROUNDS[gid], max_rounds=max_rounds,
                enable_heavy=self.enable_heavy_goals, prior_ids=prior, admit_ids=prior + (gid,),
                syncs=syncs,
            )
            return state, rounds, moves, before, after, None
        state, rounds, moves, before, after = _goal_step_fn(
            state, ctx, gid=gid, round_fns=GOAL_ROUNDS[gid], max_rounds=max_rounds,
            enable_heavy=self.enable_heavy_goals, prior_ids=prior, admit_ids=prior + (gid,),
            syncs=syncs, spmd=self._spmd,
        )
        return state, rounds, moves, before, after, None

    def violations(self, state: ClusterArrays, ctx: GoalContext) -> torch.Tensor:
        """f32[NUM_GOALS] violation counts of the configured goal list, left on
        the device (the drift probe; it can be handed to
        :meth:`incremental_optimize`)."""
        state, ctx = state.to(self.device), ctx.to(self.device)
        return _violations_fn(state, ctx, self.enable_heavy_goals, self.goal_ids)

    def optimize(
        self,
        state: ClusterArrays,
        ctx: GoalContext,
        maps=None,
        raise_on_hard_failure: bool = False,
        profile_goals: bool = False,
        on_goal_done=None,
    ) -> Tuple[ClusterArrays, OptimizerResult]:
        """Bucketed entry: pad the broker axis to the ladder, solve on
        ``self.device``, and slice the final state back."""
        state, ctx = state.to(self.device), ctx.to(self.device)
        state, ctx, unbucket = self._bucketed(state, ctx)
        final, result = self._optimize_core(
            state, ctx, maps=maps,
            raise_on_hard_failure=raise_on_hard_failure,
            profile_goals=profile_goals, on_goal_done=on_goal_done,
        )
        return unbucket(final), result

    def _optimize_core(
        self,
        state: ClusterArrays,
        ctx: GoalContext,
        maps=None,
        raise_on_hard_failure: bool = False,
        profile_goals: bool = False,
        on_goal_done=None,
    ) -> Tuple[ClusterArrays, OptimizerResult]:
        """Run the goal list.  Per-goal scalars stay on the device until one
        bulk fetch at the end; the only other waits are one per round.
        ``on_goal_done(name, rounds, moves, violations_after, duration_s)`` is
        called after each goal when ``profile_goals`` is set;
        ``raise_on_hard_failure`` raises :class:`OptimizationFailure` at the
        first unsatisfied hard goal.

        Every run, an aborted one too, leaves an ``"optimize"`` flight record
        (``obs.recorder``): a ``setup`` span, one span per goal and a
        ``finalize`` span, whose host-sync counts sum to ``num_host_syncs``."""
        from cruise_control_tpu_torch.core.sensors import PROPOSAL_COMPUTATION_TIMER, REGISTRY
        from cruise_control_tpu_torch.obs import recorder as obs

        trace_token = obs.start_trace("optimize")
        cost_mark = PROFILER.mark()
        t0 = time.monotonic()
        syncs = HostSyncs()
        heavy = self.enable_heavy_goals
        spmd = self._spmd
        initial = state
        viol0 = _violations_fn(state, ctx, heavy, self.goal_ids, spmd)
        initial_whole = self._whole(initial)
        stats_before = S.cluster_model_stats(initial_whole)

        max_rounds = self._max_rounds(ctx)
        state = self._offline_repair(state, ctx, max_rounds, syncs)
        # flight-record accounting: the syncs before the goal loop are the
        # "setup" span, each goal's delta its own span
        setup_syncs = syncs.count
        setup_s = time.monotonic() - t0

        degraded = False
        raw: List[tuple] = []
        prior: Tuple[int, ...] = ()
        try:
            for gid in self.goal_ids:
                if self.deadline_s is not None and syncs.runs:
                    # the device loop's goals run ahead of the host: the
                    # wall is read once the last of them has ended
                    syncs.wait(syncs.runs[-1].done)
                if self.deadline_s is not None and time.monotonic() - t0 >= self.deadline_s:
                    # stop the walk; goals already walked keep their reports
                    degraded = True
                    break
                g0 = time.monotonic()
                s0 = syncs.count
                max_rf = _max_replication_factor(initial_whole, syncs) if gid == G.KAFKA_ASSIGNER_RACK else 1
                state, rounds, moves, before, after, unassigned_t = self._run_goal(
                    gid, state, ctx, prior=prior, max_rounds=max_rounds, max_rf=max_rf, syncs=syncs,
                )
                if unassigned_t is not None:
                    moves, unassigned = syncs.tolist(torch.stack([moves, unassigned_t]))
                    if raise_on_hard_failure and unassigned > 0:
                        raise OptimizationFailure(
                            f"KafkaAssignerEvenRackAwareGoal: {unassigned} replica slot(s) have no "
                            "eligible broker (fewer eligible alive brokers than the replication factor)"
                        )
                is_hard = gid in self.hard_ids
                after_host = None
                if profile_goals or (raise_on_hard_failure and is_hard):
                    after_host, rounds, moves = host_fetch(syncs, [after, rounds, moves])
                    after_host, rounds, moves = float(after_host), int(rounds), int(moves)
                if raise_on_hard_failure and is_hard and after_host > 0:
                    raise OptimizationFailure(
                        f"{G.GOAL_NAMES[gid]} unsatisfied: {after_host:.0f} violations remain"
                    )
                dur = time.monotonic() - g0
                raw.append((gid, before, after, rounds, moves, dur, syncs.count - s0))
                if profile_goals and on_goal_done is not None:
                    on_goal_done(G.GOAL_NAMES[gid], rounds, moves, after_host, dur)
                prior = prior + (gid,)
        except OptimizationFailure as e:
            syncs.settle()
            # the spans walked so far plus the refusing goal, so the span
            # syncs still sum to the reported total
            obs.finish_trace(
                trace_token,
                spans=[obs.Span("setup", "setup", setup_s, setup_syncs)]
                + [obs.Span(G.GOAL_NAMES[g], "goal", d, n) for g, _, _, _, _, d, n in raw]
                + [obs.Span(
                    G.GOAL_NAMES[gid], "aborted", time.monotonic() - g0, syncs.count - s0,
                    attrs={"error": str(e)},
                )],
                attrs={"error": str(e), "num_dispatches": syncs.count, "num_host_syncs": syncs.count},
                device=self.device,
            )
            raise

        violN = _violations_fn(state, ctx, heavy, self.goal_ids, spmd)
        # one bulk fetch of every per-goal scalar
        viol0_h, violN_h, *per_goal = host_fetch(
            syncs, [viol0, violN] + [x for _, b, a, r, m, _, _ in raw for x in (b, a, r, m)]
        )

        reports: List[GoalReport] = []
        total_moves = 0
        for i, (gid, _, _, _, _, dur, _) in enumerate(raw):
            before, after, rounds, moves = per_goal[4 * i:4 * i + 4]
            reports.append(
                GoalReport(
                    goal_id=gid,
                    name=G.GOAL_NAMES[gid],
                    is_hard=gid in self.hard_ids,
                    violations_before=float(before),
                    violations_after=float(after),
                    rounds=int(rounds),
                    moves_applied=int(moves),
                    duration_s=dur,
                )
            )
            total_moves += int(moves)

        names = G.GOAL_NAMES
        violated_hard = [
            names[g] for g in self.hard_ids if g in self.goal_ids and violN_h[g] > 0
        ]
        state = self._whole(state)
        initial_h = syncs.state(initial_whole)
        final_h = syncs.state(state)
        provision = provision_verdict(final_h, ctx, violated_hard)
        proposals: List[ExecutionProposal] = []
        if maps is not None:
            proposals = diff_proposals(initial_h, final_h, maps)

        result = OptimizerResult(
            goal_reports=reports,
            violations_before={names[g]: float(viol0_h[g]) for g in self.goal_ids},
            violations_after={names[g]: float(violN_h[g]) for g in self.goal_ids},
            stats_before=stats_before,
            stats_after=S.cluster_model_stats(state),
            proposals=proposals,
            provision=provision,
            total_moves=total_moves,
            duration_s=time.monotonic() - t0,
            movement=movement_stats(initial_h, final_h),
            num_host_syncs=syncs.count,
            degraded=degraded,
        )
        REGISTRY.timer(PROPOSAL_COMPUTATION_TIMER).update(result.duration_s)
        self._record_optimize(trace_token, cost_mark, result, raw, setup_s, setup_syncs, ctx, state)
        return state, result

    def _record_optimize(
        self, token: dict, cost_mark: int, result: OptimizerResult, raw: List[tuple], setup_s: float,
        setup_syncs: int, ctx: GoalContext, state: ClusterArrays,
    ) -> None:
        """Close the ``"optimize"`` flight record with the JAX package's
        attribute names; ``num_dispatches`` and the spans' ``dispatches``
        carry host syncs, and ``cost`` the kernel calls since ``cost_mark``."""
        from cruise_control_tpu_torch.obs import recorder as obs

        spans = [obs.Span("setup", "setup", setup_s, setup_syncs)]
        for rep, (*_, goal_syncs) in zip(result.goal_reports, raw):
            spans.append(obs.Span(
                rep.name, "goal", rep.duration_s, goal_syncs,
                attrs={
                    "violations_before": rep.violations_before,
                    "violations_after": rep.violations_after,
                    "moves": rep.moves_applied,
                    "rounds": rep.rounds,
                    "hard": rep.is_hard,
                },
            ))
        goal_syncs = sum(t[6] for t in raw)
        spans.append(obs.Span(
            "finalize", "finalize",
            max(result.duration_s - setup_s - sum(t[5] for t in raw), 0.0),
            result.num_host_syncs - setup_syncs - goal_syncs,
        ))
        obs.finish_trace(
            token,
            spans=spans,
            attrs={
                "num_goals": len(result.goal_reports),
                "num_dispatches": result.num_host_syncs,
                "num_host_syncs": result.num_host_syncs,
                "total_moves": result.total_moves,
                "violated_hard_goals": result.violated_hard_goals,
                "residual_hard_violations": result.residual_hard_violations,
                "residual_soft_violations": result.residual_soft_violations,
                "balancedness": result.balancedness_score,
                "provision_status": result.provision.status,
                "degraded": result.degraded,
                # the JAX package's dispatch layout flags: on the device loop
                # a goal is one launch; no device-side stamps
                "fused_dispatch": self._device_loops() is not None,
                "fast_mode": bool(ctx.fast_mode),
                "stamps_supported": False,
                "num_brokers": state.num_brokers,
                "num_partitions": state.num_partitions,
                "num_replicas": state.num_replicas,
                "movement": dataclasses.asdict(result.movement),
                "cost": PROFILER.cost_since(cost_mark),
                **obs.mesh_metadata(self.device, self.mesh),
            },
            device=self.device,
        )

    # -- many clusters and bounded re-solves ----------------------------------
    #
    # The JAX package lifts each goal step over a stacked scenario axis with
    # vmap.  The port's evaluation takes the lane axis the same way: a
    # stack's violations are one lane-form snapshot and one violation pass
    # (lane_violations).  The solve's rounds are still written for one
    # cluster, so batched_optimize runs a stack's lanes one after another
    # through the same steps as optimize(): each lane is a view of the stack
    # on the device, the final lanes are restacked, and per-lane scalars stay
    # on the device until one bulk fetch.  Each lane therefore equals its
    # single-cluster solve.

    def batched_violations(self, states: ClusterArrays, ctx: GoalContext) -> torch.Tensor:
        """f32[S, NUM_GOALS] violation counts of every lane of a stack
        (``model.arrays.stack_arrays``), left on the device: one snapshot and
        one violation pass for the whole stack."""
        states, ctx = states.to(self.device), ctx.to(self.device)
        return lane_violations(states, ctx, self.enable_heavy_goals, self.goal_ids)

    def batched_optimize(
        self, states: ClusterArrays, ctx: GoalContext
    ) -> Tuple[ClusterArrays, BatchedResult]:
        """The full goal list on every lane of a stack (leading scenario axis,
        ``model.arrays.stack_arrays``; one context for all lanes): the offline
        pre-phases, then the goal walk, lane after lane.  Returns the final
        lanes restacked on the device and per-lane results.

        As in the JAX package: the unbucketed walk, no proposals, empty
        ``stats_before/after`` and per-lane ``provision`` and ``movement``;
        with the kafka-assigner goal every lane runs the batch's largest
        replication factor of position passes.  One ``"optimize"`` flight
        record with the JAX batched record's names: a ``setup`` span (every
        lane's leading probe and offline pre-phases), one span per goal (its
        walls and host syncs summed over the lanes) and a ``finalize`` span."""
        from cruise_control_tpu_torch.core.sensors import PROPOSAL_COMPUTATION_TIMER, REGISTRY
        from cruise_control_tpu_torch.obs import recorder as obs

        token = obs.start_trace("optimize")
        cost_mark = PROFILER.mark()
        t0 = time.monotonic()
        syncs = HostSyncs()
        states, ctx = states.to(self.device), ctx.to(self.device)
        heavy = self.enable_heavy_goals
        max_rounds = self._max_rounds(ctx)
        max_rf = (
            _max_replication_factor(states, syncs) if G.KAFKA_ASSIGNER_RACK in self.goal_ids else 1
        )
        setup_s, setup_syncs = time.monotonic() - t0, syncs.count
        goal_walls = {g: 0.0 for g in self.goal_ids}
        goal_syncs = {g: 0 for g in self.goal_ids}
        finals, lanes = [], []
        for i in range(A.num_lanes(states)):
            s0, c0 = time.monotonic(), syncs.count
            state = A.index_arrays(states, i)
            viol0 = _violations_fn(state, ctx, heavy, self.goal_ids)
            state = self._offline_repair(state, ctx, max_rounds, syncs)
            setup_s += time.monotonic() - s0
            setup_syncs += syncs.count - c0
            raw: List[tuple] = []
            prior: Tuple[int, ...] = ()
            for gid in self.goal_ids:
                g0, c0 = time.monotonic(), syncs.count
                state, rounds, moves, before, after, _ = self._run_goal(
                    gid, state, ctx, prior=prior, max_rounds=max_rounds, max_rf=max_rf, syncs=syncs,
                )
                wall = time.monotonic() - g0
                raw.append((gid, rounds, moves, before, after, wall))
                goal_walls[gid] += wall
                goal_syncs[gid] += syncs.count - c0
                prior = prior + (gid,)
            finals.append(state)
            lanes.append((viol0, _violations_fn(state, ctx, heavy, self.goal_ids), raw))
        final = A.stack_arrays(finals)

        # one bulk fetch of every lane's scalars, then host copies of both stacks
        flat = host_fetch(syncs, [
            x for v0, vN, raw in lanes for x in (v0, vN, *(y for r in raw for y in r[1:5]))
        ])
        initial_h, final_h = syncs.state(states), syncs.state(final)
        duration = time.monotonic() - t0
        names = G.GOAL_NAMES
        results: List[OptimizerResult] = []
        k = 0
        for i, (_, _, raw) in enumerate(lanes):
            viol0_h, violN_h = flat[k], flat[k + 1]
            k += 2
            reports = []
            for gid, _, _, _, _, wall in raw:
                rounds, moves, before, after = flat[k:k + 4]
                k += 4
                reports.append(GoalReport(
                    goal_id=gid, name=names[gid], is_hard=gid in self.hard_ids,
                    violations_before=float(before), violations_after=float(after),
                    rounds=int(rounds), moves_applied=int(moves), duration_s=wall,
                ))
            violated_hard = [
                names[g] for g in self.hard_ids if g in self.goal_ids and float(violN_h[g]) > 0
            ]
            final_i = A.index_arrays(final_h, i)
            results.append(OptimizerResult(
                goal_reports=reports,
                violations_before={names[g]: float(viol0_h[g]) for g in self.goal_ids},
                violations_after={names[g]: float(violN_h[g]) for g in self.goal_ids},
                stats_before={},
                stats_after={},
                proposals=[],
                provision=provision_verdict(final_i, ctx, violated_hard),
                total_moves=sum(r.moves_applied for r in reports),
                duration_s=duration,
                movement=movement_stats(A.index_arrays(initial_h, i), final_i),
                num_host_syncs=syncs.count,
            ))
        REGISTRY.timer(PROPOSAL_COMPUTATION_TIMER).update(duration)

        spans = [obs.Span("setup", "setup", setup_s, setup_syncs)]
        for j, gid in enumerate(self.goal_ids):
            reps = [r.goal_reports[j] for r in results]
            spans.append(obs.Span(
                names[gid], "goal", goal_walls[gid], goal_syncs[gid],
                attrs={
                    "moves": sum(r.moves_applied for r in reps),
                    "lanes_unsatisfied": sum(1 for r in reps if r.violations_after > 0),
                    "hard": gid in self.hard_ids,
                },
            ))
        spans.append(obs.Span(
            "finalize", "finalize",
            max(duration - setup_s - sum(goal_walls.values()), 0.0),
            syncs.count - setup_syncs - sum(goal_syncs.values()),
        ))
        obs.finish_trace(
            token,
            spans=spans,
            attrs={
                "batched": True,
                "batch_size": len(results),
                "num_goals": len(self.goal_ids),
                "num_dispatches": syncs.count,
                # leaves are [S, ...]-stacked: the trailing axis is the shape
                "num_brokers": int(states.broker_rack.shape[-1]),
                "num_partitions": int(states.partition_topic.shape[-1]),
                "num_replicas": int(states.replica_partition.shape[-1]),
                "fast_mode": bool(ctx.fast_mode),
                "cost": PROFILER.cost_since(cost_mark),
                **obs.mesh_metadata(self.device),
            },
            device=self.device,
        )
        return final, BatchedResult(
            results=results, batch_size=len(results), num_host_syncs=syncs.count,
            duration_s=duration,
        )

    def _incremental_walk(
        self, state: ClusterArrays, ctx: GoalContext, goals, max_rounds: int, max_rf: int,
        syncs: HostSyncs,
    ):
        """Walk the goal list running only ``goals``, each with its full-walk
        prior prefix (every goal before it, run or not) and ``max_rounds``
        rounds a phase.  Returns the state and ``(gid, rounds, moves)`` per
        goal run (the assigner's moves left on the device)."""
        raw: List[tuple] = []
        prior: Tuple[int, ...] = ()
        for gid in self.goal_ids:
            if gid in goals:
                state, rounds, moves, _, _, _ = self._run_goal(
                    gid, state, ctx, prior=prior, max_rounds=max_rounds, max_rf=max_rf, syncs=syncs,
                )
                raw.append((gid, rounds, moves))
            prior = prior + (gid,)
        return state, raw

    def incremental_optimize(
        self, state: ClusterArrays, ctx: GoalContext, max_rounds: int, violations=None,
    ) -> Tuple[ClusterArrays, IncrementalResult]:
        """Bounded re-optimize from the CURRENT placement (the continuous
        controller's tick): only goals violated in ``state`` run, each with
        its full-walk prior prefix -- so it still never violates any earlier
        goal -- and rounds capped at ``max_rounds`` a phase.  No bucketing,
        no offline pre-phases, no proposals.  ``violations`` (the caller's
        probe of ``state``) saves the leading violations probe."""
        t0 = time.monotonic()
        syncs = HostSyncs()
        state, ctx = state.to(self.device), ctx.to(self.device)
        heavy = self.enable_heavy_goals
        if violations is None:
            violations = _violations_fn(state, ctx, heavy, self.goal_ids)
        viol0 = _host_violations(syncs, violations)
        drifted = {g for g in self.goal_ids if float(viol0[g]) > 0}
        max_rf = (
            _max_replication_factor(state, syncs) if G.KAFKA_ASSIGNER_RACK in drifted else 1
        )
        state, raw = self._incremental_walk(state, ctx, drifted, int(max_rounds), max_rf, syncs)
        violN, *counts = host_fetch(
            syncs, [_violations_fn(state, ctx, heavy, self.goal_ids)] + [x for _, r, m in raw for x in (r, m)]
        )
        return state, IncrementalResult(
            goals_run=[G.GOAL_NAMES[g] for g, _, _ in raw],
            violations_before=viol0,
            violations_after=violN,
            total_moves=int(sum(int(m) for m in counts[1::2])),
            total_rounds=int(sum(int(r) for r in counts[0::2])),
            num_host_syncs=syncs.count,
            duration_s=time.monotonic() - t0,
        )

    def batched_incremental_optimize(
        self, states: ClusterArrays, ctx: GoalContext, max_rounds: int, violations=None,
        union_lanes=None,
    ) -> Tuple[ClusterArrays, BatchedIncrementalResult]:
        """:meth:`incremental_optimize` over every lane of a stack: the walk
        runs the UNION of the drifted goals of ``union_lanes`` (default every
        lane), and every lane goes through every union goal, as the JAX
        package's one static goal sequence does.  A goal a lane satisfies
        applies nothing there (a converged state is a fixpoint of its own
        rounds), but its rounds count, as in the reference.  A lane's
        ``goals_run`` is the union's goals that lane drifted on.
        ``violations`` is the caller's ``[S, NUM_GOALS]`` probe."""
        t0 = time.monotonic()
        syncs = HostSyncs()
        states, ctx = states.to(self.device), ctx.to(self.device)
        heavy = self.enable_heavy_goals
        if violations is None:
            violations = self.batched_violations(states, ctx)
        viol0 = _host_violations(syncs, violations)
        S = int(viol0.shape[0])
        lanes = range(S) if union_lanes is None else sorted(int(i) for i in union_lanes)
        drifted_by_lane = [{g for g in self.goal_ids if float(viol0[i, g]) > 0} for i in range(S)]
        union: set = set()
        for i in lanes:
            union |= drifted_by_lane[i]
        max_rf = (
            _max_replication_factor(states, syncs) if G.KAFKA_ASSIGNER_RACK in union else 1
        )
        finals, raws, viols = [], [], []
        for i in range(S):
            state, raw = self._incremental_walk(
                A.index_arrays(states, i), ctx, union, int(max_rounds), max_rf, syncs,
            )
            finals.append(state)
            raws.append(raw)
            viols.append(_violations_fn(state, ctx, heavy, self.goal_ids))
        final = A.stack_arrays(finals)
        fetched = host_fetch(syncs, viols + [x for raw in raws for _, r, m in raw for x in (r, m)])
        duration = time.monotonic() - t0
        k = S
        results: List[IncrementalResult] = []
        for i, raw in enumerate(raws):
            counts = fetched[k:k + 2 * len(raw)]
            k += 2 * len(raw)
            results.append(IncrementalResult(
                goals_run=[G.GOAL_NAMES[g] for g, _, _ in raw if g in drifted_by_lane[i]],
                violations_before=viol0[i],
                violations_after=fetched[i],
                total_moves=int(sum(int(m) for m in counts[1::2])),
                total_rounds=int(sum(int(r) for r in counts[0::2])),
                num_host_syncs=syncs.count,
                duration_s=duration,
            ))
        return final, BatchedIncrementalResult(
            results=results,
            goals_run=[G.GOAL_NAMES[g] for g in self.goal_ids if g in union],
            batch_size=S,
            num_host_syncs=syncs.count,
            duration_s=duration,
        )

    def warm_incremental_programs(
        self, state: ClusterArrays, ctx: GoalContext, max_rounds: int
    ) -> None:
        """Make the first tick as fast as later ones.  The JAX package
        compiles here every program a tick can touch; the port has no compile
        step, so this builds the CUDA kernels (on the card) and runs one
        violations probe of ``state``, which it leaves untouched.
        ``max_rounds`` is accepted for the JAX signature and unused."""
        self._build_kernels()
        HostSyncs().tolist(self.violations(state, ctx))
        self._warm_loops(state, ctx, max_rounds)

    def warm_batched_incremental_programs(
        self, states: ClusterArrays, ctx: GoalContext, max_rounds: int
    ) -> None:
        """:meth:`warm_incremental_programs` for a stack: builds the CUDA
        kernels (on the card), runs one probe of every lane and captures
        the walk's goals at a lane's shapes."""
        self._build_kernels()
        HostSyncs().tolist(self.batched_violations(states, ctx))
        self._warm_loops(A.index_arrays(states.to(self.device), 0), ctx, max_rounds)

    def _warm_loops(self, state: ClusterArrays, ctx: GoalContext, max_rounds: int) -> None:
        """On the device driver, capture every goal of the walk at ``state``'s
        shapes and ``max_rounds`` (each capture runs one round eagerly and
        discards it: ``state`` stays as it is), as the JAX warm start compiles
        every program a tick can touch."""
        loops = self._device_loops()
        if loops is None:
            return
        state, ctx = state.to(self.device), ctx.to(self.device)
        prior: Tuple[int, ...] = ()
        for gid in self.goal_ids:
            if gid != G.KAFKA_ASSIGNER_RACK:
                round_fns = GOAL_ROUNDS[gid]
                loops.prepare(
                    state, ctx, _goal_phases(gid, round_fns, prior, prior + (gid,)),
                    enable_heavy=self.enable_heavy_goals, max_passes=_max_passes(round_fns),
                    max_rounds=int(max_rounds), name=G.GOAL_NAMES[gid],
                )
            prior = prior + (gid,)

    def _build_kernels(self) -> None:
        if self.device.type == "cuda":
            from cruise_control_tpu_torch.ops import _build

            _build.build_all(["segment_sum", "even_assign", "graph_loop"])
