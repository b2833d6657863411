"""CruiseControl facade: the one object that wires every layer together.

Port of ``cruise_control_tpu/facade.py``.

Counterpart of ``KafkaCruiseControl.java:78`` (wiring :112-129): owns the
LoadMonitor, the GoalOptimizer (the solver on the device), the Executor, and exposes the
operations the API layer and the self-healing runnables invoke — cluster model
access, optimization (dry-run or executed), broker add/remove/demote, offline-replica
fix, pause/resume, stop, state.  The async/user-task machinery lives in the API
layer; this facade is synchronous.

The reference's per-operation runnables (``RebalanceRunnable.java:110``,
``RemoveBrokersRunnable``, …) collapse into the ``*_proposals``/``rebalance``-style
methods here: each builds a fresh model under the generation semaphore, runs the
solver with operation-specific context, and optionally executes.

``device`` is where every solve, sweep and rollout runs: ``cuda`` unless
``device="cpu"`` is passed; with no GPU and no explicit CPU the constructor
raises.  The model is built on the host and moved to ``device`` once per
operation (``ClusterModel.to_arrays(device=)``); the executor works on the
host against the backend only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer, OptimizerResult
from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.proposals import logdir_moves
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.backend.base import ClusterBackend
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.executor import Executor, ExecutionSummary
from cruise_control_tpu_torch.model.cluster import BrokerState, ClusterModel
from cruise_control_tpu_torch.monitor import LoadMonitor, ModelCompletenessRequirements


@dataclasses.dataclass
class OperationResult:
    """What an optimize-style operation returns (OptimizerResult + execution)."""

    optimizer_result: OptimizerResult
    execution: Optional[ExecutionSummary]
    dryrun: bool


class CruiseControl:
    def __init__(
        self,
        backend: ClusterBackend,
        monitor: LoadMonitor,
        executor: Executor,
        goal_ids: Sequence[int] = G.DEFAULT_GOAL_ORDER,
        hard_ids: Sequence[int] = G.HARD_GOALS,
        constraint: Optional[BalancingConstraint] = None,
        enable_heavy_goals: bool = True,
        optimize_deadline_s: Optional[float] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.backend = backend
        self.monitor = monitor
        self.executor = executor
        self.goal_ids = tuple(goal_ids)
        self.hard_ids = tuple(hard_ids)
        self.constraint = constraint
        self.enable_heavy_goals = enable_heavy_goals
        #: per-request optimize wall budget (optimize.deadline.ms): expired
        #: solves return best-so-far placements marked degraded
        self.optimize_deadline_s = optimize_deadline_s
        self._start_time = time.time()

    # -- lifecycle (KafkaCruiseControl.startUp) ------------------------------

    def start(self, sampling_interval_ms: int = 0) -> None:
        self.monitor.start(sampling_interval_ms=sampling_interval_ms)

    def shutdown(self) -> None:
        self.monitor.shutdown()

    # -- model access --------------------------------------------------------

    def cluster_model(
        self,
        requirements: ModelCompletenessRequirements = ModelCompletenessRequirements(),
    ) -> ClusterModel:
        return self.monitor.cluster_model(requirements=requirements)

    def _optimizer(
        self,
        goal_ids: Optional[Sequence[int]],
        hard_ids: Optional[Sequence[int]] = None,
        deadline_s: Optional[float] = None,
    ) -> GoalOptimizer:
        return GoalOptimizer(
            goal_ids=tuple(goal_ids) if goal_ids is not None else self.goal_ids,
            hard_ids=tuple(hard_ids) if hard_ids is not None else self.hard_ids,
            enable_heavy_goals=self.enable_heavy_goals,
            device=self.device,
            # per-request client budget (deadline_ms) wins over the configured
            # default — tightening only: a request asking for less time than
            # the server default should get less, not more
            deadline_s=(
                min(deadline_s, self.optimize_deadline_s)
                if deadline_s is not None and self.optimize_deadline_s is not None
                else (deadline_s if deadline_s is not None
                      else self.optimize_deadline_s)
            ),
        )

    def _context(
        self,
        model: ClusterModel,
        maps,
        state,
        excluded_topics: Sequence[str] = (),
        excluded_brokers_for_leadership: Sequence[int] = (),
        excluded_brokers_for_replica_move: Sequence[int] = (),
        only_move_immigrants: bool = False,
        triggered_by_violation: bool = False,
    ) -> GoalContext:
        topic_ids = [
            maps.topic_index[t] for t in excluded_topics if t in maps.topic_index
        ]
        bl = [
            maps.broker_index[b]
            for b in excluded_brokers_for_leadership
            if b in maps.broker_index
        ]
        br = [
            maps.broker_index[b]
            for b in excluded_brokers_for_replica_move
            if b in maps.broker_index
        ]
        return GoalContext.build(
            state.num_topics,
            state.num_brokers,
            constraint=self.constraint,
            excluded_topic_ids=topic_ids,
            excluded_brokers_for_leadership=bl,
            excluded_brokers_for_replica_move=br,
            only_move_immigrants=only_move_immigrants,
            triggered_by_violation=triggered_by_violation,
            device=self.device,
        )

    # -- operations (the runnables' workWithClusterModel bodies) -------------

    def _optimize_and_maybe_execute(
        self,
        model: ClusterModel,
        dryrun: bool,
        goal_ids: Optional[Sequence[int]] = None,
        hard_ids: Optional[Sequence[int]] = None,
        deadline_s: Optional[float] = None,
        **ctx_kw,
    ) -> OperationResult:
        state, maps = model.to_arrays(device=self.device)
        ctx = self._context(model, maps, state, **ctx_kw)
        final, result = self._optimizer(
            goal_ids, hard_ids, deadline_s=deadline_s
        ).optimize(state, ctx, maps=maps)
        ld_moves = logdir_moves(state, final, maps)
        execution = None
        if not dryrun and (result.proposals or ld_moves):
            execution = self.executor.execute_proposals(
                result.proposals, logdir_moves=ld_moves
            )
        return OperationResult(result, execution, dryrun)

    def rebalance(
        self,
        dryrun: bool = True,
        goal_ids: Optional[Sequence[int]] = None,
        excluded_topics: Sequence[str] = (),
        triggered_by_violation: bool = False,
        requirements: ModelCompletenessRequirements = ModelCompletenessRequirements(),
        deadline_s: Optional[float] = None,
    ) -> OperationResult:
        """POST /rebalance (RebalanceRunnable.java:110).  ``deadline_s`` is
        the request's remaining client budget (deadline_ms): the solve
        returns a best-so-far ``degraded=true`` placement on expiry instead
        of overrunning the client's patience."""
        model = self.cluster_model(requirements)
        return self._optimize_and_maybe_execute(
            model, dryrun, goal_ids,
            excluded_topics=excluded_topics,
            triggered_by_violation=triggered_by_violation,
            deadline_s=deadline_s,
        )

    def add_brokers(self, broker_ids: Sequence[int], dryrun: bool = True, **kw) -> OperationResult:
        """POST /add_broker: new brokers receive load (AddBrokersRunnable).

        The new brokers are marked NEW; only immigrant moves onto them are
        proposed (onlyMoveImmigrantReplicas semantics relaxed: the distribution
        goals pull load toward the under-loaded newcomers)."""
        model = self.cluster_model()
        for b in broker_ids:
            if b in model.brokers():
                model.set_broker_state(b, BrokerState.NEW)
        return self._optimize_and_maybe_execute(model, dryrun, **kw)

    def remove_brokers(self, broker_ids: Sequence[int], dryrun: bool = True, **kw) -> OperationResult:
        """POST /remove_broker: drain all replicas off the brokers
        (RemoveBrokersRunnable — also the BrokerFailures fix)."""
        model = self.cluster_model()
        for b in broker_ids:
            if b in model.brokers():
                model.set_broker_state(b, BrokerState.DEAD)
        return self._optimize_and_maybe_execute(model, dryrun, **kw)

    def demote_brokers(self, broker_ids: Sequence[int], dryrun: bool = True, **kw) -> OperationResult:
        """POST /demote_broker: move leadership (and preferred-leader slots) off
        the brokers (DemoteBrokerRunnable; SlowBrokers DEMOTE fix)."""
        model = self.cluster_model()
        for b in broker_ids:
            if b in model.brokers():
                model.set_broker_state(b, BrokerState.DEMOTED)
        return self._optimize_and_maybe_execute(
            model, dryrun,
            goal_ids=(G.LEADER_REPLICA_DIST, G.LEADER_BYTES_IN_DIST),
            excluded_brokers_for_leadership=list(broker_ids),
        )

    def fix_offline_replicas(self, dryrun: bool = True, **kw) -> OperationResult:
        """POST /fix_offline_replicas (FixOfflineReplicasRunnable; DiskFailures fix).

        The optimizer's offline pre-phase relocates replicas on dead brokers and
        dead disks; the goal list then re-balances."""
        model = self.cluster_model()
        return self._optimize_and_maybe_execute(model, dryrun, **kw)

    def remove_disks(
        self, broker_logdirs: Sequence[Tuple[int, str]], dryrun: bool = True, **kw
    ) -> OperationResult:
        """POST /remove_disks (RemoveDisksRunnable): drain the named logdirs to
        their brokers' remaining disks via the JBOD intra-broker goals — the
        replicas never leave their broker (contrast DiskFailures, whose fix is
        cross-broker relocation of offline replicas)."""
        model = self.cluster_model()
        for b, logdir in broker_logdirs:
            model.mark_disk_removed(b, logdir)
        # capacity goal only: drain exactly the marked logdirs — running the
        # intra distribution goal here would reshuffle unrelated brokers' disks
        return self._optimize_and_maybe_execute(
            model, dryrun,
            goal_ids=(G.INTRA_DISK_CAPACITY,),
            hard_ids=(G.INTRA_DISK_CAPACITY,),
            **kw,
        )

    def update_topic_replication_factor(
        self,
        topic_pattern,
        target_rf: int,
        dryrun: bool = True,
    ) -> OperationResult:
        """POST /topic_configuration: change matching topics to the target RF
        (UpdateTopicConfigurationRunnable / TopicReplicationFactorAnomaly fix).

        RF increase adds follower replicas on rack-aware least-loaded brokers; RF
        decrease strips trailing non-leader replicas.  Proposals are built directly
        (no goal optimization) and executed unless ``dryrun``.
        """
        import re

        from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal

        pattern = re.compile(topic_pattern)
        model = self.cluster_model()
        counts = {b: 0 for b in model.brokers()}
        rack_of = {}
        for b in model.brokers():
            info = self.backend.describe_cluster().brokers[b]
            rack_of[b] = info.rack
        for tp, brokers in model.replica_distribution().items():
            for b in brokers:
                counts[b] += 1

        proposals: List = []
        for tp, brokers in sorted(model.replica_distribution().items()):
            if not pattern.fullmatch(tp[0]):
                continue
            leader = model.leader_of(tp)
            new = list(brokers)
            if len(new) < target_rf:
                used_racks = {rack_of[b] for b in new}
                candidates = sorted(
                    (b for b in model.brokers() if b not in new),
                    key=lambda b: (rack_of[b] in used_racks, counts[b]),
                )
                for b in candidates[: target_rf - len(new)]:
                    new.append(b)
                    counts[b] += 1
                    used_racks.add(rack_of[b])
            elif len(new) > target_rf:
                removable = [b for b in reversed(new) if b != leader]
                for b in removable[: len(new) - target_rf]:
                    new.remove(b)
                    counts[b] -= 1
            if new == list(brokers):
                continue
            ordered = [leader] + [b for b in new if b != leader]
            proposals.append(
                ExecutionProposal(
                    tp=tp,
                    partition_size=0.0,
                    old_leader=leader,
                    old_replicas=tuple(brokers),
                    new_replicas=tuple(ordered),
                )
            )

        execution = None
        if not dryrun and proposals:
            execution = self.executor.execute_proposals(proposals)
        empty = OptimizerResult(
            goal_reports=[], violations_before={}, violations_after={},
            stats_before={}, stats_after={}, proposals=proposals,
            provision=None, total_moves=len(proposals), duration_s=0.0,
        )
        return OperationResult(empty, execution, dryrun)

    def simulate(
        self,
        scenarios: Sequence["Scenario"],
        deep: bool = False,
        goal_ids: Optional[Sequence[int]] = None,
        mesh=None,
    ) -> "SweepResult":
        """Evaluate hypothetical clusters (the SIMULATE endpoint substrate).

        ``deep=False``: every scenario as it is, with one host sync
        (``sim.batch.fast_sweep``) — as-is violations, balancedness,
        satisfiability, movement floor.  ``deep=True``: a full
        ``GoalOptimizer.optimize`` per scenario (``sim.batch.deep_sweep``) —
        post-rebalance verdicts and the real movement bill.  ``mesh`` (a
        ``parallel.mesh.Mesh``, called on every rank) shards the fast
        sweep's scenario axis over the ranks."""
        from cruise_control_tpu_torch.sim import batch as sim_batch

        model = self.cluster_model()
        state, _ = model.to_arrays(device="cpu")
        gids = tuple(goal_ids) if goal_ids is not None else self.goal_ids
        kw = dict(
            constraint=self.constraint,
            goal_ids=gids,
            hard_ids=tuple(g for g in self.hard_ids if g in gids) or self.hard_ids,
            enable_heavy=False,
            device=self.device,
        )
        if deep:
            return sim_batch.deep_sweep(state, scenarios, **kw)
        return sim_batch.fast_sweep(state, scenarios, mesh=mesh, **kw)

    def trace_rollout(
        self,
        traces: Sequence["LoadTrace"],
        policies: Sequence["AutoscalePolicy"],
        goal_ids: Optional[Sequence[int]] = None,
    ) -> "RolloutResult":
        """Batched (trace × policy) autoscaling rollouts (the POST /TRACES
        endpoint substrate): every pair stepped through time with one host
        sync (``traces.rollout.rollout``), with per-pair SLO-violation
        steps, broker-hours, scale actions and drawdown verdicts."""
        from cruise_control_tpu_torch.traces.rollout import rollout as _rollout

        model = self.cluster_model()
        state, _ = model.to_arrays(device="cpu")
        gids = tuple(goal_ids) if goal_ids is not None else self.goal_ids
        return _rollout(
            state,
            traces,
            policies,
            constraint=self.constraint,
            goal_ids=gids,
            hard_ids=tuple(g for g in self.hard_ids if g in gids) or self.hard_ids,
            device=self.device,
        )

    def trace_horizon(
        self,
        trace: "LoadTrace",
        goal_ids: Optional[Sequence[int]] = None,
    ) -> dict:
        """RIGHTSIZE planning horizon: the trace evaluated at the current
        broker count, reporting peak min-brokers-needed over the horizon —
        pre-position capacity before the predicted peak, not after it."""
        from cruise_control_tpu_torch.traces.rollout import horizon_requirements

        model = self.cluster_model()
        state, _ = model.to_arrays(device="cpu")
        gids = tuple(goal_ids) if goal_ids is not None else self.goal_ids
        return horizon_requirements(
            state,
            trace,
            constraint=self.constraint,
            goal_ids=gids,
            hard_ids=tuple(g for g in self.hard_ids if g in gids) or self.hard_ids,
            device=self.device,
        )

    def plan_capacity(
        self,
        load_factor: float = 1.0,
        goal_ids: Optional[Sequence[int]] = None,
        max_extra_brokers: Optional[int] = None,
        deep_verify: bool = False,
    ) -> "CapacityPlan":
        """Batched-bisection capacity plan (the RIGHTSIZE substrate): minimum
        brokers such that every hard goal is satisfiable under load × f.
        ``deep_verify`` confirms the pinned edge with one batched full-solver
        pass (``sim.planner.plan_capacity``)."""
        from cruise_control_tpu_torch.sim.planner import plan_capacity as _plan

        model = self.cluster_model()
        state, _ = model.to_arrays(device="cpu")
        gids = tuple(goal_ids) if goal_ids is not None else self.goal_ids
        return _plan(
            state,
            constraint=self.constraint,
            load_factor=load_factor,
            goal_ids=gids,
            hard_ids=tuple(g for g in self.hard_ids if g in gids) or self.hard_ids,
            max_extra_brokers=max_extra_brokers,
            deep_verify=deep_verify,
            device=self.device,
        )

    def train_cpu_model(self, from_ms: int = 0, to_ms: Optional[int] = None) -> bool:
        """GET /train: fit the linear CPU model from broker metric history.

        Counterpart of the TRAIN endpoint / ``LinearRegressionModelParameters``:
        least-squares CPU ≈ a·leader_bytes_in + b·leader_bytes_out +
        c·replication_bytes_in over the aggregated broker windows.  The fitted
        weights replace the static defaults used to derive follower CPU
        (ModelUtils.java's a/b/c heuristic).
        """
        import numpy as np

        from cruise_control_tpu_torch.model.model_utils import CpuModelWeights

        hist = self.monitor.broker_metric_history()
        if hist is None:
            return False
        values, brokers, metric_def = hist
        ids = {n: metric_def.metric_info(n).id for n in
               ("CPU_USAGE", "LEADER_BYTES_IN", "LEADER_BYTES_OUT",
                "REPLICATION_BYTES_IN_RATE")}
        flat = values.reshape(-1, values.shape[-1])
        y = flat[:, ids["CPU_USAGE"]]
        X = flat[:, [ids["LEADER_BYTES_IN"], ids["LEADER_BYTES_OUT"],
                     ids["REPLICATION_BYTES_IN_RATE"]]]
        keep = (y > 0) & (X.sum(axis=1) > 0)
        if keep.sum() < 3:
            return False
        coef, *_ = np.linalg.lstsq(X[keep], y[keep], rcond=None)
        if not np.all(np.isfinite(coef)):
            return False
        total = float(np.abs(coef).sum())
        if total <= 0:
            return False
        a, b, c = (float(abs(x)) / total for x in coef)
        self.trained_cpu_weights = CpuModelWeights(a, b, c)
        # the fitted model replaces the static weights for every subsequent
        # cluster model (ModelParameters.updateModelCoefficient consumption)
        self.monitor.set_cpu_model(self.trained_cpu_weights)
        return True

    # -- pass-throughs -------------------------------------------------------

    def stop_execution(self) -> None:
        self.executor.stop_execution()

    def pause_sampling(self, reason: str) -> None:
        self.monitor.pause_sampling(reason)

    def resume_sampling(self, reason: str) -> None:
        self.monitor.resume_sampling(reason)

    # -- state (STATE endpoint substrate) ------------------------------------

    def state(self) -> Dict[str, object]:
        ms = self.monitor.state()
        last = self.executor.last_summary
        return {
            "MonitorState": dataclasses.asdict(ms),
            "ExecutorState": {
                "state": self.executor.state,
                "lastExecution": None if last is None else {
                    "executionId": last.execution_id,
                    "completed": last.completed,
                    "dead": last.dead,
                    "aborted": last.aborted,
                    "failed": last.failed,
                    "stopped": last.stopped,
                    "error": last.error,
                    "durationS": round(last.duration_s, 3),
                },
            },
            "uptime_s": time.time() - self._start_time,
        }
