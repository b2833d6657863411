"""Anomaly types and notification results.

Port of ``cruise_control_tpu/detector/anomalies.py`` (pure Python, copied).

Counterpart of the core Anomaly SPI (``cruise-control-core/.../detector/``) plus the
Kafka-typed anomalies (``detector/GoalViolations.java``, ``BrokerFailures``,
``DiskFailures``, ``SlowBrokers``, ``TopicAnomaly``, maintenance plans): each anomaly
carries what it detected and knows how to fix itself through the
:class:`~cruise_control_tpu_torch.facade.CruiseControl` facade (the reference wires each
``KafkaAnomaly.fix()`` to the corresponding runnable, e.g. GoalViolations.java:84).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.backend.base import TopicPartition


class AnomalyType(enum.IntEnum):
    """Priority-ordered anomaly types (AnomalyType.java — lower = more urgent)."""

    BROKER_FAILURE = 0
    DISK_FAILURE = 1
    METRIC_ANOMALY = 2
    GOAL_VIOLATION = 3
    TOPIC_ANOMALY = 4
    MAINTENANCE_EVENT = 5
    #: a proposal execution degraded (fatal backend error / dead / stuck tasks)
    EXECUTION_FAILURE = 6
    #: the controller's own SLOs are burning error budget (obs/slo.py) — the
    #: detector layer watching the watcher
    SLO_BURN = 7


class NotificationAction(enum.Enum):
    """AnomalyNotificationResult action (IGNORE / FIX / CHECK with delay)."""

    IGNORE = "IGNORE"
    FIX = "FIX"
    CHECK = "CHECK"


@dataclasses.dataclass(frozen=True)
class NotificationResult:
    action: NotificationAction
    delay_ms: int = 0

    @classmethod
    def ignore(cls) -> "NotificationResult":
        return cls(NotificationAction.IGNORE)

    @classmethod
    def fix(cls) -> "NotificationResult":
        return cls(NotificationAction.FIX)

    @classmethod
    def check(cls, delay_ms: int) -> "NotificationResult":
        return cls(NotificationAction.CHECK, delay_ms)


_anomaly_ids = itertools.count()


@dataclasses.dataclass
class Anomaly:
    """Base anomaly; subclasses define ``fix_with``."""

    anomaly_type: AnomalyType = dataclasses.field(init=False)
    anomaly_id: int = dataclasses.field(default_factory=lambda: next(_anomaly_ids), init=False)
    detected_ms: int = dataclasses.field(
        default_factory=lambda: int(time.time() * 1000), init=False
    )
    #: result of the fix attempt, populated by the manager
    fix_result: Optional[object] = dataclasses.field(default=None, init=False)

    def fix_with(self, cruise_control) -> Optional[object]:  # pragma: no cover - abstract
        raise NotImplementedError

    def description(self) -> str:
        return type(self).__name__

    def __lt__(self, other: "Anomaly") -> bool:
        return (self.anomaly_type, self.detected_ms) < (other.anomaly_type, other.detected_ms)


@dataclasses.dataclass
class GoalViolations(Anomaly):
    """Unfixable/fixable goal violations (GoalViolations.java); fix = rebalance."""

    violated_goals: List[str] = dataclasses.field(default_factory=list)
    fixable: bool = True

    def __post_init__(self):
        self.anomaly_type = AnomalyType.GOAL_VIOLATION

    def fix_with(self, cc):
        return cc.rebalance(dryrun=False, triggered_by_violation=True)

    def description(self) -> str:
        return f"GoalViolations{{{', '.join(self.violated_goals)}}}"


@dataclasses.dataclass
class BrokerFailures(Anomaly):
    """Dead brokers (BrokerFailures.java); fix = remove_brokers."""

    failed_brokers: Dict[int, int] = dataclasses.field(default_factory=dict)  # id -> ts

    def __post_init__(self):
        self.anomaly_type = AnomalyType.BROKER_FAILURE

    def fix_with(self, cc):
        return cc.remove_brokers(sorted(self.failed_brokers), dryrun=False)

    def description(self) -> str:
        return f"BrokerFailures{{{sorted(self.failed_brokers)}}}"


@dataclasses.dataclass
class DiskFailures(Anomaly):
    """Offline logdirs (DiskFailures.java); fix = fix_offline_replicas."""

    failed_disks: Dict[int, List[str]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.anomaly_type = AnomalyType.DISK_FAILURE

    def fix_with(self, cc):
        return cc.fix_offline_replicas(dryrun=False)

    def description(self) -> str:
        return f"DiskFailures{{{self.failed_disks}}}"


class SlowBrokerAction(enum.Enum):
    DEMOTE = "DEMOTE"
    REMOVE = "REMOVE"


@dataclasses.dataclass
class SlowBrokers(Anomaly):
    """Slow brokers found by the metric-anomaly finder (SlowBrokerFinder.java:109);
    fix = demote (persistent slowness escalates to remove)."""

    slow_brokers: Dict[int, int] = dataclasses.field(default_factory=dict)
    action: SlowBrokerAction = SlowBrokerAction.DEMOTE

    def __post_init__(self):
        self.anomaly_type = AnomalyType.METRIC_ANOMALY

    def fix_with(self, cc):
        ids = sorted(self.slow_brokers)
        if self.action is SlowBrokerAction.REMOVE:
            return cc.remove_brokers(ids, dryrun=False)
        return cc.demote_brokers(ids, dryrun=False)

    def description(self) -> str:
        return f"SlowBrokers{{{sorted(self.slow_brokers)}, {self.action.value}}}"


@dataclasses.dataclass
class TopicReplicationFactorAnomaly(Anomaly):
    """Topics whose RF differs from the target (TopicReplicationFactorAnomalyFinder)."""

    bad_topics: Dict[str, int] = dataclasses.field(default_factory=dict)  # topic -> rf
    target_rf: int = 3

    def __post_init__(self):
        self.anomaly_type = AnomalyType.TOPIC_ANOMALY

    def fix_with(self, cc):
        # RF change = per-partition replica-set resize; round-1 surfaces the
        # anomaly and defers the fix to the operator (reference behavior when
        # self-healing for TOPIC_ANOMALY is disabled).
        return None

    def description(self) -> str:
        return f"TopicReplicationFactorAnomaly{{{self.bad_topics}, target={self.target_rf}}}"


class MaintenanceEventType(enum.Enum):
    ADD_BROKER = "ADD_BROKER"
    REMOVE_BROKER = "REMOVE_BROKER"
    DEMOTE_BROKER = "DEMOTE_BROKER"
    REBALANCE = "REBALANCE"
    FIX_OFFLINE_REPLICAS = "FIX_OFFLINE_REPLICAS"
    TOPIC_REPLICATION_FACTOR = "TOPIC_REPLICATION_FACTOR"


@dataclasses.dataclass
class MaintenanceEvent(Anomaly):
    """Planned operation submitted via the maintenance channel
    (MaintenanceEventDetector / MaintenancePlan)."""

    event_type: MaintenanceEventType = MaintenanceEventType.REBALANCE
    broker_ids: List[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.anomaly_type = AnomalyType.MAINTENANCE_EVENT

    def fix_with(self, cc):
        t = self.event_type
        if t is MaintenanceEventType.ADD_BROKER:
            return cc.add_brokers(self.broker_ids, dryrun=False)
        if t is MaintenanceEventType.REMOVE_BROKER:
            return cc.remove_brokers(self.broker_ids, dryrun=False)
        if t is MaintenanceEventType.DEMOTE_BROKER:
            return cc.demote_brokers(self.broker_ids, dryrun=False)
        if t is MaintenanceEventType.FIX_OFFLINE_REPLICAS:
            return cc.fix_offline_replicas(dryrun=False)
        return cc.rebalance(dryrun=False)

    def description(self) -> str:
        return f"MaintenanceEvent{{{self.event_type.value}, {self.broker_ids}}}"

    def dedupe_key(self) -> tuple:
        """IdempotenceCache key (MaintenanceEventDetector's dedupe)."""
        return (self.event_type, tuple(sorted(self.broker_ids)))


@dataclasses.dataclass
class ExecutionFailure(Anomaly):
    """A proposal execution finished degraded — fatal backend error, dead or
    stuck (timed-out) tasks, or tasks lost mid-phase.  The cluster may be
    mid-move in an unplanned intermediate state, so the fix is a fresh
    rebalance: the optimizer re-reads live metadata and converges from
    wherever the failed execution actually left the replicas."""

    execution_id: int = 0
    error: Optional[str] = None
    dead_tasks: int = 0
    failed_tasks: int = 0

    def __post_init__(self):
        self.anomaly_type = AnomalyType.EXECUTION_FAILURE

    def fix_with(self, cc):
        return cc.rebalance(dryrun=False, triggered_by_violation=True)

    def description(self) -> str:
        return (
            f"ExecutionFailure{{id={self.execution_id}, dead={self.dead_tasks}, "
            f"failed={self.failed_tasks}, error={self.error!r}}}"
        )


@dataclasses.dataclass
class SloBurnAnomaly(Anomaly):
    """One or more SLO burn-rate alerts firing against the process itself
    (``obs/slo.py``).  Unlike every other anomaly, the fix targets the
    *controller plane*, not the cluster: a bounded self-heal that flips the
    continuous controller to paused — degraded answers keep being served
    from the journaled standing set — and pauses fleet drain arbitration,
    shrinking the blast radius while the operator (or recovery) catches up.
    The emitting :class:`SelfMetricAnomalyFinder` auto-resumes both once
    every alert clears, so the heal is a state, not a ratchet."""

    #: SloAlert.to_dict() blocks of the alerts firing at detection time
    alerts: List[dict] = dataclasses.field(default_factory=list)
    #: handles the finder bound at construction (None = surface only)
    controller: Optional[object] = dataclasses.field(default=None, repr=False)
    fleet: Optional[object] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.anomaly_type = AnomalyType.SLO_BURN

    def _reason(self) -> str:
        slos = sorted({a.get("slo", "?") for a in self.alerts})
        return f"slo-burn: {', '.join(slos)}"

    def fix_with(self, cc):
        actions: List[str] = []
        reason = self._reason()
        if self.controller is not None and not getattr(
            self.controller, "paused", False
        ):
            self.controller.pause(reason)
            actions.append("controller-paused")
        if self.fleet is not None and not getattr(self.fleet, "paused", False):
            self.fleet.pause(reason)
            actions.append("fleet-drains-paused")
        return {"actions": actions, "reason": reason}

    def description(self) -> str:
        pairs = sorted(
            {f"{a.get('slo', '?')}/{a.get('pair', '?')}" for a in self.alerts}
        )
        return f"SloBurnAnomaly{{{', '.join(pairs)}}}"


@dataclasses.dataclass
class PartitionSizeAnomaly(Anomaly):
    """Partitions whose on-disk size exceeds the configured limit
    (PartitionSizeAnomalyFinder — oversized partitions hurt reassignment times
    and broker recovery; surfaced for operator action)."""

    oversized: Dict[tuple, float] = dataclasses.field(default_factory=dict)  # tp -> size
    size_limit: float = 0.0

    def __post_init__(self):
        self.anomaly_type = AnomalyType.TOPIC_ANOMALY

    def fix_with(self, cc):
        # the reference's fix is operator-driven (add partitions to the topic);
        # surfaced, not self-healed
        return None

    def description(self) -> str:
        tps = sorted(self.oversized)[:5]
        return (
            f"PartitionSizeAnomaly{{{len(self.oversized)} partitions over "
            f"{self.size_limit:.0f}, e.g. {tps}}}"
        )
