"""Detector layer: anomaly detection and the self-healing loop.

Port of ``cruise_control_tpu/detector`` (pure Python, copied).  The
detectors and the manager run on the host; the one that solves,
:class:`GoalViolationDetector`, does so through the facade's dry-run
``rebalance``, so on the facade's device.

Counterpart of ``cruise-control/src/main/java/.../detector/`` (SURVEY §2.3).
"""

from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    AnomalyType,
    BrokerFailures,
    DiskFailures,
    ExecutionFailure,
    GoalViolations,
    MaintenanceEvent,
    MaintenanceEventType,
    NotificationAction,
    NotificationResult,
    SloBurnAnomaly,
    SlowBrokerAction,
    SlowBrokers,
    TopicReplicationFactorAnomaly,
)
from cruise_control_tpu_torch.detector.detectors import (
    BrokerFailureDetector,
    Detector,
    DiskFailureDetector,
    ExecutionFailureDetector,
    GoalViolationDetector,
    MaintenanceEventDetector,
    SelfMetricAnomalyFinder,
    SlowBrokerFinder,
    TopicReplicationFactorAnomalyFinder,
)
from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager, AnomalyDetectorState
from cruise_control_tpu_torch.detector.notifier import (
    AlertCallbackNotifier,
    AnomalyNotifier,
    NoopNotifier,
    SelfHealingNotifier,
)
from cruise_control_tpu_torch.detector.provisioner import (
    BasicProvisioner,
    CallbackProvisioner,
    NoopProvisioner,
    Provisioner,
    ProvisionerResult,
    ProvisionerState,
)

__all__ = [
    "AlertCallbackNotifier",
    "Anomaly",
    "AnomalyDetectorManager",
    "AnomalyDetectorState",
    "AnomalyNotifier",
    "AnomalyType",
    "BasicProvisioner",
    "BrokerFailureDetector",
    "BrokerFailures",
    "CallbackProvisioner",
    "Detector",
    "DiskFailureDetector",
    "DiskFailures",
    "ExecutionFailure",
    "ExecutionFailureDetector",
    "GoalViolationDetector",
    "GoalViolations",
    "MaintenanceEvent",
    "MaintenanceEventDetector",
    "MaintenanceEventType",
    "NoopNotifier",
    "NoopProvisioner",
    "NotificationAction",
    "NotificationResult",
    "Provisioner",
    "ProvisionerResult",
    "ProvisionerState",
    "SelfHealingNotifier",
    "SelfMetricAnomalyFinder",
    "SloBurnAnomaly",
    "SlowBrokerAction",
    "SlowBrokerFinder",
    "SlowBrokers",
    "TopicReplicationFactorAnomalyFinder",
]
