"""Cluster backend SPI and the in-process fake backend.

Port of ``cruise_control_tpu/backend``: :class:`ClusterBackend` is the narrow
interface the monitor and the executor talk to, and
:class:`FakeClusterBackend` the deterministic in-process stand-in tests and
demos use, :class:`BreakerBackend` the circuit breaker around any backend
and :class:`ChaosBackend` the seeded fault injector.
"""

from cruise_control_tpu_torch.backend.base import (
    BrokerInfo,
    ClusterBackend,
    ClusterDescription,
    LogdirInfo,
    PartitionInfo,
    RawMetric,
    ReassignmentInProgress,
)
from cruise_control_tpu_torch.backend.breaker import (
    BreakerBackend,
    BreakerOpenError,
    CircuitBreaker,
)
from cruise_control_tpu_torch.backend.chaos import (
    ChaosBackend,
    ChaosInjectedError,
    FaultPlan,
    SimulatedCrash,
)
from cruise_control_tpu_torch.backend.fake import FakeClusterBackend

__all__ = [
    "BreakerBackend",
    "BreakerOpenError",
    "BrokerInfo",
    "ChaosBackend",
    "ChaosInjectedError",
    "CircuitBreaker",
    "SimulatedCrash",
    "ClusterBackend",
    "ClusterDescription",
    "FaultPlan",
    "LogdirInfo",
    "PartitionInfo",
    "RawMetric",
    "ReassignmentInProgress",
    "FakeClusterBackend",
]
