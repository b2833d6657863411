"""Cluster backend SPI and the in-process fake backend.

Port of ``cruise_control_tpu/backend``: :class:`ClusterBackend` is the narrow
interface the monitor and the executor talk to, and
:class:`FakeClusterBackend` the deterministic in-process stand-in tests and
demos use.  The circuit breaker and the chaos backend are not ported yet.
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
from cruise_control_tpu_torch.backend.fake import FakeClusterBackend

__all__ = [
    "BrokerInfo",
    "ClusterBackend",
    "ClusterDescription",
    "LogdirInfo",
    "PartitionInfo",
    "RawMetric",
    "ReassignmentInProgress",
    "FakeClusterBackend",
]
