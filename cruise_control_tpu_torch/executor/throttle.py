"""Replication throttling around executions.

Port of ``cruise_control_tpu/executor/throttle.py``.

Counterpart of ``executor/ReplicationThrottleHelper.java:37`` (``setThrottles``:75):
before inter-broker moves start, set the leader/follower replication throttle rate
and the throttled-replica lists on every broker involved; remove them when the
execution finishes (or is stopped).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.backend.base import ClusterBackend, TopicPartition
from cruise_control_tpu_torch.executor.tasks import ExecutionTask


class ReplicationThrottleHelper:
    def __init__(self, backend: ClusterBackend, rate_bytes: Optional[float]) -> None:
        self.backend = backend
        self.rate_bytes = rate_bytes
        self._active = False

    def set_throttles(self, tasks: Sequence[ExecutionTask]) -> None:
        if self.rate_bytes is None or not tasks:
            return
        by_broker: Dict[int, List[TopicPartition]] = {}
        for t in tasks:
            for b in t.brokers_involved:
                by_broker.setdefault(b, []).append(t.proposal.tp)
        self.backend.set_replication_throttles(self.rate_bytes, by_broker)
        self._active = True

    def clear_throttles(self) -> None:
        if self._active:
            self.backend.clear_replication_throttles()
            self._active = False
