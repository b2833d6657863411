"""Movement concurrency management and auto-adjustment.

Port of ``cruise_control_tpu/executor/concurrency.py``.

Counterpart of ``executor/concurrency/ExecutionConcurrencyManager`` and the
ConcurrencyAdjuster loop (``Executor.java:466``, recommendation logic in
``ExecutionUtils.recommendedConcurrency``): per-broker and cluster-wide caps on
in-flight inter-broker moves (plus leadership-batch size), automatically raised when
the cluster is healthy and multiplicatively dropped when (At/Under)MinISR partitions
appear — additive-increase / multiplicative-decrease, like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class ConcurrencyConfig:
    """ExecutorConfig knobs (num.concurrent.partition.movements.per.broker & co)."""

    per_broker_moves: int = 5
    cluster_moves: int = 50
    leadership_batch: int = 1000
    intra_broker_moves: int = 2
    max_per_broker_moves: int = 12
    min_per_broker_moves: int = 1
    max_cluster_moves: int = 120
    min_cluster_moves: int = 5


class ExecutionConcurrencyManager:
    def __init__(self, config: ConcurrencyConfig) -> None:
        self.config = config
        self._per_broker: Dict[int, int] = {}
        self._cluster_cap = config.cluster_moves

    def per_broker_cap(self, broker_id: int) -> int:
        return self._per_broker.get(broker_id, self.config.per_broker_moves)

    @property
    def cluster_cap(self) -> int:
        return self._cluster_cap

    def set_per_broker_cap(self, broker_id: Optional[int], cap: int) -> None:
        """Admin override (ADMIN endpoint's concurrency adjustment); None = all."""
        cap = max(self.config.min_per_broker_moves, min(cap, self.config.max_per_broker_moves))
        if broker_id is None:
            self.config.per_broker_moves = cap
            self._per_broker.clear()
        else:
            self._per_broker[broker_id] = cap

    def set_cluster_cap(self, cap: int) -> None:
        self._cluster_cap = max(
            self.config.min_cluster_moves, min(cap, self.config.max_cluster_moves)
        )


class ConcurrencyAdjuster:
    """Additive-increase / multiplicative-decrease on movement concurrency."""

    def __init__(self, manager: ExecutionConcurrencyManager) -> None:
        self.manager = manager

    def tick(self, num_under_min_isr: int, num_at_min_isr: int) -> None:
        """One adjustment interval (Executor.java:466's scheduled check)."""
        m = self.manager
        if num_under_min_isr > 0:
            # cluster unhealthy: halve everything
            m.set_cluster_cap(m.cluster_cap // 2)
            m.config.per_broker_moves = max(
                m.config.min_per_broker_moves, m.config.per_broker_moves // 2
            )
        elif num_at_min_isr > 0:
            m.set_cluster_cap(m.cluster_cap - m.config.min_cluster_moves)
        else:
            m.set_cluster_cap(m.cluster_cap + m.config.min_cluster_moves)
            m.config.per_broker_moves = min(
                m.config.max_per_broker_moves, m.config.per_broker_moves + 1
            )
