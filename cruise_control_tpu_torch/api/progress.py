"""Operation progress tracking.

Port of ``cruise_control_tpu/api/progress.py`` (pure Python, copied whole).

Counterpart of ``async/progress/OperationProgress.java`` and its step classes
(``WaitingForClusterModel``, ``RetrievingMetrics``, ``GeneratingClusterModel``,
``OptimizationForGoal`` …): an append-only list of named steps with completion
percentages, surfaced in async 202 responses and USER_TASKS.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List


@dataclasses.dataclass
class Step:
    description: str
    started_ms: int
    completion_pct: float = 0.0


class OperationProgress:
    def __init__(self) -> None:
        self._steps: List[Step] = []
        self._lock = threading.Lock()

    def add_step(self, description: str) -> Step:
        with self._lock:
            if self._steps:
                self._steps[-1].completion_pct = 100.0
            step = Step(description, int(time.time() * 1000))
            self._steps.append(step)
            return step

    def complete(self) -> None:
        with self._lock:
            if self._steps:
                self._steps[-1].completion_pct = 100.0

    def to_list(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "step": s.description,
                    "startMs": s.started_ms,
                    "completionPercentage": s.completion_pct,
                }
                for s in self._steps
            ]
