"""Provisioner SPI: act on under/over-provisioning verdicts.

Port of ``cruise_control_tpu/detector/provisioner.py`` (pure Python,
copied).  A sweep-backed recommendation's ``num_dispatches`` is the port's
host-sync count (``sim.planner.plan_capacity``).

Counterpart of ``detector/Provisioner.java`` + ``BasicProvisioner`` /
``PartitionProvisioner`` / ``NoopProvisioner``: when the optimizer reports an
UNDER_PROVISIONED verdict (hard goals unsatisfiable), the goal-violation flow calls
``rightsize`` (GoalViolationDetector.java:227).  Real capacity actions are
deployment-specific; :class:`BasicProvisioner` records the recommendation and
reports COMPLETED_WITH_ERROR like the reference's placeholder, while
:class:`CallbackProvisioner` delegates to user code (e.g. a cluster autoscaler).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional

from cruise_control_tpu_torch.analyzer.optimizer import ProvisionRecommendation


class ProvisionerState(enum.Enum):
    COMPLETED = "COMPLETED"
    COMPLETED_WITH_ERROR = "COMPLETED_WITH_ERROR"
    IN_PROGRESS = "IN_PROGRESS"


@dataclasses.dataclass
class ProvisionerResult:
    state: ProvisionerState
    summary: str


class Provisioner:
    def rightsize(self, recommendation: ProvisionRecommendation) -> ProvisionerResult:
        raise NotImplementedError


class NoopProvisioner(Provisioner):
    def rightsize(self, recommendation) -> ProvisionerResult:
        return ProvisionerResult(ProvisionerState.COMPLETED, "noop")


class BasicProvisioner(Provisioner):
    """Records recommendations; actual broker/disk changes are out of scope
    (BasicProvisioner.java behaves the same way).

    A recommendation backed by a capacity sweep (``recommendation.sweep``
    populated by ``sim/planner.py``) completes with the concrete broker count
    — there is real data behind the number.  Without a sweep the reference's
    placeholder ``COMPLETED_WITH_ERROR`` stands: the recommendation is an
    unquantified guess the operator must validate."""

    def __init__(self) -> None:
        self.history: List[ProvisionRecommendation] = []

    def rightsize(self, recommendation) -> ProvisionerResult:
        self.history.append(recommendation)
        sweep = getattr(recommendation, "sweep", None)
        if sweep:
            delta = (
                f"+{recommendation.num_brokers_to_add}"
                if recommendation.num_brokers_to_add
                else f"-{recommendation.num_brokers_to_remove}"
                if recommendation.num_brokers_to_remove
                else "±0"
            )
            return ProvisionerResult(
                ProvisionerState.COMPLETED,
                f"sweep-backed {recommendation.status} ({delta} brokers, "
                f"{sweep.get('scenarios_evaluated', '?')} scenarios in "
                f"{sweep.get('num_dispatches', '?')} dispatches): "
                f"{recommendation.message}",
            )
        return ProvisionerResult(
            ProvisionerState.COMPLETED_WITH_ERROR,
            f"recorded recommendation: {recommendation.message}",
        )


class CallbackProvisioner(Provisioner):
    def __init__(
        self, callback: Callable[[ProvisionRecommendation], bool]
    ) -> None:
        self.callback = callback

    def rightsize(self, recommendation) -> ProvisionerResult:
        ok = self.callback(recommendation)
        return ProvisionerResult(
            ProvisionerState.COMPLETED if ok else ProvisionerState.COMPLETED_WITH_ERROR,
            recommendation.message,
        )
