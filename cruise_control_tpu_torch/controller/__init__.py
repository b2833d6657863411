"""Continuous control loop (port of ``cruise_control_tpu.controller``):
streaming, drift-triggered incremental rebalancing with a durable standing
proposal set.  See :mod:`cruise_control_tpu_torch.controller.loop`."""

from cruise_control_tpu_torch.controller.drift import DriftReport, evaluate_drift
from cruise_control_tpu_torch.controller.loop import ContinuousController, ControllerConfig
from cruise_control_tpu_torch.controller.standing import ControllerJournal, StandingProposalSet

__all__ = [
    "ContinuousController",
    "ControllerConfig",
    "ControllerJournal",
    "DriftReport",
    "StandingProposalSet",
    "evaluate_drift",
]
