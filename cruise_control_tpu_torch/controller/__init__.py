"""Controller layer (port of ``cruise_control_tpu.controller``): so far only
the drift math of the continuous controller's tick; the standing proposal set
and the loop itself are still to be ported."""

from cruise_control_tpu_torch.controller.drift import DriftReport, evaluate_drift

__all__ = ["DriftReport", "evaluate_drift"]
