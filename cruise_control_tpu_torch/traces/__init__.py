"""Time-series scenario engine: load traces and policy rollouts.

Port of ``cruise_control_tpu.traces``:

* :mod:`~cruise_control_tpu_torch.traces.trace` -- the declarative
  :class:`LoadTrace` DSL: seeded-deterministic segment composition (diurnal
  sinusoid, ramps, spikes, per-topic growth, noise) into per-step
  load-factor vectors; every trace step *is* a
  :class:`~cruise_control_tpu_torch.sim.scenario.Scenario`.
* :mod:`~cruise_control_tpu_torch.traces.rollout` -- batched
  :class:`~cruise_control_tpu_torch.traces.policy.AutoscalePolicy`
  evaluation: a time loop over a stack of (trace, policy) pairs on the
  device, one host sync for the whole batch.
* :mod:`~cruise_control_tpu_torch.traces.replay` -- drive a trace-synthesized
  metric stream through the real monitor into a live continuous controller on
  a fake clock (no sleeping), with ``kind="replay"`` flight records.
"""

from cruise_control_tpu_torch.traces.policy import AutoscalePolicy, frozen_policy
from cruise_control_tpu_torch.traces.replay import FakeClock, ReplayReport, run_replay
from cruise_control_tpu_torch.traces.rollout import (
    RolloutResult,
    RolloutVerdict,
    horizon_requirements,
    rollout,
)
from cruise_control_tpu_torch.traces.trace import (
    LoadTrace,
    TraceSegment,
    diurnal_trace,
    drift_storm_trace,
    ramp_trace,
    spike_trace,
)

__all__ = [
    "AutoscalePolicy",
    "FakeClock",
    "LoadTrace",
    "ReplayReport",
    "RolloutResult",
    "RolloutVerdict",
    "TraceSegment",
    "diurnal_trace",
    "drift_storm_trace",
    "frozen_policy",
    "horizon_requirements",
    "ramp_trace",
    "rollout",
    "run_replay",
    "spike_trace",
]
