"""Time-series scenario engine: load traces and policy rollouts.

Port of ``cruise_control_tpu.traces`` (all but the replay harness):

* :mod:`~cruise_control_tpu_torch.traces.trace` -- the declarative
  :class:`LoadTrace` DSL: seeded-deterministic segment composition (diurnal
  sinusoid, ramps, spikes, per-topic growth, noise) into per-step
  load-factor vectors; every trace step *is* a
  :class:`~cruise_control_tpu_torch.sim.scenario.Scenario`.
* :mod:`~cruise_control_tpu_torch.traces.rollout` -- batched
  :class:`~cruise_control_tpu_torch.traces.policy.AutoscalePolicy`
  evaluation: a time loop over a stack of (trace, policy) pairs on the
  device, one host sync for the whole batch.

The replay harness (``traces/replay.py``: a trace-synthesized metric stream
driven through the real facade, monitor and executor on a fake clock) waits
for the port of those service planes.
"""

from cruise_control_tpu_torch.traces.policy import AutoscalePolicy, frozen_policy
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
    "LoadTrace",
    "RolloutResult",
    "RolloutVerdict",
    "TraceSegment",
    "diurnal_trace",
    "drift_storm_trace",
    "frozen_policy",
    "horizon_requirements",
    "ramp_trace",
    "rollout",
    "spike_trace",
]
