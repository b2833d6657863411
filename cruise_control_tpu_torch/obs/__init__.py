"""Observability: the flight recorder, the profiler, the exporter and the
self-monitoring plane.

Port of ``cruise_control_tpu/obs`` (the regression gate, ``obs/gate.py``,
is not ported yet, and the exporter renders no gate family until it is):

- :mod:`~cruise_control_tpu_torch.obs.recorder` -- every optimize, executor
  run, detector cycle and model build emits a structured :class:`TraceRecord`
  into a ring buffer and an optional JSONL sink;
- :mod:`~cruise_control_tpu_torch.obs.profiler` -- the hand-written kernels'
  census (calls, builds, reckoned operations and bytes per shape) and the
  per-device memory gauges;
- :mod:`~cruise_control_tpu_torch.obs.exporter` -- the Prometheus text page
  of the whole telemetry plane, and its strict parser;
- :mod:`~cruise_control_tpu_torch.obs.selfmon` -- the sensor registry (plus
  the recorder's summary and the profiler census) as windowed time-series;
- :mod:`~cruise_control_tpu_torch.obs.slo` -- burn-rate SLOs over those
  series.

All of it is host-side bookkeeping: nothing here launches device work.
"""

from cruise_control_tpu_torch.obs.recorder import (  # noqa: F401
    RECORDER,
    FlightRecorder,
    Span,
    TraceRecord,
    append_jsonl_capped,
    current_parent_id,
    parent_scope,
    read_jsonl,
)
from cruise_control_tpu_torch.obs.profiler import PROFILER, profile_jit  # noqa: F401
from cruise_control_tpu_torch.obs.selfmon import SelfMonitor, read_spool  # noqa: F401
from cruise_control_tpu_torch.obs.slo import (  # noqa: F401
    DEFAULT_PAIRS,
    SloAlert,
    SloEngine,
    SloSpec,
    WindowPair,
    build_pairs,
    set_global_engine,
    shipped_specs,
)
