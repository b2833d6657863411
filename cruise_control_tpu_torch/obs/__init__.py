"""Observability: the flight recorder and the device-memory profiler.

Port of ``cruise_control_tpu/obs`` (the recorder and the profiler's memory
half).  The regression gate, the exporter and the self-monitoring plane are
not ported yet.
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
from cruise_control_tpu_torch.obs.profiler import PROFILER  # noqa: F401
