"""The load monitor's window-delta event.

Port of ``WindowDelta`` from ``cruise_control_tpu/monitor/loadmonitor.py``,
the event the continuous controller consumes.  The ``LoadMonitor`` itself
(sampling state machine, window aggregators, ``cluster_model()``) is not
ported yet: the controller reads its monitor through a duck-typed facade
(``current_partition_loads()``, ``cpu_weights``, ``add_window_listener``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WindowDelta:
    """One metric-window delta as it lands in the aggregators.

    Pushed to the monitor's window listeners after every non-empty sample
    ingest -- the event surface the continuous controller (``controller/``)
    consumes instead of polling ``cluster_model()`` per request.
    ``window_id`` is the newest window the batch touched (``ts //
    window_ms``); ``new_window`` marks the first delta of a window.
    ``ingest_monotonic`` anchors reaction-latency measurement: time from this
    load evidence landing to a corrective proposal being published."""

    window_id: int
    ts_ms: int
    num_samples: int
    new_window: bool
    ingest_monotonic: float
