"""The program's own flight records of a traced run's window.

Each entry call writes one ``"optimize"`` record into the program's ring
(``cruise_control_tpu_torch.obs.recorder.RECORDER``).  The window's first
pass is traced, one call an input, and the check after the window calls no
solve, so the newest ``min(calls after the traced pass, ring capacity)``
records come from untraced calls of the window.
"""

from __future__ import annotations

from typing import List, Optional


def window_records(run) -> List[object]:
    """The newest optimize records of the window's untraced calls."""
    from cruise_control_tpu_torch.obs.recorder import RECORDER

    n = min(len(run.calls) - len(run.inputs), RECORDER.capacity)
    return RECORDER.recent(n, kind="optimize") if n > 0 else []


def mean_ms(values) -> Optional[float]:
    """The mean of ``values`` (seconds) in ms; None for none."""
    values = list(values)
    return 1e3 * sum(values) / len(values) if values else None
