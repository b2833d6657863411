"""Device profiler: per-device memory gauges sampled at trace boundaries.

Port of the memory half of ``cruise_control_tpu/obs/profiler.py``.
:meth:`DeviceProfiler.sample_memory` reads ``torch.cuda.memory_stats()``
(peak and in-use bytes per card) whenever the flight recorder closes a
trace, so a long-lived process tracks its device-memory watermark without a
polling thread.  Where no CUDA context exists (the CPU, or a process that
has not touched the card yet) the sample is empty: sampling never creates a
context.

The JAX profiler's other half, ``profile_jit`` and its per-executable
FLOPs/bytes from XLA's cost analysis, has no counterpart on an eager path
and is not ported.  ``CC_TPU_PROFILER=0`` disables the layer.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import torch


class DeviceProfiler:
    """Process-wide device-memory sampler."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._memory: List[dict] = []
        self._enabled: Optional[bool] = None

    @property
    def enabled(self) -> bool:
        if self._enabled is None:
            env = os.environ.get("CC_TPU_PROFILER")
            self._enabled = env not in ("0", "false", "") if env is not None else True
        return self._enabled

    @enabled.setter
    def enabled(self, value: bool) -> None:
        self._enabled = bool(value)

    def sample_memory(self) -> List[dict]:
        """Refresh the per-device memory gauges from ``torch.cuda.memory_stats``:
        one row per card, ``[]`` when disabled or without a CUDA context."""
        from cruise_control_tpu_torch.core.sensors import REGISTRY

        samples: List[dict] = []
        if self.enabled and torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                row = {
                    "device": f"cuda:{i}",
                    "bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                    "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
                }
                samples.append(row)
                for stat in ("bytes_in_use", "peak_bytes_in_use"):
                    if row[stat] is not None:
                        REGISTRY.gauge(
                            f"DeviceMemory.{row['device']}-{stat.replace('_', '-')}"
                        ).set(row[stat])
        with self._lock:
            self._memory = samples
        return samples

    def memory_peak_bytes(self) -> Optional[int]:
        """The largest per-card peak of a fresh sample (None without one)."""
        peaks = [
            m["peak_bytes_in_use"] for m in self.sample_memory()
            if m.get("peak_bytes_in_use") is not None
        ]
        return max(peaks) if peaks else None

    def snapshot(self) -> dict:
        """Status surface: the last memory sample."""
        with self._lock:
            memory = list(self._memory)
        return {"enabled": self.enabled, "memory": memory}


#: process-wide profiler
PROFILER = DeviceProfiler()
