"""Device profiler: the hand-written kernels' cost census and the per-device
memory gauges, host-side.

Port of ``cruise_control_tpu/obs/profiler.py``.  The JAX profiler wraps each
jitted program (``profile_jit``) and attaches XLA's cost analysis of the whole
program.  The port has no compiled programs: its device work is eager PyTorch
ops around three hand-written kernels (``segment_sum_f32``,
``segment_sum_i32``, ``even_assign``).  So here the "programs" are those
kernels, and the census is kept by their wrappers (``ops/segments.py``,
``ops/assign.py``):

* **Registration** -- each host call of a wrapper that launches its kernel
  (on the CPU: each call of its plain version, where the kernel would have
  launched) reports to :meth:`DeviceProfiler.on_call`, the one entry point,
  with its shape signature, the host wall of the call (enqueue, never device
  time: the wrappers add no synchronisation), the ``nvcc`` builds it caused,
  and a ``describe`` callable that runs the first time the signature is seen
  and gives the operations and bytes reckoned from the shape by the formula
  of ``chip_smoke.py``'s ``bound_ms`` (each input read once, each output
  written once).  ``flops`` / ``bytes_accessed`` name those reckoned counts.
  They count the hand-written kernels' work only, not the eager PyTorch ops
  around them, while a JAX total counts the whole program: the two are not
  comparable.
* **Attribution** -- the profiler keeps running totals (calls, reckoned
  operations and bytes, calls without a reckoning); :meth:`mark` snapshots
  them and :meth:`cost_since` returns the growth since a snapshot, so an
  optimize, rollout or sweep record carries the work of its own kernel calls
  (the ``attrs["cost"]`` block) at a constant cost per call.
* **Memory** -- :meth:`sample_memory` reads ``torch.cuda.memory_stats()``
  (peak and in-use bytes per card) whenever the flight recorder closes a
  trace.  Where no CUDA context exists (the CPU, or a process that has not
  touched the card yet) the sample is empty: sampling never creates a
  context.

The launch counters of the wrappers (``LAUNCHES``) stay the count the smoke
reads; the census is bookkeeping beside them.  :func:`profile_jit` and
:meth:`DeviceProfiler.set_analysis` exist for parity with the JAX package's
tests only: nothing in the port wraps a callable with them, but the JAX
telemetry test module, which ``tests/test_torch_telemetry.py`` runs against
the port, imports ``profile_jit``, and its ``TestProfiler`` calls it.  The
solver's own timing is the flight recorder's (``obs/recorder.py``: spans, the
host's wait, the goal graphs' device time).
``CC_TPU_PROFILER=0`` disables the layer (memory gauges included).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch


class CostMark(NamedTuple):
    """The census's running totals at one instant (see :meth:`DeviceProfiler.mark`)."""

    calls: int = 0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    unanalyzed: int = 0


@dataclasses.dataclass
class ExecutableProfile:
    """One kernel signature: a (kernel, shape) pair."""

    program: str                      # the kernel, e.g. "segment_sum_f32"
    signature: str                    # human-readable shape summary
    calls: int = 0                    # kernel calls the device ran, replays included
    #: of ``calls``, those replayed inside a device loop's captured rounds
    #: (no host wall of their own)
    graph_calls: int = 0
    total_call_s: float = 0.0         # host wall of the host calls, not device time
    last_call_s: float = 0.0
    compile_events: int = 0           # nvcc builds attributed to this kernel
    compile_s: float = 0.0
    #: operations and bytes of one call, reckoned from the shape (None for an
    #: entry registered without a reckoning)
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    analysis: str = "pending"         # "pending" | "ok" | "unavailable"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class DeviceProfiler:
    """Process-wide kernel census and device-memory sampler."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[tuple, ExecutableProfile] = {}
        self._totals = CostMark()
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

    # -- per-call bookkeeping ------------------------------------------------

    def on_call(
        self,
        program: str,
        key: tuple,
        signature: Union[str, Callable[[], Tuple[str, float, float]]],
        wall_s: float,
        events: Sequence[dict] = (),
    ) -> Tuple[Optional[ExecutableProfile], bool]:
        """Record one call; returns ``(entry, first_sight_of_signature)``, or
        ``(None, False)`` when the profiler is disabled.

        ``key`` is the call's shape signature (hashable).  ``signature`` is
        its readable summary, or a callable giving ``(summary, operations,
        bytes)`` of one call that runs only the first time ``key`` is seen
        and attaches that reckoning to the entry (the kernel wrappers' form).
        Host bookkeeping only: a dict lookup and a few additions."""
        if not self.enabled:
            return None, False
        with self._lock:
            entry = self._entries.get(key)
            fresh = entry is None
            if fresh:
                if callable(signature):
                    summary, ops, nbytes = signature()
                    entry = ExecutableProfile(program=program, signature=summary, flops=float(ops),
                                              bytes_accessed=float(nbytes), analysis="ok")
                else:
                    entry = ExecutableProfile(program=program, signature=signature)
                self._entries[key] = entry
            entry.calls += 1
            entry.total_call_s += wall_s
            entry.last_call_s = wall_s
            if events:
                entry.compile_events += len(events)
                entry.compile_s += sum(e.get("duration_s", 0.0) for e in events)
            self._count_locked(entry, 1)
        return entry, fresh

    def on_graph_calls(
        self, program: str, key: tuple, signature: Callable[[], Tuple[str, float, float]], calls: int,
    ) -> None:
        """Record ``calls`` replays of a call captured in a device loop's
        round (``ops.graph_loop``): counted like host calls, with no wall."""
        if not self.enabled or calls <= 0:
            return
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                summary, ops, nbytes = signature()
                entry = self._entries[key] = ExecutableProfile(
                    program=program, signature=summary, flops=float(ops),
                    bytes_accessed=float(nbytes), analysis="ok",
                )
            entry.calls += calls
            entry.graph_calls += calls
            self._count_locked(entry, calls)

    def _count_locked(self, entry: ExecutableProfile, calls: int) -> None:
        t = self._totals
        if entry.flops is None:
            self._totals = t._replace(calls=t.calls + calls, unanalyzed=t.unanalyzed + calls)
        else:
            self._totals = t._replace(calls=t.calls + calls, flops=t.flops + entry.flops * calls,
                                      bytes_accessed=t.bytes_accessed + (entry.bytes_accessed or 0.0) * calls)

    def set_analysis(self, key: tuple, cost: Optional[dict]) -> None:
        """Attach a cost to an entry registered without one (``{"flops",
        "bytes accessed"}``, the JAX cost-analysis keys; None marks it
        unavailable).  The entry's calls so far move from the unanalysed
        total to the reckoned ones, as the JAX profiler's window reads them."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            if cost is None:
                entry.analysis = "unavailable"
                return
            if entry.flops is None:
                t = self._totals
                self._totals = t._replace(calls=t.calls - entry.calls, unanalyzed=t.unanalyzed - entry.calls)
            else:
                self._count_locked(entry, -entry.calls)
            entry.flops = float(cost.get("flops", 0.0) or 0.0)
            entry.bytes_accessed = float(cost.get("bytes accessed", 0.0) or 0.0)
            entry.analysis = "ok"
            self._count_locked(entry, entry.calls)

    # -- windows (the attrs["cost"] block) -----------------------------------

    def mark(self) -> CostMark:
        """The running totals now; pair with :meth:`cost_since`.

        The totals are process-global, so concurrent operations' windows
        overlap and cross-attribute -- the same tradeoff as the recorder's
        compile-event marks: single-threaded emitters are exact."""
        with self._lock:
            return self._totals

    def cost_since(self, mark: CostMark) -> dict:
        """The work of the kernel calls made since ``mark``: reckoned
        operations (``flops``) and bytes summed over the calls, the number
        of calls, and a device-memory watermark sampled now."""
        with self._lock:
            now = self._totals
        return {
            "flops": now.flops - mark.flops,
            "bytes_accessed": now.bytes_accessed - mark.bytes_accessed,
            "profiled_calls": now.calls - mark.calls,
            "unanalyzed_calls": now.unanalyzed - mark.unanalyzed,
            "memory_peak_bytes": self.memory_peak_bytes(),
        }

    # -- memory (sampled at trace boundaries by recorder.finish_trace) -------

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

    # -- export surfaces -----------------------------------------------------

    def snapshot(self) -> dict:
        """Status surface: every kernel signature and the last memory sample."""
        with self._lock:
            executables = [e.to_dict() for e in self._entries.values()]
            memory = list(self._memory)
        executables.sort(key=lambda e: (e["program"], e["signature"]))
        return {"enabled": self.enabled, "executables": executables, "memory": memory}

    def per_program_totals(self) -> Dict[str, dict]:
        """Aggregate over shape signatures: the exporter's per-kernel rows.
        ``flops_total`` / ``bytes_total`` are executed totals (one call's
        reckoning x calls)."""
        out: Dict[str, dict] = {}
        with self._lock:
            entries = [dataclasses.replace(e) for e in self._entries.values()]
        for e in entries:
            row = out.setdefault(
                e.program,
                {
                    "calls": 0, "call_seconds": 0.0, "compile_events": 0,
                    "compile_seconds": 0.0, "flops_total": 0.0,
                    "bytes_total": 0.0, "signatures": 0,
                },
            )
            row["calls"] += e.calls
            row["call_seconds"] += e.total_call_s
            row["compile_events"] += e.compile_events
            row["compile_seconds"] += e.compile_s
            row["signatures"] += 1
            if e.flops is not None:
                row["flops_total"] += e.flops * e.calls
                row["bytes_total"] += (e.bytes_accessed or 0.0) * e.calls
        return out

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._totals = CostMark()
            self._memory = []


#: process-wide profiler (the device-cost counterpart of sensors.REGISTRY)
PROFILER = DeviceProfiler()


def _leaf_sig(x) -> tuple:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype))
    return (type(x).__name__,)


class ProfiledCall:
    """A callable registered with :data:`PROFILER` under ``name``: each call
    is recorded per argument-shape signature with its host wall and the
    builds it caused.  The port has no compiler to ask for a program's cost,
    so its entries stay unanalysed (``analysis="unavailable"``).  Kept for
    parity with the JAX package's tests: the kernels' wrappers report their
    reckoned work to :meth:`DeviceProfiler.on_call` themselves."""

    def __init__(self, name: str, fn) -> None:
        self._name = name
        self._fn = fn

    @property
    def __wrapped__(self):
        return self._fn

    def __call__(self, *args, **kwargs):
        if not PROFILER.enabled:
            return self._fn(*args, **kwargs)
        from cruise_control_tpu_torch.obs.recorder import compile_events_since, compile_mark

        sig = tuple(_leaf_sig(a) for a in args)
        key = (self._name, sig, tuple(sorted(kwargs)))
        mark = compile_mark()
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        wall = time.perf_counter() - t0
        _, fresh = PROFILER.on_call(self._name, key, f"{len(sig)} args", wall, compile_events_since(mark))
        if fresh:
            PROFILER.set_analysis(key, None)
        return out


def profile_jit(name: str, fn) -> ProfiledCall:
    """Register a callable with the profiler (the JAX package's name for it)."""
    return ProfiledCall(name, fn)
