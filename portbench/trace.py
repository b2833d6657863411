"""The traced run's readings: goal-graph windows, the device's busy time, and the breakdown.

* :class:`GraphTimer` records a CUDA event before and after every launch of a
  goal graph (the program's ``ops.graph_loop.GoalGraph.launch``, wrapped for
  the window as ``chip_smoke.profile_child`` wraps it), so the device time of
  the graphs is known though the profiler sees only some of the kernels a
  graph's WHILE nodes run.
* :class:`Profiled` runs ``torch.profiler`` (CPU and CUDA activity) over the
  window's first pass.  A marker kernel right after a CUDA event ties the
  graph windows to the profiler's clock.  The device is busy where a graph
  window or a traced device operation runs; a window counts the gaps between
  its nodes as busy, so the idle share is a floor.  Each idle gap is put down
  to the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"
#: entries of each breakdown list
TOP = 10

Interval = Tuple[float, float]


class GraphTimer:
    """CUDA events around each goal-graph launch while the block runs."""

    def __init__(self) -> None:
        self.windows: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._orig = None

    def __enter__(self) -> "GraphTimer":
        from cruise_control_tpu_torch.ops import graph_loop as GL

        self._cls = GL.GoalGraph
        orig = self._orig = GL.GoalGraph.launch
        windows = self.windows

        def timed_launch(graph, stream):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            orig(graph, stream)
            end.record(stream)
            windows.append((start, end))

        GL.GoalGraph.launch = timed_launch
        return self

    def __exit__(self, *exc) -> None:
        self._cls.launch = self._orig

    def seconds(self, first: int = 0) -> float:
        """The device seconds of the windows from ``first`` on."""
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.windows[first:]) / 1e3

    def since(self, ref: torch.cuda.Event, first: int = 0) -> List[Interval]:
        """The windows from ``first`` on, in ms after ``ref``."""
        torch.cuda.synchronize()
        return [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in self.windows[first:]]


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


@dataclasses.dataclass
class Reading:
    """A traced pass: its length, the device's busy time, the graphs' share
    and the breakdown lists (``[name, seconds]``)."""

    window_s: float
    busy_s: float
    graph_s: float
    device_ops: List[list]
    idle_gaps: List[list]


def innermost(cpu: Sequence[Tuple[float, float, str]], starts: Sequence[float], t: float) -> str:
    """The host operation running at ``t`` that started last (the innermost);
    ``cpu`` sorted by start, ``starts`` its starts."""
    k = bisect.bisect_right(starts, t) - 1
    while k >= 0:
        a, b, name = cpu[k]
        if b >= t:
            return name
        k -= 1
    return "host (no traced operation)"


def analyse(window: Interval, graph_windows: Sequence[Interval],
            device: Sequence[Tuple[float, float, str]], cpu: Sequence[Tuple[float, float, str]]) -> Reading:
    """The reading of a pass from its intervals, all in seconds on one clock:
    the pass ``window``, the goal graphs' windows, the traced device
    operations and the traced host operations, each ``(start, end, name)``."""
    lo, hi = window
    graphs = merge(clip(graph_windows, lo, hi))
    busy = merge(graphs + clip([(a, b) for a, b, _ in device], lo, hi))
    busy_s = sum(b - a for a, b in busy)
    starts = [a for a, _ in graphs]
    outside: Dict[str, float] = {}
    for a, b, name in device:
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and a < graphs[k][1]:
            continue
        outside[name] = outside.get(name, 0.0) + (b - a)
    graph_s = sum(b - a for a, b in graphs)
    ops = [["goal graphs (CUDA-event windows)", graph_s]] + [
        [n[:120], s] for n, s in sorted(outside.items(), key=lambda kv: -kv[1])[: TOP - 1]
    ]
    cpu_sorted = sorted(cpu)
    cpu_starts = [a for a, _, _ in cpu_sorted]
    idle: Dict[str, float] = {}
    for a, b in gaps(busy, lo, hi):
        name = innermost(cpu_sorted, cpu_starts, (a + b) / 2)
        idle[name] = idle.get(name, 0.0) + (b - a)
    return Reading(
        window_s=hi - lo, busy_s=busy_s, graph_s=graph_s, device_ops=ops,
        idle_gaps=[[n[:120], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    )


class Profiled:
    """``torch.profiler`` over a block (the window's first pass), read into
    a :class:`Reading` with the :class:`GraphTimer`'s windows of the block."""

    def __init__(self, timer: GraphTimer) -> None:
        self.timer = timer
        self.reading: Optional[Reading] = None

    def __enter__(self) -> "Profiled":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._first = len(self.timer.windows)
        self._ref = torch.cuda.Event(enable_timing=True)
        self._ref.record()
        torch.cuda._sleep(1000)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        torch.cuda.synchronize()
        window_s = time.monotonic() - self._t0
        self._prof.__exit__(exc_type, *exc)
        if exc_type is not None:
            return
        from torch.autograd import DeviceType

        device, cpu, marker = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            a, b, name = e.start_ns() / 1e9, e.end_ns() / 1e9, e.name()
            if e.device_type() == DeviceType.CUDA:
                device.append((a, b, name))
                if MARKER in name and marker is None:
                    marker = a
            else:
                cpu.append((a, b, name))
        if marker is None:
            raise RuntimeError(f"the profiler traced no {MARKER}: the graph windows cannot be placed on its clock")
        graphs = [(marker + a / 1e3, marker + b / 1e3) for a, b in self.timer.since(self._ref, self._first)]
        self.reading = analyse((marker, marker + window_s), graphs, device, cpu)
