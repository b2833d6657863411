"""Device-resident while loops: captured rounds nested in CUDA graph WHILE nodes.

The JAX package compiles each phase of a goal into one ``lax.while_loop`` and
each goal, with its pass cycle, into one dispatch
(``cruise_control_tpu/analyzer/optimizer.py``).  Eager PyTorch would drive the
same loops from the host, one wait a round.  On the card this module gives the
port the JAX layout: a round is captured once with PyTorch
(``torch.cuda.CUDAGraph(keep_graph=True)``), and ``csrc/graph_loop.cu`` nests
the captured rounds in conditional WHILE nodes with one-thread kernels that
evaluate the loop conditions on the device (its note gives the layout).  A goal
is then one graph launch, and the host reads the rounds and moves with the rest
of the solve's scalars in one fetch.  The trace rollout's time axis, a
``lax.scan`` in the JAX package, is a :class:`CountedLoop`: one captured step
run a fixed number of times in one WHILE node.

Counting.  A kernel wrapper called while a round is being captured enqueues
nothing that runs: :func:`recording` is set, and the wrapper adds a closure to
it instead of bumping its launch counter and the census.  :meth:`Recording.account`
later adds each closure's call times the round's trip count, fetched from the
device, so ``LAUNCHES`` and the census stay the count of kernel calls the
device ran, with no host wall for a replay.

CPU tensors never come here: the CPU solve and rollout keep their host loops.  A card whose
runtime or driver is older than CUDA 12.3 (no conditional nodes) raises,
naming both versions.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from cruise_control_tpu_torch.ops import _build

#: since :func:`reset_launch_counts`: goal graphs launched (host calls), the
#: control kernels they ran (counted on the device by the kernels themselves)
#: and the work nodes of their rounds (kernels, memsets, copies), derived as
#: each captured round's nodes times its fetched trip count; and the control
#: kernels the graphs' layout implies (:func:`control_kernels`), which must
#: equal the device's count.  The ``count_*`` and ``step_nodes`` keys count
#: the same of the counted loops (:class:`CountedLoop`)
LAUNCHES = {"graph_loop": 0, "loop_ctl": 0, "round_nodes": 0, "loop_ctl_by_layout": 0,
            "count_loop": 0, "count_ctl": 0, "step_nodes": 0, "count_ctl_by_layout": 0}
#: the ctl slots of ``csrc/graph_loop.cu`` (int32): the phase's carry, then the
#: goal's, the control kernels run, then each phase's trip count
IT, TOTAL, STREAK, WINDOWS, ROUNDS, MOVES, PASS_MOVES, PASSES, CTL_RUNS, TRIPS = range(10)
#: a counted loop's ctl slots (int32): the step index, the control kernels run
STEP, COUNT_RUNS = range(2)
MAX_PHASES = 16
#: conditional graph nodes: CUDA 12.3, as 1000 * major + 10 * minor
MIN_CUDA_VERSION = 12030

_LIB = None
_TLS = threading.local()
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _pack(values) -> bytes:
    return struct.pack(f"{len(values)}q", *values)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("graph_loop")
        lib.cc_loop_versions.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        for fn in (lib.cc_loop_build, lib.cc_count_loop_build, lib.cc_graph_work_nodes):
            fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong)]
        for fn in (lib.cc_loop_launch, lib.cc_loop_destroy):
            fn.argtypes = [ctypes.c_char_p]
        for fn in (lib.cc_loop_versions, lib.cc_loop_build, lib.cc_count_loop_build, lib.cc_graph_work_nodes,
                   lib.cc_loop_launch, lib.cc_loop_destroy):
            fn.restype = ctypes.c_int
        out = (ctypes.c_longlong * 2)()
        err = lib.cc_loop_versions(out)
        if err != 0:
            raise RuntimeError(f"graph loop: reading the CUDA versions failed: CUDA error {err}")
        check_versions(int(out[0]), int(out[1]))
        _LIB = lib
    return _LIB


def _version(v: int) -> str:
    return f"{v // 1000}.{(v % 1000) // 10}"


def check_versions(runtime: int, driver: int) -> None:
    """Raise unless both the CUDA runtime and the driver have conditional
    graph nodes (CUDA 12.3); there is no host-loop fallback on the card."""
    if runtime < MIN_CUDA_VERSION or driver < MIN_CUDA_VERSION:
        raise RuntimeError(
            f"the device loop needs conditional CUDA graph nodes (CUDA {_version(MIN_CUDA_VERSION)}+); "
            f"this card has CUDA runtime {_version(runtime)} and driver {_version(driver)}"
        )


def cuda_versions() -> Tuple[int, int]:
    """(runtime, driver) CUDA versions as the loop's library sees them."""
    out = (ctypes.c_longlong * 2)()
    err = _library().cc_loop_versions(out)
    if err != 0:
        raise RuntimeError(f"graph loop: reading the CUDA versions failed: CUDA error {err}")
    return int(out[0]), int(out[1])


# -- counting calls made while capturing --------------------------------------------


class Recording:
    """The kernel calls one captured round makes: each an ``account(times)``
    closure that adds ``times`` calls to its wrapper's counters and census.
    ``keep`` holds the tensors the round reads that live outside the slots
    and the graphs' pool (a cache's entries, a kernel's scratch): a graph
    holds no reference of its own, and a freed tensor's memory would be
    handed to another while the graph still reads it."""

    def __init__(self) -> None:
        self.calls: List[Callable[[int], None]] = []
        self.keep: List[torch.Tensor] = []

    def account(self, times: int) -> None:
        if times:
            for fn in self.calls:
                fn(times)


def recording() -> Optional[Recording]:
    """The capture in progress on this thread, or None (wrappers count as usual)."""
    return getattr(_TLS, "recording", None)


def keep_alive(t: torch.Tensor) -> torch.Tensor:
    """``t``, held for the life of the round being captured, if any."""
    rec = recording()
    if rec is not None:
        rec.keep.append(t)
    return t


@contextmanager
def _recording(rec: Recording):
    prev = recording()
    _TLS.recording = rec
    try:
        yield rec
    finally:
        _TLS.recording = prev


# -- captured rounds and goal graphs ------------------------------------------------


class CapturedRound:
    """One round captured on ``stream`` into ``pool``: the PyTorch graph (kept
    alive: its memory stays reserved in the pool) and its kernel calls."""

    def __init__(self, fn: Callable[[], None], *, pool, stream: torch.cuda.Stream) -> None:
        self.recording = Recording()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(stream), _recording(self.recording):
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass
                raise
            self.graph.capture_end()
        out = (ctypes.c_longlong * 1)()
        err = _library().cc_graph_work_nodes(_pack((self.raw,)), out)
        if err != 0:
            raise RuntimeError(f"graph loop: counting a captured round's nodes failed: CUDA error {err}")
        #: the kernels, memsets and copies the device runs each round
        self.work_nodes = int(out[0])

    @property
    def raw(self) -> int:
        return self.graph.raw_cuda_graph()

    def destroy(self) -> None:
        """Free the graph, its share of the pool and what the round held
        (the caller has waited for every launch that ran it)."""
        self.graph.reset()
        self.recording.keep.clear()


class GoalGraph:
    """One goal's device program: its phases' captured rounds, each in a WHILE
    node, inside the pass cycle's WHILE node (``csrc/graph_loop.cu``).
    ``ctl`` is the int32 control buffer the rounds were captured against."""

    def __init__(self, ctl: torch.Tensor, phases: Sequence[Tuple[CapturedRound, int]], max_passes: int) -> None:
        if not 0 < len(phases) <= MAX_PHASES:
            raise ValueError(f"a goal graph takes 1 to {MAX_PHASES} phases, got {len(phases)}")
        if ctl.dtype != torch.int32 or ctl.numel() < TRIPS + len(phases) or ctl.device.type != "cuda":
            raise ValueError(f"the goal graph's ctl must be a CUDA int32 buffer of {TRIPS} + phases slots")
        self.ctl = ctl
        self.phases = list(phases)
        self.max_passes = int(max_passes)
        args = [ctl.data_ptr(), self.max_passes, len(phases)]
        for rnd, max_rounds in phases:
            args += [rnd.raw, int(max_rounds)]
        out = (ctypes.c_longlong * 2)()
        lib = _library()
        with torch.cuda.device(ctl.device):
            err = lib.cc_loop_build(_pack(args), out)
        if err != 0:
            raise RuntimeError(f"graph loop: building the goal graph failed: CUDA error {err}")
        self._handles = (int(out[0]), int(out[1]))

    def launch(self, stream: torch.cuda.Stream) -> None:
        """Enqueue the goal on ``stream``; no host wait."""
        err = _library().cc_loop_launch(_pack((self._handles[1], stream.cuda_stream)))
        if err != 0:
            raise RuntimeError(f"graph loop: launching the goal graph failed: CUDA error {err}")
        with _COUNT_LOCK:
            LAUNCHES["graph_loop"] += 1

    def account(self, passes: int, ctl_runs: int, trips: Sequence[int]) -> None:
        """Add each phase's captured kernel calls times its fetched trip
        count, and ``ctl_runs``, the control kernels the launch ran as they
        counted themselves on the device."""
        for (rnd, _), n in zip(self.phases, trips):
            rnd.recording.account(int(n))
        with _COUNT_LOCK:
            LAUNCHES["loop_ctl"] += int(ctl_runs)
            LAUNCHES["loop_ctl_by_layout"] += control_kernels(passes, len(self.phases), trips)
            LAUNCHES["round_nodes"] += sum(rnd.work_nodes * int(n) for (rnd, _), n in zip(self.phases, trips))

    def destroy(self) -> None:
        """Free the graph and its executable (the caller has waited for its
        last launch)."""
        handles, self._handles = getattr(self, "_handles", None), None
        if handles is not None and _LIB is not None:
            _LIB.cc_loop_destroy(_pack(handles))

    __del__ = destroy


class CountedLoop:
    """A captured step run ``trips`` times in one WHILE node
    (``csrc/graph_loop.cu``'s counted loop, the counterpart of a
    ``lax.scan``): the step reads its index from ``ctl[STEP]``, which the
    control kernel zeroes before the loop and advances after each step."""

    def __init__(self, ctl: torch.Tensor, step: CapturedRound, trips: int) -> None:
        if ctl.dtype != torch.int32 or ctl.numel() < 2 or ctl.device.type != "cuda":
            raise ValueError("a counted loop's ctl must be a CUDA int32 buffer of 2 slots")
        self.ctl = ctl
        self.step = step
        self.trips = int(trips)
        out = (ctypes.c_longlong * 2)()
        with torch.cuda.device(ctl.device):
            err = _library().cc_count_loop_build(_pack((ctl.data_ptr(), self.trips, step.raw)), out)
        if err != 0:
            raise RuntimeError(f"graph loop: building the counted loop failed: CUDA error {err}")
        self._handles = (int(out[0]), int(out[1]))

    def launch(self, stream: torch.cuda.Stream) -> None:
        """Enqueue the ``trips`` steps on ``stream``; no host wait."""
        err = _library().cc_loop_launch(_pack((self._handles[1], stream.cuda_stream)))
        if err != 0:
            raise RuntimeError(f"graph loop: launching the counted loop failed: CUDA error {err}")
        with _COUNT_LOCK:
            LAUNCHES["count_loop"] += 1

    def account(self, steps: int, ctl_runs: int) -> None:
        """Add the step's captured kernel calls times ``steps`` (the fetched
        step index after the launch) and ``ctl_runs``, the control kernels
        the launch ran as they counted themselves on the device."""
        self.step.recording.account(int(steps))
        with _COUNT_LOCK:
            LAUNCHES["count_ctl"] += int(ctl_runs)
            LAUNCHES["count_ctl_by_layout"] += 1 + int(steps)
            LAUNCHES["step_nodes"] += self.step.work_nodes * int(steps)

    def destroy(self) -> None:
        """Free the graph and its executable (the caller has waited for its
        last launch)."""
        handles, self._handles = getattr(self, "_handles", None), None
        if handles is not None and _LIB is not None:
            _LIB.cc_loop_destroy(_pack(handles))

    __del__ = destroy


def control_kernels(passes: int, phases: int, trips: Sequence[int]) -> int:
    """The control kernels a goal graph's launch runs by its layout: one to
    start the goal, two a pass, two a phase a pass and one a round (a check
    of the trip counts against the kernels' own count, ``CTL_RUNS``)."""
    return 1 + passes * (2 + 2 * phases) + sum(int(n) for n in trips)
