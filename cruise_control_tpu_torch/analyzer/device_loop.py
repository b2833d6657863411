"""The device driver of the solver's loops: a goal as one CUDA graph launch.

:func:`~cruise_control_tpu_torch.analyzer.optimizer.phase_body` is one round of
a phase.  Here each phase's round is captured once
(:class:`~cruise_control_tpu_torch.ops.graph_loop.CapturedRound`) against
static carry buffers (:class:`Slots`), and a goal's phases are nested in the
WHILE nodes of one :class:`~cruise_control_tpu_torch.ops.graph_loop.GoalGraph`:
the phase loop and the pass cycle run on the device, and the host waits once a
solve, when it fetches the rounds, moves and trip counts with the solve's other
scalars.  Every round runs the ops and kernels of the host driver's round in
the same order, so placements, counts and float sums are bitwise the same.

What lives where:

* **Slots**, one set a shape (the state's and the context's tensor shapes,
  the context's flags): a copy of every state and context tensor a round reads
  and the int32 ``ctl`` words of the loop's carry.  They are allocated outside
  the graphs' memory pool.  Before a launch the caller's tensors are copied in;
  after it the fields the rounds write are cloned out, so the caller never
  holds the slots, and the slots hold none of the caller's tensors.
* **Rounds and goal graphs**, cached by goal phases, prior set, admission set,
  snapshot needs, heavy goals, round cap, shapes and device.  One memory pool a
  device serves every capture: a captured round keeps no tensor alive, so
  every graph's scratch is free between launches and the next graph reuses it.
* **At most ``max_shapes`` shapes** (:data:`MAX_SHAPES`), least recently used
  first out: a controller whose cluster grows, a fleet of tenants of
  different shapes or a service answering for many clusters would otherwise
  keep a state copy and a set of graphs a shape on the card for good.  An
  evicted shape's goal graphs, captured rounds (their share of the pool and
  what they held) and slots are freed once the card has run the last launch.
* **Counted loops** (:meth:`DeviceLoops.run_counted`): a captured step run a
  fixed number of times in one WHILE node, the trace rollout's time axis
  (the JAX ``lax.scan``).  Each shape holds its step's static buffers; it is
  captured after one eager step, counts against ``max_shapes`` and is
  evicted as a solver shape is.
* **One registry a device** (:func:`device_loops`), not one an optimizer: the
  service builds a :class:`GoalOptimizer` per request, and a warm request must
  capture nothing.  Its lock serialises loads, launches and clone-outs across
  host threads (the detector, the anomaly handler and API requests solve at
  once), and each launch waits on the previous one's end event, so launches
  from threads on different streams never share the slots at once.

A capture runs one round eagerly first (its result is discarded): the
segment-sum scratch of the capture stream and any cached tensors are then
allocated outside the pool, and kernels are built.  Each goal graph built is a
flight-record compile event of kind ``capture`` (``capture/<goal>``), so a
capture on a warm tick shows as a warm compile event.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import types
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from cruise_control_tpu_torch.analyzer.context import GoalContext
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.ops import graph_loop as GL

#: the shapes a card's registry keeps captured (least recently used out first)
MAX_SHAPES = 8


def _ctx_tensors(ctx: GoalContext) -> Dict[str, torch.Tensor]:
    out = {f"c.{f.name}": getattr(ctx.constraint, f.name) for f in dataclasses.fields(ctx.constraint)}
    for f in dataclasses.fields(ctx):
        v = getattr(ctx, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
    return out


def _state_tensors(state: ClusterArrays) -> Dict[str, torch.Tensor]:
    return {
        f.name: getattr(state, f.name) for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
    }


def _scalars(obj, skip=()) -> tuple:
    return tuple(
        (f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)
        if f.name not in skip and not isinstance(getattr(obj, f.name), torch.Tensor)
    )


def shape_key(state: ClusterArrays, ctx: GoalContext) -> tuple:
    """What a captured round bakes in besides the data: every tensor's shape
    and dtype, the state's counts and the context's flags."""
    def shapes(d):
        return tuple((k, tuple(v.shape), v.dtype) for k, v in d.items())

    return (
        shapes(_state_tensors(state)), shapes(_ctx_tensors(ctx)),
        _scalars(state), _scalars(ctx, skip=("constraint",)),
    )


class Slots:
    """The static carry of the rounds captured at one shape: a state, a
    context and the ``ctl`` words (``ops.graph_loop``'s layout)."""

    def __init__(self, state: ClusterArrays, ctx: GoalContext) -> None:
        st = {k: torch.empty_like(v) for k, v in _state_tensors(state).items()}
        self.state = state.replace(**st)
        cx = {k: torch.empty_like(v) for k, v in _ctx_tensors(ctx).items()}
        constraint = dataclasses.replace(
            ctx.constraint, **{k[2:]: v for k, v in cx.items() if k.startswith("c.")}
        )
        self.ctx = ctx.replace(constraint=constraint, **{k: v for k, v in cx.items() if not k.startswith("c.")})
        self.ctl = torch.zeros(GL.TRIPS + GL.MAX_PHASES, dtype=torch.int32, device=state.device)
        self.ctl[GL.WINDOWS].fill_(1)
        #: the state fields a captured round writes (cloned out after a launch)
        self.written: set = set()
        self._dst = {**{k: getattr(self.state, k) for k in st}, **cx}

    def load(self, state: ClusterArrays, ctx: GoalContext) -> None:
        """Copy the caller's tensors in."""
        for k, v in {**_state_tensors(state), **_ctx_tensors(ctx)}.items():
            self._dst[k].copy_(v)

    def clone_out(self, state: ClusterArrays) -> ClusterArrays:
        """``state`` with the fields the rounds write taken from the slots (as
        copies)."""
        return state.replace(**{k: getattr(self.state, k).clone() for k in self.written})

    def carry(self):
        from cruise_control_tpu_torch.analyzer.optimizer import PhaseCarry

        c = self.ctl
        return PhaseCarry(self.state, c[GL.IT], c[GL.TOTAL], c[GL.STREAK], c[GL.WINDOWS])

    def store(self, out) -> None:
        """Write a round's carry back into the slots (inside the captured round)."""
        for k, v in _state_tensors(out.state).items():
            dst = getattr(self.state, k)
            if v is not dst:
                dst.copy_(v)
                self.written.add(k)
        self.ctl[:GL.ROUNDS].copy_(torch.stack([out.it, out.total, out.streak, out.windows]))


@dataclasses.dataclass
class GoalRun:
    """One launch of a goal graph: its rounds and moves (0-d device int32),
    its passes and each phase's trip count (``trips``, fetched with the
    solve's scalars) and the event recorded after it."""

    goal: GL.GoalGraph
    rounds: torch.Tensor
    moves: torch.Tensor
    trips: torch.Tensor
    done: torch.cuda.Event

    def account(self, trips: Sequence[float]) -> None:
        """``trips``: the fetched passes, control kernels run and phase trip counts."""
        self.goal.account(int(trips[0]), int(trips[1]), [int(t) for t in trips[2:]])


@dataclasses.dataclass
class CountedRun:
    """One launch of a counted loop: its ctl words after the launch
    (``trips``: the steps run and the control kernels, fetched with the
    caller's outputs) and the event recorded after it."""

    loop: GL.CountedLoop
    trips: torch.Tensor
    done: torch.cuda.Event

    def account(self, trips: Sequence[float]) -> None:
        self.loop.account(int(trips[GL.STEP]), int(trips[GL.COUNT_RUNS]))


@dataclasses.dataclass
class _Counted:
    """What the registry holds for one counted loop's shape: the static
    buffers its step reads and writes, its ctl words, the captured step and
    the loop's graph."""

    bufs: Dict[str, torch.Tensor]
    ctl: torch.Tensor
    step: Optional[GL.CapturedRound] = None
    loop: Optional[GL.CountedLoop] = None

    def destroy(self) -> None:
        if self.loop is not None:
            self.loop.destroy()
        if self.step is not None:
            self.step.destroy()
        self.loop = self.step = None


@dataclasses.dataclass
class _Shape:
    """What the registry holds for one shape: its slots, captured rounds and goal graphs."""

    slots: Slots
    rounds: Dict[tuple, GL.CapturedRound] = dataclasses.field(default_factory=dict)
    goals: Dict[tuple, GL.GoalGraph] = dataclasses.field(default_factory=dict)

    def destroy(self) -> None:
        for goal in self.goals.values():
            goal.destroy()
        for rnd in self.rounds.values():
            rnd.destroy()
        self.goals.clear()
        self.rounds.clear()


class DeviceLoops:
    """The captured rounds and goal graphs of one card, for at most
    ``max_shapes`` shapes (see the module note)."""

    def __init__(self, device: torch.device, max_shapes: int = MAX_SHAPES) -> None:
        if max_shapes < 1:
            raise ValueError(f"max_shapes must be at least 1, got {max_shapes}")
        self.device = device
        self.max_shapes = int(max_shapes)
        self.lock = threading.RLock()
        with torch.cuda.device(device):
            GL.cuda_versions()  # raises on a runtime or driver without conditional nodes
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)
        self._shapes: "collections.OrderedDict[tuple, _Shape]" = collections.OrderedDict()
        self._done = None
        #: captured rounds, goal graphs built, the host wall they took, and shapes evicted
        self.captures = 0
        self.goal_graphs = 0
        self.capture_s = 0.0
        self.evictions = 0

    def shapes(self) -> int:
        """The shapes held now."""
        return len(self._shapes)

    def pool_bytes(self) -> Optional[int]:
        """Bytes the graphs' memory pool holds on the card (None when the
        allocator's snapshot does not name pools)."""
        pool, total, named = tuple(self.pool), 0, False
        for seg in torch.cuda.memory_snapshot():
            if "segment_pool_id" in seg:
                named = True
                if tuple(seg["segment_pool_id"]) == pool:
                    total += int(seg["total_size"])
        return total if named else None

    def run(
        self, state: ClusterArrays, ctx: GoalContext, phases: Sequence[tuple], *, enable_heavy: bool,
        max_passes: int, max_rounds: int, name: str,
    ) -> Tuple[ClusterArrays, GoalRun]:
        """Launch one goal (``phases`` as ``(round_fn, prior_ids, admit_ids,
        needs)``) on the current stream: ``(state after, GoalRun)``."""
        with self._turn() as turn:
            slots, goal = self._prepare(state, ctx, phases, enable_heavy, max_passes, max_rounds, name)
            goal.launch(turn.stream)
            out = slots.clone_out(state)
            counts = slots.ctl[GL.ROUNDS:GL.TRIPS + len(phases)].clone()
        return out, GoalRun(goal, counts[0], counts[1], counts[GL.PASSES - GL.ROUNDS:], turn.done)

    def prepare(
        self, state: ClusterArrays, ctx: GoalContext, phases: Sequence[tuple], *, enable_heavy: bool,
        max_passes: int, max_rounds: int, name: str,
    ) -> None:
        """Capture a goal's graph now (the warm start); ``state`` is unchanged."""
        with self._turn():
            self._prepare(state, ctx, phases, enable_heavy, max_passes, max_rounds, name)

    def run_counted(
        self, key: tuple, inputs: Dict[str, torch.Tensor], outputs: Dict[str, Tuple[tuple, torch.dtype]],
        step: Callable[[Dict[str, torch.Tensor], torch.Tensor], None], trips: int, name: str,
    ) -> Tuple[Dict[str, torch.Tensor], CountedRun]:
        """``step(bufs, ctl)`` run ``trips`` times as ONE graph launch on the
        current stream, ``ctl[GL.STEP]`` the step's index: ``inputs`` are
        copied into the static buffers of this ``key`` (the step's shapes and
        every value it bakes in), ``outputs`` (name: (shape, dtype)) are
        buffers the steps write, cloned out after the launch.  The first run
        of a key captures the step after one eager step (a compile event of
        kind ``capture``, ``capture/<name>``); the key counts against
        ``max_shapes`` as a solver shape does."""
        with self._turn() as turn:
            entry = self._counted_entry(("counted", name) + tuple(key), inputs, outputs)

            def load():
                for k, v in inputs.items():
                    entry.bufs[k].copy_(v)

            load()
            if entry.loop is None:
                self._capture_counted(entry, step, trips, name)
                load()     # the eager step moved the carry
            entry.loop.launch(turn.stream)
            outs = {k: entry.bufs[k].clone() for k in outputs}
            counts = entry.ctl.clone()
        return outs, CountedRun(entry.loop, counts, turn.done)

    def _counted_entry(self, key: tuple, inputs, outputs) -> _Counted:
        entry = self._shapes.get(key)
        if entry is not None:
            self._shapes.move_to_end(key)
            return entry
        self._make_room()
        bufs = {k: torch.empty_like(v) for k, v in inputs.items()}
        bufs.update({k: torch.empty(shape, dtype=dtype, device=self.device) for k, (shape, dtype) in outputs.items()})
        entry = self._shapes[key] = _Counted(bufs, torch.zeros(2, dtype=torch.int32, device=self.device))
        return entry

    def _capture_counted(self, entry: _Counted, step, trips: int, name: str) -> None:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            entry.ctl.zero_()
            step(entry.bufs, entry.ctl)   # the eager step before capture
        entry.step = GL.CapturedRound(lambda: step(entry.bufs, entry.ctl), pool=self.pool, stream=self.stream)
        current.wait_stream(self.stream)
        entry.loop = GL.CountedLoop(entry.ctl, entry.step, trips)
        seconds = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += seconds
        from cruise_control_tpu_torch.obs.recorder import record_compile_event

        record_compile_event(f"capture/{name}", seconds, kind="capture")

    @contextmanager
    def _turn(self):
        """The lock, this card, and its current stream (``turn.stream``)
        after the previous turn's work; the turn's end event
        (``turn.done``) is recorded on leaving."""
        with self.lock, torch.cuda.device(self.device):
            turn = types.SimpleNamespace(stream=torch.cuda.current_stream(self.device), done=None)
            if self._done is not None:
                turn.stream.wait_event(self._done)
            yield turn
            turn.done = self._done = torch.cuda.Event()
            turn.done.record(turn.stream)

    def _prepare(self, state, ctx, phases, enable_heavy, max_passes, max_rounds, name):
        """Load the slots and find or build the goal graph (lock held)."""
        entry = self._entry(state, ctx)
        slots = entry.slots
        slots.load(state, ctx)
        round_keys = [(fn, prior, admit, needs, bool(enable_heavy)) for fn, prior, admit, needs in phases]
        key = (tuple(round_keys), int(max_passes), int(max_rounds))
        goal = entry.goals.get(key)
        if goal is None:
            t0 = time.perf_counter()
            rounds = [self._round(entry, rk) for rk in round_keys]
            goal = entry.goals[key] = GL.GoalGraph(slots.ctl, [(r, max_rounds) for r in rounds], max_passes)
            seconds = time.perf_counter() - t0
            self.goal_graphs += 1
            self.capture_s += seconds
            from cruise_control_tpu_torch.obs.recorder import record_compile_event

            record_compile_event(f"capture/{name}", seconds, kind="capture")
        return slots, goal

    def _entry(self, state: ClusterArrays, ctx: GoalContext) -> _Shape:
        """The registry's entry for this shape, now the most recently used;
        a new shape past ``max_shapes`` evicts the least recently used."""
        shape = shape_key(state, ctx)
        entry = self._shapes.get(shape)
        if entry is not None:
            self._shapes.move_to_end(shape)
            return entry
        self._make_room()
        entry = self._shapes[shape] = _Shape(Slots(state, ctx))
        return entry

    def _make_room(self) -> None:
        """Evict the least recently used shapes until a new one fits."""
        while len(self._shapes) >= self.max_shapes:
            if self._done is not None:
                self._done.synchronize()   # the evicted graphs' last launch has ended
            self._shapes.popitem(last=False)[1].destroy()
            self.evictions += 1

    def _round(self, entry: _Shape, key: tuple) -> GL.CapturedRound:
        rnd = entry.rounds.get(key)
        if rnd is not None:
            return rnd
        from cruise_control_tpu_torch.analyzer.optimizer import _np_mask, phase_body

        slots = entry.slots
        fn, prior, admit, needs, heavy = key
        kw = dict(round_fn=fn, enable_heavy=heavy, prior_mask=_np_mask(prior), admit_mask=_np_mask(admit), needs=needs)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            phase_body(slots.carry(), slots.ctx, **kw)   # the eager round before capture

        def body():
            slots.store(phase_body(slots.carry(), slots.ctx, **kw))

        rnd = entry.rounds[key] = GL.CapturedRound(body, pool=self.pool, stream=self.stream)
        current.wait_stream(self.stream)
        self.captures += 1
        return rnd


_REGISTRY: Dict[torch.device, DeviceLoops] = {}
_REGISTRY_LOCK = threading.Lock()


def device_loops(device) -> DeviceLoops:
    """The device loop registry of one card (created on first use)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _REGISTRY_LOCK:
        loops = _REGISTRY.get(device)
        if loops is None:
            loops = _REGISTRY[device] = DeviceLoops(device)
        return loops

