"""Flight recorder: structured traces of what the solver actually did.

Port of ``cruise_control_tpu/obs/recorder.py``.  Every ``optimize()``,
executor run, recovery and cluster-model build emits a :class:`TraceRecord`:
per-goal :class:`Span`\\ s with wall time, per-span host-sync counts,
violations before and after and moves, plus the kernel builds the operation
caused and the device it ran on.

Records land in an in-memory ring buffer and, when configured, an
append-only JSONL sink (``CC_TPU_FLIGHT_JSONL`` or
:meth:`FlightRecorder.configure`).  Counters and timers are registered in
the port's :class:`SensorRegistry` (``core/sensors.py``) under the
``FlightRecorder.*`` family.  The record format is the JAX package's: a
sink either package wrote reads back in the other.

Two things differ from the JAX recorder, because the port has no compiler
and no JAX runtime:

* the compile log holds one event per ``nvcc`` build of a kernel source
  (``ops/_build.py`` calls :func:`record_compile_event`) where the JAX one
  listens to ``jax.monitoring``; ``compile_mark`` / ``compile_events_since``
  window it the same way;
* the platform and device fields name the torch device the emitter ran on.

A span has a start and the spans inside it (:class:`SpanTree` times them as
the work runs), so a record is a tree and each span's self time is known; the
top-level spans stay the JAX package's.  A sink the port wrote reads back in
the JAX package without the starts and children.

The port's span ``dispatches`` and the ``num_dispatches`` attribute count
host syncs (the points where the host waits on the device), the port's
counterpart of the JAX dispatch count; per trace they sum to the emitter's
total as in the JAX package.  The recorder is host-side bookkeeping: nothing
here launches work on the device.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

#: bump when the JSONL record shape changes incompatibly
SCHEMA_VERSION = 1


@dataclasses.dataclass
class Span:
    """One timed unit of work inside a trace (a goal, a phase, a fetch), with
    the spans inside it.  ``start_s`` is the offset of its start from the
    trace's start on the host's monotonic clock (None where the emitter kept
    no start: records of other emitters and older sinks)."""

    name: str
    kind: str                 # "goal" | "setup" | "finalize" | "phase" | "step" | ...
    duration_s: float
    #: host syncs (the port's count where the JAX package counts dispatches)
    #: during this span, 0 for host-only spans; per trace the top-level spans'
    #: counts sum to the emitter's reported total
    dispatches: int = 0
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    start_s: Optional[float] = None
    #: the spans inside this one, in the order they started
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def self_s(self) -> float:
        """The duration less the children's (a span's children run one after
        another inside it)."""
        return self.duration_s - sum(c.duration_s for c in self.children)

    def to_dict(self) -> dict:
        """The JAX package's span fields, plus ``start_s`` and ``children``
        where the span has them (so a span without them reads the same in
        both packages)."""
        d = {
            "name": self.name, "kind": self.kind, "duration_s": self.duration_s,
            "dispatches": self.dispatches, "attrs": copy.deepcopy(self.attrs),
        }
        if self.start_s is not None:
            d["start_s"] = self.start_s
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(
            name=d["name"], kind=d["kind"], duration_s=d["duration_s"],
            dispatches=d.get("dispatches", 0), attrs=dict(d.get("attrs", {})),
            start_s=d.get("start_s"), children=[cls.from_dict(c) for c in d.get("children", [])],
        )


def _profiler_range(name: str):
    """A profiler range on the host alone.  ``torch.profiler.record_function``
    opens a user-scope range, which the profiler also draws on the device
    timeline over the kernels the range launched (``gpu_user_annotation``
    events of the CUDA type): a device trace would count a span as device
    time.  This range has the function scope of an operator, and stays on the
    host."""
    return torch._C._profiler._RecordFunctionFast(name)


class SpanTree:
    """The spans of one trace as its work runs.  :meth:`span` times a block
    as a child of the innermost span open around it; the trace's top-level
    spans are the children of :attr:`root`.  Starts count from ``t0``, the
    trace's start on the host's monotonic clock.

    While a ``torch.profiler`` session runs, and only then, each span is also
    a profiler range named ``cc/<parent kind>/<name>`` (``cc/goal/snapshot``),
    so a device trace names the host's time by the program's spans.  Without
    one a span costs two clock reads and a list append."""

    def __init__(self, kind: str = "trace", t0: Optional[float] = None) -> None:
        self.t0 = time.monotonic() if t0 is None else t0
        self.root = Span(kind, kind, 0.0, start_s=0.0)
        self._open = [self.root]

    @contextlib.contextmanager
    def span(self, name: str, kind: str = "step"):
        """Time the block as a new child of the open span; yields the child."""
        parent = self._open[-1]
        s = Span(name, kind, 0.0, start_s=time.monotonic() - self.t0)
        parent.children.append(s)
        self._open.append(s)
        rng = None
        if torch.autograd._profiler_enabled():
            rng = _profiler_range(f"cc/{parent.kind}/{name}")
            rng.__enter__()
        try:
            yield s
        finally:
            if rng is not None:
                rng.__exit__(None, None, None)
            s.duration_s = time.monotonic() - self.t0 - s.start_s
            self._open.pop()


@dataclasses.dataclass
class TraceRecord:
    """One recorded operation: an optimize, an execution, a detector cycle…"""

    kind: str                 # "optimize" | "execution" | "detector" | "model"
    trace_id: str
    started_at: float         # epoch seconds
    duration_s: float
    platform: str             # torch device type the operation ran on
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    spans: List[Span] = dataclasses.field(default_factory=list)
    #: kernel builds that ran during the operation
    #: ([{"event": name, "duration_s": secs}]); empty on a warm process
    compile_events: List[dict] = dataclasses.field(default_factory=list)
    #: correlation id linking this trace to the request/task that caused it —
    #: the inbound ``X-Request-Id`` (or the server-generated one) threaded
    #: through the user-task machinery; None for autonomous traces (detector
    #: cycles, background refreshes)
    parent_id: Optional[str] = None
    schema: int = SCHEMA_VERSION

    @property
    def total_dispatches(self) -> int:
        return sum(s.dispatches for s in self.spans)

    @property
    def compile_s(self) -> float:
        return sum(e.get("duration_s", 0.0) for e in self.compile_events)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["spans"] = [s.to_dict() for s in self.spans]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRecord":
        return cls(
            kind=d["kind"],
            trace_id=d["trace_id"],
            started_at=d["started_at"],
            duration_s=d["duration_s"],
            platform=d.get("platform", "unknown"),
            attrs=dict(d.get("attrs", {})),
            spans=[Span.from_dict(s) for s in d.get("spans", [])],
            compile_events=list(d.get("compile_events", [])),
            parent_id=d.get("parent_id"),
            schema=d.get("schema", SCHEMA_VERSION),
        )


# -- request-id propagation ---------------------------------------------------------
#
# The REST layer stamps every request with an id (inbound ``X-Request-Id`` or
# generated) and opens a :func:`parent_scope` around the work it triggers; any
# ``start_trace`` inside the scope inherits the id as ``parent_id``, so one id
# walks request → user task → optimize → execution in GET /TRACES.  A
# contextvar (not a thread-local): scopes are explicit tokens, and subsystems
# that hop threads (user-task pool, executor thread) re-open the scope in the
# worker with the id they captured at submission.

_PARENT_ID: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "cc_tpu_trace_parent_id", default=None
)


def current_parent_id() -> Optional[str]:
    """The request id in scope, if any (what new traces will inherit)."""
    return _PARENT_ID.get()


@contextlib.contextmanager
def parent_scope(parent_id: Optional[str]):
    """Attach ``parent_id`` to every trace started inside the with-block."""
    token = _PARENT_ID.set(parent_id)
    try:
        yield
    finally:
        _PARENT_ID.reset(token)


# -- kernel-build capture ------------------------------------------------------------
#
# One process-wide monotonic log of kernel builds.  Emitters snapshot an index
# before the operation (``compile_mark``) and collect the delta after
# (``compile_events_since``), so each trace carries exactly the builds it
# caused (single-threaded emitters; concurrent operations may cross-attribute,
# which is acceptable for a diagnostic record).

_COMPILE_LOG: List[dict] = []
#: total events trimmed off the front of the log -- marks are absolute event
#: counts, so outstanding tokens stay valid across trims
_COMPILE_BASE = 0
_COMPILE_LOCK = threading.Lock()
_COMPILE_LOG_CAP = 4096


def record_compile_event(event: str, duration_s: float, kind: Optional[str] = None) -> None:
    """Append one build event (``ops/_build.py`` calls this once per ``nvcc``;
    the device loop once per goal graph it captures, ``kind="capture"``)."""
    global _COMPILE_BASE
    entry = {"event": event, "duration_s": float(duration_s)}
    if kind is not None:
        entry["kind"] = kind
    with _COMPILE_LOCK:
        _COMPILE_LOG.append(entry)
        drop = len(_COMPILE_LOG) - _COMPILE_LOG_CAP
        if drop > 0:
            del _COMPILE_LOG[:drop]
            _COMPILE_BASE += drop


def compile_mark() -> int:
    """Absolute compile-event count; pair with :func:`compile_events_since`.
    Absolute (not a list index) so a token outlives ring trims."""
    with _COMPILE_LOCK:
        return _COMPILE_BASE + len(_COMPILE_LOG)


def compile_events_since(mark: int) -> List[dict]:
    with _COMPILE_LOCK:
        return list(_COMPILE_LOG[max(mark - _COMPILE_BASE, 0):])


# -- the recorder -------------------------------------------------------------------


def append_jsonl_capped(
    path: str, line: str, max_bytes: Optional[int]
) -> int:
    """Append ``line`` to a size-capped JSONL sink, rotating ``path`` →
    ``path + ".1"`` when the append would push it past ``max_bytes``
    (None/<=0 = unbounded).  Returns the number of rotations performed
    (0 or 1).

    Crash-safety: rotation is a single atomic ``os.replace`` — at every
    instant the active history lives under exactly one of the two names
    (``path`` before the replace, ``path + ".1"`` after it; the next append
    recreates ``path``), so a crash mid-rotation never loses the active
    file.  Raises OSError like a plain append would — callers that must not
    fail (the flight recorder) keep their own guard."""
    rotations = 0
    if max_bytes and max_bytes > 0:
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size > 0 and size + len(line) + 1 > max_bytes:
            os.replace(path, path + ".1")
            rotations = 1
    with open(path, "a") as f:
        f.write(line + "\n")
    return rotations


class FlightRecorder:
    """Ring buffer + optional JSONL sink for :class:`TraceRecord`\\ s."""

    def __init__(
        self,
        capacity: int = 256,
        jsonl_path: Optional[str] = None,
        jsonl_max_bytes: Optional[int] = None,
    ) -> None:
        self.capacity = capacity
        self.jsonl_path = jsonl_path
        self.jsonl_max_bytes = jsonl_max_bytes
        self._lock = threading.Lock()
        self._ring: List[TraceRecord] = []
        self._ids = itertools.count(1)
        self._dropped = 0
        self._rotations = 0

    def configure(
        self,
        jsonl_path: Optional[str],
        jsonl_max_bytes: Optional[int] = None,
    ) -> None:
        """Point (or disable, with None) the append-only JSONL sink.
        ``jsonl_max_bytes`` caps the active file; on overflow it rotates to
        ``<path>.1`` (one generation kept, like the reference's bounded
        operation logs)."""
        with self._lock:
            self.jsonl_path = jsonl_path
            if jsonl_max_bytes is not None:
                self.jsonl_max_bytes = jsonl_max_bytes

    def next_trace_id(self, kind: str) -> str:
        return f"{kind}-{next(self._ids)}-{os.getpid()}"

    def record(self, trace: TraceRecord) -> TraceRecord:
        """Append to the ring, the JSONL sink, and the sensor registry."""
        from cruise_control_tpu_torch.core.sensors import (
            FLIGHT_RING_GAUGE,
            FLIGHT_TRACES_COUNTER,
            REGISTRY,
        )

        with self._lock:
            self._ring.append(trace)
            trimmed = len(self._ring) - self.capacity
            if trimmed > 0:
                # a shrunk capacity (or bulk insertion) trims several records
                # at once — the drop counter must account for every one of
                # them, not just the trim event
                del self._ring[:trimmed]
                self._dropped += trimmed
            path = self.jsonl_path
            max_bytes = self.jsonl_max_bytes
            size = len(self._ring)
        if path:
            line = json.dumps(trace.to_dict(), default=str)
            try:
                rotated = append_jsonl_capped(path, line, max_bytes)
            except OSError:
                # a full/readonly disk must never take down the solver
                rotated = 0
            if rotated:
                with self._lock:
                    self._rotations += rotated
        REGISTRY.counter(FLIGHT_TRACES_COUNTER).inc()
        REGISTRY.gauge(FLIGHT_RING_GAUGE).set(size)
        REGISTRY.timer(f"FlightRecorder.{trace.kind}-duration").update(
            trace.duration_s
        )
        return trace

    def recent(
        self,
        limit: int = 50,
        kind: Optional[str] = None,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
    ) -> List[TraceRecord]:
        """Newest-first slice of the ring, optionally filtered by kind,
        exact trace id, or correlation ``parent_id`` (one request id walks
        request → user task → optimize → execution)."""
        with self._lock:
            items = list(reversed(self._ring))
        if kind is not None:
            items = [t for t in items if t.kind == kind]
        if trace_id is not None:
            items = [t for t in items if t.trace_id == trace_id]
        if parent_id is not None:
            items = [t for t in items if t.parent_id == parent_id]
        return items[: max(limit, 0)]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    def snapshot(self) -> dict:
        """Summary for the STATE sensor surface."""
        with self._lock:
            kinds: Dict[str, int] = {}
            for t in self._ring:
                kinds[t.kind] = kinds.get(t.kind, 0) + 1
            return {
                "size": len(self._ring),
                "capacity": self.capacity,
                "dropped": self._dropped,
                "by_kind": kinds,
                "jsonl_path": self.jsonl_path,
                "jsonl_max_bytes": self.jsonl_max_bytes,
                "jsonl_rotations": self._rotations,
            }


class JsonlRecords(List[TraceRecord]):
    """``read_jsonl``'s result: a plain record list plus the count of trailing
    lines skipped as corrupt/partial (0 for a clean sink)."""

    skipped: int = 0


def read_jsonl(path: str) -> JsonlRecords:
    """Load an append-only sink back into records (blank lines skipped),
    streaming — a long-lived server's sink can be large.

    A crash mid-append leaves a truncated (or garbled) line; that is data
    loss that already happened, not a reason to refuse the rest of the
    flight record — the valid PREFIX is returned and ``.skipped`` counts the
    non-blank lines abandoned from the first undecodable one onward.  Prefix
    (not skip-and-continue) semantics are deliberate: past a corruption
    point, later "valid-looking" lines may be interleaved fragments, and a
    diagnostic record must not resurrect them as facts."""
    out = JsonlRecords()
    corrupt = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if corrupt:
                out.skipped += 1
                continue
            try:
                out.append(TraceRecord.from_dict(json.loads(line)))
            except (json.JSONDecodeError, KeyError, TypeError):
                corrupt = True
                out.skipped += 1
    return out


def _platform(device=None) -> str:
    """The torch device type an emitter ran on; without one, the process's
    default: ``cuda`` where a GPU is present, else ``cpu``."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def mesh_metadata(device=None, mesh=None) -> dict:
    """Platform and device facts attached to solver traces: the JAX keys
    (``platform``, ``device_count``, ``process_count``), where a sharded
    solve's ``process_count`` is its rank mesh's world and ``backend`` names
    the backend that carries its collectives."""
    platform = _platform(device)
    out = {
        "platform": platform,
        "device_count": torch.cuda.device_count() if platform == "cuda" else 1,
        "process_count": 1,
    }
    if mesh is not None:
        out["process_count"] = mesh.world
        out["backend"] = mesh.backend
    return out


def start_trace(kind: str, parent_id: Optional[str] = None) -> dict:
    """Begin-of-operation token: id, wall-clock anchors, compile-log mark.
    ``parent_id`` defaults to the request id in scope (:func:`parent_scope`)."""
    return {
        "kind": kind,
        "trace_id": RECORDER.next_trace_id(kind),
        "started_at": time.time(),
        "t0": time.monotonic(),
        "compile_mark": compile_mark(),
        "parent_id": parent_id if parent_id is not None else _PARENT_ID.get(),
    }


def finish_trace(
    token: dict,
    attrs: Optional[dict] = None,
    spans: Optional[List[Span]] = None,
    device=None,
) -> Optional[TraceRecord]:
    """Close a :func:`start_trace` token and record it.  Never raises —
    observability must not break the operation it observes — so emitting
    call sites (optimizer, executor, monitor) need no guard.  ``device`` is
    where the operation ran (the process default when None).

    Trace boundaries double as the device-memory sampling points: the
    profiler's per-device gauges (peak/in-use) are refreshed here, host-side,
    so a long-lived server tracks its device-memory watermark without any
    polling thread or added device work."""
    try:
        from cruise_control_tpu_torch.obs.profiler import PROFILER

        PROFILER.sample_memory()
    except Exception:
        pass
    try:
        return RECORDER.record(
            TraceRecord(
                kind=token["kind"],
                trace_id=token["trace_id"],
                started_at=token["started_at"],
                duration_s=time.monotonic() - token["t0"],
                platform=_platform(device),
                attrs=attrs or {},
                spans=spans or [],
                compile_events=compile_events_since(token["compile_mark"]),
                parent_id=token.get("parent_id"),
            )
        )
    except Exception:
        return None


def _env_max_bytes() -> Optional[int]:
    try:
        return int(os.environ.get("CC_TPU_FLIGHT_JSONL_MAX_BYTES", "0")) or None
    except ValueError:
        return None


#: process-wide default recorder (the flight-data singleton every subsystem
#: emits into); CC_TPU_FLIGHT_JSONL points the persistent sink and
#: CC_TPU_FLIGHT_JSONL_MAX_BYTES caps it (rotating to <path>.1 on overflow)
RECORDER = FlightRecorder(
    jsonl_path=os.environ.get("CC_TPU_FLIGHT_JSONL"),
    jsonl_max_bytes=_env_max_bytes(),
)
