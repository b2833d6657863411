"""Controller replay: a trace-synthesized metric stream on a fake clock.

Port of ``cruise_control_tpu/traces/replay.py``: the same harness on the
port's fake backend, monitor, executor, facade and controller.  The
controller and the facade solve on ``device`` (``cuda`` unless
``device="cpu"``); everything else runs on the host.  A tick's
``num_dispatches`` is the port's host-sync count, and its compile events
are ``nvcc`` builds.

The rollout (traces/rollout.py) evaluates what a *policy* would do to a
hypothetical cluster; the replay closes the loop on the real thing: it drives
a :class:`~cruise_control_tpu_torch.traces.trace.LoadTrace` through the monitor's
window-listener seam against a live :class:`~cruise_control_tpu_torch.controller
.loop.ContinuousController` — real aggregator windows, real drift probes,
real bounded solves, real standing-set publishes — with every clock the loop
reads replaced by a shared :class:`FakeClock`.  No thread, no sleeping: each
trace step sets backend loads from the step's factors, feeds two metric
windows (the second closes the first — the aggregator only trusts STABLE
windows), advances the fake clock by a fixed quantum and calls
``maybe_tick()`` synchronously.  Reaction latency is therefore *exact*: a
publish whose evidence landed j steps earlier reports precisely j quanta, and
the drift-storm tests assert reaction and churn as equalities, not bounds.

The synthesized workload concentrates each topic on ``RF`` brokers (topic t →
brokers t, t+1 mod B), so a ``topic_spike`` segment overloads a specific
broker pair past the disk-capacity threshold — a violation rebalancing can
actually fix (a uniform global factor would be either harmless or
unsatisfiable at any placement, and the controller would be right to hold
position).  A drift storm alternating spikes across topics must produce at
most one publish per phase: re-publishing within a phase means the controller
is thrashing on its own answer.

Every replay emits a ``kind="replay"`` flight record; the per-step
``controller_tick`` traces nest under it via the recorder's parent scope, so
dispatch and compile accounting for the whole replay is exact from the
flight record alone.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.backend.fake import FakeClusterBackend
from cruise_control_tpu_torch.controller.loop import (
    ContinuousController,
    ControllerConfig,
)
from cruise_control_tpu_torch.core.device import DeviceLike
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.executor import Executor
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.monitor import LoadMonitor
from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver
from cruise_control_tpu_torch.monitor.samples import BackendMetricSampler
from cruise_control_tpu_torch.traces.trace import LoadTrace

#: pinned replay workload (mirrors controller/bench.py's scale; topic-subset
#: placement is the difference that makes spikes rebalance-fixable)
BROKERS = 6
RACKS = 2
NUM_TOPICS = 4
PARTS_PER_TOPIC = 6
RF = 2
WINDOW_MS = 60_000
NUM_WINDOWS = 4
GOALS = (G.RACK_AWARE, G.REPLICA_CAPACITY, G.DISK_CAPACITY, G.DISK_USAGE_DIST)

BASE_LOAD = [0.2, 50.0, 50.0, 10.0]        # [CPU, NW_IN, NW_OUT, DISK]
CAPACITY = {
    Resource.CPU: 100.0,
    Resource.NW_IN: 1e6,
    Resource.NW_OUT: 1e6,
    # sized so one ~×20 topic spike pushes its broker pair past the
    # disk-capacity threshold while the cluster-wide total stays placeable
    Resource.DISK: 1e3,
}

#: fake-clock seconds advanced between a step's ingest and its tick — the
#: unit every reaction_s is an exact multiple of
TICK_QUANTUM_S = 1.0


class FakeClock:
    """A monotonic clock that moves only when told to."""

    def __init__(self, start: float = 1_000.0) -> None:
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError("FakeClock cannot run backwards")
        self.now += float(seconds)
        return self.now


@dataclasses.dataclass
class StepOutcome:
    """One trace step as the controller experienced it."""

    step: int
    global_factor: float
    topic_factors: List[float]
    published: bool
    version: int
    num_proposals: int
    reaction_s: Optional[float]
    trigger: Optional[str]
    num_dispatches: int
    compile_events: int


@dataclasses.dataclass
class ReplayReport:
    """Outcome of one replay run."""

    trace: str
    steps: int
    windows_fed: int
    #: standing-set publishes (= version bumps; the churn signal)
    published: int
    final_version: int
    reactions: List[float]
    #: worst evidence→publish latency, in fake-clock seconds
    max_reaction_s: float
    total_dispatches: int
    #: kernel builds attributed to ticks AFTER the first publish (warm ticks
    #: must not build; the first solve may still be paying cold starts)
    warm_compile_events: int
    duration_s: float
    outcomes: List[StepOutcome] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "replay": {
                "trace": self.trace,
                "steps": self.steps,
                "windowsFed": self.windows_fed,
                "published": self.published,
                "finalVersion": self.final_version,
                "maxReactionS": self.max_reaction_s,
                "reactions": self.reactions,
                "totalDispatches": self.total_dispatches,
                "warmCompileEvents": self.warm_compile_events,
                "durationS": round(self.duration_s, 4),
            },
            "steps": [dataclasses.asdict(o) for o in self.outcomes],
        }


def build_replay_harness(
    clock: FakeClock,
    config: Optional[ControllerConfig] = None,
    num_topics: int = NUM_TOPICS,
    device: DeviceLike = None,
):
    """(backend, monitor, controller, now_ms) on the shared fake clock, with
    a warmed window ring and the topic-subset placement; the facade and the
    controller solve on ``device``."""
    backend = FakeClusterBackend()
    for b in range(BROKERS):
        backend.add_broker(b, rack=str(b % RACKS))
    for t in range(num_topics):
        for p in range(PARTS_PER_TOPIC):
            backend.create_partition(
                (f"T{t}", p),
                [(t + r) % BROKERS for r in range(RF)],
                load=list(BASE_LOAD),
            )
    monitor = LoadMonitor(
        backend,
        BackendMetricSampler(backend),
        StaticCapacityResolver(CAPACITY),
        num_windows=NUM_WINDOWS,
        window_ms=WINDOW_MS,
        clock=clock,
    )
    cc = CruiseControl(
        backend,
        monitor,
        Executor(backend),
        goal_ids=GOALS,
        hard_ids=tuple(g for g in GOALS if g in G.HARD_GOALS),
        device=device,
    )
    controller = ContinuousController(
        cc,
        config=config
        or ControllerConfig(
            tick_interval_s=3_600.0,   # cadence off: drift is the trigger
            drift_threshold=1.0,
        ),
        clock=clock,
        device=device,
    )
    monitor.add_window_listener(controller.on_window_delta)
    # window-aligned logical sample time (independent of the fake clock,
    # which only feeds monotonic anchors)
    now = int(time.time() * 1000)
    now -= now % WINDOW_MS
    for w in range(NUM_WINDOWS + 2):
        monitor.sample_once(now_ms=now + w * WINDOW_MS)
    return backend, monitor, controller, now + (NUM_WINDOWS + 2) * WINDOW_MS


def run_replay(
    trace: LoadTrace,
    config: Optional[ControllerConfig] = None,
    num_topics: int = NUM_TOPICS,
    warm: bool = True,
    device: DeviceLike = None,
) -> ReplayReport:
    """Drive ``trace`` through the listener seam; one ``maybe_tick`` per step.

    Per step: backend loads ← BASE_LOAD × global × topic factor, two
    windows fed (the second closes the first), the fake clock advances
    ``TICK_QUANTUM_S``, then the controller decides.  Everything the
    controller does — drift probes, solves, publishes, skips — is its own
    production code path; the replay only owns time and load.  Solves run
    on ``device`` (``cuda`` unless ``device="cpu"``)."""
    from cruise_control_tpu_torch.core.sensors import (
        REGISTRY,
        TRACE_REPLAYS_COUNTER,
        TRACE_REPLAY_STEPS_COUNTER,
    )
    from cruise_control_tpu_torch.obs import recorder as obs

    arrays = trace.materialize(num_topics)
    clock = FakeClock()
    backend, monitor, controller, now_ms = build_replay_harness(
        clock, config=config, num_topics=num_topics, device=device
    )
    t0 = time.monotonic()
    token = obs.start_trace("replay")
    if warm:
        controller.warm_start()

    outcomes: List[StepOutcome] = []
    reactions: List[float] = []
    windows_fed = 0
    total_dispatches = 0
    warm_compiles = 0
    published = 0
    partitions: Dict[int, list] = {
        t: [(f"T{t}", p) for p in range(PARTS_PER_TOPIC)]
        for t in range(num_topics)
    }
    with obs.parent_scope(token["trace_id"]):
        for k in range(arrays.num_steps):
            gfac = float(arrays.global_factor[k])
            tfac = [float(x) for x in arrays.topic_factor[k]]
            for t, tps in partitions.items():
                load = [x * gfac * tfac[t] for x in BASE_LOAD]
                for tp in tps:
                    backend.set_partition_load(tp, load)
            # two windows: the shifted samples land in window w; the second
            # sample opens w+1 so w turns STABLE and the delta fires
            now_ms += WINDOW_MS
            monitor.sample_once(now_ms=now_ms)
            now_ms += WINDOW_MS
            monitor.sample_once(now_ms=now_ms)
            windows_fed += 2
            clock.advance(TICK_QUANTUM_S)
            standing = controller.maybe_tick()

            tick = next(iter(obs.RECORDER.recent(1, kind="controller_tick")), None)
            n_disp = 0
            n_comp = 0
            if tick is not None and not tick.attrs.get("skipped", True):
                n_disp = int(tick.attrs.get("num_dispatches", 0))
                n_comp = len(tick.compile_events)
                total_dispatches += n_disp
                if published > 0:
                    warm_compiles += n_comp
            if standing is not None:
                published += 1
                if standing.reaction_s is not None:
                    reactions.append(float(standing.reaction_s))
            outcomes.append(
                StepOutcome(
                    step=k,
                    global_factor=gfac,
                    topic_factors=tfac,
                    published=standing is not None,
                    version=controller._version,
                    num_proposals=(
                        len(standing.proposals) if standing is not None else 0
                    ),
                    reaction_s=(
                        float(standing.reaction_s)
                        if standing is not None and standing.reaction_s is not None
                        else None
                    ),
                    trigger=(standing.trigger if standing is not None else None),
                    num_dispatches=n_disp,
                    compile_events=n_comp,
                )
            )

    report = ReplayReport(
        trace=trace.name or "trace",
        steps=arrays.num_steps,
        windows_fed=windows_fed,
        published=published,
        final_version=controller._version,
        reactions=reactions,
        max_reaction_s=max(reactions) if reactions else 0.0,
        total_dispatches=total_dispatches,
        warm_compile_events=warm_compiles,
        duration_s=time.monotonic() - t0,
        outcomes=outcomes,
    )
    REGISTRY.counter(TRACE_REPLAYS_COUNTER).inc()
    REGISTRY.counter(TRACE_REPLAY_STEPS_COUNTER).inc(report.steps)
    obs.finish_trace(
        token,
        device=controller.device,
        attrs={
            "trace": report.trace,
            "steps": report.steps,
            "windows_fed": windows_fed,
            "published": published,
            "final_version": report.final_version,
            "max_reaction_s": report.max_reaction_s,
            "num_dispatches": total_dispatches,
            "warm_compile_events": warm_compiles,
        },
    )
    return report
