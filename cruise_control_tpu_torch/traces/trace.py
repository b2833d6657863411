"""LoadTrace: declarative, seeded-deterministic load trajectories.

Port of ``cruise_control_tpu/traces/trace.py`` (numpy only, copied whole: the
same wire form materializes bit-equal factors in both packages).  A :class:`LoadTrace` composes :class:`TraceSegment`\\ s — diurnal sinusoid,
linear ramp, spike/decay, per-topic growth or spike, gaussian noise — into a
per-step global load factor ``f32[T]`` and per-topic factors ``f32[T, topics]``.
Segments are *data*: the trace has a JSON wire format (strict — unknown keys
are rejected, the same contract as ``sim/scenario.py``), and all randomness
flows from one ``numpy`` generator seeded by ``LoadTrace.seed``, so a trace is
reproducible from its wire form alone.

A trace step IS a scenario: :meth:`LoadTrace.scenario_at` maps step ``t`` to a
:class:`~cruise_control_tpu_torch.sim.scenario.Scenario` whose ``load_factor`` /
``topic_load_factors`` are the step's (float32-exact) factors — so the rollout
engine, ``fast_sweep``, and the SIMULATE endpoint all agree bit-for-bit on
what a step means, and traces reuse ``apply_scenario`` + the power-of-two
broker bucket ladder instead of inventing a second cluster-mutation path.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.sim.scenario import Scenario, check_wire_keys

#: floor for the composed global factor — segments may interfere destructively
#: (deep ramp + off-peak sinusoid); a non-positive load factor is meaningless
MIN_FACTOR = 0.05

SEGMENT_KINDS = (
    "diurnal", "ramp", "spike", "topic_growth", "topic_spike", "noise",
)


@dataclasses.dataclass(frozen=True)
class TraceSegment:
    """One generator over a step range ``[start, start+steps)`` (steps=None
    runs to the end of the trace).  Global-factor kinds add; topic kinds
    multiply the topic's factor column.

    * ``diurnal`` — ``amplitude * sin(2π·k/period + phase)``
    * ``ramp`` — ``rate * k`` (linear growth per step)
    * ``spike`` — ``magnitude * decay**k`` (impulse at ``start``, exponential
      tail)
    * ``topic_growth`` — topic factor ``*= (1 + rate)**k`` (compounding)
    * ``topic_spike`` — topic factor ``*= magnitude`` over the whole range
    * ``noise`` — seeded gaussian, stddev ``sigma``
    """

    kind: str
    start: int = 0
    steps: Optional[int] = None
    amplitude: float = 0.0
    period: int = 24
    phase: float = 0.0
    rate: float = 0.0
    magnitude: float = 0.0
    decay: float = 0.5
    topic: int = -1
    sigma: float = 0.0

    def validate(self) -> None:
        if self.kind not in SEGMENT_KINDS:
            raise ValueError(
                f"segment kind {self.kind!r} not one of {SEGMENT_KINDS}"
            )
        if self.start < 0:
            raise ValueError(f"{self.kind}: start < 0")
        if self.steps is not None and self.steps <= 0:
            raise ValueError(f"{self.kind}: steps must be > 0")
        if self.kind == "diurnal" and self.period <= 0:
            raise ValueError("diurnal: period must be > 0")
        if self.kind == "spike" and not (0.0 <= self.decay <= 1.0):
            raise ValueError("spike: decay must be in [0, 1]")
        if self.kind in ("topic_growth", "topic_spike") and self.topic < 0:
            raise ValueError(f"{self.kind}: topic id required")
        if self.kind == "topic_spike" and self.magnitude <= 0:
            raise ValueError("topic_spike: magnitude must be > 0")
        if self.kind == "noise" and self.sigma < 0:
            raise ValueError("noise: sigma must be >= 0")

    _WIRE_KEYS = (
        "kind", "start", "steps", "amplitude", "period", "phase", "rate",
        "magnitude", "decay", "topic", "sigma",
    )

    def to_dict(self) -> dict:
        out = {"kind": self.kind, "start": self.start}
        if self.steps is not None:
            out["steps"] = self.steps
        defaults = TraceSegment(kind=self.kind)
        for key in self._WIRE_KEYS[3:]:
            v = getattr(self, key)
            if v != getattr(defaults, key):
                out[key] = v
        return out

    @classmethod
    def from_dict(cls, d: Mapping) -> "TraceSegment":
        check_wire_keys(d, cls._WIRE_KEYS, "trace segment")
        seg = cls(
            kind=str(d.get("kind", "")),
            start=int(d.get("start", 0)),
            steps=None if d.get("steps") is None else int(d["steps"]),
            amplitude=float(d.get("amplitude", 0.0)),
            period=int(d.get("period", 24)),
            phase=float(d.get("phase", 0.0)),
            rate=float(d.get("rate", 0.0)),
            magnitude=float(d.get("magnitude", 0.0)),
            decay=float(d.get("decay", 0.5)),
            topic=int(d.get("topic", -1)),
            sigma=float(d.get("sigma", 0.0)),
        )
        seg.validate()
        return seg


@dataclasses.dataclass(frozen=True)
class TraceArrays:
    """A materialized trace: the rollout kernel's input layout."""

    #: f32[T] global load factor per step
    global_factor: np.ndarray
    #: f32[T, topics] per-topic multiplier per step (on top of the global)
    topic_factor: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.global_factor.shape[0])


@dataclasses.dataclass(frozen=True)
class LoadTrace:
    """A declarative load trajectory (all fields optional but ``num_steps``)."""

    name: str = ""
    num_steps: int = 64
    #: wall seconds one step represents — the broker-hours unit
    step_s: float = 3600.0
    base_factor: float = 1.0
    seed: int = 0
    segments: Tuple[TraceSegment, ...] = ()

    def validate(self) -> None:
        if self.num_steps <= 0:
            raise ValueError(f"{self.name or 'trace'}: num_steps must be > 0")
        if self.step_s <= 0:
            raise ValueError(f"{self.name or 'trace'}: step_s must be > 0")
        if self.base_factor <= 0:
            raise ValueError(f"{self.name or 'trace'}: base_factor must be > 0")
        for seg in self.segments:
            seg.validate()
            if seg.kind in ("topic_growth", "topic_spike"):
                # topic range is checked against the base cluster at
                # materialize time; only self-consistency here
                pass

    # -- materialization -----------------------------------------------------

    def materialize(self, num_topics: int) -> TraceArrays:
        """Compose the segments into per-step factor arrays.

        Deterministic: one ``default_rng(seed)`` consumed in segment order —
        identical wire forms materialize identical arrays.  Factors are
        float32 (the dispatch dtype), so a step's scenario round-trips
        bit-exactly through the Scenario wire format."""
        self.validate()
        T = self.num_steps
        g = np.full(T, float(self.base_factor), np.float64)
        tf = np.ones((T, max(int(num_topics), 1)), np.float64)
        rng = np.random.default_rng(self.seed)
        t = np.arange(T, dtype=np.float64)
        for seg in self.segments:
            end = T if seg.steps is None else min(seg.start + seg.steps, T)
            if seg.start >= end:
                continue
            span = slice(seg.start, end)
            k = t[span] - seg.start
            if seg.kind == "diurnal":
                g[span] += seg.amplitude * np.sin(
                    2.0 * np.pi * k / seg.period + seg.phase
                )
            elif seg.kind == "ramp":
                g[span] += seg.rate * k
            elif seg.kind == "spike":
                g[span] += seg.magnitude * np.power(seg.decay, k)
            elif seg.kind == "noise":
                g[span] += rng.normal(0.0, seg.sigma, size=end - seg.start)
            elif seg.kind == "topic_growth":
                if seg.topic >= tf.shape[1]:
                    raise ValueError(
                        f"{self.name or 'trace'}: topic {seg.topic} out of "
                        f"range for {num_topics} topics"
                    )
                tf[span, seg.topic] *= np.power(1.0 + seg.rate, k)
            elif seg.kind == "topic_spike":
                if seg.topic >= tf.shape[1]:
                    raise ValueError(
                        f"{self.name or 'trace'}: topic {seg.topic} out of "
                        f"range for {num_topics} topics"
                    )
                tf[span, seg.topic] *= seg.magnitude
        g = np.maximum(g, MIN_FACTOR)
        return TraceArrays(
            global_factor=g.astype(np.float32),
            topic_factor=np.maximum(tf, MIN_FACTOR).astype(np.float32),
        )

    def scenario_at(
        self, arrays: TraceArrays, step: int, add_brokers: int = 0,
        remove_brokers: Tuple[int, ...] = (),
    ) -> Scenario:
        """Step ``t`` as a :class:`Scenario` — the composition seam with
        ``sim/``: ``apply_scenario(base, trace.scenario_at(arrays, t))`` is
        the exact cluster the rollout kernel evaluates at step ``t`` (the
        B=1 bit-equality contract of tests/test_traces.py)."""
        g = float(arrays.global_factor[step])
        tlf = tuple(
            (int(k), float(arrays.topic_factor[step, k]))
            for k in range(arrays.topic_factor.shape[1])
            if arrays.topic_factor[step, k] != np.float32(1.0)
        )
        return Scenario(
            name=f"{self.name or 'trace'}[{step}]",
            add_brokers=add_brokers,
            remove_brokers=remove_brokers,
            load_factor=g,
            topic_load_factors=tlf,
        )

    # -- wire format (REST TRACES body) --------------------------------------

    _WIRE_KEYS = (
        "name", "num_steps", "step_s", "base_factor", "seed", "segments",
    )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "num_steps": self.num_steps,
            "step_s": self.step_s,
            "base_factor": self.base_factor,
            "seed": self.seed,
            "segments": [s.to_dict() for s in self.segments],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "LoadTrace":
        check_wire_keys(d, cls._WIRE_KEYS, "trace")
        trace = cls(
            name=str(d.get("name", "")),
            num_steps=int(d.get("num_steps", 64)),
            step_s=float(d.get("step_s", 3600.0)),
            base_factor=float(d.get("base_factor", 1.0)),
            seed=int(d.get("seed", 0)),
            segments=tuple(
                TraceSegment.from_dict(s) for s in d.get("segments", ())
            ),
        )
        trace.validate()
        return trace


# -- canned generators --------------------------------------------------------


def diurnal_trace(
    name: str = "diurnal", num_steps: int = 96, amplitude: float = 0.4,
    period: int = 24, base_factor: float = 1.0, sigma: float = 0.0,
    seed: int = 0,
) -> LoadTrace:
    """Daily sinusoid (+ optional noise) — the bread-and-butter trajectory."""
    segs = [TraceSegment(kind="diurnal", amplitude=amplitude, period=period)]
    if sigma > 0:
        segs.append(TraceSegment(kind="noise", sigma=sigma))
    return LoadTrace(
        name=name, num_steps=num_steps, base_factor=base_factor, seed=seed,
        segments=tuple(segs),
    )


def ramp_trace(
    name: str = "ramp", num_steps: int = 64, rate: float = 0.02,
    base_factor: float = 1.0, seed: int = 0,
) -> LoadTrace:
    """Linear organic growth."""
    return LoadTrace(
        name=name, num_steps=num_steps, base_factor=base_factor, seed=seed,
        segments=(TraceSegment(kind="ramp", rate=rate),),
    )


def spike_trace(
    name: str = "spike", num_steps: int = 64, at: int = 16,
    magnitude: float = 1.5, decay: float = 0.7, base_factor: float = 1.0,
    seed: int = 0,
) -> LoadTrace:
    """Black-Friday impulse with an exponential cool-down."""
    return LoadTrace(
        name=name, num_steps=num_steps, base_factor=base_factor, seed=seed,
        segments=(
            TraceSegment(
                kind="spike", start=at, magnitude=magnitude, decay=decay
            ),
        ),
    )


def drift_storm_trace(
    name: str = "drift-storm", num_topics: int = 4, phases: int = 4,
    hold: int = 4, magnitude: float = 8.0, step_s: float = 60.0,
    seed: int = 0,
) -> LoadTrace:
    """Alternating per-topic hot spots: phase ``p`` spikes topic ``p % topics``
    for ``hold`` steps, then the heat moves on — the replay harness's no-thrash
    workload (each phase is new evidence; repeats within a phase are not)."""
    segs = tuple(
        TraceSegment(
            kind="topic_spike", start=p * hold, steps=hold,
            topic=p % max(num_topics, 1), magnitude=magnitude,
        )
        for p in range(phases)
    )
    return LoadTrace(
        name=name, num_steps=phases * hold, step_s=step_s, seed=seed,
        segments=segs,
    )


def traces_from_wire(specs: Sequence[Mapping]) -> Tuple[LoadTrace, ...]:
    """Parse a JSON list of trace dicts (the TRACES endpoint body)."""
    if not isinstance(specs, (list, tuple)):
        raise ValueError("traces must be a JSON list")
    return tuple(LoadTrace.from_dict(d) for d in specs)
