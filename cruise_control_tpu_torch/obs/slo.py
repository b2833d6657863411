"""SLO burn-rate engine: declarative objectives over the self-monitoring plane.

Port of ``cruise_control_tpu/obs/slo.py`` (pure Python, copied whole; the shipped objectives are the JAX package's).

The reference aggregates *cluster* metrics into windows and alerts on them;
nothing watches the controller itself.  This module closes that loop for our
reproduction: each :class:`SloSpec` names a self-monitoring series
(``obs/selfmon.py``), an objective on its value, and an error budget — the
allowed fraction of bad samples.  Evaluation follows the multi-window
burn-rate recipe (Google SRE Workbook ch. 5, the same shape as arxiv
2402.06085's SLO-target layer): an alert fires only when the burn rate —
``bad_fraction / budget`` — exceeds the pair's threshold over BOTH a long
window (sustained damage) and a short window (still happening now), so a
recovered incident stops paging immediately and a slow leak still trips the
slow pair.

Shipped pairs mirror the canonical page/ticket split:

* ``fast`` — long 1 h / short 5 m, threshold 14.4 (2% of a 30-day budget in
  one hour): page-worthy burn.
* ``slow`` — long 3 d / short 6 h, threshold 1.0: ticket-worthy leak.

Window lengths are configuration, not constants — the bench/gate tier runs
the same engine with second-scale windows so an induced burn trips in ≤ 2
sampling periods.

Alert state is exported three ways: first-class Prometheus families
(``obs/exporter.py`` ``cruise_control_tpu_slo_*``), the ``SLO`` REST endpoint
/ ``STATE`` SelfMonitor block, and the :class:`SelfMetricAnomalyFinder`
(``detector/detectors.py``) which turns a firing alert into an ``Anomaly``
with a bounded self-heal.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from cruise_control_tpu_torch.core.sensors import (
    REGISTRY,
    SLO_ALERTS_FIRING_GAUGE,
    SLO_EVALUATIONS_COUNTER,
)


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative objective over a self-monitoring series."""

    name: str                 # e.g. "reaction-latency-p99"
    series: str               # selfmon series the objective is evaluated on
    objective: float          # bound on the sampled value
    #: "le": a sample is good when value <= objective; "ge": when >= objective
    comparison: str = "le"
    #: error budget — the allowed bad-sample fraction (burn 1.0 = spending
    #: exactly the budget)
    budget: float = 0.01
    description: str = ""

    def is_good(self, value: float) -> bool:
        if self.comparison == "ge":
            return value >= self.objective
        return value <= self.objective

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class WindowPair:
    """A long/short burn-rate window pair with its firing threshold."""

    name: str                 # "fast" | "slow"
    long_s: float
    short_s: float
    threshold: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: the canonical page/ticket pairs (SRE Workbook table 5-2, 1% budget scale)
DEFAULT_PAIRS = (
    WindowPair("fast", long_s=3600.0, short_s=300.0, threshold=14.4),
    WindowPair("slow", long_s=259_200.0, short_s=21_600.0, threshold=1.0),
)


@dataclasses.dataclass
class SloAlert:
    """Alert state of one (spec, window pair) at the last evaluation."""

    slo: str
    pair: str
    firing: bool
    burn_long: Optional[float]
    burn_short: Optional[float]
    threshold: float
    #: first evaluation timestamp of the current firing streak (None when ok)
    since_ms: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _burn(spec: SloSpec, samples: Sequence[float]) -> Optional[float]:
    """bad_fraction / budget over the window's samples; None = no data."""
    if not samples:
        return None
    bad = sum(1 for v in samples if not spec.is_good(v))
    return (bad / len(samples)) / max(spec.budget, 1e-9)


class SloEngine:
    """Evaluates every spec's burn rates against a selfmon series source.

    ``source`` needs two methods (duck-typed; :class:`obs.selfmon.SelfMonitor`
    provides both): ``window_values(series, window_s, now_ms)`` → the sampled
    values inside the trailing window, and ``latest(series)`` → the most
    recent sample (or None).
    """

    def __init__(
        self,
        specs: Sequence[SloSpec],
        source,
        pairs: Sequence[WindowPair] = DEFAULT_PAIRS,
        now_ms: Optional[Callable[[], int]] = None,
    ) -> None:
        self.specs = list(specs)
        self.source = source
        self.pairs = list(pairs)
        self._now_ms = now_ms or (lambda: int(time.time() * 1000))
        self._lock = threading.Lock()
        #: (slo, pair) -> SloAlert from the last evaluation
        self._alerts: Dict[tuple, SloAlert] = {}
        self._last_eval_ms: Optional[int] = None
        self.evaluations = 0

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now_ms: Optional[int] = None) -> List[dict]:
        """One evaluation pass: per-spec status blocks, alert transitions."""
        now = self._now_ms() if now_ms is None else now_ms
        statuses: List[dict] = []
        with self._lock:
            for spec in self.specs:
                latest = self.source.latest(spec.series)
                st = {
                    "slo": spec.name,
                    "series": spec.series,
                    "objective": spec.objective,
                    "comparison": spec.comparison,
                    "budget": spec.budget,
                    "value": latest,
                    "ok": spec.is_good(latest) if latest is not None else None,
                    "alerts": [],
                }
                for pair in self.pairs:
                    long_vals = self.source.window_values(
                        spec.series, pair.long_s, now_ms=now
                    )
                    short_vals = self.source.window_values(
                        spec.series, pair.short_s, now_ms=now
                    )
                    burn_long = _burn(spec, long_vals)
                    burn_short = _burn(spec, short_vals)
                    firing = (
                        burn_long is not None
                        and burn_short is not None
                        and burn_long >= pair.threshold
                        and burn_short >= pair.threshold
                    )
                    key = (spec.name, pair.name)
                    prev = self._alerts.get(key)
                    since = prev.since_ms if (prev and prev.firing) else None
                    alert = SloAlert(
                        slo=spec.name,
                        pair=pair.name,
                        firing=firing,
                        burn_long=burn_long,
                        burn_short=burn_short,
                        threshold=pair.threshold,
                        since_ms=(since if since is not None else now)
                        if firing
                        else None,
                    )
                    self._alerts[key] = alert
                    d = alert.to_dict()
                    d["samples_long"] = len(long_vals)
                    d["samples_short"] = len(short_vals)
                    st["alerts"].append(d)
                statuses.append(st)
            self._last_eval_ms = now
            self.evaluations += 1
            firing_now = sum(1 for a in self._alerts.values() if a.firing)
        REGISTRY.counter(SLO_EVALUATIONS_COUNTER).inc()
        REGISTRY.gauge(SLO_ALERTS_FIRING_GAUGE).set(firing_now)
        return statuses

    def firing(self) -> List[SloAlert]:
        """Alerts firing as of the last :meth:`evaluate` pass."""
        with self._lock:
            return [a for a in self._alerts.values() if a.firing]

    # -- export surfaces -----------------------------------------------------

    def status(self) -> dict:
        """The ``SLO`` endpoint / ``STATE`` SelfMonitor block payload."""
        with self._lock:
            alerts = [a.to_dict() for a in self._alerts.values()]
            last_eval = self._last_eval_ms
            evaluations = self.evaluations
        return {
            "enabled": True,
            "specs": [s.to_dict() for s in self.specs],
            "pairs": [p.to_dict() for p in self.pairs],
            "alerts": alerts,
            "firing": sum(1 for a in alerts if a["firing"]),
            "evaluations": evaluations,
            "lastEvalMs": last_eval,
        }


def build_pairs(get: Callable[[str], object]) -> List[WindowPair]:
    """The fast/slow pairs from config (``slo.*.window.s`` keys)."""
    return [
        WindowPair(
            "fast",
            long_s=float(get("slo.fast.long.window.s")),
            short_s=float(get("slo.fast.short.window.s")),
            threshold=float(get("slo.fast.burn.threshold")),
        ),
        WindowPair(
            "slow",
            long_s=float(get("slo.slow.long.window.s")),
            short_s=float(get("slo.slow.short.window.s")),
            threshold=float(get("slo.slow.burn.threshold")),
        ),
    ]


def shipped_specs(get: Callable[[str], object]) -> List[SloSpec]:
    """The shipped objective set (documented in ``docs/SLOS.md``), bound to
    config thresholds.  ``get`` is ``Config.get`` — any callable answering
    the ``slo.*`` keys works (the bench passes a dict's ``.get``)."""
    budget = float(get("slo.burn.budget"))
    return [
        SloSpec(
            name="reaction-latency-p99",
            series="Controller.reaction-latency-timer.p99_s",
            objective=float(get("slo.reaction.p99.objective.s")),
            budget=budget,
            description="load-shift → corrective standing set, p99 seconds",
        ),
        SloSpec(
            name="shed-ratio",
            series="derived.Admission.shed-ratio",
            objective=float(get("slo.shed.ratio.objective")),
            budget=budget,
            description="sheds / (sheds + admitted) per sampling period",
        ),
        SloSpec(
            name="degraded-ratio",
            series="derived.GoalOptimizer.degraded-ratio",
            objective=float(get("slo.degraded.ratio.objective")),
            budget=budget,
            description=("deadline-expired (degraded=true) optimizes per "
                         "optimize, per sampling period"),
        ),
        SloSpec(
            name="warm-tick-dispatches",
            series="flight.controller_tick.dispatches",
            objective=float(get("slo.dispatch.budget")),
            budget=budget,
            description=("host syncs (the port's count of dispatches) of the "
                         "last warm controller tick"),
        ),
        SloSpec(
            name="warm-recompiles",
            series="flight.compile-events.delta",
            objective=float(get("slo.recompile.objective")),
            budget=budget,
            description="compile events (kernel builds) between samples "
                        "(warm steady state must stay at 0)",
        ),
        SloSpec(
            name="replication-staleness",
            series="Replication.follower-staleness-ms",
            objective=float(get("slo.replication.staleness.objective.ms")),
            budget=budget,
            description=("follower staleness ms — the live proxy for delta-"
                         "propagation p95 (bench_serving --replication "
                         "measures the cross-process number)"),
        ),
    ]


#: process-global engine hook: the app registers its engine here so the
#: exporter (and anything else scraping-side) can render alert state without
#: plumbing a handle through every call site; None = no SLO plane configured
GLOBAL_ENGINE: Optional[SloEngine] = None


def set_global_engine(engine: Optional[SloEngine]) -> None:
    global GLOBAL_ENGINE
    GLOBAL_ENGINE = engine
