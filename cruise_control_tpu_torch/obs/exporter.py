"""Prometheus text exposition of the whole telemetry plane.

Port of ``cruise_control_tpu/obs/exporter.py``.  The metric names keep the
JAX package's ``PREFIX`` (``cruise_control_tpu``) and its HELP texts: they
are the scrape contract of ``docs/SLOS.md``, and for one registry, recorder,
profiler and SLO engine the page is the JAX exporter's text but for the
samples of ``cruise_control_tpu_gate_baseline``: the port's family carries
the port's own committed gate baseline (``obs/gate.py``) for the process's
device -- ``GATE_BASELINE_cuda.json`` where a card is present, else
``GATE_BASELINE_cpu.json`` -- under the JAX labels.  The
``executable_*`` families carry the hand-written kernels' census
(``obs/profiler.py``): reckoned operations and bytes of the kernels alone,
where the JAX families carry XLA's cost analysis of whole programs.

The reference exports every Dropwizard sensor through JMX (``Sensors.md``
families) and leaves scraping to jmx_exporter; here the export surface IS the
scrape target: :func:`render_prometheus` renders the process-wide
:class:`~cruise_control_tpu_torch.core.sensors.SensorRegistry` (timers with
p50/p95, gauges, counters, meters), the flight recorder's summary, the
readiness gauges, the SLO engine, and the device/executable profiler into
exposition format 0.0.4, the page a ``GET /METRICS`` serves.

Name mapping: dotted sensor families become labels, not metric names —
``GoalOptimizer.proposal-computation-timer`` renders as
``cruise_control_tpu_timer_seconds{family="GoalOptimizer",
sensor="proposal-computation-timer",stat="p95"}`` — so dashboards group by
``family`` exactly the way Sensors.md organizes the reference's JMX tree, and
the metric-name cardinality stays fixed no matter how many sensors register.

:func:`parse_exposition` is the strict round-trip check: the CI metrics-lint
step and the endpoint tests parse every rendered line (name/label charsets,
escaping, HELP/TYPE pairing, duplicate-series detection, float-valued
samples), so a malformed scrape page is a red build, not a silent Prometheus
drop.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

#: every exported metric name carries this prefix (the JMX domain equivalent)
PREFIX = "cruise_control_tpu"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(value: str) -> str:
    return (
        str(value).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _escape_help(value: str) -> str:
    return str(value).replace("\\", r"\\").replace("\n", r"\n")


def _fmt(value) -> str:
    f = float(value)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if f != int(f) else str(int(f))


class _Family:
    """One metric family: HELP/TYPE header + its samples, dedup-checked."""

    def __init__(self, name: str, kind: str, help_text: str) -> None:
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: List[Tuple[Tuple[Tuple[str, str], ...], float]] = []
        self._seen: set = set()

    def add(self, labels: Dict[str, str], value) -> None:
        if value is None:
            return   # null-valued gauges (CPU memory_stats) are simply absent
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        if key in self._seen:
            return   # first writer wins; duplicates would fail the parser
        self._seen.add(key)
        self.samples.append((key, float(value)))

    def render(self, out: List[str]) -> None:
        if not self.samples:
            return
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for labels, value in self.samples:
            if labels:
                body = ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in labels
                )
                out.append(f"{self.name}{{{body}}} {_fmt(value)}")
            else:
                out.append(f"{self.name} {_fmt(value)}")


def _split_family(sensor_name: str) -> Tuple[str, str]:
    family, dot, leaf = sensor_name.partition(".")
    return (family, leaf) if dot else ("", sensor_name)


# -- section renderers --------------------------------------------------------------


def _render_sensors(families: Dict[str, _Family], registry) -> None:
    snap = registry.snapshot()
    timer_s = families[f"{PREFIX}_timer_seconds"]
    timer_n = families[f"{PREFIX}_timer_count"]
    timer_w = families[f"{PREFIX}_timer_window_samples"]
    gauge = families[f"{PREFIX}_gauge"]
    counter = families[f"{PREFIX}_counter_total"]
    meter_n = families[f"{PREFIX}_meter_total"]
    meter_r = families[f"{PREFIX}_meter_rate_per_second"]

    for name, stats in snap.get("timers", {}).items():
        fam, leaf = _split_family(name)
        labels = {"family": fam, "sensor": leaf}
        timer_n.add(labels, stats["count"])
        timer_w.add(labels, stats.get("window_n"))
        for stat in ("mean", "max", "last", "p50", "p95", "p99"):
            timer_s.add({**labels, "stat": stat}, stats.get(f"{stat}_s"))
    for name, value in snap.get("gauges", {}).items():
        fam, leaf = _split_family(name)
        gauge.add({"family": fam, "sensor": leaf}, value)
    for name, value in snap.get("counters", {}).items():
        fam, leaf = _split_family(name)
        counter.add({"family": fam, "sensor": leaf}, value)
    for name, stats in snap.get("meters", {}).items():
        fam, leaf = _split_family(name)
        labels = {"family": fam, "sensor": leaf}
        meter_n.add(labels, stats["total"])
        meter_r.add(labels, stats["rate_per_s"])


def _render_recorder(families: Dict[str, _Family], recorder) -> None:
    snap = recorder.snapshot()
    families[f"{PREFIX}_flight_ring_size"].add({}, snap["size"])
    families[f"{PREFIX}_flight_ring_capacity"].add({}, snap["capacity"])
    families[f"{PREFIX}_flight_dropped_total"].add({}, snap["dropped"])
    by_kind = families[f"{PREFIX}_flight_traces"]
    for kind, n in sorted(snap["by_kind"].items()):
        by_kind.add({"kind": kind}, n)


def _render_profiler(families: Dict[str, _Family], profiler) -> None:
    calls = families[f"{PREFIX}_executable_calls_total"]
    call_s = families[f"{PREFIX}_executable_call_seconds_total"]
    compiles = families[f"{PREFIX}_executable_compile_events_total"]
    compile_s = families[f"{PREFIX}_executable_compile_seconds_total"]
    flops = families[f"{PREFIX}_executable_flops_total"]
    bytes_t = families[f"{PREFIX}_executable_bytes_accessed_total"]
    for program, row in sorted(profiler.per_program_totals().items()):
        labels = {"program": program}
        calls.add(labels, row["calls"])
        call_s.add(labels, row["call_seconds"])
        compiles.add(labels, row["compile_events"])
        compile_s.add(labels, row["compile_seconds"])
        flops.add(labels, row["flops_total"])
        bytes_t.add(labels, row["bytes_total"])
    mem = families[f"{PREFIX}_device_memory_bytes"]
    for row in profiler.snapshot()["memory"]:
        for stat in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
            mem.add({"device": row["device"], "stat": stat}, row.get(stat))


_GATE_CACHE: Optional[Tuple[str, float, dict]] = None
_GATE_METRICS = (
    "wall_s", "cold_s", "num_dispatches", "balancedness",
    "residual_hard_violations",
)


def _gate_baseline() -> dict:
    """The committed gate baseline of the process's device (``cuda`` where a
    card is present), cached (mtime-checked) -- operators alert when a live
    sensor drifts from the number the repo promised."""
    global _GATE_CACHE
    import torch

    from cruise_control_tpu_torch.obs.gate import _repo_root, baseline_path

    path = os.path.join(_repo_root(), baseline_path("cuda" if torch.cuda.is_available() else "cpu"))
    try:
        mtime = os.path.getmtime(path)
        if _GATE_CACHE is not None and _GATE_CACHE[:2] == (path, mtime):
            return _GATE_CACHE[2]
        with open(path) as f:
            doc = json.load(f)
        _GATE_CACHE = (path, mtime, doc)
        return doc
    except (OSError, json.JSONDecodeError):
        return {}


def _render_readiness(families: Dict[str, _Family], registry) -> None:
    """First-class readiness/recovery metrics (the k8s-dashboard contract):
    ``cruise_control_tpu_ready`` is THE signal a fleet scheduler keys on, so
    it gets a stable dedicated name instead of hiding in the generic
    family/sensor gauge mapping (which also carries these values)."""
    from cruise_control_tpu_torch.core.sensors import (
        READY_GAUGE,
        RECOVERY_RECORDS_GAUGE,
        RECOVERY_WALL_GAUGE,
    )

    snap = registry.snapshot().get("gauges", {})
    if READY_GAUGE in snap:
        families[f"{PREFIX}_ready"].add({}, snap[READY_GAUGE])
    if RECOVERY_WALL_GAUGE in snap:
        families[f"{PREFIX}_recovery_wall_seconds"].add({}, snap[RECOVERY_WALL_GAUGE])
    if RECOVERY_RECORDS_GAUGE in snap:
        families[f"{PREFIX}_recovery_records_replayed"].add(
            {}, snap[RECOVERY_RECORDS_GAUGE]
        )


def _render_gate(families: Dict[str, _Family]) -> None:
    fam = families[f"{PREFIX}_gate_baseline"]
    for tier, m in sorted(_gate_baseline().get("tiers", {}).items()):
        for metric in _GATE_METRICS:
            if metric in m and m[metric] is not None:
                fam.add({"tier": tier, "metric": metric}, m[metric])


def _render_slo(families: Dict[str, _Family], engine) -> None:
    """First-class SLO series (obs/slo.py): alert state must be scrapeable
    without parsing the generic sensor families — a burning objective is THE
    page signal, same rationale as the dedicated ``_ready`` gauge."""
    value_f = families[f"{PREFIX}_slo_value"]
    objective_f = families[f"{PREFIX}_slo_objective"]
    burn_f = families[f"{PREFIX}_slo_burn_rate"]
    firing_f = families[f"{PREFIX}_slo_alert_firing"]
    for spec in engine.specs:
        labels = {"slo": spec.name}
        value_f.add(labels, engine.source.latest(spec.series))
        objective_f.add(labels, spec.objective)
    for alert in engine.status()["alerts"]:
        labels = {"slo": alert["slo"], "pair": alert["pair"]}
        burn_f.add({**labels, "window": "long"}, alert["burn_long"])
        burn_f.add({**labels, "window": "short"}, alert["burn_short"])
        firing_f.add(labels, 1.0 if alert["firing"] else 0.0)


def _render_selfmon_windows(
    families: Dict[str, _Family], selfmon, max_windows: int
) -> None:
    """The aggregated time-series view behind ``GET /METRICS?window=N``:
    per-series window means over the last N stable aggregator windows."""
    fam = families[f"{PREFIX}_selfmon_window_value"]
    doc = selfmon.windows(max_windows=max_windows)
    for series, values in sorted(doc["series"].items()):
        for win_id, value in zip(doc["window_ids"][-len(values):], values):
            fam.add({"series": series, "window_id": str(win_id)}, value)


_FAMILY_DEFS = {
    f"{PREFIX}_timer_seconds": (
        "gauge",
        "Sensor-registry timer statistics (stat: mean/max/last/p50/p95/p99)",
    ),
    f"{PREFIX}_timer_count": ("counter", "Sensor-registry timer update counts"),
    f"{PREFIX}_timer_window_samples": (
        "gauge",
        "Samples in each timer's percentile ring (the confidence behind "
        "p50/p95/p99)",
    ),
    f"{PREFIX}_gauge": ("gauge", "Sensor-registry gauges (last written value)"),
    f"{PREFIX}_counter_total": ("counter", "Sensor-registry monotonic counters"),
    f"{PREFIX}_meter_total": ("counter", "Sensor-registry meter event totals"),
    f"{PREFIX}_meter_rate_per_second": (
        "gauge", "Sensor-registry meter rates over the sliding window"
    ),
    f"{PREFIX}_flight_ring_size": ("gauge", "Flight-recorder ring occupancy"),
    f"{PREFIX}_flight_ring_capacity": ("gauge", "Flight-recorder ring capacity"),
    f"{PREFIX}_flight_dropped_total": (
        "counter", "Flight-recorder traces trimmed off the ring"
    ),
    f"{PREFIX}_flight_traces": ("gauge", "Flight-recorder ring contents by kind"),
    f"{PREFIX}_executable_calls_total": (
        "counter", "Profiled compiled-program dispatch counts"
    ),
    f"{PREFIX}_executable_call_seconds_total": (
        "counter", "Profiled compiled-program enqueue wall seconds"
    ),
    f"{PREFIX}_executable_compile_events_total": (
        "counter", "XLA compile events attributed per program"
    ),
    f"{PREFIX}_executable_compile_seconds_total": (
        "counter", "XLA compile wall seconds attributed per program"
    ),
    f"{PREFIX}_executable_flops_total": (
        "counter", "HLO cost-analysis FLOPs executed per program (analysis x calls)"
    ),
    f"{PREFIX}_executable_bytes_accessed_total": (
        "counter", "HLO cost-analysis bytes accessed per program (analysis x calls)"
    ),
    f"{PREFIX}_device_memory_bytes": (
        "gauge", "Device memory_stats() sampled at trace boundaries"
    ),
    f"{PREFIX}_gate_baseline": (
        "gauge", "Committed regression-gate baseline numbers per tier"
    ),
    f"{PREFIX}_ready": (
        "gauge",
        "1 once the startup ladder (recovering/monitor_warming) reached ready",
    ),
    f"{PREFIX}_recovery_wall_seconds": (
        "gauge", "Wall seconds of the last startup journal-recovery pass"
    ),
    f"{PREFIX}_recovery_records_replayed": (
        "gauge", "Journal records replayed by the last startup recovery pass"
    ),
    f"{PREFIX}_slo_value": (
        "gauge", "Latest sampled value of each SLO's self-monitoring series"
    ),
    f"{PREFIX}_slo_objective": ("gauge", "Configured objective of each SLO"),
    f"{PREFIX}_slo_burn_rate": (
        "gauge",
        "Burn rate (bad-fraction / error budget) per SLO, window pair, and "
        "window (long/short)",
    ),
    f"{PREFIX}_slo_alert_firing": (
        "gauge",
        "1 while the multi-window burn-rate alert fires for (slo, pair)",
    ),
    f"{PREFIX}_selfmon_window_value": (
        "gauge",
        "Self-monitoring series aggregated per stable window "
        "(GET /METRICS?window=N)",
    ),
}


def render_prometheus(
    registry=None,
    recorder=None,
    profiler=None,
    slo_engine=None,
    selfmon=None,
    selfmon_window: Optional[int] = None,
) -> str:
    """The full /METRICS page.  Defaults to the process-wide singletons
    (including the app-registered global SLO engine); ``selfmon_window=N``
    additionally renders the last N stable self-monitoring windows per
    series (the ``?window=`` query surface)."""
    from cruise_control_tpu_torch.core.sensors import (
        EXPORTER_RENDER_TIMER,
        METRICS_SCRAPES_COUNTER,
        REGISTRY,
    )
    from cruise_control_tpu_torch.obs import slo as _slo
    from cruise_control_tpu_torch.obs.profiler import PROFILER
    from cruise_control_tpu_torch.obs.recorder import RECORDER

    registry = registry if registry is not None else REGISTRY
    recorder = recorder if recorder is not None else RECORDER
    profiler = profiler if profiler is not None else PROFILER
    slo_engine = slo_engine if slo_engine is not None else _slo.GLOBAL_ENGINE
    if selfmon is None and slo_engine is not None:
        selfmon = getattr(slo_engine, "source", None)

    t0 = time.monotonic()
    # self-monitoring: the in-progress scrape is counted BEFORE the registry
    # snapshot so the page covers it; the render-wall timer can only be known
    # after rendering and thus lags one scrape (standard client behavior).
    if registry is REGISTRY:
        REGISTRY.counter(METRICS_SCRAPES_COUNTER).inc()
        REGISTRY.timer(EXPORTER_RENDER_TIMER)   # registered from scrape one
    families = {
        name: _Family(name, kind, help_text)
        for name, (kind, help_text) in _FAMILY_DEFS.items()
    }
    _render_sensors(families, registry)
    _render_recorder(families, recorder)
    _render_profiler(families, profiler)
    _render_readiness(families, registry)
    _render_gate(families)
    if slo_engine is not None:
        _render_slo(families, slo_engine)
    if selfmon is not None and selfmon_window is not None and selfmon_window > 0:
        _render_selfmon_windows(families, selfmon, selfmon_window)
    out: List[str] = []
    for fam in families.values():
        fam.render(out)
    text = "\n".join(out) + "\n"
    if registry is REGISTRY:
        REGISTRY.timer(EXPORTER_RENDER_TIMER).update(time.monotonic() - t0)
    return text


# -- strict exposition parser -------------------------------------------------------


class ExpositionError(ValueError):
    """A line violated the text exposition format (line number included)."""


_LABEL_BODY_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\\n]|\\\\|\\"|\\n)*)"'
)
_VALUE_RE = re.compile(r"^[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|Inf|NaN)$")


def _parse_labels(body: str, lineno: int) -> Tuple[Tuple[str, str], ...]:
    labels: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(body):
        m = _LABEL_BODY_RE.match(body, pos)
        if m is None:
            raise ExpositionError(
                f"line {lineno}: malformed label at offset {pos} in {{{body}}}"
            )
        labels.append((m.group(1), m.group(2)))
        pos = m.end()
        if pos < len(body):
            if body[pos] != ",":
                raise ExpositionError(
                    f"line {lineno}: expected ',' between labels in {{{body}}}"
                )
            pos += 1
    return tuple(labels)


def parse_exposition(text: str) -> Dict[str, dict]:
    """Strictly parse exposition-format text; raise :class:`ExpositionError`
    on any violation.  Returns ``{metric name: {"type", "help", "samples":
    [(labels tuple, value)]}}``.

    Strictness (what CI's metrics-lint enforces, beyond what Prometheus
    itself would merely tolerate): every sample's metric must carry BOTH a
    HELP and a TYPE line, declared before the first sample and at most once;
    names/label names must match the spec charsets; label values must use
    only the three legal escapes; no duplicate (name, labelset) series."""
    metrics: Dict[str, dict] = {}
    seen_series: set = set()
    sample_started: set = set()

    for lineno, raw in enumerate(text.split("\n"), start=1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] in ("HELP", "TYPE"):
                if len(parts) < 3:
                    raise ExpositionError(f"line {lineno}: bare # {parts[1]}")
                name = parts[2]
                if not _NAME_RE.match(name):
                    raise ExpositionError(
                        f"line {lineno}: invalid metric name {name!r}"
                    )
                entry = metrics.setdefault(
                    name, {"type": None, "help": None, "samples": []}
                )
                field = parts[1].lower()
                if name in sample_started:
                    raise ExpositionError(
                        f"line {lineno}: {parts[1]} for {name} after its samples"
                    )
                if entry[field] is not None:
                    raise ExpositionError(
                        f"line {lineno}: duplicate {parts[1]} for {name}"
                    )
                payload = parts[3] if len(parts) > 3 else ""
                if field == "type" and payload not in (
                    "counter", "gauge", "histogram", "summary", "untyped"
                ):
                    raise ExpositionError(
                        f"line {lineno}: unknown TYPE {payload!r} for {name}"
                    )
                entry[field] = payload
            # other comment lines are legal and ignored
            continue

        # sample line: name[{labels}] value [timestamp]
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)(\s+\S+)?$", line)
        if m is None:
            raise ExpositionError(f"line {lineno}: malformed sample {line!r}")
        name, _, label_body, value, _ts = m.groups()
        labels = _parse_labels(label_body, lineno) if label_body else ()
        for lname, _v in labels:
            if not _LABEL_RE.match(lname):
                raise ExpositionError(
                    f"line {lineno}: invalid label name {lname!r}"
                )
        if not _VALUE_RE.match(value):
            raise ExpositionError(f"line {lineno}: invalid value {value!r}")
        entry = metrics.get(name)
        if entry is None or entry["type"] is None or entry["help"] is None:
            raise ExpositionError(
                f"line {lineno}: sample for {name} without preceding HELP+TYPE"
            )
        series = (name, tuple(sorted(labels)))
        if series in seen_series:
            raise ExpositionError(
                f"line {lineno}: duplicate series {name}{dict(labels)}"
            )
        seen_series.add(series)
        sample_started.add(name)
        entry["samples"].append((labels, float(value)))

    for name, entry in metrics.items():
        if entry["type"] is None or entry["help"] is None:
            raise ExpositionError(f"{name}: HELP/TYPE pair incomplete")
    return metrics
