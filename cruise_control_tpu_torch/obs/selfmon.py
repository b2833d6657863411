"""Self-monitoring plane: the system's own sensors as windowed time-series.

Port of ``cruise_control_tpu/obs/selfmon.py`` (pure Python, copied whole).
Two series read what the port has in place of compiled programs:
``flight.compile-events.delta`` counts the port's compile events (one per
``nvcc`` build of a kernel source, ``ops/_build.py``), and the ``profiler.*``
series read the hand-written kernels' census (``obs/profiler.py``).

The reference's core competency — windowed metric aggregation — only ever
points at the *Kafka cluster*.  This module turns the same machinery on the
process itself: a fixed-cadence sampler snapshots the whole
:class:`SensorRegistry` (plus a flight-recorder summary and the profiler's
cost census), flattens it into named series, and lands every sample in

* a :class:`core.aggregator.MetricSampleAggregator` — the L0 window
  semantics (current window excluded, extrapolation codes, dense tensors)
  reused verbatim, one entity per series — serving ``GET /METRICS?window=…``;
* per-series trailing-history rings serving the SLO burn-rate engine
  (``obs/slo.py``) and the ``SLO`` endpoint;
* a size-capped JSONL spool under ``journal.dir/selfmon`` (rotation shared
  with the flight recorder's sink), so the history survives restarts as a
  diffable artifact.

Fleet tenants need no special casing: tenant control loops already register
their sensors under ``Fleet.tenant.<name>.*`` in the process registry, so
per-tenant series fall out of the same flatten.

The sampler is pure host-side bookkeeping — no kernel launch, no device
work — and the bench (``obs/selfmon_bench.py``) asserts exactly that from the
profiler census's running totals and the compile-event log.

Series naming (the contract ``docs/SLOS.md`` specs reference):

* timers   → ``<sensor>.{count,mean_s,max_s,last_s,p50_s,p95_s,p99_s,window_n}``
* gauges   → ``<sensor>``
* counters → ``<sensor>.count`` and ``<sensor>.rate_per_s`` (delta rate)
* meters   → ``<sensor>.total`` / ``<sensor>.rate_per_s``
* flight   → ``flight.ring-size``, ``flight.dropped``,
  ``flight.compile-events.delta`` (kernel builds since the previous sample),
  ``flight.controller_tick.dispatches`` (last warm tick's device dispatches)
* profiler → ``profiler.programs``, ``profiler.calls.total``,
  ``profiler.compile-events.total``
* derived  → ``derived.Admission.shed-ratio``,
  ``derived.GoalOptimizer.degraded-ratio`` (per-sampling-period ratios)
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.core.aggregator import (
    AggregationOptions,
    MetricSampleAggregator,
    NotEnoughValidWindowsError,
)
from cruise_control_tpu_torch.core.metricdef import MetricDef
from cruise_control_tpu_torch.core.sensors import (
    ADMISSION_ADMITTED_COUNTER,
    ADMISSION_SHED_COUNTER,
    OPTIMIZE_DEADLINE_COUNTER,
    PROPOSAL_COMPUTATION_TIMER,
    REGISTRY,
    SELFMON_SAMPLES_COUNTER,
    SELFMON_SAMPLE_TIMER,
    SELFMON_SERIES_GAUGE,
    SELFMON_SPOOL_BYTES_GAUGE,
    SELFMON_SPOOL_ROTATIONS_COUNTER,
)
from cruise_control_tpu_torch.obs import recorder as _rec

#: timer snapshot keys promoted to series (everything Timer.snapshot exports)
_TIMER_STATS = (
    "count", "mean_s", "max_s", "last_s", "p50_s", "p95_s", "p99_s",
    "window_n",
)

#: bump when the spool record shape changes incompatibly
SPOOL_SCHEMA = 1


def _selfmon_metric_def() -> MetricDef:
    """One-column def: each series is its own entity, ``value`` its metric."""
    d = MetricDef()
    d.define("value")
    return d


class SelfMonitor:
    """Fixed-cadence sampler over the process's own observability surfaces."""

    def __init__(
        self,
        registry=None,
        recorder=None,
        profiler=None,
        interval_s: float = 10.0,
        num_windows: int = 60,
        window_ms: int = 60_000,
        history: int = 4096,
        spool_dir: Optional[str] = None,
        spool_max_bytes: int = 8 * 1024 * 1024,
    ) -> None:
        self.registry = registry if registry is not None else REGISTRY
        self.recorder = recorder if recorder is not None else _rec.RECORDER
        if profiler is None:
            from cruise_control_tpu_torch.obs.profiler import PROFILER

            profiler = PROFILER
        self.profiler = profiler
        self.interval_s = interval_s
        self.num_windows = num_windows
        self.window_ms = window_ms
        self.history = history
        self.spool_dir = spool_dir
        self.spool_max_bytes = spool_max_bytes
        self.spool_path = (
            os.path.join(spool_dir, "selfmon.jsonl") if spool_dir else None
        )

        self._agg = MetricSampleAggregator(
            num_windows=num_windows,
            window_ms=window_ms,
            min_samples_per_window=1,
            metric_def=_selfmon_metric_def(),
        )
        self._lock = threading.Lock()
        self._hist: Dict[str, Deque[Tuple[int, float]]] = {}
        self._last_counters: Dict[str, float] = {}
        self._last_sample_ms: Optional[int] = None
        self._compile_mark = _rec.compile_mark()
        self.samples = 0
        self.spool_rotations = 0
        self.spool_errors = 0
        self._spool_dir_made = False
        self._spool_f = None
        self._batch_key: Tuple[str, ...] = ()
        self._batch_rows = np.empty(0, np.intp)
        self._timer_keys: Dict[str, tuple] = {}
        self._counter_keys: Dict[str, str] = {}
        self._meter_keys: Dict[str, tuple] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- collection ----------------------------------------------------------

    def collect(self, now_ms: int) -> Dict[str, float]:
        """One flattened snapshot of every observability surface (host-only)."""
        series: Dict[str, float] = {}
        snap = self.registry.snapshot()
        # sensor names are stable across ticks: cache the derived series-key
        # strings (f-string construction per series per tick adds up at
        # sampler cadence)
        tcache, ccache, mcache = self._timer_keys, self._counter_keys, self._meter_keys
        for name, stats in snap.get("timers", {}).items():
            tkeys = tcache.get(name)
            if tkeys is None:
                tkeys = tcache[name] = tuple(
                    (stat, f"{name}.{stat}") for stat in _TIMER_STATS
                )
            for stat, key in tkeys:
                if stat in stats:
                    series[key] = float(stats[stat])
        for name, value in snap.get("gauges", {}).items():
            series[name] = float(value)
        counters: Dict[str, float] = {}
        for name, value in snap.get("counters", {}).items():
            ckey = ccache.get(name)
            if ckey is None:
                ckey = ccache[name] = f"{name}.count"
            counters[name] = float(value)
            series[ckey] = float(value)
        for name, stats in snap.get("meters", {}).items():
            mkeys = mcache.get(name)
            if mkeys is None:
                mkeys = mcache[name] = (f"{name}.total", f"{name}.rate_per_s")
            series[mkeys[0]] = float(stats["total"])
            series[mkeys[1]] = float(stats["rate_per_s"])

        # flight-recorder summary + the compile-event delta since last sample
        rec_snap = self.recorder.snapshot()
        series["flight.ring-size"] = float(rec_snap["size"])
        series["flight.dropped"] = float(rec_snap["dropped"])
        mark = _rec.compile_mark()
        series["flight.compile-events.delta"] = float(
            len(_rec.compile_events_since(self._compile_mark))
        )
        self._compile_mark = mark
        ticks = self.recorder.recent(1, kind="controller_tick")
        if ticks:
            dispatches = ticks[0].attrs.get("num_dispatches")
            if dispatches is not None:
                series["flight.controller_tick.dispatches"] = float(dispatches)

        # profiler cost census
        totals = self.profiler.per_program_totals()
        series["profiler.programs"] = float(len(totals))
        series["profiler.calls.total"] = float(
            sum(t.get("calls", 0) for t in totals.values())
        )
        series["profiler.compile-events.total"] = float(
            sum(t.get("compile_events", 0) for t in totals.values())
        )

        # counter deltas vs the previous sample (a fresh process's first
        # sample deltas against zero), then the shipped derived ratios
        last = self._last_counters
        dt_s = (
            (now_ms - self._last_sample_ms) / 1000.0
            if self._last_sample_ms is not None
            else None
        )
        deltas = {k: v - last.get(k, 0.0) for k, v in counters.items()}
        if dt_s and dt_s > 0:
            for name, d in deltas.items():
                series[f"{name}.rate_per_s"] = d / dt_s
        shed_d = deltas.get(ADMISSION_SHED_COUNTER, 0.0)
        admitted_d = deltas.get(ADMISSION_ADMITTED_COUNTER, 0.0)
        total_d = shed_d + admitted_d
        series["derived.Admission.shed-ratio"] = (
            shed_d / total_d if total_d > 0 else 0.0
        )
        deadline_d = deltas.get(OPTIMIZE_DEADLINE_COUNTER, 0.0)
        opt_timer = snap.get("timers", {}).get(PROPOSAL_COMPUTATION_TIMER)
        opt_d = (
            float(opt_timer["count"]) - last.get("__optimizes__", 0.0)
            if opt_timer
            else 0.0
        )
        series["derived.GoalOptimizer.degraded-ratio"] = (
            deadline_d / opt_d if opt_d > 0 else 0.0
        )
        self._last_counters = dict(counters)
        if opt_timer:
            self._last_counters["__optimizes__"] = float(opt_timer["count"])
        return series

    def sample(self, now_ms: Optional[int] = None) -> Dict[str, float]:
        """One sampling tick: collect, aggregate, remember, spool."""
        now = int(time.time() * 1000) if now_ms is None else now_ms
        with REGISTRY.timer(SELFMON_SAMPLE_TIMER).time():
            with self._lock:
                series = self.collect(now)
                # one batched landing for the whole tick (rows_for/
                # add_rows_at): every series shares this timestamp, and the
                # batch is stable across ticks, so both the per-series
                # lock/roll overhead and the per-series row resolution are
                # pure waste at sampler cadence
                key = tuple(series)
                if key != self._batch_key:
                    self._batch_key = key
                    self._batch_rows = self._agg.rows_for(key)
                vals = np.fromiter(series.values(), np.float64, len(series))
                self._agg.add_rows_at(
                    now, self._batch_rows, vals.reshape(-1, 1)
                )
                hists = self._hist
                for name, value in series.items():
                    hist = hists.get(name)
                    if hist is None:
                        hist = hists[name] = deque(maxlen=self.history)
                    hist.append((now, value))
                self._last_sample_ms = now
                self.samples += 1
                # inside the lock: stop() closes the spool handle under it
                self._spool(now, series)
        REGISTRY.counter(SELFMON_SAMPLES_COUNTER).inc()
        REGISTRY.gauge(SELFMON_SERIES_GAUGE).set(len(series))
        return series

    def _spool(self, now_ms: int, series: Dict[str, float]) -> None:
        if not self.spool_path:
            return
        line = json.dumps(
            {"schema": SPOOL_SCHEMA, "ts_ms": now_ms, "series": series},
            separators=(",", ":"),
        )
        try:
            if self._spool_f is None:
                if not self._spool_dir_made:
                    os.makedirs(self.spool_dir, exist_ok=True)
                    self._spool_dir_made = True
                # append-mode handle held across samples: an open per line
                # would dominate the sampler's wall (same cap/rotation
                # semantics as append_jsonl_capped, size via tell())
                self._spool_f = open(self.spool_path, "a")
            size = self._spool_f.tell()
            if (
                self.spool_max_bytes
                and size > 0
                and size + len(line) + 1 > self.spool_max_bytes
            ):
                self._spool_f.close()
                self._spool_f = None
                os.replace(self.spool_path, self.spool_path + ".1")
                self._spool_f = open(self.spool_path, "a")
                size = 0
                self.spool_rotations += 1
                REGISTRY.counter(SELFMON_SPOOL_ROTATIONS_COUNTER).inc()
            self._spool_f.write(line + "\n")
            self._spool_f.flush()
            REGISTRY.gauge(SELFMON_SPOOL_BYTES_GAUGE).set(size + len(line) + 1)
        except OSError:
            # a full/readonly disk must never take down the sampler
            self.spool_errors += 1
            self._spool_dir_made = False   # dir may have vanished: retry
            if self._spool_f is not None:
                try:
                    self._spool_f.close()
                except OSError:
                    pass
                self._spool_f = None

    # -- query surfaces ------------------------------------------------------

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._hist)

    def latest(self, series: str) -> Optional[float]:
        with self._lock:
            hist = self._hist.get(series)
            return hist[-1][1] if hist else None

    def window_values(
        self, series: str, window_s: float, now_ms: Optional[int] = None
    ) -> List[float]:
        """Sampled values of ``series`` inside the trailing window (the SLO
        engine's burn-rate input)."""
        now = int(time.time() * 1000) if now_ms is None else now_ms
        cutoff = now - int(window_s * 1000)
        with self._lock:
            hist = self._hist.get(series)
            if not hist:
                return []
            return [v for ts, v in hist if cutoff <= ts <= now]

    def windows(
        self, max_windows: Optional[int] = None, prefix: Optional[str] = None
    ) -> dict:
        """Aggregated stable windows per series (``GET /METRICS?window=N``):
        the L0 window view — current window excluded, one mean per stable
        window, newest last."""
        with self._lock:
            entities = sorted(self._hist)
        if prefix is not None:
            entities = [e for e in entities if e.startswith(prefix)]
        try:
            vae, _ = self._agg.aggregate(
                entities=entities or None,
                options=AggregationOptions(include_invalid_entities=True),
            )
        except NotEnoughValidWindowsError:
            return {"window_ms": self.window_ms, "window_ids": [], "series": {}}
        win_ids = vae.window_ids
        if max_windows is not None and max_windows > 0:
            win_ids = win_ids[-max_windows:]
        keep = len(win_ids)
        return {
            "window_ms": self.window_ms,
            "window_ids": list(win_ids),
            "series": {
                str(e): [float(x) for x in vae.values[i, -keep:, 0]]
                for i, e in enumerate(vae.entities)
            },
        }

    def status(self) -> dict:
        """The ``STATE`` SelfMonitor block (sans the SLO sub-block the app
        attaches)."""
        with self._lock:
            series_count = len(self._hist)
            last_ms = self._last_sample_ms
            samples = self.samples
        spool_bytes = 0
        if self.spool_path:
            try:
                spool_bytes = os.path.getsize(self.spool_path)
            except OSError:
                spool_bytes = 0
        return {
            "enabled": True,
            "running": self._thread is not None and self._thread.is_alive(),
            "intervalS": self.interval_s,
            "samples": samples,
            "seriesCount": series_count,
            "lastSampleMs": last_ms,
            "windows": {
                "num": self.num_windows,
                "windowMs": self.window_ms,
                "stable": len(self._agg.available_window_ids()),
            },
            "spool": {
                "path": self.spool_path,
                "bytes": spool_bytes,
                "maxBytes": self.spool_max_bytes,
                "rotations": self.spool_rotations,
                "errors": self.spool_errors,
            },
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Begin background sampling (daemon thread, app-owned lifecycle)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="selfmon-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            if self._spool_f is not None:
                try:
                    self._spool_f.close()
                except OSError:
                    pass
                self._spool_f = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample()
            except Exception:
                # self-observation must never take down the process
                pass
            self._stop.wait(self.interval_s)


def read_spool(path: str) -> List[dict]:
    """Load a selfmon spool (prefix-tolerant like the flight recorder's
    ``read_jsonl``: a crash-truncated tail is skipped, not fatal)."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break
    except OSError:
        pass
    return out
