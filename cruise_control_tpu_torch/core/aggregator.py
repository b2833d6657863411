"""Sliding-window metric sample aggregation.

Port of ``cruise_control_tpu/core/aggregator.py``.

Counterpart of the reference's core aggregator
(``cruise-control-core/.../monitor/sampling/aggregator/MetricSampleAggregator.java:84``,
``RawMetricValues.java`` circular per-window arrays, ``MetricSampleCompleteness``,
``ValuesAndExtrapolations``) and the extrapolation policy (``Extrapolation.java:32``).

Design: instead of per-entity objects holding circular arrays, ALL entities
share dense numpy tensors::

    sum   [E, W, M]   per-window accumulated value (sum for AVG, max for MAX,
                      latest for LATEST)
    count [E, W]      samples per window per entity
    latest_ts [E, W]  timestamp of latest sample (for LATEST strategy)

with a rolling window ring indexed by absolute window id.  Aggregation is a pure
vectorized pass producing ``[E, W, M]`` value tensors + validity/extrapolation masks —
exactly the array the analyzer snapshot consumes, with no per-entity Python loops in
the hot path.  Ingestion (``add_sample``) is host-side; the model stays in numpy and only
``ClusterModel.to_arrays(device=)`` moves it to the device.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, Generic, Hashable, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

from cruise_control_tpu_torch.core.metricdef import MetricDef, ValueStrategy

E = TypeVar("E", bound=Hashable)


class Extrapolation(enum.IntEnum):
    """How an invalid window's value was filled (Extrapolation.java:32)."""

    NONE = 0                      # window was valid, no extrapolation needed
    AVG_AVAILABLE = 1             # avg of the samples that did arrive (>= half required)
    AVG_ADJACENT = 2              # avg of the two adjacent valid windows
    FORCED_INSUFFICIENT = 3       # forced: used whatever insufficient samples existed
    NO_VALID_EXTRAPOLATION = 4    # nothing to extrapolate from; window invalid


@dataclasses.dataclass
class AggregationOptions:
    """Aggregation requirements (AggregationOptions.java).

    ``min_valid_entity_ratio``: fraction of requested entities that must be valid.
    ``min_valid_entity_group_ratio``: fraction of entity groups fully valid.
    ``min_valid_windows``: number of windows that must meet the entity coverage.
    ``include_invalid_entities``: include invalid entities with extrapolated values.
    """

    min_valid_entity_ratio: float = 0.0
    min_valid_entity_group_ratio: float = 0.0
    min_valid_windows: int = 1
    include_invalid_entities: bool = False


@dataclasses.dataclass
class MetricSampleCompleteness:
    """Coverage summary for an aggregation (MetricSampleCompleteness.java)."""

    generation: int
    valid_entity_ratio: float
    valid_entity_group_ratio: float
    valid_windows: List[int]              # absolute window ids meeting coverage
    entity_coverage_by_window: Dict[int, float]

    @property
    def num_valid_windows(self) -> int:
        return len(self.valid_windows)


@dataclasses.dataclass
class ValuesAndExtrapolations:
    """Aggregation output for one entity set (ValuesAndExtrapolations.java).

    ``values``: float32 ``[E, W, M]`` window-major metric values.
    ``extrapolations``: uint8 ``[E, W]`` Extrapolation codes.
    ``window_ids``: absolute window indices for axis 1 (newest last).
    ``entities``: entity keys for axis 0.
    """

    values: np.ndarray
    extrapolations: np.ndarray
    window_ids: List[int]
    entities: List[Hashable]

    def entity_index(self, entity: Hashable) -> int:
        return self.entities.index(entity)


class MetricSampleAggregator(Generic[E]):
    """Dense sliding-window aggregator over hashable entities.

    Mirrors MetricSampleAggregator.java semantics:

    * samples land in the window containing their timestamp (``add_sample``:141);
    * the *current* (newest, still-filling) window is excluded from aggregation;
    * a window is valid for an entity when it holds >= ``min_samples_per_window``
      samples; invalid windows are extrapolated per ``Extrapolation``;
    * an entity is valid when it has <= ``max_allowed_extrapolations`` extrapolated
      windows and no ``NO_VALID_EXTRAPOLATION`` window;
    * a monotonically increasing ``generation`` invalidates cached aggregations.
    """

    _GROW = 256  # entity capacity growth increment

    def __init__(
        self,
        num_windows: int,
        window_ms: int,
        min_samples_per_window: int,
        metric_def: MetricDef,
        max_allowed_extrapolations: int = 5,
    ) -> None:
        if num_windows <= 0 or window_ms <= 0:
            raise ValueError("num_windows and window_ms must be positive")
        self.num_windows = num_windows
        self.window_ms = window_ms
        self.min_samples_per_window = max(1, min_samples_per_window)
        self.metric_def = metric_def
        self.max_allowed_extrapolations = max_allowed_extrapolations

        m = metric_def.size()
        # ring holds num_windows stable windows + 1 current window
        self._ring = num_windows + 1
        self._acc = np.zeros((0, self._ring, m), np.float64)
        self._count = np.zeros((0, self._ring), np.int32)
        self._latest_ts = np.full((0, self._ring), -1, np.int64)
        self._win_id = np.full(self._ring, -1, np.int64)  # absolute window id per slot

        self._entity_index: Dict[E, int] = {}
        self._entities: List[E] = []
        self._entity_group: Dict[E, Hashable] = {}
        self._generation = 0
        self._current_window: int = -1
        self._first_window: int = 0  # first window that ever received a sample
        self._lock = threading.RLock()

        strategies = metric_def.strategies_array()
        self._is_avg = np.array([s is ValueStrategy.AVG for s in strategies])
        self._is_max = np.array([s is ValueStrategy.MAX for s in strategies])
        self._is_latest = np.array([s is ValueStrategy.LATEST for s in strategies])
        self._has_avg = bool(self._is_avg.any())
        self._has_max = bool(self._is_max.any())
        self._has_latest = bool(self._is_latest.any())

    # -- properties ---------------------------------------------------------

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def current_window_index(self) -> int:
        return self._current_window

    def window_index(self, ts_ms: int) -> int:
        return int(ts_ms // self.window_ms)

    def num_entities(self) -> int:
        return len(self._entities)

    def entities(self) -> List[E]:
        return list(self._entities)

    # -- ingestion ----------------------------------------------------------

    def set_entity_group(self, entity: E, group: Hashable) -> None:
        """Assign an entity to a coverage group (e.g. partition -> topic)."""
        with self._lock:
            self._entity_group[entity] = group

    def add_sample(self, entity: E, ts_ms: int, values: Sequence[float]) -> bool:
        """Record one sample.  Returns False if the sample is too old to land."""
        if len(values) != self.metric_def.size():
            raise ValueError(
                f"sample has {len(values)} metrics, expected {self.metric_def.size()}"
            )
        w = self.window_index(ts_ms)
        with self._lock:
            if self._current_window < 0:
                self._current_window = w
            if w > self._current_window:
                self._roll_to(w)
            oldest = self._current_window - self.num_windows
            if w <= oldest - 1 or w < 0:
                return False  # predates retained history
            slot = w % self._ring
            if self._win_id[slot] != w:
                # slot belongs to an evicted window id; (re)claim it
                self._win_id[slot] = w
                self._acc[:, slot, :] = 0.0
                self._count[:, slot] = 0
                self._latest_ts[:, slot] = -1
            row = self._row_for(entity)
            vals = np.asarray(values, np.float64)
            first = self._count[row, slot] == 0
            acc = self._acc[row, slot]
            acc[self._is_avg] += vals[self._is_avg]
            if first:
                acc[self._is_max] = vals[self._is_max]
                acc[self._is_latest] = vals[self._is_latest]
            else:
                acc[self._is_max] = np.maximum(acc[self._is_max], vals[self._is_max])
                if ts_ms >= self._latest_ts[row, slot]:
                    acc[self._is_latest] = vals[self._is_latest]
            self._latest_ts[row, slot] = max(self._latest_ts[row, slot], ts_ms)
            self._count[row, slot] += 1
            self._generation += 1
            return True

    def add_samples_at(
        self, ts_ms: int, entity_values: Dict[E, Sequence[float]]
    ) -> int:
        """Record one sample per entity at one shared timestamp.

        The self-monitoring sampler's shape — every series sampled on one
        tick — pays one lock acquisition, one window roll, and one batch of
        vectorized accumulator updates instead of one of each per entity
        (:meth:`add_sample` per series is ~10 µs × hundreds of series every
        period, all of it lock/roll/indexing overhead on identical
        timestamps).  Semantics match ``add_sample`` called once per entry.
        Returns the number of samples that landed (0 when the timestamp
        predates retained history)."""
        if not entity_values:
            return 0
        m = self.metric_def.size()
        for values in entity_values.values():
            if len(values) != m:
                raise ValueError(
                    f"sample has {len(values)} metrics, expected {m}"
                )
        with self._lock:
            rows = self.rows_for(list(entity_values))
            vals = np.array(list(entity_values.values()), np.float64)
            return self.add_rows_at(ts_ms, rows, vals.reshape(len(rows), m))

    def rows_for(self, entities: Sequence[E]) -> np.ndarray:
        """Resolve (creating as needed) the accumulator rows of ``entities``.

        Callers landing the same entity batch every period (the selfmon
        sampler) cache the result and feed it to :meth:`add_rows_at` —
        skipping per-entity dict resolution on the hot path.  A cached
        array is invalidated by :meth:`retain_entities` (rows reindex)."""
        with self._lock:
            return np.array([self._row_for(e) for e in entities], np.intp)

    def add_rows_at(self, ts_ms: int, rows: np.ndarray, vals: np.ndarray) -> int:
        """Vectorized core of :meth:`add_samples_at`: land ``vals`` (B×M,
        float64) on pre-resolved ``rows`` (from :meth:`rows_for`, duplicates
        not allowed) at one shared timestamp."""
        w = self.window_index(ts_ms)
        with self._lock:
            if self._current_window < 0:
                self._current_window = w
            if w > self._current_window:
                self._roll_to(w)
            oldest = self._current_window - self.num_windows
            if w <= oldest - 1 or w < 0:
                return 0
            slot = w % self._ring
            if self._win_id[slot] != w:
                self._win_id[slot] = w
                self._acc[:, slot, :] = 0.0
                self._count[:, slot] = 0
                self._latest_ts[:, slot] = -1
            acc = self._acc[rows, slot, :]          # fancy index: a copy
            # strategy masks absent from this metric def cost nothing (the
            # selfmon def is a single AVG column — the common batch shape)
            if self._has_max or self._has_latest:
                first = (self._count[rows, slot] == 0)[:, None]
                if self._has_max:
                    upd_max = np.where(first, vals, np.maximum(acc, vals))
                    acc[:, self._is_max] = upd_max[:, self._is_max]
                if self._has_latest:
                    newest = (
                        first | (ts_ms >= self._latest_ts[rows, slot])[:, None]
                    )
                    upd_latest = np.where(newest, vals, acc)
                    acc[:, self._is_latest] = upd_latest[:, self._is_latest]
            if self._has_avg:
                if self._has_max or self._has_latest:
                    acc[:, self._is_avg] += vals[:, self._is_avg]
                else:
                    acc += vals
            self._acc[rows, slot, :] = acc
            self._latest_ts[rows, slot] = np.maximum(
                self._latest_ts[rows, slot], ts_ms
            )
            self._count[rows, slot] += 1
            self._generation += 1
            return len(rows)

    def retain_entities(self, entities: Sequence[E]) -> None:
        """Drop state for entities not in ``entities`` (aggregator retainEntities)."""
        keep = set(entities)
        with self._lock:
            if keep.issuperset(self._entity_index):
                return
            idx = [self._entity_index[e] for e in self._entities if e in keep]
            self._acc = self._acc[idx]
            self._count = self._count[idx]
            self._latest_ts = self._latest_ts[idx]
            self._entities = [e for e in self._entities if e in keep]
            self._entity_index = {e: i for i, e in enumerate(self._entities)}
            self._entity_group = {e: g for e, g in self._entity_group.items() if e in keep}
            self._generation += 1

    def clear(self) -> None:
        with self._lock:
            self._acc[:] = 0
            self._count[:] = 0
            self._latest_ts[:] = -1
            self._win_id[:] = -1
            self._current_window = -1
            self._generation += 1

    # -- aggregation --------------------------------------------------------

    def available_window_ids(self) -> List[int]:
        """Stable (non-current) windows in retention, oldest→newest.

        The range is contiguous: windows that received no samples (never stamped
        into the ring) are still listed — they aggregate as empty, so adjacency in
        the output equals adjacency in time and completeness counts the gaps.
        The range never extends before the first window that ever saw a sample:
        wall-clock start times would otherwise manufacture phantom pre-start
        windows that invalidate every entity until a full ring elapses.
        """
        with self._lock:
            if self._current_window < 0:
                return []
            lo = max(self._first_window, self._current_window - self.num_windows)
            return list(range(lo, self._current_window))

    def aggregate(
        self,
        from_ms: int = 0,
        to_ms: Optional[int] = None,
        entities: Optional[Sequence[E]] = None,
        options: Optional[AggregationOptions] = None,
    ) -> Tuple[ValuesAndExtrapolations, MetricSampleCompleteness]:
        """Aggregate stable windows intersecting ``[from_ms, to_ms]``.

        Returns window-major values with per-window extrapolation codes plus a
        completeness report.  Raises ``NotEnoughValidWindowsError`` when coverage
        requirements are not met (aggregator's NotEnoughValidWindowsException).
        """
        options = options or AggregationOptions()
        with self._lock:
            win_ids = self.available_window_ids()
            if to_ms is not None:
                win_ids = [w for w in win_ids if w * self.window_ms <= to_ms]
            win_ids = [w for w in win_ids if (w + 1) * self.window_ms > from_ms]
            if not win_ids:
                raise NotEnoughValidWindowsError("no stable windows in requested range")

            ents = list(entities) if entities is not None else list(self._entities)
            rows = np.array([self._entity_index.get(e, -1) for e in ents], np.int64)
            slots = np.array([w % self._ring for w in win_ids], np.int64)
            # A slot only holds data for window w if it was stamped with w; windows
            # skipped during rolling (or never written) must aggregate as empty.
            slot_live = self._win_id[slots] == np.array(win_ids)

            m = self.metric_def.size()
            n_e, n_w = len(ents), len(win_ids)
            acc = np.zeros((n_e, n_w, m), np.float64)
            count = np.zeros((n_e, n_w), np.int32)
            present = rows >= 0
            if present.any():
                acc[present] = self._acc[rows[present]][:, slots, :]
                count[present] = self._count[rows[present]][:, slots]
            acc[:, ~slot_live, :] = 0.0
            count[:, ~slot_live] = 0

            values, extrap = self._extrapolate(acc, count)
            completeness = self._completeness(ents, win_ids, extrap, options)

            entity_valid = self._entity_validity(extrap)
            if not options.include_invalid_entities:
                keep = entity_valid
                values, extrap = values[keep], extrap[keep]
                ents = [e for e, k in zip(ents, keep) if k]

            vae = ValuesAndExtrapolations(
                values.astype(np.float32), extrap.astype(np.uint8), win_ids, ents
            )
            return vae, completeness

    # -- internals ----------------------------------------------------------

    def _row_for(self, entity: E) -> int:
        idx = self._entity_index.get(entity)
        if idx is not None:
            return idx
        if len(self._entities) == self._acc.shape[0]:
            grow = self._GROW
            m = self.metric_def.size()
            self._acc = np.concatenate([self._acc, np.zeros((grow, self._ring, m))], 0)
            self._count = np.concatenate([self._count, np.zeros((grow, self._ring), np.int32)], 0)
            self._latest_ts = np.concatenate([self._latest_ts, np.full((grow, self._ring), -1, np.int64)], 0)
        idx = len(self._entities)
        self._entities.append(entity)
        self._entity_index[entity] = idx
        return idx

    def _roll_to(self, new_current: int) -> None:
        """Advance the current window, evicting slots that fall out of history.

        A jump larger than the ring wraps every slot at most once, so work is
        bounded by the ring size regardless of the timestamp gap.
        """
        if self._current_window < 0:
            self._first_window = new_current
        gap = new_current - self._current_window
        if gap >= self._ring:
            self._win_id[:] = -1
            self._acc[:] = 0.0
            self._count[:] = 0
            self._latest_ts[:] = -1
            start = new_current - self._ring + 1
        else:
            start = self._current_window + 1
        for w in range(start, new_current + 1):
            slot = w % self._ring
            self._win_id[slot] = w
            self._acc[:, slot, :] = 0.0
            self._count[:, slot] = 0
            self._latest_ts[:, slot] = -1
        self._current_window = new_current
        self._generation += 1

    def _extrapolate(self, acc: np.ndarray, count: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized value computation + extrapolation over [E, W(, M)] tensors."""
        n_e, n_w, m = acc.shape
        cnt = count[:, :, None].astype(np.float64)
        avg_vals = np.divide(acc, cnt, out=np.zeros_like(acc), where=cnt > 0)
        values = np.where(self._is_avg[None, None, :], avg_vals, acc)

        valid = count >= self.min_samples_per_window
        half_ok = (count >= max(1, self.min_samples_per_window // 2)) & ~valid
        some = (count > 0) & ~valid & ~half_ok

        extrap = np.full((n_e, n_w), int(Extrapolation.NO_VALID_EXTRAPOLATION), np.int32)
        extrap[valid] = int(Extrapolation.NONE)
        extrap[half_ok] = int(Extrapolation.AVG_AVAILABLE)
        extrap[some] = int(Extrapolation.FORCED_INSUFFICIENT)

        # AVG_ADJACENT: empty windows flanked by >=1 usable neighbor borrow the
        # neighbors' average (RawMetricValues adjacent-window extrapolation).
        usable = valid | half_ok | some
        empty = count == 0
        left = np.zeros_like(usable)
        right = np.zeros_like(usable)
        left[:, 1:] = usable[:, :-1]
        right[:, :-1] = usable[:, 1:]
        adj_ok = empty & (left | right)
        if adj_ok.any():
            lv = np.zeros_like(values)
            rv = np.zeros_like(values)
            lv[:, 1:, :] = values[:, :-1, :]
            rv[:, :-1, :] = values[:, 1:, :]
            w_l = left[:, :, None].astype(np.float64)
            w_r = right[:, :, None].astype(np.float64)
            denom = np.maximum(w_l + w_r, 1.0)
            adj_vals = (lv * w_l + rv * w_r) / denom
            values = np.where(adj_ok[:, :, None], adj_vals, values)
            extrap[adj_ok] = int(Extrapolation.AVG_ADJACENT)
        return values, extrap

    def _entity_validity(self, extrap: np.ndarray) -> np.ndarray:
        n_extrapolated = (extrap != int(Extrapolation.NONE)).sum(axis=1)
        has_invalid = (extrap == int(Extrapolation.NO_VALID_EXTRAPOLATION)).any(axis=1)
        return (~has_invalid) & (n_extrapolated <= self.max_allowed_extrapolations)

    def _completeness(
        self,
        ents: List[E],
        win_ids: List[int],
        extrap: np.ndarray,
        options: AggregationOptions,
    ) -> MetricSampleCompleteness:
        n_e = max(1, len(ents))
        window_ok = extrap != int(Extrapolation.NO_VALID_EXTRAPOLATION)
        coverage = window_ok.sum(axis=0) / n_e
        by_window = {w: float(c) for w, c in zip(win_ids, coverage)}
        valid_windows = [w for w, c in by_window.items() if c >= options.min_valid_entity_ratio]

        entity_valid = self._entity_validity(extrap)
        valid_entity_ratio = float(entity_valid.sum()) / n_e

        groups: Dict[Hashable, List[int]] = {}
        for i, e in enumerate(ents):
            groups.setdefault(self._entity_group.get(e, e), []).append(i)
        if groups:
            ok_groups = sum(1 for idx in groups.values() if entity_valid[idx].all())
            group_ratio = ok_groups / len(groups)
        else:
            group_ratio = 0.0

        completeness = MetricSampleCompleteness(
            generation=self._generation,
            valid_entity_ratio=valid_entity_ratio,
            valid_entity_group_ratio=float(group_ratio),
            valid_windows=sorted(valid_windows),
            entity_coverage_by_window=by_window,
        )
        if len(valid_windows) < options.min_valid_windows:
            raise NotEnoughValidWindowsError(
                f"{len(valid_windows)} valid windows < required {options.min_valid_windows}"
            )
        if valid_entity_ratio < options.min_valid_entity_ratio:
            raise NotEnoughValidEntitiesError(
                f"valid entity ratio {valid_entity_ratio:.3f} < "
                f"{options.min_valid_entity_ratio:.3f}"
            )
        if group_ratio < options.min_valid_entity_group_ratio:
            raise NotEnoughValidEntitiesError(
                f"valid entity group ratio {group_ratio:.3f} < "
                f"{options.min_valid_entity_group_ratio:.3f}"
            )
        return completeness


class NotEnoughValidWindowsError(Exception):
    """Aggregation cannot meet window-coverage requirements."""


class NotEnoughValidEntitiesError(Exception):
    """Aggregation cannot meet entity-coverage requirements."""
