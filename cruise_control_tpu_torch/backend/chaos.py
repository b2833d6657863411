"""Seeded fault injection for any :class:`ClusterBackend`.

Port of ``cruise_control_tpu/backend/chaos.py`` (pure Python, copied): the
same plans give the same ``fault_log`` in both packages, because
:class:`FaultPlan` draws from the same seeded ``random.Random``.

The reference tests mid-rebalance failure against embedded brokers it can kill
(``CCKafkaIntegrationTestHarness``); this framework's equivalent needs to be
deterministic and dependency-free, so :class:`ChaosBackend` wraps a real
backend and injects faults from a :class:`FaultPlan` — a *recipe*, not a dice
roll: every rule triggers on per-method call counts (or the plan's seeded RNG,
which is itself replayed identically for a given seed and call sequence), so a
failing chaos test reproduces byte-for-byte on re-run.

Supported fault shapes (the chaos matrix):

* ``raise_n_times(method, n)`` — the first *n* calls of ``method`` raise.
* ``raise_every(method, k)`` — every *k*-th call of ``method`` raises.
* ``raise_with_probability(method, p)`` — seeded-RNG coin per call.
* ``latency(method, seconds)`` — injected sleep before the call proceeds.
* ``flap_broker(broker, start, end)`` — the broker reports dead while the
  total southbound call count is in ``[start, end)`` (a flap *during* an
  execution, without touching the inner backend's topology).
* ``stall_reassignments(...)`` — matching reassignments register but never
  complete: they show up in ``list_partition_reassignments`` forever and the
  replica set never changes.  A cancel (``target=None``, Kafka's
  AlterPartitionReassignments-empty-target semantics) clears the stall.
* ``metric_gap(start, end)`` — ``fetch_raw_metrics`` returns nothing for the
  ``[start, end)``-th fetch calls (a reporter-feed outage).
* ``crash_after(method, n)`` — deterministic crash point: the first *n* calls
  of ``method`` succeed, every later one raises
  :class:`~cruise_control_tpu_torch.core.journal.SimulatedCrash` (NOT retryable —
  a crashing process is recovered, not retried).  Paired with
  ``Journal.crash_after_appends``, recovery tests pin the process death at an
  exact backend call / journal append.

Journal-level fault shapes (the replication-plane chaos matrix), applied by
:class:`ChaosJournal` — a :class:`~cruise_control_tpu_torch.core.journal.Journal`
whose *write path* dies at plan-scripted points, leaving the exact on-disk
wreckage each crash shape implies (recovery must digest the wreck, not just
the exception):

* ``torn_tail(after_appends)`` — the next append past the threshold writes
  only a *prefix* of its record (torn mid-record, no newline) and dies: the
  classic power-cut tail that replay's prefix tolerance must absorb.
* ``lose_fsync_suffix(after_appends, lose)`` — the process dies and the last
  ``lose`` appended records *vanish from disk* (the OS never flushed them):
  what an un-fsynced page-cache suffix looks like after the machine dies.
* ``rotation_crash(rotation_no)`` — the *n*-th rotation flushes, fsyncs and
  closes the full segment but dies **before** the atomic rename: a complete
  segment stranded under its ``.open`` name, the race window every reader's
  sealed-name fallback exists for.

Injected errors are :class:`ChaosInjectedError`, a ``ConnectionError``
subclass, so the default :class:`~cruise_control_tpu_torch.core.retry.RetryPolicy`
classifies them as retryable.  Every injected fault is appended to
``ChaosBackend.fault_log`` and ticked on the ``ChaosBackend.faults-injected``
sensor, so tests and a status payload can assert exactly what chaos ran.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.backend.base import (
    ClusterBackend,
    ClusterDescription,
    LogdirInfo,
    PartitionInfo,
    RawMetric,
    ReassignmentInProgress,
    TopicPartition,
)
from cruise_control_tpu_torch.core.journal import Journal, SimulatedCrash, _canonical, _crc
from cruise_control_tpu_torch.core.sensors import CHAOS_FAULTS_COUNTER, REGISTRY

__all__ = [
    "ChaosBackend",
    "ChaosInjectedError",
    "ChaosJournal",
    "FaultPlan",
    "SimulatedCrash",
]


class ChaosInjectedError(ConnectionError):
    """Deterministic injected backend failure (retryable by default policy)."""


@dataclasses.dataclass
class _ErrorRule:
    method: str                       # "*" matches every method
    n_times: int = 0                  # raise on the first n calls (0 = off)
    every: int = 0                    # raise on every k-th call (0 = off)
    probability: float = 0.0          # seeded coin per call (0 = off)
    exc: Optional[Callable[[str], Exception]] = None
    fired: int = 0

    def make_exc(self, method: str, call_no: int) -> Exception:
        if self.exc is not None:
            return self.exc(method)
        return ChaosInjectedError(f"injected fault: {method} (call #{call_no})")


class FaultPlan:
    """A deterministic, seeded recipe of faults; builder methods chain."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self._rng = random.Random(seed)
        self.error_rules: List[_ErrorRule] = []
        self.latency_by_method: Dict[str, float] = {}
        self.stall_all = False
        self.stall_tps: Set[TopicPartition] = set()
        self.stall_budget = 0         # next-N reassigned partitions stall
        self.flaps: List[Tuple[int, int, int]] = []   # (broker, start, end)
        self.metric_gaps: List[Tuple[int, int]] = []  # [start, end) fetch calls
        #: method -> call count after which every call raises SimulatedCrash
        self.crash_points: Dict[str, int] = {}
        # -- journal fault shapes (applied by ChaosJournal) --
        #: appends after which the next one writes a torn prefix and dies
        self.journal_torn_tail_after: Optional[int] = None
        #: (after_appends, lose): die with the last ``lose`` records unflushed
        self.journal_lost_suffix: Optional[Tuple[int, int]] = None
        #: 1-based rotation number that dies between close and rename
        self.journal_rotation_crash: Optional[int] = None

    # -- error rules --------------------------------------------------------

    def raise_n_times(self, method: str, n: int, exc=None) -> "FaultPlan":
        self.error_rules.append(_ErrorRule(method, n_times=n, exc=exc))
        return self

    def raise_every(self, method: str, k: int, exc=None) -> "FaultPlan":
        self.error_rules.append(_ErrorRule(method, every=k, exc=exc))
        return self

    def raise_with_probability(self, method: str, p: float, exc=None) -> "FaultPlan":
        self.error_rules.append(_ErrorRule(method, probability=p, exc=exc))
        return self

    # -- latency / flap / stall / gap ---------------------------------------

    def latency(self, method: str, seconds: float) -> "FaultPlan":
        self.latency_by_method[method] = seconds
        return self

    def flap_broker(self, broker_id: int, start_call: int, end_call: int) -> "FaultPlan":
        """Broker reports dead while total call count is in [start, end)."""
        self.flaps.append((broker_id, start_call, end_call))
        return self

    def stall_reassignments(
        self,
        tps: Optional[Sequence[TopicPartition]] = None,
        count: Optional[int] = None,
    ) -> "FaultPlan":
        """Stall specific partitions, the next ``count`` reassigned ones, or
        (with no arguments) every reassignment."""
        if tps is not None:
            self.stall_tps.update(tps)
        elif count is not None:
            self.stall_budget += count
        else:
            self.stall_all = True
        return self

    def metric_gap(self, start_call: int, end_call: int) -> "FaultPlan":
        self.metric_gaps.append((start_call, end_call))
        return self

    def crash_after(self, method: str, n_calls: int) -> "FaultPlan":
        """The first ``n_calls`` of ``method`` succeed; every later call
        raises :class:`SimulatedCrash` — and keeps raising, because a dead
        process doesn't come back until recovery restarts it.  ``"*"``
        matches every method (total southbound blackout)."""
        self.crash_points[method] = n_calls
        return self

    # -- journal faults (consumed by ChaosJournal) ---------------------------

    def torn_tail(self, after_appends: int) -> "FaultPlan":
        """The append after the first ``after_appends`` writes a torn prefix
        of its record (no newline) and raises :class:`SimulatedCrash`."""
        self.journal_torn_tail_after = after_appends
        return self

    def lose_fsync_suffix(self, after_appends: int, lose: int = 1) -> "FaultPlan":
        """After ``after_appends`` appends the process dies and the last
        ``lose`` records never reach disk (page-cache suffix lost)."""
        self.journal_lost_suffix = (after_appends, lose)
        return self

    def rotation_crash(self, rotation_no: int = 1) -> "FaultPlan":
        """The ``rotation_no``-th segment rotation dies after flush + close
        but *before* the atomic rename: the complete segment is stranded
        under its ``.open`` name."""
        self.journal_rotation_crash = rotation_no
        return self


class ChaosJournal(Journal):
    """A :class:`Journal` whose write path dies at the plan's scripted fault
    points, leaving the on-disk wreckage the module docstring describes.

    Every fault raises :class:`SimulatedCrash` — the test then recovers with
    a *fresh* plain ``Journal`` (or tails the directory from another cursor),
    exactly like a restarted process would.  Faults are logged to
    ``fault_log`` and ticked on the chaos sensor, mirroring
    :class:`ChaosBackend`'s accounting."""

    def __init__(
        self, directory: str, plan: Optional[FaultPlan] = None, **kwargs
    ) -> None:
        self.plan = plan or FaultPlan()
        #: (fault kind, appends-or-rotations count when it fired)
        self.fault_log: List[Tuple[str, int]] = []
        #: rotations attempted by this writer (rotation_crash bookkeeping)
        self.rotations = 0
        super().__init__(directory, **kwargs)

    def _record_fault(self, kind: str, at: int) -> None:
        self.fault_log.append((kind, at))
        REGISTRY.counter(CHAOS_FAULTS_COUNTER).inc()

    def _append_locked(self, record: dict) -> None:
        plan = self.plan
        if (
            plan.journal_torn_tail_after is not None
            and self.appends >= plan.journal_torn_tail_after
        ):
            # write a prefix of the encoded line — torn mid-record, no
            # newline — flush it so the wreck is visible, then die
            payload = _canonical(record)
            line = json.dumps(
                {"c": _crc(payload), "r": record},
                separators=(",", ":"),
                default=str,
            )
            if self._fh is None:
                self._fh = open(self._path(self._segment_idx, True), "a")
                self._records_in_segment = 0
            self._fh.write(line[: max(1, len(line) // 2)])
            self._fh.flush()
            self._record_fault("torn_tail", self.appends)
            raise SimulatedCrash(
                f"journal torn-tail fault after {self.appends} append(s)"
            )
        if (
            plan.journal_lost_suffix is not None
            and self.appends >= plan.journal_lost_suffix[0]
        ):
            lose = plan.journal_lost_suffix[1]
            # the process dies; the OS never flushed the last `lose` lines —
            # emulated by truncating them back out of the .open segment
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
            path = self._path(self._segment_idx, True)
            try:
                with open(path, "rb") as fh:
                    lines = fh.read().splitlines(keepends=True)
                with open(path, "wb") as fh:
                    fh.writelines(lines[: max(0, len(lines) - lose)])
            except FileNotFoundError:
                pass
            self._record_fault("fsync_lost_suffix", self.appends)
            raise SimulatedCrash(
                f"journal fsync-lost fault: last {lose} record(s) lost "
                f"after {self.appends} append(s)"
            )
        super()._append_locked(record)

    def _rotate_locked(self) -> None:
        self.rotations += 1
        if (
            self.plan.journal_rotation_crash is not None
            and self.rotations >= self.plan.journal_rotation_crash
        ):
            # seal-worthy segment: flush, fsync, close — then die before the
            # rename, stranding the complete segment under its .open name
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None
            self._record_fault("rotation_crash", self.rotations)
            raise SimulatedCrash(
                f"journal rotation-race fault at rotation #{self.rotations}"
            )
        super()._rotate_locked()


class ChaosBackend(ClusterBackend):
    """Wraps any backend with the fault plan; unknown attributes (test helpers
    like ``kill_broker``/``admin_log``) delegate to the inner backend."""

    def __init__(self, inner: ClusterBackend, plan: Optional[FaultPlan] = None) -> None:
        self.inner = inner
        self.plan = plan or FaultPlan()
        self._lock = threading.RLock()
        self.calls: Dict[str, int] = {}
        self.total_calls = 0
        #: (method, fault_kind, per-method call index) for every injected fault
        self.fault_log: List[Tuple[str, str, int]] = []
        #: stalled reassignments: tp -> (target, adding, removing)
        self._stalled: Dict[TopicPartition, Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]] = {}

    def __getattr__(self, name: str):
        # fault-plan misses fall through to the inner backend's surface
        return getattr(self.inner, name)

    # -- fault machinery ----------------------------------------------------

    def _record_fault(self, method: str, kind: str, call_no: int) -> None:
        self.fault_log.append((method, kind, call_no))
        REGISTRY.counter(CHAOS_FAULTS_COUNTER).inc()

    def _pre(self, method: str) -> int:
        """Count the call, inject latency, then raise if an error rule fires."""
        with self._lock:
            call_no = self.calls.get(method, 0) + 1
            self.calls[method] = call_no
            self.total_calls += 1
            for key, count in (
                (method, self.calls[method]),
                ("*", self.total_calls),
            ):
                limit = self.plan.crash_points.get(key)
                if limit is not None and count > limit:
                    # crash points outrank every other fault: the process is
                    # dead from here on, nothing else gets to fire
                    self._record_fault(method, "crash", call_no)
                    raise SimulatedCrash(
                        f"injected crash point: {method} (call #{call_no})"
                    )
            sleep_s = self.plan.latency_by_method.get(method, 0.0)
            exc: Optional[Exception] = None
            for rule in self.plan.error_rules:
                if rule.method not in (method, "*"):
                    continue
                hit = False
                if rule.n_times and rule.fired < rule.n_times:
                    hit = True
                elif rule.every and call_no % rule.every == 0:
                    hit = True
                elif rule.probability and self.plan._rng.random() < rule.probability:
                    hit = True
                if hit:
                    rule.fired += 1
                    exc = rule.make_exc(method, call_no)
                    self._record_fault(method, "error", call_no)
                    break
            if sleep_s > 0:
                self._record_fault(method, "latency", call_no)
        if sleep_s > 0:
            time.sleep(sleep_s)
        if exc is not None:
            raise exc
        return call_no

    def _flapped_down(self) -> Set[int]:
        with self._lock:
            now = self.total_calls
            down = {b for b, start, end in self.plan.flaps if start <= now < end}
            if down:
                self._record_fault("describe_cluster", "flap", now)
            return down

    # -- metadata -----------------------------------------------------------

    def describe_cluster(self) -> ClusterDescription:
        self._pre("describe_cluster")
        desc = self.inner.describe_cluster()
        down = self._flapped_down()
        if not down:
            return desc
        brokers = {
            b: (dataclasses.replace(i, alive=False) if b in down else i)
            for b, i in desc.brokers.items()
        }
        alive = [b for b, i in brokers.items() if i.alive]
        return ClusterDescription(brokers=brokers, controller=min(alive) if alive else None)

    def describe_topics(self) -> Dict[str, List[PartitionInfo]]:
        self._pre("describe_topics")
        return self.inner.describe_topics()

    def describe_logdirs(self) -> Dict[int, Dict[str, LogdirInfo]]:
        self._pre("describe_logdirs")
        return self.inner.describe_logdirs()

    # -- metric feed --------------------------------------------------------

    def fetch_raw_metrics(self, from_ms: int, to_ms: int) -> List[RawMetric]:
        call_no = self._pre("fetch_raw_metrics")
        for start, end in self.plan.metric_gaps:
            if start <= call_no - 1 < end:
                self._record_fault("fetch_raw_metrics", "metric_gap", call_no)
                return []
        return self.inner.fetch_raw_metrics(from_ms, to_ms)

    # -- admin operations ---------------------------------------------------

    def _should_stall(self, tp: TopicPartition) -> bool:
        if self.plan.stall_all or tp in self.plan.stall_tps:
            return True
        if self.plan.stall_budget > 0:
            self.plan.stall_budget -= 1
            return True
        return False

    def alter_partition_reassignments(
        self, reassignments: Mapping[TopicPartition, Optional[Sequence[int]]]
    ) -> None:
        call_no = self._pre("alter_partition_reassignments")
        with self._lock:
            cancels = {tp for tp, target in reassignments.items() if target is None}
            for tp in cancels & set(self._stalled):
                del self._stalled[tp]
            conflicts = [
                tp for tp in reassignments
                if tp in self._stalled and tp not in cancels
            ]
            if conflicts:
                raise ReassignmentInProgress(f"{conflicts[0]} already reassigning (stalled)")
            stalled = {
                tp: target
                for tp, target in reassignments.items()
                if target is not None and self._should_stall(tp)
            }
            if stalled:
                current: Dict[TopicPartition, Tuple[int, ...]] = {}
                for infos in self.inner.describe_topics().values():
                    for i in infos:
                        if i.tp in stalled:
                            current[i.tp] = i.replicas
                for tp, target in stalled.items():
                    old = set(current.get(tp, ()))
                    new = set(target)
                    self._stalled[tp] = (
                        tuple(target),
                        tuple(sorted(new - old)),
                        tuple(sorted(old - new)),
                    )
                    self._record_fault("alter_partition_reassignments", "stall", call_no)
        passthrough = {
            tp: target for tp, target in reassignments.items() if tp not in stalled
        } if stalled else dict(reassignments)
        if passthrough:
            self.inner.alter_partition_reassignments(passthrough)

    def list_partition_reassignments(self) -> Dict[TopicPartition, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
        self._pre("list_partition_reassignments")
        out = dict(self.inner.list_partition_reassignments())
        with self._lock:
            out.update({tp: (adding, removing) for tp, (_, adding, removing) in self._stalled.items()})
        return out

    def list_ongoing_reassignments(self) -> Dict[TopicPartition, Tuple[int, ...]]:
        self._pre("list_ongoing_reassignments")
        out = dict(self.inner.list_ongoing_reassignments())
        with self._lock:
            out.update({tp: target for tp, (target, _, _) in self._stalled.items()})
        return out

    def elect_leaders(self, partitions: Sequence[TopicPartition]) -> None:
        self._pre("elect_leaders")
        self.inner.elect_leaders(partitions)

    def alter_replica_logdirs(self, moves: Mapping[Tuple[TopicPartition, int], str]) -> None:
        self._pre("alter_replica_logdirs")
        self.inner.alter_replica_logdirs(moves)

    # -- throttle / config management ---------------------------------------

    def set_replication_throttles(
        self, rate_bytes: float, tp_by_broker: Mapping[int, Sequence[TopicPartition]]
    ) -> None:
        self._pre("set_replication_throttles")
        self.inner.set_replication_throttles(rate_bytes, tp_by_broker)

    def clear_replication_throttles(self) -> None:
        self._pre("clear_replication_throttles")
        self.inner.clear_replication_throttles()

    # -- introspection ------------------------------------------------------

    @property
    def stalled_reassignments(self) -> Dict[TopicPartition, Tuple[int, ...]]:
        with self._lock:
            return {tp: target for tp, (target, _, _) in self._stalled.items()}

    def faults_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, kind, _ in self.fault_log:
            out[kind] = out.get(kind, 0) + 1
        return out
