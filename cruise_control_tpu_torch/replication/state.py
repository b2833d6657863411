"""Replicated view of the standing proposal set + watch delta fan-out.

Port of ``cruise_control_tpu/replication/state.py`` (pure Python, copied whole).

One :class:`ReplicationState` lives in every serving process:

* in a **follower** it is fed by :class:`~cruise_control_tpu_torch.replication.
  follower.FollowerTailer` applying controller-WAL records in tail order;
* in the **writer** it is fed by the ``ControllerJournal.listener`` hook with
  the exact same record dicts, in the exact same order they hit the WAL —
  one application code path, two transports.

From the applied records it maintains the current ``(set_version, epoch)``
pair, the decoded standing set (what degraded reads serve), and a bounded,
sequence-numbered **delta log** that WATCH long-polls drain:

``{"seq": n, "kind": "published"|"superseded"|"drained"|"epoch",
   "version": v, "epoch": e, "tsMs": t, ...}``

Watch clients hold a cursor (``since`` = last seq seen) and re-arm; a cursor
that has fallen off the ring (or a WAL truncation reset) gets
``resync=true`` plus a synthetic ``published`` delta of the current set, so
a slow watcher converges instead of erroring.  Two invariants the failover
drill leans on:

* **no version regression** — a ``published`` record with a version at or
  below the current one is applied idempotently (no delta, no state change
  beyond epoch bookkeeping).  WAL compaction re-delivers the live set after
  a truncate; dedupe-by-version makes that invisible to watchers.
* **staleness is explicit** — every read is stamped with
  ``{setVersion, epoch, stalenessMs, degraded}``; past the lag bound the
  caller answers 503 + Retry-After instead of silently-stale data.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from cruise_control_tpu_torch.controller.standing import StandingProposalSet
from cruise_control_tpu_torch.executor.journal import proposal_from_record


def _now_ms() -> int:
    return int(time.time() * 1000)


class ReplicationState:
    """Thread-safe replicated standing-set view + watch hub (see module
    docstring).  ``writer`` mode reports zero tail staleness — the feed is
    the in-process journal listener, not a polled WAL."""

    def __init__(self, writer: bool = False, ring_size: int = 256) -> None:
        self.writer = writer
        self.ring_size = ring_size
        self._cv = threading.Condition()
        self.standing: Optional[StandingProposalSet] = None
        self.set_version = 0
        self.epoch = 0
        #: next delta sequence number (first delta gets seq 1)
        self._seq = 0
        #: (seq, delta) ring, oldest first
        self._deltas: List[dict] = []
        #: wall ms of the last *applied* record — writer liveness signal
        self.last_activity_ms = _now_ms()
        #: wall ms of the last successful tail poll — follower lag signal
        self.last_poll_ms = _now_ms()
        #: records applied / watch deltas emitted (mirrored to sensors by
        #: the follower thread; kept here so the writer path counts too)
        self.applied = 0

    # -- feed side (tailer thread / writer journal listener) -----------------

    def apply(self, record: dict) -> None:
        """Fold one controller-WAL record into the view (idempotent: version
        regressions and duplicate epochs are absorbed without a delta)."""
        rtype = record.get("type")
        with self._cv:
            self.last_activity_ms = _now_ms()
            self.applied += 1
            if rtype == "epoch":
                epoch = int(record.get("epoch", 0) or 0)
                if epoch > self.epoch:
                    self.epoch = epoch
                    self._emit(
                        {"kind": "epoch", "version": self.set_version,
                         "epoch": epoch}
                    )
            elif rtype == "published":
                self.epoch = max(self.epoch, int(record.get("epoch", 0) or 0))
                version = int(record.get("version", 0))
                if version <= self.set_version:
                    return   # re-delivery (compaction/tail reset): no-op
                superseded = self.set_version
                self.standing = StandingProposalSet(
                    version=version,
                    created_ms=int(record.get("created_ms", 0)),
                    trigger=str(record.get("trigger", "replicated")),
                    drift=float(record.get("drift", 0.0)),
                    proposals=[
                        proposal_from_record(d)
                        for d in record.get("proposals", [])
                    ],
                    reaction_s=record.get("reaction_s"),
                    epoch=int(record.get("epoch", 0) or 0),
                )
                self.set_version = version
                delta = {
                    "kind": "published", "version": version,
                    "epoch": self.epoch,
                    "numProposals": len(self.standing.proposals),
                    "trigger": self.standing.trigger,
                    "drift": self.standing.drift,
                }
                if superseded:
                    delta["superseded"] = superseded
                self._emit(delta)
            elif rtype == "invalidated":
                self.epoch = max(self.epoch, int(record.get("epoch", 0) or 0))
                version = int(record.get("version", 0))
                if version >= self.set_version and self.standing is not None:
                    # invalidated without a successor: the set is withdrawn
                    self.standing = None
                    self._emit(
                        {"kind": "superseded", "version": version,
                         "epoch": self.epoch,
                         "reason": record.get("reason")}
                    )
                # an invalidate of an older version is implicit in the
                # published delta that superseded it — no separate event
            elif rtype == "drained":
                self.epoch = max(self.epoch, int(record.get("epoch", 0) or 0))
                version = int(record.get("version", 0))
                if version >= self.set_version and self.standing is not None:
                    self.standing = None
                    self._emit(
                        {"kind": "drained", "version": version,
                         "epoch": self.epoch,
                         "completed": record.get("completed")}
                    )

    def rebase(self, records: List[dict]) -> None:
        """Reconcile after a tail **reset** (the writer compacted the WAL).

        The re-delivered records are the *entire* durable state now — replay
        them recover()-style (newest published version not invalidated/
        drained wins) and reconcile against the in-memory view:

        * recovered version above ours → normal publish (the common
          rewrite-compaction case lands here or dedupes below);
        * same version → already current, absorb silently;
        * nothing live (``drained()`` truncated before our poll saw the
          drain record, or the WAL was rewritten empty) → the set is gone:
          emit a ``drained`` delta and clear, because an empty WAL is
          exactly what a recovering process would serve;
        * recovered version *below* ours → a fresh WAL regime (operator
          wiped the directory): serve it, but watchers get a resync-shaped
          ``published`` delta rather than a silent regression.
        """
        published: Dict[int, dict] = {}
        dead = set()
        epoch = 0
        for rec in records:
            epoch = max(epoch, int(rec.get("epoch", 0) or 0))
            rtype = rec.get("type")
            if rtype == "epoch":
                continue
            v = int(rec.get("version", 0))
            if rtype == "published":
                published[v] = rec
            elif rtype in ("invalidated", "drained"):
                dead.add(v)
        live = [v for v in published if v not in dead]
        with self._cv:
            self.last_activity_ms = _now_ms()
            self.applied += len(records)
            if epoch > self.epoch:
                self.epoch = epoch
                self._emit(
                    {"kind": "epoch", "version": self.set_version,
                     "epoch": epoch}
                )
            if live:
                v = max(live)
                if self.standing is not None and self.standing.version == v:
                    # compaction re-delivered what we already hold (compare
                    # against the HELD set: after a fresh-WAL regime the
                    # monotonic set_version stamp sits above it)
                    return
                rec = published[v]
                self.standing = StandingProposalSet(
                    version=v,
                    created_ms=int(rec.get("created_ms", 0)),
                    trigger=str(rec.get("trigger", "replicated")),
                    drift=float(rec.get("drift", 0.0)),
                    proposals=[
                        proposal_from_record(d)
                        for d in rec.get("proposals", [])
                    ],
                    reaction_s=rec.get("reaction_s"),
                    epoch=int(rec.get("epoch", 0) or 0),
                )
                self.set_version = max(self.set_version, v)
                self._emit(
                    {"kind": "published", "version": v, "epoch": self.epoch,
                     "numProposals": len(self.standing.proposals),
                     "trigger": self.standing.trigger,
                     "drift": self.standing.drift}
                )
            elif self.standing is not None:
                self._emit(
                    {"kind": "drained", "version": self.set_version,
                     "epoch": self.epoch}
                )
                self.standing = None

    def note_poll(self) -> None:
        """A tail poll completed (records or not): the follower is keeping
        up with the WAL as it exists on disk."""
        with self._cv:
            self.last_poll_ms = _now_ms()

    def _emit(self, delta: dict) -> None:
        # under self._cv
        self._seq += 1
        delta["seq"] = self._seq
        delta["tsMs"] = _now_ms()
        self._deltas.append(delta)
        if len(self._deltas) > self.ring_size:
            del self._deltas[: len(self._deltas) - self.ring_size]
        from cruise_control_tpu_torch.core.sensors import (
            REGISTRY,
            REPLICATION_DELTAS_COUNTER,
        )

        REGISTRY.counter(REPLICATION_DELTAS_COUNTER).inc()
        self._cv.notify_all()

    # -- read side (HTTP handlers) -------------------------------------------

    @property
    def seq(self) -> int:
        return self._seq

    def staleness_ms(self) -> int:
        """How stale this process's view may be.  The writer applies its own
        appends synchronously — zero by construction.  A follower's bound is
        the age of its last successful tail poll: the WAL may have grown
        since, but no further back than this."""
        if self.writer:
            return 0
        return max(0, _now_ms() - self.last_poll_ms)

    def degraded_ms(self) -> int:
        """Milliseconds since the last applied record — writer-liveness
        proxy used for the degraded=true stamp."""
        return max(0, _now_ms() - self.last_activity_ms)

    def stamp(self, degraded_after_ms: Optional[int] = None) -> Dict[str, object]:
        """The per-read replication stamp: ``{setVersion, epoch,
        stalenessMs, degraded, role}``."""
        with self._cv:
            degraded = False
            if not self.writer and degraded_after_ms is not None:
                degraded = self.degraded_ms() > degraded_after_ms
            return {
                "setVersion": self.set_version,
                "epoch": self.epoch,
                "stalenessMs": self.staleness_ms(),
                "degraded": degraded,
                "role": "writer" if self.writer else "follower",
            }

    def snapshot_delta(self) -> dict:
        """Synthetic ``published`` delta of the current set — what a
        resyncing watcher receives instead of the deltas it missed."""
        with self._cv:
            d = {
                "seq": self._seq,
                "kind": "published",
                "version": self.set_version,
                "epoch": self.epoch,
                "tsMs": _now_ms(),
            }
            if self.standing is not None:
                d["numProposals"] = len(self.standing.proposals)
                d["trigger"] = self.standing.trigger
                d["drift"] = self.standing.drift
            return d

    def watch(
        self, since: int, timeout_s: float
    ) -> Tuple[List[dict], int, bool]:
        """Long-poll: block until a delta with seq > ``since`` exists (or
        timeout), then return ``(deltas, next_since, resync)``.

        ``resync=True`` means ``since`` predates the ring (watcher too slow,
        or the WAL was compacted past it): the returned single delta is a
        snapshot of the current set and the watcher continues from
        ``next_since`` — convergent, never an error."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cv:
            while True:
                if since > self._seq:
                    # cursor from a previous incarnation (follower restart
                    # resets seq): resync immediately rather than stalling
                    return [self.snapshot_delta()], self._seq, True
                if self._seq > since:
                    oldest = self._seq - len(self._deltas) + 1 if self._deltas else self._seq + 1
                    if since + 1 < oldest:
                        return [self.snapshot_delta()], self._seq, True
                    pending = [d for d in self._deltas if d["seq"] > since]
                    return list(pending), self._seq, False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], self._seq, False
                self._cv.wait(remaining)
