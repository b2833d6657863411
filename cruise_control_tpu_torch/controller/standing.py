"""Durable standing proposal set: the controller's published output.

Port of ``cruise_control_tpu/controller/standing.py`` (copied whole; the
records are the JAX package's, byte for byte, so either package recovers the
other's journal).  The reference's proposal lifecycle is request-scoped: a runnable computes
proposals, the executor consumes them, nothing survives either.  The
continuous controller inverts that — each tick publishes a *versioned standing
proposal set* that outlives the tick: the executor drains it under the
existing policy knobs, a newer tick supersedes it, and a crash resumes it.

Durability rides the write-ahead journal
(:class:`~cruise_control_tpu_torch.core.journal.Journal`, own ``journal.dir``
namespace ``<dir>/controller``) with three record types:

* ``published``  — full proposal wire form (the executor-journal encoding) +
  version, trigger, drift score.  Written **before** the in-memory set is
  swapped (write-ahead: a refused append leaves the old set standing, so
  memory and journal never diverge).
* ``invalidated`` — an explicit supersession/abandonment marker.  Replay also
  supersedes implicitly (newest published version wins), so the publish order
  is crash-safe: publish new → invalidate old; a crash between the two
  resumes the NEW set.
* ``drained`` — the executor consumed the set; the journal is then truncated
  (the standing set is recovery state, not an audit log — the flight
  recorder is the audit surface), keeping the WAL bounded by one set.

:meth:`ControllerJournal.recover` replays to the current standing set: the
highest-version ``published`` record with no ``invalidated``/``drained``
record, exactly what ``Executor.recover()``-style startup resumes instead of
cold-starting the loop.

Writer fencing (the replication plane)
--------------------------------------

With follower processes tailing this WAL, exactly one process may mutate it.
Ownership is an **epoch**: a monotonically increasing integer held in an
atomic sidecar file (``<dir>/epoch``, written via temp-file + ``os.replace``)
and journaled as a fourth record type, ``epoch``, write-ahead of any
mutation under the new epoch.  The contract:

* :meth:`ControllerJournal.fence` claims ownership: it refuses to move the
  sidecar backwards, then journals ``{"type": "epoch", "epoch": N}`` so
  followers learn the regime change through the same tail they learn
  everything else from.
* Every mutation (``published``/``invalidated``/``drained``) first re-reads
  the sidecar; if some other process fenced a *higher* epoch since, the
  append is refused with :class:`FencedEpochError` — the stale writer's
  write-ahead fails before memory and journal can diverge, so a
  half-deposed writer can never double-publish.
* A restarted writer (or a promoted follower) recovers the newest epoch
  from the sidecar/records and fences ``epoch + 1`` — its own old epoch is
  thereby fenced too, which makes restart and promotion the same code path.

``epoch`` records carry no version and never supersede proposal state; they
exist so replay and tailing followers can stamp reads with the epoch they
are current to.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Tuple

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.core.journal import Journal
from cruise_control_tpu_torch.executor.journal import (
    proposal_from_record,
    proposal_to_record,
)


class FencedEpochError(RuntimeError):
    """A stale-epoch writer tried to mutate the controller WAL (or to fence
    backwards).  The holder of the newer epoch owns the write path now."""

    def __init__(self, message: str, epoch: int, current: int) -> None:
        super().__init__(message)
        #: the epoch the refused writer was operating under
        self.epoch = epoch
        #: the newer epoch that fenced it
        self.current = current


@dataclasses.dataclass
class StandingProposalSet:
    """One published, versioned, durable proposal set."""

    version: int
    created_ms: int
    #: what caused the publish: "drift" | "cadence" | "forced"
    trigger: str
    #: drift score at publish time (violation-count delta vs the last solve)
    drift: float
    proposals: List[ExecutionProposal]
    #: wall seconds from the triggering load-shift delta to this publish
    #: (None when the tick was cadence/forced with no pending shift)
    reaction_s: Optional[float] = None
    #: writer epoch this set was published under (0 = pre-fencing journal)
    epoch: int = 0

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "createdMs": self.created_ms,
            "trigger": self.trigger,
            "drift": self.drift,
            "numProposals": len(self.proposals),
            "reactionS": self.reaction_s,
            "epoch": self.epoch,
        }


class ControllerJournal:
    """Typed record layer over one :class:`Journal` directory (see module
    docstring for the record lifecycle and the fencing contract)."""

    #: sidecar filename holding the current epoch (survives ``truncate()``,
    #: which only removes ``segment-*`` files)
    FENCE_FILE = "epoch"

    def __init__(self, journal: Journal) -> None:
        self.journal = journal
        #: the epoch this process mutates under (0 until fenced/recovered)
        self.epoch = 0
        #: optional callback invoked with each successfully appended record
        #: dict — the writer-side watch feed, fed by the exact bytes
        #: followers will tail (same record, same application order)
        self.listener: Optional[Callable[[dict], None]] = None

    @staticmethod
    def _now_ms() -> int:
        return int(time.time() * 1000)

    # -- fencing -------------------------------------------------------------

    def _fence_path(self) -> str:
        return os.path.join(self.journal.directory, self.FENCE_FILE)

    def read_fence(self) -> int:
        """The epoch on disk (0 when the journal has never been fenced)."""
        try:
            with open(self._fence_path()) as fh:
                return int(fh.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def fence(self, epoch: int) -> None:
        """Claim the write path at ``epoch``: refuse to move backwards, then
        persist the sidecar atomically and journal the regime change.

        A restarted writer or a promoted follower calls this with
        ``recovered_epoch + 1`` — which fences every older holder including
        the caller's own previous incarnation."""
        current = self.read_fence()
        if epoch < current:
            raise FencedEpochError(
                f"cannot fence epoch {epoch}: epoch {current} already holds "
                "the write path",
                epoch=epoch,
                current=current,
            )
        tmp = self._fence_path() + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(str(epoch))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._fence_path())
        self.epoch = epoch
        self._append(
            {
                "type": "epoch",
                "epoch": epoch,
                "ts_ms": self._now_ms(),
            },
            check_fence=False,
        )

    def _append(self, record: dict, check_fence: bool = True) -> None:
        """Fence-checked append + listener fan-out.  The sidecar re-read is
        the cross-process refusal point: a writer deposed since its last
        append fails here, *before* the WAL (and therefore every follower)
        can see a stale-regime record."""
        if check_fence:
            current = self.read_fence()
            if current > self.epoch:
                from cruise_control_tpu_torch.core.sensors import (
                    REGISTRY,
                    REPLICATION_FENCE_REFUSALS_COUNTER,
                )

                REGISTRY.counter(REPLICATION_FENCE_REFUSALS_COUNTER).inc()
                raise FencedEpochError(
                    f"append refused: writer epoch {self.epoch} fenced by "
                    f"epoch {current}",
                    epoch=self.epoch,
                    current=current,
                )
        self.journal.append(record)
        if self.listener is not None:
            try:
                self.listener(dict(record))
            except Exception:
                pass

    # -- write side ----------------------------------------------------------

    def published(self, standing: StandingProposalSet) -> None:
        """Write-ahead of the in-memory swap: raises on a refused append
        (I/O failure or a newer epoch holding the fence)."""
        standing.epoch = self.epoch
        self._append(
            {
                "type": "published",
                "version": standing.version,
                "created_ms": standing.created_ms,
                "trigger": standing.trigger,
                "drift": standing.drift,
                "reaction_s": standing.reaction_s,
                "epoch": self.epoch,
                "proposals": [proposal_to_record(p) for p in standing.proposals],
                "ts_ms": self._now_ms(),
            }
        )

    def invalidated(self, version: int, reason: str) -> None:
        """Best-effort supersession marker (replay supersedes implicitly via
        newest-version-wins, so a failed append here loses nothing)."""
        try:
            self._append(
                {
                    "type": "invalidated",
                    "version": version,
                    "reason": reason,
                    "epoch": self.epoch,
                    "ts_ms": self._now_ms(),
                }
            )
        except Exception:
            pass

    def drained(self, version: int, summary=None) -> None:
        """The executor consumed version ``version``; compact the WAL —
        nothing journaled is live state once the set is drained."""
        try:
            self._append(
                {
                    "type": "drained",
                    "version": version,
                    "execution_id": getattr(summary, "execution_id", None),
                    "completed": getattr(summary, "completed", None),
                    "dead": getattr(summary, "dead", None),
                    "epoch": self.epoch,
                    "ts_ms": self._now_ms(),
                }
            )
            self.journal.truncate()
        except Exception:
            pass

    def rewrite(self, standing: Optional[StandingProposalSet]) -> None:
        """Compact the WAL to exactly the current standing set (or empty).

        Superseded ``published``/``invalidated`` records are dead state the
        moment a newer version lands, but ``truncate()`` otherwise only runs
        on drain — which never happens with ``controller.execute.enable``
        off, so a long-running publisher would grow the WAL without bound.
        Callers compact right after a successful publish (and at recovery,
        bounding restart-to-restart growth).  The crash window between the
        truncate and the re-append can lose the set — the same class of
        window the user-task WAL's startup rewrite accepts; the at-risk
        record here is seconds old and superseded data, never history."""
        self.journal.truncate()
        if standing is not None:
            self.published(standing)

    def close(self) -> None:
        self.journal.close()

    # -- replay side ---------------------------------------------------------

    def recover(self) -> Tuple[Optional[StandingProposalSet], int, int, int]:
        """(standing set or None, max version seen, records replayed, epoch).

        The standing set is the highest-version ``published`` record without
        an ``invalidated``/``drained`` record — the exact set a crashed
        controller was holding, resumed instead of cold-starting.  The epoch
        is the newest regime observed across the sidecar file, ``epoch``
        records, and per-record stamps (the sidecar normally wins; the
        journaled stamps cover a sidecar lost to a partial copy).  The
        recovered epoch is installed on ``self`` so a caller that does not
        immediately :meth:`fence` still refuses writes against a newer
        holder."""
        records = self.journal.replay()
        published = {}
        dead = set()
        max_version = 0
        epoch = self.read_fence()
        for rec in records:
            epoch = max(epoch, int(rec.get("epoch", 0) or 0))
            rtype = rec.get("type")
            if rtype == "epoch":
                continue
            v = int(rec.get("version", 0))
            max_version = max(max_version, v)
            if rtype == "published":
                published[v] = rec
            elif rtype in ("invalidated", "drained"):
                dead.add(v)
        self.epoch = epoch
        live = [v for v in published if v not in dead]
        if not live:
            return None, max_version, len(records), epoch
        v = max(live)
        rec = published[v]
        standing = StandingProposalSet(
            version=v,
            created_ms=int(rec.get("created_ms", 0)),
            trigger=str(rec.get("trigger", "recovered")),
            drift=float(rec.get("drift", 0.0)),
            proposals=[proposal_from_record(d) for d in rec.get("proposals", [])],
            reaction_s=rec.get("reaction_s"),
            epoch=int(rec.get("epoch", 0) or 0),
        )
        return standing, max_version, len(records), epoch
