"""Follower WAL tailer: one thread, one cursor, one replicated view.

Port of ``cruise_control_tpu/replication/follower.py`` (pure Python, copied whole).

A follower process (``replication.role=follower``) never touches the solver,
the executor, or the WAL write path.  This thread is its whole data plane:
poll the writer's controller journal with :class:`~cruise_control_tpu_torch.core.
journal.JournalTail`, fold each record into the shared
:class:`~cruise_control_tpu_torch.replication.state.ReplicationState`, and keep
the lag gauges honest.  Everything else — HTTP serving, WATCH fan-out,
staleness 503s — reads from the state object this thread feeds.

A tail **reset** (the writer compacted the WAL with ``truncate()``/
``rewrite()``) re-delivers the live records; the state's dedupe-by-version
absorbs the replay, so watchers see nothing.  A torn tail parks the cursor
and retries next poll — the record either completes (writer alive) or seals
into permanence (writer crashed, next writer sealed the leftover), both of
which the cursor already handles.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from cruise_control_tpu_torch.core.journal import JournalTail
from cruise_control_tpu_torch.replication.state import ReplicationState


class FollowerTailer:
    """Background thread tailing ``<journal.dir>/controller`` into a
    :class:`ReplicationState`."""

    def __init__(
        self,
        directory: str,
        state: ReplicationState,
        poll_interval_s: float = 0.05,
    ) -> None:
        self.directory = directory
        self.state = state
        self.poll_interval_s = poll_interval_s
        self.tail = JournalTail(directory)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: last error string (transient I/O races are retried, not raised)
        self.last_error: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._thread = threading.Thread(
            target=self._run, name="replication-tail", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- the poll loop -------------------------------------------------------

    def poll_once(self) -> int:
        """One tail poll applied to the state; returns records applied.
        Public so tests (and the bench) can drive the tail synchronously."""
        from cruise_control_tpu_torch.core.sensors import (
            REGISTRY,
            REPLICATION_APPLIED_COUNTER,
            REPLICATION_RESETS_COUNTER,
            REPLICATION_STALENESS_GAUGE,
        )

        resets_before = self.tail.resets
        records = self.tail.poll()
        if self.tail.resets > resets_before:
            # the writer compacted the WAL under us: the re-delivered
            # records ARE the durable state now — reconcile, don't replay
            self.state.rebase(records)
        else:
            for rec in records:
                self.state.apply(rec)
        self.state.note_poll()
        if records:
            REGISTRY.counter(REPLICATION_APPLIED_COUNTER).inc(len(records))
        if self.tail.resets > resets_before:
            REGISTRY.counter(REPLICATION_RESETS_COUNTER).inc(
                self.tail.resets - resets_before
            )
        REGISTRY.gauge(REPLICATION_STALENESS_GAUGE).set(
            self.state.staleness_ms()
        )
        return len(records)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
                self.last_error = None
            except Exception as e:   # keep tailing through transient races
                self.last_error = f"{type(e).__name__}: {e}"
            self._stop.wait(self.poll_interval_s)
