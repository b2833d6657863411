"""Generic append-only write-ahead journal with crash-safe replay.

Port of ``cruise_control_tpu/core/journal.py`` (``SimulatedCrash``,
``JournalReplay``, ``Journal``), with the same on-disk format: a journal
either package wrote replays in the other.  Newline-delimited JSON records,
each wrapped in a CRC-32 envelope, written to numbered segment files under
one directory.

Write path:

* The active segment is ``segment-NNNNNN.jsonl.open`` -- records append in
  place (a crash mid-append leaves a truncated tail, which replay tolerates).
* Rotation is **atomic**: when the segment reaches ``max_segment_records`` it
  is flushed, optionally fsynced, closed, and renamed to
  ``segment-NNNNNN.jsonl`` -- sealed segments are complete by construction
  (rename is atomic on POSIX), so a reader never sees a half-sealed file.
* A writer that opens a directory with a leftover ``.open`` segment (the
  previous process crashed before rotating) seals it and starts a fresh one.
* ``fsync`` policy: ``"always"`` (fsync after every append), ``"rotate"``
  (fsync at rotation/close; the default), ``"never"`` (OS buffering only).

Replay path (:meth:`Journal.replay`): segments in index order; within each
segment the valid **prefix** is returned and everything from the first
undecodable or checksum-failing line onward is skipped and counted (past a
corruption point, "valid-looking" lines may be interleaved fragments; a
recovery pass must not resurrect them as facts).  Segment boundaries are
trust boundaries: a later *sealed* segment was written and atomically
renamed after the corrupt one, so replay resumes there.  Lines that parse as
JSON but lack the CRC envelope are returned as-is (legacy JSONL data stays
replayable).

Crash simulation: ``crash_after_appends`` makes every append past the first
N raise :class:`SimulatedCrash` *before* writing -- the journal then looks
exactly like the process died between the state change and its journal
write.

Live tailing (:meth:`Journal.tail` / :class:`JournalTail`): a follower —
usually another *process* -- holds a cursor ``(segment index, byte offset)``
and polls for records appended since the last poll, following sealed segments
and the active ``.open`` segment.  The cursor survives the two races a live
WAL throws at a reader:

* **rotation** -- ``os.replace`` keeps the inode, so a segment sealed between
  the directory listing and the ``open()`` is re-opened under its final name
  at the same offset; nothing is missed or double-read.
* **torn tails** -- an unterminated (or not-yet-fully-flushed) last line in
  the ``.open`` segment is *pending*, not corrupt: the cursor parks before it
  and retries next poll.  Corruption becomes permanent only once the segment
  is sealed, where the standard per-segment prefix tolerance applies.

A writer-side ``truncate()``/``rewrite()`` compaction resets the cursor to
the new segment 0 (counted in ``resets``); tail consumers must therefore be
idempotent against re-delivery -- the replication layer dedupes by version.
The cursor reads either package's journal: the on-disk format is one.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import List, Optional, Tuple


class SimulatedCrash(RuntimeError):
    """Deterministic injected process death (chaos crash-point faults).

    Deliberately NOT a ``ConnectionError``: the retry policy must classify it
    as fatal — a crashing process does not get retried, it gets recovered."""


class JournalReplay(List[dict]):
    """``replay``'s result: the recovered records plus replay accounting."""

    #: non-blank lines abandoned from the first corrupt one per segment
    skipped: int = 0
    #: segment files visited
    segments: int = 0


def _canonical(record: dict) -> str:
    return json.dumps(record, sort_keys=True, separators=(",", ":"), default=str)


def _crc(payload: str) -> str:
    return f"{zlib.crc32(payload.encode()) & 0xFFFFFFFF:08x}"


def _segment_index(name: str) -> int:
    return int(name.split(".")[0].split("-")[1])


def _list_segments(directory: str) -> List[str]:
    """Segment file names in index order, deduped by index.

    A POSIX ``readdir`` racing an ``os.replace`` rename may observe a segment
    under its ``.open`` name, its sealed name, or (in theory) both — never
    trust the raw listing to be one-name-per-segment.  When both names show,
    the sealed one wins: it is the same inode, complete by construction."""
    by_idx: dict = {}
    for f in os.listdir(directory):
        if not f.startswith("segment-"):
            continue
        if f.endswith(".jsonl"):
            by_idx[_segment_index(f)] = f
        elif f.endswith(".jsonl" + Journal.OPEN_SUFFIX):
            by_idx.setdefault(_segment_index(f), f)
    return [by_idx[i] for i in sorted(by_idx)]


class Journal:
    """Append-only checksummed WAL over numbered segment files."""

    OPEN_SUFFIX = ".open"

    def __init__(
        self,
        directory: str,
        max_segment_records: int = 10_000,
        fsync: str = "rotate",
    ) -> None:
        if fsync not in ("always", "rotate", "never"):
            raise ValueError(f"fsync must be always|rotate|never, got {fsync!r}")
        self.directory = directory
        self.max_segment_records = max_segment_records
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh = None
        self._records_in_segment = 0
        #: total successful appends this process (crash-point bookkeeping)
        self.appends = 0
        #: test hook: appends past this count raise SimulatedCrash BEFORE
        #: writing (None = disabled) — "die after the Nth journal append"
        self.crash_after_appends: Optional[int] = None
        os.makedirs(directory, exist_ok=True)
        self._seal_leftovers()
        self._segment_idx = self._next_segment_index()

    # -- segment bookkeeping -------------------------------------------------

    def _segment_files(self) -> List[str]:
        return _list_segments(self.directory)

    def _next_segment_index(self) -> int:
        files = self._segment_files()
        if not files:
            return 0
        return int(files[-1].split(".")[0].split("-")[1]) + 1

    def _seal_leftovers(self) -> None:
        """A crashed writer leaves its active segment ``.open``; seal it so
        this writer's fresh segment gets the next index and replay order
        stays by-index.  The truncated tail (if any) stays in the sealed
        file — replay's prefix tolerance handles it."""
        for f in os.listdir(self.directory):
            if f.startswith("segment-") and f.endswith(".jsonl" + self.OPEN_SUFFIX):
                final = f[: -len(self.OPEN_SUFFIX)]
                os.replace(
                    os.path.join(self.directory, f),
                    os.path.join(self.directory, final),
                )

    def _path(self, idx: int, open_segment: bool) -> str:
        name = f"segment-{idx:06d}.jsonl"
        if open_segment:
            name += self.OPEN_SUFFIX
        return os.path.join(self.directory, name)

    # -- write path ----------------------------------------------------------

    def append(self, record: dict) -> None:
        """Write one record (envelope: ``{"c": crc32, "r": record}``).

        Raises on I/O failure — a WAL that silently drops records is worse
        than no WAL (callers that only *prefer* durability wrap the call)."""
        from cruise_control_tpu_torch.core.sensors import JOURNAL_APPENDS_COUNTER, REGISTRY

        with self._lock:
            self._append_locked(record)
            self._flush_locked()
        REGISTRY.counter(JOURNAL_APPENDS_COUNTER).inc()

    def append_many(self, records) -> int:
        """Batch append under one lock and one flush/fsync — the hot
        sample-store path pays a syscall per *batch*, not per record.
        Durability granularity is the call (``fsync="always"`` syncs once,
        after the whole batch).  Returns the number of records written."""
        from cruise_control_tpu_torch.core.sensors import JOURNAL_APPENDS_COUNTER, REGISTRY

        n = 0
        with self._lock:
            for record in records:
                self._append_locked(record)
                n += 1
            self._flush_locked()
        if n:
            REGISTRY.counter(JOURNAL_APPENDS_COUNTER).inc(n)
        return n

    def _append_locked(self, record: dict) -> None:
        if (
            self.crash_after_appends is not None
            and self.appends >= self.crash_after_appends
        ):
            raise SimulatedCrash(
                f"journal crash point: {self.appends} append(s) committed"
            )
        payload = _canonical(record)
        line = json.dumps(
            {"c": _crc(payload), "r": record},
            separators=(",", ":"),
            default=str,
        )
        if self._fh is None:
            self._fh = open(self._path(self._segment_idx, True), "a")
            self._records_in_segment = 0
        self._fh.write(line + "\n")
        self._records_in_segment += 1
        self.appends += 1
        if self._records_in_segment >= self.max_segment_records:
            self._rotate_locked()   # flushes + fsyncs + seals

    def _flush_locked(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            if self.fsync == "always":
                os.fsync(self._fh.fileno())

    def _rotate_locked(self) -> None:
        """Seal the active segment (flush → fsync per policy → atomic rename)
        and arm the next index."""
        if self._fh is None:
            return
        self._fh.flush()
        if self.fsync in ("always", "rotate"):
            os.fsync(self._fh.fileno())
        self._fh.close()
        self._fh = None
        os.replace(
            self._path(self._segment_idx, True),
            self._path(self._segment_idx, False),
        )
        self._segment_idx += 1

    def truncate(self) -> None:
        """Delete every segment and start over (bounded-growth compaction).

        For owners whose finished history is dead weight — the execution
        journal after a finished/recovered execution, the user-task journal
        after a startup rewrite — the WAL is recovery state, not an audit
        log (the flight recorder is the audit surface).  Safe against a
        crash mid-truncate: any surviving partial record set replays to
        zero open state."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            for f in self._segment_files():
                try:
                    os.remove(os.path.join(self.directory, f))
                except OSError:
                    pass
            self._segment_idx = 0
            self._records_in_segment = 0

    def close(self) -> None:
        """Seal the active segment; the journal can be reopened later."""
        with self._lock:
            if self._fh is not None and self._records_in_segment > 0:
                self._rotate_locked()
            elif self._fh is not None:
                self._fh.close()
                self._fh = None
                try:
                    os.remove(self._path(self._segment_idx, True))
                except OSError:
                    pass

    # -- replay path ---------------------------------------------------------

    def replay(self) -> JournalReplay:
        """All recoverable records in write order, with per-segment prefix
        tolerance (see module docstring).  Safe on a live journal (reads the
        flushed state)."""
        from cruise_control_tpu_torch.core.sensors import JOURNAL_SKIPPED_COUNTER, REGISTRY

        out = JournalReplay()
        counts = {"skipped": 0, "segments": 0}
        for rec in self.replay_iter(counts):
            out.append(rec)
        out.skipped = counts["skipped"]
        out.segments = counts["segments"]
        if out.skipped:
            REGISTRY.counter(JOURNAL_SKIPPED_COUNTER).inc(out.skipped)
        return out

    def replay_iter(self, counts: Optional[dict] = None):
        """Streaming variant of :meth:`replay`: yields records one at a time,
        holding one segment file open at a time — a large store (the sample
        journal) never materializes whole in memory.  ``counts``, when given,
        is updated in place with ``"skipped"``/``"segments"`` as segments
        finish (read it after exhaustion)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            files = self._segment_files()
        skipped = segments = 0
        for name in files:
            segments += 1
            corrupt = False
            fh = self._open_segment(name)
            if fh is None:
                # the segment vanished between the listing and the open with
                # no sealed successor name — a concurrent truncate() compacted
                # it away; everything it held is dead state by definition
                continue
            with fh:
                for raw in fh:
                    line = raw.strip()
                    if not line:
                        continue
                    if corrupt:
                        skipped += 1
                        continue
                    rec = self._decode(line)
                    if rec is None:
                        corrupt = True
                        skipped += 1
                    else:
                        yield rec
            if counts is not None:
                counts["skipped"] = skipped
                counts["segments"] = segments

    def _open_segment(self, name: str):
        """Open a listed segment, surviving the rotation rename race: a
        ``.open`` name sealed between the directory listing and the ``open()``
        is retried under its final name (``os.replace`` keeps the content —
        the sealed file IS the file the listing saw, byte for byte).  Returns
        None only when the segment is gone under both names (truncated)."""
        path = os.path.join(self.directory, name)
        try:
            return open(path)
        except FileNotFoundError:
            if name.endswith(self.OPEN_SUFFIX):
                try:
                    return open(path[: -len(self.OPEN_SUFFIX)])
                except FileNotFoundError:
                    return None
            return None

    def tail(self) -> "JournalTail":
        """A live read cursor over this journal's directory (works equally
        from another process -- construct :class:`JournalTail` directly on the
        directory there)."""
        return JournalTail(self.directory)

    @staticmethod
    def _decode(line: str) -> Optional[dict]:
        """One line → record; None marks the corruption point.

        CRC-enveloped lines verify the checksum of the canonical re-dump;
        plain-JSON-object lines (legacy, pre-envelope data) pass through."""
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            return None
        if isinstance(doc, dict) and set(doc) == {"c", "r"}:
            rec = doc["r"]
            if not isinstance(rec, dict) or _crc(_canonical(rec)) != doc["c"]:
                return None
            return rec
        if isinstance(doc, dict):
            return doc   # legacy record without envelope
        return None


class JournalTail:
    """Live cursor over a journal directory: each :meth:`poll` returns the
    records appended since the last one, in write order (see the module
    docstring for the rotation / torn-tail / truncation semantics).

    The cursor is a ``(segment index, byte offset)`` pair over the on-disk
    files — it holds no file handles between polls and shares no state with
    the writer, so a follower in another process tails the same directory
    with nothing but filesystem visibility.  Truncation (compaction) by the
    writer is detected by segment *identity* (inode + size), not just the
    listing: a recreated ``segment-000000`` under a parked cursor resets the
    cursor instead of silently serving the stale offset."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self._idx = 0
        self._offset = 0
        #: inode of the segment under the cursor (None until first opened)
        self._ino: Optional[int] = None
        #: (inode, size) of the most recently *finished* (sealed, fully
        #: consumed) segment — its disappearance or replacement marks a
        #: truncation.  Size rides along because freed inode numbers are
        #: reused: a recreated same-index segment can collide on inode alone
        self._prev_ino: Optional[int] = None
        self._prev_size: Optional[int] = None
        #: fstat size of the segment under the cursor as of the last open
        self._cur_size: int = 0
        #: records delivered across all polls
        self.records = 0
        #: permanently skipped lines (sealed-segment prefix tolerance)
        self.skipped = 0
        #: cursor resets observed (writer-side truncate()/rewrite()
        #: compaction) — consumers must dedupe re-delivered records
        self.resets = 0
        #: True when the last poll read to the end of the WAL without error
        self.caught_up = False

    # -- cursor internals ----------------------------------------------------

    def _segments(self) -> dict:
        """index → (name, sealed) for every segment currently listed."""
        out: dict = {}
        try:
            names = _list_segments(self.directory)
        except FileNotFoundError:
            return out
        for name in names:
            out[_segment_index(name)] = (name, name.endswith(".jsonl"))
        return out

    def _open_at(self, name: str):
        """Open a listed segment; rotation-race safe (same fallback as
        :meth:`Journal._open_segment` — ``os.replace`` keeps the inode, so
        the sealed name serves the identical bytes at the same offset)."""
        path = os.path.join(self.directory, name)
        try:
            return open(path, "rb")
        except FileNotFoundError:
            if name.endswith(Journal.OPEN_SUFFIX):
                try:
                    return open(path[: -len(Journal.OPEN_SUFFIX)], "rb")
                except FileNotFoundError:
                    return None
            return None

    def _stat_sig(self, name: str) -> Optional[Tuple[int, int]]:
        """(inode, size) of a listed segment, rotation-race tolerant."""
        try:
            st = os.stat(os.path.join(self.directory, name))
            return st.st_ino, st.st_size
        except OSError:
            if name.endswith(Journal.OPEN_SUFFIX):
                try:
                    st = os.stat(
                        os.path.join(
                            self.directory, name[: -len(Journal.OPEN_SUFFIX)]
                        )
                    )
                    return st.st_ino, st.st_size
                except OSError:
                    return None
            return None

    def _reset(self, idx: int) -> None:
        self._idx = idx
        self._offset = 0
        self._ino = None
        self._prev_ino = None
        self._prev_size = None
        self.resets += 1

    # -- the poll loop -------------------------------------------------------

    def poll(self, max_records: Optional[int] = None) -> List[dict]:
        """Read forward from the cursor; returns a possibly-empty list of
        records.  Never blocks and never raises on concurrent writer
        activity — a torn tail or a mid-rename segment just ends the poll
        early and the next poll resumes."""
        out: List[dict] = []
        self.caught_up = False
        while True:
            if max_records is not None and len(out) >= max_records:
                return out
            segs = self._segments()
            if not segs:
                # empty (or truncated-to-empty) journal: park at segment 0
                if self._idx != 0 or self._offset != 0 or self._ino is not None:
                    self._reset(0)
                self.caught_up = True
                return out
            lo, hi = min(segs), max(segs)
            # truncation check against the last finished segment: if the
            # segment we completed was replaced (new inode) or is gone while
            # lower indices exist, the writer compacted — restart from the
            # oldest surviving segment
            if self._prev_ino is not None and self._idx > lo:
                prev = segs.get(self._idx - 1)
                # the segment we finished was SEALED — immutable, and a name
                # never transitions back to .open.  Anything listed at that
                # index that is .open again, or whose (inode, size) signature
                # differs, is a recreation — inode alone is not identity (the
                # filesystem reuses freed inode numbers immediately)
                if (
                    prev is None
                    or not prev[1]
                    or self._stat_sig(prev[0])
                    != (self._prev_ino, self._prev_size)
                ):
                    self._reset(lo)
                    continue
            if self._idx not in segs:
                if self._idx == hi + 1 and self._prev_ino is not None:
                    # parked past the newest segment after cleanly finishing
                    # it — waiting for the writer to start the next one
                    self.caught_up = True
                    return out
                if self._idx > hi or self._idx < lo:
                    # the WAL restarted below the cursor (truncate) or the
                    # cursor predates the oldest segment
                    self._reset(lo)
                    continue
                # gap mid-listing (rename in flight): retry next poll
                self.caught_up = True
                return out
            name, sealed = segs[self._idx]
            fh = self._open_at(name)
            if fh is None:
                continue   # vanished under both names: concurrent truncate
            with fh:
                st = os.fstat(fh.fileno())
                self._cur_size = st.st_size
                if self._ino is None:
                    self._ino = st.st_ino
                elif st.st_ino != self._ino or st.st_size < self._offset:
                    # the file under the cursor is not the file the offset
                    # was measured in (truncate + recreate at this index)
                    self._reset(lo)
                    continue
                fh.seek(self._offset)
                data = fh.read()
            if not self._consume(data, sealed, out, max_records):
                # parked: torn tail in .open, caught up, or max_records hit
                self.caught_up = True
                return out

    def _consume(
        self,
        data: bytes,
        sealed: bool,
        out: List[dict],
        max_records: Optional[int],
    ) -> bool:
        """Decode complete lines from ``data`` (the bytes past the cursor),
        advancing ``self._offset`` over everything cleanly consumed.
        Returns True when the segment finished (sealed, fully read) and the
        poll loop should continue into the next one; False when the cursor
        parks for this poll."""
        pos = 0
        while True:
            if max_records is not None and len(out) >= max_records:
                self._offset += pos
                return False
            nl = data.find(b"\n", pos)
            if nl < 0:
                tail = data[pos:]
                self._offset += pos
                if not tail.strip():
                    # clean end of the readable bytes: a sealed segment is
                    # finished; the .open segment is simply caught up
                    return self._finish_segment() if sealed else False
                if sealed:
                    # torn tail of a sealed segment never completes — the
                    # crashed-writer leftover; prefix tolerance skips it
                    self.skipped += 1
                    return self._finish_segment()
                # torn / in-flight tail of the .open segment: the writer may
                # still complete the line — park before it, retry next poll
                return False
            line = data[pos:nl].decode("utf-8", errors="replace").strip()
            if not line:
                pos = nl + 1
                continue
            rec = Journal._decode(line)
            if rec is None:
                if sealed:
                    # permanent corruption: abandon the rest of the segment
                    # (count every remaining non-blank line, replay-style)
                    self.skipped += 1 + sum(
                        1 for ln in data[nl + 1:].splitlines() if ln.strip()
                    )
                    self._offset += pos
                    return self._finish_segment()
                # .open segment: a newline-terminated line failing the CRC
                # may be a write racing this read — park and re-decode next
                # poll; if the segment seals with the line still bad, the
                # sealed branch above makes the skip permanent
                self._offset += pos
                return False
            out.append(rec)
            self.records += 1
            pos = nl + 1

    def _finish_segment(self) -> bool:
        """Advance past the current (sealed, fully consumed) segment."""
        self._prev_ino = self._ino
        self._prev_size = self._cur_size
        self._ino = None
        self._idx += 1
        self._offset = 0
        return True
