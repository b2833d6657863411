"""Sample persistence: the checkpoint/replay path of the monitor.

Port of ``cruise_control_tpu/monitor/samplestore.py``.

Counterpart of the ``SampleStore`` SPI and ``KafkaSampleStore``
(``monitor/sampling/KafkaSampleStore.java:68``, ``storeSamples``:178,
``loadSamples``:203): every processed sample batch is persisted so monitor state
(the sliding windows) survives restarts, replayed through the same ``add_sample``
path on startup.  This framework checkpoints to local newline-JSON segment files
(one per flush) instead of compacted Kafka topics; the SPI keeps that pluggable.
"""

from __future__ import annotations

import abc
import itertools
from typing import Callable, List

from cruise_control_tpu_torch.core.journal import Journal
from cruise_control_tpu_torch.monitor.samples import (
    BrokerMetricSample,
    PartitionMetricSample,
    SampleBatch,
)


class SampleStore(abc.ABC):
    @abc.abstractmethod
    def store(self, batch: SampleBatch) -> None: ...

    @abc.abstractmethod
    def replay(self, consumer: Callable[[SampleBatch], None]) -> int:
        """Feed all persisted samples to ``consumer``; returns samples replayed."""

    def close(self) -> None:  # pragma: no cover
        pass


class NoopSampleStore(SampleStore):
    def store(self, batch: SampleBatch) -> None:
        pass

    def replay(self, consumer) -> int:
        return 0


class FileSampleStore(SampleStore):
    """Checksummed JSONL segments on the generic WAL (``core/journal.py``).

    The write path inherits the journal's crash hardening: CRC-32 record
    envelopes, atomic write-temp-then-rename segment rotation (a reader never
    sees a half-sealed segment), and an fsync policy knob.  ``replay``
    tolerates a crash-truncated or corrupted segment — the valid prefix is
    ingested and the abandoned lines are counted (``last_replay_skipped`` +
    the ``SampleStore.replay-records-skipped`` sensor), mirroring
    ``read_jsonl``'s semantics instead of dying on ``JSONDecodeError`` and
    taking monitor startup down with it.  Plain pre-envelope segments (older
    stores) replay through the journal's legacy passthrough.
    """

    #: replay chunk: samples per SampleBatch handed to the consumer
    REPLAY_CHUNK = 50_000

    def __init__(
        self,
        directory: str,
        max_segment_records: int = 100_000,
        fsync: str = "never",
    ) -> None:
        self.directory = directory
        self._journal = Journal(
            directory, max_segment_records=max_segment_records, fsync=fsync
        )
        #: corrupt/truncated lines abandoned by the last replay
        self.last_replay_skipped = 0

    def store(self, batch: SampleBatch) -> None:
        # one lock + one flush per batch, not per sample (the sampling loop's
        # hot path)
        self._journal.append_many(
            s.to_record()
            for s in itertools.chain(batch.partition_samples, batch.broker_samples)
        )

    def replay(self, consumer: Callable[[SampleBatch], None]) -> int:
        from cruise_control_tpu_torch.core.sensors import (
            REGISTRY,
            SAMPLE_STORE_SKIPPED_COUNTER,
        )

        counts = {"skipped": 0, "segments": 0}
        psamples: List[PartitionMetricSample] = []
        bsamples: List[BrokerMetricSample] = []
        total = 0

        def flush() -> None:
            nonlocal psamples, bsamples, total
            if psamples or bsamples:
                batch = SampleBatch(psamples, bsamples)
                consumer(batch)
                total += len(batch)
                psamples, bsamples = [], []

        # streaming: one segment at a time, chunked batches to the consumer —
        # a long-lived store never materializes whole in memory
        for rec in self._journal.replay_iter(counts):
            if rec.get("type") == "partition":
                psamples.append(
                    PartitionMetricSample(
                        (rec["topic"], rec["partition"]),
                        rec["broker"],
                        rec["ts"],
                        tuple(rec["values"]),
                    )
                )
            elif rec.get("type") == "broker":
                bsamples.append(
                    BrokerMetricSample(rec["broker"], rec["ts"], tuple(rec["values"]))
                )
            if len(psamples) + len(bsamples) >= self.REPLAY_CHUNK:
                flush()
        flush()
        self.last_replay_skipped = counts["skipped"]
        if counts["skipped"]:
            REGISTRY.counter(SAMPLE_STORE_SKIPPED_COUNTER).inc(counts["skipped"])
        return total

    def close(self) -> None:
        self._journal.close()
