"""Metric fetcher pool: concurrent samplers with a partition assignor.

Port of ``cruise_control_tpu/monitor/fetcher.py`` (pure Python, copied whole).  The fetchers run on host threads and never touch the device.

Counterpart of ``sampling/MetricFetcherManager.java:37`` (``fetchMetricSamples``
:148,166) and the ``MetricSamplerPartitionAssignor`` SPI: a pool of sampler
instances fetches disjoint partition sets concurrently, and the default
assignor keeps every partition of a topic on one fetcher (the reference's
``DefaultMetricSamplerPartitionAssignor`` invariant, which keeps per-topic byte
apportioning consistent within a fetch).

The pool composes as a :class:`MetricSampler` itself, so the LoadMonitor is
oblivious: ``FetcherPool(factory, assignor, n).get_samples(...)`` fans out and
merges.  Failed fetchers degrade to a partial batch (a warning-level event in
the reference) rather than failing the round.
"""

from __future__ import annotations

import abc
import concurrent.futures
from typing import Callable, List, Optional, Sequence

from cruise_control_tpu_torch.backend.base import TopicPartition
from cruise_control_tpu_torch.core.sensors import (
    FETCHER_REPLACED_COUNTER,
    REGISTRY,
    SAMPLE_FETCH_TIMER,
)
from cruise_control_tpu_torch.monitor.samples import MetricSampler, SampleBatch


class PartitionAssignor(abc.ABC):
    """MetricSamplerPartitionAssignor SPI."""

    @abc.abstractmethod
    def assign(
        self, partitions: Sequence[TopicPartition], num_fetchers: int
    ) -> List[List[TopicPartition]]: ...


class DefaultPartitionAssignor(PartitionAssignor):
    """All partitions of a topic go to one fetcher; topics spread round-robin by
    aggregate weight (partition count) — mirrors the default assignor's goal of
    balanced fetcher load without splitting a topic."""

    def assign(
        self, partitions: Sequence[TopicPartition], num_fetchers: int
    ) -> List[List[TopicPartition]]:
        by_topic: dict = {}
        for tp in partitions:
            by_topic.setdefault(tp[0], []).append(tp)
        buckets: List[List[TopicPartition]] = [[] for _ in range(num_fetchers)]
        loads = [0] * num_fetchers
        # biggest topics first onto the lightest fetcher (greedy balance)
        for topic in sorted(by_topic, key=lambda t: -len(by_topic[t])):
            i = loads.index(min(loads))
            buckets[i].extend(by_topic[topic])
            loads[i] += len(by_topic[topic])
        return buckets


class PartitionFilteringSampler(MetricSampler):
    """Wraps a sampler, keeping only samples for an assigned partition set."""

    def __init__(self, inner: MetricSampler, assigned: Sequence[TopicPartition]):
        self.inner = inner
        self.assigned = set(assigned)

    def get_samples(self, from_ms: int, to_ms: int) -> SampleBatch:
        batch = self.inner.get_samples(from_ms, to_ms)
        keep = [s for s in batch.partition_samples if s.tp in self.assigned]
        return SampleBatch(keep, batch.broker_samples)


class FetcherPool(MetricSampler):
    """Concurrent sampling fan-out (MetricFetcherManager.fetchMetricSamples)."""

    def __init__(
        self,
        sampler_factory: Callable[[], MetricSampler],
        list_partitions: Callable[[], Sequence[TopicPartition]],
        num_fetchers: int = 4,
        assignor: Optional[PartitionAssignor] = None,
        timeout_s: float = 120.0,
    ) -> None:
        self.num_fetchers = max(1, num_fetchers)
        self.assignor = assignor or DefaultPartitionAssignor()
        self.list_partitions = list_partitions
        self.timeout_s = timeout_s
        self._sampler_factory = sampler_factory
        self._samplers = [sampler_factory() for _ in range(self.num_fetchers)]
        self._abandoned: List[MetricSampler] = []
        self._pool = self._new_pool()

    def _new_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        return concurrent.futures.ThreadPoolExecutor(
            max_workers=self.num_fetchers, thread_name_prefix="metric-fetcher"
        )

    def get_samples(self, from_ms: int, to_ms: int) -> SampleBatch:
        partitions = list(self.list_partitions())
        assignment = self.assignor.assign(partitions, self.num_fetchers)
        with REGISTRY.timer(SAMPLE_FETCH_TIMER).time():
            futures = {}          # future -> sampler slot
            for slot, (sampler, assigned) in enumerate(zip(self._samplers, assignment)):
                if not assigned:
                    continue
                wrapped = PartitionFilteringSampler(sampler, assigned)
                futures[self._pool.submit(wrapped.get_samples, from_ms, to_ms)] = slot
            done, hung = concurrent.futures.wait(futures, timeout=self.timeout_s)
            psamples, bsamples = [], []
            seen_brokers = set()
            for fut in done:
                try:
                    batch = fut.result()
                except Exception:
                    continue  # partial batch beats a failed round
                psamples.extend(batch.partition_samples)
                # broker samples arrive from every fetcher; dedupe by (broker, ts)
                for b in batch.broker_samples:
                    key = (b.broker_id, b.ts_ms)
                    if key not in seen_brokers:
                        seen_brokers.add(key)
                        bsamples.append(b)
            if hung:
                # a hung fetcher forfeits its share; keep what the others got
                # (the degrade-to-partial contract — never fail the round)
                self._replace_hung(sorted(futures[f] for f in hung), hung)
        return SampleBatch(psamples, bsamples)

    def _replace_hung(self, slots, hung_futures) -> None:
        """Replace poisoned workers so repeated hangs can't exhaust the pool.

        A timed-out future's worker thread stays occupied for as long as the
        sampler call blocks; abandoning it in the shared executor would leak
        one worker per hang until every slot is dead.  Instead: cancel what
        can be cancelled, swap in fresh sampler instances for the hung slots
        (the old ones may be blocked mid-call and are unsafe to reuse), and
        retire the whole executor for a fresh one — the old executor's
        threads die off as their calls return (or never, in which case they
        hold only abandoned objects, not pool capacity)."""
        for f in hung_futures:
            f.cancel()
        for slot in slots:
            # evicted samplers may be blocked mid-call; keep them for close()
            # so their connections/handles are still released at shutdown
            self._abandoned.append(self._samplers[slot])
            self._samplers[slot] = self._sampler_factory()
        old = self._pool
        self._pool = self._new_pool()
        old.shutdown(wait=False, cancel_futures=True)
        REGISTRY.counter(FETCHER_REPLACED_COUNTER).inc(len(slots))

    def close(self) -> None:
        for s in self._samplers + self._abandoned:
            try:
                s.close()
            except Exception:
                pass
        self._abandoned.clear()
        self._pool.shutdown(wait=False)
