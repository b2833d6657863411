"""The port's metrics ingest against the JAX package's.

The route a deployment's metrics take: a reporter in each broker
(``monitor/reporter.py``) serializes them with the versioned wire format
(``monitor/wire.py``) onto a transport, and a pool of fetchers
(``monitor/fetcher.py``) samples them back for the load monitor; beside it
the Prometheus sampler (``monitor/prometheus.py``) and the cgroup CPU helpers
(``monitor/container.py``).  The JAX cases of ``tests/test_aux_subsystems.py``
run on both packages (``pkg``); the two packages exchange wire bytes both
ways; and the whole route at config2_small -- reporters, transport, fetcher
pool, ``rebalance(dryrun=True)`` -- gives the JAX facade's proposals and
model loads over the JAX stack, and the port's own direct path's.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
import time
import types

import numpy as np
import pytest

import chip_smoke as SM

PACKAGES = ("jax", "port")


def _modules(name: str):
    if name == "jax":
        from cruise_control_tpu.backend import base
        from cruise_control_tpu.core import metricdef
        from cruise_control_tpu.monitor import container, fetcher, prometheus, reporter, samples, wire
    else:
        from cruise_control_tpu_torch.backend import base
        from cruise_control_tpu_torch.core import metricdef
        from cruise_control_tpu_torch.monitor import container, fetcher, prometheus, reporter, samples, wire
    return types.SimpleNamespace(base=base, metricdef=metricdef, container=container, fetcher=fetcher,
                                 prometheus=prometheus, reporter=reporter, samples=samples, wire=wire)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _modules(request.param)


def _metrics(base, metricdef, seed: int, n: int = 200):
    """Seeded raw metrics of every scope, names from the wire taxonomy."""
    rng = np.random.default_rng(seed)
    scopes = {t.name: metricdef.raw_metric_scope(t).name for t in metricdef.RawMetricType}
    names = sorted(scopes)
    out = []
    for _ in range(n):
        name = names[int(rng.integers(len(names)))]
        scope = scopes[name]
        topic = f"topic-{int(rng.integers(50))}" if scope in ("TOPIC", "PARTITION") else None
        part = int(rng.integers(10_000)) if scope == "PARTITION" else None
        out.append(base.RawMetric(name, scope, int(rng.integers(-1, 500)), float(rng.normal() * 10.0 ** rng.integers(-8, 9)),
                                  int(1_700_000_000_000 + rng.integers(0, 10**7)), topic=topic, partition=part))
    return out


# -- the wire format -------------------------------------------------------------


class TestWireSerde:
    """``test_aux_subsystems.TestWireSerde`` on both packages."""

    def _metrics(self, pkg):
        R = pkg.base.RawMetric
        return [
            R("ALL_TOPIC_BYTES_IN", "BROKER", 3, 1234.5, 1_700_000_000_000),
            R("TOPIC_BYTES_IN", "TOPIC", 3, 99.0, 1_700_000_000_000, topic="T1"),
            R("PARTITION_SIZE", "PARTITION", 4, 5.5, 1_700_000_000_123, topic="T1", partition=7),
            R("BROKER_CPU_UTIL", "BROKER", 0, 0.66, 1_700_000_000_456),
        ]

    def test_round_trip(self, pkg):
        assert pkg.wire.deserialize(pkg.wire.serialize(self._metrics(pkg))) == self._metrics(pkg)

    def test_unknown_name_rejected_on_serialize(self, pkg):
        with pytest.raises(pkg.wire.WireFormatError):
            pkg.wire.serialize([pkg.base.RawMetric("NOT_A_METRIC", "BROKER", 0, 1.0, 0)])

    def test_truncated_payload_raises(self, pkg):
        payload = pkg.wire.serialize(self._metrics(pkg))
        with pytest.raises(pkg.wire.WireFormatError):
            pkg.wire.deserialize(payload[: len(payload) // 2])

    def test_newer_version_records_are_skipped(self, pkg):
        payload = bytearray(pkg.wire.serialize(self._metrics(pkg)[:1]))
        payload[6] = 99
        assert pkg.wire.deserialize(bytes(payload)) == []

    def test_newer_version_with_different_layout_cannot_desync(self, pkg):
        v1 = pkg.wire.serialize(self._metrics(pkg)[:1])[4:]
        weird_body = bytes([99]) + b"\x07" * 33
        batch = struct.pack("<I", 2) + struct.pack("<H", len(weird_body)) + weird_body + v1
        assert pkg.wire.deserialize(batch) == self._metrics(pkg)[:1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_bytes_are_the_jax_bytes_and_read_back_both_ways(seed):
    """The same seeded metrics serialize to the same bytes in both packages,
    and each package's bytes deserialize to equal metrics in the other, a
    record of a future layout and one with an unknown metric id among them
    (both skipped by their length)."""
    J, P = _modules("jax"), _modules("port")
    jm, pm = _metrics(J.base, J.metricdef, seed), _metrics(P.base, P.metricdef, seed)
    jb, pb = J.wire.serialize(jm), P.wire.serialize(pm)
    assert pb == jb
    unknown = bytearray(P.wire.serialize(pm[:1])[4:])
    struct.pack_into("<H", unknown, 4, 60_000)                 # metric id past the taxonomy
    future = bytes([99]) + b"\x01" * 17
    batch = struct.pack("<I", len(pm) + 2) + bytes(unknown) + struct.pack("<H", len(future)) + future + pb[4:]
    assert [dataclasses.astuple(m) for m in P.wire.deserialize(jb)] == [dataclasses.astuple(m) for m in jm]
    assert [dataclasses.astuple(m) for m in J.wire.deserialize(pb)] == [dataclasses.astuple(m) for m in pm]
    for reader in (J, P):
        got = reader.wire.deserialize(batch)
        assert [dataclasses.astuple(m) for m in got] == [dataclasses.astuple(m) for m in pm]


# -- cgroup awareness ------------------------------------------------------------


class TestContainerAwareness:
    """``test_aux_subsystems.TestContainerAwareness`` on both packages, the
    cgroup files written under ``tmp_path``."""

    def test_v2_quota(self, pkg, tmp_path):
        p = tmp_path / "cpu.max"
        p.write_text("200000 100000\n")
        assert pkg.container.container_cpu_limit_cores(v2_path=str(p)) == 2.0

    def test_v2_unlimited(self, pkg, tmp_path):
        p = tmp_path / "cpu.max"
        p.write_text("max 100000\n")
        assert pkg.container.container_cpu_limit_cores(
            v2_path=str(p), v1_quota_path=str(tmp_path / "nope"), v1_period_path=str(tmp_path / "nope2")) is None

    def test_v1_quota(self, pkg, tmp_path):
        q, per = tmp_path / "quota", tmp_path / "period"
        q.write_text("150000")
        per.write_text("100000")
        assert pkg.container.container_cpu_limit_cores(
            v2_path=str(tmp_path / "missing"), v1_quota_path=str(q), v1_period_path=str(per)) == 1.5

    def test_adjust_cpu_util_scales_to_allowance(self, pkg, tmp_path):
        p = tmp_path / "cpu.max"
        p.write_text("200000 100000")
        assert abs(pkg.container.adjust_cpu_util(0.1, host_cores=16, v2_path=str(p)) - 0.8) < 1e-9
        assert pkg.container.effective_cores(host_cores=16, v2_path=str(p)) == 2.0


@pytest.mark.parametrize("quota,period,host,util", [(250000, 100000, 8, 0.3), (50000, 100000, 64, 0.01),
                                                    (10**9, 100000, 4, 0.9), (-1, 100000, 6, 0.5)])
def test_cgroup_helpers_equal_across_packages(tmp_path, quota, period, host, util):
    """v2 and v1 files of one quota: both packages read the same allowance
    and rescale one host utilization alike."""
    J, P = _modules("jax"), _modules("port")
    (tmp_path / "cpu.max").write_text(f"{'max' if quota < 0 else quota} {period}\n")
    (tmp_path / "quota").write_text(str(quota))
    (tmp_path / "period").write_text(str(period))
    for paths in (dict(v2_path=str(tmp_path / "cpu.max")),
                  dict(v2_path=str(tmp_path / "none"), v1_quota_path=str(tmp_path / "quota"),
                       v1_period_path=str(tmp_path / "period"))):
        got = [(m.container.effective_cores(host_cores=host, **paths),
                m.container.adjust_cpu_util(util, host_cores=host, **paths)) for m in (J, P)]
        assert got[1] == got[0]


# -- the fetcher pool --------------------------------------------------------------


def _recording_sampler(pkg, partitions, calls):
    class Recording(pkg.samples.MetricSampler):
        def get_samples(self, from_ms, to_ms):
            calls.append(1)
            return pkg.samples.SampleBatch(
                [pkg.samples.PartitionMetricSample(tp, 0, to_ms, (1.0, 2.0)) for tp in partitions], [])

    return Recording()


class TestFetcherPool:
    """``test_aux_subsystems.TestFetcherPool`` on both packages."""

    def test_assignor_keeps_topics_whole(self, pkg):
        partitions = [("A", i) for i in range(6)] + [("B", i) for i in range(3)] + [("C", 0)]
        for bucket in pkg.fetcher.DefaultPartitionAssignor().assign(partitions, 3):
            for t in {tp[0] for tp in bucket}:
                assert all(tp in bucket for tp in partitions if tp[0] == t), f"topic {t} split"

    def test_pool_fans_out_and_merges(self, pkg):
        partitions = [("A", 0), ("A", 1), ("B", 0), ("C", 0)]
        calls = []
        pool = pkg.fetcher.FetcherPool(sampler_factory=lambda: _recording_sampler(pkg, partitions, calls),
                                       list_partitions=lambda: partitions, num_fetchers=2)
        batch = pool.get_samples(0, 1000)
        assert sorted(s.tp for s in batch.partition_samples) == sorted(partitions)
        assert len(calls) == 2
        pool.close()

    def test_repeated_hangs_still_yield_partial_batches(self, pkg):
        """A hung fetcher forfeits its share and is replaced; every round
        still returns the healthy topic's share (the waits are bounded and
        the parked samplers released in ``finally``)."""
        release = threading.Event()
        partitions = [("hang", 0), ("ok", 0)]
        closed, made = [], []

        class MaybeHanging(pkg.samples.MetricSampler):
            def __init__(self, hangs):
                self.hangs = hangs

            def get_samples(self, from_ms, to_ms):
                if self.hangs:
                    release.wait(30)
                return pkg.samples.SampleBatch(
                    [pkg.samples.PartitionMetricSample(tp, 0, to_ms, (1.0, 2.0)) for tp in partitions], [])

            def close(self):
                closed.append(self)

        def factory():
            s = MaybeHanging(hangs=(len(made) != 1))
            made.append(s)
            return s

        pool = pkg.fetcher.FetcherPool(sampler_factory=factory, list_partitions=lambda: partitions,
                                       num_fetchers=2, timeout_s=0.2)
        try:
            for round_no in range(3):
                got = {s.tp for s in pool.get_samples(0, 1000).partition_samples}
                assert ("ok", 0) in got and ("hang", 0) not in got, round_no
            assert len(made) == 2 + 3
        finally:
            release.set()
            pool.close()
        assert set(closed) == set(made)


@pytest.mark.parametrize("fetchers", [1, 3, 4, 7])
def test_assignments_are_the_jax_assignments(fetchers):
    rng = np.random.default_rng(fetchers)
    partitions = [(f"t{int(t)}", int(p)) for t, p in zip(rng.integers(0, 40, 600), rng.integers(0, 90, 600))]
    J, P = _modules("jax"), _modules("port")
    assert (P.fetcher.DefaultPartitionAssignor().assign(partitions, fetchers)
            == J.fetcher.DefaultPartitionAssignor().assign(partitions, fetchers))


def test_pool_batches_equal_across_packages_with_a_hung_fetcher():
    """Seeded samplers behind both packages' pools, the first fetcher of
    each hung every round and replaced: the merged batches (partition and
    deduplicated broker samples) are equal, round by round."""
    rng = np.random.default_rng(4)
    partitions = sorted({(f"t{int(t)}", int(p)) for t, p in zip(rng.integers(0, 12, 200), rng.integers(0, 30, 200))})
    values = {tp: tuple(float(x) for x in rng.normal(size=3)) for tp in partitions}
    release = threading.Event()
    out = {}
    pools = []
    try:
        for name in PACKAGES:
            m = _modules(name)
            made = []

            class Seeded(m.samples.MetricSampler):
                def __init__(self, hangs):
                    self.hangs = hangs

                def get_samples(self, from_ms, to_ms, m=m):
                    if self.hangs:
                        release.wait(30)
                    return m.samples.SampleBatch(
                        [m.samples.PartitionMetricSample(tp, 0, to_ms, values[tp]) for tp in partitions],
                        [m.samples.BrokerMetricSample(b, to_ms, (float(b),)) for b in range(5)])

            def factory(made=made, Seeded=Seeded):
                s = Seeded(hangs=not made)       # the first sampler made is the hung one
                made.append(s)
                return s

            pool = m.fetcher.FetcherPool(factory, lambda: partitions, num_fetchers=4, timeout_s=0.3)
            pools.append(pool)
            rounds = []
            for r in range(2):
                batch = pool.get_samples(0, 1000 * (r + 1))
                rounds.append((sorted(dataclasses.astuple(s) for s in batch.partition_samples),
                               sorted(dataclasses.astuple(s) for s in batch.broker_samples)))
            out[name] = (rounds, len(made))
    finally:
        release.set()
        for pool in pools:
            pool.close()
    assert out["port"] == out["jax"]
    assert out["port"][0][0][0] and len(out["port"][0][0][0]) < len(partitions)   # the hung share is lost


# -- the Prometheus sampler --------------------------------------------------------


def _fake_prom(url, timeout_s):
    """A canned ``query_range`` answer per query (no network)."""
    q = url.split("query=")[1].split("&")[0]
    if "BytesInPerSec" in q and "topic" not in q:
        result = [{"metric": {"instance": "b0:7071"}, "values": [[1000.0, "5000"]]},
                  {"metric": {"instance": "b1:7071"}, "values": [[1000.0, "7000"], [1060.0, "7100"]]}]
    elif "idle" in q:
        result = [{"metric": {"instance": "b0:7071"}, "values": [[1000.0, "0.25"]]},
                  {"metric": {"instance": "b1:7071"}, "values": [[1000.0, "not-a-number"]]}]
    elif "topic" in q:
        result = [{"metric": {"instance": "b0:7071", "topic": "T"}, "values": [[1000.0, "1200"]]},
                  {"metric": {"instance": "b9:7071", "topic": "T"}, "values": [[1000.0, "1"]]}]
    elif "kafka_log_Log_Size" in q:
        result = [{"metric": {"instance": "b0:7071", "topic": "T", "partition": str(p)},
                   "values": [[1000.0, str(900 + p)]]} for p in range(3)]
    else:
        result = []
    return {"status": "success", "data": {"result": result}}


def test_prometheus_sampler_equals_the_jax_sampler():
    """A canned ``fetch_fn``: both packages' samplers give the same samples,
    an unmapped exporter and an unparsable value skipped; a failed query
    raises in both."""
    out = {}
    for name in PACKAGES:
        m = _modules(name)
        topics = {"T": [m.base.PartitionInfo(("T", p), leader=0, replicas=[0, 1], isr=[0, 1]) for p in range(3)]}
        sampler = m.prometheus.PrometheusMetricSampler("http://prom:9090", broker_by_instance={"b0:7071": 0, "b1:7071": 1},
                                                       describe_topics=lambda: topics, fetch_fn=_fake_prom)
        batch = sampler.get_samples(0, 2_000_000)
        out[name] = ([dataclasses.astuple(s) for s in batch.partition_samples],
                     sorted(dataclasses.astuple(s) for s in batch.broker_samples))
        failing = m.prometheus.PrometheusMetricSampler("http://prom:9090", {}, lambda: {},
                                                       fetch_fn=lambda url, t: {"status": "error", "error": "x"})
        with pytest.raises(m.prometheus.PrometheusSamplerError):
            failing.get_samples(0, 1)
    assert out["port"] == out["jax"]
    assert {s[0] for s in out["port"][0]} == {("T", p) for p in range(3)}


# -- the reporter -------------------------------------------------------------------


def test_reporter_publishes_and_the_other_package_consumes(pkg):
    """``test_aux_subsystems.TestMetricsReporter`` on the real clock, through
    the package's ``InMemoryTransport``, read by both packages' samplers."""
    transport = pkg.reporter.InMemoryTransport()
    now = int(time.time() * 1000)
    metrics = [pkg.base.RawMetric("BROKER_CPU_UTIL", "BROKER", 7, 0.42, now),
               pkg.base.RawMetric("ALL_TOPIC_BYTES_IN", "BROKER", 7, 5000.0, now)]
    reporter = pkg.reporter.MetricsReporter(7, transport, collect_fn=lambda: metrics)
    assert reporter.report_once() == 2 and reporter.batches_published == 1
    for reader in PACKAGES:
        sampler = _modules(reader).reporter.TransportMetricSampler(transport, describe_topics=lambda: {})
        batch = sampler.get_samples(now - 60_000, now + 60_000)
        assert [(s.broker_id, s.ts_ms) for s in batch.broker_samples] == [(7, now)]
        assert sampler.get_samples(now + 60_000, now + 120_000).broker_samples == []


def test_process_collector_reports_cpu_after_warmup(pkg):
    collect = pkg.reporter.process_metrics_collector(0)
    assert collect() == []
    sum(i * i for i in range(200_000))
    (out,) = collect()
    assert out.name == "BROKER_CPU_UTIL" and 0.0 <= out.value <= 1.0


# -- the route end to end, at config2_small ------------------------------------------

#: a short goal list: the JAX side compiles it in seconds
INGEST_GOALS = (0, 2, 3, 9)


def _jax_ingest_facade(spec, goal_ids):
    """The JAX stack on the smoke's ingest route: the same seeded fake
    backend, the JAX reporters, wire, fetcher pool, monitor and facade, the
    windows filled on the same clock by the smoke's harness."""
    from cruise_control_tpu import facade as JF
    from cruise_control_tpu.analyzer import goals_base as JG
    from cruise_control_tpu.backend import FakeClusterBackend
    from cruise_control_tpu.core.resources import Resource
    from cruise_control_tpu.executor import Executor
    from cruise_control_tpu.monitor import LoadMonitor, StaticCapacityResolver
    from cruise_control_tpu.monitor import fetcher, reporter
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    syn = SyntheticSpec(**spec)
    state, maps = generate(syn, device="cpu")
    backend = SM.seed_fake_backend(FakeClusterBackend(metric_interval_ms=SM.FACADE_WINDOW_MS), state, maps,
                                   syn.num_racks)
    fleet = SM.ReporterFleet(backend, reporter, SM.FACADE_WINDOW_MS, SM.facade_clock(-(SM.FACADE_WINDOWS + 1)))
    capacity = {Resource.CPU: syn.capacity_cpu, Resource.NW_IN: syn.capacity_nw_in,
                Resource.NW_OUT: syn.capacity_nw_out, Resource.DISK: syn.capacity_disk}
    monitor = LoadMonitor(backend, SM.ingest_sampler(backend, fleet.transport, fetcher, reporter),
                          StaticCapacityResolver(capacity), num_windows=SM.FACADE_WINDOWS,
                          window_ms=SM.FACADE_WINDOW_MS)
    cc = JF.CruiseControl(backend, monitor, Executor(backend), goal_ids=goal_ids,
                          hard_ids=tuple(g for g in goal_ids if g in JG.HARD_GOALS))
    cc.start()
    run = types.SimpleNamespace(cc=cc, fleet=fleet, window=0, sample_s=0.0, fetch_s=0.0)
    for _ in range(SM.FACADE_WINDOWS + 2):
        SM.ingest_window(run)
    return run


@pytest.fixture(scope="module")
def routes():
    """The ingest route on both packages and the port's direct path, each
    with its model and a dry-run rebalance."""
    import jax

    cfg, _ = SM.ingest_config()
    out = {}
    port = SM.build_ingest_facade(SM.CONFIG2_SMALL, "cpu", cfg, goal_ids=INGEST_GOALS)
    direct, _ = SM.build_facade(SM.CONFIG2_SMALL, "cpu", goal_ids=INGEST_GOALS)
    jax_run = _jax_ingest_facade(SM.CONFIG2_SMALL, INGEST_GOALS)
    for name, cc in (("port", port.cc), ("direct", direct), ("jax", jax_run.cc)):
        out[name] = dict(loads=cc.monitor.current_partition_loads(), model=cc.cluster_model(),
                         dry=cc.rebalance(dryrun=True).optimizer_result, cc=cc)
    out["fleets"] = (port.fleet, jax_run.fleet)
    yield out
    for name in ("port", "direct", "jax"):
        out[name]["cc"].shutdown()
    jax.clear_caches()


def test_the_route_carries_every_broker_and_the_jax_bytes(routes):
    pfleet, jfleet = routes["fleets"]
    assert len(pfleet.reporters) == SM.CONFIG2_SMALL["num_brokers"]
    assert [(ts, p) for ts, p in pfleet.transport.batches] == [(ts, p) for ts, p in jfleet.transport.batches]
    assert pfleet.transport.bytes > 0 and {ts for ts, _ in pfleet.transport.batches} == {
        SM.facade_clock(w) for w in range(-(SM.FACADE_WINDOWS + 1), SM.FACADE_WINDOWS + 1)}


def test_the_route_gives_the_jax_loads_and_model(routes):
    """Loads exact (the wire carries f64): the port's route equals the JAX
    route and the port's direct path (``BackendMetricSampler``)."""
    from tests.torch_port_helpers import assert_fields_same

    assert routes["port"]["loads"] and routes["port"]["loads"] == routes["jax"]["loads"]
    assert routes["port"]["loads"] == routes["direct"]["loads"]
    jstate, jmaps = routes["jax"]["model"].to_arrays()
    pstate, pmaps = routes["port"]["model"].to_arrays(device="cpu")
    assert_fields_same(pstate, jstate)
    assert dataclasses.asdict(pmaps) == dataclasses.asdict(jmaps)


def test_the_route_dry_run_equals_the_jax_facade(routes):
    p, j, d = (routes[k]["dry"] for k in ("port", "jax", "direct"))
    props = [dataclasses.astuple(x) for x in p.proposals]
    assert props and props == [dataclasses.astuple(x) for x in j.proposals]
    assert props == [dataclasses.astuple(x) for x in d.proposals]
    assert p.residual_hard_violations == 0 and p.violations_after == j.violations_after
