"""The port's monitor layer against the JAX package.

The cases of the JAX package's ``tests/test_monitor.py`` run against the
port (``FakeClusterBackend`` in place of embedded Kafka).  The parity cases
drive the JAX ``LoadMonitor`` and the port's over two fake backends built
from the same seed, on the same window-aligned clock, and require the
aggregated windows and the model's ``ClusterArrays`` leaves to be equal bit
for bit: both sides run the same numpy code.
"""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.backend import FakeClusterBackend as JFake
from cruise_control_tpu.monitor import BackendMetricSampler as JSampler
from cruise_control_tpu.monitor import LoadMonitor as JLoadMonitor
from cruise_control_tpu.monitor import StaticCapacityResolver as JStatic
from cruise_control_tpu_torch.backend import FakeClusterBackend
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.monitor import (
    BackendMetricSampler,
    FileSampleStore,
    LoadMonitor,
    ModelCompletenessRequirements,
    MonitorState,
    NotEnoughValidSnapshotsError,
    StaticCapacityResolver,
)
from tests.torch_port_helpers import assert_fields_same

CAPACITY = {
    Resource.CPU: 100.0,
    Resource.NW_IN: 100_000.0,
    Resource.NW_OUT: 100_000.0,
    Resource.DISK: 500_000.0,
}

WINDOW_MS = 60_000


def make_backend():
    backend = FakeClusterBackend(metric_interval_ms=10_000)
    for b in range(3):
        backend.add_broker(b, rack=str(b % 2))
    backend.create_partition(("T1", 0), [0, 1], load=[10.0, 1000.0, 2000.0, 5000.0])
    backend.create_partition(("T1", 1), [1, 2], load=[8.0, 800.0, 1600.0, 4000.0])
    backend.create_partition(("T2", 0), [2, 0], load=[6.0, 600.0, 1200.0, 3000.0])
    return backend


def make_monitor(backend, **kw):
    return LoadMonitor(
        backend,
        BackendMetricSampler(backend),
        StaticCapacityResolver(CAPACITY),
        num_windows=4,
        window_ms=WINDOW_MS,
        min_samples_per_window=1,
        **kw,
    )


def fill_windows(monitor, num_windows=5):
    """Sample enough history to stabilize `num_windows` windows."""
    for w in range(num_windows + 1):
        monitor.sample_once(now_ms=(w + 1) * WINDOW_MS)


class TestSamplingAndModel:
    def test_not_enough_windows_raises(self):
        monitor = make_monitor(make_backend())
        monitor.start()
        with pytest.raises(NotEnoughValidSnapshotsError):
            monitor.cluster_model()

    def test_cluster_model_joins_loads_and_topology(self):
        monitor = make_monitor(make_backend())
        monitor.start()
        fill_windows(monitor)
        model = monitor.cluster_model()
        assert model.brokers() == [0, 1, 2]
        assert model.replicas_of(("T1", 0)) == [(0, True), (1, False)]
        state, maps = model.to_arrays(device="cpu")
        # leader of T1-0 carries its NW_OUT; follower on broker 1 carries none
        from cruise_control_tpu_torch.model import arrays as A

        load = np.asarray(A.broker_load(state))
        assert load[maps.broker_index[0], Resource.NW_OUT] == pytest.approx(
            2000.0 + 1200.0 * 0  # leader of T1-0 only (T2-0 leader is broker 2)
        , rel=0.05)
        # disk counts leader + follower copies
        assert load[maps.broker_index[1], Resource.DISK] == pytest.approx(
            5000.0 + 4000.0, rel=0.05
        )

    def test_completeness_requirements_enforced(self):
        monitor = make_monitor(make_backend())
        monitor.start()
        fill_windows(monitor, num_windows=2)
        with pytest.raises(NotEnoughValidSnapshotsError):
            monitor.cluster_model(
                requirements=ModelCompletenessRequirements(min_required_num_windows=4)
            )

    def test_pause_resume(self):
        monitor = make_monitor(make_backend())
        monitor.start()
        monitor.pause_sampling("test pause")
        assert monitor.sample_once(now_ms=WINDOW_MS) == 0
        assert monitor.state().state == MonitorState.PAUSED
        monitor.resume_sampling("test resume")
        assert monitor.sample_once(now_ms=2 * WINDOW_MS) > 0

    def test_dead_broker_reflected(self):
        backend = make_backend()
        monitor = make_monitor(backend)
        monitor.start()
        fill_windows(monitor)
        backend.kill_broker(2)
        model = monitor.cluster_model()
        from cruise_control_tpu_torch.model.cluster import BrokerState

        assert model.broker_state(2) == BrokerState.DEAD


class TestSampleStore:
    def test_store_and_replay(self, tmp_path):
        backend = make_backend()
        store = FileSampleStore(str(tmp_path / "samples"))
        monitor = make_monitor(backend, sample_store=store)
        monitor.start()
        fill_windows(monitor)
        model1 = monitor.cluster_model()
        monitor.shutdown()

        # fresh monitor replays the persisted samples on start (KafkaSampleStore
        # loadSamples:203 semantics)
        store2 = FileSampleStore(str(tmp_path / "samples"))
        monitor2 = make_monitor(backend, sample_store=store2)
        monitor2.start()
        model2 = monitor2.cluster_model()
        assert model1.replica_distribution() == model2.replica_distribution()
        s1, _ = model1.to_arrays(device="cpu")
        s2, _ = model2.to_arrays(device="cpu")
        np.testing.assert_allclose(
            np.asarray(s1.base_load), np.asarray(s2.base_load), rtol=1e-6
        )


class TestBootstrap:
    def test_bootstrap_backfills_windows(self):
        monitor = make_monitor(make_backend())
        monitor.start()
        n = monitor.bootstrap(0, 6 * WINDOW_MS)
        assert n > 0
        model = monitor.cluster_model()
        assert len(model.partitions()) == 3


class TestWallClockStart:
    def test_model_available_soon_after_wall_clock_start(self):
        """Monitoring that starts at a large wall-clock window must not see
        phantom pre-start windows (aggregator first-window tracking)."""
        monitor = make_monitor(make_backend())
        monitor.start()
        base = 29_000_000 * WINDOW_MS  # ~wall-clock epoch ms scale
        for w in range(3):
            monitor.sample_once(now_ms=base + (w + 1) * WINDOW_MS)
        model = monitor.cluster_model()
        assert len(model.partitions()) == 3


# -- the port against the JAX monitor, same inputs -------------------------------------

#: a skewed synthetic cluster; JBOD brokers split their disk over two logdirs
SPEC = dict(
    num_racks=3, num_brokers=9, num_topics=5, num_partitions=60,
    replication_factor=3, distribution="exponential", skew_brokers=4,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15,
)


def _stack(fake_cls, sampler_cls, static_cls, monitor_cls, seed, jbod):
    """A monitor of one package over a fake backend seeded with the shared
    numpy cluster, its windows filled on a window-aligned clock."""
    from chip_smoke import seed_fake_backend
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, maps = generate(SyntheticSpec(seed=seed, **SPEC), device="cpu")
    backend = fake_cls(metric_interval_ms=20_000, noise=0.03, seed=seed)
    if jbod:
        real_add = backend.add_broker
        backend.add_broker = lambda b, rack: real_add(b, rack, logdirs={"/d0": 1e5, "/d1": 1e5})
    seed_fake_backend(backend, state, maps, SPEC["num_racks"])
    backend.kill_broker(seed % SPEC["num_brokers"])
    capacity = {Resource.CPU: 100.0, Resource.NW_IN: 3e5, Resource.NW_OUT: 2e5, Resource.DISK: 3e5}
    monitor = monitor_cls(backend, sampler_cls(backend), static_cls(capacity), num_windows=3,
                          window_ms=WINDOW_MS)
    monitor.start()
    start = 29_000_000 * WINDOW_MS
    for w in range(5):
        monitor.sample_once(now_ms=start + w * WINDOW_MS + (w % 2) * 7_000)
    return monitor


@pytest.mark.parametrize("seed,jbod", [(0, False), (1, True), (2, False)])
def test_monitor_windows_and_model_equal_the_jax_monitor(seed, jbod):
    jmon = _stack(JFake, JSampler, JStatic, JLoadMonitor, seed, jbod)
    pmon = _stack(FakeClusterBackend, BackendMetricSampler, StaticCapacityResolver, LoadMonitor, seed, jbod)
    assert pmon.current_partition_loads() == jmon.current_partition_loads()
    jv, _ = jmon._partition_agg.aggregate()
    pv, _ = pmon._partition_agg.aggregate()
    assert pv.entities == jv.entities and pv.window_ids == jv.window_ids
    np.testing.assert_array_equal(pv.values, jv.values)
    jh, ph = jmon.broker_metric_history(), pmon.broker_metric_history()
    np.testing.assert_array_equal(ph[0], jh[0])
    assert ph[1] == jh[1]
    assert dataclasses.asdict(pmon.state()) == dataclasses.asdict(jmon.state())

    jstate, jmaps = jmon.cluster_model().to_arrays()
    pstate, pmaps = pmon.cluster_model().to_arrays(device="cpu")
    assert_fields_same(pstate, jstate)
    assert dataclasses.asdict(pmaps) == dataclasses.asdict(jmaps)
    assert pstate.num_disks == (2 if jbod else 1) * SPEC["num_brokers"]   # the fake default: one logdir


def test_model_trace_recorded_with_the_jax_attribute_names():
    from cruise_control_tpu.obs import RECORDER as JREC
    from cruise_control_tpu_torch.obs import RECORDER

    jmon = _stack(JFake, JSampler, JStatic, JLoadMonitor, 0, False)
    pmon = _stack(FakeClusterBackend, BackendMetricSampler, StaticCapacityResolver, LoadMonitor, 0, False)
    JREC.clear()
    RECORDER.clear()
    jmon.cluster_model()
    pmon.cluster_model()
    with pytest.raises(NotEnoughValidSnapshotsError):
        make_monitor(make_backend()).cluster_model()
    got = [(r.kind, r.attrs) for r in RECORDER.recent(5)]
    assert got[0][0] == "model" and "error" in got[0][1]
    assert got[1] == ("model", JREC.recent(1, kind="model")[0].attrs)
