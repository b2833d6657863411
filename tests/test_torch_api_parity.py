"""The port's REST answers against the JAX package's, request for request.

One seeded cluster, built in numpy, at two sizes: the JAX API tests' fixture
(4 brokers, 12 partitions) and config2_small (40 brokers, 2,000 partitions)
with a trimmed goal list, so that the JAX side compiles in seconds.  Each
package's own app serves it over real HTTP on the CPU, on one
window-aligned clock, and one client sends both the same requests: STATE (its
``MonitorState`` block), LOAD, PARTITION_LOAD, KAFKA_CLUSTER_STATE,
PROPOSALS, SIMULATE and USER_TASKS.  The bodies must be equal once the fields
that record when or how long something ran, or how many device dispatches or
host syncs it took, are dropped (``WALL_CLOCK_KEYS``).  Strings, ints, bools
and the proposals are exact; floats agree within ``RTOL``.
"""

import math

import pytest

from chip_smoke import CONFIG2_SMALL, facade_clock, seed_fake_backend
from cruise_control_tpu_torch.client import CruiseControlClient
from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

#: float tolerance: the packages sum f32 loads in different orders (the JAX
#: segment sums against the port's), so the last bits of a sum may differ
RTOL = 1e-6
#: fields that record when, how long or with how many dispatches or host
#: syncs something ran: they differ between any two runs or between packages
WALL_CLOCK_KEYS = frozenset({
    "durationS", "startMs", "StartMs", "UserTaskId", "RequestId",
    "numHostSyncs", "numDispatches", "bucketHit",
})
GOALS = "RackAwareGoal,ReplicaCapacityGoal,DiskCapacityGoal,DiskUsageDistributionGoal"
WINDOW_MS = 60_000
CAPACITY = [100.0, 1e6, 1e6, 1e7]     # CPU, NW_IN, NW_OUT, DISK of the small fixture


def _tiny(backend):
    for b in range(4):
        backend.add_broker(b, rack=str(b % 2))
    for p in range(12):
        backend.create_partition(("T", p), [p % 2, (p % 2 + 1) % 4], load=[1.5, 4e3, 6e3, 3e4])
    return backend, CAPACITY


def _config2_small(backend):
    syn = SyntheticSpec(**CONFIG2_SMALL)
    state, maps = generate(syn, device="cpu")
    seed_fake_backend(backend, state, maps, syn.num_racks)
    return backend, [syn.capacity_cpu, syn.capacity_nw_in, syn.capacity_nw_out, syn.capacity_disk]


def _serve(package: str, cluster):
    """One package's app over ``cluster``, its windows sampled, serving HTTP."""
    if package == "jax":
        from cruise_control_tpu.app import CruiseControlTpuApp
        from cruise_control_tpu.backend import FakeClusterBackend
        from cruise_control_tpu.core.resources import Resource
        from cruise_control_tpu.monitor.capacity import StaticCapacityResolver

        kw = {}
    else:
        from cruise_control_tpu_torch.app import CruiseControlTpuApp
        from cruise_control_tpu_torch.backend import FakeClusterBackend
        from cruise_control_tpu_torch.core.resources import Resource
        from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver

        kw = {"device": "cpu"}
    backend, cap = cluster(FakeClusterBackend(metric_interval_ms=WINDOW_MS))
    props = {
        "partition.metrics.window.ms": WINDOW_MS,
        "num.partition.metrics.windows": 4,
        "metric.sampling.interval.ms": 3_600_000,
        "anomaly.detection.interval.ms": 3_600_000,
        "anomaly.detection.initial.pass": False,
        "sample.store.class": f"{package_root(package)}.monitor.samplestore.NoopSampleStore",
        "webserver.http.port": 0,
        "default.goals": GOALS,
    }
    app = CruiseControlTpuApp(props, backend=backend, **kw)
    app.monitor.capacity_resolver = StaticCapacityResolver(
        {Resource.CPU: cap[0], Resource.NW_IN: cap[1], Resource.NW_OUT: cap[2], Resource.DISK: cap[3]}
    )
    for w in range(6):
        app.monitor.sample_once(now_ms=facade_clock(w))
    app.start(serve_http=True)
    app.app.stop_proposal_refresher()   # no background solve between requests
    return app


def package_root(package: str) -> str:
    return {"jax": "cruise_control_tpu", "port": "cruise_control_tpu_torch"}[package]


def _session(app) -> dict:
    c = CruiseControlClient(f"http://127.0.0.1:{app.port}", poll_timeout_s=600.0)
    return {
        "STATE": c.state()["MonitorState"],
        "LOAD": c.load(),
        "PARTITION_LOAD": c.partition_load(entries=100_000),
        "KAFKA_CLUSTER_STATE": c.kafka_cluster_state(),
        "PROPOSALS": c.proposals(),
        "SIMULATE": c.simulate(add_broker_counts=[0, 2], load_factors=[1.0, 1.5]),
        "USER_TASKS": c.user_tasks(),
    }


def _strip(body):
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k not in WALL_CLOCK_KEYS}
    if isinstance(body, list):
        return [_strip(v) for v in body]
    return body


def assert_same_body(port, jax, where="body"):
    """Equal structure and keys; floats within ``RTOL``; everything else exact."""
    if isinstance(jax, float) and isinstance(port, float):
        assert math.isclose(port, jax, rel_tol=RTOL) or (math.isnan(port) and math.isnan(jax)), (where, port, jax)
        return
    assert type(port) is type(jax), (where, port, jax)
    if isinstance(jax, dict):
        assert port.keys() == jax.keys(), (where, sorted(port.keys() ^ jax.keys()))
        for k in jax:
            assert_same_body(port[k], jax[k], f"{where}.{k}")
    elif isinstance(jax, list):
        assert len(port) == len(jax), (where, len(port), len(jax))
        for i, (p, j) in enumerate(zip(port, jax)):
            assert_same_body(p, j, f"{where}[{i}]")
    else:
        assert port == jax, (where, port, jax)


@pytest.mark.parametrize("cluster", [_tiny, _config2_small], ids=["4x12", "config2_small"])
def test_the_port_answers_every_request_as_the_jax_app(cluster):
    bodies = {}
    for package in ("jax", "port"):
        app = _serve(package, cluster)
        try:
            bodies[package] = _session(app)
        finally:
            app.stop()
    assert bodies["port"]["PROPOSALS"]["numProposals"] > 0
    assert bodies["port"]["PROPOSALS"]["proposals"] == bodies["jax"]["PROPOSALS"]["proposals"]
    for endpoint in bodies["jax"]:
        assert_same_body(_strip(bodies["port"][endpoint]), _strip(bodies["jax"][endpoint]), endpoint)
