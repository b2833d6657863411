"""The port's support layer against the JAX package: the metric taxonomy, the
window aggregator, the retry policy, the fake cluster backend, and the
three wire and signature faults fixed before the facade (the JAX keys beside
the port's host-sync keys, the optimizer's lazy ``CC_TPU_BUCKET_BROKERS``,
``fast_sweep(mesh=)``).

The metric-definition and aggregator cases are the JAX package's own
(``tests/test_metricdef.py``, ``tests/test_aggregator.py``), run against the
port.  The parity cases feed the same seeded numpy inputs to both packages
and require equal outputs: both sides run the same numpy code, so equal
means bit for bit.
"""

import dataclasses

import numpy as np
import pytest

import cruise_control_tpu.core.aggregator as JAG
import cruise_control_tpu.core.metricdef as JMD
from cruise_control_tpu.backend import FakeClusterBackend as JFake
from cruise_control_tpu_torch.backend import FakeClusterBackend
from cruise_control_tpu_torch.core.aggregator import (
    AggregationOptions,
    Extrapolation,
    MetricSampleAggregator,
    NotEnoughValidEntitiesError,
    NotEnoughValidWindowsError,
)
from cruise_control_tpu_torch.core.metricdef import (
    BROKER_METRIC_DEF,
    COMMON_METRIC_DEF,
    COMMON_METRIC_NAMES,
    MetricDef,
    MetricScope,
    RawMetricType,
    ValueStrategy,
    raw_metric_scope,
    raw_types_for_scope,
    resource_to_metric_ids,
)
from cruise_control_tpu_torch.core.resources import Resource

# -- the JAX package's metric-definition cases --------------------------------------


def test_raw_taxonomy_counts():
    # Reference RawMetricType: broker/topic/partition scopes; 43 broker types was the
    # historical figure, the current tree carries the full queue/local/total-time
    # percentile families.
    assert len(raw_types_for_scope(MetricScope.PARTITION)) == 1
    assert len(raw_types_for_scope(MetricScope.TOPIC)) == 7
    assert len(raw_types_for_scope(MetricScope.BROKER)) >= 40
    assert raw_metric_scope(RawMetricType.PARTITION_SIZE) is MetricScope.PARTITION


def test_common_def_is_prefix_of_broker_def():
    common = [m.name for m in COMMON_METRIC_DEF.all()]
    broker = [m.name for m in BROKER_METRIC_DEF.all()]
    assert common == COMMON_METRIC_NAMES
    assert broker[: len(common)] == common
    # ids are dense column indices
    assert [m.id for m in BROKER_METRIC_DEF.all()] == list(range(BROKER_METRIC_DEF.size()))


def test_strategies():
    assert COMMON_METRIC_DEF.metric_info("DISK_USAGE").strategy is ValueStrategy.LATEST
    assert COMMON_METRIC_DEF.metric_info("CPU_USAGE").strategy is ValueStrategy.AVG
    # All broker-only defs use AVG in the reference (KafkaMetricDef.java:61-101).
    assert (
        BROKER_METRIC_DEF.metric_info("BROKER_PRODUCE_TOTAL_TIME_MS_MAX").strategy
        is ValueStrategy.AVG
    )
    # Only CPU_USAGE is the CPU-model prediction target.
    assert COMMON_METRIC_DEF.metric_info("CPU_USAGE").to_predict
    assert not COMMON_METRIC_DEF.metric_info("DISK_USAGE").to_predict


def test_resource_groups():
    groups = resource_to_metric_ids(COMMON_METRIC_DEF)
    assert groups[Resource.CPU] == [COMMON_METRIC_DEF.metric_info("CPU_USAGE").id]
    assert groups[Resource.DISK] == [COMMON_METRIC_DEF.metric_info("DISK_USAGE").id]
    assert len(groups[Resource.NW_IN]) == 2   # leader bytes in + replication bytes in
    assert len(groups[Resource.NW_OUT]) == 2


def test_resource_properties():
    assert Resource.CPU.is_host_resource
    assert not Resource.DISK.is_host_resource
    assert Resource.DISK.is_broker_resource
    assert Resource.CPU.epsilon(1e6, 1e6) > 0



# -- the JAX package's aggregator cases ---------------------------------------------

WINDOW_MS = 1000


def _metric_def():
    return (
        MetricDef()
        .define("avg_m", ValueStrategy.AVG)
        .define("max_m", ValueStrategy.MAX)
        .define("latest_m", ValueStrategy.LATEST)
    )


def _agg(num_windows=4, min_samples=2):
    return MetricSampleAggregator(num_windows, WINDOW_MS, min_samples, _metric_def())


def fill_window(agg, entity, window, n=2, base=10.0):
    for i in range(n):
        ts = window * WINDOW_MS + i * 10
        agg.add_sample(entity, ts, [base + i, base + i, base + i])


def test_strategies_avg_max_latest():
    agg = _agg()
    agg.add_sample("p0", 100, [1.0, 5.0, 7.0])
    agg.add_sample("p0", 200, [3.0, 2.0, 9.0])
    # advance current window so window 0 becomes stable
    agg.add_sample("p0", 1 * WINDOW_MS + 1, [0.0, 0.0, 0.0])
    vae, _ = agg.aggregate()
    assert vae.window_ids == [0]
    row = vae.values[vae.entity_index("p0"), 0]
    assert row[0] == pytest.approx(2.0)   # AVG of 1,3
    assert row[1] == pytest.approx(5.0)   # MAX of 5,2
    assert row[2] == pytest.approx(9.0)   # LATEST at ts=200


def test_max_strategy_later_sample_wins():
    agg = _agg()
    agg.add_sample("p0", 100, [1.0, 1.0, 1.0])
    agg.add_sample("p0", 200, [2.0, 8.0, 2.0])  # larger max arrives second
    agg.add_sample("p0", WINDOW_MS + 1, [0.0, 0.0, 0.0])
    vae, _ = agg.aggregate()
    assert vae.values[vae.entity_index("p0"), 0, 1] == pytest.approx(8.0)


def test_far_future_roll_is_bounded_and_correct():
    agg = _agg(num_windows=3)
    fill_window(agg, "p0", 0)
    # jump a billion windows ahead: must complete fast and evict all history
    far = 10**9
    agg.add_sample("p0", far * WINDOW_MS, [1.0, 1.0, 1.0])
    fill_window(agg, "p0", far)  # no-op extra samples into current window
    fill_window(agg, "p0", far + 1)
    vae, _ = agg.aggregate()
    assert all(w >= far - 3 for w in vae.window_ids)
    assert agg.add_sample("p0", 0, [1.0, 1.0, 1.0]) is False


def test_current_window_excluded():
    agg = _agg()
    fill_window(agg, "p0", 0)
    vae_err = None
    try:
        agg.aggregate()
    except NotEnoughValidWindowsError as e:
        vae_err = e
    assert vae_err is not None  # only the current window exists -> nothing stable


def test_window_rolling_evicts_old():
    agg = _agg(num_windows=3)
    for w in range(6):
        fill_window(agg, "p0", w)
    # current=5; stable retained: 2,3,4
    vae, _ = agg.aggregate()
    assert vae.window_ids == [2, 3, 4]
    # too-old sample rejected
    assert agg.add_sample("p0", 0, [1.0, 1.0, 1.0]) is False


def test_extrapolation_avg_available():
    agg = _agg(min_samples=4)
    # 2 samples (>= half of 4) -> AVG_AVAILABLE
    fill_window(agg, "p0", 0, n=2, base=10.0)
    fill_window(agg, "p0", 1, n=4)  # window 1 rolls the ring forward
    vae, _ = agg.aggregate(options=AggregationOptions(include_invalid_entities=True))
    i = vae.entity_index("p0")
    w = vae.window_ids.index(0)
    assert vae.extrapolations[i, w] == Extrapolation.AVG_AVAILABLE
    assert vae.values[i, w, 0] == pytest.approx(10.5)


def test_extrapolation_forced_insufficient():
    agg = _agg(min_samples=4)
    fill_window(agg, "p0", 0, n=1, base=3.0)  # 1 < half of 4
    fill_window(agg, "p0", 1, n=4)
    vae, _ = agg.aggregate(options=AggregationOptions(include_invalid_entities=True))
    i, w = vae.entity_index("p0"), vae.window_ids.index(0)
    assert vae.extrapolations[i, w] == Extrapolation.FORCED_INSUFFICIENT
    assert vae.values[i, w, 0] == pytest.approx(3.0)


def test_extrapolation_avg_adjacent():
    agg = _agg(num_windows=4, min_samples=2)
    fill_window(agg, "p0", 0, base=10.0)   # valid
    # window 1: no samples at all
    fill_window(agg, "p0", 2, base=20.0)   # valid
    fill_window(agg, "p0", 3)              # rolls the ring to window 3
    agg.add_sample("p0", 4 * WINDOW_MS, [0.0, 0.0, 0.0])  # open current window 4
    vae, _ = agg.aggregate(options=AggregationOptions(include_invalid_entities=True))
    i, w = vae.entity_index("p0"), vae.window_ids.index(1)
    assert vae.extrapolations[i, w] == Extrapolation.AVG_ADJACENT
    # avg of window0 avg (10.5) and window2 avg (20.5)
    assert vae.values[i, w, 0] == pytest.approx(15.5)


def test_adjacent_means_adjacent_in_time_not_position():
    # Samples land only in window 3; retention covers [2..9].  Window 4 may borrow
    # (truly adjacent) but windows 6+ must NOT be filled from window 3.
    agg = _agg(num_windows=8, min_samples=1)
    fill_window(agg, "p0", 3, n=1, base=10.0)
    agg.add_sample("p0", 10 * WINDOW_MS, [0.0] * 3)  # current window 10
    vae, _ = agg.aggregate(options=AggregationOptions(include_invalid_entities=True))
    assert vae.window_ids == list(range(2, 10))
    i = vae.entity_index("p0")
    w = {wid: k for k, wid in enumerate(vae.window_ids)}
    assert vae.extrapolations[i, w[2]] == Extrapolation.AVG_ADJACENT
    assert vae.extrapolations[i, w[4]] == Extrapolation.AVG_ADJACENT
    for far in (5, 6, 7, 8, 9):
        assert vae.extrapolations[i, w[far]] == Extrapolation.NO_VALID_EXTRAPOLATION


def test_no_valid_extrapolation_marks_entity_invalid():
    agg = _agg(num_windows=4, min_samples=2)
    fill_window(agg, "good", 0)
    fill_window(agg, "good", 1)
    fill_window(agg, "good", 2)
    fill_window(agg, "good", 3)
    agg.add_sample("good", 4 * WINDOW_MS, [0.0] * 3)
    # "bad" entity has a single isolated window; others have no adjacent help
    fill_window(agg, "bad", 0)
    vae, completeness = agg.aggregate()
    assert "bad" not in vae.entities
    assert "good" in vae.entities
    assert completeness.valid_entity_ratio == pytest.approx(0.5)


def test_completeness_window_requirement_enforced():
    agg = _agg(num_windows=2, min_samples=2)
    fill_window(agg, "p0", 0)
    fill_window(agg, "p0", 1)
    agg.add_sample("p0", 2 * WINDOW_MS, [0.0] * 3)
    fill_window(agg, "p1", 2)  # p1 only has current-window samples -> no stable data
    # p1 covers no stable window, so window coverage is 0.5 < 1.0 everywhere
    with pytest.raises(NotEnoughValidWindowsError):
        agg.aggregate(options=AggregationOptions(min_valid_entity_ratio=1.0))
    with pytest.raises(NotEnoughValidWindowsError):
        agg.aggregate(options=AggregationOptions(min_valid_entity_ratio=0.9, min_valid_windows=5))


def test_completeness_entity_requirement_enforced():
    # Entity invalid through too many extrapolations while window coverage stays
    # full (extrapolated windows count toward window coverage, not entity validity).
    agg = MetricSampleAggregator(2, WINDOW_MS, 2, _metric_def(), max_allowed_extrapolations=0)
    fill_window(agg, "p0", 0)
    fill_window(agg, "p0", 1)
    fill_window(agg, "p1", 0, n=1)  # FORCED_INSUFFICIENT -> extrapolated
    fill_window(agg, "p1", 1)
    agg.add_sample("p0", 2 * WINDOW_MS, [0.0] * 3)
    with pytest.raises(NotEnoughValidEntitiesError):
        agg.aggregate(options=AggregationOptions(min_valid_entity_ratio=0.9))
    vae, comp = agg.aggregate(options=AggregationOptions(min_valid_entity_ratio=0.5))
    assert comp.valid_entity_ratio == pytest.approx(0.5)
    assert vae.entities == ["p0"]


def test_entity_groups_in_completeness():
    agg = _agg(num_windows=2, min_samples=1)
    for e, grp in [("t0-0", "t0"), ("t0-1", "t0"), ("t1-0", "t1")]:
        agg.set_entity_group(e, grp)
    fill_window(agg, "t0-0", 0, n=1)
    fill_window(agg, "t0-1", 0, n=1)
    fill_window(agg, "t1-0", 0, n=1)
    agg.add_sample("t0-0", 1 * WINDOW_MS, [0.0] * 3)
    _, comp = agg.aggregate(options=AggregationOptions(include_invalid_entities=True))
    assert comp.valid_entity_group_ratio == pytest.approx(1.0)


def test_generation_increments():
    agg = _agg()
    g0 = agg.generation
    agg.add_sample("p0", 10, [1.0, 1.0, 1.0])
    assert agg.generation > g0


def test_retain_entities():
    agg = _agg(min_samples=1)
    fill_window(agg, "p0", 0, n=1)
    fill_window(agg, "p1", 0, n=1)
    agg.add_sample("p0", WINDOW_MS, [0.0] * 3)
    agg.retain_entities(["p1"])
    vae, _ = agg.aggregate()
    assert vae.entities == ["p1"]


def test_time_range_filtering():
    agg = _agg(num_windows=4, min_samples=1)
    for w in range(5):
        fill_window(agg, "p0", w, n=1)
    vae, _ = agg.aggregate(from_ms=1 * WINDOW_MS, to_ms=3 * WINDOW_MS)
    assert vae.window_ids == [1, 2, 3]


def test_many_entities_dense_growth():
    agg = _agg(min_samples=1)
    for i in range(600):
        agg.add_sample(f"p{i}", 100, [float(i), float(i), float(i)])
    agg.add_sample("p0", WINDOW_MS, [0.0] * 3)
    vae, _ = agg.aggregate()
    assert len(vae.entities) == 600
    i = vae.entity_index("p599")
    assert vae.values[i, 0, 0] == pytest.approx(599.0)


# -- the port against the JAX package, same inputs -----------------------------------


def _feed(agg_cls, metric_def, seed):
    """An aggregator of each package fed the same seeded samples: skewed
    entity activity, gaps, late and too-old samples, a far roll."""
    rng = np.random.default_rng(seed)
    agg = agg_cls(5, WINDOW_MS, 2, metric_def, max_allowed_extrapolations=2)
    accepted = []
    for _ in range(400):
        e = f"p{int(rng.integers(0, 12))}"
        ts = int(rng.integers(0, 9 * WINDOW_MS))
        vals = (rng.exponential(size=metric_def.size()) * 100).tolist()
        accepted.append(agg.add_sample(e, ts, vals))
    return agg, accepted


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregates_equal_the_jax_aggregator(seed):
    jagg, jacc = _feed(JAG.MetricSampleAggregator, JMD.COMMON_METRIC_DEF, seed)
    pagg, pacc = _feed(MetricSampleAggregator, COMMON_METRIC_DEF, seed)
    assert pacc == jacc and pagg.generation == jagg.generation
    for inc in (False, True):
        jv, jc = jagg.aggregate(options=JAG.AggregationOptions(include_invalid_entities=inc))
        pv, pc = pagg.aggregate(options=AggregationOptions(include_invalid_entities=inc))
        assert pv.entities == jv.entities and pv.window_ids == jv.window_ids
        np.testing.assert_array_equal(pv.values, jv.values)
        np.testing.assert_array_equal(
            np.asarray(pv.extrapolations, np.int64), np.asarray(jv.extrapolations, np.int64)
        )
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)


def _demo(cls):
    backend = cls(noise=0.05, seed=3, reassignment_latency_polls=2)
    backend.seed_demo(num_brokers=6, num_racks=3, num_partitions=30, replication_factor=3)
    return backend


def test_fake_backend_metrics_and_admin_ops_equal_the_jax_backend():
    """Same seed, same noise stream: the raw metrics are equal value for
    value; the same admin calls leave the same placement and log."""
    j, p = _demo(JFake), _demo(FakeClusterBackend)
    for lo, hi in ((0, 30_000), (30_000, 95_000)):
        jm, pm = j.fetch_raw_metrics(lo, hi), p.fetch_raw_metrics(lo, hi)
        assert [dataclasses.astuple(m) for m in pm] == [dataclasses.astuple(m) for m in jm]
    for b in (j, p):
        b.kill_broker(1)
        b.alter_partition_reassignments({("demo-0", 0): [2, 3, 4], ("demo-1", 0): None})
        b.elect_leaders([("demo-2", 0)])
        b.list_partition_reassignments()
    assert p.list_ongoing_reassignments() == j.list_ongoing_reassignments()
    topo = {
        name: [dataclasses.astuple(i) for i in infos] for name, infos in p.describe_topics().items()
    }
    assert topo == {
        name: [dataclasses.astuple(i) for i in infos] for name, infos in j.describe_topics().items()
    }
    assert p.admin_log == j.admin_log


def test_retry_policy_backoff_and_outcomes_match_jax():
    from cruise_control_tpu.core.retry import RetryPolicy as JRetry
    from cruise_control_tpu_torch.core.retry import RetryExhaustedError, RetryPolicy

    def run(cls):
        slept = []
        pol = cls(max_attempts=4, seed=5, sleep=slept.append)
        calls = iter([ConnectionError("a"), TimeoutError("b"), "ok"])

        def flaky():
            v = next(calls)
            if isinstance(v, Exception):
                raise v
            return v

        return pol.call(flaky, op_name="flaky"), slept, pol

    jr, jslept, _ = run(JRetry)
    pr, pslept, pol = run(RetryPolicy)
    assert pr == jr == "ok" and pslept == jslept and len(pslept) == 2
    with pytest.raises(RetryExhaustedError):
        pol.call(lambda: (_ for _ in ()).throw(OSError("down")), op_name="down")
    with pytest.raises(ValueError):   # not retryable: raised as it is
        pol.call(lambda: (_ for _ in ()).throw(ValueError("bad")))


# -- the optimizer's broker bucketing reads the environment lazily -------------------


@pytest.mark.parametrize("env,want", [(None, True), ("0", False), ("false", False), ("", False), ("1", True)])
def test_bucket_brokers_reads_the_environment_lazily(monkeypatch, env, want):
    from cruise_control_tpu.analyzer import GoalOptimizer as JOpt
    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    monkeypatch.delenv("CC_TPU_BUCKET_BROKERS", raising=False)
    port, ref = GoalOptimizer(device="cpu"), JOpt()
    # read at first use, not at construction
    if env is not None:
        monkeypatch.setenv("CC_TPU_BUCKET_BROKERS", env)
    assert port.bucket_brokers is ref.bucket_brokers is want
    port.bucket_brokers = not want
    assert port.bucket_brokers is (not want)
    assert GoalOptimizer(bucket_brokers=False, device="cpu").bucket_brokers is False


def test_unbucketed_optimizer_solves_at_the_exact_broker_count(monkeypatch):
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, _ = generate(SyntheticSpec(num_brokers=5, num_racks=5, num_topics=2, num_partitions=20), device="cpu")
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cpu")
    seen = []
    monkeypatch.setenv("CC_TPU_BUCKET_BROKERS", "0")
    opt = GoalOptimizer(goal_ids=(G.RACK_AWARE,), hard_ids=(G.RACK_AWARE,), device="cpu")
    real = opt._optimize_core
    monkeypatch.setattr(opt, "_optimize_core", lambda s, c, **kw: (seen.append(s.num_brokers), real(s, c, **kw))[1])
    opt.optimize(state, ctx)
    assert seen == [5]   # 8 with bucketing on


# -- fast_sweep takes the JAX signature's mesh= ---------------------------------------

SWEEP_SPEC = dict(num_brokers=8, num_racks=2, num_topics=2, num_partitions=24, replication_factor=2,
                  distribution="exponential", skew_brokers=2, seed=3)
SWEEP_FACTORS = (1.0, 1.5, 3.0)


def test_fast_sweep_takes_mesh_none_and_refuses_a_mesh():
    """``mesh=None`` sweeps on the given device; a mesh that is not the
    port's rank mesh (here a bare object, as a JAX device mesh would be)
    raises instead of sweeping unsharded."""
    from cruise_control_tpu_torch.sim import Scenario, fast_sweep
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, _ = generate(SyntheticSpec(num_brokers=4, num_racks=2, num_topics=2, num_partitions=12), device="cpu")
    res = fast_sweep(state, [Scenario(name="as-is")], mesh=None, device="cpu")
    assert res.sweep_size == 1
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        fast_sweep(state, [Scenario(name="as-is")], mesh=object(), device="cpu")


def test_fast_sweep_over_a_mesh_equals_mesh_none_and_the_jax_sweep():
    """``fast_sweep(mesh=)`` shards the scenario axis over 2 gloo ranks (5
    scenarios: padded to 6 by repeating scenario 0, the padding trimmed):
    every rank's verdicts equal ``mesh=None`` and the JAX ``fast_sweep`` on a
    2-device mesh, exactly."""
    import jax

    from cruise_control_tpu import sim as JSIM
    from cruise_control_tpu import synthetic as JS
    from cruise_control_tpu.analyzer import goals_base as JG
    from cruise_control_tpu.parallel import solver_mesh
    from cruise_control_tpu_torch.parallel import run_ranks
    from tests import torch_parallel_tasks as T

    goals = (JG.RACK_AWARE, JG.REPLICA_CAPACITY, JG.DISK_CAPACITY, JG.DISK_USAGE_DIST)
    runs = run_ranks(T.sweep, 2, device="cpu", args=(SWEEP_SPEC, SWEEP_FACTORS + (2.0,), goals), timeout_s=300)
    jbase, _ = JS.generate(JS.SyntheticSpec(**SWEEP_SPEC))
    scenarios = [JSIM.Scenario(**dataclasses.asdict(s)) for s in T.sweep_scenarios(SWEEP_FACTORS + (2.0,))]
    jres = JSIM.fast_sweep(jbase, scenarios, goal_ids=goals, mesh=solver_mesh(jax.devices()[:2]))
    want = [v.to_dict() for v in jres.scenarios]
    assert len(want) == 5
    for sharded, whole, syncs in runs:
        assert sharded == whole == want
        assert syncs == 1
