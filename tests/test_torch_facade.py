"""The port's ``CruiseControl`` facade against the JAX package's.

Both stacks -- fake backend, load monitor, solver, executor, facade -- are
built over one seeded numpy cluster and driven on one window-aligned clock
with the four-goal list of the JAX control-loop harness
(``controller/bench.py``).  Exact: the model's ``ClusterArrays`` leaves, the
proposals of a dry-run rebalance, the execution summary's counts, the
backend's admin log and its final replica lists and leaders; the flight
records of the port carry every attribute name of the JAX records.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import backend_placement
from cruise_control_tpu import facade as JF
from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.backend import FakeClusterBackend as JFake
from cruise_control_tpu.core.resources import Resource as JResource
from cruise_control_tpu.executor import Executor as JExecutor
from cruise_control_tpu.monitor import BackendMetricSampler as JSampler
from cruise_control_tpu.monitor import LoadMonitor as JLoadMonitor
from cruise_control_tpu.monitor import StaticCapacityResolver as JStatic
from cruise_control_tpu.obs import RECORDER as JRECORDER
from cruise_control_tpu_torch import facade as PF
from cruise_control_tpu_torch.obs import RECORDER
from tests import torch_parallel_tasks as T
from tests.torch_port_helpers import assert_fields_same, assert_keys_superset

WINDOW_MS = 60_000
#: controller/bench.py's trimmed goal list
GOALS = (JG.RACK_AWARE, JG.REPLICA_CAPACITY, JG.DISK_CAPACITY, JG.DISK_USAGE_DIST)
SPEC = dict(
    num_racks=3, num_brokers=9, num_topics=4, num_partitions=48,
    replication_factor=2, distribution="exponential", skew_brokers=3,
    mean_cpu=0.2, mean_disk=0.25, mean_nw_in=0.15, mean_nw_out=0.15, seed=5,
)
SIDES = {
    "jax": ((JFake, JSampler, JStatic, JLoadMonitor, JExecutor, JF.CruiseControl, JResource), {}),
    "port": (T.port_facade_classes(), {"device": "cpu"}),
}
HARD = tuple(g for g in GOALS if g in JG.HARD_GOALS)


def build(side):
    classes, kw = SIDES[side]
    return T.facade_stack(classes, SPEC, GOALS, HARD, WINDOW_MS, kw)


def _proposals(res):
    return [dataclasses.astuple(p) for p in res.optimizer_result.proposals]


def _summary(s):
    d = dataclasses.asdict(s)
    d.pop("duration_s")
    return d


@pytest.fixture(scope="module")
def pair():
    """Both facades after a dry run and an executed rebalance, with the
    flight records of those runs."""
    out = {}
    for side, rec in (("jax", JRECORDER), ("port", RECORDER)):
        cc = build(side)
        model = cc.cluster_model()
        rec.clear()
        dry = cc.rebalance(dryrun=True)
        records = list(reversed(rec.recent(rec.capacity)))
        done = cc.rebalance(dryrun=False)
        out[side] = dict(cc=cc, model=model, dry=dry, records=records, done=done)
    return out


def test_model_arrays_equal_the_jax_model(pair):
    jstate, jmaps = pair["jax"]["model"].to_arrays()
    pstate, pmaps = pair["port"]["model"].to_arrays(device="cpu")
    assert_fields_same(pstate, jstate)
    assert dataclasses.asdict(pmaps) == dataclasses.asdict(jmaps)


def test_dry_run_proposals_equal_the_jax_facade(pair):
    j, p = pair["jax"]["dry"], pair["port"]["dry"]
    assert p.dryrun and p.execution is None
    assert _proposals(p) and _proposals(p) == _proposals(j)
    jr, pr = j.optimizer_result, p.optimizer_result
    assert pr.violations_after == jr.violations_after and pr.total_moves == jr.total_moves
    assert pr.residual_hard_violations == 0


def test_flight_records_carry_the_jax_attribute_names(pair):
    jrec, prec = pair["jax"]["records"], pair["port"]["records"]
    assert [r.kind for r in prec] == [r.kind for r in jrec] == ["model", "optimize"]
    for p, j in zip(prec, jrec):
        assert_keys_superset(p.attrs, j.attrs)
        assert [(s.kind, s.name) for s in p.spans] == [(s.kind, s.name) for s in j.spans]
        for ps, js in zip(p.spans, j.spans):
            assert_keys_superset(ps.attrs, js.attrs)
    opt = prec[1]
    assert opt.total_dispatches == opt.attrs["num_dispatches"] == pair["port"]["dry"].optimizer_result.num_host_syncs
    assert opt.platform == "cpu" and opt.compile_events == []


def test_execution_equals_the_jax_execution(pair):
    j, p = pair["jax"]["done"], pair["port"]["done"]
    assert _proposals(p) == _proposals(pair["port"]["dry"])
    assert p.execution.succeeded and _summary(p.execution) == _summary(j.execution)
    jb, pb = pair["jax"]["cc"].backend, pair["port"]["cc"].backend
    assert pb.admin_log == jb.admin_log
    placement = backend_placement(pb)
    assert placement == backend_placement(jb)
    assert all(placement[p.tp] == (p.new_replicas, p.new_replicas[0]) for p in p.optimizer_result.proposals)
    # sampling was paused for the move and resumed after it
    assert pair["port"]["cc"].monitor.state().state == "RUNNING"


def test_state_after_the_execution_matches(pair):
    js, ps = pair["jax"]["cc"].state(), pair["port"]["cc"].state()
    for s in (js, ps):
        s.pop("uptime_s")
        s["ExecutorState"]["lastExecution"].pop("durationS")
    assert ps == js


def test_model_after_the_execution_has_no_hard_violation(pair):
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer

    state, _ = pair["port"]["cc"].cluster_model().to_arrays(device="cpu")
    viol = GoalOptimizer(goal_ids=GOALS, device="cpu").violations(
        state, GoalContext.build(state.num_topics, state.num_brokers, device="cpu"))
    assert float(viol[list(g for g in GOALS if g in JG.HARD_GOALS)].sum()) == 0


#: the fix operations the detector's anomalies run (``detector/anomalies.py``),
#: each with the fault that calls for it
FIX_OPS = {
    "remove_brokers": (lambda b: b.kill_broker(2), lambda cc, **kw: cc.remove_brokers([2], **kw)),
    "demote_brokers": (None, lambda cc, **kw: cc.demote_brokers([0, 1], **kw)),
    "fix_offline_replicas": (lambda b: b.kill_logdir(4, "/data/d0"), lambda cc, **kw: cc.fix_offline_replicas(**kw)),
    "add_brokers": (None, lambda cc, **kw: cc.add_brokers([7, 8], **kw)),
}


@pytest.mark.parametrize("op", sorted(FIX_OPS))
def test_fix_operation_equals_the_jax_facade(op):
    """A dry run, then the executed operation, on both facades: identical
    proposals, execution counts, admin log and final placement."""
    fault, run = FIX_OPS[op]
    out = {}
    for side in ("jax", "port"):
        cc = build(side)
        if fault is not None:
            fault(cc.backend)
        dry = run(cc, dryrun=True)
        done = run(cc, dryrun=False)
        out[side] = (_proposals(dry), _proposals(done), done.execution and _summary(done.execution),
                     cc.backend.admin_log, backend_placement(cc.backend))
    assert out["port"] == out["jax"]
    dry, done, summary, _, placement = out["port"]
    assert done == dry
    if op == "demote_brokers":
        # the two leadership goals find no admissible leader swap on this
        # cluster, in the JAX package as in the port: nothing to execute
        assert dry == [] and summary is None
        return
    assert dry and summary["completed"] > 0 and summary["dead"] == summary["failed"] == 0
    if op == "remove_brokers":
        assert all(2 not in replicas for replicas, _ in placement.values())


def test_replication_factor_update_equals_the_jax_facade():
    out = {}
    for side in ("jax", "port"):
        res = build(side).update_topic_replication_factor("T[01]", 3, dryrun=True)
        out[side] = _proposals(res)
    assert out["port"] and out["port"] == out["jax"]


def test_cpu_model_training_equals_the_jax_facade():
    out = {}
    for side in ("jax", "port"):
        cc = build(side)
        out[side] = (cc.train_cpu_model(), getattr(cc, "trained_cpu_weights", None))
    assert out["port"][0] is out["jax"][0]
    if out["port"][0]:
        np.testing.assert_array_equal(dataclasses.astuple(out["port"][1]), dataclasses.astuple(out["jax"][1]))


def test_sweeps_and_rollouts_run_through_the_facade_on_its_device():
    from cruise_control_tpu_torch.sim import Scenario
    from cruise_control_tpu_torch.traces import AutoscalePolicy, diurnal_trace

    cc = build("port")
    sweep = cc.simulate([Scenario(name="as-is"), Scenario(name="x2", load_factor=2.0)])
    assert sweep.sweep_size == 2 and sweep.to_dict()["sweep"]["numDispatches"] == 1
    # the facade hands mesh= to the fast sweep: sharded over 2 gloo ranks
    # (each rank builds this test's port stack), every rank's verdicts equal
    # its own unsharded sweep's and the JAX facade's sweep on a 2-device mesh
    import jax

    from cruise_control_tpu.parallel import solver_mesh as jsolver_mesh
    from cruise_control_tpu.sim import Scenario as JScenario
    from cruise_control_tpu_torch.parallel import run_ranks

    factors = (1.0, 2.0, 0.5)
    runs = run_ranks(T.facade_sweep, 2, device="cpu", args=(SPEC, GOALS, HARD, WINDOW_MS, factors), timeout_s=300)
    jsweep = build("jax").simulate([JScenario(name=f"x{f}", load_factor=f) for f in factors],
                                   mesh=jsolver_mesh(jax.devices()[:2]))
    want = [v.to_dict() for v in jsweep.scenarios]
    for sharded, whole in runs:
        assert len(sharded) == 3 and sharded == whole == want
    assert cc.simulate([Scenario(name="as-is")], deep=True).deep
    plan = cc.plan_capacity(load_factor=1.0)
    assert plan.min_brokers is not None
    roll = cc.trace_rollout([diurnal_trace(num_steps=4)], [AutoscalePolicy(name="p")])
    assert roll.num_host_syncs == 1
    assert cc.trace_horizon(diurnal_trace(num_steps=4))["numDispatches"] == 1


def test_facade_defaults_to_the_card_and_raises_without_it(monkeypatch):
    cc = build("port")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PF.CruiseControl(cc.backend, cc.monitor, cc.executor)
    assert cc.device == torch.device("cpu")
    assert cc._optimizer(None).device == torch.device("cpu")
