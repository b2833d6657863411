"""The port's continuous controller and its journals against the JAX package,
on the CPU.

* ``ClusterModel.to_arrays``: every ``tests/fixtures.py`` cluster (and JBOD,
  broker-state and padding variants), leaf by leaf, with equal index maps.
* The write-ahead journal: each package replays the other's segments
  (rotation, a crash's open segment, a corrupt tail, legacy lines).
* The standing-proposal-set journal: the cases of
  ``tests/test_controller.py::TestStandingJournal``, and each package
  recovers the other's journal.
* The loop: one duck facade (``tests/torch_controller_parity.py``) drives a
  JAX and a port ``ContinuousController`` on one fake clock through warm
  start, load shifts, ``maybe_tick``, pause/resume, an idle wake, a refused
  publish and crash/recover.  Drift reports, versions and standing sets must
  be identical (every field but the wall clock's ``created_ms``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.proposals import ExecutionProposal as JProposal
from cruise_control_tpu.controller.loop import ContinuousController as JController
from cruise_control_tpu.controller.loop import ControllerConfig as JConfig
from cruise_control_tpu.controller.standing import ControllerJournal as JCJournal
from cruise_control_tpu.core.journal import Journal as JJournal
from cruise_control_tpu.model.cluster import BrokerState as JBrokerState
from cruise_control_tpu.model.cluster import ClusterModel as JClusterModel
from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.controller import ContinuousController, ControllerConfig
from cruise_control_tpu_torch.controller.standing import (
    ControllerJournal,
    FencedEpochError,
    StandingProposalSet,
)
from cruise_control_tpu_torch.core.journal import Journal, SimulatedCrash
from cruise_control_tpu_torch.core.sensors import REGISTRY
from cruise_control_tpu_torch.model.cluster import BrokerState
from tests import fixtures
from tests import torch_controller_parity as H
from tests.torch_port_helpers import (
    assert_keys_superset,
    assert_records_match,
    clear_records,
    port_cluster_model,
)


# -- ClusterModel.to_arrays -------------------------------------------------------


def _jbod_states() -> JClusterModel:
    """Two logdirs a broker, a dead and a removed logdir, every broker state."""
    m = fixtures.homogeneous_cluster(fixtures.RACK_BY_BROKER4, logdirs={"/d0": 1.5e5, "/d1": 1.5e5})
    for p in range(7):
        tp = ("T%d" % (p % 3), p)
        brokers = [p % 6, (p + 2) % 6]
        for i, b in enumerate(brokers):
            m.create_replica(b, tp, i, i == 0, logdir="/d%d" % (p % 2), is_original=(p != 3))
            if p != 5:
                m.set_replica_load(b, tp, [1.0 + p, 10.0 * p, 0.0 if i else 7.5 * p, 100.0 + p])
    m.mark_disk_dead(1, "/d1")
    m.mark_disk_removed(2, "/d0")
    m.set_broker_state(3, JBrokerState.DEAD)
    m.set_broker_state(4, JBrokerState.NEW)
    m.set_broker_state(5, JBrokerState.DEMOTED)
    return m


MODELS = {
    "unbalanced": fixtures.unbalanced,
    "unbalanced2": fixtures.unbalanced2,
    "unbalanced_with_a_follower": fixtures.unbalanced_with_a_follower,
    "rack_aware_satisfiable": fixtures.rack_aware_satisfiable,
    "rack_aware_unsatisfiable": fixtures.rack_aware_unsatisfiable,
    "jbod_states": _jbod_states,
    "controller_bench": lambda: H.jax_model(H.base_loads()),
}


@pytest.mark.parametrize("pad", [None, dict(pad_replicas_to=128, pad_partitions_to=64, pad_topics_to=9)],
                         ids=["unpadded", "padded"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_cluster_model_to_arrays_matches(name, pad):
    jmodel = MODELS[name]()
    jstate, jmaps = jmodel.to_arrays(**(pad or {}))
    pstate, pmaps = port_cluster_model(jmodel).to_arrays(**(pad or {}), device="cpu")
    for f in dataclasses.fields(jstate):
        want, got = getattr(jstate, f.name), getattr(pstate, f.name)
        if isinstance(got, torch.Tensor):
            w = np.asarray(want)
            assert got.numpy().dtype == w.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f.name)
        else:
            assert got == want, f.name
    assert dataclasses.asdict(pmaps) == dataclasses.asdict(jmaps)
    assert port_cluster_model(jmodel).replica_distribution() == jmodel.replica_distribution()


def test_cluster_model_queries_and_errors():
    jmodel = _jbod_states()
    pmodel = port_cluster_model(jmodel)
    assert pmodel.brokers() == jmodel.brokers()
    assert pmodel.partitions() == jmodel.partitions()
    assert pmodel.leader_distribution() == jmodel.leader_distribution()
    assert [pmodel.broker_state(b) for b in pmodel.brokers()] == [jmodel.broker_state(b) for b in jmodel.brokers()]
    assert BrokerState.DEMOTED == JBrokerState.DEMOTED
    with pytest.raises(ValueError):
        pmodel.create_broker("0", 0, fixtures.BROKER_CAPACITY)
    with pytest.raises(ValueError):
        pmodel.create_replica(0, ("T0", 0), 0, True)
    with pytest.raises(ValueError):
        pmodel.to_arrays(pad_replicas_to=1, device="cpu")
    pmodel.delete_replica(0, ("T0", 0))
    jmodel.delete_replica(0, ("T0", 0))
    assert pmodel.replica_distribution() == jmodel.replica_distribution()


# -- the journal --------------------------------------------------------------------


def _records(n: int, tag: str):
    return [{"type": "t", "i": i, "tag": tag, "x": 0.1 * i, "nested": {"a": [i, None]}} for i in range(n)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journals_replay_each_other(tmp_path, writer):
    """Rotation every 3 records, a crashed writer's open segment, a corrupt
    tail line and a legacy (unenveloped) line: both packages replay the same
    records and count the same skips."""
    W = Journal if writer == "port" else JJournal
    d = str(tmp_path / "wal")
    j = W(d, max_segment_records=3)
    j.append_many(_records(7, "a"))
    j.close()
    j2 = W(d, max_segment_records=3)
    j2.append({"type": "open", "i": 99})      # left .open: a crash
    with open(os.path.join(d, sorted(os.listdir(d))[0]), "a") as fh:
        fh.write('{"c":"00000000","r":{"type":"bad"}}\n{"type":"after-corruption"}\n')
    with open(os.path.join(d, "segment-000900.jsonl"), "w") as fh:
        fh.write(json.dumps({"type": "legacy", "i": 1}) + "\n")
    got_port, got_jax = Journal(d).replay(), JJournal(d).replay()
    assert list(got_port) == list(got_jax)
    assert got_port.skipped == got_jax.skipped == 2
    assert got_port.segments == got_jax.segments
    assert [r["i"] for r in got_port if r["type"] == "t"] == list(range(7))
    assert got_port[-1]["type"] == "legacy"


def test_journal_crash_point_and_truncate(tmp_path):
    j = Journal(str(tmp_path / "wal"))
    j.crash_after_appends = 2
    j.append({"i": 0})
    j.append({"i": 1})
    with pytest.raises(SimulatedCrash):
        j.append({"i": 2})
    assert [r["i"] for r in JJournal(str(tmp_path / "wal")).replay()] == [0, 1]
    j.truncate()
    assert list(Journal(str(tmp_path / "wal")).replay()) == []
    with pytest.raises(ValueError):
        Journal(str(tmp_path / "x"), fsync="sometimes")


# -- the standing-proposal-set journal (TestStandingJournal) ------------------------


def _proposals(n: int = 2, cls=ExecutionProposal):
    return [cls(tp=("T", i), partition_size=1.0, old_leader=0, old_replicas=(0, 1), new_replicas=(0, 2))
            for i in range(n)]


def _set(version, n=2, trigger="drift"):
    return StandingProposalSet(version=version, created_ms=123, trigger=trigger, drift=2.0,
                               proposals=_proposals(n), reaction_s=0.01)


def _cj(tmp_path, port=True):
    return (ControllerJournal(Journal(str(tmp_path / "controller"))) if port
            else JCJournal(JJournal(str(tmp_path / "controller"))))


def test_publish_supersede_drain_recover(tmp_path):
    j = _cj(tmp_path)
    j.published(_set(1))
    j.published(_set(2, n=3))
    j.invalidated(1, "superseded")
    standing, max_v, records, _ = _cj(tmp_path).recover()
    assert standing.version == 2 and len(standing.proposals) == 3
    assert standing.proposals[0].new_replicas == (0, 2)
    assert max_v == 2 and records == 3
    _cj(tmp_path).drained(2)
    standing3, max_v3, _, _ = _cj(tmp_path).recover()
    assert standing3 is None and max_v3 == 0


def test_crash_between_publish_and_invalidate_resumes_newest(tmp_path):
    j = _cj(tmp_path)
    j.published(_set(1))
    j.published(_set(2))
    assert _cj(tmp_path).recover()[0].version == 2


def test_rewrite_compacts_to_the_standing_set(tmp_path):
    j = _cj(tmp_path)
    for v in range(1, 6):
        j.published(_set(v))
        if v > 1:
            j.invalidated(v - 1, "superseded")
    assert j.journal.appends == 9
    j.rewrite(_set(5, n=3))
    j2 = _cj(tmp_path)
    records = j2.journal.replay()
    assert len(records) == 1 and records[0]["version"] == 5
    standing, _, _, _ = j2.recover()
    assert standing.version == 5 and len(standing.proposals) == 3


def test_recover_compacts_superseded_history(tmp_path):
    j = _cj(tmp_path)
    for v in range(1, 4):
        j.published(_set(v))
    controller = ContinuousController(H.Duck(True, H.base_loads()), journal=_cj(tmp_path), device="cpu")
    assert controller.recover() == 3
    assert controller.standing.version == 3
    replayed = Journal(str(tmp_path / "controller")).replay()
    published = [r for r in replayed if r["type"] == "published"]
    assert len(published) == 1 and published[0]["version"] == 3
    assert [r for r in replayed if r["type"] == "epoch"]
    assert controller.journal.epoch == 1


def test_refused_publish_append_raises(tmp_path):
    j = _cj(tmp_path)
    j.published(_set(1))
    j.journal.crash_after_appends = j.journal.appends
    with pytest.raises(SimulatedCrash):
        j.published(_set(2))
    assert _cj(tmp_path).recover()[0].version == 1


def test_fencing_refuses_a_deposed_writer(tmp_path):
    old = _cj(tmp_path)
    old.fence(1)
    old.published(_set(1))
    new = _cj(tmp_path)
    new.fence(2)
    with pytest.raises(FencedEpochError):
        old.published(_set(2))
    with pytest.raises(FencedEpochError):
        old.fence(1)
    standing, _, _, epoch = _cj(tmp_path, port=False).recover()
    assert standing.version == 1 and epoch == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_standing_journals_recover_each_other(tmp_path, writer):
    """A standing-set journal either package wrote recovers to the same set
    in both (every field, the proposals record for record)."""
    wj = _cj(tmp_path, port=(writer == "port"))
    cls = ExecutionProposal if writer == "port" else JProposal
    wj.fence(3)
    for v in (1, 2, 3):
        s = _set(v, n=v)
        s = dataclasses.replace(s, proposals=_proposals(v, cls))
        wj.published(s)
    wj.invalidated(2, "superseded")
    wj.invalidated(3, "topology-changed")
    p_out = _cj(tmp_path, port=True).recover()
    j_out = _cj(tmp_path, port=False).recover()
    assert H.set_key(p_out[0], True) == H.set_key(j_out[0], False)
    assert p_out[1:] == j_out[1:] == (3, 6, 3)
    assert p_out[0].version == 1


# -- the loop against the JAX loop ---------------------------------------------------


class Pair:
    """A JAX and a port controller on one duck-built cluster and one clock."""

    def __init__(self, tmp_path=None, **cfg):
        self.clock = H.FakeClock()
        self.loads = {"jax": H.base_loads(), "port": H.base_loads()}
        self.ducks = {k: H.Duck(k == "port", self.loads[k]) for k in ("jax", "port")}
        kw = dict(H.TICK_CFG, **cfg)
        self.ctl = {
            "jax": JController(self.ducks["jax"], journal=self._journal(tmp_path, "jax"),
                               config=JConfig(**kw), clock=self.clock),
            "port": ContinuousController(self.ducks["port"], journal=self._journal(tmp_path, "port"),
                                         config=ControllerConfig(**kw), clock=self.clock, device="cpu"),
        }
        for k, c in self.ctl.items():
            self.ducks[k].monitor.add_window_listener(c.on_window_delta)
        self.hot = {"jax": [], "port": []}
        self.window = 0

    @staticmethod
    def _journal(tmp_path, side):
        if tmp_path is None:
            return None
        d = str(tmp_path / side / "controller")
        return ControllerJournal(Journal(d)) if side == "port" else JCJournal(JJournal(d))

    def warm_start(self):
        for c in self.ctl.values():
            c.warm_start()

    def shift(self, victim):
        for k, c in self.ctl.items():
            self.hot[k] = H.shift(self.loads[k], c, victim, self.hot[k])
        assert self.hot["jax"] == self.hot["port"]

    def deliver(self, lag_s=2.5):
        self.clock.t += 5.0
        self.window += 1
        for d in self.ducks.values():
            d.push_delta(self.clock, self.window)
        self.clock.t += lag_s

    def tick(self, **kw):
        """Tick both; assert identical outcomes; return the port's set."""
        js = self.ctl["jax"].maybe_tick(**kw)
        ps = self.ctl["port"].maybe_tick(**kw)
        self.assert_same()
        assert H.set_key(ps, True) == H.set_key(js, False)
        return ps

    def assert_same(self):
        j, p = self.ctl["jax"], self.ctl["port"]
        assert H.drift_key(p._last_drift) == H.drift_key(j._last_drift)
        assert H.set_key(p.standing, True) == H.set_key(j.standing, False)
        assert p._version == j._version
        np.testing.assert_array_equal(p._state_host.replica_broker.numpy(),
                                      np.asarray(j._state_host.replica_broker))
        for side in ("_candidate_host",):
            jc, pc = getattr(j, side), getattr(p, side)
            assert (jc is None) == (pc is None)
            if pc is not None:
                np.testing.assert_array_equal(pc.replica_broker.numpy(), np.asarray(jc.replica_broker))
                np.testing.assert_array_equal(pc.partition_leader.numpy(), np.asarray(jc.partition_leader))
        ps, js = p.status(), j.status()
        for key in ("state", "paused", "drift", "balancedness", "violatedGoals", "standing", "topology", "epoch"):
            if key == "standing" and ps[key] is not None:
                assert {k: v for k, v in ps[key].items() if k != "createdMs"} == \
                       {k: v for k, v in js[key].items() if k != "createdMs"}
            else:
                assert ps[key] == js[key], key


@pytest.fixture(scope="module")
def _jax_warm():
    """One JAX warm start for the module: later controllers of the same
    shapes reuse its compiled programs."""
    Pair().ctl["jax"].warm_start()


def test_warm_start_mirrors_match(_jax_warm):
    pair = Pair()
    pair.warm_start()
    j, p = pair.ctl["jax"], pair.ctl["port"]
    for f in dataclasses.fields(p._state_host):
        got, want = getattr(p._state_host, f.name), getattr(j._state_host, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
            assert got.numpy().dtype == np.asarray(want).dtype, f.name
        else:
            assert got == want, f.name
    assert p._bucket == j._bucket == 8
    np.testing.assert_array_equal(p._part_base, j._part_base)
    np.testing.assert_array_equal(p._part_delta, j._part_delta)
    assert p._state.device.type == "cpu" and p.warmed and j.warmed


def test_shift_ticks_supersede_and_pause_match_jax(tmp_path, _jax_warm):
    pair = Pair(tmp_path)
    pair.warm_start()
    pair.shift(0)
    pair.deliver()
    s1 = pair.tick()
    assert s1 is not None and s1.version == 1 and s1.trigger == "drift"
    assert s1.proposals and s1.reaction_s == 2.5
    attrs = pair.ctl["port"]._last_tick_attrs
    assert attrs["goals_run"] == pair.ctl["jax"]._last_tick_attrs["goals_run"]
    assert attrs["moves"] == pair.ctl["jax"]._last_tick_attrs["moves"]
    # the JAX tick's keys (num_dispatches, which the replay harness reads) beside the port's
    assert_keys_superset(attrs, pair.ctl["jax"]._last_tick_attrs)
    assert attrs["num_dispatches"] == attrs["num_host_syncs"]
    assert [s.name for s in pair.ctl["port"].last_spans] == ["ingest", "drift", "optimize", "publish"]

    # an idle wake: same loads, a fresh delta; drift against the residual is 0
    pair.deliver()
    assert pair.tick() is None
    assert pair.ctl["port"].standing.version == 1

    # paused: the evidence waits; resumed: the tick answers it
    for c in pair.ctl.values():
        c.pause("maintenance")
    pair.shift(1)
    pair.deliver(lag_s=1.25)
    assert pair.tick() is None
    assert pair.ctl["port"].status()["state"] == "paused"
    for c in pair.ctl.values():
        c.resume("done")
    s2 = pair.tick()
    assert s2 is not None and s2.version == 2
    assert pair.ctl["port"].status()["state"] == "running"

    # a forced tick with nothing new still publishes when there is a diff
    pair.tick(force=True)
    # the journals: the same record types in the same order
    j_recs = JJournal(str(tmp_path / "jax" / "controller")).replay()
    p_recs = Journal(str(tmp_path / "port" / "controller")).replay()
    assert [r["type"] for r in p_recs] == [r["type"] for r in j_recs]
    assert [r.get("version") for r in p_recs] == [r.get("version") for r in j_recs]
    assert REGISTRY.timer("Controller.reaction-latency-timer").count >= 2


def test_tick_flight_records_match_jax(_jax_warm):
    """A published tick, then an idle (skipped) one: each package writes one
    ``controller_tick`` record a tick, of one shape, and the port's
    ``last_spans`` are its last record's spans."""
    from cruise_control_tpu_torch.obs import RECORDER

    pair = Pair()
    pair.warm_start()
    clear_records()
    pair.shift(0)
    pair.deliver()
    assert pair.tick() is not None
    pair.deliver()
    assert pair.tick() is None
    assert_records_match("controller_tick", count=2)
    (last,) = RECORDER.recent(1, kind="controller_tick")
    assert last.spans == pair.ctl["port"].last_spans and last.attrs["skipped"] is True


def test_refused_publish_and_crash_recover_match_jax(tmp_path, _jax_warm):
    """A publish refused by the journal keeps the old set (write-ahead); a
    fresh controller on the journal resumes it, in both packages -- and
    each package's controller recovers the OTHER's journal to the same set."""
    pair = Pair(tmp_path)
    pair.warm_start()
    pair.shift(0)
    pair.deliver()
    s1 = pair.tick()
    assert s1 is not None
    for c in pair.ctl.values():
        c.journal.journal.crash_after_appends = c.journal.journal.appends
    pair.shift(1)
    pair.deliver()
    assert pair.tick() is None
    assert pair.ctl["port"].standing is s1
    assert pair.ctl["port"]._last_tick_attrs["error"].startswith("SimulatedCrash")
    for c in pair.ctl.values():
        c.kill()

    recovered = {}
    for side, journal_side in (("jax", "jax"), ("port", "port"), ("jax", "port"), ("port", "jax")):
        fresh = Pair()
        ctl = fresh.ctl[side]
        d = str(tmp_path / journal_side / "controller")
        ctl.journal = ControllerJournal(Journal(d)) if side == "port" else JCJournal(JJournal(d))
        records = ctl.recover()
        recovered[(side, journal_side)] = (records, H.set_key(ctl.standing, side == "port"))
    keys = {v[1][:3] + (json.dumps(v[1][5]),) for v in recovered.values()}
    assert len(keys) == 1
    assert recovered[("port", "port")][1][0] == 1


def test_controller_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousController(H.Duck(True, H.base_loads()))
