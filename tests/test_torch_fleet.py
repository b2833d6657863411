"""The port's fleet controller (``cruise_control_tpu_torch/fleet``) against
the JAX package, on the CPU.

A fleet tick of three tenants (the JAX controller bench's cluster, each
tenant shifted on its own broker) must publish, for every tenant, the
standing set the JAX fleet publishes and the one that tenant's standalone
port controller publishes from the same shift.  Tenants group as the JAX
fleet groups them (goal order, hard goals, shapes, context contents).  The
coordinator's host plumbing -- tenant names, pause/resume, drain
arbitration, the legacy journal namespace -- is the JAX package's, checked
here on the port.
"""

import os

import pytest
import torch

from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.fleet import FleetConfig as JFleetConfig
from cruise_control_tpu.fleet import FleetController as JFleet
from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.controller import ContinuousController, ControllerConfig
from cruise_control_tpu_torch.controller.standing import ControllerJournal, StandingProposalSet
from cruise_control_tpu_torch.core.journal import Journal
from cruise_control_tpu_torch.fleet import (
    RESERVED_TENANT_NAMES,
    FleetConfig,
    FleetController,
    adopt_legacy_namespace,
)
from cruise_control_tpu_torch.model import arrays as A
from tests import torch_controller_parity as H
from tests.torch_port_helpers import assert_keys_superset, assert_records_match, clear_records

N = 3
ALT_GOALS = (JG.RACK_AWARE, JG.REPLICA_CAPACITY, JG.DISK_CAPACITY)


class Trio:
    """A JAX fleet, a port fleet and N standalone port controllers, each
    tenant on its own copy of the cluster, one fake clock for all."""

    def __init__(self, tenants):
        """``tenants``: [(name, goals, hard goals, victim)]."""
        self.clock = H.FakeClock()
        self.jfleet = JFleet(config=JFleetConfig(**H.TICK_CFG), clock=self.clock)
        self.pfleet = FleetController(config=FleetConfig(**H.TICK_CFG), clock=self.clock, device="cpu")
        self.tenants = tenants
        self.loads, self.ducks, self.solos, self.hot = {}, {}, {}, {}
        for name, goals, hard, _ in tenants:
            for side in ("jax", "port", "solo"):
                self.loads[side, name] = H.base_loads()
                self.ducks[side, name] = H.Duck(side != "jax", self.loads[side, name], goals, hard)
                self.hot[side, name] = []
            self.jfleet.add_tenant(name, self.ducks["jax", name])
            self.pfleet.add_tenant(name, self.ducks["port", name])
            solo = ContinuousController(self.ducks["solo", name], config=ControllerConfig(**H.TICK_CFG),
                                        clock=self.clock, device="cpu")
            self.ducks["solo", name].monitor.add_window_listener(solo.on_window_delta)
            self.solos[name] = solo
        self.window = 0

    def controllers(self, name):
        return {"jax": self.jfleet.tenant(name).controller, "port": self.pfleet.tenant(name).controller,
                "solo": self.solos[name]}

    def warm_start(self):
        for name, *_ in self.tenants:
            for c in self.controllers(name).values():
                c.warm_start()

    def shift(self, offset=0):
        for name, _, _, victim in self.tenants:
            for side, c in self.controllers(name).items():
                self.hot[side, name] = H.shift(self.loads[side, name], c, (victim + offset) % H.BROKERS,
                                               self.hot[side, name])
        self.clock.t += 5.0
        self.window += 1
        for d in self.ducks.values():
            d.push_delta(self.clock, self.window)
        self.clock.t += 1.5

    def tick(self):
        clear_records()
        ja, pa = self.jfleet.maybe_tick(), self.pfleet.maybe_tick()
        assert_keys_superset(pa, ja)
        # one "fleet_tick" flight record each, of one shape
        assert_records_match("fleet_tick", count=1)
        for s in self.solos.values():
            s.maybe_tick()
        for key in ("tenants", "active", "groups", "probe_dispatches", "triggered", "published", "skipped"):
            assert pa[key] == ja[key], key
        for name, *_ in self.tenants:
            c = self.controllers(name)
            want = H.set_key(c["jax"].standing, False)
            assert H.set_key(c["port"].standing, True) == want, name
            assert H.set_key(c["solo"].standing, True) == want, name
            assert H.drift_key(c["port"]._last_drift) == H.drift_key(c["jax"]._last_drift)
            assert H.drift_key(c["solo"]._last_drift) == H.drift_key(c["jax"]._last_drift)
        return pa


def test_fleet_tick_matches_jax_and_standalone_ticks():
    trio = Trio([(f"t{i}", H.GOALS, H.HARD, i) for i in range(N)])
    trio.pfleet.warm()
    trio.jfleet.warm()
    for s in trio.solos.values():
        s.warm_start()
    trio.shift()
    attrs = trio.tick()
    assert attrs["groups"] == 1 and attrs["published"] == N and attrs["tenants_per_dispatch"] == N
    assert [s.name for s in trio.pfleet.last_spans] == ["ingest", "probe", "optimize"] + ["publish"] * N
    # a second shift: every tenant's candidate is probed, the sets supersede
    trio.shift(offset=3)
    attrs = trio.tick()
    for name, *_ in trio.tenants:
        assert trio.pfleet.tenant(name).controller.standing.version == 2
    status = trio.pfleet.status()
    assert status["tenantCount"] == N and status["lastTick"] == attrs
    assert status["tenants"]["t0"]["standing"]["version"] == 2


def test_mixed_goal_orders_group_as_jax_groups_them():
    """Three tenants on the 4-goal list, one on a 3-goal list and one with a
    different hard-goal set: the port forms the JAX fleet's groups, and a
    tick over them publishes what the JAX fleet publishes."""
    tenants = [(f"t{i}", H.GOALS, H.HARD, i) for i in range(N)]
    tenants += [("trim", ALT_GOALS, tuple(g for g in ALT_GOALS if g in JG.HARD_GOALS), 4)]
    trio = Trio(tenants)
    trio.warm_start()

    def partition(fleet):
        groups = {}
        for name in fleet.tenant_names:
            groups.setdefault(fleet._group_key(fleet.tenant(name)), []).append(name)
        return sorted(groups.values())

    assert partition(trio.pfleet) == partition(trio.jfleet) == [["t0", "t1", "t2"], ["trim"]]
    with pytest.raises(ValueError, match="differing goal orders"):
        A.stack_arrays([trio.pfleet.tenant("t0").controller._state_host,
                        trio.pfleet.tenant("trim").controller._state_host],
                       goal_orders=[H.GOALS, ALT_GOALS])
    trio.shift()
    attrs = trio.tick()
    assert attrs["groups"] == 2 and attrs["probe_dispatches"] == 2 and attrs["published"] == N + 1


def test_context_contents_split_groups():
    """Equal shapes, different context contents: two groups (the signature
    hashes the contents), equal contents: one."""
    fleet = FleetController(config=FleetConfig(**H.TICK_CFG), device="cpu")
    for name in ("a", "b", "c"):
        fleet.add_tenant(name, H.Duck(True, H.base_loads()))
        fleet.tenant(name).controller.warm_start()
    ctl = fleet.tenant("c").controller
    excluded = ctl._ctx.excluded_topics.clone()
    excluded[0] = True
    ctl._ctx = ctl._ctx.__class__(**{**ctl._ctx.__dict__, "excluded_topics": excluded})
    keys = [fleet._group_key(fleet.tenant(n)) for n in ("a", "b", "c")]
    assert keys[0] == keys[1] != keys[2]


# -- the coordinator's host plumbing -------------------------------------------------


def test_tenant_name_validation():
    fleet = FleetController(device="cpu")
    for bad in ("", "a/b", " padded ", *RESERVED_TENANT_NAMES):
        with pytest.raises(ValueError):
            fleet.add_tenant(bad, H.Duck(True, H.base_loads()))
    fleet.add_tenant("ok", H.Duck(True, H.base_loads()))
    with pytest.raises(ValueError, match="duplicate"):
        fleet.add_tenant("ok", H.Duck(True, H.base_loads()))
    assert fleet.tenant_names == ["ok"]


def test_pause_resume_fleet_and_single_tenant():
    fleet = FleetController(device="cpu")
    fleet.add_tenant("a", H.Duck(True, H.base_loads()))
    fleet.pause("ops")
    assert fleet.paused and fleet.maybe_tick() is None
    fleet.resume("ops done")
    assert not fleet.paused
    fleet.pause("noisy", tenant="a")
    assert fleet.tenant("a").controller.paused and not fleet.paused
    assert fleet.maybe_tick() is None           # the only tenant is paused
    fleet.resume(tenant="a")
    assert not fleet.tenant("a").controller.paused


def test_drain_arbitration_budget_rotation_and_stagger():
    clock = [1_000.0]
    fleet = FleetController(
        config=FleetConfig(**H.TICK_CFG, execute=True, max_concurrent_drains=1, drain_stagger_s=300.0),
        clock=lambda: clock[0], device="cpu",
    )
    drained, runtimes = [], []
    for name in ("a", "b"):
        rt = fleet.add_tenant(name, H.Duck(True, H.base_loads()))
        rt.controller._drain_standing = lambda fh, _n=name: drained.append(_n) or True
        runtimes.append(rt)
    live = [(rt, None, None) for rt in runtimes]

    def pend():
        for rt in runtimes:
            rt.pending_drain = (object(), object())

    pend()
    assert fleet._arbitrate_drains(live) == (1, 1) and drained == ["a"]
    assert all(rt.pending_drain is None for rt in runtimes)
    fleet._tick_count = 1
    pend()
    assert fleet._arbitrate_drains(live) == (1, 1) and drained == ["a", "b"]
    pend()
    assert fleet._arbitrate_drains(live) == (0, 2)
    clock[0] += 301.0
    pend()
    assert fleet._arbitrate_drains(live)[0] == 1 and drained == ["a", "b", "b"]
    fleet.cfg.execute = False
    pend()
    assert fleet._arbitrate_drains(live) == (0, 0) and drained == ["a", "b", "b"]


def _standing(version, n=2):
    return StandingProposalSet(
        version=version, created_ms=1_000 + version, trigger="drift", drift=2.0,
        proposals=[ExecutionProposal(tp=("T", i), partition_size=1.0, old_leader=0,
                                     old_replicas=(0, 1), new_replicas=(0, 2)) for i in range(n)],
    )


def test_legacy_namespace_adopted_recovered_and_fenced(tmp_path):
    """A single-tenant controller journal becomes the ``default`` tenant's:
    recovery resumes its set under a bumped fence, a restart replays one
    live set."""
    jdir = str(tmp_path / "journal")
    legacy = ControllerJournal(Journal(os.path.join(jdir, "controller")))
    legacy.fence(1)
    legacy.published(_standing(3))
    legacy.published(_standing(4, n=3))
    legacy.close()
    assert adopt_legacy_namespace(str(tmp_path / "empty")) is False

    fleet = FleetController(journal_dir=jdir, device="cpu")
    rt = fleet.add_tenant("default", H.Duck(True, H.base_loads()))
    assert not os.path.exists(os.path.join(jdir, "controller"))
    assert adopt_legacy_namespace(jdir) is False
    assert fleet.recover() == 3
    ctl = rt.controller
    assert ctl.standing.version == 4 and len(ctl.standing.proposals) == 3
    assert ctl.journal.epoch == 2
    ctl.journal.published(_standing(5, n=1))
    ctl.journal.invalidated(4, "superseded by v5")
    fleet.stop()

    fleet2 = FleetController(journal_dir=jdir, device="cpu")
    rt2 = fleet2.add_tenant("default", H.Duck(True, H.base_loads()))
    assert fleet2.recover() > 0
    assert rt2.controller.standing.version == 5 and rt2.controller.journal.epoch == 3
    fleet2.stop()
    records = Journal(os.path.join(jdir, "default")).replay()
    assert [r["version"] for r in records if r.get("type") == "published"] == [5]


def test_fleet_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetController()
