"""FleetController: N tenant control loops, one batched control plane.

Port of ``cruise_control_tpu/fleet/controller.py`` (the hierarchical
multi-objective co-operation design of arxiv 2512.07792, with
Execution-Template-style amortization, arxiv 1705.01662): one coordinator
holds N tenant clusters.

* **One batched probe and one batched solve per group, not N.**  Each tenant
  carries a continuous controller (warm state, drift gating, durable standing
  set, epoch fence) -- but its device work is hoisted into the fleet tick:
  tenant CPU mirrors (``ContinuousController._state_host`` /
  ``_candidate_host``, kept by the single-tenant ingest path) are stacked per
  group (``model.arrays.stack_arrays``) and probed by one
  ``GoalOptimizer.batched_violations``; triggered tenants then share one
  ``batched_incremental_optimize`` whose walk runs the union of their
  violated goals.  The port runs a stack's lanes one after another
  (``analyzer/optimizer.py``), so each lane equals its own solve.

* **Grouping is correctness, not just efficiency.**  A batched goal walk runs
  one goal sequence across all lanes, so tenants are grouped by (goal order,
  hard goals, array shapes, goal-context contents) before stacking --
  ``stack_arrays`` refuses mixed goal orders outright.  Every lane of a group
  rides every tick; non-triggered lanes' outputs are discarded, which is
  exact because a converged lane is a fixpoint of its own rounds (zero-move).

* **Per-tenant durability composes unchanged.**  Each tenant owns
  ``journal.dir/<tenant>`` -- its own journal, standing proposal set and
  epoch fence.  A pre-fleet single-tenant ``journal.dir/controller`` journal
  is adopted as the ``default`` tenant's namespace on first fleet startup
  (:func:`adopt_legacy_namespace`).

* **Hierarchy above the goal walks.**  The coordinator arbitrates cross-
  tenant execution capacity: at most ``max_concurrent_drains`` standing sets
  drain per tick, granted in tick-rotated order with a per-tenant stagger
  window -- publishes stay immediate, only the expensive backend drains are
  scheduled.  Per-tenant pause/resume and tenant -> admission-tier threading
  (``admission.set_tier_override``) keep one noisy tenant from starving the
  rest of the fleet.

Each fleet tick is one ``fleet_tick`` flight record with the JAX package's
attribute names (``num_host_syncs``, the port's own count, stays in the tick's
attributes and ``status()``); ``last_spans`` is a view of its spans.
``probe_dispatches`` counts the batched probes, one a group as in the JAX
package, each one host sync; ``optimize_dispatches`` counts the host syncs of
the batched solves, so ``num_dispatches`` equals ``num_host_syncs``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.optimizer import HostSyncs, host_fetch
from cruise_control_tpu_torch.controller.loop import (
    ContinuousController,
    ControllerConfig,
)
from cruise_control_tpu_torch.controller.standing import ControllerJournal
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.core.journal import Journal
from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.obs import recorder as obs

#: journal.dir namespaces that are NOT tenant WALs — a tenant may not shadow
#: the executor/user-task planes or the legacy single-tenant controller dir
RESERVED_TENANT_NAMES = frozenset({"controller", "executor", "usertasks"})


def adopt_legacy_namespace(journal_dir: str, tenant: str = "default") -> bool:
    """Adopt a pre-fleet ``journal.dir/controller`` WAL as ``tenant``'s.

    First fleet startup on a directory written by the single-tenant
    controller: the whole namespace — sealed segments, any ``.open`` segment
    a crash left behind, and the ``epoch`` fence sidecar — moves by one
    rename, so recovery replays the same records under the same fence and no
    publish is lost or doubled.  Idempotent: a no-op once the tenant
    namespace exists (or when there is nothing to adopt)."""
    legacy = os.path.join(journal_dir, "controller")
    target = os.path.join(journal_dir, tenant)
    if not os.path.isdir(legacy) or os.path.exists(target):
        return False
    os.rename(legacy, target)
    from cruise_control_tpu_torch.core.sensors import (
        FLEET_MIGRATIONS_COUNTER,
        REGISTRY,
    )

    REGISTRY.counter(FLEET_MIGRATIONS_COUNTER).inc()
    return True


@dataclasses.dataclass
class FleetConfig:
    """The ``fleet.*`` knob block: its defaults are those of
    :func:`~cruise_control_tpu_torch.core.config_defs.fleet_config` (the
    ``*.ms`` keys in seconds here; ``execute`` is ``fleet.execute.enable``)."""

    tick_interval_s: float = 30.0
    drift_threshold: float = 1.0
    max_rounds_per_tick: int = 64
    stale_after_s: float = 300.0
    #: hand drained standing sets to the executors (tenant controllers
    #: themselves always run with execute=False — the coordinator owns the
    #: cross-tenant drain budget)
    execute: bool = False
    #: cross-tenant capacity arbitration: standing sets granted a drain per
    #: fleet tick (the rest stay published and are superseded or drained on a
    #: later tick)
    max_concurrent_drains: int = 1
    #: staggered execution windows: minimum wall seconds between two drains
    #: of the SAME tenant (0 = no stagger)
    drain_stagger_s: float = 0.0


@dataclasses.dataclass
class _TenantRuntime:
    """One tenant's slot in the fleet: its control loop + coordination state."""

    name: str
    controller: ContinuousController
    tier: Optional[int] = None
    last_drain_mono: float = 0.0
    #: (standing, final_host) published this tick, awaiting a drain grant
    pending_drain: Optional[tuple] = None
    #: goal-context identity + content signature cache (recomputed when the
    #: controller rebuilds and swaps its ctx object)
    ctx_obj: object = None
    ctx_sig: str = ""


def _ctx_leaves(obj) -> List[np.ndarray]:
    """The value leaves of a goal context, depth first in field order (the
    JAX package's pytree leaf order): tensors and bool scalars as numpy
    arrays of their dtype; the int fields that set shapes are static."""
    leaves: List[np.ndarray] = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            leaves.extend(_ctx_leaves(v))
        elif isinstance(v, torch.Tensor):
            leaves.append(v.detach().cpu().numpy())
        elif isinstance(v, bool):
            leaves.append(np.asarray(v))
    return leaves


def _ctx_signature(ctx) -> str:
    """Content hash of a GoalContext: two tenants share a batched probe and
    solve only when their broadcast context is VALUE-identical (one context
    serves every lane of a stack), so contents -- not just shapes -- key the
    group.  Hashes each leaf's shape, dtype and bytes, as the JAX package
    does, after the static fields."""
    h = hashlib.sha1()
    h.update(repr((ctx.top_k, ctx.max_active_brokers)).encode())
    for arr in _ctx_leaves(ctx):
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class FleetController:
    """One instance per app, wired behind ``fleet.enable``.  Every tenant's
    device work runs on ``device`` (``cuda`` unless ``device="cpu"``)."""

    def __init__(
        self,
        config: Optional[FleetConfig] = None,
        journal_dir: Optional[str] = None,
        journal_kwargs: Optional[dict] = None,
        breaker=None,
        clock=None,
        admission=None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = config or FleetConfig()
        self._journal_dir = journal_dir or None
        self._journal_kwargs = dict(journal_kwargs or {})
        self.breaker = breaker
        self._clock = clock if clock is not None else time.monotonic
        self.admission = admission

        #: insertion-ordered: rotation and group iteration are deterministic
        self._tenants: Dict[str, _TenantRuntime] = {}
        self.paused = False
        self.pause_reason: Optional[str] = None
        self._tick_count = 0
        self._last_tick_attrs: Optional[dict] = None
        #: the span records of the last fleet tick
        self.last_spans: List[obs.Span] = []
        #: (group_key, batch_size) pairs whose batched programs were warmed
        self._warm_for = set()

        self._tick_lock = threading.RLock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- tenant registry -----------------------------------------------------

    def add_tenant(
        self,
        name: str,
        cruise_control,
        tier: Optional[int] = None,
        config: Optional[ControllerConfig] = None,
    ) -> _TenantRuntime:
        """Register one tenant cluster: its own control loop, journal
        namespace ``journal.dir/<name>``, admission tier, and window-delta
        wiring.  The ``default`` tenant adopts a pre-fleet single-tenant
        controller WAL on first startup."""
        if not name or "/" in name or os.sep in name or name != name.strip():
            raise ValueError(f"invalid tenant name {name!r}")
        if name in RESERVED_TENANT_NAMES:
            raise ValueError(
                f"tenant name {name!r} is reserved (journal.dir namespace "
                f"of another plane: {sorted(RESERVED_TENANT_NAMES)})"
            )
        if name in self._tenants:
            raise ValueError(f"duplicate tenant {name!r}")
        journal = None
        if self._journal_dir:
            if name == "default":
                adopt_legacy_namespace(self._journal_dir, name)
            journal = ControllerJournal(
                Journal(
                    os.path.join(self._journal_dir, name),
                    **self._journal_kwargs,
                )
            )
        controller = ContinuousController(
            cruise_control,
            journal=journal,
            config=config or ControllerConfig(
                tick_interval_s=self.cfg.tick_interval_s,
                drift_threshold=self.cfg.drift_threshold,
                max_rounds_per_tick=self.cfg.max_rounds_per_tick,
                stale_after_s=self.cfg.stale_after_s,
                # the coordinator owns drains (stagger + arbitration below);
                # a tenant loop draining on its own would bypass the budget
                execute=False,
            ),
            breaker=self.breaker,
            clock=self._clock,
            tenant=name,
            device=self.device,
        )
        # the fleet warms per goal-order group, for the whole stack
        controller.warm_programs_enabled = False
        rt = _TenantRuntime(name=name, controller=controller, tier=tier)
        self._tenants[name] = rt
        if tier is not None and self.admission is not None:
            # tenant → principal tier: requests authenticated as this tenant
            # queue at its tier, so a noisy tenant cannot starve the fleet
            self.admission.set_tier_override(name, tier)

        def _on_delta(delta, _ctl=controller) -> None:
            # evidence lands on the tenant loop (pending flag + reaction
            # anchor), the FLEET loop is what wakes — tenant threads are
            # never started
            _ctl.on_window_delta(delta)
            self._wake.set()

        cruise_control.monitor.add_window_listener(_on_delta)
        return rt

    def tenant(self, name: str) -> _TenantRuntime:
        return self._tenants[name]

    @property
    def tenant_names(self) -> List[str]:
        return list(self._tenants)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fleet-controller"
        )
        self._thread.start()

    def stop(self) -> None:
        """Graceful: loop down, every tenant journal sealed."""
        self.kill()
        for rt in self._tenants.values():
            if rt.controller.journal is not None:
                try:
                    rt.controller.journal.close()
                except Exception:
                    pass

    def kill(self) -> None:
        """Crash simulation: loop thread down, journals un-sealed."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        from cruise_control_tpu_torch.core.sensors import (
            FLEET_TICK_ERRORS_COUNTER,
            REGISTRY,
        )

        while not self._stop.is_set():
            self._wake.wait(timeout=self.cfg.tick_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                break
            try:
                self.maybe_tick()
            except Exception:
                # same contract as the single-tenant loop: a dead control
                # plane is a silent outage for EVERY tenant at once
                REGISTRY.counter(FLEET_TICK_ERRORS_COUNTER).inc()

    def recover(self) -> int:
        """Replay every tenant's journaled standing set (fence per tenant).
        Returns total records replayed across the fleet."""
        return sum(
            rt.controller.recover() for rt in self._tenants.values()
        )

    def pause(self, reason: str = "operator request",
              tenant: Optional[str] = None) -> None:
        if tenant is not None:
            self._tenants[tenant].controller.pause(reason)
            return
        self.paused = True
        self.pause_reason = reason

    def resume(self, reason: str = "operator request",
               tenant: Optional[str] = None) -> None:
        if tenant is not None:
            self._tenants[tenant].controller.resume(reason)
            return
        self.paused = False
        self.pause_reason = reason

    # -- grouping ------------------------------------------------------------

    def _group_key(self, rt: _TenantRuntime) -> tuple:
        """Batch-compatibility key: goal walk + array shapes + context
        contents.  Tenants stack into one dispatch iff their keys match."""
        ctl = rt.controller
        if ctl._ctx is not rt.ctx_obj:
            rt.ctx_obj = ctl._ctx
            rt.ctx_sig = _ctx_signature(ctl._ctx)
        st = ctl._state_host
        shapes = []
        for f in dataclasses.fields(type(st)):
            v = getattr(st, f.name)
            if isinstance(v, int):
                shapes.append((f.name, v))
            else:
                shapes.append((f.name, tuple(v.shape)))
        opt = ctl._optimizer
        return (
            tuple(opt.goal_ids),
            tuple(opt.hard_ids),
            tuple(shapes),
            rt.ctx_sig,
        )

    def _ensure_group_warm(self, gkey, members: List[_TenantRuntime]) -> None:
        """Warm the batched tick for this (group, batch-size) once
        (``warm_batched_incremental_programs``: the kernels' build on the
        card and one probe of every lane) -- the cold fleet tick pays it."""
        key = (gkey, len(members))
        if key in self._warm_for:
            return
        opt = members[0].controller._optimizer
        ctx = members[0].controller._ctx
        orders = [m.controller._optimizer.goal_ids for m in members]
        tracked = A.stack_arrays(
            [m.controller._state_host for m in members], goal_orders=orders
        )
        opt.warm_batched_incremental_programs(
            tracked, ctx, max_rounds=self.cfg.max_rounds_per_tick
        )
        self._warm_for.add(key)

    def warm(self) -> None:
        """Warm every tenant state and every group's batched tick without
        ticking (the measured warm tick then builds nothing)."""
        with self._tick_lock:
            for rt in self._tenants.values():
                ctl = rt.controller
                if not ctl.warmed or ctl._needs_rebuild:
                    ctl.warm_start()
            groups: Dict[tuple, List[_TenantRuntime]] = {}
            for rt in self._tenants.values():
                if rt.controller.warmed:
                    groups.setdefault(self._group_key(rt), []).append(rt)
            for gkey, rts in groups.items():
                self._ensure_group_warm(gkey, rts)

    # -- the fleet tick ------------------------------------------------------

    def maybe_tick(
        self, force: bool = False, tenant: Optional[str] = None
    ) -> Optional[dict]:
        """One fleet evaluation: per-tenant evidence/ingest (host work), ONE
        batched drift probe per goal-order group, one batched incremental
        optimize per group with triggered lanes, per-tenant publish through
        the SAME commit path as the single-tenant loop, then the cross-tenant
        drain arbitration.  Returns the tick's attribute dict when the fleet
        evaluated, else None.

        ``force`` triggers every tenant (or just ``tenant`` when named) the
        way a forced single-tenant tick would."""
        from cruise_control_tpu_torch.core.sensors import (
            FLEET_BREAKER_SKIPS_COUNTER,
            REGISTRY,
        )
        from cruise_control_tpu_torch.monitor.completeness import (
            NotEnoughValidSnapshotsError,
        )

        with self._tick_lock:
            if self.breaker is not None and self.breaker.is_open:
                # fleet-wide blackout: every tenant holds position, every
                # standing set keeps standing
                REGISTRY.counter(FLEET_BREAKER_SKIPS_COUNTER).inc()
                return None
            if self.paused:
                return None
            for rt in self._tenants.values():
                ctl = rt.controller
                ctl._update_staleness_gauge()
                if ctl.paused:
                    continue
                if not ctl.warmed or ctl._needs_rebuild:
                    try:
                        ctl.warm_start()
                    except NotEnoughValidSnapshotsError:
                        continue   # this tenant's monitor is still warming
            active = [
                rt for rt in self._tenants.values()
                if rt.controller.warmed
                and not rt.controller.paused
                and not rt.controller._needs_rebuild
            ]
            if not active:
                return None
            return self._tick(force, tenant, active)

    def _tick(
        self, force: bool, force_tenant: Optional[str],
        active: List[_TenantRuntime],
    ) -> dict:
        from cruise_control_tpu_torch.core.sensors import (
            FLEET_GROUPS_GAUGE,
            FLEET_OPTIMIZE_DISPATCHES_COUNTER,
            FLEET_PROBE_DISPATCHES_COUNTER,
            FLEET_TENANTS_GAUGE,
            FLEET_TICKS_COUNTER,
            REGISTRY,
        )
        token = obs.start_trace("fleet_tick")
        spans: List[obs.Span] = []
        probe_dispatches = 0
        optimize_dispatches = 0
        host_syncs = 0
        triggered_count = 0
        published_count = 0
        skipped_count = 0
        errors: List[str] = []

        # -- phase 0: evidence + ingest, per tenant (host-side) ---------------
        t0 = time.monotonic()
        live: List[Tuple[_TenantRuntime, Optional[float], object]] = []
        for rt in active:
            had_delta, anchor, restore = rt.controller.tick_begin_evidence()
            refreshed, err = rt.controller.tick_ingest(had_delta)
            if err is not None:
                restore()
                errors.append(f"{rt.name}: {err}")
                continue
            live.append((rt, anchor, restore))
        spans.append(obs.Span("ingest", "ingest", time.monotonic() - t0, 0, attrs={"tenants": len(live)}))

        # -- group by batch compatibility ------------------------------------
        groups: Dict[tuple, List[Tuple]] = {}
        for item in live:
            groups.setdefault(self._group_key(item[0]), []).append(item)
        REGISTRY.gauge(FLEET_TENANTS_GAUGE).set(len(self._tenants))
        REGISTRY.gauge(FLEET_GROUPS_GAUGE).set(len(groups))

        for gi, gkey in enumerate(sorted(groups, key=repr)):
            members = groups[gkey]
            self._ensure_group_warm(gkey, [m[0] for m in members])
            opt = members[0][0].controller._optimizer
            ctx = members[0][0].controller._ctx
            orders = [m[0].controller._optimizer.goal_ids for m in members]
            S = len(members)

            # -- phase A: ONE batched drift probe for the whole group ---------
            # candidate-or-tracked CPU mirrors, stacked on the host and moved
            # to the device once
            tp = time.monotonic()
            probes = A.stack_arrays(
                [m[0].controller.tick_probe_host() for m in members],
                goal_orders=orders,
            )
            syncs = HostSyncs()
            (viol,) = host_fetch(syncs, [opt.batched_violations(probes, ctx)])
            probe_dispatches += 1
            host_syncs += syncs.count
            spans.append(
                obs.Span("probe", "drift", time.monotonic() - tp, syncs.count, attrs={"group": gi, "tenants": S})
            )

            # -- phase B: per-tenant trigger decision (host math) -------------
            decisions = []
            for i, (rt, anchor, restore) in enumerate(members):
                f = force and (force_tenant is None or rt.name == force_tenant)
                report, trigger, stale = rt.controller.tick_decide(viol[i], f)
                decisions.append((report, trigger))
                if trigger is None:
                    rt.controller.tick_skipped()
                    restore()
                    skipped_count += 1
            triggered = [i for i, d in enumerate(decisions) if d[1] is not None]
            if not triggered:
                continue
            triggered_count += len(triggered)

            # -- phase C: ONE batched incremental walk for the group ----------
            # every member lane rides (a stable batch shape); the goal union
            # covers TRIGGERED lanes only, and non-triggered lanes' outputs
            # are discarded -- exact, because a lane satisfied on a goal is a
            # zero-move fixpoint of that goal's rounds
            to = time.monotonic()
            initial_hosts = [m[0].controller._state_host for m in members]
            tracked = A.stack_arrays(initial_hosts, goal_orders=orders)
            final_states, binc = opt.batched_incremental_optimize(
                tracked, ctx,
                max_rounds=self.cfg.max_rounds_per_tick,
                violations=None,
                union_lanes=triggered,
            )
            # one copy of the final stack to the host for every lane's commit
            syncs = HostSyncs()
            finals_host = syncs.state(final_states)
            optimize_dispatches += binc.num_host_syncs + syncs.count
            host_syncs += binc.num_host_syncs + syncs.count
            spans.append(
                obs.Span(
                    "optimize", "optimize", time.monotonic() - to,
                    binc.num_host_syncs + syncs.count,
                    attrs={"group": gi, "tenants": S, "triggered": len(triggered),
                           "goals_run": binc.goals_run},
                )
            )

            # -- phase D: per-tenant commit (same path as single-tenant) ------
            for i in triggered:
                rt, anchor, restore = members[i]
                report, trigger = decisions[i]
                final_host = A.index_arrays(finals_host, i)
                published, _attrs = rt.controller.tick_commit(
                    spans, report, trigger, anchor, restore,
                    initial_hosts[i], final_host, binc.results[i],
                )
                if published is not None:
                    published_count += 1
                    rt.pending_drain = (published, final_host)

        # -- phase E: cross-tenant drain arbitration --------------------------
        drains, deferrals = self._arbitrate_drains(live)

        self._tick_count += 1
        REGISTRY.counter(FLEET_TICKS_COUNTER).inc()
        REGISTRY.counter(FLEET_PROBE_DISPATCHES_COUNTER).inc(probe_dispatches)
        REGISTRY.counter(FLEET_OPTIMIZE_DISPATCHES_COUNTER).inc(
            optimize_dispatches
        )
        attrs = {
            "tenants": len(self._tenants),
            "active": len(live),
            "groups": len(groups),
            "probe_dispatches": probe_dispatches,
            "optimize_dispatches": optimize_dispatches,
            "num_dispatches": probe_dispatches + optimize_dispatches,
            "num_host_syncs": host_syncs,
            "triggered": triggered_count,
            "published": published_count,
            "skipped": skipped_count,
            "drains": drains,
            "drain_deferrals": deferrals,
            "tenants_per_dispatch": (
                len(live) / probe_dispatches if probe_dispatches else 0.0
            ),
            "errors": errors or None,
        }
        self._last_tick_attrs = attrs
        self.last_spans = spans
        obs.finish_trace(
            token, spans=spans,
            attrs={k: v for k, v in attrs.items() if k != "num_host_syncs"},
            device=self.device,
        )
        return attrs

    def _arbitrate_drains(self, live) -> Tuple[int, int]:
        """Grant at most ``max_concurrent_drains`` of this tick's published
        sets a drain, in tick-rotated order, each tenant inside its stagger
        window.  Deferred sets stay published (superseded or granted later);
        with ``execute`` off everything pending is simply cleared."""
        from cruise_control_tpu_torch.core.sensors import (
            FLEET_DRAIN_DEFERRALS_COUNTER,
            FLEET_DRAINS_COUNTER,
            REGISTRY,
        )

        pending = [rt for (rt, _, _) in live if rt.pending_drain is not None]
        if not self.cfg.execute:
            for rt in pending:
                rt.pending_drain = None
            return 0, 0
        if pending:
            off = self._tick_count % len(pending)
            pending = pending[off:] + pending[:off]
        drains = deferrals = 0
        now = self._clock()
        for rt in pending:
            _, final_host = rt.pending_drain
            rt.pending_drain = None
            if drains >= self.cfg.max_concurrent_drains or (
                self.cfg.drain_stagger_s > 0
                and now - rt.last_drain_mono < self.cfg.drain_stagger_s
            ):
                REGISTRY.counter(FLEET_DRAIN_DEFERRALS_COUNTER).inc()
                deferrals += 1
                continue
            if rt.controller._drain_standing(final_host):
                rt.last_drain_mono = now
                drains += 1
                REGISTRY.counter(FLEET_DRAINS_COUNTER).inc()
        return drains, deferrals

    # -- surface -------------------------------------------------------------

    def status(self) -> Dict[str, object]:
        """The FLEET endpoint payload: coordinator state + one status block
        per tenant (each the exact single-tenant CONTROLLER shape, plus the
        tenant's admission tier)."""
        tenants = {}
        for name, rt in self._tenants.items():
            s = rt.controller.status()
            s["tier"] = rt.tier
            tenants[name] = s
        return {
            "state": "paused" if self.paused else "running",
            "paused": self.paused,
            "pauseReason": self.pause_reason,
            "tenantCount": len(self._tenants),
            "tenants": tenants,
            "lastTick": self._last_tick_attrs,
            "config": {
                "tickIntervalS": self.cfg.tick_interval_s,
                "driftThreshold": self.cfg.drift_threshold,
                "maxRoundsPerTick": self.cfg.max_rounds_per_tick,
                "staleAfterS": self.cfg.stale_after_s,
                "execute": self.cfg.execute,
                "maxConcurrentDrains": self.cfg.max_concurrent_drains,
                "drainStaggerS": self.cfg.drain_stagger_s,
            },
        }
