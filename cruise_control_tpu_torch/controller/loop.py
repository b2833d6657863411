"""ContinuousController: the streaming, drift-triggered control loop.

Port of ``cruise_control_tpu/controller/loop.py`` ("Integrative Dynamic
Reconfiguration", arxiv 1602.03770): instead of re-solving from scratch per
request or anomaly, the controller *continuously* tracks load and emits
incremental reconfigurations:

* **Warm device state.**  One cluster model is built at warm start (padded to
  the broker-bucket ladder) and held on ``device`` as a
  :class:`~cruise_control_tpu_torch.model.arrays.ClusterArrays`, beside a
  CPU mirror of it; after that, metric-window deltas pushed by the monitor's
  window-completion listener refresh ONLY the load leaves (``base_load`` /
  ``leadership_delta``) of both -- placement leaves are never rebuilt, so a
  tick pays no model construction.

* **Drift-gated ticks.**  Each wake runs one violations probe on the device
  (one host fetch) and host-side drift math
  (:mod:`cruise_control_tpu_torch.controller.drift`).  A tick's bounded
  incremental re-optimize (``GoalOptimizer.incremental_optimize``: drifted
  goals only, rounds capped by ``max_rounds_per_tick``) runs when drift
  crosses ``drift_threshold`` or the ``tick_interval_s`` cadence elapses with
  violations outstanding -- never from scratch, always from the current
  placement.

* **Durable standing proposal set.**  Each productive tick publishes a
  versioned :class:`StandingProposalSet`, journaled write-ahead
  (:class:`~cruise_control_tpu_torch.controller.standing.ControllerJournal`,
  the JAX package's record format); superseded versions are invalidated, the
  executor drains the set under the policy knobs (``execute``), and
  :meth:`recover` resumes the journaled set after a crash instead of
  cold-starting the loop.

The headline metric is **reaction latency** -- wall time from a load-shift
window delta landing to the corrective proposal set being published -- in
the ``Controller.reaction-latency-timer`` sensor of the port's
``core.sensors.REGISTRY``.

Tracked placement is *reality*, not ambition: a tick optimizes from the
tracked placement and publishes the diff; the tracked placement only advances
when the executor actually drains the set (a non-clean execution schedules a
full rebuild).  Superseded sets therefore always diff against the placement
the backend really has.

The seam to the rest of the service is the JAX package's, duck-typed: a
``cruise_control`` object with ``goal_ids``, ``hard_ids``,
``enable_heavy_goals``, ``constraint``, ``cluster_model()`` (a port
:class:`~cruise_control_tpu_torch.model.cluster.ClusterModel`),
``monitor.current_partition_loads()`` / ``monitor.cpu_weights``,
``backend.describe_cluster()`` and ``executor.execute_proposals`` (reached
only with ``execute=True``).  The tick phases (``tick_begin_evidence`` ...
``tick_commit``) are the fleet's seam, as in the JAX package.  Each phase
appends an ``obs.Span`` (its ``dispatches`` count host syncs) to
the caller's ``spans`` list.  A single-tenant evaluation is one
``controller_tick`` flight record with the JAX package's attribute names
(``num_dispatches`` carries the host-sync count; the tick's own attributes
add ``num_host_syncs``); ``last_spans`` is a view of its spans.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer, HostSyncs, host_fetch
from cruise_control_tpu_torch.analyzer.proposals import diff as diff_proposals
from cruise_control_tpu_torch.controller.drift import DriftReport, evaluate_drift
from cruise_control_tpu_torch.controller.standing import (
    ControllerJournal,
    FencedEpochError,
    StandingProposalSet,
)
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.model.model_utils import follower_cpu_from_leader_load
from cruise_control_tpu_torch.monitor.loadmonitor import WindowDelta
from cruise_control_tpu_torch.obs import recorder as obs


@dataclasses.dataclass
class ControllerConfig:
    """The ``controller.*`` knob block: its defaults are those of
    :func:`~cruise_control_tpu_torch.core.config_defs.controller_config`
    (``controller.tick.interval.ms`` and ``controller.stale.after.ms`` in
    seconds here; ``execute`` is ``controller.execute.enable``)."""

    tick_interval_s: float = 30.0
    drift_threshold: float = 1.0
    max_rounds_per_tick: int = 64
    stale_after_s: float = 300.0
    #: let the controller hand its standing set to the executor (off = the
    #: set stands for operators / the CONTROLLER endpoint to inspect)
    execute: bool = False


class ContinuousController:
    """One instance per app, wired behind ``controller.enable``.  The tick's
    device work runs on ``device`` (``cuda`` unless ``device="cpu"``)."""

    def __init__(
        self,
        cruise_control,
        journal: Optional[ControllerJournal] = None,
        config: Optional[ControllerConfig] = None,
        breaker=None,
        clock=None,
        tenant: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cc = cruise_control
        self.journal = journal
        self.cfg = config or ControllerConfig()
        #: fleet membership: when set, every Controller.* sensor this instance
        #: emits is re-namespaced to Fleet.* (fleet aggregate) and
        #: Fleet.tenant.<name>.* (per-tenant series) — the global Controller.*
        #: names keep meaning "the single-tenant loop" on mixed deployments
        self.tenant = tenant
        #: fleet seam: the fleet warms its batched programs for the whole
        #: stack, so a fleet tenant skips the single-lane warm-up
        self.warm_programs_enabled = True
        #: monotonic time source; injectable so a replay harness can drive
        #: staleness, cadence and reaction latency on a fake clock without
        #: sleeping
        self._clock = clock if clock is not None else time.monotonic
        #: shared backend circuit breaker: while open the loop holds position
        #: — no ticks, no rebuilds, standing set stays published (the
        #: degraded REBALANCE answers are served from it)
        self.breaker = breaker
        self._optimizer = GoalOptimizer(
            goal_ids=cruise_control.goal_ids,
            hard_ids=cruise_control.hard_ids,
            enable_heavy_goals=cruise_control.enable_heavy_goals,
            device=self.device,
        )

        # warm state (built lazily: the monitor may not have windows yet)
        self._state = None                 # bucketed ClusterArrays on self.device
        self._ctx = None
        self._maps = None
        self._bucket = 0
        self._rp_np = None                 # np i32[R] replica_partition
        self._valid_np = None              # np bool[R]
        self._part_base = None             # np f32[P, 4] per-partition base load
        self._part_delta = None            # np f32[P, 4] leadership delta
        self._broker_fingerprint: Tuple[int, ...] = ()

        #: the last published solve's OUTPUT placement with live loads — the
        #: state drift is measured on: violations here are violations the
        #: standing set does NOT answer (None = no standing set; probe the
        #: tracked state directly)
        self._candidate_state = None
        #: post-solve violation vector at the last publish — the drift
        #: baseline (bounded ticks may leave residual violations; measuring
        #: against the residual keeps an unsolvable tail from re-triggering
        #: an identical tick every wake)
        self._solved_viol = None
        self._programs_warm_for: Tuple[int, int] = (-1, -1)
        self._last_drift: Optional[DriftReport] = None
        self._last_solve_mono = 0.0
        self._needs_rebuild = False

        self.standing: Optional[StandingProposalSet] = None
        self._version = 0
        #: chaos seam for the replication failover drill: invoked right
        #: after the journal write-ahead succeeds and BEFORE the in-memory
        #: swap — the exact window where a dying writer leaves followers
        #: holding a set the writer itself never served
        self._hook_after_journal_publish: Optional[Callable[[], None]] = None

        self.paused = False
        self.pause_reason: Optional[str] = None
        self.warmed = False

        self._tick_lock = threading.RLock()
        self._pending_delta = False
        self._last_delta: Optional[WindowDelta] = None
        self._last_delta_mono: Optional[float] = None
        self._shift_t0: Optional[float] = None
        self._started_mono = self._clock()
        self._last_topology_probe = 0.0
        self._last_tick_attrs: Optional[dict] = None
        #: the spans of the last single-tenant evaluation's flight record
        self.last_spans: List[obs.Span] = []

        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

        # CPU mirrors of the tracked/candidate device states.  Free to
        # maintain: warm_start, the delta ingest and placement adoption all
        # compute their leaves on the host before the copy to the device.
        # The fleet stacks these mirrors and moves each stack to the device
        # once.
        self._state_host = None
        self._candidate_host = None

    # -- sensor routing -------------------------------------------------------

    def _sensor_names(self, name: str) -> List[str]:
        """Route a Controller.* sensor constant: standalone keeps the global
        name; a fleet tenant reports the fleet aggregate + its own series."""
        if self.tenant is None:
            return [name]
        suffix = name.split(".", 1)[1]
        return [f"Fleet.{suffix}", f"Fleet.tenant.{self.tenant}.{suffix}"]

    def _count(self, name: str) -> None:
        from cruise_control_tpu_torch.core.sensors import REGISTRY

        for s in self._sensor_names(name):
            REGISTRY.counter(s).inc()

    def _gauge(self, name: str, value) -> None:
        from cruise_control_tpu_torch.core.sensors import REGISTRY

        for s in self._sensor_names(name):
            REGISTRY.gauge(s).set(value)

    def _timer(self, name: str, value) -> None:
        from cruise_control_tpu_torch.core.sensors import REGISTRY

        for s in self._sensor_names(name):
            REGISTRY.timer(s).update(value)

    # -- event surface (called from the monitor's sampling thread) -----------

    def on_window_delta(self, delta: WindowDelta) -> None:
        """Window-completion listener: record and wake — nothing heavy runs
        on the sampling thread."""
        self._last_delta = delta
        self._last_delta_mono = delta.ingest_monotonic
        if self._shift_t0 is None:
            # the FIRST load evidence since the last publish anchors the
            # reaction-latency clock
            self._shift_t0 = delta.ingest_monotonic
        self._pending_delta = True
        self._wake.set()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Spawn the loop thread (wakes on window deltas and on cadence)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="continuous-controller"
        )
        self._thread.start()

    def stop(self) -> None:
        self.kill()
        if self.journal is not None:
            try:
                self.journal.close()
            except Exception:
                pass

    def kill(self) -> None:
        """Stop the loop thread WITHOUT sealing the journal (crash simulation)."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        from cruise_control_tpu_torch.core.sensors import (
            CONTROLLER_TICK_ERRORS_COUNTER,
        )

        while not self._stop.is_set():
            self._wake.wait(timeout=self.cfg.tick_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                break
            try:
                self.maybe_tick()
            except Exception:
                # the loop survives everything — a dead control loop is a
                # silent outage, the one failure mode this plane must not have
                self._count(CONTROLLER_TICK_ERRORS_COUNTER)

    def pause(self, reason: str = "operator request") -> None:
        self.paused = True
        self.pause_reason = reason

    def resume(self, reason: str = "operator request") -> None:
        self.paused = False
        self.pause_reason = reason

    def recover(self) -> int:
        """Resume the journaled standing proposal set after a crash (the
        ``Executor.recover()`` analogue for this plane).  Returns the number
        of journal records replayed; a no-op without a journal."""
        from cruise_control_tpu_torch.core.sensors import (
            CONTROLLER_STANDING_PROPOSALS_GAUGE,
            CONTROLLER_STANDING_VERSION_GAUGE,
            REPLICATION_EPOCH_GAUGE,
        )

        if self.journal is None:
            return 0
        standing, max_version, records, epoch = self.journal.recover()
        self.standing = standing
        self._version = max(self._version, max_version)
        if records > 1:
            # startup compaction (user-task-WAL pattern): the recovered set
            # is the only live state — replay cost stays bounded across
            # restarts instead of accreting superseded history
            try:
                self.journal.rewrite(standing)
            except Exception:
                pass
        # claim the write path: epoch + 1 fences every older holder,
        # including this process's own previous incarnation — restart and
        # follower promotion are the same move (see standing.py docstring).
        # After the rewrite, so the journaled epoch record survives the
        # compaction and tailing followers learn the regime change.  A
        # refused fence (a newer holder already fenced) leaves this process
        # a read-only stale writer: every later append is refused too.
        try:
            self.journal.fence(epoch + 1)
        except FencedEpochError:
            pass
        except Exception:
            pass
        self._gauge(REPLICATION_EPOCH_GAUGE, self.journal.epoch)
        if standing is not None:
            self._gauge(CONTROLLER_STANDING_VERSION_GAUGE, standing.version)
            self._gauge(
                CONTROLLER_STANDING_PROPOSALS_GAUGE, len(standing.proposals)
            )
        return records

    # -- warm state ----------------------------------------------------------

    def warm_start(self) -> None:
        """Build the device-resident cluster state ONCE (bucketed broker
        axis), plus the per-partition load tables the delta ingest rewrites.
        Raises ``NotEnoughValidSnapshotsError`` until the monitor has a
        stable window (callers treat that as "not warm yet")."""
        from cruise_control_tpu_torch.analyzer.context import (
            GoalContext,
            pad_context_brokers,
        )

        model = self.cc.cluster_model()
        state, maps = model.to_arrays(device="cpu")
        B = state.num_brokers
        bucket = (
            A.broker_bucket(B) if self._optimizer.bucket_brokers else B
        )
        ctx = GoalContext.build(
            state.num_topics, B, constraint=self.cc.constraint, device=self.device
        )
        if bucket != B:
            state = A.pad_brokers(state, bucket)
            ctx = pad_context_brokers(ctx, bucket)
        # host mirror first: the CPU state IS the mirror; one copy per leaf
        # to the device (cold path, runs once)
        self._state_host = state
        self._state = state.to(self.device)
        self._ctx = ctx
        self._maps = maps
        self._bucket = bucket
        self._broker_fingerprint = tuple(maps.broker_ids)

        self._rp_np = state.replica_partition.numpy().copy()
        self._valid_np = state.replica_valid.numpy().copy()
        # the ingest rewrites these tables in place: copies, never views of
        # the mirror's tensors
        self._part_delta = state.leadership_delta.numpy().astype(np.float32, copy=True)
        base = state.base_load.numpy().astype(np.float32, copy=True)
        self._part_base = np.zeros_like(self._part_delta)
        live = self._valid_np
        # all replicas of a partition share one base row in monitor-built
        # models (follower-equivalent load); last-writer-wins is exact there
        # and a harmless seed elsewhere — the first delta ingest overwrites
        self._part_base[self._rp_np[live]] = base[live]

        self._candidate_state = None
        self._candidate_host = None
        self._solved_viol = None
        # deltas ingested while cold (warmup sampling, kernel build) are not
        # load shifts the loop could have reacted to — the reaction clock
        # starts fresh with the first delta the WARM loop sees
        self._shift_t0 = None
        self._needs_rebuild = False
        self.warmed = True
        if self.warm_programs_enabled:
            self.warm_programs()

    def warm_programs(self) -> None:
        """Make the first tick as fast as later ones, once per shape
        (``GoalOptimizer.warm_incremental_programs``: on the card it builds
        the CUDA kernels, then runs one violations probe).  The cold burst
        lands at warm start: a controller that builds its kernels during its
        first real incident would react at build speed.  Idempotent."""
        if self._programs_warm_for == (self._bucket, self._state.num_replicas):
            return
        self._optimizer.warm_incremental_programs(
            self._state, self._ctx, max_rounds=self.cfg.max_rounds_per_tick
        )
        self._programs_warm_for = (self._bucket, self._state.num_replicas)

    def _topology_changed(self) -> bool:
        try:
            desc = self.cc.backend.describe_cluster()
        except Exception:
            return False
        return tuple(sorted(desc.brokers)) != self._broker_fingerprint

    def _topology_probe_due(self) -> bool:
        """Rate-limit the broker-set probe: ``describe_cluster`` is an admin
        RPC on a real backend, and the reaction-latency hot path must not
        carry one per tick.  Partition-level changes are caught for free by
        the ingest's unknown-tp signal; this probe only exists for the
        replica-less new/removed broker case, which one cadence interval of
        lag cannot hurt."""
        now = self._clock()
        if now - self._last_topology_probe < self.cfg.tick_interval_s:
            return False
        self._last_topology_probe = now
        return True

    def _ingest_loads(self) -> int:
        """Apply the monitor's current window aggregate onto the warm state's
        load leaves -- placement leaves untouched, shapes identical.  Returns
        the number of partitions refreshed; -1 signals a topology change
        (caller rebuilds).
        """
        loads = self.cc.monitor.current_partition_loads()
        if not loads:
            return 0
        pidx = self._maps.partition_index
        weights = self.cc.monitor.cpu_weights
        refreshed = 0
        for tp, (cpu, nw_in, nw_out, disk) in loads.items():
            p = pidx.get(tp)
            if p is None:
                return -1   # unknown partition: the topology moved under us
            fcpu = float(
                follower_cpu_from_leader_load(nw_in, nw_out, cpu, weights)
            )
            self._part_base[p, Resource.CPU] = fcpu
            self._part_base[p, Resource.NW_IN] = nw_in
            self._part_base[p, Resource.NW_OUT] = 0.0
            self._part_base[p, Resource.DISK] = disk
            self._part_delta[p, Resource.CPU] = cpu - fcpu
            self._part_delta[p, Resource.NW_OUT] = nw_out
            refreshed += 1
        base = np.where(
            self._valid_np[:, None], self._part_base[self._rp_np], 0.0
        ).astype(np.float32)
        # base_load is replica-axis keyed by replica_partition, which moves
        # never change — ONE pair of refreshed leaves serves both the tracked
        # state and the candidate (their placements differ, their loads don't)
        base_host = torch.from_numpy(base)
        delta_host = torch.from_numpy(self._part_delta.copy())
        base_dev = base_host.to(self.device)
        delta_dev = delta_host.to(self.device)
        self._state = self._state.replace(
            base_load=base_dev, leadership_delta=delta_dev
        )
        self._state_host = self._state_host.replace(
            base_load=base_host, leadership_delta=delta_host
        )
        if self._candidate_state is not None:
            self._candidate_state = self._candidate_state.replace(
                base_load=base_dev, leadership_delta=delta_dev
            )
        if self._candidate_host is not None:
            self._candidate_host = self._candidate_host.replace(
                base_load=base_host, leadership_delta=delta_host
            )
        return refreshed

    def _adopt_placement(self, final_host) -> None:
        """The executor drained the standing set cleanly: the candidate
        placement IS reality now — advance the tracked state to it (a fresh
        snapshot: every replica is original again)."""
        rb_host = final_host.replica_broker.to("cpu").clone()
        disk_host = final_host.replica_disk.to("cpu").clone()
        leader_host = final_host.partition_leader.to("cpu").clone()
        rb = rb_host.to(self.device)
        self._state = self._state.replace(
            replica_broker=rb,
            replica_disk=disk_host.to(self.device),
            partition_leader=leader_host.to(self.device),
            original_broker=rb,
        )
        self._state_host = self._state_host.replace(
            replica_broker=rb_host,
            replica_disk=disk_host,
            partition_leader=leader_host,
            original_broker=rb_host,
        )
        self._candidate_state = None   # candidate IS the tracked state now
        self._candidate_host = None

    # -- the tick ------------------------------------------------------------

    def maybe_tick(self, force: bool = False) -> Optional[StandingProposalSet]:
        """One control-loop evaluation: ingest pending deltas, measure drift,
        and — when drift crosses the threshold, the cadence elapses with
        violations outstanding, or ``force`` — run the bounded incremental
        re-optimize and publish the standing proposal set.

        Returns the standing set when this call published one, else None.
        Synchronous and re-entrant-safe (the HTTP ``action=tick``, the loop
        thread, and tests all come through here)."""
        from cruise_control_tpu_torch.monitor.completeness import (
            NotEnoughValidSnapshotsError,
        )

        with self._tick_lock:
            self._update_staleness_gauge()
            if self.breaker is not None and self.breaker.is_open:
                # backend blackout: hold position (counted), pause or not.
                # The standing set keeps standing — it is what degraded
                # REBALANCE answers serve — and ticking (even a forced one)
                # would only fail fast against the open breaker and thrash
                # the drift baseline
                from cruise_control_tpu_torch.core.sensors import (
                    CONTROLLER_BREAKER_SKIPS_COUNTER,
                )

                self._count(CONTROLLER_BREAKER_SKIPS_COUNTER)
                return None
            if self.paused:
                return None
            if not self.warmed or self._needs_rebuild:
                try:
                    self.warm_start()
                except NotEnoughValidSnapshotsError:
                    return None   # monitor still warming; next delta retries
            return self._evaluate_and_tick(force)

    # -- tick phases ----------------------------------------------------------
    #
    # `_evaluate_and_tick` below composes these for the single-tenant loop;
    # the fleet controller (fleet/controller.py) drives the SAME phase
    # methods per tenant -- consuming evidence, ingesting, deciding triggers
    # and committing publishes through identical code paths -- while
    # replacing only the device work in the middle (per-tenant probes and
    # solves become one batched probe and one batched solve per group).  The
    # driver owns the spans list.

    def tick_begin_evidence(self) -> Tuple[bool, Optional[float], Callable]:
        """Consume the pending window delta and the reaction anchor.

        The anchor is consumed WITH the evidence: a delta landing mid-solve
        re-anchors a fresh clock instead of being wiped by the solve's
        completion (its reaction is measured by the NEXT tick).  The returned
        restore callback re-arms the anchor when the tick is skipped or the
        publish is refused — unanswered evidence keeps its clock running."""
        had_delta = self._pending_delta
        self._pending_delta = False
        anchor = self._shift_t0
        self._shift_t0 = None

        def _restore_anchor() -> None:
            if anchor is not None and self._shift_t0 is None:
                self._shift_t0 = anchor

        return had_delta, anchor, _restore_anchor

    def tick_ingest(self, had_delta: bool) -> Tuple[int, Optional[str]]:
        """Refresh the load leaves in place; rebuild on topology change.

        Returns ``(partitions_refreshed, error)`` — a non-None error means
        the rebuild failed (flagged for the next wake; the caller restores
        the anchor and closes its trace)."""
        from cruise_control_tpu_torch.core.sensors import CONTROLLER_REBUILDS_COUNTER

        refreshed = 0
        if had_delta:
            refreshed = self._ingest_loads()
            if refreshed < 0 or (
                self._topology_probe_due() and self._topology_changed()
            ):
                # the cluster grew/shrank under the warm state: one full
                # rebuild (counted — this is the expensive path the delta
                # ingest exists to avoid), standing set invalidated (its
                # old_replicas may no longer describe reality)
                self._count(CONTROLLER_REBUILDS_COUNTER)
                if self.standing is not None and self.journal is not None:
                    self.journal.invalidated(
                        self.standing.version, "topology-changed"
                    )
                if self.standing is not None:
                    self.standing = None
                try:
                    self.warm_start()
                except Exception as e:
                    # the monitor can be momentarily incomplete mid-change;
                    # flag the rebuild for the next wake instead of dying
                    self._needs_rebuild = True
                    return refreshed, f"rebuild failed: {e}"
                refreshed = self._ingest_loads()
        return refreshed, None

    def tick_probe_state(self):
        """The device state drift is measured on: the CANDIDATE (last solve's
        output placement, live loads) when a standing set exists — violations
        there are the ones the standing set does NOT answer — else the
        tracked state (everything unanswered)."""
        return (
            self._candidate_state
            if self._candidate_state is not None
            else self._state
        )

    def tick_probe_host(self):
        """CPU-mirror twin of :meth:`tick_probe_state` -- what the fleet
        stacks into its batched probe."""
        return (
            self._candidate_host
            if self._candidate_host is not None
            else self._state_host
        )

    def tick_decide(
        self, viol_now, force: bool
    ) -> Tuple[DriftReport, Optional[str], bool]:
        """Host-side drift math + trigger decision from a probed violation
        vector.  Returns ``(report, trigger, stale)``; trigger None = skip."""
        from cruise_control_tpu_torch.core.sensors import (
            CONTROLLER_BALANCEDNESS_GAUGE,
            CONTROLLER_DRIFT_GAUGE,
        )

        report = evaluate_drift(
            viol_now, self._solved_viol,
            self._optimizer.goal_ids, self._optimizer.hard_ids,
        )
        self._last_drift = report
        self._gauge(CONTROLLER_DRIFT_GAUGE, report.score)
        self._gauge(CONTROLLER_BALANCEDNESS_GAUGE, report.balancedness)

        now = self._clock()
        cadence_due = (now - self._last_solve_mono) >= self.cfg.tick_interval_s
        stale = self._staleness_s() > self.cfg.stale_after_s
        if force:
            trigger = "forced"
        elif stale:
            # flying blind (no fresh window delta past the stale budget):
            # solving on stale loads would thrash the standing set with
            # superseding guesses — hold position until evidence returns
            # (force bypasses: the operator knows what they're doing)
            trigger = None
        elif report.score >= self.cfg.drift_threshold:
            trigger = "drift"
        elif cadence_due and report.violated_goal_ids:
            trigger = "cadence"
        else:
            trigger = None
        return report, trigger, stale

    def tick_skipped(self) -> None:
        """Idle-tick accounting for a trigger-None evaluation."""
        from cruise_control_tpu_torch.core.sensors import (
            CONTROLLER_IDLE_TICKS_COUNTER,
        )

        self._count(CONTROLLER_IDLE_TICKS_COUNTER)

    def tick_commit(
        self,
        spans,
        report: DriftReport,
        trigger: str,
        anchor: Optional[float],
        restore_anchor,
        initial_host,
        final_host,
        inc,
        final_dev=None,
    ) -> Tuple[Optional[StandingProposalSet], dict]:
        """Publish phase: diff -> versioned standing set -> write-ahead
        journal -> supersede -> baselines -> optional drain.  Appends the
        publish span to ``spans`` and returns ``(published, attrs)``.
        ``final_host`` is the solve output on the host (or any device: it is
        copied to the CPU for the mirror); ``final_dev``, when the caller
        already holds the solve output on the device, seeds the candidate
        state without a host-to-device copy."""
        from cruise_control_tpu_torch.core.sensors import (
            CONTROLLER_PUBLISHED_COUNTER,
            CONTROLLER_REACTION_TIMER,
            CONTROLLER_STANDING_PROPOSALS_GAUGE,
            CONTROLLER_STANDING_VERSION_GAUGE,
            CONTROLLER_TICK_ERRORS_COUNTER,
            CONTROLLER_TICKS_COUNTER,
        )
        t0 = time.monotonic()
        proposals = diff_proposals(initial_host, final_host, self._maps)
        reaction_s: Optional[float] = None
        published: Optional[StandingProposalSet] = None
        publish_error: Optional[str] = None
        if proposals:
            if anchor is not None:
                reaction_s = self._clock() - anchor
            candidate = StandingProposalSet(
                version=self._version + 1,
                created_ms=int(time.time() * 1000),
                trigger=trigger,
                drift=report.score,
                proposals=proposals,
                reaction_s=reaction_s,
            )
            try:
                if self.journal is not None:
                    # write-ahead of the in-memory swap: a refused append
                    # (full disk, simulated crash, a newer fenced epoch)
                    # leaves the OLD set standing — memory and journal
                    # never diverge
                    self.journal.published(candidate)
                if self._hook_after_journal_publish is not None:
                    self._hook_after_journal_publish()
                superseded = self.standing
                self.standing = candidate
                self._version = candidate.version
                published = candidate
                if superseded is not None and self.journal is not None:
                    self.journal.invalidated(superseded.version, "superseded")
                if (
                    self.journal is not None
                    and self.journal.journal.appends >= 64
                ):
                    # supersession churn: everything but the set just
                    # published is dead state — compact (best-effort; a
                    # failed rewrite just replays more history)
                    try:
                        self.journal.rewrite(candidate)
                    except Exception:
                        pass
                self._count(CONTROLLER_PUBLISHED_COUNTER)
                self._gauge(CONTROLLER_STANDING_VERSION_GAUGE, candidate.version)
                self._gauge(CONTROLLER_STANDING_PROPOSALS_GAUGE, len(proposals))
                if reaction_s is not None:
                    self._timer(CONTROLLER_REACTION_TIMER, reaction_s)
            except Exception as e:
                publish_error = f"{type(e).__name__}: {e}"
                self._count(CONTROLLER_TICK_ERRORS_COUNTER)
                # the evidence was NOT answered: its reaction clock resumes
                restore_anchor()
        spans.append(
            obs.Span(
                "publish", "publish", time.monotonic() - t0, 0,
                attrs={
                    "proposals": len(proposals),
                    "error": publish_error,
                    **({"tenant": self.tenant} if self.tenant else {}),
                },
            )
        )

        # the new drift reference is this solve's OUTPUT: its placement (the
        # candidate future drains walk the cluster into) and its residual
        # violations (bounded rounds may leave a tail — measuring against it
        # keeps an unsolvable residue from re-triggering identical ticks).
        # A refused publish changes neither: the old set keeps standing and
        # the next wake retries against the old baseline.
        if publish_error is None:
            if published is not None:
                self._candidate_state = (
                    final_dev if final_dev is not None
                    else final_host.to(self.device)
                )
                self._candidate_host = final_host.to("cpu")
            self._solved_viol = inc.violations_after
            self._last_solve_mono = self._clock()

        # -- optional drain through the executor (existing policy knobs) ------
        drained = False
        if published is not None and publish_error is None and self.cfg.execute:
            drained = self._drain_standing(final_host)

        attrs = {
            "skipped": False,
            "trigger": trigger,
            "drift": report.score,
            "balancedness": report.balancedness,
            "goals_run": inc.goals_run,
            "moves": inc.total_moves,
            "num_proposals": len(proposals),
            "num_host_syncs": 1 + inc.num_host_syncs,   # drift + optimize
            "num_dispatches": 1 + inc.num_host_syncs,
            "standing_version": self.standing.version if self.standing else None,
            "reaction_s": reaction_s,
            "drained": drained,
            "error": publish_error,
        }
        if self.tenant is not None:
            attrs["tenant"] = self.tenant
        self._last_tick_attrs = attrs
        self._count(CONTROLLER_TICKS_COUNTER)
        return published, attrs

    # -- the single-tenant driver --------------------------------------------

    def _evaluate_and_tick(self, force: bool) -> Optional[StandingProposalSet]:
        token = obs.start_trace("controller_tick")
        spans: List[obs.Span] = []
        self.last_spans = spans

        # -- ingest: refresh the load leaves in place -------------------------
        t0 = time.monotonic()
        had_delta, anchor, _restore_anchor = self.tick_begin_evidence()
        refreshed, ingest_error = self.tick_ingest(had_delta)
        if ingest_error is not None:
            _restore_anchor()
            self._finish(token, spans, {"skipped": True, "error": ingest_error})
            return None
        spans.append(
            obs.Span(
                "ingest", "ingest", time.monotonic() - t0, 0,
                attrs={"partitions_refreshed": max(refreshed, 0)},
            )
        )

        # -- drift: one violations probe (one host fetch) + host math ---------
        t0 = time.monotonic()
        syncs = HostSyncs()
        (viol_now,) = host_fetch(
            syncs, [self._optimizer.violations(self.tick_probe_state(), self._ctx)]
        )
        report, trigger, stale = self.tick_decide(viol_now, force)
        spans.append(
            obs.Span(
                "drift", "drift", time.monotonic() - t0, syncs.count,
                attrs={
                    "score": report.score,
                    "hard_score": report.hard_score,
                    "violated_goals": report.violated_goals,
                },
            )
        )

        if trigger is None:
            self.tick_skipped()
            _restore_anchor()
            standing = self.standing
            self._finish(token, spans, {
                "skipped": True,
                "stale": stale,
                "drift": report.score,
                "balancedness": report.balancedness,
                "standing_version": standing.version if standing else None,
            })
            return None

        return self._tick(
            token, spans, viol_now, report, trigger, anchor, _restore_anchor
        )

    def _finish(self, token, spans, attrs: dict) -> None:
        """Close the ``controller_tick`` record under the JAX attribute names:
        the tick's ``num_host_syncs`` rides as ``num_dispatches`` alone."""
        obs.finish_trace(
            token, spans=spans,
            attrs={k: v for k, v in attrs.items() if k != "num_host_syncs"},
            device=self.device,
        )

    def _tick(
        self, token, spans, viol_now, report: DriftReport, trigger: str,
        anchor: Optional[float], restore_anchor,
    ) -> Optional[StandingProposalSet]:
        # -- bounded incremental optimize from the CURRENT placement ----------
        # viol_now was probed on the candidate when one exists; the optimize
        # starts from the TRACKED placement, whose violation set can be a
        # superset (it still carries what the standing set was fixing) -- let
        # incremental_optimize re-probe it (one more host fetch) in that case
        t0 = time.monotonic()
        initial_host = self._state_host
        final, inc = self._optimizer.incremental_optimize(
            self._state, self._ctx,
            max_rounds=self.cfg.max_rounds_per_tick,
            violations=viol_now if self._candidate_state is None else None,
        )
        syncs = HostSyncs()
        final_host = syncs.state(final)
        spans.append(
            obs.Span(
                "optimize", "optimize", time.monotonic() - t0,
                inc.num_host_syncs + syncs.count,
                attrs={
                    "goals_run": inc.goals_run,
                    "moves": inc.total_moves,
                    "rounds": inc.total_rounds,
                    "max_rounds_per_tick": self.cfg.max_rounds_per_tick,
                },
            )
        )

        published, attrs = self.tick_commit(
            spans, report, trigger, anchor, restore_anchor,
            initial_host, final_host, inc, final_dev=final,
        )
        self._finish(token, spans, attrs)
        return published

    def _drain_standing(self, final_host) -> bool:
        """Hand the standing set to the executor under its policy knobs.
        Clean drain advances the tracked placement to the candidate; a
        degraded one schedules a full rebuild (reality is now unknown)."""
        from cruise_control_tpu_torch.core.sensors import (
            CONTROLLER_DRAINED_COUNTER,
            CONTROLLER_STANDING_PROPOSALS_GAUGE,
        )
        from cruise_control_tpu_torch.executor.engine import OngoingExecutionError

        standing = self.standing
        if standing is None:
            return False
        try:
            summary = self.cc.executor.execute_proposals(
                standing.proposals, wait=True
            )
        except OngoingExecutionError:
            return False   # someone else is executing; the set keeps standing
        except Exception:
            self._needs_rebuild = True
            return False
        if self.journal is not None:
            self.journal.drained(standing.version, summary)
        self.standing = None
        self._count(CONTROLLER_DRAINED_COUNTER)
        self._gauge(CONTROLLER_STANDING_PROPOSALS_GAUGE, 0)
        if summary.succeeded:
            self._adopt_placement(final_host)
        else:
            self._needs_rebuild = True
        return True

    # -- surface -------------------------------------------------------------

    def _staleness_s(self) -> float:
        anchor = self._last_delta_mono
        if anchor is None:
            anchor = self._started_mono
        return max(self._clock() - anchor, 0.0)

    def _update_staleness_gauge(self) -> None:
        from cruise_control_tpu_torch.core.sensors import CONTROLLER_STALENESS_GAUGE

        self._gauge(CONTROLLER_STALENESS_GAUGE, self._staleness_s())

    def status(self) -> Dict[str, object]:
        """The CONTROLLER endpoint / STATE block payload."""
        from cruise_control_tpu_torch.core.sensors import (
            CONTROLLER_REACTION_TIMER,
            REGISTRY,
        )

        self._update_staleness_gauge()
        staleness = self._staleness_s()
        # a fleet tenant reads ITS reaction series, not the global one
        reaction = REGISTRY.timer(
            self._sensor_names(CONTROLLER_REACTION_TIMER)[-1]
        ).snapshot()
        drift = self._last_drift
        # capture once: the tick/drain thread swaps these without a lock
        # shared with the HTTP handler
        standing = self.standing
        maps = self._maps
        if self.paused:
            state = "paused"
        elif not self.warmed:
            state = "warming"
        else:
            state = "running"
        return {
            "state": state,
            "paused": self.paused,
            "pauseReason": self.pause_reason,
            "warmed": self.warmed,
            # backend blackout flag: the loop is holding position behind the
            # open breaker; the standing set below is what degraded
            # REBALANCE-family answers are served from
            "breakerOpen": (
                self.breaker.is_open if self.breaker is not None else False
            ),
            "stalenessS": round(staleness, 3),
            # no fresh window delta for longer than the stale budget: the
            # loop is flying blind (e.g. a reporter-feed outage) — it stops
            # reacting but the standing set stays intact (no thrash)
            "stale": staleness > self.cfg.stale_after_s,
            # writer epoch: which fenced regime this process mutates under
            # (0 = no journal / never fenced)
            "epoch": self.journal.epoch if self.journal is not None else 0,
            "drift": drift.score if drift else 0.0,
            "balancedness": drift.balancedness if drift else None,
            "violatedGoals": drift.violated_goals if drift else [],
            "standing": standing.to_dict() if standing else None,
            "reaction": {
                "p50S": reaction["p50_s"],
                "p95S": reaction["p95_s"],
                "count": reaction["count"],
            },
            "lastTick": self._last_tick_attrs,
            "topology": {
                "brokers": len(maps.broker_ids) if maps else 0,
                "partitions": len(maps.partitions) if maps else 0,
                "brokerBucket": self._bucket,
            },
            "config": {
                "tickIntervalS": self.cfg.tick_interval_s,
                "driftThreshold": self.cfg.drift_threshold,
                "maxRoundsPerTick": self.cfg.max_rounds_per_tick,
                "staleAfterS": self.cfg.stale_after_s,
                "execute": self.cfg.execute,
            },
        }
