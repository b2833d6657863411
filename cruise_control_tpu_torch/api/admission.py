"""Admission control: rate limits, quotas, priority queueing, load shedding.

Port of ``cruise_control_tpu/api/admission.py`` (pure Python, copied whole); its sensors and flight records go to the port's ``core/sensors`` and ``obs/recorder``.

The serving surface used to collapse under load in the ugliest possible way:
the 26th concurrent POST hit ``UserTaskManager``'s active-task cap and escaped
as a bare 500, every principal shared one unbounded lane, and nothing between
the socket and the solver ever said "not now, try later".  This module is the
"not now": every authenticated request passes the :class:`AdmissionController`
before any work happens, and rejected work gets a real ``429`` with a
``Retry-After`` derived from live queue depth and drain rate — never a 500.

Three mechanisms, checked in order of cheapness:

* **Per-principal token buckets** (``admission.rate.limit.qps`` /
  ``admission.rate.burst``): one bucket per principal (the ``security.py``
  user; anonymous requests under :class:`NoSecurityProvider` share the
  ``"(anonymous)"`` principal and the default tier).  A dry bucket sheds with
  ``Retry-After`` = time until the next token.

* **Per-principal active-operation quotas**
  (``admission.max.tasks.per.principal``): a principal already holding its
  quota of in-flight solver operations is shed immediately — waiting in the
  queue cannot make its own backlog drain faster, and letting it queue would
  let one tenant starve the rest.

* **A global bounded priority queue** feeding the user-task plane: when all
  execution slots (``admission.max.concurrent``, default = the user-task
  active cap) are busy, solver-class requests wait in a bounded heap ordered
  by ``priority = endpoint class × principal tier`` (mutations outrank
  analytics, operators outrank tenants — the hierarchical multi-objective
  shape of arxiv 2512.07792 applied to the serving plane).  The wait is
  bounded by ``admission.queue.timeout.ms`` AND the request's own budget
  (``deadline_ms``, the same budget that becomes the solver's per-request
  ``optimize.deadline.ms``) — an over-deadline queued request is shed
  *before* it reaches the solver.  A full queue sheds instantly.

Cheap reads (STATE / METRICS / HEALTHZ / TRACES / USER_TASKS …) and operator
escape hatches (STOP_PROPOSAL_EXECUTION, ADMIN, CONTROLLER) bypass both the
bucket and the queue entirely: shedding the observability surface during
overload blinds the operator at exactly the moment they need it, and an
emergency stop that can be rate-limited is not an emergency stop.

Dedupe composes with quotas: the server checks the user-task dedupe key
*before* admission, so a re-submitted request (the reference's poll-by-repost
idiom) rides its existing task and consumes no quota; a ticket acquired for a
request that then loses the creation race is released by ``get_or_create``
itself (the lifecycle lives where the state lives).

Everything here is host-side Python — the optimize and controller-tick warm
paths gain exactly 0 host syncs and 0 compile events (asserted from the
obs flight record in tests/test_admission.py).
"""

from __future__ import annotations

import contextvars
import dataclasses
import heapq
import itertools
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.api.security import Role
from cruise_control_tpu_torch.core.sensors import (
    ADMISSION_ACTIVE_GAUGE,
    ADMISSION_ADMITTED_COUNTER,
    ADMISSION_DEDUPE_HITS_COUNTER,
    ADMISSION_DRAIN_METER,
    ADMISSION_QUEUE_DEPTH_GAUGE,
    ADMISSION_QUEUED_COUNTER,
    ADMISSION_SHED_COUNTER,
    ADMISSION_SHED_DEADLINE_COUNTER,
    ADMISSION_SHED_QUEUE_FULL_COUNTER,
    ADMISSION_SHED_QUOTA_COUNTER,
    ADMISSION_SHED_RATE_COUNTER,
    ADMISSION_WAIT_TIMER,
    REGISTRY,
)

ANONYMOUS_PRINCIPAL = "(anonymous)"

#: endpoints that bypass the bucket AND the queue: the observability surface
#: (shedding it blinds the operator mid-incident) and the operator escape
#: hatches (an emergency stop that can be rate-limited is not one)
CHEAP_ENDPOINTS = {
    "HEALTHZ", "METRICS", "STATE", "TRACES", "USER_TASKS", "PERMISSIONS",
    "REVIEW_BOARD", "CONTROLLER", "FLEET", "ADMIN", "REVIEW",
    "STOP_PROPOSAL_EXECUTION", "WATCH", "SLO",
}

#: endpoint class ranks for queue priority (lower = drains first): cluster
#: mutations outrank what-if analytics — during overload the corrective
#: rebalance must not starve behind a batch of speculative SIMULATE sweeps
MUTATE_ENDPOINTS = {
    "REBALANCE", "ADD_BROKER", "REMOVE_BROKER", "DEMOTE_BROKER",
    "FIX_OFFLINE_REPLICAS", "TOPIC_CONFIGURATION", "REMOVE_DISKS",
}
ANALYTICS_ENDPOINTS = {"SIMULATE", "RIGHTSIZE"}

#: principal tier by authenticated role (ADMIN drains first); anonymous
#: principals get the configured default tier instead
TIER_BY_ROLE = {Role.ADMIN: 0, Role.USER: 1, Role.VIEWER: 2}


def endpoint_class_rank(endpoint: str) -> int:
    if endpoint in MUTATE_ENDPOINTS:
        return 0
    if endpoint in ANALYTICS_ENDPOINTS:
        return 1
    return 0


def principal_of(user: Optional[str]) -> str:
    return user if user else ANONYMOUS_PRINCIPAL


#: per-request context (principal, role, deadline budget) set by the HTTP
#: handler and read by the async-op plumbing — requests are thread-per-
#: connection but the user-task key/work closure crosses functions, and a
#: contextvar beats threading it through every post_* signature
_REQUEST_CONTEXT: contextvars.ContextVar[Optional["RequestContext"]] = (
    contextvars.ContextVar("cc_tpu_request_context", default=None)
)


@dataclasses.dataclass
class RequestContext:
    principal: str = ANONYMOUS_PRINCIPAL
    role: Optional[Role] = None
    anonymous: bool = True
    #: monotonic deadline of the client budget (deadline_ms), None = unbounded
    deadline_mono: Optional[float] = None

    def remaining_s(self) -> Optional[float]:
        if self.deadline_mono is None:
            return None
        return self.deadline_mono - time.monotonic()


def set_request_context(ctx: Optional[RequestContext]):
    return _REQUEST_CONTEXT.set(ctx)


def reset_request_context(token) -> None:
    _REQUEST_CONTEXT.reset(token)


def current_request_context() -> Optional[RequestContext]:
    return _REQUEST_CONTEXT.get()


class AdmissionRefused(Exception):
    """Shed: the request was refused by admission control.  The API layer
    maps this to ``429`` + ``Retry-After`` (never a 500 — the whole point)."""

    def __init__(self, reason: str, retry_after_s: float, detail: str = "") -> None:
        super().__init__(detail or f"admission refused: {reason}")
        self.reason = reason
        self.retry_after_s = max(retry_after_s, 1.0)


class TokenBucket:
    """Deterministic token bucket (refill on read, injectable clock)."""

    def __init__(
        self, qps: float, burst: float, clock: Callable[[], float] = time.monotonic
    ) -> None:
        self.qps = qps
        self.capacity = max(burst, 1.0)
        self.tokens = self.capacity
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def try_acquire(self) -> Tuple[bool, float]:
        """(acquired, seconds-until-next-token-if-not)."""
        with self._lock:
            now = self._clock()
            self.tokens = min(
                self.capacity, self.tokens + (now - self._last) * self.qps
            )
            self._last = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True, 0.0
            need = 1.0 - self.tokens
            return False, need / self.qps if self.qps > 0 else float("inf")


@dataclasses.dataclass
class AdmissionConfig:
    """The ``admission.*`` knob block (core/config_defs.py).  The defaults
    are deliberately permissive — admission is a posture, the knobs are the
    policy — except the queue, which is always bounded."""

    enabled: bool = True
    #: per-principal request rate (token bucket); 0 = unlimited
    rate_qps: float = 0.0
    #: bucket depth; 0 = derived (max(2×qps, 1))
    rate_burst: float = 0.0
    #: per-principal cap on in-flight solver operations; 0 = no quota
    max_tasks_per_principal: int = 0
    #: global concurrent solver-operation slots (defaults to the user-task
    #: active cap in the app shell)
    max_concurrent: int = 25
    #: bounded priority queue depth; arrivals past it shed instantly
    queue_capacity: int = 64
    #: longest a request may wait for a slot (also bounded by its own
    #: deadline_ms budget)
    queue_timeout_s: float = 5.0
    #: Retry-After fallback when no drain rate has been observed yet
    default_retry_after_s: float = 5.0
    #: queue tier for anonymous principals (NoSecurityProvider)
    default_tier: int = 1


class AdmissionTicket:
    """One admitted solver operation; release exactly once (idempotent).
    Handed to ``UserTaskManager.get_or_create``, which ties the release to
    the task lifecycle (completion, failed creation rollback, or dedupe)."""

    __slots__ = ("controller", "principal", "released")

    def __init__(self, controller: "AdmissionController", principal: str) -> None:
        self.controller = controller
        self.principal = principal
        self.released = False

    def release(self) -> None:
        self.controller.release(self)


class AdmissionController:
    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.cfg = config or AdmissionConfig()
        self._clock = clock
        self._cv = threading.Condition()
        self._buckets: Dict[str, TokenBucket] = {}
        self._buckets_lock = threading.Lock()
        self._active = 0
        self._active_by_principal: Dict[str, int] = {}
        #: waiter heap entries: [priority, seq]
        self._waiters: List[list] = []
        self._seq = itertools.count()
        self.admitted = 0
        self.shed = 0
        self.shed_by_reason: Dict[str, int] = {}
        self.shed_by_principal: Dict[str, int] = {}
        #: principal → queue tier, set by the fleet controller (tenant →
        #: principal tier threading): a named tenant's requests queue at its
        #: configured tier regardless of role/anonymity, so a noisy low-tier
        #: tenant drains AFTER every higher tier even when both are anonymous
        self._tier_overrides: Dict[str, int] = {}

    # -- classification ------------------------------------------------------

    def set_tier_override(self, principal: str, tier: int) -> None:
        """Pin a principal's queue tier (fleet tenant → tier mapping)."""
        self._tier_overrides[principal] = int(tier)

    def tier_of(
        self,
        role: Optional[Role],
        anonymous: bool,
        principal: Optional[str] = None,
    ) -> int:
        if principal is not None and principal in self._tier_overrides:
            return self._tier_overrides[principal]
        if anonymous or role is None:
            return self.cfg.default_tier
        return TIER_BY_ROLE.get(role, self.cfg.default_tier)

    def priority(
        self,
        endpoint: str,
        role: Optional[Role],
        anonymous: bool,
        principal: Optional[str] = None,
    ) -> int:
        # class dominates tier: a tenant's corrective mutation still outranks
        # an operator's speculative sweep (the sweep can always wait).  The
        # tier slot is sized for the largest role tier or tenant override in
        # play, so an override can only reorder WITHIN an endpoint class.
        max_tier = max(TIER_BY_ROLE.values())
        if self._tier_overrides:
            max_tier = max(max_tier, max(self._tier_overrides.values()))
        return endpoint_class_rank(endpoint) * (max_tier + 2) + (
            self.tier_of(role, anonymous, principal=principal)
        )

    # -- shedding ------------------------------------------------------------

    def _shed(
        self, reason: str, counter: str, retry_after_s: float,
        principal: str, endpoint: str, detail: str = "",
    ) -> AdmissionRefused:
        from cruise_control_tpu_torch.obs import recorder as obs

        self.shed += 1
        self.shed_by_reason[reason] = self.shed_by_reason.get(reason, 0) + 1
        self.shed_by_principal[principal] = (
            self.shed_by_principal.get(principal, 0) + 1
        )
        REGISTRY.counter(ADMISSION_SHED_COUNTER).inc()
        REGISTRY.counter(counter).inc()
        token = obs.start_trace("admission")
        obs.finish_trace(
            token,
            attrs={
                "outcome": "shed",
                "reason": reason,
                "principal": principal,
                "endpoint": endpoint,
                "retry_after_s": round(retry_after_s, 3),
                "queue_depth": len(self._waiters),
            },
        )
        return AdmissionRefused(
            reason,
            retry_after_s,
            detail
            or f"{endpoint}: admission refused ({reason}) for {principal}",
        )

    def retry_after_estimate(self) -> float:
        """Retry-After for capacity sheds, derived from live queue depth and
        the observed drain rate: roughly how long until today's backlog (plus
        you) has drained.  Falls back to the configured default before any
        drain has been observed."""
        rate = REGISTRY.meter(ADMISSION_DRAIN_METER).snapshot()["rate_per_s"]
        depth = len(self._waiters) + max(self._active, 0)
        if rate <= 0.0:
            return self.cfg.default_retry_after_s
        return float(
            min(max(math.ceil((depth + 1) / rate), 1), 300)
        )

    def shed_deadline(self, principal: str, endpoint: str, detail: str = ""):
        """Raise an ACCOUNTED deadline shed — for callers that discover only
        mid-work (after admission) that the client budget is already spent.
        Routing through :meth:`_shed` keeps the counters, per-reason split,
        and the ``admission`` trace consistent with every other shed path."""
        raise self._shed(
            "deadline", ADMISSION_SHED_DEADLINE_COUNTER,
            self.retry_after_estimate(), principal, endpoint, detail=detail,
        )

    # -- rate limiting (every non-cheap authenticated request) ---------------

    def check_rate(self, principal: str, endpoint: str) -> None:
        if not self.cfg.enabled or self.cfg.rate_qps <= 0:
            return
        with self._buckets_lock:
            bucket = self._buckets.get(principal)
            if bucket is None:
                burst = self.cfg.rate_burst or max(2 * self.cfg.rate_qps, 1.0)
                bucket = TokenBucket(self.cfg.rate_qps, burst, self._clock)
                self._buckets[principal] = bucket
        ok, wait_s = bucket.try_acquire()
        if not ok:
            raise self._shed(
                "rate-limited", ADMISSION_SHED_RATE_COUNTER,
                max(math.ceil(wait_s), 1), principal, endpoint,
                detail=(
                    f"{endpoint}: rate limit exceeded for {principal} "
                    f"({self.cfg.rate_qps:g} req/s)"
                ),
            )

    # -- the queue (solver-class operations only) ----------------------------

    def note_dedupe_hit(self) -> None:
        REGISTRY.counter(ADMISSION_DEDUPE_HITS_COUNTER).inc()

    def acquire(
        self,
        principal: str,
        endpoint: str,
        role: Optional[Role] = None,
        anonymous: bool = True,
        deadline_s: Optional[float] = None,
    ) -> Optional[AdmissionTicket]:
        """Admit one solver-class operation, waiting in the bounded priority
        queue when all slots are busy.  Returns a ticket (release ties to the
        task lifecycle), or None when admission is disabled.  Raises
        :class:`AdmissionRefused` on quota, full queue, or deadline."""
        if not self.cfg.enabled:
            return None
        quota = self.cfg.max_tasks_per_principal
        prio = self.priority(endpoint, role, anonymous, principal=principal)
        with self._cv:
            if quota and self._active_by_principal.get(principal, 0) >= quota:
                # waiting cannot help: the principal's own backlog is the
                # bottleneck, and queueing it would starve other tenants
                raise self._shed(
                    "principal-quota", ADMISSION_SHED_QUOTA_COUNTER,
                    self.retry_after_estimate(), principal, endpoint,
                    detail=(
                        f"{endpoint}: {principal} already holds {quota} "
                        "in-flight operation(s) (per-principal quota)"
                    ),
                )
            if self._active < self.cfg.max_concurrent and not self._waiters:
                return self._admit_locked(principal, waited_s=0.0)
            if len(self._waiters) >= self.cfg.queue_capacity:
                raise self._shed(
                    "queue-full", ADMISSION_SHED_QUEUE_FULL_COUNTER,
                    self.retry_after_estimate(), principal, endpoint,
                )
            entry = [prio, next(self._seq)]
            heapq.heappush(self._waiters, entry)
            REGISTRY.counter(ADMISSION_QUEUED_COUNTER).inc()
            REGISTRY.gauge(ADMISSION_QUEUE_DEPTH_GAUGE).set(len(self._waiters))
            budget = self.cfg.queue_timeout_s
            if deadline_s is not None:
                budget = min(budget, deadline_s)
            t0 = self._clock()
            deadline = t0 + budget
            try:
                while True:
                    if (
                        self._waiters
                        and self._waiters[0] is entry
                        and self._active < self.cfg.max_concurrent
                    ):
                        if quota and (
                            self._active_by_principal.get(principal, 0) >= quota
                        ):
                            raise self._shed(
                                "principal-quota", ADMISSION_SHED_QUOTA_COUNTER,
                                self.retry_after_estimate(), principal, endpoint,
                            )
                        heapq.heappop(self._waiters)
                        # another slot may be free for the next waiter
                        self._cv.notify_all()
                        return self._admit_locked(
                            principal, waited_s=self._clock() - t0
                        )
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        # shed BEFORE the solver: the client's budget (or the
                        # queue policy) is already spent waiting
                        raise self._shed(
                            "deadline", ADMISSION_SHED_DEADLINE_COUNTER,
                            self.retry_after_estimate(), principal, endpoint,
                            detail=(
                                f"{endpoint}: queued {budget:.1f}s without a "
                                "free slot (over deadline)"
                            ),
                        )
                    # cv.wait with a poll guard: a missed notify must not
                    # strand a waiter past its deadline
                    self._cv.wait(min(remaining, 0.05))
            finally:
                if entry in self._waiters:
                    self._waiters.remove(entry)
                    heapq.heapify(self._waiters)
                REGISTRY.gauge(ADMISSION_QUEUE_DEPTH_GAUGE).set(len(self._waiters))

    def _admit_locked(self, principal: str, waited_s: float) -> AdmissionTicket:
        self._active += 1
        self._active_by_principal[principal] = (
            self._active_by_principal.get(principal, 0) + 1
        )
        self.admitted += 1
        REGISTRY.counter(ADMISSION_ADMITTED_COUNTER).inc()
        REGISTRY.gauge(ADMISSION_ACTIVE_GAUGE).set(self._active)
        REGISTRY.timer(ADMISSION_WAIT_TIMER).update(waited_s)
        return AdmissionTicket(self, principal)

    def release(self, ticket: AdmissionTicket) -> None:
        with self._cv:
            if ticket.released:
                return
            ticket.released = True
            self._active = max(self._active - 1, 0)
            n = self._active_by_principal.get(ticket.principal, 0) - 1
            if n <= 0:
                self._active_by_principal.pop(ticket.principal, None)
            else:
                self._active_by_principal[ticket.principal] = n
            REGISTRY.gauge(ADMISSION_ACTIVE_GAUGE).set(self._active)
            REGISTRY.meter(ADMISSION_DRAIN_METER).mark()
            self._cv.notify_all()

    # -- surface -------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "enabled": self.cfg.enabled,
                "admitted": self.admitted,
                "shed": self.shed,
                "shedByReason": dict(self.shed_by_reason),
                "shedByPrincipal": dict(self.shed_by_principal),
                "active": self._active,
                "activeByPrincipal": dict(self._active_by_principal),
                "tierOverrides": dict(self._tier_overrides),
                "queueDepth": len(self._waiters),
                "queueCapacity": self.cfg.queue_capacity,
                "maxConcurrent": self.cfg.max_concurrent,
                "rateQps": self.cfg.rate_qps,
                "maxTasksPerPrincipal": self.cfg.max_tasks_per_principal,
            }
