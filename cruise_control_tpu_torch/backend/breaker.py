"""Backend circuit breaker: fail fast instead of stacking callers in backoff.

Port of ``cruise_control_tpu/backend/breaker.py`` (pure Python, copied; the
counters are the port's own ``core/sensors.py`` registry).

A :class:`~cruise_control_tpu_torch.core.retry.RetryPolicy` makes each caller
survive a flaky backend, but it makes a *dead* backend worse: during a
blackout every caller -- the sampling loop, the detectors, the controller --
burns its full attempt/backoff budget against a cluster that cannot answer.
The breaker is a shared seam *under* the retry policy:

* **closed** -- calls pass through; consecutive failures are counted (any
  success resets the streak).
* **open** -- after ``failure_threshold`` consecutive failures every call
  raises :class:`BreakerOpenError` *without touching the backend*.
  ``BreakerOpenError`` is deliberately NOT a ``ConnectionError``: the retry
  policy classifies it as fatal, so an open breaker collapses a would-be
  retry storm into one immediate error per caller.
* **half-open** -- once the cooldown expires, exactly ONE caller becomes the
  probe (everyone else keeps failing fast); probe success closes the breaker,
  probe failure re-opens it with an exponentially longer cooldown (bounded by
  ``max_open_s``).

The cooldown jitter is drawn from a seeded RNG and state transitions are
driven by an injectable clock, so tests never sleep and replay exactly.

:class:`BreakerBackend` is the duck-typed proxy: southbound SPI calls are
guarded, unknown attributes (test helpers like ``kill_broker``) delegate to
the inner backend.  While the breaker is open the detector manager skips its
passes with a counted reason and the controller stops ticking (its standing
set stays published).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from cruise_control_tpu_torch.core.sensors import (
    BREAKER_CLOSES_COUNTER,
    BREAKER_FAST_FAILURES_COUNTER,
    BREAKER_OPENS_COUNTER,
    BREAKER_PROBES_COUNTER,
    BREAKER_STATE_GAUGE,
    REGISTRY,
)

__all__ = ["BreakerOpenError", "BreakerState", "CircuitBreaker", "BreakerBackend"]


class BreakerOpenError(Exception):
    """The backend circuit breaker is open: the call failed fast, the backend
    was never touched.  NOT a ``ConnectionError`` — the retry policy must
    treat it as fatal, or an open breaker would still burn backoff budgets."""

    def __init__(self, op: str, retry_after_s: float) -> None:
        super().__init__(
            f"backend circuit breaker open ({op}); retry after "
            f"~{retry_after_s:.1f}s"
        )
        self.op = op
        self.retry_after_s = retry_after_s


class BreakerState:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    _GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    """Shared breaker state; one instance guards one backend seam."""

    def __init__(
        self,
        failure_threshold: int = 5,
        open_s: float = 10.0,
        backoff_multiplier: float = 2.0,
        max_open_s: float = 60.0,
        jitter: float = 0.1,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.failure_threshold = max(int(failure_threshold), 1)
        self.open_s = open_s
        self.backoff_multiplier = backoff_multiplier
        self.max_open_s = max_open_s
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._consecutive_failures = 0
        self._consecutive_opens = 0
        self._opened_at = 0.0
        self._cooldown_s = open_s
        self._probe_in_flight = False
        self._probe_started = 0.0
        self.opens = 0
        self.closes = 0
        self.probes = 0
        self.fast_failures = 0
        self.last_error: Optional[str] = None
        self._export_state()

    # -- state machine -------------------------------------------------------

    def _export_state(self) -> None:
        REGISTRY.gauge(BREAKER_STATE_GAUGE).set(BreakerState._GAUGE[self._state])

    def _next_cooldown(self) -> float:
        base = min(
            self.open_s * (self.backoff_multiplier ** self._consecutive_opens),
            self.max_open_s,
        )
        if self.jitter > 0:
            base *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(base, 0.001)

    def _open_locked(self) -> None:
        self._cooldown_s = self._next_cooldown()
        self._consecutive_opens += 1
        self._opened_at = self._clock()
        self._state = BreakerState.OPEN
        self._probe_in_flight = False
        self.opens += 1
        REGISTRY.counter(BREAKER_OPENS_COUNTER).inc()
        self._export_state()

    def before_call(self, op: str) -> bool:
        """Gate one backend call.  Returns True when the call is the
        half-open probe (the caller MUST report its outcome); raises
        :class:`BreakerOpenError` when the call must fail fast."""
        with self._lock:
            if self._state == BreakerState.CLOSED:
                return False
            remaining = self._opened_at + self._cooldown_s - self._clock()
            if self._state == BreakerState.OPEN and remaining <= 0:
                self._state = BreakerState.HALF_OPEN
                self._export_state()
            if self._state == BreakerState.HALF_OPEN and (
                not self._probe_in_flight
                # probe reclaim: a probe that has been outstanding longer
                # than a whole cooldown is presumed hung/dead (hung socket,
                # thread killed by BaseException) — without this the seam
                # would fail fast FOREVER on one wedged probe
                or self._clock() - self._probe_started > self._cooldown_s
            ):
                # exactly one live caller probes; everyone else fails fast
                self._probe_in_flight = True
                self._probe_started = self._clock()
                self.probes += 1
                REGISTRY.counter(BREAKER_PROBES_COUNTER).inc()
                return True
            self.fast_failures += 1
            REGISTRY.counter(BREAKER_FAST_FAILURES_COUNTER).inc()
            raise BreakerOpenError(op, max(remaining, 0.0))

    def record_success(self, probe: bool = False) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state != BreakerState.CLOSED:
                self._state = BreakerState.CLOSED
                self._consecutive_opens = 0
                self._probe_in_flight = False
                self.closes += 1
                REGISTRY.counter(BREAKER_CLOSES_COUNTER).inc()
                self._export_state()

    def record_failure(self, error: BaseException, probe: bool = False) -> None:
        with self._lock:
            self.last_error = f"{type(error).__name__}: {error}"
            if probe or self._state == BreakerState.HALF_OPEN:
                # failed probe: straight back to open, longer cooldown
                self._open_locked()
                return
            self._consecutive_failures += 1
            if (
                self._state == BreakerState.CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._open_locked()

    # -- introspection -------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == BreakerState.OPEN:
                if self._opened_at + self._cooldown_s - self._clock() <= 0:
                    return BreakerState.HALF_OPEN
            return self._state

    @property
    def is_open(self) -> bool:
        """True while calls would fail fast (open, cooldown not expired).
        Half-open reads as NOT open: a probe is allowed, so degraded serving
        paths should attempt real work again."""
        with self._lock:
            return (
                self._state == BreakerState.OPEN
                and self._opened_at + self._cooldown_s - self._clock() > 0
            )

    def retry_after_s(self) -> float:
        """Seconds until the next probe window — the Retry-After a degraded
        response should carry."""
        with self._lock:
            if self._state == BreakerState.CLOSED:
                return 0.0
            return max(self._opened_at + self._cooldown_s - self._clock(), 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutiveFailures": self._consecutive_failures,
                "opens": self.opens,
                "closes": self.closes,
                "probes": self.probes,
                "fastFailures": self.fast_failures,
                "cooldownS": round(self._cooldown_s, 3),
                "lastError": self.last_error,
            }


class BreakerBackend:
    """Duck-typed backend proxy: southbound SPI calls run through the shared
    :class:`CircuitBreaker`; everything else delegates untouched (the
    ``_RetryingBackend`` pattern — test helpers on the wrapped backend stay
    reachable)."""

    #: the ClusterBackend SPI surface (matches _RetryingBackend._RETRIED plus
    #: the metric feed — a blacked-out metric pipe must open the breaker too,
    #: or the sampling loop would hang-and-retry forever)
    _GUARDED = frozenset(
        {
            "describe_cluster",
            "describe_topics",
            "describe_logdirs",
            "fetch_raw_metrics",
            "alter_partition_reassignments",
            "list_partition_reassignments",
            "list_ongoing_reassignments",
            "elect_leaders",
            "alter_replica_logdirs",
            "set_replication_throttles",
            "clear_replication_throttles",
        }
    )

    def __init__(self, inner, breaker: CircuitBreaker) -> None:
        self.inner = inner
        self.breaker = breaker

    def __getattr__(self, name: str):
        attr = getattr(self.inner, name)
        if name in self._GUARDED and callable(attr):
            breaker = self.breaker

            def guarded(*args, **kwargs):
                probe = breaker.before_call(name)   # raises when open
                try:
                    result = attr(*args, **kwargs)
                except BaseException as e:
                    # every backend exception counts: a dead backend raises
                    # ConnectionErrors, a crashed-process chaos plan raises
                    # SimulatedCrash — both mean the seam is unhealthy.
                    # BaseException (not Exception): a probe thread dying to
                    # KeyboardInterrupt/SystemExit must still hand the probe
                    # token back, or the breaker stays half-open-wedged
                    breaker.record_failure(e, probe=probe)
                    raise
                breaker.record_success(probe=probe)
                return result

            return guarded
        return attr
