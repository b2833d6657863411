"""Bounded retry with exponential backoff for southbound backend calls.

Port of ``cruise_control_tpu/core/retry.py``.

The reference leans on the Kafka AdminClient's internal retries
(``request.timeout.ms``/``retries``) and otherwise lets a failed admin call
abort the runnable; this framework's :class:`~cruise_control_tpu_torch.backend.base.ClusterBackend`
SPI makes every southbound call a plain Python method that "may raise on
backend failure", so the retry budget has to live on this side of the seam.

:class:`RetryPolicy` is that budget: bounded attempts, exponential backoff with
deterministic seeded jitter, an overall per-call deadline, and a retryable-vs-
fatal classification.  Transient transport-ish failures (``ConnectionError``,
``TimeoutError``, ``OSError`` — which covers
:class:`~cruise_control_tpu_torch.backend.chaos.ChaosInjectedError`) are retried;
anything else is treated as fatal and re-raised immediately, because blindly
replaying a non-idempotent admin mutation (e.g. a reassignment that partially
registered) is worse than surfacing the error.

Every call that needed at least one retry emits a ``kind="retry"`` trace into
the flight recorder (``obs/recorder.py`` → ``GET /traces?kind=retry``) and
ticks the ``RetryPolicy.*`` counters in the sensor registry, so flaky backends
are visible in the STATE/TRACES surface rather than silently absorbed.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple

from cruise_control_tpu_torch.core.sensors import (
    REGISTRY,
    RETRY_COUNTER,
    RETRY_EXHAUSTED_COUNTER,
    RETRY_FATAL_COUNTER,
)


class RetryExhaustedError(Exception):
    """A retryable call failed on every attempt within the budget."""

    def __init__(self, op_name: str, attempts: int, last: BaseException) -> None:
        super().__init__(
            f"{op_name}: {attempts} attempt(s) exhausted; last error: "
            f"{type(last).__name__}: {last}"
        )
        self.op_name = op_name
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass
class RetryPolicy:
    """Retry budget for one class of calls (shared across calls, thread-safe
    in the GIL-atomic sense — the RNG is only consulted for jitter)."""

    max_attempts: int = 5
    base_backoff_s: float = 0.02
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 1.0
    #: +/- fraction of the computed backoff, drawn from the seeded RNG
    jitter: float = 0.25
    #: overall wall budget per call() across all attempts (None = unbounded)
    deadline_s: Optional[float] = None
    retryable: Tuple[type, ...] = (ConnectionError, TimeoutError, OSError)
    #: checked before ``retryable`` — matches are never retried
    fatal: Tuple[type, ...] = ()
    seed: int = 0
    #: injectable for tests (virtual clocks); must accept one float
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    # -- classification -----------------------------------------------------

    def is_retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, self.fatal):
            return False
        return isinstance(exc, self.retryable)

    def backoff_s(self, failure_index: int) -> float:
        """Backoff after the ``failure_index``-th failure (0-based), jittered."""
        base = min(
            self.base_backoff_s * (self.backoff_multiplier ** failure_index),
            self.max_backoff_s,
        )
        if self.jitter > 0:
            base *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(base, 0.0)

    # -- execution ----------------------------------------------------------

    def call(
        self,
        fn: Callable,
        *args,
        op_name: Optional[str] = None,
        assume_applied_on: Tuple[type, ...] = (),
        **kwargs,
    ):
        """Run ``fn(*args, **kwargs)`` under the retry budget.

        Raises the original exception for fatal errors and
        :class:`RetryExhaustedError` (chained to the last error) when the
        attempt/deadline budget runs out.

        ``assume_applied_on``: exception types that, raised on a *retry*
        attempt (never the first), mean the previous attempt actually applied
        server-side and only its response was lost — e.g. a replayed
        reassignment answered with ``ReassignmentInProgress``.  The call is
        treated as a success (returns ``None``) instead of degrading a
        mutation that already took effect into a fatal error.
        """
        from cruise_control_tpu_torch.obs import recorder as obs

        op = op_name or getattr(fn, "__name__", "call")
        t_start = time.monotonic()
        token = None          # retry trace opened lazily at the first failure
        attempts = 0
        while True:
            attempts += 1
            try:
                result = fn(*args, **kwargs)
            except Exception as e:
                if attempts > 1 and isinstance(e, assume_applied_on):
                    obs.finish_trace(
                        token, attrs=self._attrs(op, attempts, "assumed-applied", e)
                    )
                    return None
                if not self.is_retryable(e):
                    REGISTRY.counter(RETRY_FATAL_COUNTER).inc()
                    if token is not None:
                        obs.finish_trace(token, attrs=self._attrs(op, attempts, "fatal", e))
                    raise
                if token is None:
                    token = obs.start_trace("retry")
                elapsed = time.monotonic() - t_start
                out_of_budget = attempts >= self.max_attempts or (
                    self.deadline_s is not None and elapsed >= self.deadline_s
                )
                if out_of_budget:
                    REGISTRY.counter(RETRY_EXHAUSTED_COUNTER).inc()
                    obs.finish_trace(token, attrs=self._attrs(op, attempts, "exhausted", e))
                    raise RetryExhaustedError(op, attempts, e) from e
                REGISTRY.counter(RETRY_COUNTER).inc()
                self.sleep(self.backoff_s(attempts - 1))
                continue
            if token is not None:
                obs.finish_trace(token, attrs=self._attrs(op, attempts, "success", None))
            return result

    @staticmethod
    def _attrs(op: str, attempts: int, outcome: str, error: Optional[BaseException]) -> dict:
        attrs = {"op": op, "attempts": attempts, "outcome": outcome}
        if error is not None:
            attrs["error"] = f"{type(error).__name__}: {error}"
        return attrs
