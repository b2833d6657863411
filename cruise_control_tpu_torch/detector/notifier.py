"""Anomaly notifier SPI + self-healing policy.

Port of ``cruise_control_tpu/detector/notifier.py`` (pure Python, copied).

Counterpart of ``detector/notifier/`` — ``AnomalyNotifier`` decides per anomaly
whether to IGNORE, FIX now, or CHECK again after a delay.  ``SelfHealingNotifier``
(SelfHealingNotifier.java:58) implements the reference's policy: per-type
self-healing enable switches, and for broker failures a two-stage grace period —
alert after ``broker_failure_alert_threshold_ms``, auto-fix only after
``broker_failure_self_healing_threshold_ms`` (onBrokerFailure:228) so transient
bounces don't trigger replica mass-movement.

The webhook notifiers (Slack/MSTeams/Alerta in the reference) reduce to
:class:`AlertCallbackNotifier`, which invokes a user callback with the rendered
alert — the transport is the deployment's concern.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    AnomalyType,
    BrokerFailures,
    NotificationResult,
)


class AnomalyNotifier:
    """Base notifier: fix everything immediately (useful in tests)."""

    def on_anomaly(self, anomaly: Anomaly) -> NotificationResult:
        return NotificationResult.fix()

    @property
    def self_healing_enabled(self) -> Dict[AnomalyType, bool]:
        return {t: True for t in AnomalyType}


class NoopNotifier(AnomalyNotifier):
    """NoopNotifier.java: observe only, never fix."""

    def on_anomaly(self, anomaly: Anomaly) -> NotificationResult:
        return NotificationResult.ignore()

    @property
    def self_healing_enabled(self) -> Dict[AnomalyType, bool]:
        return {t: False for t in AnomalyType}


class SelfHealingNotifier(AnomalyNotifier):
    def __init__(
        self,
        enabled: Optional[Dict[AnomalyType, bool]] = None,
        broker_failure_alert_threshold_ms: int = 15 * 60_000,
        broker_failure_self_healing_threshold_ms: int = 30 * 60_000,
        alert: Optional[Callable[[str, bool], None]] = None,
        now_ms: Optional[Callable[[], int]] = None,
    ) -> None:
        self._enabled = {t: True for t in AnomalyType}
        if enabled:
            self._enabled.update(enabled)
        self.alert_threshold_ms = broker_failure_alert_threshold_ms
        self.self_healing_threshold_ms = broker_failure_self_healing_threshold_ms
        self._alert = alert or (lambda msg, auto_fix: None)
        self._now = now_ms or (lambda: int(time.time() * 1000))
        self.alerts: List[str] = []

    @property
    def self_healing_enabled(self) -> Dict[AnomalyType, bool]:
        return dict(self._enabled)

    def set_self_healing(self, anomaly_type: AnomalyType, enabled: bool) -> None:
        self._enabled[anomaly_type] = enabled

    def _emit(self, message: str, auto_fix: bool) -> None:
        self.alerts.append(message)
        self._alert(message, auto_fix)

    def on_anomaly(self, anomaly: Anomaly) -> NotificationResult:
        if isinstance(anomaly, BrokerFailures):
            return self._on_broker_failure(anomaly)
        if not self._enabled.get(anomaly.anomaly_type, False):
            self._emit(f"{anomaly.description()} detected (self-healing disabled)", False)
            return NotificationResult.ignore()
        self._emit(f"{anomaly.description()} detected; self-healing started", True)
        return NotificationResult.fix()

    def _on_broker_failure(self, anomaly: BrokerFailures) -> NotificationResult:
        """Two-stage grace period (SelfHealingNotifier.onBrokerFailure:228)."""
        if not anomaly.failed_brokers:
            return NotificationResult.ignore()
        now = self._now()
        earliest = min(anomaly.failed_brokers.values())
        alert_at = earliest + self.alert_threshold_ms
        fix_at = earliest + self.self_healing_threshold_ms
        if now < alert_at:
            return NotificationResult.check(alert_at - now)
        if not self._enabled.get(AnomalyType.BROKER_FAILURE, False):
            self._emit(f"{anomaly.description()} (self-healing disabled)", False)
            return NotificationResult.ignore()
        if now < fix_at:
            self._emit(f"{anomaly.description()} — fix scheduled", False)
            return NotificationResult.check(fix_at - now)
        self._emit(f"{anomaly.description()} — removing failed brokers", True)
        return NotificationResult.fix()


class AlertCallbackNotifier(SelfHealingNotifier):
    """Stands in for the Slack/MSTeams/Alerta notifiers: same policy as
    SelfHealingNotifier, alerts delivered through the provided callback."""
