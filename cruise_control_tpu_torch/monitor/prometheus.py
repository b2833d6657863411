"""Prometheus metric sampler.

Port of ``cruise_control_tpu/monitor/prometheus.py`` (pure Python, copied whole).

Counterpart of ``sampling/prometheus/PrometheusMetricSampler.java:52`` (+
``PrometheusAdapter`` and the ``model/`` DTOs): samples broker/topic/partition
metrics from a Prometheus server's ``/api/v1/query_range`` endpoint and feeds
them through the same derivation processor as the backend sampler.

The default query set mirrors the reference's mapping of RawMetricTypes to
node-exporter/kafka-exporter series; deployments override any entry via
``queries``.  The HTTP transport is injectable (``fetch_fn``) so the sampler is
unit-testable offline and swappable for pooled clients.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Mapping, Optional

from cruise_control_tpu_torch.backend.base import RawMetric
from cruise_control_tpu_torch.monitor.processor import MetricsProcessor
from cruise_control_tpu_torch.monitor.samples import MetricSampler, SampleBatch

#: RawMetricType name -> PromQL (PrometheusMetricSampler's DEFAULT_QUERY_MAP).
DEFAULT_QUERIES: Dict[str, str] = {
    "ALL_TOPIC_BYTES_IN": "rate(kafka_server_BrokerTopicMetrics_BytesInPerSec[1m])",
    "ALL_TOPIC_BYTES_OUT": "rate(kafka_server_BrokerTopicMetrics_BytesOutPerSec[1m])",
    "BROKER_CPU_UTIL": "1 - avg by (instance) (rate(node_cpu_seconds_total{mode='idle'}[1m]))",
    "TOPIC_BYTES_IN": "sum by (instance, topic) (rate(kafka_server_BrokerTopicMetrics_BytesInPerSec{topic!=''}[1m]))",
    "TOPIC_BYTES_OUT": "sum by (instance, topic) (rate(kafka_server_BrokerTopicMetrics_BytesOutPerSec{topic!=''}[1m]))",
    "PARTITION_SIZE": "kafka_log_Log_Size",
}


class PrometheusSamplerError(Exception):
    pass


def _http_fetch(url: str, timeout_s: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


class PrometheusMetricSampler(MetricSampler):
    """query_range → RawMetrics → MetricsProcessor → samples."""

    def __init__(
        self,
        endpoint: str,
        broker_by_instance: Mapping[str, int],
        describe_topics: Callable[[], dict],
        queries: Optional[Mapping[str, str]] = None,
        step_s: int = 60,
        timeout_s: float = 30.0,
        fetch_fn: Callable[[str, float], dict] = _http_fetch,
    ) -> None:
        """``broker_by_instance`` maps the Prometheus ``instance`` label to broker
        ids (the reference resolves this from the instance's host:port)."""
        self.endpoint = endpoint.rstrip("/")
        self.broker_by_instance = dict(broker_by_instance)
        self.describe_topics = describe_topics
        self.queries = dict(queries or DEFAULT_QUERIES)
        self.step_s = step_s
        self.timeout_s = timeout_s
        self.fetch_fn = fetch_fn
        self.processor = MetricsProcessor()

    # -- PrometheusAdapter.queryMetric ---------------------------------------

    def _query_range(self, promql: str, from_ms: int, to_ms: int) -> List[dict]:
        qs = urllib.parse.urlencode(
            {
                "query": promql,
                "start": from_ms / 1000.0,
                "end": to_ms / 1000.0,
                "step": self.step_s,
            }
        )
        url = f"{self.endpoint}/api/v1/query_range?{qs}"
        body = self.fetch_fn(url, self.timeout_s)
        if body.get("status") != "success":
            raise PrometheusSamplerError(f"query failed: {body.get('error', body)}")
        return body.get("data", {}).get("result", [])

    def _to_raw(self, name: str, series: List[dict]) -> List[RawMetric]:
        scope = (
            "PARTITION" if name == "PARTITION_SIZE"
            else "TOPIC" if name.startswith("TOPIC_")
            else "BROKER"
        )
        out: List[RawMetric] = []
        for entry in series:
            labels = entry.get("metric", {})
            instance = labels.get("instance", "")
            broker = self.broker_by_instance.get(instance)
            if broker is None:
                continue  # unmapped exporter — skip, never fail the round
            for ts_s, value in entry.get("values", []):
                try:
                    v = float(value)
                except (TypeError, ValueError):
                    continue
                out.append(
                    RawMetric(
                        name=name,
                        scope=scope,
                        broker_id=broker,
                        value=v,
                        ts_ms=int(float(ts_s) * 1000),
                        topic=labels.get("topic"),
                        partition=(
                            int(labels["partition"]) if "partition" in labels else None
                        ),
                    )
                )
        return out

    def get_samples(self, from_ms: int, to_ms: int) -> SampleBatch:
        raw: List[RawMetric] = []
        for name, promql in self.queries.items():
            raw.extend(self._to_raw(name, self._query_range(promql, from_ms, to_ms)))
        return self.processor.process(raw, self.describe_topics())
