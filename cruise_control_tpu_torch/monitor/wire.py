"""Raw-metric wire format: versioned binary serde for metric transport.

Port of ``cruise_control_tpu/monitor/wire.py`` (pure Python, copied whole): the bytes are the JAX package's for the same ``RawMetric`` records, so either package's reporter feeds the other's sampler.

Counterpart of the reference's ``MetricSerde`` + per-class serialization in
``cruise-control-metrics-reporter`` (``BrokerMetric``/``TopicMetric``/
``PartitionMetric`` with a wire-format version header per ``RawMetricType``
scope, RawMetricType.java:27): the broker-side reporter serializes metrics into
the transport topic; samplers deserialize batches back.

Binary layout (little-endian), one record:

    u16 record length         (bytes after this field — lets readers SKIP
                               records of any future layout safely)
    u8  record version        (RECORD_VERSION)
    u8  scope                 (0=BROKER, 1=TOPIC, 2=PARTITION)
    u16 metric id             (taxonomy id, core.metricdef.RawMetricType)
    i32 broker id
    i64 timestamp ms
    f64 value
    u16 topic length | 0      (TOPIC/PARTITION scopes)
    ..  topic utf-8 bytes
    i32 partition             (PARTITION scope only)

A batch is ``u32 count`` followed by records.  Forward compatibility: records
with a newer version or an unknown metric id are skipped by LENGTH — a v2
layout change can never desync a v1 reader's offsets (the same guarantee the
reference's versioned wire format gives mixed-version fleets).
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Tuple

from cruise_control_tpu_torch.backend.base import RawMetric
from cruise_control_tpu_torch.core.metricdef import RawMetricType

RECORD_VERSION = 1

_SCOPES = ("BROKER", "TOPIC", "PARTITION")
_SCOPE_ID = {s: i for i, s in enumerate(_SCOPES)}

_HEAD = struct.Struct("<BBHiqd")   # version, scope, metric id, broker, ts, value
_U16 = struct.Struct("<H")
_I32 = struct.Struct("<i")
_U32 = struct.Struct("<I")


class WireFormatError(Exception):
    """Malformed or incompatible serialized metrics."""


def _ids() -> Tuple[dict, dict]:
    by_name = {t.name: t.value[0] for t in RawMetricType}
    by_id = {i: name for name, i in by_name.items()}
    return by_name, by_id


def serialize(metrics: Iterable[RawMetric]) -> bytes:
    """One batch of raw metrics → bytes (reporter side, MetricSerde.toBytes)."""
    by_name, _ = _ids()
    records: List[bytes] = []
    for m in metrics:
        if m.scope not in _SCOPE_ID:
            raise WireFormatError(f"unknown scope {m.scope!r}")
        if m.name not in by_name:
            raise WireFormatError(f"unknown metric name {m.name!r}")
        parts = [
            _HEAD.pack(
                RECORD_VERSION, _SCOPE_ID[m.scope], by_name[m.name],
                m.broker_id, m.ts_ms, m.value,
            )
        ]
        if m.scope in ("TOPIC", "PARTITION"):
            topic = (m.topic or "").encode()
            parts.append(_U16.pack(len(topic)))
            parts.append(topic)
        if m.scope == "PARTITION":
            parts.append(_I32.pack(m.partition if m.partition is not None else -1))
        body = b"".join(parts)
        records.append(_U16.pack(len(body)) + body)
    return _U32.pack(len(records)) + b"".join(records)


def deserialize(payload: bytes) -> List[RawMetric]:
    """Bytes → raw metrics (sampler side, MetricSerde.fromBytes).

    Records with a newer major version or an unknown metric id are skipped —
    never fatal — so mixed-version fleets keep reporting.
    """
    _, by_id = _ids()
    if len(payload) < _U32.size:
        raise WireFormatError("truncated batch header")
    (count,) = _U32.unpack_from(payload, 0)
    off = _U32.size
    out: List[RawMetric] = []
    for _ in range(count):
        if off + _U16.size > len(payload):
            raise WireFormatError("truncated record length")
        (rlen,) = _U16.unpack_from(payload, off)
        off += _U16.size
        if off + rlen > len(payload):
            raise WireFormatError("truncated record")
        record = payload[off:off + rlen]
        off += rlen   # length-prefixed: offsets stay in sync for ANY version

        if len(record) < 1:
            raise WireFormatError("empty record")
        version = record[0]
        if version > RECORD_VERSION:
            continue  # future layout — skipped whole by length
        if len(record) < _HEAD.size:
            raise WireFormatError("truncated record header")
        version, scope_id, metric_id, broker, ts, value = _HEAD.unpack_from(record, 0)
        pos = _HEAD.size
        topic = None
        partition = None
        if scope_id >= len(_SCOPES):
            raise WireFormatError(f"unknown scope id {scope_id}")
        scope = _SCOPES[scope_id]
        if scope in ("TOPIC", "PARTITION"):
            if pos + _U16.size > len(record):
                raise WireFormatError("truncated topic length")
            (tlen,) = _U16.unpack_from(record, pos)
            pos += _U16.size
            if pos + tlen > len(record):
                raise WireFormatError("truncated topic")
            topic = record[pos:pos + tlen].decode()
            pos += tlen
        if scope == "PARTITION":
            if pos + _I32.size > len(record):
                raise WireFormatError("truncated partition")
            (partition,) = _I32.unpack_from(record, pos)
            pos += _I32.size
        if metric_id not in by_id:
            continue  # forward compatibility: unknown taxonomy entry
        out.append(
            RawMetric(
                name=by_id[metric_id], scope=scope, broker_id=broker,
                value=value, ts_ms=ts, topic=topic, partition=partition,
            )
        )
    return out
