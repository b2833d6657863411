"""Broker capacity resolution.

Port of ``cruise_control_tpu/monitor/capacity.py``.

Counterpart of the ``BrokerCapacityConfigResolver`` SPI and
``BrokerCapacityConfigFileResolver`` (config layer, SURVEY §2.3), which reads
``config/capacity.json`` / ``capacityJBOD.json``: per-broker DISK (MB), CPU (%),
NW_IN/NW_OUT (KB/s), with broker id -1 as the default entry and optional per-logdir
disk capacities for JBOD.
"""

from __future__ import annotations

import abc
import dataclasses
import json
from typing import Dict, Mapping, Optional

from cruise_control_tpu_torch.core.resources import Resource

DEFAULT_BROKER_ID = -1


@dataclasses.dataclass(frozen=True)
class BrokerCapacityInfo:
    capacity: Dict[Resource, float]
    disk_capacity_by_logdir: Optional[Dict[str, float]] = None
    num_cores: int = 1


class BrokerCapacityResolver(abc.ABC):
    @abc.abstractmethod
    def capacity_for(self, broker_id: int) -> BrokerCapacityInfo: ...


class StaticCapacityResolver(BrokerCapacityResolver):
    """All brokers share one capacity spec (tests / homogeneous clusters)."""

    def __init__(self, capacity: Mapping[Resource, float], num_cores: int = 1) -> None:
        self._info = BrokerCapacityInfo(dict(capacity), None, num_cores)

    def capacity_for(self, broker_id: int) -> BrokerCapacityInfo:
        return self._info


class FileCapacityResolver(BrokerCapacityResolver):
    """Reads the reference's capacity.json format:

    ``{"brokerCapacities": [{"brokerId": "-1", "capacity": {"DISK": "100000",
    "CPU": "100", "NW_IN": "10000", "NW_OUT": "10000"}}, ...]}``

    JBOD variant: DISK is an object ``{"/logdir": "cap", ...}``
    (capacityJBOD.json).  Broker id −1 supplies the default.
    """

    def __init__(self, path: str) -> None:
        with open(path) as fh:
            doc = json.load(fh)
        self._by_broker: Dict[int, BrokerCapacityInfo] = {}
        for entry in doc.get("brokerCapacities", []):
            broker_id = int(entry["brokerId"])
            cap = entry["capacity"]
            disk = cap.get("DISK", 0)
            logdirs = None
            if isinstance(disk, dict):
                logdirs = {path: float(v) for path, v in disk.items()}
                disk_total = sum(logdirs.values())
            else:
                disk_total = float(disk)
            self._by_broker[broker_id] = BrokerCapacityInfo(
                capacity={
                    Resource.CPU: float(cap.get("CPU", 0)),
                    Resource.NW_IN: float(cap.get("NW_IN", 0)),
                    Resource.NW_OUT: float(cap.get("NW_OUT", 0)),
                    Resource.DISK: disk_total,
                },
                disk_capacity_by_logdir=logdirs,
                num_cores=int(entry.get("doc", {}).get("numCores", 1))
                if isinstance(entry.get("doc"), dict)
                else int(entry.get("numCores", 1)),
            )
        if DEFAULT_BROKER_ID not in self._by_broker:
            raise ValueError("capacity file must define a default entry (brokerId -1)")

    def capacity_for(self, broker_id: int) -> BrokerCapacityInfo:
        return self._by_broker.get(broker_id, self._by_broker[DEFAULT_BROKER_ID])
