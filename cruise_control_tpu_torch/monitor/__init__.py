"""Monitor layer: sampling, aggregation, and cluster-model construction.

Port of ``cruise_control_tpu/monitor`` (the counterpart of the reference's
``monitor/``).  The model is built on the host in numpy; only
``ClusterModel.to_arrays(device=)`` moves it to the device.  The ingest
route of a deployment -- a reporter in each broker (``reporter``), the
versioned wire format (``wire``), a transport and a pool of fetchers
(``fetcher``) -- and the Prometheus sampler (``prometheus``) and the cgroup
CPU helpers (``container``) run on the host too; import them from their
modules, as in the JAX package.
"""

from cruise_control_tpu_torch.monitor.capacity import (
    BrokerCapacityInfo,
    BrokerCapacityResolver,
    FileCapacityResolver,
    StaticCapacityResolver,
)
from cruise_control_tpu_torch.monitor.completeness import (
    ModelCompletenessRequirements,
    NotEnoughValidSnapshotsError,
)
from cruise_control_tpu_torch.monitor.loadmonitor import LoadMonitor, LoadMonitorState, MonitorState
from cruise_control_tpu_torch.monitor.processor import MetricsProcessor
from cruise_control_tpu_torch.monitor.samples import (
    BackendMetricSampler,
    BrokerMetricSample,
    MetricSampler,
    NoopSampler,
    PartitionMetricSample,
    SampleBatch,
)
from cruise_control_tpu_torch.monitor.samplestore import (
    FileSampleStore,
    NoopSampleStore,
    SampleStore,
)

__all__ = [
    "BackendMetricSampler",
    "BrokerCapacityInfo",
    "BrokerCapacityResolver",
    "BrokerMetricSample",
    "FileCapacityResolver",
    "FileSampleStore",
    "LoadMonitor",
    "LoadMonitorState",
    "MetricSampler",
    "MetricsProcessor",
    "ModelCompletenessRequirements",
    "MonitorState",
    "NoopSampleStore",
    "NoopSampler",
    "NotEnoughValidSnapshotsError",
    "PartitionMetricSample",
    "SampleBatch",
    "SampleStore",
    "StaticCapacityResolver",
]
