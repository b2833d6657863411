"""Container (cgroup) CPU awareness.

Port of ``cruise_control_tpu/monitor/container.py`` (pure Python, copied whole; the cgroup files are read from the paths the caller passes).

Counterpart of ``cruise-control-metrics-reporter``'s ``ContainerMetricUtils``:
a broker reporting raw ``BROKER_CPU_UTIL`` as a fraction of the *host's* cores
under-reports when the process is CPU-quota'd by a cgroup.  These helpers read
the effective CPU limit from cgroup v2 (``cpu.max``) or v1
(``cpu.cfs_quota_us`` / ``cpu.cfs_period_us``) and rescale utilization to the
container's allowance.
"""

from __future__ import annotations

import os
from typing import Optional

CGROUP_V2_CPU_MAX = "/sys/fs/cgroup/cpu.max"
CGROUP_V1_QUOTA = "/sys/fs/cgroup/cpu/cpu.cfs_quota_us"
CGROUP_V1_PERIOD = "/sys/fs/cgroup/cpu/cpu.cfs_period_us"


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as fh:
            return fh.read().strip()
    except OSError:
        return None


def container_cpu_limit_cores(
    v2_path: str = CGROUP_V2_CPU_MAX,
    v1_quota_path: str = CGROUP_V1_QUOTA,
    v1_period_path: str = CGROUP_V1_PERIOD,
) -> Optional[float]:
    """Effective CPU allowance in cores, or None when unlimited / not in a cgroup.

    cgroup v2: ``cpu.max`` = "<quota_us|max> <period_us>";
    cgroup v1: quota/period files, quota −1 ⇒ unlimited.
    """
    v2 = _read(v2_path)
    if v2:
        parts = v2.split()
        if parts and parts[0] != "max":
            try:
                quota = float(parts[0])
                period = float(parts[1]) if len(parts) > 1 else 100_000.0
                if quota > 0 and period > 0:
                    return quota / period
            except ValueError:
                pass
        if parts and parts[0] == "max":
            return None
    q, p = _read(v1_quota_path), _read(v1_period_path)
    if q is not None and p is not None:
        try:
            quota, period = float(q), float(p)
            if quota > 0 and period > 0:
                return quota / period
        except ValueError:
            pass
    return None


def effective_cores(host_cores: Optional[int] = None, **paths) -> float:
    """min(host cores, container allowance) — the denominator CPU utilization
    should be computed against (ContainerMetricUtils.getContainerProcessCpuLoad)."""
    host = float(host_cores if host_cores is not None else (os.cpu_count() or 1))
    limit = container_cpu_limit_cores(**paths)
    return min(host, limit) if limit is not None else host


def adjust_cpu_util(host_cpu_util: float, host_cores: Optional[int] = None, **paths) -> float:
    """Rescale a host-fraction CPU utilization to the container's allowance.

    A process pinned to quota=2 cores on a 16-core host showing 0.1 host
    utilization is actually at 0.8 of its allowance.  Values clamp to [0, 1].
    """
    host = float(host_cores if host_cores is not None else (os.cpu_count() or 1))
    eff = effective_cores(host_cores=host_cores, **paths)
    if eff <= 0:
        return host_cpu_util
    return max(0.0, min(1.0, host_cpu_util * host / eff))
