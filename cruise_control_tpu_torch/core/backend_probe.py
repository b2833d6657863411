"""Device guard shared by the process entry points.

Port of ``cruise_control_tpu/core/backend_probe.py``.  The JAX probe runs
``jax.devices()`` in a killable subprocess and forces the CPU platform when the
accelerator does not answer.  This one probes the CUDA device the same way,
in a subprocess with a timeout (``torch.cuda.is_available()``, the device's
name, and one tiny launch, synchronised), so a wedged driver cannot hang the
serving process.  It never falls back: a device that does not answer raises,
naming the device it tried.  Only a caller that asks for ``cpu`` gets the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict

import torch

from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device

#: seconds to wait for the probe child (importing torch and one launch take a
#: few seconds on a healthy card; override with CC_TPU_PROBE_TIMEOUT_S)
BACKEND_PROBE_TIMEOUT_S = float(os.environ.get("CC_TPU_PROBE_TIMEOUT_S", 120))

_PROBE = (
    "import sys, torch\n"
    "if not torch.cuda.is_available():\n"
    "    sys.exit('torch.cuda.is_available() is false')\n"
    "d = torch.device(sys.argv[1])\n"
    "x = torch.arange(8, device=d, dtype=torch.float32)\n"
    "s = float((x * 2).sum())\n"
    "torch.cuda.synchronize(d)\n"
    "if s != 56.0:\n"
    "    sys.exit(f'the probe launch returned {s}, not 56.0')\n"
    "print(torch.cuda.get_device_name(d))\n"
)


def probe_device(device: DeviceLike = None, timeout_s: float = BACKEND_PROBE_TIMEOUT_S) -> str:
    """The name of the card ``device`` resolves to (``cuda`` unless told
    otherwise), or ``"cpu"`` when the caller asked for the CPU.

    Raises :class:`RuntimeError` naming the device when there is no GPU, or
    when the probe child fails, times out or its launch gives a wrong sum."""
    dev = torch.device("cuda" if device is None else device)
    name = str(dev) if dev.type != "cuda" or dev.index is not None else "cuda:0"
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the CUDA device {name} is not available (torch.cuda.is_available() is false); "
            "pass device='cpu' (--device cpu) to run on the CPU explicitly"
        )
    if resolve_device(dev).type == "cpu":
        return "cpu"
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE, name],
            timeout=timeout_s, capture_output=True, text=True,
        )
    except subprocess.TimeoutExpired:
        raise RuntimeError(
            f"the CUDA device {name} did not answer the probe within {timeout_s:g} s"
        ) from None
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(
            f"the CUDA device {name} failed its probe (rc={proc.returncode}): "
            f"{(proc.stderr or proc.stdout).strip()[-2000:]}"
        )
    return lines[-1].strip()


_RESOLVED: Dict[str, str] = {}


def ensure_live_backend(device: DeviceLike = None, timeout_s: float = BACKEND_PROBE_TIMEOUT_S) -> str:
    """:func:`probe_device`, once a process for each device (entry points may
    call it repeatedly).  Raises where the probe raises; never carries on on
    the CPU unless ``device="cpu"``."""
    key = str(torch.device("cuda" if device is None else device))
    if key not in _RESOLVED:
        _RESOLVED[key] = probe_device(device, timeout_s)
    return _RESOLVED[key]
