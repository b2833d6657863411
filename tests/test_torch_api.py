"""The port's REST layer: the JAX package's API test classes, run unchanged.

``tests/test_api.py``'s four classes (two-step verification, basic auth, the
anomaly queue's wait, the OpenAPI drift check against ``docs/openapi.yaml``)
and the JWT and trusted-proxy providers of ``tests/test_aux_subsystems.py``
run against the port through ``port_test_module``, every app and facade they
build bound to ``device="cpu"`` explicitly.
"""

from tests.torch_port_helpers import port_test_module

_API = port_test_module("test_api", device="cpu")
TestTwoStepVerification = _API.TestTwoStepVerification
TestBasicAuth = _API.TestBasicAuth
TestAnomalyQueueWait = _API.TestAnomalyQueueWait
TestOpenApiDrift = _API.TestOpenApiDrift

_AUX = port_test_module("test_aux_subsystems", device="cpu")
TestJwtProvider = _AUX.TestJwtProvider
TestTrustedProxyProvider = _AUX.TestTrustedProxyProvider


def test_the_probe_raises_naming_the_device_when_its_child_finds_none(monkeypatch):
    """The probe runs in a child process: with no card there, the child's
    failure is raised here, naming the device; nothing falls back to the CPU."""
    import pytest
    import torch

    from cruise_control_tpu_torch.core import backend_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match=r"cuda:0 failed its probe.*is_available\(\) is false"):
        backend_probe.probe_device()


def test_the_entry_point_refuses_to_serve_without_a_gpu(tmp_path):
    """``python -m cruise_control_tpu_torch`` with no visible GPU exits non-zero
    with an error that names the device; it never serves on the CPU."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "cruise_control_tpu_torch", "--config",
         os.path.join(root, "config", "cruisecontrol.properties")],
        cwd=root, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "the CUDA device cuda:0 is not available" in proc.stderr
    assert "serving on" not in proc.stdout
