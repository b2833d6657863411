"""Python client for the cruise-control-tpu REST API.

Port of ``cruise_control_tpu/client`` (plain ``urllib``, copied whole).

Counterpart of the reference's ``cruise-control-client`` package
(``cruisecontrolclient/client/Endpoint.py``): a programmatic
:class:`CruiseControlClient` with one typed method per endpoint and transparent
202/User-Task-ID polling, plus the ``cctpu`` command-line front-end
(:mod:`cruise_control_tpu_torch.client.cli`).
"""

from cruise_control_tpu_torch.client.client import ClientError, CruiseControlClient

__all__ = ["ClientError", "CruiseControlClient"]
