"""The port's app shell and Python client over real HTTP: the JAX package's
``tests/test_app_client.py`` classes, run unchanged against the port
(``port_test_module``, the app bound to ``device="cpu"`` explicitly).
``test_rebalance_round_trip`` stays ``slow``, as in the JAX file.
"""

from tests.torch_port_helpers import port_test_module

_PORTED = port_test_module("test_app_client", device="cpu")
served_app = _PORTED.served_app
client = _PORTED.client
TestConfig = _PORTED.TestConfig
TestClientRoundTrip = _PORTED.TestClientRoundTrip
TestProposalRefresher = _PORTED.TestProposalRefresher
TestResponseSchemas = _PORTED.TestResponseSchemas
