"""The port's SPNEGO provider and the security-provider wiring: the seven
tests of the JAX package's ``tests/test_spnego.py``, run unchanged against the
port (``port_test_module``; the app ``test_401_carries_challenge_header``
builds is bound to ``device="cpu"`` explicitly).  ``gssapi`` stays a lazy
import that fails closed.
"""

from tests.torch_port_helpers import port_test_module

_PORTED = port_test_module("test_spnego", device="cpu")
test_principal_shortname_rule = _PORTED.test_principal_shortname_rule
test_missing_negotiate_header_rejected = _PORTED.test_missing_negotiate_header_rejected
test_fails_closed_without_gssapi = _PORTED.test_fails_closed_without_gssapi
test_accepted_token_maps_principal_to_role = _PORTED.test_accepted_token_maps_principal_to_role
test_malformed_base64_rejected = _PORTED.test_malformed_base64_rejected
test_provider_class_config_wiring = _PORTED.test_provider_class_config_wiring
test_401_carries_challenge_header = _PORTED.test_401_carries_challenge_header
