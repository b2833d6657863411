"""The port's serving plane under overload: every class of the JAX package's
``tests/test_admission.py`` (token buckets, the breaker, the admission
controller, concurrent admission, readiness Retry-After, shedding over real
HTTP, overflow and readiness over HTTP, the backend blackout drill), run
unchanged against the port (``port_test_module``, every app bound to
``device="cpu"`` explicitly).  ``TestShedOverHTTP::
test_warm_optimize_budget_unchanged_with_admission`` is held to the JAX
test's own check, which the JAX package fails as well.
"""

from tests.torch_port_helpers import port_test_module

_PORTED = port_test_module("test_admission", device="cpu")
served_app = _PORTED.served_app
client = _PORTED.client
TestTokenBucket = _PORTED.TestTokenBucket
TestCircuitBreaker = _PORTED.TestCircuitBreaker
TestAdmissionController = _PORTED.TestAdmissionController
TestConcurrentAdmission = _PORTED.TestConcurrentAdmission
TestReadinessRetryAfter = _PORTED.TestReadinessRetryAfter
TestShedOverHTTP = _PORTED.TestShedOverHTTP
TestOverflowAndReadinessHTTP = _PORTED.TestOverflowAndReadinessHTTP
TestBackendBlackoutDrill = _PORTED.TestBackendBlackoutDrill
