"""The REST API: server, admission, user tasks, security, schemas, OpenAPI.

Port of ``cruise_control_tpu/api/``.  Host code throughout; every solve a
request starts runs on the facade's device.
"""
