"""Security provider SPI and the role model.

Port of ``cruise_control_tpu/api/security.py`` (pure Python, copied whole).

Counterpart of ``servlet/security/`` — pluggable ``SecurityProvider`` with the
ADMIN/USER/VIEWER role model (DefaultRoleSecurityProvider, UserPermissionsManager):

* VIEWER — read-only endpoints;
* USER   — VIEWER + endpoints that reveal detailed cluster internals;
* ADMIN  — everything, including state-changing POSTs.

Shipped providers: :class:`NoSecurityProvider` (everyone ADMIN, the default like the
reference with security disabled) and :class:`BasicSecurityProvider` (HTTP Basic
against a user→(password, role) table, the ``BasicSecurityProvider`` analogue; the
SPNEGO/JWT/trusted-proxy variants plug in behind the same interface).
"""

from __future__ import annotations

import base64
import enum
import hmac
from typing import Dict, Mapping, Optional, Tuple


class Role(enum.IntEnum):
    VIEWER = 0
    USER = 1
    ADMIN = 2


#: Minimum role per endpoint (UserPermissionsManager's mapping).  METRICS is
#: VIEWER-tier: a Prometheus scrape target carries aggregate operational
#: numbers only (the JMX-exporter posture of the reference deployment).
VIEWER_ENDPOINTS = {
    "STATE", "LOAD", "PARTITION_LOAD", "PROPOSALS", "KAFKA_CLUSTER_STATE",
    "METRICS",
}
#: CONTROLLER status (GET) is USER-tier operational data; the POST switch
#: stays ADMIN through the method rule below
USER_ENDPOINTS = VIEWER_ENDPOINTS | {
    "USER_TASKS", "REVIEW_BOARD", "PERMISSIONS", "CONTROLLER",
}


def required_role(endpoint: str, method: str) -> Role:
    if method == "POST":
        return Role.ADMIN
    if endpoint in VIEWER_ENDPOINTS:
        return Role.VIEWER
    if endpoint in USER_ENDPOINTS:
        return Role.USER
    return Role.ADMIN


class SecurityProvider:
    """Resolve a request's (user, role); None user means anonymous."""

    #: optional (header, value) the server sends with a 401 so conforming
    #: clients know which scheme to retry with (WWW-Authenticate)
    challenge_header: Optional[Tuple[str, str]] = None

    def authenticate(self, headers: Mapping[str, str]) -> Tuple[Optional[str], Role]:
        raise NotImplementedError

    def authorize(self, role: Role, endpoint: str, method: str) -> bool:
        return role >= required_role(endpoint, method)


class NoSecurityProvider(SecurityProvider):
    def authenticate(self, headers) -> Tuple[Optional[str], Role]:
        return None, Role.ADMIN


class AuthenticationError(Exception):
    pass


class BasicSecurityProvider(SecurityProvider):
    challenge_header = ("WWW-Authenticate", 'Basic realm="cruise-control-tpu"')

    def __init__(self, users: Dict[str, Tuple[str, Role]]) -> None:
        """``users``: name -> (password, role)."""
        self.users = users

    def authenticate(self, headers) -> Tuple[Optional[str], Role]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            raise AuthenticationError("missing credentials")
        try:
            decoded = base64.b64decode(auth[6:]).decode()
            user, _, password = decoded.partition(":")
        except Exception as e:
            raise AuthenticationError("malformed credentials") from e
        entry = self.users.get(user)
        # constant-time comparison; compare against a dummy when the user is
        # unknown so lookup failures are not timing-distinguishable
        expected = entry[0] if entry is not None else ""
        ok = hmac.compare_digest(expected.encode(), password.encode())
        if entry is None or not ok:
            raise AuthenticationError("bad credentials")
        return user, entry[1]
