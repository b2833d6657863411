"""Additional security providers: JWT bearer tokens, trusted proxies, SPNEGO.

Port of ``cruise_control_tpu/api/security_providers.py`` (pure Python, copied whole; ``gssapi`` stays a lazy import that fails closed).

Counterparts of the reference's pluggable security stacks
(``servlet/security/jwt/`` — JwtLoginService/JwtAuthenticator,
``servlet/security/trustedproxy/`` — TrustedProxyLoginService, and
``servlet/security/spnego/`` — SpnegoSecurityProvider).

* :class:`JwtSecurityProvider` verifies ``Authorization: Bearer <jwt>`` tokens
  signed with HS256 (stdlib hmac), checks ``exp`` and optional ``aud``, and maps
  a claim (default ``"role"``) onto the ADMIN/USER/VIEWER model.
* :class:`TrustedProxySecurityProvider` authenticates a fronting proxy by a
  shared secret header, then trusts the end-user identity the proxy forwards
  (``doAs`` semantics), with a per-user role table.
* :class:`SpnegoSecurityProvider` implements the HTTP ``Negotiate`` flow; the
  GSSAPI token validation itself is delegated to python-gssapi when installed
  (Kerberos is an OS/keytab integration, not something to hand-roll), with the
  same principal→role mapping the reference applies
  (``DefaultRoleSecurityProvider`` semantics, principal shortnames).
"""

from __future__ import annotations

import base64
import hmac
import hashlib
import json
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

from cruise_control_tpu_torch.api.security import AuthenticationError, Role, SecurityProvider


def _b64url_decode(segment: str) -> bytes:
    pad = "=" * (-len(segment) % 4)
    return base64.urlsafe_b64decode(segment + pad)


def _b64url_encode(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


def encode_jwt(claims: Mapping[str, object], secret: str) -> str:
    """Mint an HS256 JWT (test/tooling helper; the provider only verifies)."""
    header = _b64url_encode(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url_encode(json.dumps(dict(claims)).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url_encode(sig)}"


class JwtSecurityProvider(SecurityProvider):
    """``Authorization: Bearer`` HS256 validation (servlet/security/jwt/)."""

    challenge_header = ("WWW-Authenticate", "Bearer")

    @classmethod
    def from_config(cls, cfg) -> "JwtSecurityProvider":
        secret = cfg.get("webserver.security.jwt.secret")
        if not secret:
            from cruise_control_tpu_torch.core.config import ConfigException

            raise ConfigException(
                "JwtSecurityProvider requires webserver.security.jwt.secret"
            )
        return cls(secret)

    def __init__(
        self,
        secret: str,
        expected_audiences: Optional[Sequence[str]] = None,
        role_claim: str = "role",
        subject_claim: str = "sub",
        now: Optional[callable] = None,
    ) -> None:
        self.secret = secret
        self.expected_audiences = set(expected_audiences or [])
        self.role_claim = role_claim
        self.subject_claim = subject_claim
        self._now = now or time.time

    def authenticate(self, headers: Mapping[str, str]) -> Tuple[Optional[str], Role]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            raise AuthenticationError("missing bearer token")
        token = auth[7:].strip()
        parts = token.split(".")
        if len(parts) != 3:
            raise AuthenticationError("malformed token")
        header_s, payload_s, sig_s = parts
        try:
            header = json.loads(_b64url_decode(header_s))
            payload = json.loads(_b64url_decode(payload_s))
            signature = _b64url_decode(sig_s)
        except Exception as e:
            raise AuthenticationError("undecodable token") from e
        if header.get("alg") != "HS256":
            raise AuthenticationError(f"unsupported alg {header.get('alg')!r}")
        signing_input = f"{header_s}.{payload_s}".encode()
        expected = hmac.new(self.secret.encode(), signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, signature):
            raise AuthenticationError("bad signature")
        exp = payload.get("exp")
        if exp is not None and float(exp) < self._now():
            raise AuthenticationError("token expired")
        if self.expected_audiences:
            aud = payload.get("aud")
            auds = set(aud) if isinstance(aud, list) else {aud}
            if not (auds & self.expected_audiences):
                raise AuthenticationError("audience mismatch")
        user = payload.get(self.subject_claim)
        role_name = str(payload.get(self.role_claim, "USER")).upper()
        try:
            role = Role[role_name]
        except KeyError:
            raise AuthenticationError(f"unknown role {role_name!r}") from None
        return user, role


class TrustedProxySecurityProvider(SecurityProvider):
    """Authenticate the proxy, trust its forwarded end-user identity
    (servlet/security/trustedproxy/ semantics with a shared-secret handshake)."""

    @classmethod
    def from_config(cls, cfg) -> "TrustedProxySecurityProvider":
        secret = cfg.get("webserver.security.trusted.proxy.secret")
        if not secret:
            from cruise_control_tpu_torch.core.config import ConfigException

            raise ConfigException(
                "TrustedProxySecurityProvider requires "
                "webserver.security.trusted.proxy.secret"
            )
        return cls(secret)

    def __init__(
        self,
        proxy_secret: str,
        user_roles: Optional[Dict[str, Role]] = None,
        default_role: Role = Role.USER,
        secret_header: str = "X-Proxy-Secret",
        user_header: str = "X-Forwarded-User",
    ) -> None:
        self.proxy_secret = proxy_secret
        self.user_roles = user_roles or {}
        self.default_role = default_role
        self.secret_header = secret_header
        self.user_header = user_header

    def authenticate(self, headers: Mapping[str, str]) -> Tuple[Optional[str], Role]:
        supplied = headers.get(self.secret_header, "")
        if not hmac.compare_digest(self.proxy_secret.encode(), supplied.encode()):
            raise AuthenticationError("untrusted proxy")
        user = headers.get(self.user_header)
        if not user:
            raise AuthenticationError("proxy forwarded no user")
        return user, self.user_roles.get(user, self.default_role)


class SpnegoSecurityProvider(SecurityProvider):
    """HTTP Negotiate (SPNEGO/Kerberos) authentication.

    Counterpart of ``servlet/security/spnego/SpnegoSecurityProvider.java``:
    the client sends ``Authorization: Negotiate <base64 GSS token>``; the
    service accepts it against its keytab credential and derives the user from
    the initiator principal's shortname (``user@REALM`` / ``user/host@REALM``
    → ``user``), which maps onto ADMIN/USER/VIEWER like every other provider.

    Token acceptance is delegated to python-gssapi (an MIT/Heimdal binding —
    Kerberos is OS integration, not something to reimplement).  When gssapi is
    not installed the provider still speaks the protocol (401 +
    ``WWW-Authenticate: Negotiate`` challenge) but rejects all tokens, so a
    misconfigured deployment fails closed, never open.
    """

    challenge_header = ("WWW-Authenticate", "Negotiate")

    def __init__(
        self,
        service_principal: Optional[str] = None,
        user_roles: Optional[Dict[str, Role]] = None,
        default_role: Role = Role.USER,
    ) -> None:
        self.service_principal = service_principal
        self.user_roles = user_roles or {}
        self.default_role = default_role
        try:
            import gssapi  # type: ignore

            self._gssapi = gssapi
        except ImportError:
            self._gssapi = None

    @staticmethod
    def principal_shortname(principal: str) -> str:
        """``user/host@REALM`` → ``user`` (the reference's PrincipalName
        shortname rule used for role lookup)."""
        return principal.split("@", 1)[0].split("/", 1)[0]

    @classmethod
    def from_config(cls, cfg) -> "SpnegoSecurityProvider":
        return cls(service_principal=cfg.get("webserver.security.spnego.principal") or None)

    def _accept_token(self, token: bytes) -> str:
        """Validate the GSS token, returning the initiator principal."""
        if self._gssapi is None:
            raise AuthenticationError(
                "SPNEGO configured but python-gssapi is not installed"
            )
        gssapi = self._gssapi
        # every GSS failure (garbage token, missing/expired keytab, clock
        # skew) must surface as a 401, never a crashed request handler
        try:
            creds = None
            if self.service_principal:
                name = gssapi.Name(
                    self.service_principal,
                    name_type=gssapi.NameType.kerberos_principal,
                )
                creds = gssapi.Credentials(name=name, usage="accept")
            ctx = gssapi.SecurityContext(creds=creds, usage="accept")
            ctx.step(token)
            if not ctx.complete:
                raise AuthenticationError("SPNEGO negotiation incomplete")
            return str(ctx.initiator_name)
        except AuthenticationError:
            raise
        except Exception as e:
            raise AuthenticationError(f"SPNEGO rejected: {e}") from e

    def authenticate(self, headers: Mapping[str, str]) -> Tuple[Optional[str], Role]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Negotiate "):
            raise AuthenticationError("missing Negotiate token")
        try:
            token = base64.b64decode(auth[len("Negotiate "):].strip())
        except Exception:
            raise AuthenticationError("malformed Negotiate token") from None
        principal = self._accept_token(token)
        user = self.principal_shortname(principal)
        return user, self.user_roles.get(user, self.default_role)
