"""HS256 JWT access tokens with video grants.

Reference parity: livekit/protocol auth package (AccessToken / VideoGrant /
ClaimGrants) used by the reference everywhere a request is authenticated:
pkg/service/auth.go:45-188 (HTTP middleware), rtcservice.go:106-194 (join
validation), roommanager.go:832-854 (refreshToken), turn.go long-term
credentials. Implemented on stdlib hmac/hashlib — same wire format as any
RFC 7519 HS256 JWT, no external jwt dependency.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field


class TokenError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


@dataclass
class VideoGrant:
    """The `video` claim (livekit/protocol auth/grants.go)."""

    room_create: bool = False
    room_join: bool = False
    room_list: bool = False
    room_record: bool = False
    room_admin: bool = False
    room: str = ""
    can_publish: bool | None = None
    can_subscribe: bool | None = None
    can_publish_data: bool | None = None
    can_publish_sources: list[str] = field(default_factory=list)
    can_update_own_metadata: bool | None = None
    hidden: bool = False
    recorder: bool = False
    agent: bool = False
    ingress_admin: bool = False

    def to_claim(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None or v == "" or v == []:
                continue
            # Plain bool flags omit False; tri-state (None-default) fields
            # keep an explicit False — it means "deny", not "unset".
            if v is False and f.default is False:
                continue
            # proto JSON style: camelCase keys
            parts = f.name.split("_")
            d[parts[0] + "".join(p.title() for p in parts[1:])] = v
        return d

    @classmethod
    def from_claim(cls, d: dict) -> "VideoGrant":
        kw = {}
        for f in dataclasses.fields(cls):
            parts = f.name.split("_")
            camel = parts[0] + "".join(p.title() for p in parts[1:])
            if camel in d:
                kw[f.name] = d[camel]
        return cls(**kw)


@dataclass
class ClaimGrants:
    """Decoded token claims (auth/grants.go ClaimGrants)."""

    identity: str = ""
    name: str = ""
    video: VideoGrant = field(default_factory=VideoGrant)
    metadata: str = ""
    attributes: dict[str, str] = field(default_factory=dict)
    sha256: str = ""  # request-body integrity (webhooks)
    kind: str = ""    # standard | ingress | egress | sip | agent


def ensure_admin_permission(claims: ClaimGrants, room: str) -> bool:
    """Room-scoped admin (pkg/service/auth.go:133 EnsureAdminPermission):
    requires roomAdmin AND the token's room claim to name the target room.
    A bare roomAdmin token with no room claim administrates nothing."""
    return bool(claims.video.room_admin and room and room == claims.video.room)


def ensure_create_permission(claims: ClaimGrants) -> bool:
    """auth.go:146 EnsureCreatePermission — roomCreate grant."""
    return bool(claims.video.room_create)


def ensure_list_permission(claims: ClaimGrants) -> bool:
    """auth.go:154 EnsureListPermission — roomList grant."""
    return bool(claims.video.room_list)


def ensure_record_permission(claims: ClaimGrants) -> bool:
    """auth.go:162 EnsureRecordPermission — roomRecord grant (egress)."""
    return bool(claims.video.room_record)


def ensure_ingress_admin_permission(claims: ClaimGrants) -> bool:
    """auth.go:170 EnsureIngressAdminPermission — ingressAdmin grant."""
    return bool(claims.video.ingress_admin)


class AccessToken:
    """Mint HS256 JWTs (auth/access_token.go)."""

    def __init__(self, api_key: str, api_secret: str):
        self.api_key = api_key
        self.api_secret = api_secret
        self.identity = ""
        self.name = ""
        self.metadata = ""
        self.attributes: dict[str, str] = {}
        self.kind = ""
        self.grant = VideoGrant()
        self.sha256 = ""  # body-integrity claim (webhook signing)
        self.ttl = 6 * 3600  # auth defaultValidDuration

    def to_jwt(self, now: int | None = None) -> str:
        now = int(time.time()) if now is None else now
        header = {"alg": "HS256", "typ": "JWT"}
        payload: dict = {
            "iss": self.api_key,
            "nbf": now - 10,
            "exp": now + self.ttl,
            "video": self.grant.to_claim(),
        }
        if self.identity:
            payload["sub"] = self.identity
            payload["jti"] = self.identity
        elif self.grant.room_join:
            raise TokenError("identity is required for room join tokens")
        if self.name:
            payload["name"] = self.name
        if self.metadata:
            payload["metadata"] = self.metadata
        if self.attributes:
            payload["attributes"] = self.attributes
        if self.kind:
            payload["kind"] = self.kind
        if self.sha256:
            payload["sha256"] = self.sha256
        signing = _b64url(json.dumps(header, separators=(",", ":")).encode()) + "." + _b64url(
            json.dumps(payload, separators=(",", ":")).encode()
        )
        sig = hmac.new(self.api_secret.encode(), signing.encode(), hashlib.sha256).digest()
        return signing + "." + _b64url(sig)


def verify_token(token: str, key_provider, now: int | None = None) -> ClaimGrants:
    """Decode + verify an HS256 token.

    `key_provider`: mapping api_key -> api_secret (the config `keys` map,
    reference pkg/config/config.go Keys / auth.go UserVerifier).
    """
    now = int(time.time()) if now is None else now
    parts = token.split(".")
    if len(parts) != 3:
        raise TokenError("malformed token")
    try:
        header = json.loads(_unb64url(parts[0]))
        payload = json.loads(_unb64url(parts[1]))
        sig = _unb64url(parts[2])
    except Exception as e:  # noqa: BLE001 — any decode failure is the same error class
        raise TokenError(f"undecodable token: {e}") from e
    if header.get("alg") != "HS256":
        raise TokenError(f"unsupported alg: {header.get('alg')}")
    api_key = payload.get("iss", "")
    secret = key_provider.get(api_key) if hasattr(key_provider, "get") else None
    if not secret:
        raise TokenError("unknown API key")
    expect = hmac.new(secret.encode(), f"{parts[0]}.{parts[1]}".encode(), hashlib.sha256).digest()
    if not hmac.compare_digest(sig, expect):
        raise TokenError("invalid signature")
    if payload.get("exp", 0) < now:
        raise TokenError("token expired")
    if payload.get("nbf", 0) > now + 10:
        raise TokenError("token not yet valid")
    return ClaimGrants(
        identity=payload.get("sub", ""),
        name=payload.get("name", ""),
        video=VideoGrant.from_claim(payload.get("video", {})),
        metadata=payload.get("metadata", ""),
        attributes=payload.get("attributes", {}),
        sha256=payload.get("sha256", ""),
        kind=payload.get("kind", ""),
    )
