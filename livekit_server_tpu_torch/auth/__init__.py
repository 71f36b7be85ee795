"""JWT authentication: access tokens and grants.

Reference parity: livekit/protocol auth (JWT HS256 access tokens carrying
`video` grants) as enforced by pkg/service/auth.go:45-188 (middleware →
ClaimGrants in context; permission guards EnsureJoinPermission /
EnsureAdminPermission / …) and minted by cmd create-join-token.
"""

from livekit_server_tpu_torch.auth.token import (
    AccessToken,
    ClaimGrants,
    TokenError,
    VideoGrant,
    ensure_admin_permission,
    ensure_create_permission,
    ensure_ingress_admin_permission,
    ensure_list_permission,
    ensure_record_permission,
    verify_token,
)

__all__ = [
    "AccessToken",
    "ClaimGrants",
    "TokenError",
    "VideoGrant",
    "ensure_admin_permission",
    "ensure_create_permission",
    "ensure_ingress_admin_permission",
    "ensure_list_permission",
    "ensure_record_permission",
    "verify_token",
]
