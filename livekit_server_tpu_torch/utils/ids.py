"""Typed object IDs.

Reference parity: livekit/protocol utils guid.go (RM_/PA_/TR_ prefixed GUIDs
used throughout pkg/service and pkg/rtc). Same surface, new implementation.
"""

from __future__ import annotations

import secrets
import string

_ALPHABET = string.ascii_letters + string.digits
_ID_LEN = 12

ROOM_PREFIX = "RM_"
PARTICIPANT_PREFIX = "PA_"
TRACK_PREFIX = "TR_"
API_KEY_PREFIX = "API"
NODE_PREFIX = "ND_"
CONNECTION_PREFIX = "CO_"
EGRESS_PREFIX = "EG_"
INGRESS_PREFIX = "IN_"
SIP_TRUNK_PREFIX = "ST_"
SIP_DISPATCH_RULE_PREFIX = "SDR_"
SIP_CALL_PREFIX = "SCL_"
AGENT_JOB_PREFIX = "AJ_"
AGENT_WORKER_PREFIX = "AW_"


def _rand(n: int = _ID_LEN) -> str:
    return "".join(secrets.choice(_ALPHABET) for _ in range(n))


def new_guid(prefix: str) -> str:
    return prefix + _rand()


def new_room_id() -> str:
    return new_guid(ROOM_PREFIX)


def new_participant_id() -> str:
    return new_guid(PARTICIPANT_PREFIX)


def new_track_id() -> str:
    return new_guid(TRACK_PREFIX)


def new_node_id() -> str:
    return new_guid(NODE_PREFIX)


def new_connection_id() -> str:
    return new_guid(CONNECTION_PREFIX)


def new_api_key() -> str:
    return API_KEY_PREFIX + _rand(11)


def new_api_secret() -> str:
    # 32 bytes of entropy, urlsafe — matches the reference's generate-keys
    # output shape (cmd/server/commands.go generate-keys).
    return secrets.token_urlsafe(32)
