"""Signal protocol: the /rtc WebSocket message surface.

Reference parity: livekit.SignalRequest / livekit.SignalResponse oneofs as
dispatched by pkg/rtc/signalhandler.go:24-97 (14 request variants) and
emitted throughout pkg/rtc (JoinResponse room.go:935, ParticipantUpdate,
SpeakersChanged, StreamStateUpdate, …). Framing is the JSON oneof shape of
the reference's JSON signal mode (pkg/service/wsprotocol.go): one
single-key object `{"<variant>": {...}}`.

Messages are tagged unions: `SignalRequest(kind, data)` where `kind` names
the oneof arm and `data` is the payload dict (typed payload dataclasses in
protocol.models are used for the structured ones). This keeps the wire
surface complete without a protobuf toolchain; a protobuf codec can slot in
behind encode/decode later without touching callers.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

from livekit_server_tpu_torch.protocol import packer

# Request variants a client may send (signalhandler.go:24-97).
REQUEST_KINDS = frozenset(
    {
        "offer",            # publisher SDP offer
        "answer",           # subscriber SDP answer
        "trickle",          # ICE candidate
        "add_track",        # AddTrackRequest
        "mute",             # MuteTrackRequest
        "subscription",     # UpdateSubscription
        "track_setting",    # UpdateTrackSettings (quality/dims/fps)
        "leave",            # LeaveRequest
        "update_layers",    # UpdateVideoLayers (deprecated upstream, kept)
        "subscription_permission",  # per-publisher subscription grants
        "sync_state",       # resume: replay subscriptions/tracks
        "simulate",         # fault injection scenarios
        "ping",             # rtt ping (responds pong)
        "update_metadata",  # participant metadata/name/attributes
        "request_relay",    # mint a media-relay allocation (TURN cred seat)
    }
)

# Response variants the server may send.
RESPONSE_KINDS = frozenset(
    {
        "join",
        "answer",
        "offer",
        "trickle",
        "update",                    # ParticipantUpdate
        "track_published",
        "track_unpublished",
        "leave",
        "mute",
        "speakers_changed",
        "room_update",
        "connection_quality",
        "stream_state_update",
        "subscribed_quality_update",
        "subscription_permission_update",
        "refresh_token",
        "pong",
        "reconnect",
        "subscription_response",
        "request_response",
        "track_subscribed",
        # Data packets ride the signal socket in this build (the reference
        # uses SCTP data channels; the seam is the same fan-out —
        # room.go:1455).
        "data_packet",
    }
)


@dataclass
class SignalRequest:
    kind: str
    data: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in REQUEST_KINDS:
            raise ValueError(f"unknown signal request kind: {self.kind!r}")


@dataclass
class SignalResponse:
    kind: str
    data: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in RESPONSE_KINDS:
            raise ValueError(f"unknown signal response kind: {self.kind!r}")


# -- binary framing ---------------------------------------------------------
# The reference negotiates JSON vs protobuf per WS connection
# (pkg/service/wsprotocol.go — SDKs speak the compact binary form). This
# build's binary mode is msgpack with numeric kind tags: a deliberate
# redesign (no protobuf toolchain), same capability — a compact,
# schema-tagged binary signal wire negotiated per connection.
#
# Frame: 0x00 | msgpack([kind_id, data]). The leading 0x00 can never
# collide with the media frames that share the BINARY channel: those are
# msgpack maps, whose first byte is 0x80-0x8f or 0xde/0xdf.
#
# Kind ids are STABLE WIRE CONSTANTS — append only, never renumber.
BINARY_MAGIC = 0x00

_REQUEST_ID_LIST = [
    "offer", "answer", "trickle", "add_track", "mute", "subscription",
    "track_setting", "leave", "update_layers", "subscription_permission",
    "sync_state", "simulate", "ping", "update_metadata", "request_relay",
]
_RESPONSE_ID_LIST = [
    "join", "answer", "offer", "trickle", "update", "track_published",
    "track_unpublished", "leave", "mute", "speakers_changed", "room_update",
    "connection_quality", "stream_state_update", "subscribed_quality_update",
    "subscription_permission_update", "refresh_token", "pong", "reconnect",
    "subscription_response", "request_response", "track_subscribed",
    "data_packet",
]
REQUEST_KIND_TO_ID = {k: i for i, k in enumerate(_REQUEST_ID_LIST)}
RESPONSE_KIND_TO_ID = {k: i for i, k in enumerate(_RESPONSE_ID_LIST)}

# Always-on invariant (asserts vanish under python -O): a drifted id list
# would silently renumber wire constants for deployed binary clients.
if set(_REQUEST_ID_LIST) != REQUEST_KINDS or set(_RESPONSE_ID_LIST) != RESPONSE_KINDS:
    raise RuntimeError("binary signal kind-id tables out of sync with KINDS")


def _encode_bin(kind_id: int, data: dict) -> bytes:
    return bytes([BINARY_MAGIC]) + packer.packb([kind_id, data])


def _decode_bin(raw: bytes, id_list: list[str], what: str) -> tuple[str, dict]:
    if not raw or raw[0] != BINARY_MAGIC:
        raise ValueError(f"{what}: not a binary signal frame")
    try:
        msg = packer.unpackb(raw[1:])
    except ValueError as e:
        raise ValueError(f"{what}: malformed msgpack: {e}") from None
    if not isinstance(msg, (list, tuple)) or len(msg) != 2:
        raise ValueError(f"{what}: expected [kind_id, data] pair")
    kind_id, data = msg
    if not isinstance(kind_id, int) or not 0 <= kind_id < len(id_list):
        raise ValueError(f"{what}: unknown kind id {kind_id!r}")
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ValueError(f"{what}: payload must be a map")
    return id_list[kind_id], data


def is_binary_signal_frame(data: bytes) -> bool:
    """Demux for the shared BINARY channel: signal frame vs media frame."""
    return bool(data) and data[0] == BINARY_MAGIC


def encode_signal_request_bin(req: SignalRequest) -> bytes:
    return _encode_bin(REQUEST_KIND_TO_ID[req.kind], req.data)


def decode_signal_request_bin(raw: bytes) -> SignalRequest:
    return SignalRequest(*_decode_bin(raw, _REQUEST_ID_LIST, "SignalRequest"))


def encode_signal_response_bin(resp: SignalResponse) -> bytes:
    return _encode_bin(RESPONSE_KIND_TO_ID[resp.kind], resp.data)


def decode_signal_response_bin(raw: bytes) -> SignalResponse:
    return SignalResponse(*_decode_bin(raw, _RESPONSE_ID_LIST, "SignalResponse"))


def _encode(kind: str, data: dict) -> str:
    return json.dumps({kind: data}, separators=(",", ":"))


def _decode(raw: str | bytes, kinds: frozenset[str], what: str) -> tuple[str, dict]:
    msg = json.loads(raw)
    if not isinstance(msg, dict) or len(msg) != 1:
        raise ValueError(f"{what}: expected single-key oneof object")
    kind, data = next(iter(msg.items()))
    if kind not in kinds:
        raise ValueError(f"{what}: unknown variant {kind!r}")
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ValueError(f"{what}: payload for {kind!r} must be an object")
    return kind, data


def encode_signal_request(req: SignalRequest) -> str:
    return _encode(req.kind, req.data)


def decode_signal_request(raw: str | bytes) -> SignalRequest:
    return SignalRequest(*_decode(raw, REQUEST_KINDS, "SignalRequest"))


def encode_signal_response(resp: SignalResponse) -> str:
    return _encode(resp.kind, resp.data)


def decode_signal_response(raw: str | bytes) -> SignalResponse:
    return SignalResponse(*_decode(raw, RESPONSE_KINDS, "SignalResponse"))
