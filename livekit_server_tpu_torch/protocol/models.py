"""Core API model types.

Reference parity: livekit/protocol protobufs as used throughout the
reference (livekit.Room, livekit.ParticipantInfo, livekit.TrackInfo,
livekit.ParticipantPermission, enums VideoQuality/TrackType/TrackSource/
ConnectionQuality/DisconnectReason), consumed by pkg/service (Twirp APIs),
pkg/rtc (room state), and webhooks. Dataclasses + to_dict/from_dict JSON
framing replace protobuf; field names follow the proto JSON names so
payloads look like the reference's JSON signal mode
(pkg/service/wsprotocol.go).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from dataclasses import dataclass, field
from typing import Any


class TrackType(enum.IntEnum):
    AUDIO = 0
    VIDEO = 1
    DATA = 2


class TrackSource(enum.IntEnum):
    UNKNOWN = 0
    CAMERA = 1
    MICROPHONE = 2
    SCREEN_SHARE = 3
    SCREEN_SHARE_AUDIO = 4


class VideoQuality(enum.IntEnum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2
    OFF = 3


class ConnectionQuality(enum.IntEnum):
    POOR = 0
    GOOD = 1
    EXCELLENT = 2
    LOST = 3


class ParticipantState(enum.IntEnum):
    JOINING = 0
    JOINED = 1      # signal connected, no media yet
    ACTIVE = 2      # media flowing
    DISCONNECTED = 3


class DisconnectReason(enum.IntEnum):
    UNKNOWN_REASON = 0
    CLIENT_INITIATED = 1
    DUPLICATE_IDENTITY = 2
    SERVER_SHUTDOWN = 3
    PARTICIPANT_REMOVED = 4
    ROOM_DELETED = 5
    STATE_MISMATCH = 6
    JOIN_FAILURE = 7
    MIGRATION = 8
    SIGNAL_CLOSE = 9


class DataPacketKind(enum.IntEnum):
    RELIABLE = 0
    LOSSY = 1


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_dict(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, enum.Enum):
        return int(obj)
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_dict(v) for k, v in obj.items()}
    return obj


class _Model:
    """Mixin: dict round-trip tolerant of unknown/missing keys."""

    def to_dict(self) -> dict:
        return _to_dict(self)

    @classmethod
    def from_dict(cls, d: dict):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            t = f.type if isinstance(f.type, type) else None
            sub = _NESTED.get((cls.__name__, f.name))
            if sub is not None and v is not None:
                if isinstance(v, list):
                    v = [sub.from_dict(x) if isinstance(x, dict) else x for x in v]
                elif isinstance(v, dict):
                    v = sub.from_dict(v)
            kw[f.name] = v
        return cls(**kw)


@dataclass
class SimulcastLayer(_Model):
    """One spatial encoding of a published video track (livekit.VideoLayer)."""

    quality: VideoQuality = VideoQuality.HIGH
    width: int = 0
    height: int = 0
    bitrate: int = 0
    ssrc: int = 0


@dataclass
class CodecInfo(_Model):
    """livekit.SimulcastCodecInfo / codec mime registration."""

    mime_type: str = ""
    mid: str = ""
    cid: str = ""
    layers: list[SimulcastLayer] = field(default_factory=list)


@dataclass
class TrackInfo(_Model):
    """livekit.TrackInfo (protocol) — the published-track descriptor."""

    sid: str = ""
    type: TrackType = TrackType.AUDIO
    name: str = ""
    muted: bool = False
    width: int = 0
    height: int = 0
    simulcast: bool = False
    disable_dtx: bool = False
    source: TrackSource = TrackSource.UNKNOWN
    layers: list[SimulcastLayer] = field(default_factory=list)
    mime_type: str = ""
    mid: str = ""
    codecs: list[CodecInfo] = field(default_factory=list)
    stereo: bool = False
    disable_red: bool = False
    stream: str = ""
    encryption: int = 0  # 0 none, 1 gcm, 2 custom — E2EE passthrough


def is_svc_mime(mime: str | None, is_video: bool) -> bool:
    """SVC codecs (VP9/AV1) carry all spatial layers in ONE stream and take
    the dependency-descriptor selection path (receiver.go IsSvcCodec)."""
    m = (mime or "").lower()
    return is_video and ("vp9" in m or "av1" in m)


@dataclass
class ParticipantPermission(_Model):
    """livekit.ParticipantPermission (auth grants → runtime enforcement,
    reference pkg/rtc/participant.go SetPermission)."""

    can_subscribe: bool = True
    can_publish: bool = True
    can_publish_data: bool = True
    can_publish_sources: list[TrackSource] = field(default_factory=list)
    hidden: bool = False
    recorder: bool = False
    can_update_metadata: bool = False
    agent: bool = False


@dataclass
class ParticipantInfo(_Model):
    """livekit.ParticipantInfo."""

    sid: str = ""
    identity: str = ""
    state: ParticipantState = ParticipantState.JOINING
    tracks: list[TrackInfo] = field(default_factory=list)
    metadata: str = ""
    joined_at: int = 0
    name: str = ""
    version: int = 0
    permission: ParticipantPermission = field(default_factory=ParticipantPermission)
    region: str = ""
    is_publisher: bool = False
    kind: int = 0  # 0 standard, 1 ingress, 2 egress, 3 sip, 4 agent
    attributes: dict[str, str] = field(default_factory=dict)


@dataclass
class RoomInfo(_Model):
    """livekit.Room."""

    sid: str = ""
    name: str = ""
    empty_timeout: int = 300
    departure_timeout: int = 20
    max_participants: int = 0
    creation_time: int = field(default_factory=lambda: int(time.time()))
    turn_password: str = ""
    enabled_codecs: list[CodecInfo] = field(default_factory=list)
    metadata: str = ""
    num_participants: int = 0
    num_publishers: int = 0
    active_recording: bool = False


# Nested-field deserialization table for _Model.from_dict.
_NESTED: dict[tuple[str, str], Any] = {
    ("CodecInfo", "layers"): SimulcastLayer,
    ("TrackInfo", "layers"): SimulcastLayer,
    ("TrackInfo", "codecs"): CodecInfo,
    ("ParticipantInfo", "tracks"): TrackInfo,
    ("ParticipantInfo", "permission"): ParticipantPermission,
    ("RoomInfo", "enabled_codecs"): CodecInfo,
}
