"""Wire/API protocol types.

The reference consumes these from the external `livekit/protocol` repo
(protobuf-generated Go types: Room, ParticipantInfo, TrackInfo,
SignalRequest/SignalResponse, …). This build defines the same surface as
plain Python dataclasses with JSON framing — the seam every layer above the
media plane speaks (service HTTP APIs, /rtc WebSocket signaling, routing
relay, webhooks).
"""

from livekit_server_tpu_torch.protocol.models import (
    CodecInfo,
    ConnectionQuality,
    DataPacketKind,
    DisconnectReason,
    ParticipantInfo,
    ParticipantPermission,
    ParticipantState,
    RoomInfo,
    SimulcastLayer,
    TrackInfo,
    TrackSource,
    TrackType,
    VideoQuality,
)
from livekit_server_tpu_torch.protocol.signal import (
    SignalRequest,
    SignalResponse,
    decode_signal_request,
    decode_signal_response,
    encode_signal_request,
    encode_signal_response,
)

__all__ = [
    "CodecInfo",
    "ConnectionQuality",
    "DataPacketKind",
    "DisconnectReason",
    "ParticipantInfo",
    "ParticipantPermission",
    "ParticipantState",
    "RoomInfo",
    "SimulcastLayer",
    "TrackInfo",
    "TrackSource",
    "TrackType",
    "VideoQuality",
    "SignalRequest",
    "SignalResponse",
    "decode_signal_request",
    "decode_signal_response",
    "encode_signal_request",
    "encode_signal_response",
]
