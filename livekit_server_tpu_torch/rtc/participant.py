"""Participant: one connected client's session state.

Reference parity: pkg/rtc/participant.go (ParticipantImpl — signal
handling, track publication state machine, permissions, subscription
intents) and pkg/rtc/uptrackmanager.go (published-track registry). The
reference's two PCTransports + Pion plumbing collapse here into the media
slot coordinates: a published track is a (room row, track col) in the
plane tensor; a subscription is a True in the ctrl.subscribed mask; media
I/O happens via the runtime's ingest/egress (packets are pushed by the
transport layer with those coordinates).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from livekit_server_tpu_torch.protocol import models as pm
from livekit_server_tpu_torch.protocol.signal import SignalResponse, encode_signal_response
from livekit_server_tpu_torch.routing.messagechannel import ChannelClosed, ChannelFull, MessageChannel
from livekit_server_tpu_torch.utils import ids


@dataclass
class PublishedTrack:
    """UpTrackManager entry: TrackInfo + tensor coordinates."""

    info: pm.TrackInfo
    track_col: int
    cid: str = ""              # client's local id until published
    ssrc: int = 0              # UDP-transport media binding (0 = WS media)
    via_gateway: bool = False  # claimed by a standards-lane negotiation

    @property
    def is_video(self) -> bool:
        return self.info.type == pm.TrackType.VIDEO


class Participant:
    """Control-plane participant (ParticipantImpl analog, host-side)."""

    def __init__(
        self,
        identity: str,
        room,                     # rtc.Room (avoid circular type import)
        response_sink: MessageChannel | None = None,
        grants: dict | None = None,
        name: str = "",
        auto_subscribe: bool = True,
        client_info: dict | None = None,
    ):
        self.sid = ids.new_participant_id()
        self.identity = identity
        self.name = name
        self.room = room
        self.response_sink = response_sink
        self.grants = grants or {}
        self.auto_subscribe = auto_subscribe
        self.client_info = client_info or {}
        # Device/SDK quirk config matched at join (pkg/clientconfiguration
        # conf.go GetConfiguration); rides the JoinResponse and gates
        # resume + publish codecs server-side.
        from livekit_server_tpu_torch.clientconfig import ClientConfigurationManager

        self.client_config = ClientConfigurationManager().get_configuration(
            self.client_info
        )
        self.state = pm.ParticipantState.JOINING
        self.joined_at = int(time.time())
        self.metadata = ""
        self.attributes: dict[str, str] = {}
        self.sub_col: int = -1          # subscriber column in the room row
        self.crypto_session = None      # media-wire AEAD session (join-minted)
        self.gateway_peer = None        # standards-lane DTLS-SRTP peer
        # Last signaled allocator stream state per subscribed track sid
        # (streamallocator.go StreamStateUpdate change detection).
        self.stream_paused: dict[str, bool] = {}
        self.permission = pm.ParticipantPermission()
        self._apply_grant_permissions()
        self.published: dict[str, PublishedTrack] = {}   # track sid → entry
        self.pending_tracks: dict[str, pm.TrackInfo] = {}  # cid → info
        self.pending_since: dict[str, float] = {}  # cid → announce time
        # (supervisor/participant_supervisor.go publication watchdog)
        self.subscribed_tracks: set[str] = set()         # track sids
        self.disconnected = asyncio.Event()
        self.close_reason = pm.DisconnectReason.UNKNOWN_REASON
        self._media_out: Callable[[Any], None] | None = None
        self.media_queue: asyncio.Queue | None = None  # set by the transport
        # Bumped on every signal-sink swap (resume); a stale session worker
        # compares its captured epoch before tearing the participant down.
        self.session_epoch = 0
        self.version = 0

    # -- permissions (participant.go SetPermission / canPublishSource) ----
    def _apply_grant_permissions(self) -> None:
        video = self.grants.get("video", {}) if self.grants else {}
        def tri(key, default=True):
            v = video.get(key)
            return default if v is None else bool(v)
        self.permission = pm.ParticipantPermission(
            can_subscribe=tri("canSubscribe"),
            can_publish=tri("canPublish"),
            can_publish_data=tri("canPublishData"),
            hidden=bool(video.get("hidden", False)),
            recorder=bool(video.get("recorder", False)),
            can_update_metadata=tri("canUpdateOwnMetadata", False),
            agent=bool(video.get("agent", False)),
        )

    def set_permission(self, perm: pm.ParticipantPermission) -> bool:
        """Admin UpdateParticipant path; revoking publish closes tracks."""
        old = self.permission
        self.permission = perm
        if old.can_publish and not perm.can_publish:
            for sid in list(self.published):
                self.unpublish_track(sid)
            self.pending_tracks.clear()  # announced-but-unbound tracks too
            self.pending_since.clear()
        self.version += 1
        return True

    # -- signaling out ----------------------------------------------------
    def send(self, kind: str, data: dict) -> None:
        """Queue a SignalResponse; drop-on-overflow like the reference's
        bounded signal sinks (a stuck client can't block the room)."""
        if self.response_sink is None or self.response_sink.is_closed:
            return
        try:
            self.response_sink.write_message(
                encode_signal_response(SignalResponse(kind, data))
            )
        except (ChannelFull, ChannelClosed):
            pass

    def to_info(self) -> pm.ParticipantInfo:
        return pm.ParticipantInfo(
            sid=self.sid,
            identity=self.identity,
            state=self.state,
            tracks=[t.info for t in self.published.values()],
            metadata=self.metadata,
            joined_at=self.joined_at,
            name=self.name,
            version=self.version,
            permission=self.permission,
            is_publisher=bool(self.published),
            attributes=dict(self.attributes),
        )

    # -- publication state machine (participant.go AddTrack → addMediaTrack)
    def add_track_request(self, req: dict) -> pm.TrackInfo | None:
        """AddTrackRequest → pending track + track_published response."""
        if not self.permission.can_publish:
            return None
        cid = req.get("cid", "")
        if not cid or cid in self.pending_tracks:
            return None
        mime = str(req.get("mime_type", "")).lower()
        if self.client_config is not None and mime and mime in {
            m.lower()
            for m in self.client_config.disabled_codecs
            + self.client_config.disabled_publish_codecs
        }:
            # Codec publish disabled for this device/SDK combination
            # (clientconfiguration staticconfiguration.go). Answer
            # explicitly — dead air would hang the SDK's publish().
            self.send(
                "request_response",
                {"error": {"reason": "codec_disabled_for_client", "cid": cid,
                           "mime_type": mime}},
            )
            return None
        deny = getattr(self.room, "admission", None)
        reason = deny("publish") if deny is not None else ""
        if reason:
            # Node admission (governor L4 / LimitConfig track cap / node
            # ingress rate): answer explicitly — same contract as the
            # codec rejection above, dead air would hang the SDK.
            self.send(
                "request_response",
                {"error": {"reason": "node_overloaded", "cid": cid,
                           "message": reason}},
            )
            return None
        try:
            track_type = pm.TrackType(int(req.get("type", 0)))
            source = pm.TrackSource(int(req.get("source", 0)))
        except (ValueError, TypeError):
            return None  # malformed enum from client: reject, don't crash
        info = pm.TrackInfo(
            sid=ids.new_track_id(),
            type=track_type,
            name=req.get("name", ""),
            muted=req.get("muted", False),
            width=req.get("width", 0),
            height=req.get("height", 0),
            simulcast=len(req.get("layers", [])) > 1,
            source=source,
            layers=[
                pm.SimulcastLayer(
                    quality=pm.VideoQuality(l.get("quality", 0)),
                    width=l.get("width", 0),
                    height=l.get("height", 0),
                )
                for l in req.get("layers", [])
            ],
            mime_type=req.get("mime_type", ""),
            stereo=req.get("stereo", False),
            disable_red=req.get("disable_red", False),
        )
        self.pending_tracks[cid] = info
        self.pending_since[cid] = time.time()
        self.send("track_published", {"cid": cid, "track": info.to_dict()})
        return info

    def reap_stale_publications(self, wait_s: float = 30.0) -> list[str]:
        """Publication watchdog (supervisor/publication_monitor.go:30
        publishWaitDuration): an announced track whose media never arrived
        is abandoned and the client told, instead of a ghost entry living
        in pending_tracks forever. Returns the reaped cids."""
        now = time.time()
        stale = [
            cid for cid, t0 in self.pending_since.items()
            if now - t0 > wait_s and cid in self.pending_tracks
        ]
        for cid in stale:
            info = self.pending_tracks.pop(cid, None)
            self.pending_since.pop(cid, None)
            if info is not None:
                self.send(
                    "track_unpublished",
                    {"track_sid": info.sid, "participant_sid": self.sid,
                     "reason": "publish_timeout"},
                )
        return stale

    def publish_pending(self, cid: str) -> PublishedTrack | None:
        """Media arrived for a pending track (the reference's onMediaTrack
        → mediaTrackReceived): allocate the tensor column, flip the mask."""
        if not self.permission.can_publish:
            # Permission may have been revoked between announce and media.
            self.pending_tracks.pop(cid, None)
            self.pending_since.pop(cid, None)
            return None
        info = self.pending_tracks.pop(cid, None)
        if info is None:
            return None
        track = self.room.publish_track(self, info)
        if track is None:
            self.pending_tracks[cid] = info  # no capacity; retry later
            # Media IS arriving — restart the watchdog clock so an active
            # publish blocked on capacity is never reaped as abandoned.
            self.pending_since[cid] = time.time()
            return None
        self.pending_since.pop(cid, None)
        track.cid = cid
        self.published[info.sid] = track
        self.state = pm.ParticipantState.ACTIVE
        self.version += 1
        return track

    def unpublish_track(self, track_sid: str) -> None:
        track = self.published.pop(track_sid, None)
        if track is not None:
            self.room.unpublish_track(self, track)
            self.version += 1

    def set_track_muted(self, track_sid: str, muted: bool) -> None:
        track = self.published.get(track_sid)
        if track is None:
            # may still be pending (mute before media arrives)
            for info in self.pending_tracks.values():
                if info.sid == track_sid:
                    info.muted = muted
            return
        track.info.muted = muted
        self.room.set_track_muted(self, track, muted)
        self.version += 1

    # -- media egress hookup ---------------------------------------------
    def on_media(self, cb: Callable[[Any], None]) -> None:
        """Transport registers its egress writer (EgressPacket consumer)."""
        self._media_out = cb

    def deliver_media(self, pkt) -> None:
        if self._media_out is not None:
            self._media_out(pkt)

    # -- teardown ---------------------------------------------------------
    def close(self, reason: pm.DisconnectReason) -> None:
        if self.state == pm.ParticipantState.DISCONNECTED:
            return
        self.state = pm.ParticipantState.DISCONNECTED
        self.close_reason = reason
        if self.response_sink is not None:
            self.response_sink.close()
        self.disconnected.set()
