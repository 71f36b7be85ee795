"""Room: participant registry + subscription fan-out + per-tick events.

Reference parity: pkg/rtc/room.go (Room struct :76-122, Join :313-472,
RemoveParticipant :546-620, onTrackPublished :963-1041,
subscribeToExistingTracks :1074-1099, audioUpdateWorker :1278,
broadcastParticipantState :1101, data fan-out :1455) plus the
subscription-manager reconcile (subscriptionmanager.go) collapsed into
mask writes: desired state IS the ctrl.subscribed tensor, so reconcile is
a single assignment rather than a retry loop.

A Room owns one room row in the node's PlaneRuntime; its handle_tick
receives the row's slice of TickResult (egress packets, speakers,
keyframe needs) from the node dispatcher.
"""

from __future__ import annotations

import time
from typing import Callable

from livekit_server_tpu_torch.protocol import models as pm
from livekit_server_tpu_torch.rtc.participant import Participant, PublishedTrack
from livekit_server_tpu_torch.runtime.plane_runtime import PlaneRuntime
from livekit_server_tpu_torch.runtime.slots import CapacityError, RoomSlots
from livekit_server_tpu_torch.runtime.udp import PLI_THROTTLE_MS
from livekit_server_tpu_torch.utils import ids


class Room:
    def __init__(
        self,
        name: str,
        runtime: PlaneRuntime,
        info: pm.RoomInfo | None = None,
    ):
        self.name = name
        self.runtime = runtime
        self.slots: RoomSlots = runtime.slots.alloc_room(name)
        self.info = info or pm.RoomInfo(sid=ids.new_room_id(), name=name)
        self.info.name = name
        self.participants: dict[str, Participant] = {}   # identity → P
        self.by_sid: dict[str, Participant] = {}
        self.tracks: dict[str, tuple[Participant, PublishedTrack]] = {}
        self.created_at = time.time()
        self.last_left_at = 0.0
        self.closed = False
        self.udp = None  # UDPMediaTransport when the node serves UDP media
        self.crypto = None  # MediaCryptoRegistry (join-time key minting)
        # Node admission gate (RoomManager._admission_denied): returns a
        # non-empty rejection reason when new work must be refused.
        # None (tests constructing rooms directly) admits everything.
        self.admission = None
        # Incremental indexes for the per-tick hot path (no per-packet
        # dict rebuilds): sub col → participant, track col → track sid.
        self.sub_index: dict[int, Participant] = {}
        self.col_to_sid: dict[int, str] = {}
        # Hooks fired on publish (room.go onTrackPublished callbacks —
        # used for publisher agent jobs and track egress launch).
        self.on_track_published: list[Callable] = []
        self._on_close: list[Callable[[], None]] = []
        self._active_speakers: list[dict] = []
        self._last_pli: dict[int, float] = {}  # track col → monotonic s
        from livekit_server_tpu_torch.rtc.dynacast import DynacastState

        self.dynacast = DynacastState()

    # -- join / leave (room.go Join :313) ---------------------------------
    def join(self, participant: Participant) -> dict:
        """Admit the participant; returns the JoinResponse payload."""
        if self.closed:
            raise RuntimeError("room closed")
        existing = self.participants.get(participant.identity)
        if existing is not None:
            # duplicate identity ⇒ disconnect the older session
            # (room.go:331 DuplicateIdentity)
            self.remove_participant(existing, pm.DisconnectReason.DUPLICATE_IDENTITY)
        participant.sub_col = self.slots.alloc_sub(participant.sid)
        self.participants[participant.identity] = participant
        self.by_sid[participant.sid] = participant
        self.sub_index[participant.sub_col] = participant
        participant.state = pm.ParticipantState.JOINED
        self.info.num_participants = len(self.participants)

        # auto-subscribe to existing tracks (room.go:1074)
        if participant.auto_subscribe and participant.permission.can_subscribe:
            for sid in self.tracks:
                self.subscribe(participant, sid)

        self.broadcast_participant_state(participant)
        others = [
            p.to_info().to_dict()
            for p in self.participants.values()
            if p.sid != participant.sid and not p.permission.hidden
        ]
        resp = {
            "room": self.info.to_dict(),
            "participant": participant.to_info().to_dict(),
            "other_participants": others,
            "server_info": {"edition": "tpu", "protocol": 12},
        }
        if self.crypto is not None:
            # Media-wire key exchange over the authenticated signal channel
            # (the DTLS-SRTP handshake seat — transport.go:167): the
            # session seals every UDP/TCP media datagram both directions.
            import base64

            from livekit_server_tpu_torch.runtime.crypto import ALGO

            session = self.crypto.mint()
            session.room = self.slots.row
            session.sub = participant.sub_col
            participant.crypto_session = session
            if self.udp is not None:
                self.udp.bind_sub_session(
                    self.slots.row, participant.sub_col, session
                )
            resp["media_crypto"] = {
                "key_id": session.key_id,
                "key": base64.b64encode(session.key).decode(),
                "algo": ALGO,
            }
        return resp

    def remove_participant(
        self, participant: Participant, reason: pm.DisconnectReason
    ) -> None:
        p = self.participants.get(participant.identity)
        if p is None or p.sid != participant.sid:
            return
        for sid in list(p.published):
            p.unpublish_track(sid)
        # drop their subscriptions column
        if p.sub_col >= 0:
            for _, (_, track) in self.tracks.items():
                self.runtime.set_subscription(
                    self.slots.row, track.track_col, p.sub_col, subscribed=False
                )
            self.slots.release_sub(p.sid)
            self.sub_index.pop(p.sub_col, None)
            if self.udp is not None:
                self.udp.release_subscriber(self.slots.row, p.sub_col)
        if self.crypto is not None and getattr(p, "crypto_session", None) is not None:
            self.crypto.remove(p.crypto_session.key_id)
        peer = getattr(p, "gateway_peer", None)
        if peer is not None and self.udp is not None and self.udp.gateway is not None:
            # Standards-lane client: tear down the DTLS association and
            # its SSRC bindings with the participant.
            self.udp.gateway.close_peer(peer)
            p.gateway_peer = None
        del self.participants[p.identity]
        self.by_sid.pop(p.sid, None)
        self.info.num_participants = len(self.participants)
        self.last_left_at = time.time()
        p.send("leave", {"reason": int(reason), "can_reconnect": False})
        p.close(reason)
        self.broadcast_participant_state(p)

    # -- publication (room.go onTrackPublished :963) ----------------------
    def publish_track(
        self, publisher: Participant, info: pm.TrackInfo
    ) -> PublishedTrack | None:
        try:
            col = self.slots.alloc_track(info.sid)
        except CapacityError:
            return None
        track = PublishedTrack(info=info, track_col=col)
        self.tracks[info.sid] = (publisher, track)
        self.col_to_sid[col] = info.sid
        is_svc = pm.is_svc_mime(info.mime_type, info.type == pm.TrackType.VIDEO)
        self.runtime.set_track(
            self.slots.row,
            col,
            published=True,
            is_video=info.type == pm.TrackType.VIDEO,
            pub_muted=info.muted,
            is_svc=is_svc,
            pub_sub=publisher.sub_col,
        )
        if self.udp is not None:
            self.udp.set_track_kind(self.slots.row, col, info.type == pm.TrackType.VIDEO)
        # Count distinct publishers from the track registry (the caller's
        # published dict is updated only after this returns).
        self.info.num_publishers = len({pub.sid for pub, _t in self.tracks.values()})
        # fan out subscriptions to everyone else (room.go:1028)
        for p in self.participants.values():
            if p.sid == publisher.sid:
                continue
            if p.auto_subscribe and p.permission.can_subscribe:
                self.subscribe(p, info.sid)
        self.broadcast_participant_state(publisher)
        for cb in self.on_track_published:
            cb(publisher, track)
        return track

    def unpublish_track(self, publisher: Participant, track: PublishedTrack) -> None:
        sid = track.info.sid
        if sid not in self.tracks:
            return
        del self.tracks[sid]
        self.col_to_sid.pop(track.track_col, None)
        self.runtime.set_track(
            self.slots.row, track.track_col, published=False, is_video=track.is_video
        )
        if self.udp is not None:
            self.udp.release_track(self.slots.row, track.track_col)
        self.slots.release_track(sid)
        for p in self.participants.values():
            p.subscribed_tracks.discard(sid)
            p.stream_paused.pop(sid, None)   # sids never reuse; no growth
            if p.sid != publisher.sid:
                p.send("track_unpublished", {"track_sid": sid, "participant_sid": publisher.sid})
        self.broadcast_participant_state(publisher)

    def set_track_muted(self, publisher: Participant, track: PublishedTrack, muted: bool) -> None:
        self.runtime.set_track(
            self.slots.row,
            track.track_col,
            published=True,
            is_video=track.is_video,
            pub_muted=muted,
        )
        self.broadcast_participant_state(publisher)

    # -- subscription (subscriptionmanager.go collapsed) ------------------
    def subscribe(self, subscriber: Participant, track_sid: str) -> bool:
        ent = self.tracks.get(track_sid)
        if ent is None or subscriber.sub_col < 0:
            return False
        if not subscriber.permission.can_subscribe:
            subscriber.send(
                "subscription_response",
                {"track_sid": track_sid, "err": 1},  # ERR_NO_PERMISSION
            )
            return False
        _pub, track = ent
        self.runtime.set_subscription(
            self.slots.row, track.track_col, subscriber.sub_col, subscribed=True
        )
        subscriber.subscribed_tracks.add(track_sid)
        subscriber.send("track_subscribed", {"track_sid": track_sid})
        return True

    def unsubscribe(self, subscriber: Participant, track_sid: str) -> None:
        ent = self.tracks.get(track_sid)
        subscriber.subscribed_tracks.discard(track_sid)
        # Forget the signaled pause state: a later re-subscribe starts from
        # the implicit 'active' baseline, so a still-paused allocation is
        # re-signaled instead of silently suppressed.
        subscriber.stream_paused.pop(track_sid, None)
        if ent is None or subscriber.sub_col < 0:
            return
        _pub, track = ent
        self.runtime.set_subscription(
            self.slots.row, track.track_col, subscriber.sub_col, subscribed=False
        )

    def update_track_settings(
        self, subscriber: Participant, track_sid: str, settings: dict
    ) -> None:
        """UpdateTrackSettings: mute/quality/dimensions → layer caps
        (mediatrackreceiver.go GetQualityForDimension analog)."""
        ent = self.tracks.get(track_sid)
        if ent is None or subscriber.sub_col < 0:
            return
        _pub, track = ent
        disabled = settings.get("disabled", False)
        quality = settings.get("quality")
        width = settings.get("width", 0)
        height = settings.get("height", 0)
        fps = settings.get("fps", 0)
        if "pinned" in settings:
            # Pinned subscriptions (screen share, active speaker) are
            # exempt from the governor's L3 video pause.
            self.runtime.set_pinned(
                self.slots.row, track.track_col, subscriber.sub_col,
                bool(settings["pinned"]),
            )
        self.runtime.set_subscription(
            self.slots.row,
            track.track_col,
            subscriber.sub_col,
            subscribed=track_sid in subscriber.subscribed_tracks,
            sub_muted=disabled,
        )
        # Only update layer caps when the settings actually carry layer
        # intent — a disabled-only update must not clobber a previous cap.
        max_spatial = None
        if quality is not None:
            max_spatial = min(int(quality), 2)
        elif width or height:
            # dimension → quality: smallest layer covering the request
            # (mediatrackreceiver.go GetQualityForDimension)
            max_spatial = 0
            for i, layer in enumerate(sorted(track.info.layers, key=lambda l: l.width)):
                max_spatial = min(i, 2)
                if layer.width >= width and layer.height >= height:
                    break
        # fps → temporal layer, assuming ~30 fps at the top layer with
        # rate halving per layer (temporallayerselector semantics).
        max_temporal = None
        if fps:
            max_temporal = 0 if fps <= 8 else 1 if fps <= 15 else 2 if fps <= 25 else 3
        if max_spatial is not None or max_temporal is not None:
            coords = (self.slots.row, track.track_col, subscriber.sub_col)
            if max_spatial is None:  # keep the current cap for the unset axis
                max_spatial = int(self.runtime.ctrl.max_spatial[coords])
            if max_temporal is None:
                max_temporal = int(self.runtime.ctrl.max_temporal[coords])
            self.runtime.set_layer_caps(*coords, max_spatial=max_spatial, max_temporal=max_temporal)

    # -- broadcast (room.go broadcastParticipantState :1101) --------------
    def broadcast_participant_state(self, participant: Participant) -> None:
        if participant.permission.hidden:
            return
        info = participant.to_info().to_dict()
        for p in self.participants.values():
            p.send("update", {"participants": [info]})

    def broadcast_data(
        self,
        sender: Participant | None,
        payload: str,
        kind: int = 0,
        destination_sids: list[str] | None = None,
        topic: str = "",
    ) -> None:
        """Data-channel fan-out (room.go:1455 BroadcastDataPacketForRoom).
        Data packets bypass the media plane (reference: SCTP, not RTP)."""
        if sender is not None and not sender.permission.can_publish_data:
            return
        targets = (
            [self.by_sid[s] for s in destination_sids if s in self.by_sid]
            if destination_sids
            else list(self.participants.values())
        )
        msg = {
            "participant_sid": sender.sid if sender else "",
            "payload": payload,
            "kind": kind,
            "topic": topic,
        }
        for p in targets:
            if sender is not None and p.sid == sender.sid:
                continue
            p.send("data_packet", msg)

    # -- per-tick events from the dispatcher ------------------------------
    def handle_speakers(self, speakers: list[tuple[int, float]]) -> None:
        """Room-row speaker ranking → speakers_changed broadcast
        (room.go audioUpdateWorker :1278)."""
        spk = []
        for track_col, level in speakers:
            sid = self.col_to_sid.get(track_col)
            if sid is None or sid not in self.tracks:
                continue
            pub, _t = self.tracks[sid]
            spk.append({"sid": pub.sid, "level": level, "active": True})
        if spk != self._active_speakers:
            self._active_speakers = spk
            for p in self.participants.values():
                p.send("speakers_changed", {"speakers": spk})

    def handle_keyframe_request(self, track_col: int) -> None:
        """Device says a subscriber needs a keyframe ⇒ PLI to publisher
        (receiver.go SendPLI / mediatrack.go), throttled per track so a
        persistent need_keyframe or a PLI-spamming subscriber cannot
        force a keyframe storm (buffer pliThrottle analog)."""
        now = time.monotonic()
        if now - self._last_pli.get(track_col, -1e12) < PLI_THROTTLE_MS / 1000.0:
            return
        self._last_pli[track_col] = now
        sid = self.col_to_sid.get(track_col)
        if sid and sid in self.tracks:
            pub, track = self.tracks[sid]
            pub.send("request_response", {"pli": {"track_sid": sid}})

    def deliver_egress(self, pkt) -> None:
        """Route one EgressPacket to the right subscriber's transport."""
        p = self.sub_index.get(pkt.sub)
        if p is not None:
            p.deliver_media(pkt)

    def handle_quality(self, track_quality, track_mos, sub_quality) -> None:
        """Per-window connection-quality fan-out (room.go:1318-1396
        connectionQualityWorker): each participant's quality = worst of its
        published tracks' E-model scores and its subscriber-side state,
        broadcast as a connection_quality update."""
        updates = []
        from livekit_server_tpu_torch.ops.quality import QUALITY_EXCELLENT, QUALITY_LOST

        for p in self.participants.values():
            qs: list[int] = []
            scores: list[float] = []
            for sid in p.published:
                ent = self.tracks.get(sid)
                if ent is None:
                    continue
                col = ent[1].track_col
                qs.append(int(track_quality[col]))
                scores.append(float(track_mos[col]))
            if p.sub_col >= 0 and p.subscribed_tracks:
                qs.append(int(sub_quality[p.sub_col]))
            # LOST only dominates when everything is LOST
            # (ParticipantImpl.GetConnectionQuality aggregation).
            live = [q for q in qs if q != QUALITY_LOST]
            if qs and not live:
                q = QUALITY_LOST
            elif live:
                q = min(live)
            else:
                q = QUALITY_EXCELLENT  # signal-only participant
            updates.append(
                {
                    "participant_sid": p.sid,
                    "quality": q,
                    "score": round(min(scores), 2) if scores else 5.0,
                }
            )
        if not updates:
            return
        for p in self.participants.values():
            p.send("connection_quality", {"updates": updates})

    def update_stream_states(self, target_layers) -> None:
        """Allocator pause/resume transitions → stream_state_update
        (streamallocator.go StreamStateUpdate → signal): a subscriber whose
        video allocation went to -1 (congestion pause, caps, mute) learns
        the stream is intentionally stopped, not lost. Only transitions are
        signaled; the initial active state is implicit."""
        for p in self.participants.values():
            if p.sub_col < 0 or not p.subscribed_tracks:
                continue
            states = []
            for sid in list(p.subscribed_tracks):
                ent = self.tracks.get(sid)
                if ent is None or not ent[1].is_video:
                    continue
                paused = int(target_layers[p.sub_col, ent[1].track_col]) < 0
                prev = p.stream_paused.get(sid)
                if prev is None:
                    p.stream_paused[sid] = paused
                    if not paused:
                        continue  # initial active is implicit
                elif prev == paused:
                    continue
                p.stream_paused[sid] = paused
                states.append({
                    "track_sid": sid,
                    "state": "paused" if paused else "active",
                })
            if states:
                p.send("stream_state_update", {"stream_states": states})

    def reconcile_dynacast(self) -> None:
        """Aggregate subscriber layer demand → subscribed_quality_update to
        publishers so they stop encoding unwatched simulcast layers
        (dynacastmanager.go:187-255; debounced downgrades inside
        rtc.dynacast.reconcile)."""
        from livekit_server_tpu_torch.rtc.dynacast import reconcile

        for publisher, sid, maxq in reconcile(self.dynacast, self):
            publisher.send(
                "subscribed_quality_update",
                {
                    "track_sid": sid,
                    "subscribed_qualities": [
                        {"quality": q, "enabled": q <= maxq} for q in range(3)
                    ],
                },
            )

    # -- lifecycle --------------------------------------------------------
    @property
    def is_empty(self) -> bool:
        return not self.participants

    def should_close(self, now: float | None = None) -> bool:
        """Idle-room reaping (server.go backgroundWorker + CloseIdleRooms):
        empty_timeout applies to rooms nobody ever joined; once the last
        participant departs, the (much shorter) departure_timeout governs."""
        now = now or time.time()
        if self.closed:
            return True
        if not self.is_empty:
            return False
        if self.last_left_at:
            return now - self.last_left_at > self.info.departure_timeout
        return now - self.created_at > self.info.empty_timeout

    def on_close(self, cb: Callable[[], None]) -> None:
        self._on_close.append(cb)

    def close(self, reason: pm.DisconnectReason = pm.DisconnectReason.ROOM_DELETED) -> None:
        if self.closed:
            return
        self.closed = True
        for p in list(self.participants.values()):
            self.remove_participant(p, reason)
        if self.udp is not None:
            self.udp.release_room(self.slots.row)
        self.runtime.clear_room(self.slots.row)
        self.runtime.slots.release_room(self.name)
        for cb in self._on_close:
            cb()
