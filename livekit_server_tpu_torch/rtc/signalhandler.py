"""Signal dispatch: SignalRequest variants → participant/room operations.

Reference parity: pkg/rtc/signalhandler.go:24-97 — the switch over the 14
SignalRequest oneof arms. SDP offer/answer and ICE trickle are accepted
and acknowledged at this layer (the media transport in this build binds
publishers by token + slot coordinates rather than DTLS — see
service/media once the UDP path lands); everything else maps 1:1 to the
reference's behavior.
"""

from __future__ import annotations

import time

from livekit_server_tpu_torch.protocol.signal import SignalRequest
from livekit_server_tpu_torch.protocol import models as pm
from livekit_server_tpu_torch.rtc.participant import Participant


def handle_participant_signal(room, participant: Participant, req: SignalRequest) -> None:
    """One inbound signal message (rtcSessionWorker loop body analog)."""
    kind, data = req.kind, req.data

    if kind == "offer":
        # Publisher SDP. A real SDP (carries ICE credentials) negotiates
        # through the standards-lane WebRTC gateway: ICE-lite + DTLS-SRTP
        # on the media socket (runtime/webrtc_gateway.py; the reference's
        # Pion seat, pkg/rtc/transport.go + participant_sdp.go). Anything
        # else keeps the legacy reflect behavior for the slot-addressed
        # sealed transport's protocol-conformant SDKs.
        sdp_text = data.get("sdp", "")
        udp = getattr(room, "udp", None)
        sealed_active = (
            participant.crypto_session is not None
            and getattr(participant.crypto_session, "client_active", False)
        )
        if udp is not None and "a=ice-ufrag" in sdp_text and not sealed_active:
            answer = _negotiate_gateway_offer(room, participant, sdp_text)
            if answer is not None:
                participant.send("answer", {"type": "answer", "sdp": answer})
                return
        participant.send("answer", {"type": "answer", "sdp": sdp_text})
    elif kind == "answer":
        pass  # subscriber-side answer: nothing to reconcile host-side
    elif kind == "trickle":
        pass  # ICE candidates are not used by the slot-addressed transport
    elif kind == "add_track":
        info = participant.add_track_request(data)
        # UDP media: bind the tensor slot now and hand the client an SSRC
        # (the WS-media path instead binds on first BINARY frame).
        udp = getattr(room, "udp", None)
        if info is not None and data.get("transport") == "udp" and udp is not None:
            track = participant.publish_pending(data.get("cid", ""))
            if track is not None:
                # One SSRC per simulcast spatial layer (mediatrack.go layer
                # SSRC bookkeeping); single-layer tracks get exactly one.
                # SVC codecs (VP9/AV1) are single-stream: ONE SSRC, layers
                # ride the dependency descriptor (receiver.go IsSvcCodec).
                is_svc = pm.is_svc_mime(track.info.mime_type, track.is_video)
                n_layers = (
                    1 if is_svc or not track.is_video
                    else max(1, len(track.info.layers))
                )
                layer_ssrcs = [
                    udp.assign_ssrc(
                        room.slots.row, track.track_col, track.is_video, layer=l,
                        session=participant.crypto_session, svc=is_svc,
                        mime=track.info.mime_type,
                    )
                    for l in range(n_layers)
                ]
                track.ssrc = layer_ssrcs[0]
                participant.send(
                    "request_response",
                    {
                        "udp_media": {
                            "track_sid": track.info.sid,
                            "ssrc": layer_ssrcs[0],
                            "layer_ssrcs": layer_ssrcs,
                        }
                    },
                )
    elif kind == "mute":
        sid = data.get("sid", "")
        participant.set_track_muted(sid, bool(data.get("muted", False)))
        participant.send("mute", {"sid": sid, "muted": bool(data.get("muted", False))})
    elif kind == "subscription":
        udp = getattr(room, "udp", None)
        if (
            udp is not None
            and (data.get("udp_addr") or data.get("udp"))
            and participant.sub_col >= 0
        ):
            # A client-supplied address is never registered verbatim (it
            # would let any subscriber aim the server's media stream at a
            # third party — traffic reflection). Hand back a punch id; the
            # address latches when a PUNCH datagram carrying it arrives
            # from the client's actual socket (ICE-consent analog).
            # `udp_repunch` rotates a latched id after a NAT rebind.
            punch = udp.assign_subscriber_punch(
                room.slots.row,
                participant.sub_col,
                rotate=bool(data.get("udp_repunch", False)),
            )
            participant.send("request_response", {"udp_punch": {"punch_id": punch}})
        if udp is not None and participant.sub_col >= 0 and "red" in data:
            # RED capability opt-in (RFC 2198 Opus redundancy; the
            # reference negotiates RED in SDP — redreceiver.go).
            udp.set_sub_red(room.slots.row, participant.sub_col, bool(data["red"]))
        if udp is not None and participant.sub_col >= 0 and "audio_mix" in data:
            # MCU seat opt-in (runtime/mixer.py): the subscriber receives
            # ONE server-mixed Opus stream with their own voice excluded;
            # they typically unsubscribe the individual audio tracks in
            # the same message. An opt-out on a node with no mixer is a
            # no-op — it must not instantiate one.
            mixer = None
            if data["audio_mix"] or udp.audio_mixer is not None:
                try:
                    mixer = udp.enable_audio_mixer()
                except Exception:  # noqa: BLE001 — libopus absent: ignore
                    mixer = None
            if mixer is not None:
                own = next(
                    (t.track_col for t in participant.published.values()
                     if not t.is_video),
                    -1,
                )
                mixer.enable_sub(
                    room.slots.row, participant.sub_col,
                    bool(data["audio_mix"]), exclude_track=own,
                )
        for sid in data.get("track_sids", []):
            if data.get("subscribe", True):
                room.subscribe(participant, sid)
            else:
                room.unsubscribe(participant, sid)
        for pt in data.get("participant_tracks", []):
            for sid in pt.get("track_sids", []):
                if data.get("subscribe", True):
                    room.subscribe(participant, sid)
                else:
                    room.unsubscribe(participant, sid)
    elif kind == "track_setting":
        for sid in data.get("track_sids", []):
            room.update_track_settings(participant, sid, data)
    elif kind == "update_layers":
        pass  # deprecated upstream; dynacast handles layer pausing
    elif kind == "subscription_permission":
        _handle_subscription_permission(room, participant, data)
    elif kind == "sync_state":
        _handle_sync_state(room, participant, data)
    elif kind == "simulate":
        _handle_simulate(room, participant, data)
    elif kind == "ping":
        participant.send(
            "pong",
            {"last_ping_timestamp": data.get("timestamp", 0), "timestamp": int(time.time() * 1000)},
        )
    elif kind == "request_relay":
        # Media-relay allocation (turn.go:47 capability): hand back the
        # relay address + a token bound to this participant's media-crypto
        # session. The relay is blind; the token only admits forwarding.
        udp = getattr(room, "udp", None)
        info = getattr(udp, "relay_info", None) if udp is not None else None
        sess = participant.crypto_session
        if info is not None and sess is not None:
            from livekit_server_tpu_torch.runtime.relay import mint_relay_token

            host, port, secret, ttl = info
            token = mint_relay_token(secret, sess.key_id, ttl)
            participant.send(
                "request_response",
                {"relay_info": {
                    "host": host, "port": port, "token": token.hex(),
                    "ttl_s": ttl,
                }},
            )
        else:
            participant.send("request_response", {"relay_info": None})
    elif kind == "update_metadata":
        if participant.permission.can_update_metadata:
            participant.metadata = data.get("metadata", participant.metadata)
            participant.name = data.get("name", participant.name)
            participant.attributes.update(data.get("attributes", {}))
            participant.version += 1
            room.broadcast_participant_state(participant)
    elif kind == "leave":
        room.remove_participant(participant, pm.DisconnectReason.CLIENT_INITIATED)


def _negotiate_gateway_offer(room, participant: Participant, offer_text: str):
    """SDP offer → gateway peer + ICE-lite answer (participant_sdp.go
    seat). Send-capable m-sections bind to plane track columns: pending
    tracks (announced via add_track) are matched by media kind in order;
    sections with no matching announce auto-publish a track named after
    their mid. recv-capable sections register the participant's
    subscriber column for SRTP egress."""
    from livekit_server_tpu_torch.interop import sdp as sdp_mod

    udp = room.udp
    gw = udp.enable_gateway()
    try:
        offer = sdp_mod.parse_sdp(offer_text)
    except Exception:  # noqa: BLE001 — malformed SDP: fall back to legacy
        return None
    if not offer.media:
        return None
    old = getattr(participant, "gateway_peer", None)
    if old is not None:
        # Renegotiation: the old association's keys die with it.
        gw.close_peer(old)
        participant.gateway_peer = None

    # Tracks claimed by a previous gateway negotiation: reuse them by
    # kind on renegotiation (onnegotiationneeded fires for ICE restarts
    # and device changes — duplicating columns each time would exhaust
    # the room after a handful of re-offers).
    prior = {
        sid: t for sid, t in participant.published.items()
        if getattr(t, "via_gateway", False)
    }
    reused: set = set()
    publish = []
    for m in offer.media:
        if m.kind not in ("audio", "video"):
            continue
        if m.direction not in ("sendonly", "sendrecv") or not m.ssrcs:
            continue
        want_video = m.kind == "video"
        track = None
        for sid, t in prior.items():
            if sid not in reused and t.is_video == want_video:
                track = t
                reused.add(sid)
                break
        if track is None:
            for cid, info in list(participant.pending_tracks.items()):
                if (info.type == pm.TrackType.VIDEO) == want_video:
                    track = participant.publish_pending(cid)
                    break
        if track is None:
            cid = f"sdp-{m.mid or len(publish)}"
            codec = next(iter(m.codecs.values()), "")
            info = participant.add_track_request({
                "cid": cid,
                "type": int(pm.TrackType.VIDEO if want_video
                            else pm.TrackType.AUDIO),
                "name": cid,
                "mime_type": f"{m.kind}/{codec}" if codec else "",
            })
            if info is None:
                continue
            track = participant.publish_pending(cid)
        if track is None:
            continue
        track.via_gateway = True
        mime = next(
            (c for c in ("vp8", "vp9", "av1", "h264", "opus")
             if c in m.codecs.values()),
            "vp8" if want_video else "opus",
        )
        publish.append({
            "mid": m.mid, "room": room.slots.row,
            "track": track.track_col, "mime": mime,
            "svc": mime in ("vp9", "av1") and not any(
                g[0] == "SIM" for g in m.ssrc_groups
            ),
        })
    # Gateway tracks from the previous negotiation that this offer no
    # longer carries: unpublish, or they linger as ghost columns.
    for sid in list(prior):
        if sid not in reused:
            participant.unpublish_track(sid)
    subscribe = None
    if participant.sub_col >= 0 and any(
        m.direction in ("recvonly", "sendrecv") for m in offer.media
    ):
        subscribe = (room.slots.row, participant.sub_col)
    try:
        answer, peer = gw.create_peer(
            offer_text, publish=publish, subscribe=subscribe
        )
    except Exception:  # noqa: BLE001
        return None
    participant.gateway_peer = peer
    return answer


def _handle_subscription_permission(room, participant: Participant, data: dict) -> None:
    """UpdateSubscriptionPermission (uptrackmanager.go): restrict who may
    subscribe to this publisher's tracks."""
    # proto3 JSON omits false bools: a missing key means NOT all (the
    # restrictive reading — matching livekit.SubscriptionPermission).
    all_participants = bool(data.get("all_participants", False))
    # livekit.TrackPermission semantics: an entry with empty track_sids
    # grants that participant ALL of the publisher's tracks; a non-empty
    # list restricts the grant to exactly those track sids.
    allow_all: set = set()
    allow_by_track: dict[str, set] = {}
    for tp in data.get("track_permissions", []):
        who = tp.get("participant_sid") or tp.get("participant_identity")
        if not who:
            continue
        sids = tp.get("track_sids") or []
        if sids:
            for tsid in sids:
                allow_by_track.setdefault(tsid, set()).add(who)
        else:
            allow_all.add(who)
    for sid, (pub, track) in room.tracks.items():
        if pub.sid != participant.sid:
            continue
        track_allowed = allow_by_track.get(sid, set())
        for p in room.participants.values():
            if p.sid == pub.sid:
                continue
            ok = (
                all_participants
                or p.sid in allow_all
                or p.identity in allow_all
                or p.sid in track_allowed
                or p.identity in track_allowed
            )
            if not ok and sid in p.subscribed_tracks:
                room.unsubscribe(p, sid)
                p.send("subscription_permission_update", {
                    "participant_sid": pub.sid, "track_sid": sid, "allowed": False,
                })
            elif ok and p.auto_subscribe and sid not in p.subscribed_tracks:
                room.subscribe(p, sid)


def _handle_sync_state(room, participant: Participant, data: dict) -> None:
    """Resume path (room.go:648): replay desired subscription state."""
    sub = data.get("subscription", {})
    for sid in sub.get("track_sids", []):
        room.subscribe(participant, sid)
    for pub_track in data.get("publish_tracks", []):
        cid = pub_track.get("cid", "")
        if cid and cid not in participant.pending_tracks:
            participant.add_track_request(pub_track.get("track", {}) | {"cid": cid})


def _handle_simulate(room, participant: Participant, data: dict) -> None:
    """Fault injection (room.go:850-911 SimulateScenario)."""
    if "speaker_update" in data:
        pass  # speaker simulation handled by the audio path naturally
    if data.get("node_failure"):
        participant.close(pm.DisconnectReason.STATE_MISMATCH)
    if data.get("server_leave"):
        room.remove_participant(participant, pm.DisconnectReason.SERVER_SHUTDOWN)
    if "subscriber_bandwidth" in data:
        bw = float(data["subscriber_bandwidth"])
        if participant.sub_col >= 0 and bw > 0:
            room.runtime.ingest.push_feedback(
                room.slots.row, participant.sub_col, estimate=bw
            )
