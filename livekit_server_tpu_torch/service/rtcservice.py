"""/rtc WebSocket endpoint: signaling + media framing.

Reference parity: pkg/service/rtcservice.go (validate :106-194, ServeHTTP
:196-440, startConnection :527) — token validation, room allocation via the
router, then a bidirectional pump between the socket and the participant's
MessageChannels.

Transport re-design: the reference splits signal (WS) from media (WebRTC/
UDP via Pion). This build multiplexes both on the one WebSocket: TEXT
frames carry JSON signal messages (protocol/signal.py), BINARY frames carry
msgpack media packets (header fields + payload) that land in the node's
IngestBuffer — and subscriber egress returns as msgpack BINARY frames. A
native UDP media path can bind the same ingest seam (runtime/ingest.py)
without touching this service.

Port of the JAX package's service/rtcservice.py; the MessagePack frames
go through the port's own codec (protocol/packer.py), byte for byte the
reference's.
"""

from __future__ import annotations

import asyncio
import json
from typing import TYPE_CHECKING

from aiohttp import WSMsgType, web

from livekit_server_tpu_torch.auth import TokenError, verify_token
from livekit_server_tpu_torch.protocol import packer, signal as sigproto
from livekit_server_tpu_torch.routing.messagechannel import ChannelClosed, ChannelFull
from livekit_server_tpu_torch.routing.router import ParticipantInit
from livekit_server_tpu_torch.runtime.ingest import PacketIn

if TYPE_CHECKING:
    from livekit_server_tpu_torch.service.server import LivekitServer


class RTCService:
    def __init__(self, server: "LivekitServer"):
        self.server = server
        self.connections = 0

    async def handle(self, request: web.Request) -> web.StreamResponse:
        # -- validate (rtcservice.go:106) --------------------------------
        token = request.query.get("access_token") or request.headers.get(
            "Authorization", ""
        ).removeprefix("Bearer ").strip()
        try:
            claims = verify_token(token, self.server.config.keys)
        except TokenError as e:
            return web.Response(status=401, text=str(e))
        if not claims.video.room_join:
            return web.Response(status=401, text="token lacks roomJoin")
        room_name = request.query.get("room") or claims.video.room
        if not room_name:
            return web.Response(status=400, text="room required")
        if claims.video.room and room_name != claims.video.room:
            return web.Response(status=401, text="token not valid for room")
        if not claims.identity:
            return web.Response(status=400, text="identity required")
        auto_subscribe = request.query.get("auto_subscribe", "1") not in ("0", "false")

        # -- route (rtcservice.go startConnection :527) -------------------
        router = self.server.router
        node_id = await router.get_node_for_room(room_name)
        if not node_id:
            if not self.server.config.room.auto_create:
                # ValidateCreateRoom (roomallocator.go:147): with
                # auto-create off, an admin-created room (store record,
                # no pin yet) must still be joinable; only a room that
                # exists nowhere is a 404.
                if await self.server.store.load_room(room_name) is None:
                    return web.Response(status=404, text="room not found")
            node = self.server.select_node()
            if node is None:
                return web.Response(status=503, text="no nodes available")
            await router.set_node_for_room(room_name, node.node_id)
        # ClientInfo rides the connect query (SDKs send sdk/version/os/...;
        # rtcservice.go ParseClientInfo) → clientconfiguration matching.
        client_info = {
            k: request.query[k]
            for k in ("sdk", "version", "protocol", "os", "os_version",
                      "browser", "browser_version", "device_model")
            if k in request.query
        }
        init = ParticipantInit(
            identity=claims.identity,
            name=claims.name,
            auto_subscribe=auto_subscribe,
            reconnect=request.query.get("reconnect") == "1",
            grants={"video": claims.video.to_claim()},
            client_info=client_info or None,
        )
        try:
            cid, req_sink, resp_source = await router.start_participant_signal(room_name, init)
        except Exception as e:  # noqa: BLE001 — surface as 503 like the reference
            return web.Response(status=503, text=f"signal start failed: {e}")

        # -- websocket pump (rtcservice.go:283-439) -----------------------
        # Signal wire negotiation (wsprotocol.go JSON-vs-protobuf seat):
        # `?signal=binary` or WS subprotocol "signal-binary" selects the
        # compact msgpack signal framing; JSON TEXT remains the default.
        # Either way the session plumbing sees JSON — transcoding happens
        # here at the edge.
        ws = web.WebSocketResponse(
            heartbeat=30, protocols=("signal-json", "signal-binary")
        )
        await ws.prepare(request)
        binary_signal = (
            request.query.get("signal") == "binary"
            or ws.ws_protocol == "signal-binary"
        )
        self.connections += 1
        pump = asyncio.ensure_future(
            self._pump_responses(
                ws, resp_source, room_name, claims.identity, binary_signal
            )
        )
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    try:
                        req_sink.write_message(msg.data)
                    except (ChannelFull, ChannelClosed):
                        break
                elif msg.type == WSMsgType.BINARY:
                    if sigproto.is_binary_signal_frame(msg.data):
                        try:
                            req = sigproto.decode_signal_request_bin(msg.data)
                            req_sink.write_message(
                                sigproto.encode_signal_request(req)
                            )
                        except (ValueError, TypeError):
                            # malformed frame, or a payload JSON can't carry
                            # (raw bytes in a map value): drop
                            pass
                        except (ChannelFull, ChannelClosed):
                            break
                        continue
                    self._ingest_media(room_name, claims.identity, msg.data)
                elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
        finally:
            self.connections -= 1
            req_sink.close()
            pump.cancel()
        return ws

    async def _pump_responses(
        self, ws, resp_source, room_name: str, identity: str,
        binary_signal: bool = False,
    ) -> None:
        """Server→client: signal as TEXT JSON (or tagged BINARY msgpack in
        binary mode); media deliveries as BINARY."""
        sig_t: asyncio.Task | None = None
        med_t: asyncio.Task | None = None
        try:
            while True:
                # Media queue appears once the session handler created the
                # participant (same-node rooms only; cross-node media binds
                # to the hosting node's own /rtc socket).
                media_q = self.server.room_manager_media_queue(room_name, identity)
                if sig_t is None:
                    sig_t = asyncio.ensure_future(resp_source.read_message())
                if media_q is not None and med_t is None:
                    med_t = asyncio.ensure_future(media_q.get())
                tasks = {sig_t} | ({med_t} if med_t is not None else set())
                done, _pending = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED, timeout=0.25
                )
                if sig_t in done:
                    data = sig_t.result()
                    sig_t = None
                    if binary_signal:
                        await ws.send_bytes(
                            sigproto.encode_signal_response_bin(
                                sigproto.decode_signal_response(data)
                            )
                        )
                    else:
                        await ws.send_str(data)
                if med_t is not None and med_t in done:
                    data = med_t.result()
                    med_t = None
                    await ws.send_bytes(data)
        except (ChannelClosed, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            for t in (sig_t, med_t):
                if t is not None:
                    t.cancel()
            if not ws.closed:
                await ws.close()

    def _ingest_media(self, room_name: str, identity: str, data: bytes) -> None:
        """BINARY media frame → IngestBuffer (the transport→buffer seam)."""
        rm = self.server.room_manager
        room = rm.rooms.get(room_name)
        if room is None:
            return
        participant = room.participants.get(identity)
        if participant is None:
            return
        try:
            frame = packer.unpackb(data)
        except ValueError:  # malformed frame: drop
            return
        if not isinstance(frame, dict):
            return
        cid = frame.get("cid", "")
        track_sid = frame.get("track_sid", "")
        track = None
        if track_sid:
            track = participant.published.get(track_sid)
        if track is None and cid:
            track = participant.publish_pending(cid)  # first media binds it
            if track is None and cid in participant.pending_tracks:
                return  # no capacity yet
            for t in participant.published.values():
                if t.cid == cid:
                    track = t
                    break
        if track is None:
            return
        rm.runtime.ingest.push(
            PacketIn(
                room=room.slots.row,
                track=track.track_col,
                sn=frame.get("sn", 0),
                ts=frame.get("ts", 0),
                size=len(frame.get("payload", b"")),
                payload=frame.get("payload", b""),
                layer=frame.get("layer", 0),
                temporal=frame.get("temporal", 0),
                keyframe=frame.get("keyframe", False),
                layer_sync=frame.get("layer_sync", frame.get("keyframe", False)),
                begin_pic=frame.get("begin_pic", False),
                pid=frame.get("pid", 0),
                tl0=frame.get("tl0", 0),
                keyidx=frame.get("keyidx", 0),
                frame_ms=frame.get("frame_ms", 20),
                audio_level=frame.get("audio_level", 127),
                arrival_rtp=frame.get("ts", 0),
            )
        )
