"""RoomService: the Twirp-style admin HTTP API.

Reference parity: pkg/service/roomservice.go:34-331 — the eleven
livekit.RoomService RPCs (CreateRoom, ListRooms, DeleteRoom,
ListParticipants, GetParticipant, RemoveParticipant, MutePublishedTrack,
UpdateParticipant, UpdateSubscriptions, SendData, UpdateRoomMetadata),
served at POST /twirp/livekit.RoomService/<Method> with JSON bodies and
Bearer-token auth, same wire shape as the reference's Twirp JSON mode. In
multi-node mode, ops on rooms hosted elsewhere are relayed to the hosting
node over the cluster bus (the reference's psrpc RTC-node RPC;
multinode_roomservice_test.go) and the response mirrored back.

A copy of the JAX package's service/roomservice.py.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

from aiohttp import web

from livekit_server_tpu_torch.auth import (
    TokenError,
    ensure_admin_permission,
    ensure_create_permission,
    ensure_list_permission,
    verify_token,
)
from livekit_server_tpu_torch.protocol import models as pm

if TYPE_CHECKING:
    from livekit_server_tpu_torch.service.server import LivekitServer


def _err(status: int, msg: str) -> web.Response:
    return web.json_response({"code": "error", "msg": msg}, status=status)


class RoomServiceAPI:
    PREFIX = "/twirp/livekit.RoomService/"
    # RPCs that act on live room/participant state and must execute on the
    # node HOSTING the room (multinode_roomservice_test.go: admin ops hit
    # the non-hosting node and are relayed — the reference's RTC-node RPC).
    ROOM_SCOPED = frozenset({
        "DeleteRoom", "ListParticipants", "GetParticipant",
        "RemoveParticipant", "MutePublishedTrack", "UpdateParticipant",
        "UpdateSubscriptions", "SendData", "UpdateRoomMetadata",
    })

    def __init__(self, server: "LivekitServer"):
        self.server = server
        self._rpc_sub = None
        self._rpc_task = None

    # -- cross-node forwarding -------------------------------------------
    async def start(self) -> None:
        """Subscribe to this node's admin-RPC channel (hosting side)."""
        bus = getattr(self.server.router, "bus", None)
        if bus is None:
            return
        import asyncio

        node_id = self.server.router.local_node.node_id
        self._rpc_sub = bus.subscribe(f"admin_rpc:{node_id}")

        tasks: set = set()

        async def serve_one(req: dict, rid: str) -> None:
            try:
                handler = getattr(self, f"_rpc_{req.get('method', '')}", None)
                if handler is None:
                    resp = {"status": 404, "body": "unknown method"}
                else:
                    r = await handler(req.get("body") or {})
                    resp = {"status": r.status, "body": r.text}
            except Exception as e:  # noqa: BLE001 — a failing handler must
                # not take the relay down; the caller sees the 500.
                resp = {"status": 500, "body": str(e)}
            await bus.publish(f"admin_rpc_resp:{rid}", json.dumps(resp))

        async def worker():
            async for raw in self._rpc_sub:
                try:
                    req = json.loads(raw)
                    rid = req.get("id", "")
                except (ValueError, TypeError):
                    continue  # malformed frame: no id to answer to
                if not rid:
                    continue
                # Concurrent per-request tasks: one slow DeleteRoom must
                # not head-of-line-block other nodes' forwarded RPCs past
                # _forward's timeout.
                t = asyncio.ensure_future(serve_one(req, rid))
                tasks.add(t)
                t.add_done_callback(tasks.discard)

        self._rpc_task = asyncio.ensure_future(worker())

    async def stop(self) -> None:
        if self._rpc_sub is not None:
            self._rpc_sub.close()
        if self._rpc_task is not None:
            self._rpc_task.cancel()

    async def _forward(self, node_id: str, method: str, body: dict) -> web.Response:
        """Relay an admin RPC to the hosting node and mirror its response
        (the Twirp caller never sees which node served it)."""
        import asyncio

        from livekit_server_tpu_torch.utils import ids

        bus = self.server.router.bus
        rpc_id = ids.new_connection_id()
        sub = bus.subscribe(f"admin_rpc_resp:{rpc_id}")
        try:
            await bus.publish(
                f"admin_rpc:{node_id}",
                json.dumps({"id": rpc_id, "method": method, "body": body}),
            )
            try:
                raw = await sub.read(timeout=5.0)
            except asyncio.TimeoutError:
                return _err(504, f"hosting node {node_id[:12]} did not answer")
            resp = json.loads(raw)
            return web.Response(
                status=resp["status"], text=resp["body"],
                content_type="application/json",
            )
        finally:
            sub.close()

    async def handle(self, request: web.Request) -> web.Response:
        method = request.path.removeprefix(self.PREFIX)
        token = request.headers.get("Authorization", "").removeprefix("Bearer ").strip()
        try:
            claims = verify_token(token, self.server.config.keys)
        except TokenError as e:
            return _err(401, str(e))
        try:
            body = await request.json()
        except json.JSONDecodeError:
            body = {}
        handler = getattr(self, f"_rpc_{method}", None)
        if handler is None:
            return _err(404, f"unknown method {method}")
        # Permission guards, matching the reference per-RPC
        # (roomservice.go:79,142,165,174-271): CreateRoom/DeleteRoom need
        # roomCreate, ListRooms needs roomList, and every participant/room
        # mutation needs roomAdmin *scoped to the target room* — a token
        # minted as admin of room A must not administrate room B.
        if method in ("CreateRoom", "DeleteRoom"):
            if not ensure_create_permission(claims):
                return _err(403, "requires roomCreate")
        elif method == "ListRooms":
            if not ensure_list_permission(claims):
                return _err(403, "requires roomList")
        else:
            target = body.get("room", "")
            if not ensure_admin_permission(claims, target):
                return _err(403, "requires roomAdmin for this room")
        if method in self.ROOM_SCOPED:
            router = self.server.router
            name = body.get("room", "")
            node_id = await router.get_node_for_room(name)
            if (
                node_id
                and node_id != router.local_node.node_id
                and getattr(router, "bus", None) is not None
            ):
                if not await router.is_node_alive(node_id):
                    # Running the op LOCALLY against a room living on a
                    # (possibly just slow-heartbeating) other node would
                    # split-brain its state; a join re-homes the room via
                    # takeover, after which admin ops work again.
                    return _err(503, "hosting node unreachable")
                return await self._forward(node_id, method, body)
        return await handler(body)

    # -- RPCs -------------------------------------------------------------
    async def _rpc_CreateRoom(self, body: dict) -> web.Response:
        from livekit_server_tpu_torch.runtime import CapacityError

        name = body.get("name", "")
        if not name:
            return _err(400, "name required")
        info = pm.RoomInfo(
            name=name,
            empty_timeout=body.get("empty_timeout", self.server.config.room.empty_timeout_s),
            departure_timeout=body.get("departure_timeout", self.server.config.room.departure_timeout_s),
            max_participants=body.get("max_participants", 0),
            metadata=body.get("metadata", ""),
        )
        try:
            room = await self.server.room_manager.get_or_create_room(name, info=info)
        except CapacityError as e:
            # node room-tensor full (reference: explicit limits-reached
            # rejection rather than a raw 500 — roomallocator.go)
            return _err(503, f"node at capacity: {e}")
        return web.json_response(room.info.to_dict())

    async def _rpc_ListRooms(self, body: dict) -> web.Response:
        names = body.get("names") or None
        rooms = await self.server.store.list_rooms(names)
        return web.json_response({"rooms": [r.to_dict() for r in rooms]})

    async def _rpc_DeleteRoom(self, body: dict) -> web.Response:
        name = body.get("room", "")
        if not name:
            return _err(400, "room required")
        await self.server.room_manager.delete_room(name)
        return web.json_response({})

    def _room(self, body: dict):
        return self.server.room_manager.rooms.get(body.get("room", ""))

    async def _rpc_ListParticipants(self, body: dict) -> web.Response:
        room = self._room(body)
        if room is None:
            return _err(404, "room not found")
        return web.json_response(
            {"participants": [p.to_info().to_dict() for p in room.participants.values()]}
        )

    async def _rpc_GetParticipant(self, body: dict) -> web.Response:
        room = self._room(body)
        p = room.participants.get(body.get("identity", "")) if room else None
        if p is None:
            return _err(404, "participant not found")
        return web.json_response(p.to_info().to_dict())

    async def _rpc_RemoveParticipant(self, body: dict) -> web.Response:
        room = self._room(body)
        p = room.participants.get(body.get("identity", "")) if room else None
        if p is None:
            return _err(404, "participant not found")
        room.remove_participant(p, pm.DisconnectReason.PARTICIPANT_REMOVED)
        return web.json_response({})

    async def _rpc_MutePublishedTrack(self, body: dict) -> web.Response:
        room = self._room(body)
        p = room.participants.get(body.get("identity", "")) if room else None
        if p is None:
            return _err(404, "participant not found")
        sid = body.get("track_sid", "")
        muted = bool(body.get("muted", False))
        p.set_track_muted(sid, muted)
        track = p.published.get(sid)
        return web.json_response({"track": track.info.to_dict() if track else {}})

    async def _rpc_UpdateParticipant(self, body: dict) -> web.Response:
        room = self._room(body)
        p = room.participants.get(body.get("identity", "")) if room else None
        if p is None:
            return _err(404, "participant not found")
        if "metadata" in body:
            p.metadata = body["metadata"]
        if body.get("attributes"):
            p.attributes.update(body["attributes"])
        if body.get("permission"):
            p.set_permission(pm.ParticipantPermission.from_dict(body["permission"]))
        if "name" in body:
            p.name = body["name"]
        p.version += 1
        room.broadcast_participant_state(p)
        return web.json_response(p.to_info().to_dict())

    async def _rpc_UpdateSubscriptions(self, body: dict) -> web.Response:
        room = self._room(body)
        p = room.participants.get(body.get("identity", "")) if room else None
        if p is None:
            return _err(404, "participant not found")
        subscribe = bool(body.get("subscribe", True))
        for sid in body.get("track_sids", []):
            if subscribe:
                room.subscribe(p, sid)
            else:
                room.unsubscribe(p, sid)
        return web.json_response({})

    async def _rpc_SendData(self, body: dict) -> web.Response:
        room = self._room(body)
        if room is None:
            return _err(404, "room not found")
        room.broadcast_data(
            None,
            payload=body.get("data", ""),
            kind=body.get("kind", 0),
            destination_sids=body.get("destination_sids") or None,
            topic=body.get("topic", ""),
        )
        return web.json_response({})

    async def _rpc_UpdateRoomMetadata(self, body: dict) -> web.Response:
        room = self._room(body)
        if room is None:
            return _err(404, "room not found")
        if "metadata" not in body:
            return _err(400, "metadata required")
        room.info.metadata = body["metadata"]
        await self.server.store.store_room(room.info)
        for p in room.participants.values():
            p.send("room_update", {"room": room.info.to_dict()})
        return web.json_response(room.info.to_dict())
