"""Room/participant object store.

A copy of the JAX package's service/store.py.

Reference parity: pkg/service/interfaces.go ObjectStore +
localstore.go:28-170 (in-memory, single-node) + redisstore.go:67-944
(KV-backed, multi-node, with distributed room lock). The KV variant rides
the routing MessageBus so multi-node tests run N stores over one
MemoryBus, like the reference's multi-node tests over one Redis.
"""

from __future__ import annotations

import json
import time
from typing import Protocol

from livekit_server_tpu_torch.protocol import models as pm
from livekit_server_tpu_torch.routing.kv import MessageBus


class ObjectStore(Protocol):
    async def store_room(self, room: pm.RoomInfo) -> None: ...
    async def load_room(self, name: str) -> pm.RoomInfo | None: ...
    async def delete_room(self, name: str) -> None: ...
    async def list_rooms(self, names: list[str] | None = None) -> list[pm.RoomInfo]: ...
    async def store_participant(self, room: str, p: pm.ParticipantInfo) -> None: ...
    async def load_participant(self, room: str, identity: str) -> pm.ParticipantInfo | None: ...
    async def delete_participant(self, room: str, identity: str) -> None: ...
    async def list_participants(self, room: str) -> list[pm.ParticipantInfo]: ...
    async def lock_room(self, name: str, ttl: float = 5.0) -> bool: ...
    async def unlock_room(self, name: str) -> None: ...


class LocalStore:
    """localstore.go — maps guarded by the event loop (no locks needed)."""

    def __init__(self):
        self.rooms: dict[str, pm.RoomInfo] = {}
        self.participants: dict[str, dict[str, pm.ParticipantInfo]] = {}
        self._locks: dict[str, float] = {}

    async def store_room(self, room: pm.RoomInfo) -> None:
        self.rooms[room.name] = room

    async def load_room(self, name: str) -> pm.RoomInfo | None:
        return self.rooms.get(name)

    async def delete_room(self, name: str) -> None:
        self.rooms.pop(name, None)
        self.participants.pop(name, None)

    async def list_rooms(self, names: list[str] | None = None) -> list[pm.RoomInfo]:
        if names is None:
            return list(self.rooms.values())
        return [r for n, r in self.rooms.items() if n in names]

    async def store_participant(self, room: str, p: pm.ParticipantInfo) -> None:
        self.participants.setdefault(room, {})[p.identity] = p

    async def load_participant(self, room: str, identity: str) -> pm.ParticipantInfo | None:
        return self.participants.get(room, {}).get(identity)

    async def delete_participant(self, room: str, identity: str) -> None:
        self.participants.get(room, {}).pop(identity, None)

    async def list_participants(self, room: str) -> list[pm.ParticipantInfo]:
        return list(self.participants.get(room, {}).values())

    async def lock_room(self, name: str, ttl: float = 5.0) -> bool:
        now = time.monotonic()
        if self._locks.get(name, 0) > now:
            return False
        self._locks[name] = now + ttl
        return True

    async def unlock_room(self, name: str) -> None:
        self._locks.pop(name, None)


class KVStore:
    """redisstore.go over the MessageBus (hashes + setnx lock)."""

    ROOMS = "rooms"

    def __init__(self, bus: MessageBus):
        self.bus = bus

    async def store_room(self, room: pm.RoomInfo) -> None:
        await self.bus.hset(self.ROOMS, room.name, json.dumps(room.to_dict()))

    async def load_room(self, name: str) -> pm.RoomInfo | None:
        raw = await self.bus.hget(self.ROOMS, name)
        return pm.RoomInfo.from_dict(json.loads(raw)) if raw else None

    async def delete_room(self, name: str) -> None:
        await self.bus.hdel(self.ROOMS, name)
        parts = await self.bus.hgetall(f"room_participants:{name}")
        for identity in parts:
            await self.bus.hdel(f"room_participants:{name}", identity)

    async def list_rooms(self, names: list[str] | None = None) -> list[pm.RoomInfo]:
        raw = await self.bus.hgetall(self.ROOMS)
        rooms = [pm.RoomInfo.from_dict(json.loads(v)) for v in raw.values()]
        if names is not None:
            rooms = [r for r in rooms if r.name in names]
        return rooms

    async def store_participant(self, room: str, p: pm.ParticipantInfo) -> None:
        await self.bus.hset(f"room_participants:{room}", p.identity, json.dumps(p.to_dict()))

    async def load_participant(self, room: str, identity: str) -> pm.ParticipantInfo | None:
        raw = await self.bus.hget(f"room_participants:{room}", identity)
        return pm.ParticipantInfo.from_dict(json.loads(raw)) if raw else None

    async def delete_participant(self, room: str, identity: str) -> None:
        await self.bus.hdel(f"room_participants:{room}", identity)

    async def list_participants(self, room: str) -> list[pm.ParticipantInfo]:
        raw = await self.bus.hgetall(f"room_participants:{room}")
        return [pm.ParticipantInfo.from_dict(json.loads(v)) for v in raw.values()]

    async def lock_room(self, name: str, ttl: float = 5.0) -> bool:
        return await self.bus.setnx(f"room_lock:{name}", "1", ttl)

    async def unlock_room(self, name: str) -> None:
        await self.bus.delete(f"room_lock:{name}")
