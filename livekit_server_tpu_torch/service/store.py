"""Room/participant object store.

Reference parity: pkg/service/interfaces.go ObjectStore +
localstore.go:28-170 (in-memory, single-node). The KV-backed store of
redisstore.go waits for the multi-node bus (ROADMAP A13).
"""

from __future__ import annotations

import json
import time
from typing import Protocol

from livekit_server_tpu_torch.protocol import models as pm


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
