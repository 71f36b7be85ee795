"""Router: room→node mapping + participant signal start.

Reference parity: pkg/routing interfaces (interfaces.go:83-114 Router /
MessageRouter) and LocalRouter (localrouter.go:32-147), the single-node
router. The multi-node router over a shared bus (redisrouter.go) waits
for the bus (ROADMAP A13).

Signal start: start_participant_signal returns (connection_id,
request_sink, response_source); the registered session handler is invoked
with the same channels.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Protocol

from livekit_server_tpu_torch.routing.messagechannel import MessageChannel
from livekit_server_tpu_torch.routing.node import LocalNode, NodeState
from livekit_server_tpu_torch.utils import ids

# handler(room_name, participant_init, request_source, response_sink)
SessionHandler = Callable[[str, dict, MessageChannel, MessageChannel], Awaitable[None]]


class RouterError(Exception):
    pass


@dataclass
class ParticipantInit:
    """routing.ParticipantInit (interfaces.go) — session start params."""

    identity: str
    name: str = ""
    reconnect: bool = False
    reconnect_reason: int = 0
    auto_subscribe: bool = True
    client_info: dict | None = None
    grants: dict | None = None
    region: str = ""
    connection_id: str = ""

    def to_dict(self) -> dict:
        return vars(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ParticipantInit":
        return cls(**d)


class Router(Protocol):
    local_node: LocalNode

    async def register_node(self) -> None: ...
    async def unregister_node(self) -> None: ...
    async def list_nodes(self) -> list[LocalNode]: ...
    async def get_node_for_room(self, room_name: str) -> str: ...
    async def set_node_for_room(self, room_name: str, node_id: str) -> None: ...
    async def clear_room_state(self, room_name: str) -> None: ...
    def on_new_session(self, handler: SessionHandler) -> None: ...
    async def start_participant_signal(
        self, room_name: str, init: ParticipantInit
    ) -> tuple[str, MessageChannel, MessageChannel]: ...
    async def drain(self) -> None: ...


class LocalRouter:
    """Single-node router (localrouter.go:32): identity mapping, in-memory
    channels, no external bus."""

    def __init__(self, local_node: LocalNode):
        self.local_node = local_node
        self._handler: SessionHandler | None = None
        self._room_nodes: dict[str, str] = {}
        # Strong refs: the event loop only weakly references tasks, so
        # untracked fire-and-forget sessions could be GC'd mid-flight.
        self._tasks: set[asyncio.Task] = set()

    def _track(self, task: asyncio.Task) -> asyncio.Task:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def register_node(self) -> None:
        self.local_node.stats.updated_at = time.time()

    async def unregister_node(self) -> None:
        pass

    async def list_nodes(self) -> list[LocalNode]:
        return [self.local_node]

    async def get_node_for_room(self, room_name: str) -> str:
        return self._room_nodes.get(room_name, "")

    async def set_node_for_room(self, room_name: str, node_id: str) -> None:
        self._room_nodes[room_name] = node_id

    async def clear_room_state(self, room_name: str) -> None:
        self._room_nodes.pop(room_name, None)

    def on_new_session(self, handler: SessionHandler) -> None:
        self._handler = handler

    async def start_participant_signal(
        self, room_name: str, init: ParticipantInit
    ) -> tuple[str, MessageChannel, MessageChannel]:
        if self._handler is None:
            raise RouterError("no session handler registered")
        connection_id = ids.new_connection_id()
        init.connection_id = connection_id
        req = MessageChannel(connection_id=connection_id)
        resp = MessageChannel(connection_id=connection_id)
        self._track(asyncio.ensure_future(self._handler(room_name, init.to_dict(), req, resp)))
        return connection_id, req, resp

    async def drain(self) -> None:
        self.local_node.state = NodeState.SHUTTING_DOWN
