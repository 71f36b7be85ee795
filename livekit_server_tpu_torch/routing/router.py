"""Routers: room→node mapping + participant signal start.

A copy of the JAX package's routing/router.py.

Reference parity: pkg/routing interfaces (interfaces.go:83-114 Router /
MessageRouter), LocalRouter (localrouter.go:32-147) for single-node, and
the Redis-backed router (redisrouter.go:48-311) for multi-node — node
registry, room pinning, signal relay, keep-alive stats. The KVRouter here
runs the same protocol over a MessageBus; with MemoryBus it reproduces the
reference's multi-node tests (N nodes, one process) and with a real KV it
scales to hosts.

Signal relay: StartParticipantSignal returns (connection_id, request_sink,
response_source). On the RTC-node side the registered session handler is
invoked with mirrored channels (signal.go RelaySignal stream semantics:
sequence-numbered envelopes, drop-on-overflow).
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Protocol

from livekit_server_tpu_torch.routing.kv import MemoryBus, MessageBus
from livekit_server_tpu_torch.routing.messagechannel import MessageChannel
from livekit_server_tpu_torch.routing.node import LocalNode, NodeState
from livekit_server_tpu_torch.routing.selector import NodeSelector
from livekit_server_tpu_torch.utils import ids

NODES_KEY = "nodes"            # redisrouter.go NodesKey hash
NODE_ROOM_KEY = "room_node_map"  # NodeRoomKey hash
STATS_MAX_AGE = 30.0
# Liveness lease: a TTL key refreshed with every stats heartbeat. Expiry
# marks a node dead within lease_ttl (~3 heartbeats) instead of the 30 s
# registry staleness window — the signal room failover keys off.
NODE_LEASE_PREFIX = "node_lease:"

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
    async def try_takeover(self, room_name: str, dead_node_id: str = "") -> str: ...
    async def is_node_alive(self, node_id: str) -> bool: ...
    async def dead_room_pins(self) -> list[tuple[str, str]]: ...
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

    async def try_takeover(self, room_name: str, dead_node_id: str = "") -> str:
        """Re-home a room whose pinned node died; returns the node that
        actually owns it afterwards. Single-node: always us."""
        self._room_nodes[room_name] = self.local_node.node_id
        return self.local_node.node_id

    async def is_node_alive(self, node_id: str) -> bool:
        return node_id == self.local_node.node_id

    async def dead_room_pins(self) -> list[tuple[str, str]]:
        """(room, node_id) pairs pinned to nodes that are no longer alive.
        Single-node: every pin is ours, so never any."""
        return []

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


class KVRouter(LocalRouter):
    """Multi-node router over a MessageBus (redisrouter.go:48).

    Nodes register in the NODES_KEY hash, heartbeat stats every
    `stats_interval`, pin rooms in NODE_ROOM_KEY, and relay signal messages
    over per-connection pub/sub channels with sequence numbers
    (signal.go:220-239 seq reconciliation: gaps are surfaced as relay
    errors rather than silently reordered).
    """

    def __init__(
        self,
        local_node: LocalNode,
        bus: MessageBus,
        stats_interval: float = 2.0,
        lease_ttl: float = 6.0,
    ):
        super().__init__(local_node)
        self.bus = bus
        self.stats_interval = stats_interval
        self.lease_ttl = lease_ttl
        # Ownership fence (routing/fleet.py RoomFence), attached by the
        # fleet plane. When present, every pin move rides an epoch CAS.
        self.fence = None
        # Monotonic stamp of the last lease refresh that reached the bus,
        # plus an async observer fed after EVERY attempt (ok or not) —
        # the self-fencing signal (service/fleetplane.py LeaseGuard).
        self.last_lease_ok = time.monotonic()
        self.on_lease: Callable[[bool], Awaitable[None]] | None = None
        self._stats_task: asyncio.Task | None = None
        self._session_task: asyncio.Task | None = None
        self._session_sub = None

    def _lease_key(self, node_id: str) -> str:
        return NODE_LEASE_PREFIX + node_id

    # -- node registry --------------------------------------------------
    async def register_node(self) -> None:
        self.local_node.stats.updated_at = time.time()
        await self.bus.hset(NODES_KEY, self.local_node.node_id, json.dumps(self.local_node.to_dict()))
        await self.bus.set(self._lease_key(self.local_node.node_id), "1", self.lease_ttl)
        self._session_sub = self.bus.subscribe(f"node_session:{self.local_node.node_id}")
        self._stats_task = self._track(asyncio.ensure_future(self._stats_worker()))
        self._session_task = self._track(asyncio.ensure_future(self._session_worker()))

    async def unregister_node(self) -> None:
        if self._stats_task:
            self._stats_task.cancel()
        if self._session_task:
            self._session_task.cancel()
        if self._session_sub is not None:
            self._session_sub.close()
        await self.bus.delete(self._lease_key(self.local_node.node_id))
        await self.bus.hdel(NODES_KEY, self.local_node.node_id)

    async def remove_dead_nodes(self) -> None:
        """redisrouter.go RemoveDeadNodes — reap stale registry entries."""
        for node in await self.list_nodes():
            if not node.is_available(STATS_MAX_AGE) and node.node_id != self.local_node.node_id:
                await self.bus.hdel(NODES_KEY, node.node_id)

    async def _stats_worker(self) -> None:
        while True:
            await asyncio.sleep(self.stats_interval)
            self.local_node.stats.updated_at = time.time()
            self.local_node.stats.mono_at = time.monotonic()
            ok = True
            try:
                await self.bus.hset(
                    NODES_KEY, self.local_node.node_id, json.dumps(self.local_node.to_dict())
                )
                await self.bus.set(self._lease_key(self.local_node.node_id), "1", self.lease_ttl)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — a severed/partitioned bus
                # must not kill the heartbeat task: the failed attempt IS
                # the signal the lease observer fences on, and the worker
                # must keep probing so recovery is observed too.
                ok = False
            if ok:
                self.last_lease_ok = time.monotonic()
            if self.on_lease is not None:
                try:
                    await self.on_lease(ok)
                except Exception:  # noqa: BLE001 — observer bugs must not
                    pass           # stop the lease heartbeat itself

    async def list_nodes(self) -> list[LocalNode]:
        raw = await self.bus.hgetall(NODES_KEY)
        return [LocalNode.from_dict(json.loads(v)) for v in raw.values()]

    # -- room pinning ---------------------------------------------------
    async def get_node_for_room(self, room_name: str) -> str:
        return await self.bus.hget(NODE_ROOM_KEY, room_name) or ""

    async def set_node_for_room(self, room_name: str, node_id: str) -> None:
        """Move a room pin. With a fence attached the pin only moves
        behind an epoch CAS: pinning to ourselves claims the next epoch,
        pinning elsewhere (migration COMMIT) transfers it — so the pin
        and the ownership epoch advance together and a concurrent
        claimant makes this raise instead of silently split-braining."""
        if self.fence is not None:
            from livekit_server_tpu_torch.routing.fleet import FencedWriteRejected

            if node_id == self.local_node.node_id:
                moved = await self.fence.claim(room_name)
            else:
                moved = await self.fence.transfer(room_name, node_id)
            if not moved:
                raise FencedWriteRejected(room_name)
        await self.bus.hset(NODE_ROOM_KEY, room_name, node_id)

    async def clear_room_state(self, room_name: str) -> None:
        if self.fence is not None and self.fence.owns(room_name):
            await self.fence.release(room_name)
        await self.bus.hdel(NODE_ROOM_KEY, room_name)

    async def try_takeover(self, room_name: str, dead_node_id: str = "") -> str:
        """Serialized dead-node re-home: concurrent joins on different
        live nodes race to a setnx lock; exactly one rewrites the pin and
        releases the lock, the others route to the winner (prevents a
        split-brain room existing on two nodes at once). If the winner
        itself dies mid-takeover the lock TTL expires and the losers
        re-race, so a crash can delay — but never wedge — the re-home."""
        lock_key = f"takeover:{room_name}"
        for _ in range(10):
            if await self.bus.setnx(lock_key, self.local_node.node_id, 5.0):
                from livekit_server_tpu_torch.routing.fleet import FencedWriteRejected

                try:
                    await self.set_node_for_room(room_name, self.local_node.node_id)
                except FencedWriteRejected:
                    # The epoch CAS lost to a restorer on the other
                    # election path (the orchestrator's create-lock):
                    # back off cleanly to whoever holds the epoch now.
                    await self.bus.delete(lock_key)
                    if self.fence is not None:
                        _epoch, holder = await self.fence.read(room_name)
                        if holder:
                            return holder
                    return await self.get_node_for_room(room_name) or self.local_node.node_id
                await self.bus.delete(lock_key)
                from livekit_server_tpu_torch.utils.logger import log

                log.info("room takeover", room=room_name,
                         dead_node=dead_node_id[:12],
                         new_node=self.local_node.node_id[:12])
                return self.local_node.node_id
            # Lost the race: wait for the winner to release (or for its
            # TTL to lapse if it crashed), then read the new pin.
            for _ in range(300):
                if await self.bus.get(lock_key) is None:
                    break
                await asyncio.sleep(0.02)
            winner = await self.get_node_for_room(room_name)
            if winner and winner != dead_node_id:
                return winner
            # Pin still points at the dead node ⇒ the lock holder crashed
            # before repinning; race again.
        return await self.get_node_for_room(room_name) or self.local_node.node_id

    async def is_node_alive(self, node_id: str) -> bool:
        """One-field liveness probe for the join hot path (vs. fetching
        and parsing the whole registry).

        A node is alive when its registry entry exists AND either its
        lease key is live or its heartbeat is fresh within lease_ttl.
        The lease is the fast-death signal (expires ~3 missed heartbeats
        after a crash); the heartbeat fallback keeps one lost lease write
        from marking a healthy node dead, since both are rewritten on the
        same cadence."""
        if node_id == self.local_node.node_id:
            return True
        raw = await self.bus.hget(NODES_KEY, node_id)
        if not raw:
            return False
        if await self.bus.get(self._lease_key(node_id)) is not None:
            return True
        return LocalNode.from_dict(json.loads(raw)).is_available(self.lease_ttl)

    async def dead_room_pins(self) -> list[tuple[str, str]]:
        """(room, node_id) pairs whose pinned node's lease has lapsed —
        the failover worker's scan (see service/roommanager.py). Local
        pins are excluded: we cannot adjudicate our own death."""
        pins = await self.bus.hgetall(NODE_ROOM_KEY)
        alive_cache: dict[str, bool] = {}
        dead: list[tuple[str, str]] = []
        for room, node_id in pins.items():
            if not node_id or node_id == self.local_node.node_id:
                continue
            if node_id not in alive_cache:
                alive_cache[node_id] = await self.is_node_alive(node_id)
            if not alive_cache[node_id]:
                dead.append((room, node_id))
        return dead

    # -- signal relay ---------------------------------------------------
    async def start_participant_signal(
        self, room_name: str, init: ParticipantInit
    ) -> tuple[str, MessageChannel, MessageChannel]:
        node_id = await self.get_node_for_room(room_name)
        if not node_id:
            raise RouterError(f"no node for room {room_name}")
        if node_id == self.local_node.node_id and self._handler is not None:
            return await super().start_participant_signal(room_name, init)

        connection_id = ids.new_connection_id()
        init.connection_id = connection_id
        req = MessageChannel(connection_id=connection_id)
        resp = MessageChannel(connection_id=connection_id)
        resp_sub = self.bus.subscribe(f"signal_resp:{connection_id}")

        await self.bus.publish(
            f"node_session:{node_id}",
            json.dumps({"room": room_name, "init": init.to_dict()}),
        )
        # The RTC node publishes {"ready"} once it has subscribed to the
        # request channel; holding requests until then closes the race where
        # a fast first message (seq=1) is published before anyone listens
        # and the seq check tears the session down.
        ready = asyncio.Event()

        async def pump_requests():
            seq = 0
            try:
                try:
                    await asyncio.wait_for(ready.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    pass  # proceed; the RTC node may be older/acks-less
                while True:
                    msg = await req.read_message()
                    seq += 1
                    await self.bus.publish(
                        f"signal_req:{connection_id}", json.dumps({"seq": seq, "msg": msg})
                    )
            except Exception:
                await self.bus.publish(f"signal_req:{connection_id}", json.dumps({"close": True}))

        async def pump_responses():
            expect = 0
            try:
                async for raw in resp_sub:
                    env = json.loads(raw)
                    if env.get("ready"):
                        ready.set()
                        continue
                    if env.get("close"):
                        break
                    expect += 1
                    if env["seq"] != expect:
                        break  # relay gap ⇒ force client reconnect (signal.go:232)
                    resp.write_message(env["msg"])
            finally:
                resp.close()
                resp_sub.close()

        self._track(asyncio.ensure_future(pump_requests()))
        self._track(asyncio.ensure_future(pump_responses()))
        return connection_id, req, resp

    async def _session_worker(self) -> None:
        """RTC-node side: receive session starts, bridge bus↔handler."""
        assert self._session_sub is not None
        async for raw in self._session_sub:
            msg = json.loads(raw)
            if self._handler is None:
                continue
            init = ParticipantInit.from_dict(msg["init"])
            connection_id = init.connection_id
            req = MessageChannel(connection_id=connection_id)
            resp = MessageChannel(connection_id=connection_id)
            req_sub = self.bus.subscribe(f"signal_req:{connection_id}")
            # Ack: request channel is live — the signal node may now pump.
            await self.bus.publish(f"signal_resp:{connection_id}", json.dumps({"ready": True}))

            async def pump_in(req_sub=req_sub, req=req):
                expect = 0
                try:
                    async for raw_req in req_sub:
                        env = json.loads(raw_req)
                        if env.get("close"):
                            break
                        expect += 1
                        if env["seq"] != expect:
                            break  # dropped request envelope ⇒ kill session,
                            # client reconnects (signal.go:232 semantics)
                        req.write_message(env["msg"])
                finally:
                    req.close()
                    req_sub.close()

            async def pump_out(resp=resp, connection_id=connection_id):
                seq = 0
                try:
                    while True:
                        msg_out = await resp.read_message()
                        seq += 1
                        await self.bus.publish(
                            f"signal_resp:{connection_id}",
                            json.dumps({"seq": seq, "msg": msg_out}),
                        )
                except Exception:
                    await self.bus.publish(
                        f"signal_resp:{connection_id}", json.dumps({"close": True})
                    )

            self._track(asyncio.ensure_future(pump_in()))
            self._track(asyncio.ensure_future(pump_out()))
            self._track(
                asyncio.ensure_future(self._handler(msg["room"], msg["init"], req, resp))
            )

    async def drain(self) -> None:
        self.local_node.state = NodeState.SHUTTING_DOWN
        await self.bus.hset(NODES_KEY, self.local_node.node_id, json.dumps(self.local_node.to_dict()))


def create_router(
    local_node: LocalNode,
    bus: MessageBus | None,
    lease_ttl: float = 6.0,
    stats_interval: float = 2.0,
) -> Router:
    """interfaces.go:116 CreateRouter — bus present ⇒ distributed."""
    if bus is None:
        return LocalRouter(local_node)
    return KVRouter(local_node, bus, stats_interval=stats_interval, lease_ttl=lease_ttl)
