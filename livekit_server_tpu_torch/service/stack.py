"""A node's serving stack without its HTTP face.

The router and store, the telemetry service, the RoomManager on the
plane's device, the placement selector, and the start and stop sequence
of the reference server (pkg/service/server.go Start :170-293, Stop
:295-316) less the HTTP listener and the Twirp services. `create_server`
(service/server.py) builds one and puts the aiohttp app on top of it;
the traffic twin (runtime/traffic_twin.py) runs nodes on it bare, so a
node needs no aiohttp, msgpack or PyYAML.
"""

from __future__ import annotations

import asyncio

from livekit_server_tpu_torch.config.config import Config
from livekit_server_tpu_torch.routing import (
    LocalNode,
    MemoryBus,
    NodeState,
    create_router,
    create_selector,
)
from livekit_server_tpu_torch.routing.node import sample_system_stats
from livekit_server_tpu_torch.routing.selector import NoNodesAvailable
from livekit_server_tpu_torch.service.roommanager import RoomManager
from livekit_server_tpu_torch.service.store import KVStore, LocalStore
from livekit_server_tpu_torch.telemetry import TelemetryService
from livekit_server_tpu_torch.utils.logger import Logger, configure


class NodeStack:
    """Router, store, telemetry and RoomManager of one node, with the
    placement selector and the node-stats refresh. `start` and `stop`
    take the services that open and close between the transports and the
    room manager (the server's ioinfo and room-service bus workers)."""

    def __init__(self, config: Config, router, store, room_manager: RoomManager,
                 telemetry: TelemetryService, selector):
        self.config = config
        self.router = router
        self.store = store
        self.room_manager = room_manager
        self.telemetry = telemetry
        self.selector = selector
        configure(config.log_level)
        self.log = Logger(node=router.local_node.node_id[:12])
        room_manager.log = self.log
        room_manager.runtime.blackbox.log = self.log
        self._node_cache: list[LocalNode] = []
        self._stats_task: asyncio.Task | None = None

    def select_node(self) -> LocalNode | None:
        """Pick an RTC node for a new room (roomallocator.go)."""
        try:
            return self.selector.select_node(self._node_cache or [self.router.local_node])
        except NoNodesAvailable:
            return None

    async def _refresh_nodes(self) -> None:
        while True:
            self._node_cache = await self.router.list_nodes()
            sample_system_stats(self.router.local_node.stats)
            # Per-participant traffic rates → NodeStats packet/byte rates
            # (participant_traffic_load.go cadence).
            self.room_manager.sample_traffic()
            await asyncio.sleep(2.0)

    async def start(self, services=()) -> None:
        rm = self.room_manager
        # Identify this node's bus connection to the BusServer before any
        # other op: the partition-injection harness severs/heals by node
        # id, and pub/sub sender attribution needs it.
        bus = getattr(self.router, "bus", None)
        if bus is not None and hasattr(bus, "set_ident"):
            bus.set_ident(self.router.local_node.node_id)
        await self.router.register_node()
        if hasattr(self.router, "remove_dead_nodes"):
            await self.router.remove_dead_nodes()
        # Warm step before accepting traffic: builds the CUDA kernels
        # (nvcc, once per process) and runs the first tick, so no session
        # waits on a build mid-call.
        await rm.runtime.step_once()
        rm.runtime.mark_warm()
        # Native UDP media transport on the RTC port, and the TCP fallback.
        await rm.start_transports()
        for service in services:
            await service.start()
        rm.start()
        self._stats_task = asyncio.ensure_future(self._refresh_nodes())

    async def stop(self, force: bool = False, services=()) -> None:
        rm = self.room_manager
        self.router.local_node.state = NodeState.SHUTTING_DOWN
        await self.router.drain()
        if not force and rm.migration is not None:
            # Graceful stop IS a node drain: every local room migrates to
            # a peer through the two-phase handoff (bounded concurrency,
            # admissions refused throughout); rooms with no willing peer
            # stay and are torn down by room_manager.stop() below.
            try:
                await rm.migration.drain_node()
            except Exception as e:  # noqa: BLE001 — stopping anyway
                self.log.warn("graceful drain failed", error=str(e))
        elif not force:
            # Bus-less single node: nobody to migrate to. Wait briefly for
            # participants to leave on their own (server.go:295).
            for _ in range(50):
                if not any(r.participants for r in rm.rooms.values()):
                    break
                await asyncio.sleep(0.1)
        if self._stats_task:
            self._stats_task.cancel()
        rm.close_transports()
        for service in services:
            await service.stop()
        await rm.stop()
        await self.router.unregister_node()


def create_stack(config: Config, bus=None, device="cuda", mesh=None) -> NodeStack:
    """The Wire graph (wire_gen.go InitializeServer) as explicit wiring:
    with kv.kind 'memory' and no `bus`, the single-node router and store;
    otherwise the KV router and store over `bus` (a private MemoryBus when
    none is given). The media plane runs on `device`, or over the shards
    of `mesh` (parallel/mesh.py `make_mesh`) when one is given."""
    node = LocalNode(region=config.region)
    sample_system_stats(node.stats)
    if bus is None and config.kv.kind == "memory":
        router = create_router(node, None)
        store = LocalStore()
    else:
        bus = bus if bus is not None else MemoryBus()
        router = create_router(
            node, bus,
            lease_ttl=config.kv.lease_ttl_s,
            stats_interval=config.kv.stats_interval_s,
        )
        store = KVStore(bus)
    telemetry = TelemetryService(config)
    rm = RoomManager(config, router, store, telemetry=telemetry, device=device, mesh=mesh)
    selector = create_selector(config.node_selector, config.region)
    if rm.migration is not None:
        # Drain-target ranking reuses the placement selector, so a drain
        # spreads rooms the same way the router places new ones.
        rm.migration.selector = selector
    return NodeStack(config, router, store, rm, telemetry, selector)
