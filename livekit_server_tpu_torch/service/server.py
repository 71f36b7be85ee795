"""Server assembly + lifecycle.

Reference parity: pkg/service/server.go (LivekitServer :46-61, Start
:170-293, Stop :295-316, health :351-364) and the Wire DI graph
(wire_gen.go:38-138) — here plain constructor wiring in create_server().
Endpoints: /rtc (WS signal+media), /twirp/livekit.RoomService/* (admin),
/ (health), /metrics (prometheus text format), /debug/rooms,
/debug/overload (the governor), /debug/integrity (the audit, the repair
ladder, the checkpoint codec, restart causes), /debug/migration and
/debug/fleet (the multi-node plane).

Port of the JAX package's service/server.py. `create_server(cfg,
device=...)` builds the port's RoomManager on `device` ("cuda" by
default) and, with `kv.kind: tcp` (or an injected `bus`), the multi-node
router, store and planes over the shared bus (`connect_bus`). Routes
whose subsystem the port does not carry yet are left out (ROADMAP A): the
agents, egress, ingress and SIP services, ioinfo, /debug/compiles and
/debug/trace. The UDP media transport and the TCP fallback open at start
(RoomManager.start_transports) on rtc.udp_port and rtc.tcp_port, with
the express lane attached (plane.express_max_subs > 0) and the embedded
media relay beside them (relay.enabled); both are off by default.
"""

from __future__ import annotations

import asyncio
import time

from aiohttp import web

from livekit_server_tpu_torch.config.config import Config, ConfigError
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
from livekit_server_tpu_torch.service.roomservice import RoomServiceAPI
from livekit_server_tpu_torch.service.rtcservice import RTCService
from livekit_server_tpu_torch.service.store import KVStore, LocalStore
from livekit_server_tpu_torch.telemetry import TelemetryService
from livekit_server_tpu_torch.version import __version__


class LivekitServer:
    def __init__(self, config: Config, router, store, room_manager, telemetry):
        self.config = config
        self.router = router
        self.store = store
        self.room_manager: RoomManager = room_manager
        self.telemetry: TelemetryService = telemetry
        from livekit_server_tpu_torch.utils.logger import Logger, configure

        self.rtc_service = RTCService(self)
        self.room_api = RoomServiceAPI(self)
        configure(config.log_level)
        self.log = Logger(node=router.local_node.node_id[:12])
        room_manager.log = self.log
        room_manager.runtime.blackbox.log = self.log
        self.app = web.Application(middlewares=[self._request_hooks])
        self.app.router.add_get("/", self.health)
        self.app.router.add_get("/rtc", self.rtc_service.handle)
        self.app.router.add_get("/rtc/validate", self.validate)
        self.app.router.add_post(
            "/twirp/livekit.RoomService/{method}", self.room_api.handle
        )
        self.app.router.add_get("/metrics", self.metrics)
        self.app.router.add_get("/debug/rooms", self.debug_rooms)
        self.app.router.add_get("/debug/analytics", self.debug_analytics)
        self.app.router.add_get("/debug/tasks", self.debug_tasks)
        self.app.router.add_get("/debug/ticks", self.debug_ticks)
        self.app.router.add_get("/debug/overload", self.debug_overload)
        self.app.router.add_get("/debug/pager", self.debug_pager)
        self.app.router.add_get("/debug/integrity", self.debug_integrity)
        self.app.router.add_get("/debug/migration", self.debug_migration)
        self.app.router.add_get("/debug/fleet", self.debug_fleet)
        self.app.router.add_get("/debug/egress", self.debug_egress)
        self.app.router.add_get("/debug/blackbox/{room}", self.debug_blackbox)
        self._runner: web.AppRunner | None = None
        self._sites: list[web.TCPSite] = []
        self._stats_task: asyncio.Task | None = None
        self.started_at = 0.0

    # -- selector ---------------------------------------------------------
    def select_node(self) -> LocalNode | None:
        """Pick an RTC node for a new room (roomallocator.go)."""
        nodes = getattr(self, "_node_cache", None) or [self.router.local_node]
        try:
            return self._selector.select_node(nodes)
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

    def room_manager_media_queue(self, room_name: str, identity: str):
        room = self.room_manager.rooms.get(room_name)
        if room is None:
            return None
        p = room.participants.get(identity)
        return getattr(p, "media_queue", None) if p else None

    # -- endpoints --------------------------------------------------------
    async def health(self, request: web.Request) -> web.Response:
        # server.go:351 — 406 when node stats are stale
        age = time.time() - self.router.local_node.stats.updated_at
        if age > 4.0 and self.started_at and time.time() - self.started_at > 4.0:
            return web.Response(status=406, text=f"node stats stale ({age:.1f}s)")
        return web.Response(text="OK")

    async def validate(self, request: web.Request) -> web.Response:
        """rtcservice.go validate — join preflight without upgrading."""
        from livekit_server_tpu_torch.auth import TokenError, verify_token

        token = request.query.get("access_token", "")
        try:
            claims = verify_token(token, self.config.keys)
        except TokenError as e:
            return web.Response(status=401, text=str(e))
        if not claims.video.room_join:
            return web.Response(status=401, text="token lacks roomJoin")
        return web.Response(text="success")

    @web.middleware
    async def _request_hooks(self, request: web.Request, handler):
        """Twirp request logging + status metrics (the TwirpLogger /
        request-status hooks of service/server.go's Twirp server options)."""
        t0 = time.perf_counter()
        status = 500
        try:
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            status = e.status
            raise
        except asyncio.CancelledError:
            status = 499  # client went away; not a server error
            raise
        finally:
            if request.path.startswith("/twirp/"):
                svc = request.path.split("/")[2]
                method = request.match_info.get("method", "")
                self.telemetry.add(
                    "livekit_twirp_requests_total",
                    service=svc, method=method, status=str(status),
                )
                self.log.info(
                    "twirp", service=svc, method=method, status=status,
                    dur_ms=round((time.perf_counter() - t0) * 1000.0, 2),
                )

    async def debug_tasks(self, request: web.Request) -> web.Response:
        """Asyncio task dump (the pprof goroutine-profile analog, §5.1)."""
        tasks = []
        for t in asyncio.all_tasks():
            tasks.append({
                "name": t.get_name(),
                "done": t.done(),
                "coro": str(getattr(t.get_coro(), "__qualname__", t.get_coro())),
            })
        return web.json_response({"count": len(tasks), "tasks": tasks})

    async def debug_ticks(self, request: web.Request) -> web.Response:
        """Recent tick timing breakdown (§5.1 profiling surface): totals
        plus the per-tick pipeline-stage split (stage/device/fanout ms,
        depth, late) so an overlap regression is visible per stage rather
        than inferred from host_ms_per_tick."""
        rt = self.room_manager.runtime
        body = {
            "tick_ms": rt.tick_ms,
            "stats": rt.stats,
            "pipeline_depth": 0 if rt.low_latency else 1,
            "recent_tick_s": list(getattr(rt, "recent_tick_s", [])),
            "recent_ticks": list(getattr(rt, "recent_ticks", [])),
        }
        body["sleep_bias_us"] = round(
            max(getattr(rt, "_sleep_bias", 0.0), 0.0) * 1e6, 1
        )
        body["edge_overshoot_us"] = round(
            getattr(rt, "_edge_overshoot_us", 0.0), 1
        )
        if rt.wire_stages is not None:
            # Per-stage wire-latency decomposition (sampled attribution).
            body["wire_stages"] = rt.wire_stages.summary()
        udp = self.room_manager.udp
        if udp is not None:
            # Measured wall-clock packet-in→wire-out latency (includes
            # tick-queueing wait) — the probe in runtime/udp.py.
            body["forward_latency"] = udp.fwd_latency.summary()
        if rt.express is not None:
            body["express"] = rt.express.debug()
            if udp is not None:
                # Express twin: arrival-driven, no tick-queue wait.
                body["forward_latency_express"] = udp.fwd_latency_express.summary()
        return web.json_response(body)

    async def debug_blackbox(self, request: web.Request) -> web.Response:
        """One room's black-box flight-recorder lane ({room} is a room
        name, a row index, or `node` for the node lane), plus the
        retained automatic dumps."""
        rt = self.room_manager.runtime
        bb = rt.blackbox
        key = request.match_info["room"]
        if key == "node":
            row = bb.NODE
        else:
            room = self.room_manager.rooms.get(key)
            if room is not None:
                row = room.slots.row
            else:
                try:
                    row = int(key)
                except ValueError:
                    return web.json_response(
                        {"error": f"unknown room {key!r}"}, status=404
                    )
                if not 0 <= row < rt.dims.rooms:
                    return web.json_response(
                        {"error": f"row {row} out of range"}, status=404
                    )
        return web.json_response({
            "room": key,
            "row": row,
            "events": bb.dump(row),
            "dumps_total": bb.dumps,
            "last_dumps": list(bb.last_dumps),
        })

    async def metrics(self, request: web.Request) -> web.Response:
        # Recovery-machinery gauges sampled at scrape time: bus transport
        # churn lives on the client object, plane restarts on the
        # supervisor (livekit_plane_restarts_total / _room_failovers_total
        # counters are emitted by their owners via telemetry.add).
        bus = getattr(self.router, "bus", None)
        if bus is not None and hasattr(bus, "retries"):
            self.telemetry.set_gauge("livekit_bus_retries_total", bus.retries)
            self.telemetry.set_gauge("livekit_bus_reconnects_total", bus.reconnects)
        self.telemetry.observe_queue_drops()
        return web.Response(
            text=self.telemetry.prometheus_text(), content_type="text/plain"
        )

    async def debug_overload(self, request: web.Request) -> web.Response:
        """Overload-governor state: ladder level, recent transitions,
        split ingest drop counters, admission rejections, bus/signal
        back-pressure drops, and the active limits."""
        from dataclasses import asdict

        from livekit_server_tpu_torch.routing.kv import Subscription
        from livekit_server_tpu_torch.routing.messagechannel import MessageChannel

        rm = self.room_manager
        gov = rm.governor
        ing = rm.runtime.ingest
        return web.json_response({
            "governor": gov.snapshot() if gov is not None else None,
            "ingest": {
                "dropped_capacity": ing.dropped_capacity,
                "dropped_fault": ing.dropped_fault,
                "dropped_policed": ing.dropped_policed,
            },
            "admission_rejected": dict(rm.admission_rejected),
            "admission_denied_reasons": dict(rm.admission_denied_reasons),
            "queue_drops": {
                "signal_channel": MessageChannel.total_dropped,
                "bus_subscription": Subscription.total_dropped,
            },
            "supervisor_restarts": rm.supervisor.restarts if rm.supervisor is not None else 0,
            "limits": asdict(self.config.limits),
        })

    async def debug_fleet(self, request: web.Request) -> web.Response:
        """Fleet-plane state: fence flag + lease age, owned room epochs,
        and the fencing / failover-election / rebalance counters."""
        fleet = self.room_manager.fleet
        return web.json_response(
            {
                "enabled": fleet is not None,
                "fleet": fleet.snapshot() if fleet is not None else None,
            }
        )

    async def debug_migration(self, request: web.Request) -> web.Response:
        """Migration-plane state: drain flag, in-flight handoffs with
        their epochs, pending adoptions, and the lifetime counters
        (commits, rollbacks, NACKs, bridged packets, stale-epoch drops)."""
        mig = self.room_manager.migration
        return web.json_response(
            {
                "enabled": mig is not None,
                "migration": mig.snapshot() if mig is not None else None,
                "frozen_rows": sorted(self.room_manager.runtime.ingest.frozen_rows),
            }
        )

    async def debug_integrity(self, request: web.Request) -> web.Response:
        """State-integrity plane: audits run, violations by rule, the
        quarantine/repair ladder's outcomes, checkpoint checksum failures
        + generation fallbacks, and supervisor restart causes."""
        from livekit_server_tpu_torch.utils.checksum import CodecStats

        rm = self.room_manager
        sup = rm.supervisor
        integ = self.config.integrity
        return web.json_response({
            "integrity": rm.integrity_stats() if rm.integrity is not None else None,
            "checksum": {
                "frames_encoded": CodecStats.frames_encoded,
                "frames_verified": CodecStats.frames_verified,
                "verify_failures": CodecStats.verify_failures,
            },
            "restart_causes": dict(sup.restart_causes) if sup is not None else {},
            "supervisor_ckpt_fallbacks": sup.ckpt_fallbacks if sup is not None else 0,
            "room_ckpt_fallbacks": rm.ckpt_fallbacks,
            "config": {
                "enabled": integ.enabled,
                "audit_every_ticks": integ.audit_every_ticks,
                "max_row_repairs": integ.max_row_repairs,
                "storm_threshold": integ.storm_threshold,
                "checkpoint_generations": integ.checkpoint_generations,
            },
        })

    async def debug_egress(self, request: web.Request) -> web.Response:
        """Sharded egress plane: host_egress_pps, shard plan, canonical
        grouping rates, per-shard sent/busy totals, and the last tick's
        per-shard send + munge breakdowns."""
        rm = self.room_manager
        snap = rm.runtime.egress_plane.observe()
        if rm.udp is not None:
            snap["tx_total"] = rm.udp.stats.get("tx", 0)
            snap["tx_drop_total"] = rm.udp.stats.get("tx_drop", 0)
        return web.json_response(snap)

    async def debug_pager(self, request: web.Request) -> web.Response:
        """Paged room-state plane: page-pool occupancy/fragmentation,
        allocator churn counters, per-room page extents, and per-resource
        slot occupancy. `paged: false` (with the dense slot occupancy)
        when the plane runs the dense layout."""
        rm = self.room_manager
        rt = rm.runtime
        pager_stats = getattr(rt, "pager_stats", None)
        body: dict = {
            "paged": pager_stats is not None,
            "occupancy": rt.occupancy(),
        }
        if pager_stats is not None:
            body["pool"] = pager_stats()
            pager = rt.pager
            body["rooms"] = {
                room.name: {
                    "row": room.slots.row,
                    "pages": [int(p) for p in pager.pages_of_room(room.slots.row)],
                    "extent": tuple(pager.extent(room.slots.row)),
                }
                for room in rm.rooms.values()
            }
        return web.json_response(body)

    async def debug_analytics(self, request: web.Request) -> web.Response:
        """Recent per-track analytics records (statsworker.go stream seat)."""
        try:
            n = max(0, int(request.query.get("n", 100)))
        except ValueError:
            return web.Response(status=400, text="n must be an integer")
        return web.json_response(
            {"track_stats": self.telemetry.track_stats[-n:] if n else []}
        )

    async def debug_rooms(self, request: web.Request) -> web.Response:
        rm = self.room_manager
        return web.json_response(
            {
                "node": self.router.local_node.node_id,
                "version": __version__,
                "rooms": {
                    name: {
                        "row": r.slots.row,
                        "participants": list(r.participants),
                        "tracks": list(r.tracks),
                        "traffic": rm.participant_traffic(r),
                    }
                    for name, r in rm.rooms.items()
                },
                "plane": rm.runtime.stats,
                "ingest_dropped": rm.runtime.ingest.dropped,
            }
        )

    # -- lifecycle --------------------------------------------------------
    async def start(self) -> None:
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
        await self.room_manager.runtime.step_once()
        self.room_manager.runtime.mark_warm()
        # Native UDP media transport on the RTC port, and the TCP fallback.
        await self.room_manager.start_transports()
        await self.room_api.start()
        self.room_manager.start()
        self._stats_task = asyncio.ensure_future(self._refresh_nodes())
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        for addr in self.config.bind_addresses:
            site = web.TCPSite(self._runner, addr, self.config.port)
            await site.start()
            self._sites.append(site)
        self.started_at = time.time()

    async def stop(self, force: bool = False) -> None:
        self.router.local_node.state = NodeState.SHUTTING_DOWN
        await self.router.drain()
        mig = self.room_manager.migration
        if not force and mig is not None:
            # Graceful stop IS a node drain: every local room migrates to
            # a peer through the two-phase handoff (bounded concurrency,
            # admissions refused throughout); rooms with no willing peer
            # stay and are torn down by room_manager.stop() below.
            try:
                await mig.drain_node()
            except Exception as e:  # noqa: BLE001 — stopping anyway
                self.log.warn("graceful drain failed", error=str(e))
        elif not force:
            # Bus-less single node: nobody to migrate to. Wait briefly for
            # participants to leave on their own (server.go:295).
            for _ in range(50):
                if not any(r.participants for r in self.room_manager.rooms.values()):
                    break
                await asyncio.sleep(0.1)
        if self._stats_task:
            self._stats_task.cancel()
        self.room_manager.close_transports()
        await self.room_api.stop()
        await self.room_manager.stop()
        await self.router.unregister_node()
        if self._runner is not None:
            await self._runner.cleanup()

    @property
    def port(self) -> int:
        return self.config.port


async def connect_bus(config: Config):
    """Resolve the configured multi-node bus (redisrouter's Redis client
    seat): kv.kind == "tcp" dials the in-repo BusServer at kv.address."""
    if config.kv.kind == "tcp":
        if not config.kv.address:
            # Booting a cluster-configured node standalone would silently
            # split-brain it out of the cluster; fail loudly instead.
            raise ConfigError("kv.kind is 'tcp' but kv.address is empty")
        from livekit_server_tpu_torch.routing.tcpbus import TCPBusClient

        return await TCPBusClient.connect_address(
            config.kv.address, token=config.kv.auth_token
        )
    if config.kv.kind in ("", "memory"):
        return None
    # An unknown kind must not fall through to a private in-process bus —
    # the node would boot "clustered" against a registry only it can see.
    raise ConfigError(
        f"unsupported kv.kind {config.kv.kind!r}: no external KV client is "
        "bundled; run `python -m livekit_server_tpu_torch bus` and use kv.kind='tcp'"
    )


def create_server(config: Config, bus=None, device="cuda") -> LivekitServer:
    """The Wire graph (wire_gen.go InitializeServer) as explicit wiring:
    with kv.kind 'memory' and no `bus`, the single-node router and store;
    otherwise the KV router and store over `bus` (a private MemoryBus when
    none is given). The media plane runs on `device`."""
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
    rm = RoomManager(config, router, store, telemetry=telemetry, device=device)
    server = LivekitServer(config, router, store, rm, telemetry)
    server._selector = create_selector(config.node_selector, config.region)
    if rm.migration is not None:
        # Drain-target ranking reuses the placement selector, so a drain
        # spreads rooms the same way the router places new ones.
        rm.migration.selector = server._selector
    return server
