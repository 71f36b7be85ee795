"""Server assembly + lifecycle.

Reference parity: pkg/service/server.go (LivekitServer :46-61, Start
:170-293, Stop :295-316, health :351-364) and the Wire DI graph
(wire_gen.go:38-138) — here plain constructor wiring in create_server().
Endpoints: /rtc (WS signal+media), /twirp/livekit.RoomService/* (admin),
/agent (agent workers' WS), /twirp/livekit.{Egress,Ingress,SIP}/*,
/ (health), /metrics (prometheus text format), /debug/rooms,
/debug/overload (the governor), /debug/integrity (the audit, the repair
ladder, the checkpoint codec, restart causes), /debug/migration and
/debug/fleet (the multi-node plane).

Port of the JAX package's service/server.py. `create_server(cfg,
device=...)` builds the port's RoomManager on `device` ("cuda" by
default) and, with `kv.kind: tcp` (or an injected `bus`), the multi-node
router, store and planes over the shared bus (`connect_bus`). The
egress/ingress status aggregator (service/ioinfo.py) starts and stops
with the server. Everything but HTTP (the wiring, the start and stop
sequence) is the node stack of service/stack.py, which the traffic twin
runs without this module. /debug/trace exports the tick-span ring as
Chrome trace events (telemetry/trace_export.py). The route whose
subsystem the port does not carry yet is left out (ROADMAP A11):
/debug/compiles. The UDP media transport and the TCP fallback open at
start (RoomManager.start_transports) on rtc.udp_port and rtc.tcp_port,
with the express lane attached (plane.express_max_subs > 0) and the
embedded media relay beside them (relay.enabled); both are off by
default.
"""

from __future__ import annotations

import asyncio
import time

from aiohttp import web

from livekit_server_tpu_torch.config.config import Config, ConfigError
from livekit_server_tpu_torch.routing import LocalNode
from livekit_server_tpu_torch.service.roommanager import RoomManager
from livekit_server_tpu_torch.service.roomservice import RoomServiceAPI
from livekit_server_tpu_torch.service.rtcservice import RTCService
from livekit_server_tpu_torch.service.stack import NodeStack, create_stack
from livekit_server_tpu_torch.telemetry import TelemetryService
from livekit_server_tpu_torch.version import __version__


class LivekitServer:
    def __init__(self, stack: NodeStack):
        self.stack = stack
        self.config: Config = stack.config
        self.router = stack.router
        self.store = stack.store
        self.room_manager: RoomManager = stack.room_manager
        self.telemetry: TelemetryService = stack.telemetry
        self.log = stack.log
        from livekit_server_tpu_torch.service.agents import AgentService
        from livekit_server_tpu_torch.service.egress import EgressService
        from livekit_server_tpu_torch.service.ingress import IngressService
        from livekit_server_tpu_torch.service.ioinfo import IOInfoService
        from livekit_server_tpu_torch.service.sip import SIPService

        self.rtc_service = RTCService(self)
        self.room_api = RoomServiceAPI(self)
        self.egress = EgressService(self)
        self.ingress = IngressService(self)
        self.sip = SIPService(self)
        self.ioinfo = IOInfoService(self)
        self.agents = AgentService(self)
        self.room_manager.agents = self.agents
        self.app = web.Application(middlewares=[self._request_hooks])
        self.app.router.add_get("/", self.health)
        self.app.router.add_get("/rtc", self.rtc_service.handle)
        self.app.router.add_get("/rtc/validate", self.validate)
        self.app.router.add_get("/agent", self.agents.handle)
        self.app.router.add_post(
            "/twirp/livekit.RoomService/{method}", self.room_api.handle
        )
        self.app.router.add_post("/twirp/livekit.Egress/{method}", self.egress.handle)
        self.app.router.add_post("/twirp/livekit.Ingress/{method}", self.ingress.handle)
        self.app.router.add_post("/twirp/livekit.SIP/{method}", self.sip.handle)
        self.app.router.add_get("/metrics", self.metrics)
        self.app.router.add_get("/debug/rooms", self.debug_rooms)
        self.app.router.add_get("/debug/analytics", self.debug_analytics)
        self.app.router.add_get("/debug/tasks", self.debug_tasks)
        self.app.router.add_get("/debug/ticks", self.debug_ticks)
        self.app.router.add_get("/debug/trace", self.debug_trace)
        self.app.router.add_get("/debug/overload", self.debug_overload)
        self.app.router.add_get("/debug/pager", self.debug_pager)
        self.app.router.add_get("/debug/integrity", self.debug_integrity)
        self.app.router.add_get("/debug/migration", self.debug_migration)
        self.app.router.add_get("/debug/fleet", self.debug_fleet)
        self.app.router.add_get("/debug/egress", self.debug_egress)
        self.app.router.add_get("/debug/blackbox/{room}", self.debug_blackbox)
        self._runner: web.AppRunner | None = None
        self._sites: list[web.TCPSite] = []
        self.started_at = 0.0

    def select_node(self) -> LocalNode | None:
        """Pick an RTC node for a new room (roomallocator.go)."""
        return self.stack.select_node()

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

    async def debug_trace(self, request: web.Request) -> web.Response:
        """Chrome/Perfetto trace export of the tick-span ring
        (?ticks=N, newest N ticks) plus the sampled wire-latency stage
        decomposition as a sidecar. Save the body to a file and load it
        in ui.perfetto.dev or chrome://tracing."""
        rt = self.room_manager.runtime
        if rt.trace is None:
            return web.json_response(
                {"error": "tracing disabled (trace.enabled: false)"}, status=404
            )
        try:
            n = int(request.query.get("ticks", "120"))
        except ValueError:
            return web.json_response({"error": "ticks must be an integer"}, status=400)
        from livekit_server_tpu_torch.telemetry import trace_export

        body: dict = {
            "traceEvents": trace_export.to_chrome(rt.trace.snapshot(n), rt.tick_ms),
            "displayTimeUnit": "ms",
        }
        if rt.wire_stages is not None:
            # Perfetto ignores unknown top-level keys; curl consumers get
            # the stage decomposition without a second request.
            body["otherData"] = {"wire_stages": rt.wire_stages.summary()}
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
        await self.stack.start(services=(self.ioinfo, self.room_api))
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        for addr in self.config.bind_addresses:
            site = web.TCPSite(self._runner, addr, self.config.port)
            await site.start()
            self._sites.append(site)
        self.started_at = time.time()

    async def stop(self, force: bool = False) -> None:
        await self.stack.stop(force, services=(self.ioinfo, self.room_api))
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


def create_server(config: Config, bus=None, device="cuda", mesh=None) -> LivekitServer:
    """The node stack of service/stack.py (`create_stack`: router, store,
    RoomManager on `device` or over `mesh`) with the HTTP app on top."""
    return LivekitServer(create_stack(config, bus=bus, device=device, mesh=mesh))
