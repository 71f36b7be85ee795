"""RoomManager: per-node room registry + participant session workers.

Reference parity: pkg/service/roommanager.go (StartSession :236-496,
getOrCreateRoom :499-577, rtcSessionWorker :580-634, admin ops :655-761)
plus the idle-room reaper (server.go backgroundWorker :367). The node's
single PlaneRuntime is owned here; a tick dispatcher routes TickResults to
each room's handlers (speakers, egress, keyframe requests) — replacing the
reference's per-room worker goroutines (room.go:1278-1396).

Port of the JAX package's service/roommanager.py. It builds the port's
PlaneRuntime or PagedPlaneRuntime on an explicit `device` ("cuda" by
default), or over a `mesh` of room (dense) or page (paged) shards
(parallel/mesh.py), which the caller builds: `plane.mesh_devices` is read
by nothing, as in the reference. The server attaches the UDP media transport (`udp`), through
which each tick's egress leaves in one native batch; entries without a
UDP/TCP destination go out as WebSocket frames. The failure and overload
plane is wired as in the reference: the plane supervisor (tick watchdog,
checkpoint generations, restart-from-snapshot), the fault injector (off
by default), the overload governor (its L4 gate in `_admission_denied`)
and the integrity monitor (row repair from the supervisor's checkpoints,
escalation to a supervisor restart). With a shared bus the multi-node
plane is wired as in the reference too: per-room KV checkpoints in a
generation ring (one device gather per round, `snapshot_rooms`), the live
migration plane (two-phase handoff, node drain), the fleet plane (epoch
fences, self-fencing, elected failover) and the dead-node failover
worker. The express lane (plane.express_max_subs > 0) and the embedded
media relay (relay.enabled) are off by default, as in the reference; when
on, the runtime builds the lane and `start_transports` attaches it to the
UDP transport and starts the relay beside it. A subsystem the port does
not carry (config.UNPORTED, empty since the mesh was ported) is refused
at construction with a ConfigError naming the ROADMAP item that brings
it; nothing is skipped in silence.
"""

from __future__ import annotations

import asyncio
import secrets
import time

import numpy as np

from livekit_server_tpu_torch.config.config import Config, check_ported
from livekit_server_tpu_torch.models import plane
from livekit_server_tpu_torch.ops import audio as audio_ops, bwe as bwe_ops
from livekit_server_tpu_torch.ops.pacer import WIRE_OVERHEAD_BYTES
from livekit_server_tpu_torch.protocol import models as pm, packer
from livekit_server_tpu_torch.protocol.signal import (
    SignalResponse,
    decode_signal_request,
    encode_signal_response,
)
from livekit_server_tpu_torch.routing.fleet import FencedWriteRejected
from livekit_server_tpu_torch.routing.messagechannel import (
    ChannelClosed,
    ChannelFull,
    MessageChannel,
)
from livekit_server_tpu_torch.routing.router import Router
from livekit_server_tpu_torch.rtc import Participant, Room, handle_participant_signal
from livekit_server_tpu_torch.runtime import CapacityError, PlaneRuntime, trace
from livekit_server_tpu_torch.runtime.faultinject import FaultInjector
from livekit_server_tpu_torch.runtime.governor import OverloadGovernor
from livekit_server_tpu_torch.runtime.integrity import IntegrityMonitor
from livekit_server_tpu_torch.runtime.plane_runtime import TickResult
from livekit_server_tpu_torch.runtime.relay import start_media_relay
from livekit_server_tpu_torch.runtime.supervisor import PlaneSupervisor
from livekit_server_tpu_torch.utils.backoff import BackoffPolicy
from livekit_server_tpu_torch.service.store import ObjectStore
from livekit_server_tpu_torch.utils.logger import Logger

# Failover checkpoints outlive a node crash but not a forgotten room:
# long enough for survivors to notice the lapsed lease (~lease_ttl) and
# win the takeover race, short enough that a deliberately deleted room
# cannot be resurrected much later from a stale row image.
CHECKPOINT_TTL_S = 30.0
# Rooms whose checkpoint writes are in flight at once in a round
# (checkpoint_rooms).
CHECKPOINT_PUBLISH_CONCURRENCY = 128

# Canonical admission-denial causes for telemetry: every human-readable
# refusal string from _admission_denied rolls up to one of overload |
# draining | no_capacity | fenced, so dashboards attribute rejected joins
# without string-matching prose.
DENIAL_REASON_LABELS = {
    "node fenced (quorum lost)": "fenced",
    "node draining": "draining",
    "no plane capacity for a new room": "no_capacity",
    "node overloaded": "overload",
    "max rooms on node": "no_capacity",
    "max tracks on node": "no_capacity",
    "node ingress packet rate exceeded": "overload",
    "node ingress byte rate exceeded": "overload",
}


class RoomManager:
    def __init__(
        self,
        config: Config,
        router: Router,
        store: ObjectStore,
        telemetry=None,
        device="cuda",
        mesh=None,
    ):
        check_ported(config)
        self.config = config
        self.router = router
        self.store = store
        self.telemetry = telemetry
        p = config.plane
        if p.pager_enabled:
            from livekit_server_tpu_torch.models import paged
            from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime

            pool = p.pager_pool_pages or (
                p.rooms
                * (p.tracks_per_room // p.pager_tpage)
                * (p.subs_per_room // p.pager_spage)
            )
            runtime_cls = PagedPlaneRuntime
            dims = paged.PagedDims(
                p.rooms, p.tracks_per_room, p.pkts_per_track, p.subs_per_room,
                tpage=p.pager_tpage, spage=p.pager_spage, pool_pages=pool,
            )
        else:
            runtime_cls = PlaneRuntime
            dims = plane.PlaneDims(
                p.rooms, p.tracks_per_room, p.pkts_per_track, p.subs_per_room
            )
        extra = {"paged_kernel": p.paged_kernel} if p.pager_enabled else {}
        self.runtime = runtime_cls(
            dims,
            tick_ms=p.tick_ms,
            **extra,
            low_latency=p.low_latency,
            red_enabled="audio/red" in config.room.enabled_codecs,
            audio_params=audio_ops.AudioLevelParams(
                active_level=config.audio.active_level,
                min_percentile=config.audio.min_percentile,
                observe_interval_ms=config.audio.update_interval_ms,
                smooth_intervals=config.audio.smooth_intervals,
            ),
            bwe_params=bwe_ops.BWEParams(
                nack_ratio_threshold=config.rtc.congestion_control.nack_ratio_threshold,
                nack_window_min_packets=config.rtc.congestion_control.nack_window_min_packets,
                estimate_required_downgrades=config.rtc.congestion_control.estimate_required_downgrades,
                congested_min_estimate=config.rtc.congestion_control.min_channel_capacity,
            ),
            trace_enabled=config.trace.enabled,
            trace_ring_ticks=config.trace.ring_ticks,
            trace_sample_every=config.trace.sample_every,
            blackbox_events=config.trace.blackbox_events,
            egress_shards=config.egress.shards,
            egress_multicast=config.egress.multicast_seal,
            express_max_subs=p.express_max_subs,
            express_max_rooms=p.express_max_rooms,
            device=device,
            mesh=mesh,
        )
        self.rooms: dict[str, Room] = {}
        self.udp = None     # UDPMediaTransport (start_transports / attach_udp)
        self.tcp_media = None  # TCPMediaTransport, the TCP fallback
        self.media_relay = None  # MediaRelay (relay.enabled), beside the UDP port
        self._row_to_room: dict[int, Room] = {}
        self._create_locks: dict[str, asyncio.Lock] = {}
        # Media-wire key registry (the DTLS-SRTP key-exchange seat): one
        # AEAD session per participant, minted at join and delivered over
        # the authenticated signal channel. No AEAD backend installed ⇒
        # cleartext (room.py's join path branches on crypto being None).
        from livekit_server_tpu_torch.runtime.crypto import HAVE_AEAD, MediaCryptoRegistry

        self.crypto = MediaCryptoRegistry() if HAVE_AEAD else None
        self.log = Logger()  # server start replaces with a node-scoped one
        # Black-box dumps go to the manager's log (re-pointed alongside
        # self.log when the server installs the node-scoped logger).
        self.runtime.blackbox.log = self.log
        self.agents = None  # AgentService; room/publisher job dispatch
        self.runtime.on_tick(self._dispatch_tick)
        self._reaper_task: asyncio.Task | None = None
        self._failover_task: asyncio.Task | None = None
        # Serializes snapshot→publish in checkpoint_rooms: without it, a
        # cadence-driven call that snapshotted, then yielded on the bus
        # write, can land its STALE row over a fresher concurrent publish.
        self._ckpt_lock = asyncio.Lock()
        # Cost of the room-checkpoint rounds (chip_smoke's migration phase
        # reads it): rounds, rooms written, the locked gather, the encodes
        # (in a worker thread), the wait for the writes, payload bytes
        # published, the longest round, and the rounds that outlasted the
        # checkpoint interval.
        self.ckpt_stats = {"rounds": 0, "rooms": 0, "gather_s": 0.0,
                           "encode_s": 0.0, "publish_s": 0.0, "bytes": 0,
                           "max_round_s": 0.0, "over_interval": 0}
        # Plane supervision: tick watchdog + restart-from-snapshot, with
        # the per-room checkpoint publisher as its cadence callback.
        self.supervisor = None
        sup = config.supervisor
        if sup.enabled:
            self.supervisor = PlaneSupervisor(
                self.runtime,
                tick_deadline_s=sup.tick_deadline_ms / 1000.0,
                warmup_deadline_s=sup.warmup_deadline_s,
                check_interval_s=sup.check_interval_ms / 1000.0,
                checkpoint_interval_s=sup.checkpoint_interval_s,
                max_restarts=sup.max_restarts,
                overload_grace=sup.overload_grace,
                ckpt_generations=config.integrity.checkpoint_generations,
                backoff=BackoffPolicy(
                    base=sup.restart_backoff_base_s, max_delay=sup.restart_backoff_max_s
                ),
                telemetry=telemetry,
                log=self.log,
            )
            self.supervisor.room_checkpoint_cb = self.checkpoint_rooms
        # Deterministic fault injection (chaos harness) — default-off; the
        # injector only exists when config.faults.enabled is set.
        self.fault = None
        if config.faults.enabled:
            self.fault = FaultInjector.from_config(config.faults)
            self.runtime.fault = self.fault
            self.runtime.ingest.fault = self.fault
        # Overload governor (runtime/governor.py): closes the loop from
        # tick telemetry to the degradation ladder. Attached to the
        # runtime (per-tick sensor feed) and consulted by admission; the
        # supervisor reads runtime.governor for its stall grace.
        self.governor = None
        self.admission_rejected: dict[str, int] = {}
        self._stats_pending = False   # a node-stats refresh is scheduled
        # Same refusals keyed by canonical cause (overload | draining |
        # no_capacity | fenced) — telemetry attributes rejected joins by
        # WHY, not just by kind.
        self.admission_denied_reasons: dict[str, int] = {}
        if config.limits.governor_enabled:
            self.governor = OverloadGovernor.from_config(self.runtime, config.limits,
                                                         log=self.log)
            self.runtime.governor = self.governor
        # State-integrity plane (runtime/integrity.py): audits on the tick
        # cadence, row quarantine + repair from the supervisor's last
        # verified checkpoint, storm/repair-failure escalation to a
        # supervisor restart (cause `integrity`).
        self.integrity = None
        integ = config.integrity
        if integ.enabled:
            self.integrity = IntegrityMonitor(
                self.runtime,
                audit_every_ticks=integ.audit_every_ticks,
                max_row_repairs=integ.max_row_repairs,
                storm_threshold=integ.storm_threshold,
                log=self.log,
            )
            self.runtime.integrity = self.integrity
            if self.supervisor is not None:
                self.integrity.snapshot_provider = self.supervisor.last_good_snapshot
                self.integrity.escalate_cb = self.supervisor.request_restart
        # Room-checkpoint generations on the KV bus: base key + :g1..:gK-1,
        # rotated from this local history (payload strings, newest first).
        self._ckpt_gens = max(1, integ.checkpoint_generations)
        self._ckpt_history: dict[str, list[str]] = {}
        self.ckpt_fallbacks = 0  # room-restore generations rejected
        # Fired for every checkpoint/snapshot adoption (failover restore
        # and migration alike); subscription masks never travel in a
        # snapshot (restore_room docstring), so this is where re-attach
        # logic — and the drills standing in for it — re-subscribes.
        self.on_adopt: list = []
        # Live migration plane (service/migration.py): two-phase room
        # handoff + node drain. Needs a shared bus to talk to peers —
        # a bus-less single-node router runs without it.
        self.migration = None
        if config.migration.enabled and getattr(router, "bus", None) is not None:
            from livekit_server_tpu_torch.service.migration import MigrationOrchestrator

            self.migration = MigrationOrchestrator(self)
        # Fleet coordination plane (service/fleetplane.py): epoch-fenced
        # room ownership, self-fencing on lease loss, elected failover
        # and the load rebalancer. Needs a shared bus AND a router that
        # runs the lease loop (KVRouter) — single-node runs without it.
        self.fleet = None
        if config.fleet.enabled and hasattr(router, "on_lease"):
            from livekit_server_tpu_torch.service.fleetplane import FleetPlane

            self.fleet = FleetPlane(self)
        router.on_new_session(self.start_session)
        self._update_node_stats()

    # -- room lifecycle ---------------------------------------------------
    async def get_or_create_room(
        self, name: str, info: pm.RoomInfo | None = None,
        *, admission_kind: str = "room",
    ) -> Room:
        # admission_kind: 'room' for client-driven creates; 'restore' when
        # the failover orchestrator re-homes a dead node's room (same hard
        # gates, exempt from the governor's transient overload ladder).
        room = self.rooms.get(name)
        if room is not None:
            return room
        # Serialize creation per name: a second joiner arriving during the
        # awaits below (store load, migration-snapshot restore) must wait
        # for the fully-initialized room — subscribing against a row whose
        # ctrl masks a restore is about to overwrite would silently wipe
        # the subscription.
        lock = self._create_locks.setdefault(name, asyncio.Lock())
        async with lock:
            room = self.rooms.get(name)
            if room is not None:
                return room
            reason = self._admission_denied(admission_kind)
            if reason:
                raise CapacityError(reason)
            stored = await self.store.load_room(name)
            room = Room(name, self.runtime, info=info or stored)
            room.crypto = self.crypto
            room.udp = self.udp
            # Publish-admission gate consulted by Participant.add_track_request.
            room.admission = self._admission_denied
            if info is None and stored is None:
                room.info.empty_timeout = self.config.room.empty_timeout_s
                room.info.departure_timeout = self.config.room.departure_timeout_s
                room.info.max_participants = self.config.room.max_participants
            await self._maybe_restore_room(room)
            self.rooms[name] = room
            self._row_to_room[room.slots.row] = room
            await self.store.store_room(room.info)
            try:
                await self.router.set_node_for_room(
                    name, self.router.local_node.node_id
                )
            except FencedWriteRejected:
                # Lost the ownership election: another node claimed a
                # higher epoch between our admission check and the pin.
                # Tear the half-created replica down and refuse — the
                # epoch holder serves this room.
                self.rooms.pop(name, None)
                self._row_to_room.pop(room.slots.row, None)
                room.close(pm.DisconnectReason.MIGRATION)
                raise CapacityError("room owned by another node")
        self._create_locks.pop(name, None)
        self._update_node_stats()
        self.runtime.blackbox.emit(room.slots.row, trace.EV_ROOM_OPEN)
        self.log.info("room started", room=name, row=room.slots.row)
        self._notify("room_started", room=room.info.to_dict())
        if self.agents is not None:
            # room agent job on room start; publisher job on first publish
            # (roommanager.go / rtc/agentclient.go launch points)
            asyncio.ensure_future(self.agents.launch_room_job(name))

            def on_publish(pub, _track, room_name=name):
                if not pub.published:  # first track → becoming a publisher
                    asyncio.ensure_future(
                        self.agents.launch_publisher_job(room_name, pub.identity)
                    )

            room.on_track_published.append(on_publish)
        return room

    async def delete_room(self, name: str) -> None:
        room = self.rooms.pop(name, None)
        if room is not None:
            self._row_to_room.pop(room.slots.row, None)
            self.runtime.blackbox.emit(room.slots.row, trace.EV_ROOM_CLOSE)
            room.close(pm.DisconnectReason.ROOM_DELETED)
            self.log.info("room finished", room=name)
            self._notify("room_finished", room=room.info.to_dict())
        await self.store.delete_room(name)
        bus = getattr(self.router, "bus", None)
        if bus is not None:
            # A deliberate delete must also retire the failover checkpoint
            # — every generation of it — or a same-name room created
            # within CHECKPOINT_TTL_S would adopt the dead room's SN/TS
            # lanes. Runs BEFORE clear_room_state releases the ownership
            # epoch, so the deletes go out under our own fence.
            try:
                for key in self._checkpoint_keys(name):
                    await self._fenced_delete(name, key)
            except FencedWriteRejected:
                pass   # new owner's checkpoints are theirs to retire
            except (ConnectionError, OSError):
                pass
        await self.router.clear_room_state(name)
        self._ckpt_history.pop(name, None)
        self._update_node_stats()

    def _checkpoint_keys(self, name: str) -> list[str]:
        """KV keys for a room's checkpoint generations, newest first."""
        return [f"room_checkpoint:{name}"] + [
            f"room_checkpoint:{name}:g{i}" for i in range(1, self._ckpt_gens)
        ]

    # The ONLY writers for room-checkpoint/snapshot KV keys (graftcheck
    # GC09 fencing discipline): with the fleet plane up every write
    # CAS-asserts this node's ownership epoch first, so a stale owner's
    # checkpoint loses (FencedWriteRejected) instead of clobbering the
    # takeover winner's state. Without a fleet (single node, fleet
    # disabled) they fall through to the raw bus.
    async def _fenced_set(
        self, room_name: str, key: str, value: str, ttl: float | None = None
    ) -> None:
        if self.fleet is not None:
            await self.fleet.fence.guarded_set(room_name, key, value, ttl)
        else:
            await self.router.bus.set(key, value, ttl)

    async def _fenced_set_many(
        self, room_name: str, items: list[tuple[str, str]], ttl: float | None = None
    ) -> None:
        """_fenced_set of several keys of one room, the writes in flight
        together (one epoch assert with the fleet plane up)."""
        if self.fleet is not None:
            await self.fleet.fence.guarded_set_many(room_name, items, ttl)
        else:
            await asyncio.gather(*(self.router.bus.set(k, v, ttl) for k, v in items))

    async def _fenced_delete(self, room_name: str, key: str) -> None:
        if self.fleet is not None and self.fleet.fence.owns(room_name):
            await self.fleet.fence.guarded_delete(room_name, key)
        else:
            await self.router.bus.delete(key)

    # -- session handling (roommanager.go StartSession) -------------------
    async def start_session(
        self,
        room_name: str,
        init: dict,
        request_source: MessageChannel,
        response_sink: MessageChannel,
    ) -> None:
        try:
            room = await self.get_or_create_room(room_name)
        except CapacityError as e:
            # Node room tensor full or admission refused: reject
            # explicitly (the reference sends a limits-reached error; a
            # silent open WebSocket is the failure ADVICE flagged). The
            # sink close lets rtcservice's pump end the connection.
            self._reject_session(
                response_sink, request_source, str(e) or "node at capacity"
            )
            return
        identity = init.get("identity", "")

        existing = room.participants.get(identity)
        if (
            existing is not None
            and existing.client_config is not None
            and existing.client_config.resume_connection == "disabled"
        ):
            # Client-quirk config forbids resume for this device/SDK
            # (clientconfiguration → ResumeConnection DISABLED): force a
            # full rejoin instead of session resumption.
            existing = None
        if existing is not None and init.get("reconnect"):
            # resume: swap the signal sinks onto the live participant
            # (roommanager.go:266-316); bump the epoch so the OLD worker's
            # teardown becomes a no-op when its socket finally closes.
            existing.session_epoch += 1
            existing.response_sink = response_sink
            # Fresh media queue: the old connection's pump may still hold a
            # pending get() on the previous queue — re-attaching reroutes
            # egress to this connection instead of splitting frames.
            self._attach_media_queue(room, existing)
            existing.send("reconnect", {})
            await self._session_worker(room, existing, request_source)
            return

        # Node admission (after resume handling: an existing session may
        # always resume — admission only refuses NEW load).
        reason = self._admission_denied("join")
        if reason:
            self._reject_session(response_sink, request_source, reason)
            return
        # A same-identity rejoin replaces its old session (room.join kicks
        # the duplicate), so it must not count toward the cap.
        max_p = room.info.max_participants
        if max_p and identity not in room.participants and len(room.participants) >= max_p:
            self._reject_session(response_sink, request_source, "room is full")
            return
        participant = Participant(
            identity,
            room,
            response_sink=response_sink,
            grants=init.get("grants"),
            name=init.get("name", ""),
            auto_subscribe=init.get("auto_subscribe", True),
            client_info=init.get("client_info"),
        )
        self._attach_media_queue(room, participant)
        try:
            join = room.join(participant)
        except CapacityError:
            # subscriber-column tensor full (slots.alloc_sub)
            self._reject_session(response_sink, request_source)
            return
        if participant.client_config is not None:
            join["client_configuration"] = participant.client_config.to_dict()
        participant.send("join", join)
        self.runtime.blackbox.emit(
            room.slots.row, trace.EV_JOIN, float(participant.sub_col)
        )
        self.log.info("participant joined", room=room_name, participant=identity)
        await self.store.store_participant(room_name, participant.to_info())
        self._update_node_stats()
        self._notify(
            "participant_joined",
            room=room.info.to_dict(),
            participant=participant.to_info().to_dict(),
        )
        await self._session_worker(room, participant, request_source)

    async def _session_worker(
        self, room: Room, participant: Participant, request_source: MessageChannel
    ) -> None:
        """Per-participant signal loop (rtcSessionWorker :580)."""
        epoch = participant.session_epoch
        try:
            while not participant.disconnected.is_set():
                raw = await request_source.read_message()
                try:
                    req = decode_signal_request(raw)
                except ValueError:
                    continue  # unknown/garbage frame: skip (reference logs)
                try:
                    handle_participant_signal(room, participant, req)
                except Exception:  # noqa: BLE001 — a malformed payload must
                    # not tear down the session (reference logs and skips)
                    pass
        except ChannelClosed:
            pass
        finally:
            # A stale worker (its session was resumed, or its identity was
            # replaced by a newer connection) must not tear down the live
            # participant or its store record.
            cur = room.participants.get(participant.identity)
            stale = participant.session_epoch != epoch or (
                cur is not None and cur is not participant
            )
            if not stale:
                if not participant.disconnected.is_set():
                    room.remove_participant(participant, pm.DisconnectReason.SIGNAL_CLOSE)
                self.runtime.blackbox.emit(
                    room.slots.row, trace.EV_LEAVE, float(participant.sub_col)
                )
                await self.store.delete_participant(room.name, participant.identity)
                self.log.info(
                    "participant left", room=room.name,
                    participant=participant.identity,
                    reason=participant.close_reason.name,
                )
                self._update_node_stats()
                self._notify(
                    "participant_left",
                    room=room.info.to_dict(),
                    participant=participant.to_info().to_dict(),
                )

    def _admission_denied(self, kind: str) -> str:
        """Non-empty rejection reason when the node must refuse new work
        of `kind` ('room' / 'join' / 'publish'), or a failover adoption
        ('restore') — the config.go LimitConfig seat plus the governor's
        L4. Every refusal is explicit (signal response) and counted;
        existing sessions are never evicted by any of these gates. A
        'restore' passes the same hard gates as 'room' (fenced, draining,
        plane headroom, max_rooms) but never the transient overload
        ladder — the fleet already admitted that room before its node
        died, and refusing its restore on a busy survivor would orphan
        it permanently (governor.should_admit carries the carve-out)."""
        lim = self.config.limits
        st = self.router.local_node.stats
        reason = ""
        if self.fleet is not None and self.fleet.fenced:
            # Quorum lost: this node may already have been failed over
            # by the majority side — admitting anything here would build
            # state a survivor is about to own.
            reason = "node fenced (quorum lost)"
        elif self.migration is not None and self.migration.draining:
            # Drain works with the governor disabled too: the orchestrator
            # itself refuses every admission kind while rooms move off.
            reason = "node draining"
        elif kind in ("room", "restore") and (
            self.runtime.occupancy().get("admittable_rooms", 1) <= 0
        ):
            # Real plane headroom (paged: free pages / min room footprint;
            # dense: free rows) — checked before the governor so page-pool
            # exhaustion reports its own reason rather than "overloaded".
            reason = "no plane capacity for a new room"
        elif self.governor is not None and not self.governor.should_admit(kind):
            reason = "node overloaded"
        elif kind in ("room", "restore") and (
            lim.max_rooms and len(self.rooms) >= lim.max_rooms
        ):
            reason = "max rooms on node"
        elif kind == "publish" and lim.num_tracks and (
            sum(len(r.tracks) for r in self.rooms.values()) >= lim.num_tracks
        ):
            reason = "max tracks on node"
        elif kind in ("join", "publish") and (
            lim.packets_per_sec and st.packets_in_per_sec > lim.packets_per_sec
        ):
            reason = "node ingress packet rate exceeded"
        elif kind in ("join", "publish") and (
            lim.bytes_per_sec and st.bytes_in_per_sec > lim.bytes_per_sec
        ):
            reason = "node ingress byte rate exceeded"
        if reason:
            self.admission_rejected[kind] = self.admission_rejected.get(kind, 0) + 1
            label = DENIAL_REASON_LABELS.get(reason, "overload")
            self.admission_denied_reasons[label] = (
                self.admission_denied_reasons.get(label, 0) + 1
            )
            if self.governor is not None:
                self.governor.note_rejection(kind)
            self.log.warn("admission refused", kind=kind, reason=reason)
        return reason

    def _reject_session(
        self,
        response_sink: MessageChannel,
        request_source: MessageChannel,
        error: str = "node at capacity",
    ) -> None:
        """Send an explicit JOIN_FAILURE leave and close both channels."""
        try:
            response_sink.write_message(
                encode_signal_response(
                    SignalResponse(
                        "leave",
                        {
                            "reason": int(pm.DisconnectReason.JOIN_FAILURE),
                            "can_reconnect": False,
                            "error": error,
                        },
                    )
                )
            )
        except (ChannelFull, ChannelClosed):
            pass
        response_sink.close()
        request_source.close()

    def _attach_media_queue(self, room: Room, participant: Participant) -> None:
        """Subscriber egress → bounded queue of MessagePack media frames
        drained by the WS pump (the transport half of DownTrack.WriteRTP →
        pacer → wire). The frames are the reference's bytes
        (protocol/packer.py)."""
        q: asyncio.Queue = asyncio.Queue(maxsize=512)
        participant.media_queue = q

        def media_out(pkt, room=room, q=q):
            data = packer.packb(
                {
                    "track_sid": room.col_to_sid.get(pkt.track, ""),
                    "sn": pkt.sn,
                    "ts": pkt.ts,
                    "pid": pkt.pid,
                    "tl0": pkt.tl0,
                    "keyidx": pkt.keyidx,
                    "payload": pkt.payload,
                }
            )
            try:
                q.put_nowait(data)
            except asyncio.QueueFull:
                pass  # slow subscriber: drop (pacer/leaky-bucket analog)

        participant.on_media(media_out)

    def handle_pli(self, row: int, track_col: int) -> None:
        """RTCP PLI from a UDP subscriber → keyframe request toward the
        publisher over the signal plane (receiver.go SendPLI)."""
        room = self._row_to_room.get(row)
        if room is not None:
            room.handle_keyframe_request(track_col)

    # -- tick fan-out -----------------------------------------------------
    def _dispatch_tick(self, res: TickResult) -> None:
        if self.fleet is not None and self.fleet.fenced:
            # Self-fenced: drop this tick's egress wholesale (UDP batch,
            # WS packets, padding, speaker/keyframe fan-out). The
            # majority side may already be serving these rooms —
            # double-forwarding is exactly the split-brain failure the
            # fleet plane exists to prevent.
            self.fleet.stats["muted_ticks"] += 1
            return
        if self.udp is not None:
            # Batch wire path: one native call assembles/seals/sends every
            # UDP-destined entry; only WS-destined entries materialize as
            # Python packet objects.
            handled = self.udp.send_egress_batch(
                res.egress_batch,
                red_plan=(res.red_sn, res.red_off, res.red_ok),
                layer_caps=(
                    self.runtime.ctrl.max_spatial, self.runtime.ctrl.max_temporal
                ),
                pacer_allowed=res.pacer_allowed,
            )
            if res.padding:
                # BWE probe padding (UDP subscribers only — padding is a
                # channel measurement, meaningless over the WS loopback).
                self.udp.send_egress(res.padding, rtx=True)
            ws_pkts = res.egress_batch.to_packets(~handled) if len(handled) else []
        else:
            ws_pkts = res.egress
        ws_tx = self.runtime.ingest.ws_tx
        for pkt in ws_pkts:
            room = self._row_to_room.get(pkt.room)
            if room is not None:
                room.deliver_egress(pkt)
                # WS-media egress accounting (wire-byte basis).
                ws_tx[pkt.room, pkt.sub, 0] += 1
                ws_tx[pkt.room, pkt.sub, 1] += (
                    len(pkt.payload) + WIRE_OVERHEAD_BYTES
                )
        for row, speakers in res.speakers.items():
            room = self._row_to_room.get(row)
            if room is not None:
                room.handle_speakers(speakers)
        seen = set()
        for row, track_col, _sub in res.need_keyframe:
            if (row, track_col) in seen:
                continue  # PLI throttle: one per track per tick
            seen.add((row, track_col))
            room = self._row_to_room.get(row)
            if room is not None:
                room.handle_keyframe_request(track_col)
        if res.quality_window_closed and res.track_quality is not None:
            # ~1/s: connection-quality fan-out + dynacast reconciliation
            # (room.go:1318 connectionQualityWorker; dynacastmanager.go).
            for row, room in self._row_to_room.items():
                room.handle_quality(
                    res.track_quality[row], res.track_mos[row], res.sub_quality[row]
                )
                room.reconcile_dynacast()
                if res.target_layers is not None:
                    room.update_stream_states(res.target_layers[row])
            if self.telemetry is not None:
                # Windowed device reductions → quality histograms + one
                # analytics record per published track (statsworker.go).
                pub = self.runtime.meta.published
                if pub.any():
                    self.telemetry.observe_tracks(
                        res.track_loss_pct[pub],
                        res.track_jitter_ms[pub],
                        res.track_bps[pub],
                    )
                for row, room in self._row_to_room.items():
                    for col, sid in room.col_to_sid.items():
                        if not pub[row, col]:
                            continue
                        self.telemetry.track_stat(
                            room=room.name, track=sid,
                            kind="video" if self.runtime.meta.is_video[row, col] else "audio",
                            loss_pct=round(float(res.track_loss_pct[row, col]), 3),
                            jitter_ms=round(float(res.track_jitter_ms[row, col]), 3),
                            bps=round(float(res.track_bps[row, col]), 1),
                            mos=round(float(res.track_mos[row, col]), 2),
                            quality=int(res.track_quality[row, col]),
                        )
        if self.telemetry is not None:
            self.telemetry.observe_plane(self.runtime.stats)
            self.telemetry.observe_tick_latency(res.tick_s)
            if self.udp is not None:
                self.telemetry.observe_transport(self.udp.stats)
            if self.governor is not None:
                self.telemetry.observe_overload({
                    **self.governor.stats_dict(),
                    "denied_reasons": dict(self.admission_denied_reasons),
                })
            if self.integrity is not None:
                self.telemetry.observe_integrity(self.integrity_stats())
            self.telemetry.observe_egress(self.runtime.egress_plane.observe())
            pager_stats = getattr(self.runtime, "pager_stats", None)
            if pager_stats is not None:
                self.telemetry.observe_pager(pager_stats())
            if self.runtime.wire_stages is not None:
                # Per-stage wire-latency samples since the last tick →
                # stage histograms + livekit_forward_latency_ms.
                self.telemetry.observe_wire_stages(
                    self.runtime.wire_stages.drain()
                )

    # -- media transports (rtc/config.go UDPMux, transportmanager.go) -----
    async def start_transports(self) -> None:
        """Open the native UDP media transport on rtc.udp_port (0 = none)
        and, when the node has an AEAD backend, the TCP fallback on
        rtc.tcp_port (0 = none), and the embedded media relay when
        relay.enabled, and wire them to the runtime and rooms (the
        reference server's start sequence). To serve on an ephemeral
        port, start the transport with port 0 and hand it to `attach_udp`
        (and the relay to `start_relay`) instead."""
        cfg = self.config
        if not cfg.rtc.udp_port or self.udp is not None:
            return
        from livekit_server_tpu_torch.runtime.udp import start_udp_transport

        udp = await start_udp_transport(
            self.runtime.ingest, cfg.bind_addresses[0], cfg.rtc.udp_port,
            crypto=self.crypto, require_encryption=cfg.rtc.require_encryption,
            nack_resolver=self.runtime.resolve_nacks,
        )
        self.attach_udp(udp)
        # TCP media fallback (transportmanager.go:73 ladder): the same
        # sealed frames, length-prefixed; always encrypted, so it cannot
        # exist on a node without an AEAD backend.
        if cfg.rtc.tcp_port and self.crypto is not None:
            from livekit_server_tpu_torch.runtime.tcp import start_tcp_transport

            try:
                self.tcp_media = await start_tcp_transport(
                    udp, self.crypto, cfg.bind_addresses[0], cfg.rtc.tcp_port
                )
            except OSError as e:    # port busy: the UDP path still works
                self.log.warn("TCP media fallback not started",
                              port=cfg.rtc.tcp_port, error=str(e))
        if cfg.relay.enabled:
            await self.start_relay(cfg.bind_addresses[0], cfg.relay.udp_port)

    async def start_relay(self, host: str, port: int) -> None:
        """Start the embedded media relay (turn.go:47 seat) on (host,
        port), forwarding to this node's UDP media port, and advertise it
        through the transport's `relay_info` for request_relay. Relay
        tokens are minted and verified only by this process, so the HMAC
        secret is fresh and random per process (a config-derived secret
        would be the constant "dev" in keyless dev mode). A wildcard bind
        is never advertised: clients cannot route to it, so the relay then
        runs unadvertised unless relay.external_host names an address."""
        rcfg, udp = self.config.relay, self.udp
        up_host, up_port = udp.transport.get_extra_info("sockname")[:2]
        if up_host in ("", "0.0.0.0", "::"):
            up_host = "127.0.0.1"   # the relay's upstream sockets dial loopback
        secret = secrets.token_bytes(32)
        try:
            self.media_relay = await start_media_relay(
                host, port, (up_host, up_port), secret,
                ttl_s=float(rcfg.allocation_ttl_s),
                max_allocations=rcfg.max_allocations,
            )
        except OSError as e:    # relay port busy: the direct path still works
            self.log.warn("media relay not started", port=port, error=str(e))
            return
        advert = rcfg.external_host or host
        if advert in ("", "0.0.0.0", "::"):
            self.log.warn("relay enabled but bind address is a wildcard and "
                          "relay.external_host is unset; not advertising relay "
                          "to clients")
            return
        udp.relay_info = (advert, self.media_relay.transport.get_extra_info(
            "sockname")[1], secret, float(rcfg.allocation_ttl_s))

    def attach_udp(self, udp) -> None:
        """Wire a started UDPMediaTransport to the runtime and the rooms:
        client PLIs, the sharded egress plane, the wire-latency
        attribution, the pacer and playout-delay settings."""
        cfg = self.config
        udp.on_pli = self.handle_pli
        udp.attach_egress_plane(self.runtime.egress_plane)
        udp.wire_stages = self.runtime.wire_stages
        if self.runtime.express is not None:
            # Express lane: interactive rooms forward on packet arrival
            # through this transport instead of the batched tick.
            udp.attach_express(self.runtime.express)
        udp.send_side_bwe = cfg.rtc.congestion_control.send_side_bwe
        # The MCU seat's batched mix runs where the plane runs.
        udp.mixer_device = self.runtime.device
        if cfg.rtc.pacer == "no-queue":
            udp.pacer_spread_ms = cfg.plane.tick_ms / 2.0
        elif cfg.rtc.pacer == "leaky-bucket":
            # Per-subscriber byte budgets from the device pacer op gate
            # egress; over-budget packets defer FIFO.
            udp.pacer_mode = "leaky-bucket"
        if cfg.room.playout_delay_max_ms > 0:
            udp.playout_delay = (
                cfg.room.playout_delay_min_ms, cfg.room.playout_delay_max_ms,
            )
        self.udp = udp
        for room in self.rooms.values():
            room.udp = udp

    def close_transports(self) -> None:
        """Close the media relay, the UDP socket and the TCP listener, if
        open."""
        if self.media_relay is not None:
            self.media_relay.close()
            self.media_relay = None
        if self.udp is not None and self.udp.transport is not None:
            self.udp.transport.close()
        if self.tcp_media is not None:
            self.tcp_media.close()
            self.tcp_media = None

    # -- cross-node room migration (participant.go:823 analog) ------------
    async def handoff_room(self, name: str, target_node_id: str = "") -> bool:
        """Publish a room's media-plane row to the bus and unpin (or repin)
        it, so another node's get_or_create_room resumes mid-stream with
        intact munger/VP8 offsets — migrated subscribers see contiguous
        SN/TS instead of a stream reset. (The host-side NACK replay ring
        does not travel; post-migration NACKs miss until it repopulates.)"""
        room = self.rooms.get(name)
        bus = getattr(self.router, "bus", None)
        if room is None or bus is None:
            return False
        # Quiesce the row first: packets (or probe padding) forwarded after
        # the snapshot would advance munger SN lanes past what the
        # destination restores, and those SNs would be re-issued there.
        self.runtime.ingest.frozen_rows.add(room.slots.row)
        try:
            # Ticks staged before the freeze finish first (see
            # PlaneRuntime.settle_staged).
            await self.runtime.settle_staged()
            async with self.runtime.state_lock:  # vs. the device step
                snap = self.runtime.snapshot_room(room.slots.row)
            # Durability gate: the snapshot must be on the bus and the
            # pin moved BEFORE any local teardown. A bus failure here
            # leaves the room fully serving on this node — never pop a
            # room whose state only exists in a packet that didn't land.
            try:
                await self._fenced_set(
                    name,
                    f"room_snapshot:{name}",
                    self.runtime.encode_room_snapshot(snap),
                    self.config.migration.snapshot_ttl_s,
                )
                if target_node_id:
                    await self.router.set_node_for_room(name, target_node_id)
                else:
                    await self.router.clear_room_state(name)
            except FencedWriteRejected:
                # Ownership already moved to a higher epoch — the
                # fence's on_lost callback closed the local replica;
                # there is nothing left here to hand off.
                return False
            except (ConnectionError, OSError) as e:
                self.log.warn(
                    "handoff aborted; room keeps serving here",
                    room=name, error=str(e),
                )
                return False
            # Local teardown only — the pin/store state now belongs to the
            # destination node (clients reconnect there, reason MIGRATION).
            self.rooms.pop(name, None)
            self._row_to_room.pop(room.slots.row, None)
            room.close(pm.DisconnectReason.MIGRATION)
            self.log.info("room handed off", room=name, target=target_node_id or "unpinned")
        finally:
            # On success room.close released the row (its next tenant
            # starts unfrozen); on an aborted handoff this resumes it.
            self.runtime.ingest.frozen_rows.discard(room.slots.row)
        self._update_node_stats()
        return True

    async def migrate_room(self, name: str, target_node_id: str = "") -> bool:
        """Supervised two-phase handoff (service/migration.py): the room
        moves only after the target ACKs a restored replica, freeze-window
        packets are bridged across, and any failure rolls back to serving
        here. Falls back to the fire-and-forget bus handoff when the
        migration plane is disabled."""
        if self.migration is not None:
            return await self.migration.migrate_room(name, target_node_id)
        return await self.handoff_room(name, target_node_id)

    def _on_room_adopted(self, room: Room) -> None:
        """Post-adoption resync (the NACK blind-window satellite): the
        host-side NACK replay ring does not travel in a snapshot, so
        lost-packet recovery is blind until each video track's ring
        repopulates. Shrink that window by soliciting an immediate
        keyframe per migrated video track — a keyframe resets decode
        state without needing history — and re-solicit when a publisher
        reconnects and republishes."""
        row = room.slots.row
        meta = self.runtime.meta
        cols = np.nonzero(meta.published[row] & meta.is_video[row])[0]
        pending: set[int] = set()
        for col in cols:
            room.handle_keyframe_request(int(col))
            pending.add(int(col))

        def _resync(pub, track) -> None:
            col = getattr(track, "track_col", None)
            if col is None or col not in pending:
                return
            pending.discard(col)
            # The adoption-time request above recorded _last_pli for this
            # col even when no publisher was mapped yet; clear it so this
            # republish-time request isn't throttled away.
            room._last_pli.pop(col, None)
            room.handle_keyframe_request(col)

        if pending:
            room.on_track_published.append(_resync)
        for cb in list(self.on_adopt):
            cb(room)

    async def _maybe_restore_room(self, room: Room) -> None:
        """Adopt a migrated room's device state if a snapshot is waiting on
        the bus (the receiving half of handoff_room), falling back to the
        failover checkpoint GENERATIONS (the receiving half of
        checkpoint_rooms) when no deliberate handoff is in flight.

        Every candidate is checksum-verified (decode_room_snapshot) and
        shape/dtype-validated (restore_room) before anything scatters
        into device state; a corrupt or mismatched payload falls back a
        generation (counter + warn) instead of raising out of room
        creation. With no usable candidate the room starts fresh — a
        stream reset, not an outage."""
        bus = getattr(self.router, "bus", None)
        if bus is None:
            return
        candidates = [f"room_snapshot:{room.name}"] + self._checkpoint_keys(room.name)
        for key in candidates:
            raw = await bus.get(key)
            if not raw:
                continue
            try:
                snap = self.runtime.decode_room_snapshot(raw)
                async with self.runtime.state_lock:  # vs. the device step
                    self.runtime.restore_room(room.slots.row, snap)
            except Exception as e:  # noqa: BLE001 — corruption, version or
                # dims drift; reject-and-log, then try an older generation.
                self.ckpt_fallbacks += 1
                self.log.warn(
                    "room snapshot rejected; falling back a generation",
                    room=room.name, key=key, error=str(e),
                )
                await bus.delete(key)
                continue
            self.log.info("room restored from snapshot", room=room.name, key=key)
            await bus.delete(key)
            # Same blind window as a two-phase adoption: solicit keyframes
            # so video recovers before the NACK ring repopulates.
            self._on_room_adopted(room)
            return

    # -- supervision & failover ------------------------------------------
    async def checkpoint_rooms(self, force_fenced: bool = False) -> None:
        """Publish every live room's row snapshot to the KV bus — the seed
        a surviving node restores from if this node dies. Runs on the
        PlaneSupervisor's checkpoint cadence.

        A self-fenced node freezes this entirely (a survivor may hold
        newer state; our write would clobber it) — except the recovery
        reconcile, which calls with ``force_fenced=True`` exactly BECAUSE
        each write CAS-asserts ownership: every room a survivor took
        raises FencedWriteRejected, closing the local replica, and every
        still-owned room gets a fresh checkpoint.

        The reference snapshots, encodes and publishes room by room, each
        write awaited in turn. Here one hold of state_lock gathers every
        live row in one device → host copy per leaf (`snapshot_rooms`),
        each room's frame byte-equal to `encode_room_snapshot(
        snapshot_room(row))` at that point; a worker thread encodes the
        frames while the event loop goes on ticking, and then every
        room's generation ring is written, up to
        CHECKPOINT_PUBLISH_CONCURRENCY rooms in flight. On a node whose
        event loop the tick's fan-out keeps busy, every await waits for a
        turn of the loop: awaited room by room, a 520-room round took
        55 s on an H100 host (chip_smoke.py's migration phase), and
        checkpoints older than CHECKPOINT_TTL_S expired before a survivor
        could restore them."""
        bus = getattr(self.router, "bus", None)
        if bus is None:
            return
        if self.fleet is not None and self.fleet.fenced and not force_fenced:
            return
        async with self._ckpt_lock:
            t0 = time.perf_counter()
            live = [(name, room) for name, room in list(self.rooms.items())
                    # mid-handoff: the migration owns this row's snapshot
                    if room.slots.row not in self.runtime.ingest.frozen_rows]
            if not live:
                return
            async with self.runtime.state_lock:  # vs. the device step
                snaps = self.runtime.snapshot_rooms([r.slots.row for _, r in live])
            st = self.ckpt_stats
            st["gather_s"] += time.perf_counter() - t0
            sem = asyncio.Semaphore(CHECKPOINT_PUBLISH_CONCURRENCY)

            async def publish(name: str, items: list[tuple[str, str]]) -> None:
                async with sem:
                    try:
                        await self._fenced_set_many(name, items, CHECKPOINT_TTL_S)
                    except FencedWriteRejected:
                        return  # room lost: on_lost closed the replica
                st["rooms"] += 1
                st["bytes"] += sum(len(v) for _, v in items)

            te = time.perf_counter()
            encode = self.runtime.encode_room_snapshot
            payloads = await asyncio.to_thread(lambda: [encode(snap) for snap in snaps])
            st["encode_s"] += time.perf_counter() - te
            writes = []
            for (name, room), payload in zip(live, payloads):
                if self.rooms.get(name) is not room:
                    continue  # deleted or handed off since the gather
                if self.fault is not None:
                    # corrupt_ckpt seam: damage lands on the encoded frame,
                    # exactly where real bus/storage bit rot would.
                    payload = self.fault.corrupt_ckpt(payload)
                # Rotate the generation ring: newest at the base key, the
                # previous K-1 payloads at :g1..:gK-1 so a corrupt newest
                # frame falls back instead of orphaning the room.
                hist = self._ckpt_history.setdefault(name, [])
                hist.insert(0, payload)
                del hist[self._ckpt_gens:]
                writes.append(asyncio.ensure_future(
                    publish(name, list(zip(self._checkpoint_keys(name), hist)))))
            tp = time.perf_counter()
            results = await asyncio.gather(*writes, return_exceptions=True)
            st["publish_s"] += time.perf_counter() - tp
            took = time.perf_counter() - t0
            st["rounds"] += 1
            st["max_round_s"] = max(st["max_round_s"], took)
            if took > self.config.supervisor.checkpoint_interval_s:
                st["over_interval"] += 1
            for res in results:
                if isinstance(res, BaseException):
                    raise res

    async def _failover_worker(self) -> None:
        """Scan for rooms pinned to dead nodes (lapsed liveness lease,
        routing/router.py dead_room_pins) and adopt the ones we win the
        takeover race for, restoring their media-plane rows from the dead
        node's last checkpoint. Replaces the reference's join-triggered
        takeover with a proactive one: rooms re-home within
        ~lease_ttl + failover_interval even with no client knocking."""
        interval = self.config.kv.failover_interval_s
        while True:
            await asyncio.sleep(interval)
            if self.fleet is not None:
                # Elected restore path (exactly one winner per room via
                # create-lock + epoch CAS); a fenced node sits scans out
                # — it must not restore rooms it may be about to lose.
                if not self.fleet.fenced:
                    try:
                        await self.fleet.orchestrator.run_once()
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001 — scan must
                        # not kill the loop; next interval retries.
                        self.log.warn("failover scan failed", error=str(e))
                continue
            try:
                dead = await self.router.dead_room_pins()
            except (ConnectionError, OSError):
                continue  # bus outage: retry next interval
            adopted_any = False
            for name, dead_node in dead:
                try:
                    winner = await self.router.try_takeover(name, dead_node)
                    if winner != self.router.local_node.node_id:
                        continue  # another survivor won; it restores the room
                    await self.get_or_create_room(name)
                except (ConnectionError, OSError):
                    continue
                except CapacityError:
                    # No free row here: release the pin so a survivor with
                    # headroom can win the next scan's race.
                    await self.router.clear_room_state(name)
                    continue
                adopted_any = True
                self.log.info("room failed over", room=name, dead_node=dead_node[:12])
                if self.telemetry is not None:
                    self.telemetry.add("livekit_room_failovers_total")
            if dead and hasattr(self.router, "remove_dead_nodes"):
                try:
                    await self.router.remove_dead_nodes()
                except (ConnectionError, OSError):
                    pass
            if adopted_any:
                self._update_node_stats()

    def integrity_stats(self) -> dict:
        """IntegrityMonitor stats + the checkpoint-generation fallback
        counters spread across the supervisor (full-plane ring) and this
        manager (KV room checkpoints) — the /debug/integrity payload."""
        snap = self.integrity.stats_dict() if self.integrity is not None else {}
        fallbacks = self.ckpt_fallbacks
        if self.supervisor is not None:
            fallbacks += self.supervisor.ckpt_fallbacks
            snap["restart_causes"] = dict(self.supervisor.restart_causes)
        snap["generation_fallbacks"] = fallbacks
        return snap

    # -- periodic reaping (server.go backgroundWorker) --------------------
    def start(self) -> None:
        self.runtime.start()
        if self.supervisor is not None:
            self.supervisor.start()
        if self._reaper_task is None:
            self._reaper_task = asyncio.ensure_future(self._reaper())
        # Failover scan only makes sense with a shared bus to observe
        # other nodes' leases (and to read their checkpoints from).
        if self._failover_task is None and getattr(self.router, "bus", None) is not None:
            self._failover_task = asyncio.ensure_future(self._failover_worker())
        if self.migration is not None:
            self.migration.start()
        if self.fleet is not None:
            self.fleet.start()

    async def _reaper(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            for name in [n for n, r in self.rooms.items() if r.should_close()]:
                await self.delete_room(name)
            # Publication watchdog (participant_supervisor.go monitor loop):
            # announced tracks whose media never arrived get reaped and the
            # client notified.
            for room in list(self.rooms.values()):
                for p in list(room.participants.values()):
                    p.reap_stale_publications()

    async def stop(self) -> None:
        if self.fleet is not None:
            await self.fleet.stop()
        if self.migration is not None:
            await self.migration.stop()
        if self.supervisor is not None:
            await self.supervisor.stop()
        for attr in ("_reaper_task", "_failover_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                setattr(self, attr, None)
        await self.runtime.stop()
        for name in list(self.rooms):
            await self.delete_room(name)

    # -- helpers ----------------------------------------------------------
    def _update_node_stats(self) -> None:
        """Refresh the node's stats once the callbacks the event loop has
        ready now have run. Each refresh sums over every room and
        participant, and joins come in bursts (a room filling, a mass
        rejoin): the reference refreshes at every join, which made the
        joins of 10,240 participants quadratic (on an H100 host, 25-46 s
        in chip_smoke.py). Here a burst shares one refresh; the stats lag
        a change by at most one turn of the loop."""
        if self._stats_pending:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:          # no loop yet (construction)
            self._refresh_node_stats()
            return
        self._stats_pending = True
        loop.call_soon(self._refresh_node_stats)

    def _refresh_node_stats(self) -> None:
        self._stats_pending = False
        st = self.router.local_node.stats
        st.num_rooms = len(self.rooms)
        st.num_clients = sum(len(r.participants) for r in self.rooms.values())
        st.num_tracks_in = sum(len(r.tracks) for r in self.rooms.values())
        st.num_tracks_out = sum(
            len(p.subscribed_tracks)
            for r in self.rooms.values()
            for p in r.participants.values()
        )
        st.plane_rooms_used = self.runtime.slots.rooms_used
        st.plane_rooms_capacity = self.runtime.slots.capacity
        occ = self.runtime.occupancy()
        st.plane_pages_used = occ.get("pages_used", 0)
        st.plane_pages_capacity = occ.get("pages_total", 0)

    def sample_traffic(self) -> None:
        """Window deltas of the cumulative rx/tx counters → node packet/
        byte rates (participant_traffic_load.go:38-150 seat: per-
        participant rates feed NodeStats and thereby node selection).
        Called from the server's 2 s stats loop; per-slot rate arrays are
        retained for /debug/rooms' per-participant view."""
        now = time.monotonic()
        ing = self.runtime.ingest
        prev = getattr(self, "_traffic_prev", None)
        rx_p = ing.rx_pkts.copy()
        # Wire-byte basis on BOTH directions (payload + fixed per-packet
        # overhead), so bytes_in/bytes_out are comparable.
        rx_b = ing.rx_bytes + ing.rx_pkts * WIRE_OVERHEAD_BYTES
        tx_p = ing.ws_tx[:, :, 0].copy()
        tx_b = ing.ws_tx[:, :, 1].copy()
        if self.udp is not None:
            tx_p += self.udp.tx_pkts
            tx_b += self.udp.tx_bytes
        self._traffic_prev = (now, rx_p, rx_b, tx_p, tx_b)
        if prev is None:
            return
        t0, prx_p, prx_b, ptx_p, ptx_b = prev
        dt = max(now - t0, 1e-3)
        # Clamp: slot release resets counters mid-window.
        self.rx_pps = np.maximum(rx_p - prx_p, 0) / dt      # [R, T]
        self.rx_bps = np.maximum(rx_b - prx_b, 0) * 8 / dt
        self.tx_pps = np.maximum(tx_p - ptx_p, 0) / dt      # [R, S]
        self.tx_bps = np.maximum(tx_b - ptx_b, 0) * 8 / dt
        st = self.router.local_node.stats
        st.packets_in_per_sec = float(self.rx_pps.sum())
        st.bytes_in_per_sec = float(self.rx_bps.sum()) / 8
        st.packets_out_per_sec = float(self.tx_pps.sum())
        st.bytes_out_per_sec = float(self.tx_bps.sum()) / 8

    def participant_traffic(self, room: "Room") -> dict:
        """Per-participant rates from the last sample window: egress from
        the participant's subscriber slot, ingress summed over the tracks
        it publishes."""
        out = {}
        rx_pps = getattr(self, "rx_pps", None)
        row = room.slots.row
        for ident, p in room.participants.items():
            ent = {"tx_pps": 0.0, "tx_bps": 0.0, "rx_pps": 0.0, "rx_bps": 0.0}
            if getattr(self, "tx_pps", None) is not None and p.sub_col >= 0:
                ent["tx_pps"] = round(float(self.tx_pps[row, p.sub_col]), 1)
                ent["tx_bps"] = round(float(self.tx_bps[row, p.sub_col]), 1)
            if rx_pps is not None:
                cols = [
                    t.track_col for pub, t in room.tracks.values()
                    if pub.sid == p.sid
                ]
                if cols:
                    ent["rx_pps"] = round(float(rx_pps[row, cols].sum()), 1)
                    ent["rx_bps"] = round(float(self.rx_bps[row, cols].sum()), 1)
            out[ident] = ent
        return out

    def _notify(self, event: str, **payload) -> None:
        if self.telemetry is not None:
            self.telemetry.notify(event, **payload)
