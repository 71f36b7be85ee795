"""Fleet coordination plane: self-fencing, elected failover, rebalancing.

Port of the JAX package's service/fleetplane.py; the failover scan
restores several rooms at once (FailoverOrchestrator.run_once).

The mechanism half lives in routing/fleet.py (RoomFence epoch CAS,
LeaseGuard transitions); this module wires it to node-level effects:

  FleetPlane            maps LeaseGuard's fence/recover onto the media
                        plane — mute room egress (_dispatch_tick early
                        return), freeze checkpoint writes, quiesce the
                        supervisor's restart-from-KV path, and deny
                        admissions — and closes local replicas the
                        moment their epoch is lost to a survivor.
  FailoverOrchestrator  turns KVRouter.dead_room_pins() into exactly-one
                        -winner recovery: a create-lock (setnx) plus the
                        epoch CAS elect the restorer; everyone else backs
                        off cleanly, so two survivors never both
                        restore the same room.
  Rebalancer            drains hot nodes through the two-phase
                        migration: when this node's plane load sits
                        above the fleet mean by more than the configured
                        headroom, the busiest rooms move to
                        selector-picked peers (bounded moves per scan).

Recovery order matters: a healed node reconciles BEFORE unmuting. The
forced guarded checkpoint pass CAS-asserts every held room's epoch while
egress is still muted, so each room a survivor took is discovered (and
its replica closed) before this node could double-forward a single
packet for it.
"""

from __future__ import annotations

import asyncio

from livekit_server_tpu_torch.protocol import models as pm
from livekit_server_tpu_torch.routing.fleet import LeaseGuard, RoomFence
from livekit_server_tpu_torch.routing.router import NODE_ROOM_KEY
from livekit_server_tpu_torch.runtime import CapacityError

RESTORE_LOCK_PREFIX = "fleet_restore:"
# Rooms of one dead-pin scan restored at once (FailoverOrchestrator.run_once).
RESTORE_CONCURRENCY = 256


class FleetPlane:
    """Per-node fencing state machine, fed by the router's lease worker."""

    def __init__(self, manager):
        self.mgr = manager
        self.router = manager.router
        self.cfg = manager.config.fleet
        self.log = manager.log
        self.fence = RoomFence(
            self.router.bus, self.router.local_node.node_id, log=manager.log
        )
        self.guard = LeaseGuard(self.cfg.fence_grace_s)
        # The router runs the lease loop and the fenced pin moves; it
        # observes through us, we fence through it.
        self.router.fence = self.fence
        self.router.on_lease = self._lease_observed
        self.fence.on_lost.append(self._room_lost)
        self.orchestrator = FailoverOrchestrator(manager, self.fence)
        self.rebalancer = Rebalancer(manager, self)
        self._rebalance_task: asyncio.Task | None = None
        self.stats = {
            "fences": 0, "recoveries": 0, "rooms_lost": 0, "muted_ticks": 0,
        }

    @property
    def fenced(self) -> bool:
        return self.guard.fenced

    def start(self) -> None:
        if self.rebalancer.enabled and self._rebalance_task is None:
            self._rebalance_task = asyncio.ensure_future(self.rebalancer.run())

    async def stop(self) -> None:
        if self._rebalance_task is not None:
            self._rebalance_task.cancel()
            self._rebalance_task = None

    # -- lease transitions ------------------------------------------------
    async def _lease_observed(self, ok: bool) -> None:
        action = self.guard.observe(ok)
        if action == "fence":
            self._enter_fence()
        elif action == "recover":
            await self._reconcile_and_unfence()

    def _enter_fence(self) -> None:
        """Quorum lost: go silent BEFORE any survivor's takeover can
        double-forward — egress mute and admission denial key off
        guard.fenced; the supervisor flag stops restart-from-KV."""
        self.stats["fences"] += 1
        if self.mgr.supervisor is not None:
            self.mgr.supervisor.fenced = True
        self.log.warn(
            "node self-fenced: lease unrefreshed past fence_grace",
            lease_age_s=round(self.guard.age(), 2),
            fence_grace_s=self.guard.fence_grace_s,
        )
        if self.mgr.telemetry is not None:
            self.mgr.telemetry.add("livekit_fleet_fences_total")

    async def _reconcile_and_unfence(self) -> None:
        """The lease refreshes again. Reconcile while STILL fenced: the
        forced guarded checkpoint pass CAS-asserts every held room's
        epoch, so each room a survivor took over fires _room_lost (and
        closes here) before a single muted packet could resume."""
        try:
            await self.mgr.checkpoint_rooms(force_fenced=True)
        except (ConnectionError, OSError):
            return   # bus flapped again: stay fenced, retry on next OK
        self.guard.unfence()
        if self.mgr.supervisor is not None:
            self.mgr.supervisor.fenced = False
        self.stats["recoveries"] += 1
        self.log.info(
            "node unfenced: lease restored, ownership reconciled",
            rooms=len(self.mgr.rooms),
        )
        if self.mgr.telemetry is not None:
            self.mgr.telemetry.add("livekit_fleet_recoveries_total")

    # -- ownership loss ---------------------------------------------------
    def _room_lost(self, name: str) -> None:
        """A guarded write lost its epoch CAS: a survivor owns the room
        now. Tear down the local replica only — the KV pin, store row and
        checkpoints belong to the new owner; clients reconnect and route
        there."""
        self.stats["rooms_lost"] += 1
        room = self.mgr.rooms.pop(name, None)
        if room is None:
            return
        self.mgr._row_to_room.pop(room.slots.row, None)
        self.mgr._ckpt_history.pop(name, None)
        from livekit_server_tpu_torch.runtime.trace import EV_ROOM_CLOSE

        self.mgr.runtime.blackbox.emit(room.slots.row, EV_ROOM_CLOSE)
        room.close(pm.DisconnectReason.MIGRATION)
        self.log.warn("room lost to higher epoch; local replica closed",
                      room=name)
        self.mgr._update_node_stats()

    def snapshot(self) -> dict:
        """/debug/fleet payload."""
        return {
            "fenced": self.guard.fenced,
            "lease_age_s": round(self.guard.age(), 3),
            "fence_grace_s": self.guard.fence_grace_s,
            "owned_rooms": self.fence.owned_rooms(),
            "fence": dict(self.fence.stats),
            "plane": dict(self.stats),
            "failover": dict(self.orchestrator.stats),
            "rebalance": dict(self.rebalancer.stats),
        }


class FailoverOrchestrator:
    """Exactly-one-winner restoration of rooms pinned to dead nodes.

    Two independent mechanisms make the election safe even when the
    create-lock's TTL lapses mid-restore: the setnx lock keeps the
    common case cheap (losers never touch the checkpoint), and the
    epoch CAS inside fence.claim is the actual correctness boundary —
    two nodes holding the "lock" across a TTL lapse still resolve to
    one owner, because only one CAS can move the epoch record.
    """

    def __init__(self, manager, fence: RoomFence):
        self.mgr = manager
        self.router = manager.router
        self.fence = fence
        self.cfg = manager.config.fleet
        self.log = manager.log
        self.stats = {
            "restored": 0, "lock_losses": 0, "claim_losses": 0,
            "capacity_released": 0,
        }

    async def run_once(self) -> int:
        """One dead-pin scan; returns the number of rooms restored here.

        The port restores up to RESTORE_CONCURRENCY rooms of a scan at
        once (the reference restores them one after another): each
        restore is a dozen bus round trips and a wait for state_lock, and
        on a node whose event loop the tick's fan-out keeps busy every
        round trip waits for a turn of the loop, so one at a time a dead
        node's rooms outlived their checkpoints' TTL (on an H100 host,
        chip_smoke.py's migration phase: 190 of 264 rooms in 180 s; 64 at
        a time, 264 rooms in 10-13 s of the TTL's 30).
        Each room's restore is the reference's, under its own create-lock
        and epoch claim."""
        try:
            dead = await self.router.dead_room_pins()
        except (ConnectionError, OSError):
            return 0
        sem = asyncio.Semaphore(RESTORE_CONCURRENCY)

        async def one(name: str, dead_node: str) -> bool:
            async with sem:
                return await self._restore_one(name, dead_node)

        restored = sum(await asyncio.gather(*(one(n, d) for n, d in dead)))
        if dead and hasattr(self.router, "remove_dead_nodes"):
            try:
                await self.router.remove_dead_nodes()
            except (ConnectionError, OSError):
                pass
        if restored:
            self.mgr._update_node_stats()
        return restored

    async def _restore_one(self, name: str, dead_node: str) -> bool:
        """Win the election for one room pinned to a dead node and restore
        it here; False when another survivor restores it, the pin moved,
        this node has no room for it, or the bus failed."""
        bus = self.router.bus
        me = self.router.local_node.node_id
        lock = RESTORE_LOCK_PREFIX + name
        won = False
        try:
            if not await bus.setnx(lock, me, self.cfg.restore_lock_ttl_s):
                self.stats["lock_losses"] += 1
                return False   # another survivor is restoring this room
            try:
                # Re-check under the lock: a scan that started before
                # another survivor's restore finished still holds the
                # stale dead-pin — claiming now would steal the room
                # straight back off the fresh winner.
                if await bus.hget(NODE_ROOM_KEY, name) != dead_node:
                    return False
                if not await self.fence.claim(name):
                    self.stats["claim_losses"] += 1
                    return False   # raced a restorer across a lock lapse
                try:
                    # 'restore' admission: the fleet already admitted
                    # this room — a survivor at L4 must still adopt it
                    # (hard gates only; see governor.should_admit).
                    await self.mgr.get_or_create_room(
                        name, admission_kind="restore"
                    )
                    won = True
                except CapacityError:
                    # Claimed but cannot host. Keep the bumped epoch
                    # (it fences the dark owner out) and clear only
                    # the pin, so a survivor with headroom can claim
                    # e+1 and restore on its next scan.
                    await bus.hdel(NODE_ROOM_KEY, name)
                    self.fence.forget(name)
                    self.stats["capacity_released"] += 1
                    return False
            finally:
                # A winner KEEPS the lock until its TTL lapses: it is
                # the barrier that parks in-flight scans on other
                # survivors until the new pin is visible to them.
                # Every losing path frees it for the next scan.
                if not won:
                    await bus.delete(lock)
        except (ConnectionError, OSError):
            return False   # bus outage mid-restore: retry next scan
        self.stats["restored"] += 1
        self.log.info("room failed over", room=name,
                      dead_node=dead_node[:12])
        if self.mgr.telemetry is not None:
            self.mgr.telemetry.add("livekit_room_failovers_total")
        return True


class Rebalancer:
    """Load-aware drain of hot nodes via live migration (default-off).

    Plane-room occupancy is the load signal — a TPU node saturates its
    room tensor long before its CPUs (same reasoning as the selector's
    capacity gate). Moves are bounded per scan and go through the
    two-phase MigrationOrchestrator, so every move carries the same
    continuity guarantee as an operator-driven drain.
    """

    def __init__(self, manager, plane: FleetPlane):
        self.mgr = manager
        self.plane = plane
        cfg = manager.config.fleet
        self.enabled = cfg.rebalance_enabled
        self.interval_s = cfg.rebalance_interval_s
        self.headroom = cfg.rebalance_headroom
        self.max_moves = cfg.rebalance_max_moves
        self.log = manager.log
        self.stats = {"scans": 0, "moves": 0, "move_failures": 0}

    @staticmethod
    def _load(node) -> float:
        st = node.stats
        if st.plane_rooms_capacity:
            return st.plane_rooms_used / st.plane_rooms_capacity
        return float(st.num_rooms)

    async def run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.run_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — a scan must not kill
                # the loop; the next interval retries from fresh state.
                self.log.warn("rebalance scan failed", error=str(e))

    async def run_once(self) -> int:
        """One scan; returns the number of rooms moved off this node."""
        mgr = self.mgr
        if (
            mgr.migration is None
            or mgr.migration.draining
            or self.plane.fenced
            or not mgr.rooms
        ):
            return 0
        self.stats["scans"] += 1
        try:
            nodes = await self.router_nodes()
        except (ConnectionError, OSError):
            return 0
        if len(nodes) < 2:
            return 0
        me = mgr.router.local_node.node_id
        mine = next((n for n in nodes if n.node_id == me), None)
        if mine is None:
            return 0
        my_load = self._load(mine)
        mean = sum(self._load(n) for n in nodes) / len(nodes)
        if my_load <= mean * (1.0 + self.headroom):
            return 0
        if any(self._load(n) > my_load for n in nodes if n.node_id != me):
            return 0   # a hotter node exists; let it shed first
        # Shed the emptiest rooms first: each move frees a full plane row
        # while disrupting the fewest participants.
        names = sorted(
            mgr.rooms, key=lambda n: len(mgr.rooms[n].participants)
        )[: self.max_moves]
        moved = 0
        for name in names:
            if await mgr.migration.migrate_room(name):
                moved += 1
                self.stats["moves"] += 1
                self.log.info("rebalanced room off hot node", room=name,
                              load=round(my_load, 3), fleet_mean=round(mean, 3))
            else:
                self.stats["move_failures"] += 1
        return moved

    async def router_nodes(self):
        from livekit_server_tpu_torch.routing.node import NodeState

        nodes = await self.mgr.router.list_nodes()
        return [
            n for n in nodes
            if n.state != NodeState.SHUTTING_DOWN and n.is_available()
        ]
