"""Live room migration plane: two-phase handoff with rollback.

Port of the JAX package's service/migration.py. The device work is the
port runtime's snapshot_room / restore_room under state_lock: the loop
holds that lock from a step's upload to its commit, so a freeze-time
snapshot and an adoption's restore land between steps, never under one.

The reference moves a room between nodes only implicitly — the old node
dies, its lease lapses, and a survivor adopts the pin (routing-plane
failover). That path loses the freeze window's media and cannot be
*asked* to move a room. This module makes migration a first-class,
supervised, abortable operation:

  PREPARE   source freezes the row, snapshots it (LKCK-checksummed,
            plane_runtime.encode_room_snapshot) and publishes the
            snapshot inline on ``node_migrate:{target}`` together with a
            fresh attempt epoch. The target adopts the room into a local
            device row (restore_room under its state_lock), records a
            TTL-bounded *adoption*, and ACKs. A target that is draining,
            governed at L3+, or out of rows NACKs instead — governed
            admission: an inbound migration is deferrable load, so it is
            refused one ladder rung earlier than a client join.
  COMMIT    only after the ACK does the source repin the room to the
            target, flush the freeze-window bridge, publish COMMIT, and
            tear down its replica (close → signals clients MIGRATION so
            they reconnect and land on the new pin).
  ROLLBACK  on NACK, ACK timeout, or a bus failure anywhere in commit,
            the source unfreezes the row, re-asserts its own pin,
            publishes ABORT, and replays the bridged packets into its
            *local* ingest — the room never stopped being served and its
            audio shows no gap. Retries ride utils.backoff.retry_async;
            each attempt carries a new epoch and a timed-out epoch is
            aborted before the next attempt sends, so a late ACK from an
            aborted attempt finds a dead epoch and can never double-commit.

Freeze-window bridging: packets ingested on the source between the
snapshot and COMMIT would otherwise drop on the frozen row. A
FreezeBridge capture sink (ingest.freeze_sinks) buffers them — bounded,
audio evicts video when the budget is hit — and the commit path forwards
them to the target in BRIDGE chunks, so the cutover drops zero audio.

Node drain: ``drain_node`` flips the local node to SHUTTING_DOWN
(selectors exclude it), pins the overload governor at L_MAX, marks the
plane supervisor as draining (a quiescing plane must not be watchdog-
restarted), then migrates every local room off with bounded concurrency.
This is the real implementation behind LivekitServer.stop()'s graceful
path and the ``drain`` CLI verb.

Adoptions that never see a COMMIT (source died mid-handoff, ABORT lost)
are reaped after ``migration.adopt_ttl_s`` — the target releases the row
and forgets the room, so a failed handoff leaks nothing on either side.
"""

from __future__ import annotations

import asyncio
import base64
from collections import deque
from dataclasses import dataclass, field

from livekit_server_tpu_torch.protocol import models as pm
from livekit_server_tpu_torch.routing.fleet import FencedWriteRejected
from livekit_server_tpu_torch.routing.node import NodeState
from livekit_server_tpu_torch.routing.selector import NoNodesAvailable
from livekit_server_tpu_torch.rtc.room import Room
from livekit_server_tpu_torch.runtime.governor import L_PAUSE
from livekit_server_tpu_torch.runtime.ingest import PacketIn
from livekit_server_tpu_torch.runtime import CapacityError
from livekit_server_tpu_torch.utils.backoff import BackoffPolicy, retry_async

# PacketIn fields that ride a BRIDGE message alongside the b64 payload.
_PKT_FIELDS = (
    "track", "sn", "ts", "size", "marker", "layer", "temporal", "keyframe",
    "layer_sync", "begin_pic", "pid", "tl0", "keyidx", "frame_ms",
    "audio_level", "arrival_rtp", "ts_aligned",
)


def _encode_pkt(pkt: PacketIn) -> dict:
    d = {f: getattr(pkt, f) for f in _PKT_FIELDS}
    d["payload"] = base64.b64encode(pkt.payload).decode("ascii")
    return d


def _decode_pkt(d: dict, row: int) -> PacketIn:
    """Rebuild a PacketIn on the ADOPTING node's row (rows are per-node
    slot allocations; only the room identity travels, never the row)."""
    kw = {f: d[f] for f in _PKT_FIELDS if f in d}
    kw["payload"] = base64.b64decode(d.get("payload", ""))
    return PacketIn(room=row, **kw)


class FreezeBridge:
    """Bounded capture buffer for one frozen row's freeze window.

    Audio priority: at budget, an incoming video packet is dropped
    outright and an incoming audio packet evicts the oldest buffered
    video packet first (oldest audio only when the buffer is all audio).
    ``drain()`` returns everything in capture order and resets, so the
    commit path can flush repeatedly until the window runs dry.
    """

    def __init__(self, row: int, is_video_col, max_packets: int):
        self.row = row
        self._is_video = is_video_col       # host mirror view [tracks]
        self.budget = max(1, int(max_packets))
        self._buf: deque = deque()          # (seq, pkt)
        self._seq = 0
        self.captured = 0
        self.dropped = 0

    def capture(self, pkt: PacketIn) -> None:
        video = bool(self._is_video[pkt.track])
        if len(self._buf) >= self.budget:
            if video:
                self.dropped += 1
                return
            evict = None
            for i, (_, old) in enumerate(self._buf):
                if self._is_video[old.track]:
                    evict = i
                    break
            if evict is None:
                evict = 0                   # all-audio: shed the oldest
            del self._buf[evict]
            self.dropped += 1
        self._seq += 1
        self._buf.append((self._seq, pkt))
        self.captured += 1

    def drain(self) -> list[PacketIn]:
        out = [p for _, p in self._buf]
        self._buf.clear()
        return out


@dataclass
class _Attempt:
    """Source side: one in-flight PREPARE awaiting its ACK/NACK."""

    epoch: int
    target: str
    ack: asyncio.Future


@dataclass
class _Adoption:
    """Target side: an adopted room awaiting COMMIT (or reaping).

    The adopted row stays frozen until COMMIT: packets that reach the
    target directly during the handoff window (the pin moves before the
    freeze-window flush finishes) land in ``bridge``, while the source's
    BRIDGE messages accumulate in ``bridged``. COMMIT replays bridged
    first, then the local captures — SN order stays monotonic, so the
    munger never sees the bridged tail as stale."""

    epoch: int
    source: str
    deadline: float                         # loop.time()-based
    row: int = field(default=-1)
    bridge: FreezeBridge | None = None      # direct packets, pre-COMMIT
    bridged: list = field(default_factory=list)  # source freeze window


class MigrationOrchestrator:
    """One per RoomManager (constructed only when the router has a bus).

    All bus traffic rides one channel per node, ``node_migrate:{id}``,
    with dict messages keyed by ``kind``:

      prepare  {room, epoch, source, snapshot, info}   source → target
      ack/nack {room, epoch, target[, reason]}         target → source
      commit   {room, epoch}                           source → target
      abort    {room, epoch}                           source → target
      bridge   {room, packets: [...]}                  source → target
      drain    {}                                      admin  → node
    """

    def __init__(self, manager):
        self.mgr = manager
        self.cfg = manager.config.migration
        self.router = manager.router
        self.bus = manager.router.bus
        self.log = manager.log
        self.selector = None        # wired by create_server (node ranking)
        self.on_adopt: list = []    # test seam: callbacks fired per adoption
        self.draining = False
        self._epoch = 0             # monotonic attempt counter (this node)
        self._attempts: dict[str, _Attempt] = {}
        self._adoptions: dict[str, _Adoption] = {}
        self._migrating: set[str] = set()
        self._sub = None
        self._worker_task: asyncio.Task | None = None
        self._reaper_task: asyncio.Task | None = None
        self._tasks: set[asyncio.Task] = set()
        self.stats = {
            "migrations": 0, "commits": 0, "rollbacks": 0, "timeouts": 0,
            "nacks_sent": 0, "nacks_received": 0, "stale_acks": 0,
            "stale_commits": 0, "adoptions": 0, "commits_in": 0,
            "adoptions_released": 0, "bridged_out": 0, "bridged_in": 0,
            "bridge_dropped": 0, "drains": 0,
            # Handoffs whose ownership epoch was claimed away mid-flight
            # by a failover restorer (routing/fleet.py): the local
            # replica is closed by the fence, not rolled back.
            "fenced_handoffs": 0,
            # Handoffs that snapshotted after settle_staged timed out (a
            # tick staged before the freeze had not completed).
            "settle_timeouts": 0,
        }

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        me = self.router.local_node.node_id
        self._sub = self.bus.subscribe(f"node_migrate:{me}")
        self._worker_task = asyncio.ensure_future(self._worker())
        self._reaper_task = asyncio.ensure_future(self._adopt_reaper())

    async def stop(self) -> None:
        if self._sub is not None:
            self._sub.close()
            self._sub = None
        tasks = [t for t in (self._worker_task, self._reaper_task)
                 if t is not None]
        tasks += list(self._tasks)
        self._worker_task = self._reaper_task = None
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass

    # -- bus plumbing -----------------------------------------------------
    async def _send(self, node_id: str, msg: dict) -> int:
        return await self.bus.publish(f"node_migrate:{node_id}", msg)

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._task_done)
        return task

    def _task_done(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            self.log.warn(
                "migration handler task failed",
                error=repr(task.exception()),
            )

    @staticmethod
    def _now() -> float:
        return asyncio.get_running_loop().time()

    async def _worker(self) -> None:
        async for raw in self._sub:
            msg = raw if isinstance(raw, dict) else None
            if msg is None:
                continue
            kind = msg.get("kind", "")
            if kind in ("ack", "nack"):
                self._resolve(msg, kind)   # inline: unblocks a waiter
            elif kind in ("prepare", "commit", "abort", "bridge"):
                self._spawn(getattr(self, f"_handle_{kind}")(msg))
            elif kind == "drain":
                self._spawn(self.drain_node())

    def _resolve(self, msg: dict, kind: str) -> None:
        """ACK/NACK dispatch with the epoch guard: a reply whose epoch
        does not match the room's CURRENT attempt is from an aborted
        earlier attempt and is dropped — it must never resolve the new
        attempt's future (the double-commit hazard)."""
        att = self._attempts.get(msg.get("room", ""))
        if att is None or att.epoch != msg.get("epoch"):
            self.stats["stale_acks"] += 1
            self.log.warn(
                "stale migration reply ignored (epoch guard)",
                room=msg.get("room", ""), kind=kind,
                epoch=msg.get("epoch"),
            )
            return
        if not att.ack.done():
            att.ack.set_result((kind, msg.get("reason", "")))

    # -- source side: migrate one room ------------------------------------
    async def migrate_room(self, name: str, target_node_id: str = "") -> bool:
        """Move one locally-served room to another node. Returns True on
        a committed handoff; False leaves the room serving here."""
        mgr = self.mgr
        if name not in mgr.rooms or name in self._migrating:
            return False
        self._migrating.add(name)
        try:
            if target_node_id:
                candidates = [target_node_id]
            else:
                try:
                    candidates = await self._candidates()
                except (ConnectionError, OSError) as e:
                    self.log.warn("migration: node list unavailable",
                                  room=name, error=str(e))
                    return False
            if not candidates:
                self.log.warn("migration: no candidate nodes", room=name)
                return False
            for target in candidates:
                if name not in mgr.rooms:
                    return False           # deleted underneath us
                if await self._attempt_handoff(name, target):
                    self.stats["migrations"] += 1
                    if mgr.telemetry is not None:
                        mgr.telemetry.add("livekit_room_migrations_total")
                    return True
            return False
        finally:
            self._migrating.discard(name)

    async def _candidates(self) -> list[str]:
        """Peer nodes ranked by the placement selector (load/region aware,
        by repeated selection); selector-refused peers still close the
        list as last resorts — they may NACK, which is cheap."""
        me = self.router.local_node.node_id
        nodes = await self.router.list_nodes()
        peers = [
            n for n in nodes
            if n.node_id != me and n.state != NodeState.SHUTTING_DOWN
        ]
        if self.selector is None:
            return [n.node_id for n in peers]
        ordered: list[str] = []
        pool = list(peers)
        while pool:
            try:
                n = self.selector.select_node(list(pool))
            except NoNodesAvailable:
                break
            ordered.append(n.node_id)
            pool = [m for m in pool if m.node_id != n.node_id]
        ordered += [n.node_id for n in peers if n.node_id not in ordered]
        return ordered

    async def _attempt_handoff(self, name: str, target: str) -> bool:
        mgr = self.mgr
        rt = mgr.runtime
        room = mgr.rooms.get(name)
        if room is None:
            return False
        row = room.slots.row
        bridge = FreezeBridge(
            row, rt.meta.is_video[row], self.cfg.bridge_max_packets
        )
        # Freeze + tap: from here the row's packets stop staging and are
        # captured for bridging instead (ingest.push frozen branch).
        # Already-staged packets move into the bridge too — drain() has
        # no frozen filter, so left alone they would enter the device
        # after the snapshot below and race the teardown.
        rt.ingest.frozen_rows.add(row)
        rt.ingest.freeze_sinks[row] = bridge.capture
        # The port also takes the row's packets out of the loop's staged
        # tick (older than the ingest buffer's, so first).
        staged = rt.extract_staged_row(row)
        for pkt in (staged or []) + rt.ingest.extract_row(row):
            bridge.capture(pkt)
        bb = getattr(rt, "blackbox", None)
        if bb is not None:
            from livekit_server_tpu_torch.runtime.trace import EV_MIG_FREEZE

            bb.emit(row, EV_MIG_FREEZE)
        epoch = 0
        try:
            # Let the tick in flight (and a staged tick whose packets could
            # not be taken out) finish: their packets go out from here and
            # land in the snapshot (the port's settle; the reference
            # snapshots at once, and loses such packets of the row when
            # the commit closes it first).
            if not await rt.settle_staged(staged=staged is None):
                self.stats["settle_timeouts"] += 1
                self.log.warn("handoff snapshot after a settle timeout", room=name)
            async with rt.state_lock:      # vs. the device step
                snap = rt.snapshot_room(row)
            payload = rt.encode_room_snapshot(snap)
            if mgr.fault is not None:
                payload = mgr.fault.corrupt_handoff(payload)
            verdict, reason = "error", ""
            try:
                verdict, reason, epoch = await self._prepare_exchange(
                    name, target, payload, room
                )
            except (
                TimeoutError, asyncio.TimeoutError, ConnectionError, OSError,
            ) as e:
                verdict, reason = "timeout", f"{type(e).__name__}: {e}"
            if verdict == "ack":
                try:
                    if await self._commit(name, target, room, bridge, epoch):
                        return True
                except FencedWriteRejected:
                    # A failover restorer claimed a higher epoch mid-
                    # commit: the fence's on_lost already closed the
                    # local replica, so there is nothing to roll back
                    # INTO. Abort the target's adoption and stand down.
                    self.stats["fenced_handoffs"] += 1
                    try:
                        await self._send(
                            target,
                            {"kind": "abort", "room": name, "epoch": epoch},
                        )
                    except (ConnectionError, OSError):
                        pass   # target's adopt TTL reaps it
                    self.log.warn(
                        "handoff fenced out by a higher ownership epoch",
                        room=name, target=target[:12],
                    )
                    return False
                reason = "commit failed: bus error"
            elif verdict == "nack":
                self.stats["nacks_received"] += 1
            await self._rollback(
                name, target, room, bridge, epoch,
                reason=f"{verdict}: {reason}",
            )
            return False
        finally:
            # Idempotent with _rollback's unfreeze; on commit the row is
            # already released and these are no-ops.
            rt.ingest.freeze_sinks.pop(row, None)
            rt.ingest.frozen_rows.discard(row)
            self.stats["bridge_dropped"] += bridge.dropped

    async def _prepare_exchange(
        self, name: str, target: str, payload: str, room: Room
    ):
        """Send PREPARE and await the ACK/NACK, with retry_async supplying
        the backoff schedule. Each attempt mints a fresh epoch; a timed-out
        epoch is ABORTed before the retry sends, so the target releases a
        silently-adopted row and a late ACK finds a dead epoch."""
        me = self.router.local_node.node_id
        last = {"epoch": 0}

        async def once():
            self._epoch += 1
            epoch = last["epoch"] = self._epoch
            fut = asyncio.get_running_loop().create_future()
            self._attempts[name] = _Attempt(epoch=epoch, target=target, ack=fut)
            n = await self._send(target, {
                "kind": "prepare", "room": name, "epoch": epoch,
                "source": me, "snapshot": payload,
                "info": room.info.to_dict(),
            })
            if n == 0:
                # Dead target detected at publish time — cheaper than
                # burning the full ACK timeout on a node that is gone.
                raise ConnectionError(f"no migration listener on {target[:12]}")
            try:
                return await asyncio.wait_for(fut, self.cfg.ack_timeout_s)
            except (TimeoutError, asyncio.TimeoutError):
                self.stats["timeouts"] += 1
                try:
                    await self._send(
                        target, {"kind": "abort", "room": name, "epoch": epoch}
                    )
                except (ConnectionError, OSError):
                    pass   # severed bus: the target's adopt TTL reaps it
                raise

        policy = BackoffPolicy(
            base=self.cfg.retry_backoff_base_s,
            max_delay=self.cfg.retry_backoff_max_s,
            max_attempts=max(1, self.cfg.retry_attempts),
        )
        try:
            kind, reason = await retry_async(
                once, policy,
                retry_on=(
                    TimeoutError, asyncio.TimeoutError,
                    ConnectionError, OSError,
                ),
            )
            return kind, reason, last["epoch"]
        finally:
            self._attempts.pop(name, None)

    async def _commit(
        self, name: str, target: str, room: Room,
        bridge: FreezeBridge, epoch: int,
    ) -> bool:
        """Phase two. Order matters: repin first (new joins route to the
        target), bridge the freeze window, COMMIT, and only then tear
        down the local replica — a failure before teardown rolls back to
        a fully-serving source."""
        mgr = self.mgr
        row = room.slots.row
        try:
            if mgr.fault is not None and mgr.fault.mig_sever_commit():
                raise ConnectionError("bus severed mid-handoff (fault)")
            await self.router.set_node_for_room(name, target)
            await self._flush_bridge(name, target, bridge)
            # Deregister BEFORE the final flush: nothing new enters the
            # bridge once the manager stops routing here, so the flush
            # below empties it for good — and COMMIT is sent only after
            # the last BRIDGE message, so on the target's FIFO channel
            # the whole freeze window precedes the unfreeze. A failure
            # past this point rolls back; _rollback re-registers.
            mgr.rooms.pop(name, None)
            mgr._row_to_room.pop(row, None)
            await self._flush_bridge(name, target, bridge)
            await self._send(
                target, {"kind": "commit", "room": name, "epoch": epoch}
            )
        except (ConnectionError, OSError) as e:
            self.log.warn(
                "migration commit failed; rolling back",
                room=name, target=target[:12], error=str(e),
            )
            return False
        # Committed: the pin and the row now belong to the target.
        room.close(pm.DisconnectReason.MIGRATION)
        mgr._update_node_stats()
        self.stats["commits"] += 1
        bb = getattr(mgr.runtime, "blackbox", None)
        if bb is not None:
            from livekit_server_tpu_torch.runtime.trace import EV_MIG_COMMIT

            bb.emit(row, EV_MIG_COMMIT, float(epoch))
        self.log.info(
            "room migrated", room=name, target=target[:12], epoch=epoch,
            bridged=bridge.captured,
        )
        return True

    async def _flush_bridge(
        self, name: str, target: str, bridge: FreezeBridge
    ) -> None:
        chunk = max(1, int(self.cfg.bridge_chunk))
        for _ in range(16):   # bounded: the source stops feeding once unpinned
            pkts = bridge.drain()
            if not pkts:
                return
            for i in range(0, len(pkts), chunk):
                await self._send(target, {
                    "kind": "bridge", "room": name,
                    "packets": [_encode_pkt(p) for p in pkts[i:i + chunk]],
                })
            self.stats["bridged_out"] += len(pkts)

    async def _rollback(
        self, name: str, target: str, room: Room,
        bridge: FreezeBridge, epoch: int, reason: str = "",
    ) -> None:
        mgr = self.mgr
        row = room.slots.row
        # Re-register first (idempotent): _commit deregisters before its
        # final flush, so a failure after that point must restore local
        # serving before anything else.
        mgr.rooms[name] = room
        mgr._row_to_room[row] = room
        # The pin may have moved if commit died between repin and COMMIT;
        # the room still serves HERE, so re-assert our pin (idempotent
        # when it never moved). The row stays frozen across these sends —
        # live packets keep landing in the bridge, in order.
        me = self.router.local_node.node_id
        try:
            await self.router.set_node_for_room(name, me)
        except (ConnectionError, OSError):
            pass   # bus down: lease failover will converge the pin
        except FencedWriteRejected:
            # A higher epoch owns the room now (takeover raced the
            # rollback): the fence's on_lost just closed — and popped —
            # the replica re-registered above. Stand down entirely; the
            # epoch holder serves the room.
            self.stats["fenced_handoffs"] += 1
            self.log.warn(
                "rollback fenced out by a higher ownership epoch", room=name
            )
            return
        try:
            await self._send(
                target, {"kind": "abort", "room": name, "epoch": epoch}
            )
        except (ConnectionError, OSError):
            pass   # target reaps the adoption via its TTL
        # Replay the freeze window into the LOCAL ingest: these packets
        # were never rx-counted (the frozen branch precedes accounting),
        # so the default counting path keeps the books exact — and the
        # room's audio shows zero gap across the aborted handoff.
        replayed = await self._replay_unfreeze(row, [], bridge)
        self.stats["rollbacks"] += 1
        self.log.warn(
            "migration rolled back; room keeps serving",
            room=name, target=target[:12], reason=reason, replayed=replayed,
        )
        bb = getattr(mgr.runtime, "blackbox", None)
        if bb is not None:
            from livekit_server_tpu_torch.runtime.trace import EV_MIG_ABORT

            bb.emit(row, EV_MIG_ABORT, float(epoch))
            bb.dump_to(row, f"migration_abort:{reason[:40]}")

    async def _replay_unfreeze(
        self, row: int, head: list, bridge: FreezeBridge | None
    ) -> int:
        """Meter ``head`` plus the row's freeze-bridge captures into the
        local ingest, then unfreeze. One tick's staging set has only
        dims.pkts slots per (room, track); dumping the whole window in
        one burst overflows them and the excess capacity-drops — the
        replay must spread across ticks instead. The row stays frozen
        between rounds so live packets keep queueing in the bridge
        (in arrival order, behind the window being replayed); the final
        drain → unfreeze runs in one sync block, so nothing slips in
        unordered."""
        ing = self.mgr.runtime.ingest
        k_max = int(ing.dims.pkts)
        tick_s = max(0.001, getattr(self.mgr.runtime, "tick_ms", 10) / 1000.0)
        pending = deque(head)
        replayed = 0
        for _ in range(256):          # bound: ~2.5s of ticks, then give up
            if bridge is not None:
                pending.extend(bridge.drain())
            ing.frozen_rows.discard(row)
            while pending and int(ing._count[row, pending[0].track]) < k_max:
                ing.push(pending.popleft(), _fault_ok=True)
                replayed += 1
            # Unfreeze only with headroom left in this tick's slots, so
            # a live packet arriving right behind us isn't shed either.
            if not pending and int(ing._count[row].max()) < k_max:
                break
            ing.frozen_rows.add(row)
            await asyncio.sleep(tick_s)
        else:
            ing.frozen_rows.discard(row)
            while pending:            # bound hit: stop metering, best effort
                ing.push(pending.popleft(), _fault_ok=True)
                replayed += 1
        ing.freeze_sinks.pop(row, None)
        ing.frozen_rows.discard(row)
        if bridge is not None:
            for pkt in bridge.drain():
                ing.push(pkt, _fault_ok=True)
                replayed += 1
        return replayed

    # -- target side ------------------------------------------------------
    async def _handle_prepare(self, msg: dict) -> None:
        mgr = self.mgr
        name = msg.get("room", "")
        epoch = int(msg.get("epoch", 0))
        source = msg.get("source", "")
        if not name or not source:
            return
        me = self.router.local_node.node_id

        async def reply(kind: str, **extra) -> None:
            try:
                await self._send(source, {
                    "kind": kind, "room": name, "epoch": epoch,
                    "target": me, **extra,
                })
            except (ConnectionError, OSError):
                pass   # source times out and rolls back on its own

        async def nack(why: str) -> None:
            self.stats["nacks_sent"] += 1
            self.log.warn("migration PREPARE refused", room=name,
                          source=source[:12], reason=why)
            await reply("nack", reason=why)

        # Already hosting: a retry whose earlier ACK was lost re-ACKs the
        # pending adoption under the NEW epoch; a room we serve outright
        # (committed, or never migrated) NACKs — two nodes must never
        # both serve one room.
        ad = self._adoptions.get(name)
        if name in mgr.rooms:
            if ad is None:
                await nack("already serving this room")
                return
            ad.epoch = epoch
            ad.source = source
            ad.deadline = self._now() + self.cfg.adopt_ttl_s
            if mgr.fault is not None and mgr.fault.mig_swallow_prepare():
                return
            if mgr.fault is not None:
                await mgr.fault.mig_delay_ack()
            await reply("ack")
            return
        # Governed admission, before any decode work. An inbound
        # migration is deferrable load: refuse at L3+ (client joins only
        # stop at L4) and always while draining.
        if self.draining:
            await nack("target draining")
            return
        gov = mgr.governor
        if gov is not None and (gov.drain_hold or gov.level >= L_PAUSE):
            await nack(f"target overloaded (L{gov.level})")
            return
        why = mgr._admission_denied("room")
        if why:
            await nack(why)
            return
        try:
            snap = mgr.runtime.decode_room_snapshot(msg.get("snapshot", ""))
        except Exception as e:  # noqa: BLE001 — checksum/codec damage
            await nack(f"snapshot rejected: {e}")
            return
        info = None
        if isinstance(msg.get("info"), dict):
            try:
                info = pm.RoomInfo.from_dict(msg["info"])
            except (TypeError, ValueError, KeyError):
                info = None
        lock = mgr._create_locks.setdefault(name, asyncio.Lock())
        async with lock:
            if name in mgr.rooms:          # raced a concurrent create
                await nack("already serving this room")
                return
            try:
                room = Room(name, mgr.runtime, info=info)
            except CapacityError as e:
                await nack(str(e) or "no free room row")
                return
            room.udp = mgr.udp
            room.crypto = mgr.crypto
            room.admission = mgr._admission_denied
            try:
                async with mgr.runtime.state_lock:   # vs. the device step
                    mgr.runtime.restore_room(room.slots.row, snap)
            except Exception as e:  # noqa: BLE001 — dims drifted vs source
                room.close(pm.DisconnectReason.MIGRATION)
                await nack(f"snapshot restore failed: {e}")
                return
            mgr.rooms[name] = room
            mgr._row_to_room[room.slots.row] = room
        mgr._create_locks.pop(name, None)
        # Freeze the adopted row until COMMIT: traffic that beats the
        # freeze-window flush here (the pin moves first) is captured and
        # replayed AFTER the bridged packets, preserving SN order.
        arow = room.slots.row
        abridge = FreezeBridge(
            arow, mgr.runtime.meta.is_video[arow], self.cfg.bridge_max_packets
        )
        mgr.runtime.ingest.frozen_rows.add(arow)
        mgr.runtime.ingest.freeze_sinks[arow] = abridge.capture
        self._adoptions[name] = _Adoption(
            epoch=epoch, source=source,
            deadline=self._now() + self.cfg.adopt_ttl_s,
            row=arow, bridge=abridge,
        )
        mgr._on_room_adopted(room)
        for cb in list(self.on_adopt):
            cb(room)
        mgr._update_node_stats()
        self.stats["adoptions"] += 1
        self.log.info("migration PREPARE adopted", room=name,
                      source=source[:12], epoch=epoch, row=room.slots.row)
        if mgr.fault is not None and mgr.fault.mig_swallow_prepare():
            return   # chaos drill: adopted, then went silent — no ACK ever
        if mgr.fault is not None:
            await mgr.fault.mig_delay_ack()
        await reply("ack")

    async def _handle_commit(self, msg: dict) -> None:
        name = msg.get("room", "")
        ad = self._adoptions.get(name)
        if ad is None or ad.epoch != msg.get("epoch"):
            # Aborted/expired adoption, or a stale epoch: never finalize.
            self.stats["stale_commits"] += 1
            return
        del self._adoptions[name]
        self.stats["commits_in"] += 1
        # The source's COMMIT repin transferred the ownership epoch to
        # us; adopt the record now so our own checkpoint writes are
        # fenced under it (guarded writes would auto-assume lazily, but
        # an explicit adopt keeps /debug/fleet truthful immediately).
        fence = getattr(self.router, "fence", None)
        if fence is not None:
            try:
                await fence.assume(name)
            except (ConnectionError, OSError):
                pass   # lazy auto-assume covers it on the next write
        room = self.mgr.rooms.get(name)
        # Replay the source's freeze window first, then whatever arrived
        # here directly while the row was frozen — monotonic SN order, so
        # the munger accepts the bridged tail instead of dropping it.
        await self._replay_unfreeze(ad.row, ad.bridged, ad.bridge)
        if ad.bridge is not None:
            self.stats["bridge_dropped"] += ad.bridge.dropped
        ad.bridged = []
        self.log.info("migration committed (target)", room=name,
                      row=room.slots.row if room else -1)
        try:
            if room is not None:
                await self.mgr.store.store_room(room.info)
        except (ConnectionError, OSError):
            pass   # best-effort; the store heals on the next room update

    async def _handle_abort(self, msg: dict) -> None:
        name = msg.get("room", "")
        ad = self._adoptions.get(name)
        if ad is None or ad.epoch != msg.get("epoch"):
            return   # not our adoption (or already committed): ignore
        await self._release_adoption(name, "aborted by source")

    async def _handle_bridge(self, msg: dict) -> None:
        name = msg.get("room", "")
        room = self.mgr.rooms.get(name)
        if room is None:
            return   # adoption already released: the window died with it
        ad = self._adoptions.get(name)
        ing = self.mgr.runtime.ingest
        n = 0
        for d in msg.get("packets", []):
            try:
                pkt = _decode_pkt(d, room.slots.row)
            except (TypeError, ValueError, KeyError):
                continue
            if ad is not None:
                # Pre-COMMIT: hold the freeze window aside; COMMIT
                # replays it before the row's own captures.
                ad.bridged.append(pkt)
            else:
                ing.push(pkt, _fault_ok=True)
            n += 1
        self.stats["bridged_in"] += n

    async def _adopt_reaper(self) -> None:
        """Release adoptions whose COMMIT never arrived (source died, or
        its ABORT was lost): the row is reclaimed and the pin — which
        still names the source — is left alone for lease failover."""
        interval = max(0.05, self.cfg.adopt_ttl_s / 4.0)
        while True:
            await asyncio.sleep(interval)
            now = self._now()
            expired = [
                n for n, ad in self._adoptions.items() if ad.deadline <= now
            ]
            for name in expired:
                await self._release_adoption(
                    name, "no COMMIT before adopt_ttl_s"
                )

    async def _release_adoption(self, name: str, why: str) -> None:
        ad = self._adoptions.pop(name, None)
        mgr = self.mgr
        room = mgr.rooms.pop(name, None)
        if ad is not None:
            mgr.runtime.ingest.freeze_sinks.pop(ad.row, None)
            mgr.runtime.ingest.frozen_rows.discard(ad.row)
        if room is None:
            return
        mgr._row_to_room.pop(room.slots.row, None)
        # close() releases the UDP row, clears the plane row, and frees
        # the slot — no row leak from an abandoned handoff. The routing
        # pin is NOT ours to clear: it still names the source.
        room.close(pm.DisconnectReason.MIGRATION)
        mgr._update_node_stats()
        self.stats["adoptions_released"] += 1
        self.log.warn("migration adoption released", room=name, reason=why)

    # -- node drain -------------------------------------------------------
    async def drain_node(self) -> dict:
        """Migrate every local room off this node with bounded concurrency
        while the node refuses all new admissions. Used by the graceful
        server stop and the ``drain`` CLI verb."""
        mgr = self.mgr
        if self.draining:
            return {"already_draining": True}
        self.draining = True
        self.stats["drains"] += 1
        self.router.local_node.state = NodeState.SHUTTING_DOWN
        try:
            await self.router.drain()   # republish: selectors exclude us
        except (ConnectionError, OSError):
            pass
        if mgr.governor is not None:
            mgr.governor.hold_max("node draining")
        if mgr.supervisor is not None:
            # A draining plane quiesces on purpose; the watchdog must not
            # read the calm as a stall and restart it mid-drain.
            mgr.supervisor.draining = True
        names = list(mgr.rooms)
        sem = asyncio.Semaphore(max(1, int(self.cfg.drain_concurrency)))
        results: dict[str, bool] = {}

        async def one(name: str) -> None:
            async with sem:
                results[name] = await self.migrate_room(name)

        if names:
            await asyncio.gather(*(one(n) for n in names))
        moved = sum(1 for ok in results.values() if ok)
        failed = sorted(n for n, ok in results.items() if not ok)
        if mgr.telemetry is not None:
            mgr.telemetry.add("livekit_node_drains_total")
        self.log.info("node drain finished", rooms=len(names),
                      migrated=moved, failed=len(failed))
        return {"rooms": len(names), "migrated": moved, "failed": failed}

    # -- visibility -------------------------------------------------------
    def snapshot(self) -> dict:
        """State dump for /debug/migration."""
        return {
            "draining": self.draining,
            "epoch": self._epoch,
            "in_flight": sorted(self._migrating),
            "attempts": {
                n: {"epoch": a.epoch, "target": a.target[:12]}
                for n, a in self._attempts.items()
            },
            "adoptions": {
                n: {"epoch": a.epoch, "source": a.source[:12], "row": a.row}
                for n, a in self._adoptions.items()
            },
            "stats": dict(self.stats),
        }
