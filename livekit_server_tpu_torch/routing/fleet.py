"""Epoch-fenced room ownership: the partition-tolerance primitives.

A copy of the JAX package's routing/fleet.py, with one addition:
RoomFence.guarded_set_many.

The lease-based failover of routing/router.py answers "who is dead?"
but not "who may write?". Under a bus partition both answers go wrong
at once: a survivor restores a room from its KV checkpoint while the
original owner — alive on the dark side — keeps forwarding media and
writing checkpoints, so the heal delivers duplicate wire packets and a
stale checkpoint clobbering the winner's. This module makes ownership
explicit and *fenced*, in the style of fencing tokens on a lease
service:

  RoomFence   every room pin carries a monotonically increasing
              ownership epoch in KV (``room_epoch:{room}`` holding
              ``{"e": epoch, "n": node_id}``). Taking a room over is an
              epoch CAS — exactly one claimant can move e→e+1 from a
              given record. Every checkpoint/pin write first CAS-asserts
              the writer's own record; a stale owner's expect string
              names a dead epoch, so its write loses instead of
              clobbering (FencedWriteRejected), and the loss doubles as
              the "you no longer own this room" signal (on_lost).
  LeaseGuard  a node that cannot refresh its liveness lease for longer
              than ``fence_grace`` must assume a survivor is (about to
              be) taking its rooms and go silent FIRST: the guard turns
              refresh outcomes into fence/recover transitions the
              FleetPlane maps onto egress muting, checkpoint freeze and
              supervisor quiesce (service/fleetplane.py).

No-overlap timeline (all clocks start at the dark node's last
successful refresh, t=0): the lease key expires at t=lease_ttl, so no
survivor can even observe the death before then, and its dead-pin scan
lands at most ``failover_interval`` later — the earliest takeover
completes after t=lease_ttl. The dark node self-fences at
t≈fence_grace. ``fence_grace < lease_ttl + failover_interval`` (config
validation) keeps the mute strictly ahead of any takeover; the
``fence_grace ≤ 2×lease_ttl`` ceiling bounds how long a blip can mute a
healthy node.

The CAS-assert-then-write pair is not transactional: a claim landing in
the gap can still race one write. That window is bounded by one bus
round-trip and only matters to checkpoint freshness (the winner
restores once, then every later stale write is rejected); pins and
epoch records themselves only ever move by CAS.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Callable

ROOM_EPOCH_PREFIX = "room_epoch:"


class FencedWriteRejected(Exception):
    """A guarded write lost its epoch CAS: a higher epoch exists, so this
    node no longer owns the room and must go quiet for it."""

    def __init__(self, room: str):
        super().__init__(f"write fenced: room {room!r} owned at a higher epoch")
        self.room = room


def _record(epoch: int, node_id: str) -> str:
    # Compact separators: CAS compares exact raw strings, so every writer
    # must produce byte-identical encodings for identical records.
    return json.dumps({"e": epoch, "n": node_id}, separators=(",", ":"))


def _parse(raw: str | None) -> tuple[int, str]:
    if not raw:
        return 0, ""
    try:
        d = json.loads(raw)
        return int(d.get("e", 0)), str(d.get("n", ""))
    except (ValueError, TypeError):
        return 0, ""


class RoomFence:
    """Per-node view of room ownership epochs, backed by bus.cas.

    ``_owned`` caches the raw record string this node last wrote per
    room — the exact CAS expect for every guarded operation. Losing any
    CAS pops the cache and fires ``on_lost`` so the owner of the local
    replica (RoomManager) can tear it down without touching KV.
    """

    def __init__(self, bus, node_id: str, log=None):
        self.bus = bus
        self.node_id = node_id
        self.log = log
        self._owned: dict[str, str] = {}     # room → raw owned record
        self.on_lost: list[Callable[[str], None]] = []
        self.stats = {
            "claims": 0, "claim_losses": 0, "assumes": 0, "transfers": 0,
            "writes_fenced": 0, "releases": 0,
        }

    @staticmethod
    def _key(room: str) -> str:
        return ROOM_EPOCH_PREFIX + room

    # -- introspection ----------------------------------------------------
    def owns(self, room: str) -> bool:
        return room in self._owned

    def epoch_of(self, room: str) -> int:
        """Locally-owned epoch (0 = not owned here)."""
        return _parse(self._owned.get(room))[0]

    def owned_rooms(self) -> list[str]:
        return sorted(self._owned)

    async def read(self, room: str) -> tuple[int, str]:
        """Current (epoch, holder) straight from KV; (0, "") = unclaimed."""
        return _parse(await self.bus.get(self._key(room)))

    # -- ownership moves (all CAS) ----------------------------------------
    async def claim(self, room: str) -> bool:
        """Move the room's epoch to cur+1 naming this node. Exactly one
        claimant wins from any given record; winning invalidates every
        prior owner's guarded writes by construction."""
        key = self._key(room)
        cur = await self.bus.get(key)
        if cur is not None and cur == self._owned.get(room):
            return True   # already own it at the current epoch
        epoch, _holder = _parse(cur)
        nxt = _record(epoch + 1, self.node_id)
        if await self.bus.cas(key, cur, nxt):
            self._owned[room] = nxt
            self.stats["claims"] += 1
            return True
        self.stats["claim_losses"] += 1
        return False

    async def assume(self, room: str) -> bool:
        """Adopt ownership KV already assigns to this node (the target
        side of a transfer), or claim an unclaimed room. Never steals
        from another holder — a fenced node recovering must not re-claim
        rooms a survivor took while it was dark."""
        raw = await self.bus.get(self._key(room))
        if raw is None:
            return await self.claim(room)
        epoch, holder = _parse(raw)
        if holder == self.node_id:
            self._owned[room] = raw
            self.stats["assumes"] += 1
            return True
        return False

    async def transfer(self, room: str, target_node_id: str) -> bool:
        """Hand the room to ``target`` at epoch+1 (migration's COMMIT
        repin). From the source's owned record when we hold one, else
        from the current KV record. On success our own guarded writes
        for the room are dead, exactly as they must be."""
        key = self._key(room)
        cur = self._owned.get(room)
        if cur is None:
            cur = await self.bus.get(key)
        epoch, _holder = _parse(cur)
        nxt = _record(epoch + 1, target_node_id)
        if await self.bus.cas(key, cur, nxt):
            self._owned.pop(room, None)
            self.stats["transfers"] += 1
            return True
        self._lost(room)
        return False

    async def release(self, room: str) -> None:
        """Drop ownership and clear the KV record (room deletion). The
        record is only deleted while it still names our epoch — a racing
        claimant's record survives."""
        owned = self._owned.pop(room, None)
        if owned is not None:
            self.stats["releases"] += 1
            if await self.bus.cas(self._key(room), owned, owned):
                await self.bus.delete(self._key(room))

    def forget(self, room: str) -> None:
        """Drop the local ownership cache only (no KV traffic): the
        fenced-node path, where the bus is unreachable or the record
        already belongs to a survivor."""
        self._owned.pop(room, None)

    # -- fenced writes ----------------------------------------------------
    async def _assert_owner(self, room: str) -> None:
        owned = self._owned.get(room)
        if owned is None:
            if await self.assume(room):
                return
            self.stats["writes_fenced"] += 1
            raise FencedWriteRejected(room)
        if not await self.bus.cas(self._key(room), owned, owned):
            self.stats["writes_fenced"] += 1
            self._lost(room)
            raise FencedWriteRejected(room)

    async def guarded_set(
        self, room: str, key: str, value: str, ttl: float | None = None
    ) -> None:
        """The fenced writer API (graftcheck GC09): every checkpoint/
        snapshot/pin write for a room goes through here. CAS-asserts our
        epoch record, then writes; a dead epoch raises instead of
        writing."""
        await self._assert_owner(room)
        await self.bus.set(key, value, ttl)

    async def guarded_set_many(
        self, room: str, items: list[tuple[str, str]], ttl: float | None = None
    ) -> None:
        """guarded_set of several keys of one room: one CAS-assert of our
        epoch record, then the writes, in flight together (the port's
        checkpoint round writes a room's generation ring this way)."""
        await self._assert_owner(room)
        await asyncio.gather(*(self.bus.set(key, value, ttl) for key, value in items))

    async def guarded_delete(self, room: str, key: str) -> None:
        await self._assert_owner(room)
        await self.bus.delete(key)

    def _lost(self, room: str) -> None:
        self._owned.pop(room, None)
        if self.log is not None:
            self.log.warn("room ownership lost (higher epoch)", room=room)
        for cb in list(self.on_lost):
            cb(room)


class LeaseGuard:
    """Lease-refresh outcomes → fence/recover transitions.

    Fed by KVRouter's stats worker after every refresh attempt. The
    guard itself only decides; the FleetPlane maps "fence" onto egress
    mute + checkpoint freeze + supervisor quiesce, and "recover" onto
    reconcile-then-unfence (the caller clears the flag via unfence()
    only AFTER reconciling, so a recovered node discovers which rooms it
    lost while still silent).
    """

    def __init__(self, fence_grace_s: float, clock=time.monotonic):
        self.fence_grace_s = float(fence_grace_s)
        self._clock = clock
        self.last_ok = clock()
        self.fenced = False
        self.fences = 0          # lifetime fence transitions (telemetry)

    def age(self) -> float:
        """Seconds since the last successful lease refresh."""
        return self._clock() - self.last_ok

    def observe(self, ok: bool) -> str:
        """→ "" | "fence" | "recover"."""
        if ok:
            self.last_ok = self._clock()
            return "recover" if self.fenced else ""
        if not self.fenced and self.age() > self.fence_grace_s:
            self.fenced = True
            self.fences += 1
            return "fence"
        return ""

    def unfence(self) -> None:
        self.fenced = False
