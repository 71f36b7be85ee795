"""Tensor-slot allocation for rooms, tracks, and subscribers.

No direct reference equivalent — this replaces Go's dynamic object graph
(map[string]*Room, slices of DownTracks) with static tensor coordinates:
every live room owns a row r ∈ [0, R), every published track in it a
column t ∈ [0, T), every participant a subscriber column s ∈ [0, S).
The media plane is compiled once for (R, T, K, S); occupancy is masked.

A copy of the JAX package's runtime/slots.py (dense allocator only; the
paged allocator arrives with the paged plane).

The capacity gates here are the device analog of the reference's node limits
(config LimitConfig, selector.LimitsReached — rtcservice.go:162): a node
refuses work when its tensor is full, and the node selector routes new
rooms elsewhere (plane_rooms_used/capacity in NodeStats).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class CapacityError(Exception):
    """Raised when the plane tensor has no free row/column."""


@dataclass
class _Pool:
    capacity: int
    free: list[int] = field(default_factory=list)

    def __post_init__(self):
        self.free = list(range(self.capacity - 1, -1, -1))  # pop() yields 0 first

    def alloc(self, what: str) -> int:
        if not self.free:
            raise CapacityError(f"no free {what} slot")
        return self.free.pop()

    def release(self, idx: int) -> None:
        self.free.append(idx)

    def grow(self, n: int) -> None:
        """Widen the pool by `n` fresh slots (paged mode: a page-extent
        grow makes the new page's columns allocatable)."""
        self.free.extend(range(self.capacity + n - 1, self.capacity - 1, -1))
        self.capacity += n

    @property
    def used(self) -> int:
        return self.capacity - len(self.free)


@dataclass
class RoomSlots:
    """Per-room slot maps: track sid → col, participant sid → sub col."""

    row: int
    tracks: _Pool
    subs: _Pool
    track_of: dict[str, int] = field(default_factory=dict)
    sub_of: dict[str, int] = field(default_factory=dict)

    def alloc_track(self, track_sid: str) -> int:
        if track_sid in self.track_of:
            return self.track_of[track_sid]
        idx = self.tracks.alloc("track")
        self.track_of[track_sid] = idx
        return idx

    def release_track(self, track_sid: str) -> int | None:
        idx = self.track_of.pop(track_sid, None)
        if idx is not None:
            self.tracks.release(idx)
        return idx

    def alloc_sub(self, participant_sid: str) -> int:
        if participant_sid in self.sub_of:
            return self.sub_of[participant_sid]
        idx = self.subs.alloc("subscriber")
        self.sub_of[participant_sid] = idx
        return idx

    def release_sub(self, participant_sid: str) -> int | None:
        idx = self.sub_of.pop(participant_sid, None)
        if idx is not None:
            self.subs.release(idx)
        return idx

    def occupancy(self) -> dict:
        return {
            "tracks_used": self.tracks.used,
            "tracks_capacity": self.tracks.capacity,
            "subs_used": self.subs.used,
            "subs_capacity": self.subs.capacity,
        }


class SlotAllocator:
    """Node-wide allocator of room rows and per-room track/sub columns."""

    def __init__(self, rooms: int, tracks_per_room: int, subs_per_room: int):
        self.capacity = rooms
        self.tracks_per_room = tracks_per_room
        self.subs_per_room = subs_per_room
        self._rows = _Pool(rooms)
        self._rooms: dict[str, RoomSlots] = {}

    def alloc_room(self, room_name: str) -> RoomSlots:
        if room_name in self._rooms:
            return self._rooms[room_name]
        row = self._rows.alloc("room")
        slots = RoomSlots(
            row=row,
            tracks=_Pool(self.tracks_per_room),
            subs=_Pool(self.subs_per_room),
        )
        self._rooms[room_name] = slots
        return slots

    def get(self, room_name: str) -> RoomSlots | None:
        return self._rooms.get(room_name)

    def release_room(self, room_name: str) -> None:
        slots = self._rooms.pop(room_name, None)
        if slots is not None:
            self._rows.release(slots.row)

    @property
    def rooms_used(self) -> int:
        return self._rows.used

    def occupancy(self) -> dict:
        """Per-RESOURCE occupancy, not just room count: a node whose rooms
        are large can run out of track/sub columns long before its row
        pool does (and vice versa), so admission and the node selector
        need all three axes. Dense mode: every room pre-pays the full
        per-room column pools, so capacity is rooms × per-room."""
        tracks_used = sum(s.tracks.used for s in self._rooms.values())
        subs_used = sum(s.subs.used for s in self._rooms.values())
        return {
            "rooms_used": self._rows.used,
            "rooms_capacity": self.capacity,
            "tracks_used": tracks_used,
            "tracks_capacity": self.capacity * self.tracks_per_room,
            "subs_used": subs_used,
            "subs_capacity": self.capacity * self.subs_per_room,
            "admittable_rooms": self.capacity - self._rows.used,
        }
