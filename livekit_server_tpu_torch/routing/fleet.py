"""Epoch-fenced room ownership: the exception of the partition-tolerance
primitives.

The JAX package's routing/fleet.py fences every room-scoped KV write
with an ownership epoch (RoomFence, LeaseGuard; service/fleetplane.py
drives them). The port carries the fleet plane later (ROADMAP A13);
until then only the exception a fenced write raises is needed, because
routing/router.py's KV paths catch it.
"""

from __future__ import annotations


class FencedWriteRejected(Exception):
    """A guarded write lost its epoch CAS: a higher epoch exists, so this
    node no longer owns the room and must go quiet for it."""

    def __init__(self, room: str):
        super().__init__(f"write fenced: room {room!r} owned at a higher epoch")
        self.room = room
