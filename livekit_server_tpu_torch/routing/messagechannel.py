"""Bounded in-memory message channel (sink + source).

Reference parity: pkg/routing/messagechannel.go:26-80 — the
MessageSink/MessageSource pair behind every signal connection. Semantics
preserved: bounded buffer, non-blocking writes that raise ChannelFull on
overflow (the reference returns ErrChannelFull and *drops*, so a slow
consumer can't stall the signal path), idempotent close.
"""

from __future__ import annotations

import asyncio
from typing import Any

DEFAULT_SIZE = 200  # messagechannel.go DefaultMessageChannelSize


_SENTINEL = object()


class ChannelFull(Exception):
    pass


class ChannelClosed(Exception):
    pass


class MessageChannel:
    """Async bounded channel; WriteMessage never blocks (drop-on-full)."""

    # Process-wide overflow count across every channel instance —
    # exported as livekit_signal_channel_dropped_total (a saturated
    # signal path must be visible, not a silent local counter).
    total_dropped = 0

    def __init__(self, size: int = DEFAULT_SIZE, connection_id: str = ""):
        self._q: asyncio.Queue[Any] = asyncio.Queue(maxsize=size)
        self._closed = False
        self.connection_id = connection_id
        self.dropped = 0  # this channel's overflow count

    @property
    def is_closed(self) -> bool:
        return self._closed

    def write_message(self, msg: Any) -> None:
        if self._closed:
            raise ChannelClosed
        try:
            self._q.put_nowait(msg)
        except asyncio.QueueFull:
            self.dropped += 1
            MessageChannel.total_dropped += 1
            raise ChannelFull from None

    async def read_message(self) -> Any:
        """Blocking pop; raises ChannelClosed once drained after close."""
        if self._closed and self._q.empty():
            raise ChannelClosed
        msg = await self._q.get()
        if msg is _SENTINEL:
            self._q.put_nowait(_SENTINEL)  # wake any other reader
            raise ChannelClosed
        return msg

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._q.put_nowait(_SENTINEL)
        except asyncio.QueueFull:
            # Queue has items: a reader can't be parked in get(); the closed
            # flag is observed once the backlog drains.
            pass
