"""Shared KV + pub/sub message bus.

A copy of the JAX package's routing/kv.py.

Reference parity: the Redis seat — node registry hashes and room pinning
(pkg/routing/redisrouter.go:71-154), per-node pub/sub channels (:249-279),
and the psrpc message bus (wire_gen.go:218-223: Redis bus multi-node,
LocalMessageBus single-node). One interface, two implementations:

  - MemoryBus — in-process; N logical nodes in one process share one
    MemoryBus, exactly how the reference's single-node mode uses
    psrpc.NewLocalMessageBus and how its multi-node *tests* run N servers
    against one Redis (test/multinode_test.go). This is the fake-backend
    path for multi-node tests without a cluster.
  - An external bus (real Redis/etcd) can implement the same interface;
    gated off by default since this image ships no KV server.
"""

from __future__ import annotations

import asyncio
import fnmatch
import time
from typing import Any, AsyncIterator, Callable, Protocol


class MessageBus(Protocol):
    async def hset(self, key: str, field: str, value: str) -> None: ...
    async def hget(self, key: str, field: str) -> str | None: ...
    async def hgetall(self, key: str) -> dict[str, str]: ...
    async def hdel(self, key: str, field: str) -> None: ...
    async def set(self, key: str, value: str, ttl: float | None = None) -> None: ...
    async def get(self, key: str) -> str | None: ...
    async def delete(self, key: str) -> None: ...
    async def setnx(self, key: str, value: str, ttl: float | None = None) -> bool: ...
    async def cas(
        self, key: str, expect: str | None, value: str, ttl: float | None = None
    ) -> bool: ...
    async def publish(self, channel: str, msg: Any) -> int: ...
    def subscribe(self, channel: str, size: int = 200) -> "Subscription": ...


class Subscription:
    """One subscriber's bounded queue on a channel (drop-on-overflow, the
    reference's bounded-channel semantics — signal.go:295-348)."""

    # Process-wide overflow count across every subscription — exported
    # as livekit_bus_sub_dropped_total (a saturated bus must be visible,
    # not a per-instance count that dies with the subscription).
    total_dropped = 0

    def __init__(self, bus: "MemoryBus", channel: str, size: int):
        self._bus = bus
        self._channel = channel
        self._q: asyncio.Queue = asyncio.Queue(maxsize=size)
        self.dropped = 0
        self.closed = False

    def _offer(self, msg: Any) -> None:
        try:
            self._q.put_nowait(msg)
        except asyncio.QueueFull:
            self.dropped += 1
            Subscription.total_dropped += 1

    async def __aiter__(self) -> AsyncIterator[Any]:
        while not self.closed:
            msg = await self._q.get()
            if msg is _CLOSE:
                break
            yield msg

    async def read(self, timeout: float | None = None) -> Any:
        if timeout is None:
            msg = await self._q.get()
        else:
            msg = await asyncio.wait_for(self._q.get(), timeout)
        if msg is _CLOSE:
            raise asyncio.CancelledError("subscription closed")
        return msg

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._bus._unsubscribe(self._channel, self)
        try:
            self._q.put_nowait(_CLOSE)
        except asyncio.QueueFull:
            pass


_CLOSE = object()


class MemoryBus:
    """In-process MessageBus (hash/KV with TTL + fan-out pub/sub)."""

    def __init__(self):
        self._hashes: dict[str, dict[str, str]] = {}
        self._kv: dict[str, tuple[str, float | None]] = {}  # value, expiry
        self._subs: dict[str, list[Subscription]] = {}

    # -- hashes (node registry, room pinning) ---------------------------
    async def hset(self, key: str, field: str, value: str) -> None:
        self._hashes.setdefault(key, {})[field] = value

    async def hget(self, key: str, field: str) -> str | None:
        return self._hashes.get(key, {}).get(field)

    async def hgetall(self, key: str) -> dict[str, str]:
        return dict(self._hashes.get(key, {}))

    async def hdel(self, key: str, field: str) -> None:
        self._hashes.get(key, {}).pop(field, None)

    # -- plain KV with TTL (locks, object store) ------------------------
    def _live(self, key: str) -> str | None:
        ent = self._kv.get(key)
        if ent is None:
            return None
        value, exp = ent
        if exp is not None and time.monotonic() > exp:
            del self._kv[key]
            return None
        return value

    async def set(self, key: str, value: str, ttl: float | None = None) -> None:
        self._kv[key] = (value, time.monotonic() + ttl if ttl else None)

    async def get(self, key: str) -> str | None:
        return self._live(key)

    async def delete(self, key: str) -> None:
        self._kv.pop(key, None)

    async def setnx(self, key: str, value: str, ttl: float | None = None) -> bool:
        """Distributed-lock primitive (redisstore.go:242-280 room lock)."""
        if self._live(key) is not None:
            return False
        await self.set(key, value, ttl)
        return True

    async def cas(
        self, key: str, expect: str | None, value: str, ttl: float | None = None
    ) -> bool:
        """Compare-and-swap: write only if the key's current value is
        EXACTLY `expect` (None = key absent). The epoch-fencing primitive
        (routing/fleet.py): a stale owner's expect string names a dead
        epoch, so its write loses here instead of clobbering the winner's."""
        if self._live(key) != expect:
            return False
        await self.set(key, value, ttl)
        return True

    # -- pub/sub --------------------------------------------------------
    async def publish(self, channel: str, msg: Any) -> int:
        subs = list(self._subs.get(channel, []))
        # Pattern subscriptions (psrpc-style topic wildcards).
        for pat, lst in self._subs.items():
            if pat != channel and ("*" in pat or "?" in pat) and fnmatch.fnmatch(channel, pat):
                subs.extend(lst)
        for s in subs:
            s._offer(msg)
        return len(subs)

    def subscribe(self, channel: str, size: int = 200) -> Subscription:
        sub = Subscription(self, channel, size)
        self._subs.setdefault(channel, []).append(sub)
        return sub

    def _unsubscribe(self, channel: str, sub: Subscription) -> None:
        lst = self._subs.get(channel)
        if lst and sub in lst:
            lst.remove(sub)
            if not lst:
                del self._subs[channel]
