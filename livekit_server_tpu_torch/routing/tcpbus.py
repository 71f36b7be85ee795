"""TCP message bus: the MessageBus protocol over real sockets.

A copy of the JAX package's routing/tcpbus.py, byte-compatible on the
wire: a client of either package works against a server of the other.

Reference parity: the Redis deployment seat — multi-node livekit runs N
servers against one Redis for node registry, room pinning, and pub/sub
signal relay (pkg/routing/redisrouter.go:48-311; test/multinode_test.go
runs exactly this shape). This module ships both halves in-repo so a
cluster needs no external dependency:

  - BusServer — a standalone asyncio server holding the hash/KV/pub-sub
    state (`python -m livekit_server_tpu_torch bus` runs it; tests embed it)
  - TCPBusClient — a MessageBus implementation over one TCP connection;
    drop-in for MemoryBus in KVRouter/KVStore (config: kv.kind = "tcp",
    kv.address = "host:port")

Wire protocol: 4-byte big-endian length + UTF-8 JSON.
  request   {"i": id, "op": op, "a": [args]}
  response  {"i": id, "r": result}  |  {"i": id, "e": "error"}
  push      {"p": subscribed-pattern, "c": channel, "m": msg}

Ordering matters for the router's subscribe-then-publish handshakes, so
`subscribe()` writes its SUB frame synchronously on the shared writer —
frames from one client are processed strictly in order by the server.
"""

from __future__ import annotations

import asyncio
import fnmatch
import hmac
import json
import random
from collections import deque
from typing import Any

from livekit_server_tpu_torch.routing.kv import MemoryBus, Subscription
from livekit_server_tpu_torch.utils.backoff import (
    BackoffPolicy,
    CircuitBreaker,
    RetryAborted,
    retry_async,
)

MAX_FRAME = 8 * 1024 * 1024  # room snapshots ride the bus; give them room
MAX_BUFFERED = 4 * 1024 * 1024  # per-subscriber write backlog before drops


def _frame(obj: Any) -> bytes:
    raw = json.dumps(obj, separators=(",", ":")).encode()
    return len(raw).to_bytes(4, "big") + raw


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    hdr = await reader.readexactly(4)
    n = int.from_bytes(hdr, "big")
    if n == 0 or n > MAX_FRAME:
        raise ConnectionError(f"bad frame length {n}")
    return json.loads(await reader.readexactly(n))


class BusServer:
    """Standalone KV/pub-sub node (the 'run one Redis' deployment seat).

    `token` is the Redis-AUTH seat: when set, a client's first frame must
    be {"op": "auth", "a": [token]} or the connection is refused — the bus
    carries room pins, node registry, signal relay, and room snapshots, so
    an unauthenticated listener is cluster-control-plane takeover."""

    def __init__(self, token: str = "") -> None:
        self.state = MemoryBus()  # hashes + KV with TTL (pub/sub is ours)
        self.token = token
        self.server: asyncio.AbstractServer | None = None
        # writer → {pattern, ...}
        self._subs: dict[asyncio.StreamWriter, set[str]] = {}
        # writer → node ident (the "ident" op; fault-injection partitions
        # sever by node, and a client survives reconnects by re-identing).
        self._idents: dict[asyncio.StreamWriter, str] = {}
        # Partition injection (FaultSpec.bus_partition_groups): idents NOT
        # in group 0 lose the bus — every op errors (their clients see a
        # non-retried RuntimeError, so leases lapse fast) and no pushes
        # flow to or from them. Asym pairs (src, dst) additionally hold
        # src→dst pushes in a bounded buffer flushed on heal — the
        # deterministic "COMMIT arrives after the heal" drill primitive.
        self._severed: set[str] = set()
        self._asym: set[tuple[str, str]] = set()
        self._held: deque = deque(maxlen=256)  # (writer, pattern, channel, msg)
        self.stats = {"conns": 0, "ops": 0, "published": 0}

    # -- partition injection (deterministic, driven by the fault harness) --
    def set_partition(self, groups, asym_pairs=()) -> None:
        """Sever node subsets: `groups` is an iterable of ident groups;
        group 0 keeps the bus (the bus process lives on the majority
        side), every other group loses it entirely. Idents that appear in
        no group (test-harness utility clients) stay connected."""
        self._severed = set()
        for i, g in enumerate(groups):
            if i > 0:
                self._severed |= {str(n) for n in g}
        self._asym = {(str(a), str(b)) for a, b in asym_pairs}
        self.stats["partitions"] = self.stats.get("partitions", 0) + 1

    def heal_partition(self) -> None:
        """Reconnect everyone and flush pushes held on asym pairs, in
        capture order — held messages arrive AFTER everything published
        during the partition, exactly like a delayed link coming back."""
        self._severed = set()
        self._asym = set()
        held, self._held = list(self._held), deque(maxlen=256)
        for w, pat, channel, msg in held:
            if not w.is_closing():
                w.write(_frame({"p": pat, "c": channel, "m": msg}))
        self.stats["heals"] = self.stats.get("heals", 0) + 1

    async def start(self, host: str = "127.0.0.1", port: int = 7850) -> None:
        self.server = await asyncio.start_server(self._handle, host, port)

    @property
    def port(self) -> int:
        return self.server.sockets[0].getsockname()[1]

    def close(self) -> None:
        if self.server is not None:
            self.server.close()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.stats["conns"] += 1
        self._subs[writer] = set()
        authed = not self.token
        try:
            while True:
                req = await _read_frame(reader)
                self.stats["ops"] += 1
                if not authed:
                    ok = req.get("op") == "auth" and hmac.compare_digest(
                        str(req.get("a", [""])[0] or ""), self.token
                    )
                    writer.write(
                        _frame({"i": req.get("i", 0), "r": True} if ok
                               else {"i": req.get("i", 0), "e": "auth required"})
                    )
                    await writer.drain()
                    if not ok:
                        break
                    authed = True
                    continue
                try:
                    result = await self._dispatch(writer, req["op"], req.get("a", []))
                    writer.write(_frame({"i": req["i"], "r": result}))
                except Exception as e:  # noqa: BLE001 — survive bad ops
                    writer.write(_frame({"i": req["i"], "e": str(e)}))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, ConnectionResetError):
            pass
        finally:
            self._subs.pop(writer, None)
            self._idents.pop(writer, None)
            writer.close()

    async def _dispatch(self, writer, op: str, a: list):
        s = self.state
        if op == "ident":
            self._idents[writer] = str(a[0])
            return None
        if self._severed and self._idents.get(writer, "") in self._severed:
            # The severed side sees every op fail, not time out: the error
            # frame surfaces as a non-retried RuntimeError client-side, so
            # a partitioned node's lease refresh fails within one beat.
            raise RuntimeError("bus partitioned")
        if op == "hset":
            await s.hset(a[0], a[1], a[2])
        elif op == "hget":
            return await s.hget(a[0], a[1])
        elif op == "hgetall":
            return await s.hgetall(a[0])
        elif op == "hdel":
            await s.hdel(a[0], a[1])
        elif op == "set":
            await s.set(a[0], a[1], a[2])
        elif op == "get":
            return await s.get(a[0])
        elif op == "del":
            await s.delete(a[0])
        elif op == "setnx":
            return await s.setnx(a[0], a[1], a[2])
        elif op == "cas":
            return await s.cas(a[0], a[1], a[2], a[3])
        elif op == "pub":
            return self._publish(a[0], a[1], sender=self._idents.get(writer, ""))
        elif op == "sub":
            self._subs[writer].add(a[0])
        elif op == "unsub":
            self._subs[writer].discard(a[0])
        elif op == "auth":
            return True  # already authed (token-less bus, or re-auth)
        else:
            raise ValueError(f"unknown op {op}")
        return None

    def _publish(self, channel: str, msg: Any, sender: str = "") -> int:
        n = 0
        for w, patterns in list(self._subs.items()):
            dst = self._idents.get(w, "")
            if self._severed and dst in self._severed:
                continue  # receiver is on the dark side of the partition
            for pat in patterns:
                if pat == channel or (
                    ("*" in pat or "?" in pat) and fnmatch.fnmatch(channel, pat)
                ):
                    if w.is_closing():
                        continue
                    if sender and (sender, dst) in self._asym:
                        # One-way link failure: hold (not drop) until heal.
                        self._held.append((w, pat, channel, msg))
                        self.stats["held"] = self.stats.get("held", 0) + 1
                        continue
                    # Bounded like Subscription's drop-on-overflow queue: a
                    # stalled subscriber drops pushes instead of growing
                    # the bus process's write buffer without limit.
                    if w.transport.get_write_buffer_size() > MAX_BUFFERED:
                        self.stats["dropped"] = self.stats.get("dropped", 0) + 1
                        continue
                    w.write(_frame({"p": pat, "c": channel, "m": msg}))
                    n += 1
        self.stats["published"] += n
        return n


class TCPBusClient:
    """MessageBus over one TCP connection (the Redis-client seat).

    Reconnects automatically when the connection drops (the go-redis
    behavior the node registry depends on — a blip must not permanently
    sever a node from the cluster), under the uniform BackoffPolicy
    (exponential, full jitter) with a circuit breaker capping the dial
    rate when the bus is hard-down. Calls ride out short blips with a
    bounded retry of their own (counted in `retries`) before surfacing
    ConnectionError; every live subscription is re-issued on the fresh
    connection. Pushes published during the outage are lost — exactly
    Redis pub/sub semantics, which every consumer (heartbeats, signal
    relay seq-resume) already tolerates."""

    RECONNECT_MAX_S = 5.0
    CALL_TIMEOUT_S = 10.0  # per-attempt; a bus that accepts but never answers

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 host: str = "", port: int = 0, token: str = "",
                 jitter_seed: int | None = None):
        self._reader = reader
        self._writer = writer
        self._host, self._port, self._token = host, port, token
        self._next_id = 0
        self._ident = ""  # node identity announced via set_ident
        self._pending: dict[int, asyncio.Future] = {}
        self._subs: dict[str, list[Subscription]] = {}
        self._task = asyncio.ensure_future(self._read_loop())
        self.closed = False
        self._connected = True
        self.reconnects = 0
        self.retries = 0  # call-level retry count (telemetry gauge feed)
        self._dial_backoff = BackoffPolicy(base=0.05, max_delay=self.RECONNECT_MAX_S)
        # Full-jitter reconnect is default-on, with a PER-CLIENT rng: a
        # fleet re-dialing after a regional cut must de-correlate, and a
        # shared module-level rng would give chaos drills no seam to
        # seed. `jitter_seed` pins the stream for reproducible storms.
        self._dial_rng = random.Random(jitter_seed)
        # Hard-down bus: after 8 straight failed dials, stop hammering and
        # probe once per cooldown instead.
        self._dial_breaker = CircuitBreaker(threshold=8, cooldown_s=self.RECONNECT_MAX_S)
        # Call retries stay short and bounded: they exist to ride out the
        # reconnect window, not to mask a real outage from callers.
        self._call_policy = BackoffPolicy(base=0.05, max_delay=0.5, max_attempts=4)

    @classmethod
    async def connect(cls, host: str, port: int, token: str = "",
                      jitter_seed: int | None = None) -> "TCPBusClient":
        # Initial dial fails fast by design — the caller decides whether a
        # reachable bus is a boot requirement; only the established client
        # owns the reconnect policy.
        reader, writer = await asyncio.open_connection(host, port)  # graftcheck: disable=GC04
        client = cls(reader, writer, host=host, port=port, token=token,
                     jitter_seed=jitter_seed)
        if token:
            await client._call("auth", token)
        return client

    @classmethod
    async def connect_address(cls, address: str, token: str = "") -> "TCPBusClient":
        host, _, port = address.rpartition(":")
        return await cls.connect(host or "127.0.0.1", int(port), token=token)

    async def _read_loop(self) -> None:
        while True:
            try:
                while True:
                    msg = await _read_frame(self._reader)
                    if "p" in msg:  # push
                        for sub in list(self._subs.get(msg["p"], [])):
                            sub._offer(msg["m"])
                        continue
                    fut = self._pending.pop(msg["i"], None)
                    if fut is not None and not fut.done():
                        if "e" in msg:
                            fut.set_exception(RuntimeError(msg["e"]))
                        else:
                            fut.set_result(msg.get("r"))
            except (asyncio.IncompleteReadError, ConnectionError,
                    ConnectionResetError, OSError):
                pass
            except (ValueError, KeyError, TypeError):
                # Malformed frame (bad JSON, missing 'i'/'p', wrong types): the
                # stream is desynced, so this connection is unusable. Treat it
                # exactly like a connection loss — fall through to fail
                # pendings and reconnect — instead of letting the exception
                # kill the reader task while _connected stays True (which
                # would hang every pending and future call forever).
                pass
            # Connection dropped: fail in-flight calls now; callers retry.
            self._connected = False
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("bus connection lost"))
            self._pending.clear()
            if self.closed or not self._host:
                self.closed = True
                return
            if not await self._reconnect():
                self.closed = True
                return

    async def _reconnect(self) -> bool:
        """Dial until the bus answers (retry_async: jittered backoff,
        breaker-capped dial rate — one probe per cooldown against a
        hard-down bus), then re-auth and re-subscribe every live channel.
        Returns False only on close()."""

        async def dial() -> None:
            reader, writer = await asyncio.open_connection(self._host, self._port)
            try:
                self._writer.close()   # old transport: no fd leak
            except Exception:  # noqa: BLE001 — already torn down
                pass
            self._reader, self._writer = reader, writer
            # Mark live BEFORE re-issuing auth/subs: they go through
            # _send, which fails fast while disconnected.
            self._connected = True
            if self._token:
                # _send writes on the NEW connection; the response is
                # read by the outer loop after we return.
                self._send("auth", self._token).add_done_callback(
                    lambda f: f.exception()
                )
            if self._ident:
                self._send("ident", self._ident).add_done_callback(
                    lambda f: f.exception()
                )
            for channel in self._subs:
                self._send("sub", channel).add_done_callback(
                    lambda f: f.exception()
                )
            self.reconnects += 1

        try:
            await retry_async(
                dial, self._dial_backoff,
                retry_on=(OSError,),
                breaker=self._dial_breaker,
                wait_when_open=True,
                should_abort=lambda: self.closed,
                rng=self._dial_rng,
            )
        except RetryAborted:
            return False
        return True

    def _send(self, op: str, *args) -> asyncio.Future:
        if self.closed or not self._connected:
            # Fail fast mid-outage: a write to the dead transport would be
            # silently dropped and the call would hang forever.
            raise ConnectionError("bus connection lost")
        self._next_id += 1
        fut = asyncio.get_event_loop().create_future()
        self._pending[self._next_id] = fut
        self._writer.write(_frame({"i": self._next_id, "op": op, "a": list(args)}))
        return fut

    async def _call(self, op: str, *args):
        """One bus op under the uniform retry policy: a call that lands in
        the reconnect window retries (briefly, with jittered backoff)
        instead of failing on the first dead-transport write. Server-side
        errors (RuntimeError) never retry — only transport loss does."""

        def _on_retry(_attempt: int, _exc: BaseException) -> None:
            self.retries += 1

        return await retry_async(
            lambda: self._send(op, *args),
            self._call_policy,
            retry_on=(ConnectionError,),
            timeout=self.CALL_TIMEOUT_S,
            on_retry=_on_retry,
        )

    # -- MessageBus -----------------------------------------------------
    async def hset(self, key, field, value):
        await self._call("hset", key, field, value)

    async def hget(self, key, field):
        return await self._call("hget", key, field)

    async def hgetall(self, key):
        return await self._call("hgetall", key)

    async def hdel(self, key, field):
        await self._call("hdel", key, field)

    async def set(self, key, value, ttl=None):
        await self._call("set", key, value, ttl)

    async def get(self, key):
        return await self._call("get", key)

    async def delete(self, key):
        await self._call("del", key)

    async def setnx(self, key, value, ttl=None):
        return await self._call("setnx", key, value, ttl)

    async def cas(self, key, expect, value, ttl=None):
        return await self._call("cas", key, expect, value, ttl)

    async def publish(self, channel, msg):
        return await self._call("pub", channel, msg)

    def set_ident(self, node_id: str) -> None:
        """Name this connection to the bus (fire-and-forget, like
        subscribe): partitions sever by node ident, and _reconnect
        re-idents so the identity survives transport churn."""
        self._ident = node_id
        try:
            self._send("ident", node_id).add_done_callback(
                lambda f: f.exception()
            )
        except ConnectionError:
            pass  # re-sent by _reconnect once the transport is back

    def subscribe(self, channel: str, size: int = 200) -> Subscription:
        """Synchronous like MemoryBus.subscribe: the SUB frame goes on the
        wire immediately (writer.write is sync), so a publish awaited
        AFTER this call is ordered behind the subscription server-side."""
        sub = Subscription(self, channel, size)
        self._subs.setdefault(channel, []).append(sub)
        # Fire-and-forget op (response discarded via the pending future).
        # Mid-outage the send fails — the registration stands and
        # _reconnect re-issues it, so subscribe works across blips.
        try:
            self._send("sub", channel).add_done_callback(lambda f: f.exception())
        except ConnectionError:
            pass
        return sub

    def _unsubscribe(self, channel: str, sub: Subscription) -> None:
        lst = self._subs.get(channel)
        if lst and sub in lst:
            lst.remove(sub)
            if not lst:
                del self._subs[channel]
                if not self.closed:
                    self._send("unsub", channel).add_done_callback(
                        lambda f: f.exception()
                    )

    async def close(self) -> None:
        self.closed = True
        self._task.cancel()
        self._writer.close()
