"""The port's message bus (routing/kv.py, routing/tcpbus.py): the
counterparts of the JAX package's tests/test_multinode.py bus tests —
KV and pub/sub over real sockets, hmac auth, reconnect and resubscribe,
malformed frames — plus MemoryBus semantics against the JAX copy on one
scripted sequence, and the wire across the packages both ways (a port
client on a JAX-package BusServer and the other way round; the frames
are byte-compatible). Values compare exactly. Waits poll conditions with
deadlines."""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu.routing import kv as jkv  # noqa: E402
from livekit_server_tpu.routing import tcpbus as jtcpbus  # noqa: E402
from livekit_server_tpu_torch.routing import kv  # noqa: E402
from livekit_server_tpu_torch.routing.tcpbus import BusServer, TCPBusClient  # noqa: E402
from tests.torch_cluster_fixture import start_bus  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


async def bus_script(bus, pub=None) -> list:
    """One scripted sequence over a MessageBus (`pub` publishes, default
    `bus`): hashes, set/get/delete, setnx, cas, TTL expiry, and pub/sub
    with exact and pattern subscriptions, dict messages and a closed
    subscription; returns every observation."""
    pub = pub or bus
    out = []
    await bus.hset("nodes", "n1", "one")
    await bus.hset("nodes", "n2", "two")
    out += [await bus.hget("nodes", "n1"), await bus.hgetall("nodes")]
    await bus.hdel("nodes", "n1")
    out += [await bus.hget("nodes", "n1"), await bus.hgetall("nodes"),
            await bus.hgetall("absent")]
    await bus.set("k", "v")
    out += [await bus.get("k"), await bus.setnx("k", "w"), await bus.setnx("j", "w")]
    await bus.delete("k")
    out += [await bus.get("k"), await bus.cas("c", None, "a"), await bus.cas("c", None, "b"),
            await bus.cas("c", "x", "b"), await bus.cas("c", "a", "b"), await bus.get("c")]
    await bus.set("t", "v", 0.05)
    await bus.setnx("u", "v", 0.05)
    out += [await bus.get("t"), await bus.get("u")]
    await asyncio.sleep(0.12)
    out += [await bus.get("t"), await bus.get("u"), await bus.setnx("u", "again")]
    pattern, exact = bus.subscribe("room:*"), bus.subscribe("room:one")
    # A round trip on the subscriber's connection: a TCP server handles a
    # connection's frames in order, so its SUB frames have landed.
    await bus.get("barrier")
    out.append(await pub.publish("room:one", {"kind": "hello", "n": [1, 2]}))
    out += [await pattern.read(timeout=2), await exact.read(timeout=2)]
    out.append(await pub.publish("room:two", "plain"))
    out.append(await pattern.read(timeout=2))
    exact.close()
    pattern.close()
    await bus.get("barrier")         # the UNSUB frames have landed
    out.append(await pub.publish("room:one", "nobody"))
    return out


SCRIPT_OUT = [
    "one", {"n1": "one", "n2": "two"}, None, {"n2": "two"}, {},
    "v", False, True, None, True, False, False, True, "b",
    "v", "v", None, None, True,
    2, {"kind": "hello", "n": [1, 2]}, {"kind": "hello", "n": [1, 2]}, 1, "plain", 0,
]


async def test_memory_bus_semantics_match_reference():
    """MemoryBus of both packages on one scripted sequence: set, get,
    cas, TTL expiry, hashes and pub/sub give the same observations."""
    got = await bus_script(kv.MemoryBus())
    assert got == await bus_script(jkv.MemoryBus())
    assert got == SCRIPT_OUT


async def test_wire_crosses_between_packages():
    """The same script through a port client on a JAX-package BusServer,
    and through a JAX-package client on a port BusServer (publishing from
    a client of the other package on the same server): the framing,
    the auth handshake and every reply are byte-compatible."""
    for server_cls, client_cls, other_cls in (
            (jtcpbus.BusServer, TCPBusClient, jtcpbus.TCPBusClient),
            (BusServer, jtcpbus.TCPBusClient, TCPBusClient)):
        srv = server_cls(token="s3cret")
        await srv.start("127.0.0.1", 0)
        try:
            client = await client_cls.connect("127.0.0.1", srv.port, token="s3cret")
            other = await other_cls.connect("127.0.0.1", srv.port, token="s3cret")
            assert await bus_script(client, pub=other) == SCRIPT_OUT
            intruder = await client_cls.connect("127.0.0.1", srv.port)
            with pytest.raises((RuntimeError, ConnectionError)):
                await intruder.hset("room_node_map", "victim", "evil-node")
            for c in (client, other, intruder):
                await c.close()
        finally:
            srv.close()


async def test_tcpbus_kv_and_pubsub():
    """The bus speaks the MessageBus protocol over real sockets: state
    written by one client is visible to another, and pub/sub (including
    patterns) fans out across connections."""
    bus = await start_bus()
    try:
        a = await TCPBusClient.connect("127.0.0.1", bus.port)
        b = await TCPBusClient.connect("127.0.0.1", bus.port)

        await a.hset("nodes", "n1", "one")
        assert await b.hget("nodes", "n1") == "one"
        assert await b.hgetall("nodes") == {"n1": "one"}
        await b.hdel("nodes", "n1")
        assert await a.hget("nodes", "n1") is None

        await a.set("k", "v", None)
        assert await b.get("k") == "v"
        assert await b.setnx("k", "other", None) is False
        await b.delete("k")
        assert await a.setnx("k", "other", None) is True

        sub = b.subscribe("room:*")
        exact = b.subscribe("room:one")
        n = await a.publish("room:one", "hello")
        assert n == 2
        assert await sub.read(timeout=2) == "hello"
        assert await exact.read(timeout=2) == "hello"
        sub.close()
        await b.get("barrier")        # b's UNSUB frame has landed
        assert await a.publish("room:two", "x") == 0  # exact sub doesn't match
        await a.close()
        await b.close()
    finally:
        bus.close()


async def test_bus_auth():
    """A token-bearing bus is the Redis-AUTH seat: unauthenticated clients
    are refused every op (the bus carries room pins and signal relay, so
    open access is cluster takeover), tokened clients work normally."""
    bus = BusServer(token="s3cret")
    await bus.start("127.0.0.1", 0)
    try:
        intruder = await TCPBusClient.connect("127.0.0.1", bus.port)
        try:
            await intruder.hset("room_node_map", "victim", "evil-node")
            raise AssertionError("unauthenticated op accepted")
        except (RuntimeError, ConnectionError):
            pass  # refused (and the connection is dropped)

        member = await TCPBusClient.connect("127.0.0.1", bus.port, token="s3cret")
        await member.hset("nodes", "n1", "one")
        assert await member.hget("nodes", "n1") == "one"
        assert await member.hget("room_node_map", "victim") is None
        await member.close()
    finally:
        bus.close()


async def test_bus_client_reconnects_and_resubscribes():
    """A dropped bus connection must not sever the node permanently (the
    go-redis auto-reconnect seat): calls fail during the outage, then
    succeed again, and live subscriptions are re-issued on the fresh
    connection."""
    bus = await start_bus()
    port = bus.port
    try:
        client = await TCPBusClient.connect("127.0.0.1", port)
        other = await TCPBusClient.connect("127.0.0.1", port)
        sub = client.subscribe("announce")
        await client.set("k", "v1")      # a round trip: the SUB frame landed

        # Sever the client's connection out from under it (network blip).
        client._writer.transport.abort()
        deadline = asyncio.get_running_loop().time() + 3
        while client.reconnects == 0:
            assert asyncio.get_running_loop().time() < deadline, "no reconnect"
            await asyncio.sleep(0.05)
        # Calls work again; the reconnect wrote the re-SUB frames before
        # this round trip on the same connection, so they have landed.
        assert await client.get("k") == "v1"
        await other.publish("announce", {"hello": 1})  # pushes flow again
        msg = await sub.read(timeout=3)
        assert msg == {"hello": 1}

        # Full bus-process restart on the same port: state is fresh (like
        # a flushed Redis) but the client recovers without intervention.
        bus.close()
        client._writer.transport.abort()
        other._writer.transport.abort()
        await asyncio.sleep(0.1)
        bus2 = BusServer()
        await bus2.start("127.0.0.1", port)
        try:
            deadline = asyncio.get_running_loop().time() + 5
            while True:
                try:
                    await client.set("k2", "v2")
                    break
                except ConnectionError:
                    assert asyncio.get_running_loop().time() < deadline
                    await asyncio.sleep(0.1)
            assert await client.get("k2") == "v2"
            await client.close()
            await other.close()
        finally:
            bus2.close()
    finally:
        bus.close()


async def test_bus_client_survives_malformed_frame():
    """A malformed frame (bad JSON, or a frame with neither 'p' nor 'i')
    means the stream is desynced: the client must treat it as connection
    loss and reconnect — not die with _connected=True, which would hang
    every pending and future call forever."""
    import json as _json

    bus = await start_bus()
    try:
        client = await TCPBusClient.connect("127.0.0.1", bus.port)
        await client.set("k", "v1")

        def inject(raw: bytes) -> None:
            client._reader.feed_data(len(raw).to_bytes(4, "big") + raw)

        # Structurally invalid frame: valid JSON lacking both 'p' and 'i'.
        inject(_json.dumps({"x": 1}).encode())
        deadline = asyncio.get_running_loop().time() + 3
        while client.reconnects == 0:
            assert asyncio.get_running_loop().time() < deadline, (
                "malformed frame killed the reader without reconnecting"
            )
            await asyncio.sleep(0.05)
        assert not client.closed
        assert await client.get("k") == "v1"

        # Byte-garbage frame (json.JSONDecodeError path), on the fresh
        # connection this time.
        inject(b"\xff not json \xff")
        deadline = asyncio.get_running_loop().time() + 3
        while client.reconnects < 2:
            assert asyncio.get_running_loop().time() < deadline, "no 2nd reconnect"
            await asyncio.sleep(0.05)
        assert await client.get("k") == "v1"
        await client.close()
    finally:
        bus.close()


def test_cli_bus_serves_and_refuses_a_bare_public_bind():
    """`python -m livekit_server_tpu_torch bus` serves the bus on loopback
    (a client of the JAX package talks to it) and refuses to bind beyond
    loopback without --token."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "livekit_server_tpu_torch", "bus",
                          "--host", "0.0.0.0", "--port", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "without --token" in out.stdout
    proc = subprocess.Popen([sys.executable, "-m", "livekit_server_tpu_torch", "bus",
                             "--port", "0"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("bus listening on 127.0.0.1:"), line
        port = int(line.rsplit(":", 1)[1])

        async def talk():
            client = await jtcpbus.TCPBusClient.connect("127.0.0.1", port)
            await client.set("k", "v")
            got = await client.get("k")
            await client.close()
            return got

        assert asyncio.run(talk()) == "v"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
