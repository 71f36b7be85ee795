"""The port's embedded media relay (livekit_server_tpu_torch/runtime/
relay.py), held to the cases of the JAX package's tests/test_relay.py,
and against the JAX package's relay.

The relay is the TURN seat (pkg/service/turn.go:47): a blind UDP hop
admitted by a token minted over the signal channel. The cross-package
cases: a token minted by either package verifies in the other (and the
v2 continuity commitment is the same function), and the same seeded
sealed media through both packages' relays forwards the same bytes both
ways. The relay through the whole server is in
tests/test_torch_relay_server.py (a live serving loop).
"""

import asyncio
import random
import secrets as _secrets
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu.runtime import relay as jrelay  # noqa: E402
from livekit_server_tpu_torch import native  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.protocol import decode_signal_response  # noqa: E402
from livekit_server_tpu_torch.protocol.signal import SignalRequest  # noqa: E402
from livekit_server_tpu_torch.routing.messagechannel import MessageChannel  # noqa: E402
from livekit_server_tpu_torch.rtc import Participant, Room, handle_participant_signal  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime import relay as trelay  # noqa: E402
from livekit_server_tpu_torch.runtime.crypto import MediaCryptoClient, MediaCryptoRegistry  # noqa: E402
from livekit_server_tpu_torch.runtime.relay import (  # noqa: E402
    BIND_ACK,
    BIND_ERR,
    BIND_REQ,
    RELAY_MAGIC,
    continuity_commit,
    mint_relay_token,
    verify_relay_token,
)
from livekit_server_tpu_torch.runtime.udp import PUNCH_ACK, PUNCH_REQ  # noqa: E402
from tests.test_native import rtp_packet  # noqa: E402
from tests.torch_udp_fixture import HOST, client_socket, endpoint_transport, until  # noqa: E402

DIMS = plane.PlaneDims(rooms=2, tracks=4, pkts=8, subs=4)
SECRET = b"relay-hmac-secret"


def runtime() -> PlaneRuntime:
    return PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu")


def bind_via(sock: socket.socket, relay_addr, token: bytes) -> None:
    sock.sendto(RELAY_MAGIC + bytes([BIND_REQ]) + token, relay_addr)


def recv_all(sock: socket.socket) -> list[bytes]:
    out = []
    while True:
        try:
            out.append(sock.recvfrom(4096)[0])
        except BlockingIOError:
            return out


async def replies(sock, n: int = 1) -> list[bytes]:
    """Poll until `n` datagrams arrived on `sock`; returns them all."""
    got: list[bytes] = []
    await until(lambda: got.extend(recv_all(sock)) or len(got) >= n, f"{n} relay replies")
    await asyncio.sleep(0.01)
    return got + recv_all(sock)


async def relay_on(sfu_port: int, ttl_s: float = 30.0, mod=trelay, secret=SECRET):
    """A relay on an ephemeral port in front of (HOST, sfu_port) →
    (relay, its address)."""
    relay = await mod.start_media_relay(HOST, 0, (HOST, sfu_port), secret, ttl_s=ttl_s)
    return relay, (HOST, relay.transport.get_extra_info("sockname")[1])


async def sfu(rt, reg):
    """The port's per-datagram UDP transport, encryption required."""
    return await endpoint_transport(rt, crypto=reg, require_encryption=True)


def test_relay_token_roundtrip():
    tok = mint_relay_token(SECRET, 0xDEADBEEF, 30.0)
    assert verify_relay_token(SECRET, tok) == 0xDEADBEEF
    assert verify_relay_token(b"other", tok) is None
    assert verify_relay_token(SECRET, tok[:-1] + bytes([tok[-1] ^ 1])) is None
    assert verify_relay_token(SECRET, mint_relay_token(SECRET, 7, -5.0)) is None


def test_relay_tokens_cross_between_packages():
    """A token minted by either package verifies in the other (the HMAC
    layout is the wire contract), forgeries fail in both, and the v2
    continuity commitment is the same function."""
    for mint, verify in ((jrelay.mint_relay_token, trelay.verify_relay_token),
                         (trelay.mint_relay_token, jrelay.verify_relay_token)):
        tok = mint(SECRET, 0x5EED, 30.0)
        assert verify(SECRET, tok) == 0x5EED
        assert verify(b"other", tok) is None
        assert verify(SECRET, mint(SECRET, 1, -1.0)) is None
    reveal = bytes(range(16))
    assert trelay.continuity_commit(reveal) == jrelay.continuity_commit(reveal)
    assert (trelay.RELAY_MAGIC, trelay.BIND_REQ, trelay.BIND_ACK, trelay.BIND_ERR,
            trelay.TOKEN_LEN) == (jrelay.RELAY_MAGIC, jrelay.BIND_REQ, jrelay.BIND_ACK,
                                  jrelay.BIND_ERR, jrelay.TOKEN_LEN)


async def test_relay_forwards_same_bytes_in_both_packages():
    """The same seeded sealed media through each package's relay: the
    SFU-side socket receives the same datagrams, and the client the same
    replies, in order; the relay counts the same. Each relay admits a
    token minted by the other package."""
    results = {}
    for name, mod, other in (("jax", jrelay, trelay), ("port", trelay, jrelay)):
        rng = random.Random(11)
        key = bytes(rng.getrandbits(8) for _ in range(16))
        client = MediaCryptoClient(0x1234, key)
        upstream = client_socket()
        relay, relay_addr = await relay_on(upstream.getsockname()[1], mod=mod)
        c = client_socket()
        try:
            bind_via(c, relay_addr, other.mint_relay_token(SECRET, 0x1234, 30))
            assert await replies(c) == [RELAY_MAGIC + bytes([BIND_ACK]) + (0x1234).to_bytes(4, "big")]
            media = [client.seal(rtp_packet(sn=100 + i, ts=960 * i, ssrc=7,
                                             payload=rng.randbytes(20 + i)))
                     for i in range(8)]
            for d in media:
                c.sendto(d, relay_addr)
            up = await replies(upstream, len(media))
            # The relay's per-allocation socket, which the SFU answers.
            alloc_addr = relay.allocs[0x1234].upstream.transport.get_extra_info("sockname")
            back = [rng.randbytes(30 + i) for i in range(5)]
            for d in back:
                upstream.sendto(d, (HOST, alloc_addr[1]))
            down = await replies(c, len(back))
            await asyncio.sleep(0.02)
            results[name] = (up, down, dict(relay.stats))
            assert up == media and down == back
        finally:
            relay.close()
            c.close()
            upstream.close()
    assert results["port"] == results["jax"]


async def test_relay_end_to_end_sealed_media():
    """Publisher and subscriber that never touch the SFU port: BIND →
    sealed punch → sealed media both ways through the relay, which holds
    no media keys (every forwarded byte string is sealed)."""
    rt, reg = runtime(), MediaCryptoRegistry()
    tr, transport, sfu_port = await sfu(rt, reg)
    relay, relay_addr = await relay_on(sfu_port)
    pub, sub = client_socket(), client_socket()
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        pub_sess, sub_sess = reg.mint(), reg.mint()
        transport.bind_sub_session(0, 1, sub_sess)
        ssrc = transport.assign_ssrc(0, 0, is_video=False, session=pub_sess)
        alice = MediaCryptoClient(pub_sess.key_id, pub_sess.key)
        bob = MediaCryptoClient(sub_sess.key_id, sub_sess.key)

        bind_via(pub, relay_addr, mint_relay_token(SECRET, pub_sess.key_id, 30))
        bind_via(sub, relay_addr, mint_relay_token(SECRET, sub_sess.key_id, 30))
        assert await replies(pub) == [RELAY_MAGIC + bytes([BIND_ACK]) + pub_sess.key_id.to_bytes(4, "big")]
        assert await replies(sub) == [RELAY_MAGIC + bytes([BIND_ACK]) + sub_sess.key_id.to_bytes(4, "big")]
        assert len(relay.allocs) == 2

        # The sealed punch rides through; the SFU latches the relay's
        # per-allocation source port, never bob's own address.
        pid = transport.assign_subscriber_punch(0, 1)
        sub.sendto(bob.seal(PUNCH_REQ + pid.to_bytes(4, "big")), relay_addr)
        acks = [bob.open(f) for f in await replies(sub)]
        assert PUNCH_ACK + pid.to_bytes(4, "big") in acks
        latched = transport.sub_addrs[(0, 1)]
        assert latched[0] == HOST and latched[1] != sub.getsockname()[1]

        payload = b"relayed-opus"
        got = []
        for i in range(5):
            rx = transport.stats["rx"]
            pub.sendto(alice.seal(rtp_packet(sn=100 + i, ts=960 * i, ssrc=ssrc,
                                             payload=payload + bytes([i]))), relay_addr)
            await until(lambda: transport.stats["rx"] > rx, "the relayed packet")
            res = await rt.step_once()
            transport.send_egress(res.egress)
            for f in await replies(sub):
                assert f[0] == 0x01 and payload not in f   # still sealed on the wire
                inner = bob.open(f)
                if inner is not None and not (192 <= inner[1] <= 223):
                    got.append(inner)
        assert len(got) == 5
        out = native.rtp.parse_batch(got[0], np.asarray([0], np.int32),
                                     np.asarray([len(got[0])], np.int32))[0]
        assert int(out["sn"]) == 100
        off, ln = int(out["payload_off"]), int(out["payload_len"])
        assert got[0][off:off + ln] == payload + bytes([0])
        assert relay.stats["up_fwd"] >= 6 and relay.stats["down_fwd"] >= 6
    finally:
        pub.close()
        sub.close()
        relay.close()
        tr.close()


async def test_request_relay_signal_mints_token():
    """`request_relay` returns the relay address and a token the relay
    accepts for this participant's media session, and a null relay_info
    without a relay (the client falls back to TCP)."""
    room = Room("relayroom", runtime())
    room.crypto = MediaCryptoRegistry()
    sink = MessageChannel(size=100)
    p = Participant("alice", room, response_sink=sink)
    room.join(p)
    assert p.crypto_session is not None

    class FakeUdp:
        relay_info = ("203.0.113.9", 7885, SECRET, 30.0)

    room.udp = FakeUdp()
    handle_participant_signal(room, p, SignalRequest("request_relay", {}))
    room.udp = None
    handle_participant_signal(room, p, SignalRequest("request_relay", {}))
    infos = []
    while True:
        try:
            msg = decode_signal_response(sink._q.get_nowait())
        except asyncio.QueueEmpty:
            break
        if msg.kind == "request_response" and "relay_info" in msg.data:
            infos.append(msg.data["relay_info"])
    assert len(infos) == 2 and infos[1] is None
    info = infos[0]
    assert (info["host"], info["port"]) == ("203.0.113.9", 7885)
    assert verify_relay_token(SECRET, bytes.fromhex(info["token"])) == p.crypto_session.key_id
    assert jrelay.verify_relay_token(SECRET, bytes.fromhex(info["token"])) == \
        p.crypto_session.key_id


async def test_relay_admission_and_rebind():
    """Forged tokens never allocate; a re-BIND from a new source address
    moves the allocation (NAT-rebind recovery) and revokes the old path;
    a BIND burst for one session opens one upstream socket."""
    rt, reg = runtime(), MediaCryptoRegistry()
    tr, _transport, sfu_port = await sfu(rt, reg)
    relay, relay_addr = await relay_on(sfu_port)
    try:
        sess = reg.mint()
        c1 = client_socket()
        bind_via(c1, relay_addr, mint_relay_token(b"wrong", sess.key_id, 30))
        bind_via(c1, relay_addr, mint_relay_token(SECRET, sess.key_id, -1))
        errs = await replies(c1, 2)
        assert all(f == RELAY_MAGIC + bytes([BIND_ERR]) for f in errs)
        assert not relay.allocs and relay.stats["bad_bind"] == 2
        c1.sendto(b"\x01" + b"x" * 40, relay_addr)   # unbound: dropped
        await until(lambda: relay.stats["dropped"] == 1, "the drop")
        assert relay.stats["up_fwd"] == 0

        token = mint_relay_token(SECRET, sess.key_id, 30)
        bind_via(c1, relay_addr, token)
        assert (await replies(c1))[-1][4] == BIND_ACK
        assert relay.allocs[sess.key_id].client_addr == c1.getsockname()

        c2 = client_socket()
        bind_via(c2, relay_addr, token)               # same token, new socket: moves
        assert (await replies(c2))[-1][4] == BIND_ACK
        assert len(relay.allocs) == 1
        assert relay.allocs[sess.key_id].client_addr == c2.getsockname()
        assert c1.getsockname() not in relay.by_client
        c1.close()
        c2.close()

        sess2 = reg.mint()
        c3 = client_socket()
        burst_token = mint_relay_token(SECRET, sess2.key_id, 30)
        for _ in range(8):
            bind_via(c3, relay_addr, burst_token)
        await replies(c3)
        await until(lambda: not relay._pending, "the burst's creation")
        assert len(relay.allocs) == 2               # no duplicates
        c3.close()
    finally:
        relay.close()
        tr.close()


async def test_relay_idle_allocations_expire():
    rt, reg = runtime(), MediaCryptoRegistry()
    tr, _transport, sfu_port = await sfu(rt, reg)
    relay, relay_addr = await relay_on(sfu_port, ttl_s=0.1)
    try:
        sess = reg.mint()
        c = client_socket()
        bind_via(c, relay_addr, mint_relay_token(SECRET, sess.key_id, 30))
        await replies(c)
        assert len(relay.allocs) == 1
        # The sweeper's period is max(1 s, ttl/4): idle past the ttl → reaped.
        deadline = time.monotonic() + 3.0
        while relay.allocs and time.monotonic() < deadline:
            await asyncio.sleep(0.1)
        assert not relay.allocs and relay.stats["expired"] == 1
        c.close()
    finally:
        relay.close()
        tr.close()


async def test_relay_move_requires_continuity_proof():
    """v2 BINDs pin a hash-chain commitment: a captured BIND (v1 or v2)
    replayed from another address cannot move the allocation; only the
    holder of the unrevealed preimage, or of a fresh token, can."""
    rt, reg = runtime(), MediaCryptoRegistry()
    tr, _transport, sfu_port = await sfu(rt, reg)
    relay, relay_addr = await relay_on(sfu_port)

    async def bind(sock, token):
        bind_via(sock, relay_addr, token)
        return (await replies(sock))[-1][4]

    owner, mover, attacker = client_socket(), client_socket(), client_socket()
    try:
        sess = reg.mint()
        token = mint_relay_token(SECRET, sess.key_id, 30)
        reveal1, reveal2 = _secrets.token_bytes(16), _secrets.token_bytes(16)
        commit1, commit2 = continuity_commit(reveal1), continuity_commit(reveal2)
        first_bind = token + b"\x00" * 16 + commit1
        assert await bind(owner, first_bind) == BIND_ACK
        alloc = lambda k: relay.allocs[k].client_addr  # noqa: E731
        assert alloc(sess.key_id) == owner.getsockname()
        # Captured v1 and first v2 BINDs replayed elsewhere: refused.
        assert await bind(attacker, token) == BIND_ERR
        assert await bind(attacker, first_bind) == BIND_ERR
        assert alloc(sess.key_id) == owner.getsockname()
        # A legitimate move reveals the pinned preimage and pins the next.
        move_bind = token + reveal1 + commit2
        assert await bind(mover, move_bind) == BIND_ACK
        assert alloc(sess.key_id) == mover.getsockname()
        assert await bind(attacker, move_bind) == BIND_ERR   # reveal1 is spent
        assert alloc(sess.key_id) == mover.getsockname()
        assert await bind(owner, token + reveal2 + continuity_commit(b"x" * 16)) == BIND_ACK
        assert alloc(sess.key_id) == owner.getsockname()

        # A replay may move an unpinned (v1) allocation but never plant a
        # pin; the victim's plain v1 re-BIND reclaims the path.
        sessv1 = reg.mint()
        tokv1 = mint_relay_token(SECRET, sessv1.key_id, 30)
        assert await bind(owner, tokv1) == BIND_ACK
        assert await bind(attacker, tokv1 + b"\x00" * 16 +
                          continuity_commit(b"evil" * 4)) == BIND_ACK
        assert alloc(sessv1.key_id) == attacker.getsockname()
        assert relay.allocs[sessv1.key_id].commit is None
        assert await bind(owner, tokv1) == BIND_ACK
        assert alloc(sessv1.key_id) == owner.getsockname()

        # Recovery: a fresh token re-pins without a proof, and its
        # captured BIND is useless once spent.
        tok2 = mint_relay_token(SECRET, sess.key_id, 30)
        rec_bind = tok2 + b"\x00" * 16 + continuity_commit(_secrets.token_bytes(16))
        assert await bind(mover, rec_bind) == BIND_ACK
        assert alloc(sess.key_id) == mover.getsockname()
        assert await bind(attacker, rec_bind) == BIND_ERR
        assert alloc(sess.key_id) == mover.getsockname()
    finally:
        for s in (owner, mover, attacker):
            s.close()
        relay.close()
        tr.close()
