"""The port's UDP media transport, receive side and address latching
(livekit_server_tpu_torch.runtime.udp / tcp on PlaneRuntime(device="cpu")):
the reference's tests/test_udp.py cases for plain and sealed publish →
forward → receive, punch latching, upstream NACKs, unknown SSRCs, the TCP
fallback and the send-side BWE switch, over real loopback sockets.

Transports bind port 0; every wait polls a condition up to a deadline
(tests/torch_udp_fixture.py).
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch import native  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.crypto import (  # noqa: E402
    MediaCryptoClient,
    MediaCryptoRegistry,
)
from livekit_server_tpu_torch.runtime.tcp import start_tcp_transport  # noqa: E402
from livekit_server_tpu_torch.runtime.udp import (  # noqa: E402
    PUNCH_ACK,
    PUNCH_REQ,
    RTCP_RTPFB,
    UDPMediaTransport,
    parse_nack_fci,
)
from tests.test_native import rtp_packet  # noqa: E402
from tests.torch_udp_fixture import (  # noqa: E402
    HOST,
    client_socket,
    delivered,
    drain,
    endpoint_transport,
    recv,
    send,
    udp_transport,
    until,
)

DIMS = plane.PlaneDims(rooms=2, tracks=4, pkts=8, subs=4)


def runtime():
    return PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu")


def parse(data: bytes):
    return native.rtp.parse_batch(
        data, np.asarray([0], np.int32), np.asarray([len(data)], np.int32))[0]


async def test_udp_publish_forward_receive():
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc = transport.assign_ssrc(room=0, track=0, is_video=False)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        got = []
        for i in range(5):
            await send(transport, pub, rtp_packet(
                sn=600 + i, ts=960 * i, ssrc=ssrc, audio_level=20,
                payload=b"opus" + bytes([i])), port)
            res = await rt.step_once()
            transport.send_egress(res.egress)
            got += await recv(sub, 1)
        assert transport.stats["rx"] == 5
        assert transport.stats["parse_errors"] == 0
        assert len(got) == 5
        for i, data in enumerate(got):
            out = parse(data)
            assert int(out["sn"]) == 600 + i
            off, ln = int(out["payload_off"]), int(out["payload_len"])
            assert data[off : off + ln] == b"opus" + bytes([i])
        pub.close()
        sub.close()
    finally:
        transport.transport.close()


async def test_udp_punch_latches_only_real_source():
    """Egress addresses latch only from a punch datagram carrying a minted
    id, sent from the client's actual socket."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        pid = transport.assign_subscriber_punch(0, 1)
        sub = client_socket()
        # wrong id: no latch, counted
        await send(transport, sub, PUNCH_REQ + (pid ^ 0xFFFF).to_bytes(4, "big"), port)
        assert (0, 1) not in transport.sub_addrs
        assert transport.stats["bad_punch"] == 1
        # right id from the real socket: latches + acked
        await send(transport, sub, PUNCH_REQ + pid.to_bytes(4, "big"), port)
        assert transport.sub_addrs[(0, 1)] == sub.getsockname()
        assert (await recv(sub, 1, media_only=False))[0] == PUNCH_ACK + pid.to_bytes(4, "big")
        # retry from the SAME socket (lost ack): re-acked, still latched
        await send(transport, sub, PUNCH_REQ + pid.to_bytes(4, "big"), port)
        assert (await recv(sub, 1, media_only=False))[0] == PUNCH_ACK + pid.to_bytes(4, "big")
        # replay of the latched id from a DIFFERENT socket: rejected
        evil = client_socket()
        await send(transport, evil, PUNCH_REQ + pid.to_bytes(4, "big"), port)
        assert transport.sub_addrs[(0, 1)] == sub.getsockname()
        assert transport.stats["bad_punch"] == 2
        evil.close()
        # the outstanding id is reused across subscription signals…
        assert transport.assign_subscriber_punch(0, 2) == transport.assign_subscriber_punch(0, 2)
        assert transport.assign_subscriber_punch(0, 1) == pid
        # …but an explicit re-punch request rotates it
        pid2 = transport.assign_subscriber_punch(0, 1, rotate=True)
        assert pid2 != pid
        assert pid not in transport.punch_ids
        sub2 = client_socket()
        await send(transport, sub2, PUNCH_REQ + pid2.to_bytes(4, "big"), port)
        assert transport.sub_addrs[(0, 1)] == sub2.getsockname()
        sub2.close()
        # release clears the outstanding punch id too
        transport.release_subscriber(0, 1)
        assert pid2 not in transport.punch_ids
        assert (0, 1) not in transport._punch_by_sub
        sub.close()
    finally:
        transport.transport.close()


async def test_udp_upstream_nack_generation():
    """A gap in the publisher's SN stream makes the server NACK the
    publisher over RTCP (buffer.go doNACKs); a late arrival clears it."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=True)
        ssrc = transport.assign_ssrc(room=0, track=0, is_video=True)
        pub = client_socket()
        await send(transport, pub, rtp_packet(sn=100, ssrc=ssrc, payload=b"a"), port)
        # 101, 102 go missing:
        await send(transport, pub, rtp_packet(sn=103, ssrc=ssrc, payload=b"d"), port)
        data = (await recv(pub, 1, media_only=False))[0]
        assert data[1] == RTCP_RTPFB
        assert sorted(parse_nack_fci(data[12:])) == [101, 102]
        assert transport.stats["nacks_tx"] == 2
        # The retransmitted 101 lands and leaves only 102 tracked missing.
        await send(transport, pub, rtp_packet(sn=101, ssrc=ssrc, payload=b"b"), port)
        assert 101 not in transport._rx_missing[ssrc]
        assert 102 in transport._rx_missing[ssrc]
        pub.close()
    finally:
        transport.transport.close()


async def test_udp_unknown_ssrc_dropped():
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        pub = client_socket()
        base = transport.stats["rx"]
        pub.sendto(rtp_packet(ssrc=0xBEEF), (HOST, port))
        pub.sendto(b"garbage", (HOST, port))
        await delivered(transport, 2, base)
        assert transport.stats["unknown_ssrc"] == 1
        assert transport.stats["parse_errors"] == 1
        assert not rt.ingest.valid.any()
        pub.close()
    finally:
        transport.transport.close()


async def test_udp_encrypted_media_end_to_end():
    """Secure wire: sealed RTP in, sealed egress out; a sniffer can read
    nothing and inject nothing."""
    rt = runtime()
    reg = MediaCryptoRegistry()
    tr, transport, port = await endpoint_transport(rt, crypto=reg, require_encryption=True)
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        pub_sess, sub_sess = reg.mint(), reg.mint()
        transport.bind_sub_session(0, 1, sub_sess)
        ssrc = transport.assign_ssrc(0, 0, is_video=False, session=pub_sess)
        alice = MediaCryptoClient(pub_sess.key_id, pub_sess.key)
        bob = MediaCryptoClient(sub_sess.key_id, sub_sess.key)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        SECRET = b"top-secret-opus"
        wire_frames = []
        for i in range(5):
            await send(transport, pub, alice.seal(rtp_packet(
                sn=700 + i, ts=960 * i, ssrc=ssrc, payload=SECRET + bytes([i]))), port)
            res = await rt.step_once()
            transport.send_egress(res.egress)
            wire_frames += await recv(sub, 1, media_only=False)
        wire_frames += drain(sub, media_only=False)
        for f in wire_frames:
            assert f[0] == 0x01 and SECRET not in f
        opened = [bob.open(f) for f in wire_frames]
        media = [o for o in opened if o is not None and not (192 <= o[1] <= 223)]
        assert len(media) == 5
        for i, m in enumerate(media):
            out = parse(m)
            assert int(out["sn"]) == 700 + i
            off, ln = int(out["payload_off"]), int(out["payload_len"])
            assert m[off : off + ln] == SECRET + bytes([i])
        # Injection 1: plaintext RTP with the right SSRC → dropped.
        before = rt.ingest._count.sum()
        await send(transport, pub, rtp_packet(sn=900, ssrc=ssrc, payload=b"evil"), port)
        assert transport.stats["plaintext_drop"] == 1
        assert rt.ingest._count.sum() == before
        # Injection 2: valid OTHER key, right SSRC → session mismatch.
        await send(transport, pub, bob.seal(rtp_packet(sn=901, ssrc=ssrc, payload=b"evil")),
                   port)
        assert transport.stats["session_mismatch"] == 1
        assert rt.ingest._count.sum() == before
        # Injection 3: replayed sealed publisher frame → rejected.
        replay = alice.seal(rtp_packet(sn=702, ssrc=ssrc, payload=b"x"))
        await send(transport, pub, replay, port)
        await send(transport, pub, replay, port)
        assert transport.stats["bad_frame"] >= 1
        pub.close()
        sub.close()
    finally:
        tr.close()


async def test_tcp_media_fallback():
    """A client speaks the same sealed frames over the TCP fallback and
    publishes and receives media with no UDP socket at all."""
    rt = runtime()
    reg = MediaCryptoRegistry()
    udp = UDPMediaTransport(rt.ingest, crypto=reg, require_encryption=True)
    tcp = await start_tcp_transport(udp, reg, HOST, 0)
    port = tcp.server.sockets[0].getsockname()[1]
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        pub_sess, sub_sess = reg.mint(), reg.mint()
        udp.bind_sub_session(0, 1, sub_sess)
        ssrc = udp.assign_ssrc(0, 0, is_video=False, session=pub_sess)
        alice = MediaCryptoClient(pub_sess.key_id, pub_sess.key)
        bob = MediaCryptoClient(sub_sess.key_id, sub_sess.key)

        def frame(b: bytes) -> bytes:
            return len(b).to_bytes(2, "big") + b

        a_r, a_w = await asyncio.open_connection(HOST, port)
        b_r, b_w = await asyncio.open_connection(HOST, port)
        # Any authenticated frame binds the connection; a tiny RTCP RR.
        hello = bytes([0x80, 201, 0, 1]) + (0x1234).to_bytes(4, "big")
        b_w.write(frame(bob.seal(hello)))
        await b_w.drain()
        await until(lambda: udp.sub_addrs.get((0, 1)) == ("tcp", sub_sess.key_id),
                    "the TCP bind")
        got = []

        async def reader():
            while True:
                hdr = await b_r.readexactly(2)
                data = await b_r.readexactly(int.from_bytes(hdr, "big"))
                inner = bob.open(data)
                if inner is not None and not (192 <= inner[1] <= 223):
                    got.append(inner)

        rd = asyncio.ensure_future(reader())
        for i in range(5):
            a_w.write(frame(alice.seal(rtp_packet(
                sn=800 + i, ts=960 * i, ssrc=ssrc, payload=b"tcp" + bytes([i])))))
            await a_w.drain()
            await until(lambda i=i: tcp.stats["frames_rx"] >= 2 + i, "the TCP frame")
            res = await rt.step_once()
            udp.send_egress(res.egress)
            await until(lambda i=i: len(got) > i, "the TCP egress")
        rd.cancel()
        assert len(got) == 5
        for i, m in enumerate(got):
            out = parse(m)
            assert int(out["sn"]) == 800 + i
            off, ln = int(out["payload_off"]), int(out["payload_len"])
            assert m[off : off + ln] == b"tcp" + bytes([i])
        a_w.close()
        b_w.close()
    finally:
        tcp.close()


async def test_tcp_fallback_disables_twcc_feedback():
    """A subscriber that falls back from UDP to TCP has fb_enabled cleared
    (TCP egress carries no TWCC counters)."""
    rt = runtime()
    reg = MediaCryptoRegistry()
    udp = UDPMediaTransport(rt.ingest, crypto=reg, require_encryption=True)
    tcp = await start_tcp_transport(udp, reg, HOST, 0)
    port = tcp.server.sockets[0].getsockname()[1]
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        sub_sess = reg.mint()
        udp.bind_sub_session(0, 1, sub_sess)
        udp.register_subscriber(0, 1, (HOST, 50000))
        assert bool(rt.ingest.fb_enabled[0, 1])  # sealed UDP: TWCC on
        bob = MediaCryptoClient(sub_sess.key_id, sub_sess.key)
        r, w = await asyncio.open_connection(HOST, port)
        hello = bytes([0x80, 201, 0, 1]) + (0x1234).to_bytes(4, "big")
        sealed = bob.seal(hello)
        w.write(len(sealed).to_bytes(2, "big") + sealed)
        await w.drain()
        await until(lambda: udp.sub_addrs.get((0, 1)) == ("tcp", sub_sess.key_id),
                    "the TCP bind")
        assert not bool(rt.ingest.fb_enabled[0, 1])  # TCP: TWCC off
        w.close()
        # Teardown removes the route entirely — still no feedback expected.
        await until(lambda: (0, 1) not in udp.sub_addrs, "the TCP teardown")
        assert not bool(rt.ingest.fb_enabled[0, 1])
    finally:
        tcp.close()


async def test_send_side_bwe_off_switch():
    """send_side_bwe=false keeps fb_enabled off for an otherwise-eligible
    sealed-UDP subscriber."""
    rt = runtime()
    reg = MediaCryptoRegistry()
    tr, transport, _port = await endpoint_transport(rt, crypto=reg, require_encryption=True)
    try:
        transport.send_side_bwe = False
        transport.bind_sub_session(0, 1, reg.mint())
        transport.register_subscriber(0, 1, (HOST, 50001))
        assert not bool(rt.ingest.fb_enabled[0, 1])
        # Flipping it on and re-registering enables the path.
        transport.send_side_bwe = True
        transport.register_subscriber(0, 1, (HOST, 50001))
        assert bool(rt.ingest.fb_enabled[0, 1])
    finally:
        tr.close()
        await rt.stop()
