"""The port's UDP media transport, RTCP and retransmission
(livekit_server_tpu_torch.runtime.udp on PlaneRuntime(device="cpu")): the
reference's tests/test_udp.py cases for NACK → RTX, REMB, SR/RR and RTT,
TWCC feedback into the allocation budget, and the forward-latency probe
(overflow bin, concurrent reads, coverage of every egress path).

Transports bind port 0; every wait polls a condition up to a deadline
(tests/torch_udp_fixture.py).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch import native  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.ops.pacer import WIRE_OVERHEAD_BYTES  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.crypto import (  # noqa: E402
    MediaCryptoClient,
    MediaCryptoRegistry,
    parse_counter,
)
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.udp import (  # noqa: E402
    RTCP_RR,
    RTCP_SR,
    ForwardLatencyProbe,
    build_nack,
    build_remb,
    build_twcc_feedback,
    ntp_mid32,
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
)

DIMS = plane.PlaneDims(rooms=2, tracks=4, pkts=8, subs=4)


def runtime():
    return PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu")


async def test_udp_nack_rtx_end_to_end():
    """A subscriber loses a packet, NACKs it over RTCP, and receives the
    retransmit with the original munged SN and payload bytes, resolved
    host-side at RTCP time."""
    rt = runtime()
    transport, port = await udp_transport(rt, nack_resolver=rt.resolve_nacks)
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc = transport.assign_ssrc(room=0, track=0, is_video=False)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        for i in range(5):
            await send(transport, pub, rtp_packet(
                sn=600 + i, ts=960 * i, ssrc=ssrc, audio_level=20,
                payload=b"opus" + bytes([i])), port)
            res = await rt.step_once()
            transport.send_egress(res.egress)
            await recv(sub, 1)        # the original delivery ("lost 602")
        drain(sub, media_only=False)
        dt_ssrc = transport.subscriber_ssrc(0, 1, 0)
        await send(transport, sub, build_nack(0x1234, dt_ssrc, [602]), port)
        assert transport.stats["nacks_rx"] == 1
        assert rt.stats.get("rtx_packets", 0) == 1
        data = (await recv(sub, 1))[0]
        out = native.rtp.parse_batch(
            data, np.asarray([0], np.int32), np.asarray([len(data)], np.int32))[0]
        assert int(out["sn"]) == 602
        off, ln = int(out["payload_off"]), int(out["payload_len"])
        assert data[off : off + ln] == b"opus\x02"
        # Immediate duplicate NACK is RTT-throttled host-side.
        await send(transport, sub, build_nack(0x1234, dt_ssrc, [602]), port)
        assert rt.stats.get("rtx_packets", 0) == 1  # no second replay
        assert transport.stats["rtx_tx"] == 1
        assert not drain(sub), "throttled NACK produced a retransmit"
        pub.close()
        sub.close()
    finally:
        transport.transport.close()


async def test_udp_remb_feeds_bwe_estimate():
    """A REMB from the subscriber's own address lands as a BWE estimate
    sample; one from a spoofed source is rejected."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        sub = client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        dt_ssrc = transport.subscriber_ssrc(0, 1, 0)
        await send(transport, sub, build_remb(0x1234, 2_500_000.0, [dt_ssrc]), port)
        assert rt.ingest._estimate_valid[0, 1]
        assert abs(rt.ingest._estimate[0, 1] - 2_500_000.0) / 2_500_000.0 < 0.01
        evil = client_socket()
        await send(transport, evil, build_remb(0x1234, 10.0, [dt_ssrc]), port)
        assert rt.ingest._estimate[0, 1] > 1_000_000  # unchanged
        assert transport.stats["addr_mismatch"] >= 1
        evil.close()
        sub.close()
    finally:
        transport.transport.close()


async def test_udp_sender_report_and_rtt():
    """The server emits SRs per downtrack SSRC; a subscriber's RR echoing
    LSR/DLSR updates that sub's RTT (RFC 3550 A.8)."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc = transport.assign_ssrc(room=0, track=0, is_video=False)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        transport._last_sr_ms = -1e9  # force the first SR immediately
        await send(transport, pub, rtp_packet(sn=600, ts=960, ssrc=ssrc, payload=b"x"),
                   port)
        res = await rt.step_once()
        transport.send_egress(res.egress)
        got = await recv(sub, 2, media_only=False)       # the media and the SR
        srs = [d for d in got if d[1] == RTCP_SR]
        assert srs, "no SR emitted alongside egress"
        sr = srs[-1]
        dt_ssrc = int.from_bytes(sr[4:8], "big")
        lsr = ntp_mid32(int.from_bytes(sr[8:16], "big"))
        block = (
            dt_ssrc.to_bytes(4, "big") + bytes([0]) + (0).to_bytes(3, "big")
            + (600).to_bytes(4, "big") + (0).to_bytes(4, "big")
            + lsr.to_bytes(4, "big") + (0).to_bytes(4, "big")
        )
        rr = bytes([0x80 | 1, RTCP_RR, 0, 7]) + (0x1234).to_bytes(4, "big") + block
        await send(transport, sub, rr, port)
        assert rt.ingest.rtt_ms[0, 1] < 100
        pub.close()
        sub.close()
    finally:
        transport.transport.close()


async def test_twcc_feedback_caps_allocation_budget():
    """TWCC end to end: sealed egress counters → client feedback frames →
    host delay/rate reductions → the device's send-side estimator caps
    the allocator budget, with no estimate from the client."""
    rt = runtime()
    reg = MediaCryptoRegistry()
    tr, transport, port = await endpoint_transport(rt, crypto=reg, require_encryption=True)
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        sub_sess = reg.mint()
        transport.bind_sub_session(0, 1, sub_sess)
        bob = MediaCryptoClient(sub_sess.key_id, sub_sess.key)
        sub = client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        assert bool(rt.ingest.fb_enabled[0, 1])
        media_ssrc = transport.subscriber_ssrc(0, 1, 0)
        recv_us = 0
        for i in range(30):
            rt.ingest.push(PacketIn(room=0, track=0, sn=100 + i, ts=960 * i, size=120,
                                    payload=b"y" * 120))
            res = await rt.step_once()
            transport.send_egress_batch(res.egress_batch)
            frames = await recv(sub, len(res.egress_batch), media_only=False)
            frames += drain(sub, media_only=False)
            ctrs = [c for f in frames
                    if (c := parse_counter(f)) is not None and bob.open(f) is not None]
            if ctrs:
                # Congested receiver: every frame 25 ms after the last while
                # the sender paces at 10 ms.
                entries = []
                for c in sorted(ctrs):
                    recv_us += 25_000
                    entries.append((c, recv_us))
                fb = build_twcc_feedback(0xB0B, media_ssrc, entries)
                await send(transport, sub, bob.seal(fb), port)
        assert transport.stats.get("twcc_rx", 0) > 0
        committed = float(rt._last_committed[0, 1])
        assert committed < 1_000_000.0, committed
        sub.close()
    finally:
        tr.close()
        await rt.stop()


def test_probe_overflow_bin_reports_exact_max():
    """Samples beyond the histogram's 60 s top edge land in the overflow
    bin; quantiles there report the exact max."""
    p = ForwardLatencyProbe()
    p.observe(np.full(100, 75.0))
    s = p.summary()
    assert s["p50_ms"] == s["p99_ms"] == s["max_ms"] == 75000.0
    p.reset()
    p.observe(np.concatenate([np.full(95, 0.010), np.full(5, 90.0)]))
    s = p.summary()
    assert 9.0 <= s["p50_ms"] <= 12.0
    assert s["p99_ms"] == 90000.0


def test_probe_summary_concurrent_with_observe():
    """summary() snapshots under the probe lock while a thread observes:
    derived stats stay internally consistent."""
    p = ForwardLatencyProbe()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            p.observe(np.full(64, 0.005))

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(300):
            s = p.summary()
            if s["n"]:
                assert abs(s["mean_ms"] - 5.0) < 1e-6
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()


async def test_probe_coverage_all_egress_paths():
    """At least 99 % of wire egress carries a nonzero rx stamp into the
    forward-latency probe across the UDP batch path, the pacer-deferred
    cold path and the TCP fallback."""
    rt = runtime()
    reg = MediaCryptoRegistry()
    transport, port = await udp_transport(rt, crypto=reg)
    transport.pacer_mode = "leaky-bucket"
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)  # UDP sub
        rt.set_subscription(0, 0, 2, subscribed=True)  # TCP sub
        ssrc = transport.assign_ssrc(room=0, track=0, is_video=False)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        sess = reg.mint()
        transport.bind_sub_session(0, 2, sess)
        tcp_frames = []
        transport.tcp_sinks[sess.key_id] = tcp_frames.append
        transport.register_subscriber(0, 2, ("tcp", sess.key_id))
        bob = MediaCryptoClient(sess.key_id, sess.key)
        R, S = DIMS.rooms, DIMS.subs
        udp_rx = 0
        n_ticks, per_tick = 6, 4
        for tick in range(n_ticks):
            base = transport.stats["rx"]
            for i in range(per_tick):
                pub.sendto(rtp_packet(sn=1000 + tick * per_tick + i, ts=960 * tick,
                                      ssrc=ssrc, audio_level=20, payload=b"x" * 8),
                           (HOST, port))
            await delivered(transport, per_tick, base)
            res = await rt.step_once()
            # The budget admits half the UDP sub's packets a tick; the rest
            # defer and drain on later ticks (the cold path).
            allowed = np.zeros((R, S), np.float32)
            allowed[0, 1] = (per_tick / 2 + tick) * (8 + WIRE_OVERHEAD_BYTES)
            transport.send_egress_batch(res.egress_batch, pacer_allowed=allowed)
            udp_rx += len(drain(sub))
        z = np.zeros(0, np.int32)
        empty = res.egress_batch.__class__(
            rooms=z, tracks=z, ks=z, subs=z, sn=z, ts=z, pid=z, tl0=z, keyidx=z,
            payloads=res.egress_batch.payloads)
        for _ in range(4):
            transport.send_egress_batch(empty, pacer_allowed=np.full((R, S), 1e6, np.float32))
            udp_rx += len(drain(sub))
        n_sent = n_ticks * per_tick
        udp_rx += len(await recv(sub, n_sent - udp_rx)) if udp_rx < n_sent else 0
        tcp_media = sum(1 for f in tcp_frames
                        if (inner := bob.open(f)) is not None and not 192 <= inner[1] <= 223)
        assert udp_rx == n_sent, f"UDP sub got {udp_rx}/{n_sent}"
        assert tcp_media == n_sent, f"TCP sub got {tcp_media}/{n_sent}"
        probe = transport.fwd_latency
        assert probe.n >= 0.99 * (udp_rx + tcp_media), (
            f"probe covered {probe.n}/{udp_rx + tcp_media} egress packets")
        pub.close()
        sub.close()
    finally:
        transport.transport.close()
        await rt.stop()
