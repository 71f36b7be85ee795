"""The port's UDP media transport, send side (livekit_server_tpu_torch.runtime.udp
on PlaneRuntime(device="cpu")): the reference's tests/test_udp.py cases
for the munged VP8 / H264 / VP9-SVC streams on the wire across layer
switches, SR-aligned timestamps, the native batch egress (sealed, clear
and the WebSocket complement), both pacers and the forward-latency probe,
over real loopback sockets.

Transports bind port 0; every wait polls a condition up to a deadline
(tests/torch_udp_fixture.py).
"""

import time

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
)
from livekit_server_tpu_torch.runtime.udp import (  # noqa: E402
    H264_PT,
    SVC_PT,
    build_sr,
    ntp_now,
)
from tests.test_native import rtp_packet, vp8_payload  # noqa: E402
from tests.test_udp import _h264_payload, _vp9_payload  # noqa: E402
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


def parse(data: bytes, **kw):
    return native.rtp.parse_batch(
        data, np.asarray([0], np.int32), np.asarray([len(data)], np.int32), **kw)[0]


def empty_batch(batch):
    z = np.zeros(0, np.int32)
    return batch.__class__(rooms=z, tracks=z, ks=z, subs=z, sn=z, ts=z, pid=z, tl0=z,
                           keyidx=z, payloads=batch.payloads)


async def test_udp_vp8_rewrite_reaches_wire_across_layer_switch():
    """Simulcast layer switch: the rewritten picture ids appear in the
    payload bytes on the wire, contiguous across the switch."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=True)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc0 = transport.assign_ssrc(room=0, track=0, is_video=True, layer=0)
        ssrc1 = transport.assign_ssrc(room=0, track=0, is_video=True, layer=1)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        got = []

        async def send_and_step(sn, ts, ssrc, pid, keyframe):
            await send(transport, pub, rtp_packet(
                sn=sn, ts=ts, ssrc=ssrc, pt=96,
                payload=vp8_payload(pid=pid, tl0=pid % 256, tid=0, keyidx=pid % 32,
                                    keyframe=keyframe)), port)
            res = await rt.step_once()
            transport.send_egress(res.egress)
            got.extend(await recv(sub, len(res.egress)))

        for i in range(6):
            await send_and_step(100 + i, 90 * i, ssrc0, 1000 + i, i == 0)
        for i in range(30):
            await send_and_step(500 + i, 90 * (6 + i), ssrc1, 5000 + i, True)
        assert len(got) >= 10, f"only {len(got)} packets received"
        pids = []
        for data in got:
            out = parse(data, vp8_pts={96})
            assert int(out["payload_len"]) > 0
            pids.append(int(out["picture_id"]))
        diffs = [b - a for a, b in zip(pids, pids[1:])]
        assert all(d == 1 for d in diffs), f"pids not contiguous: {pids}"
        pub.close()
        sub.close()
    finally:
        transport.transport.close()


async def test_udp_sr_aligned_ts_across_layer_switch():
    """Publisher SRs for both simulcast layers put them on one timeline;
    the wire TS across a layer switch is then exactly continuous."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=True)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc0 = transport.assign_ssrc(room=0, track=0, is_video=True, layer=0)
        ssrc1 = transport.assign_ssrc(room=0, track=0, is_video=True, layer=1)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        L1_OFF = 100_000
        ntp = ntp_now()
        got = []

        async def send_and_step(sn, ts, ssrc, pid, keyframe):
            await send(transport, pub, rtp_packet(
                sn=sn, ts=ts, ssrc=ssrc, pt=96,
                payload=vp8_payload(pid=pid, tl0=pid % 256, tid=0, keyidx=pid % 32,
                                    keyframe=keyframe)), port)
            res = await rt.step_once()
            transport.send_egress(res.egress)
            got.extend(await recv(sub, len(res.egress)))

        await send_and_step(100, 0, ssrc0, 1000, True)
        await send_and_step(500, L1_OFF, ssrc1, 5000, True)
        await send(transport, pub, build_sr(ssrc0, ntp, 0, 1, 100), port)
        await send(transport, pub, build_sr(ssrc1, ntp, L1_OFF, 1, 100), port)
        assert transport._ts_delta[(0, 0, 1)] == L1_OFF
        assert transport._ts_delta[(0, 0, 0)] == 0
        for i in range(1, 6):
            await send_and_step(100 + i, 3000 * i, ssrc0, 1000 + i, i == 1)
        for i in range(30):
            await send_and_step(501 + i, L1_OFF + 3000 * (6 + i), ssrc1, 5000 + i, True)
        tss = [int.from_bytes(d[4:8], "big") for d in got]
        assert len(tss) >= 10
        diffs = [b - a for a, b in zip(tss, tss[1:])]
        assert all(d % 3000 == 0 and 0 < d <= 9000 for d in diffs), (tss, diffs)
        pub.close()
        sub.close()
    finally:
        transport.transport.close()


async def test_udp_native_batch_egress():
    """send_egress_batch (one native assemble/seal/sendmmsg call): sealed
    frames for keyed subscribers, cleartext for legacy ones, VP8
    descriptors patched, and the WebSocket-complement mask."""
    rt = runtime()
    reg = MediaCryptoRegistry()
    tr, transport, port = await endpoint_transport(rt, crypto=reg)
    try:
        rt.set_track(0, 0, published=True, is_video=True)
        for sub_col in (0, 1, 2):
            rt.set_subscription(0, 0, sub_col, subscribed=True)
        pub_ssrc = transport.assign_ssrc(0, 0, is_video=True)
        sealed_sess = reg.mint()
        sealed_sess.client_active = True
        transport.bind_sub_session(0, 0, sealed_sess)
        bob = MediaCryptoClient(sealed_sess.key_id, sealed_sess.key)
        socks = {}
        for sub_col in (0, 1):
            socks[sub_col] = client_socket()
            transport.register_subscriber(0, sub_col, socks[sub_col].getsockname())
        pub = client_socket()
        frames = {0: [], 1: []}
        handled_masks = []
        for i in range(10):
            await send(transport, pub, rtp_packet(
                sn=900 + i, ts=3000 * i, ssrc=pub_ssrc, pt=96,
                payload=vp8_payload(pid=800 + i, tl0=7, tid=0, keyframe=True)), port)
            res = await rt.step_once()
            handled = transport.send_egress_batch(res.egress_batch)
            handled_masks.append((res.egress_batch, handled))
            subs = np.asarray(res.egress_batch.subs)
            for sub_col, ss in socks.items():
                frames[sub_col] += await recv(ss, int((subs == sub_col).sum()),
                                              media_only=sub_col == 1)
        frames[0] += drain(socks[0], media_only=False)   # sealed: SRs counted above
        frames[1] += drain(socks[1])
        assert len(frames[0]) >= 4 and len(frames[1]) >= 4
        opened = []
        for f in frames[0]:
            assert f[0] == 0x01
            pt = bob.open(f)
            assert pt is not None
            if not 192 <= pt[1] <= 223:
                opened.append(pt)
        for f in frames[1]:
            assert f[0] >> 6 == 2 and (f[1] & 0x7F) == 96

        def fields(dgram):
            d = dgram[12:]
            return int.from_bytes(dgram[2:4], "big"), ((d[2] & 0x7F) << 8) | d[3]

        sealed_sns = [fields(p)[0] for p in opened]
        clear_sns = [fields(f)[0] for f in frames[1]]
        assert sealed_sns == sorted(sealed_sns)
        assert clear_sns == sealed_sns
        sealed_pids = [fields(p)[1] for p in opened]
        assert sealed_pids == sorted(sealed_pids)
        batch, handled = handled_masks[-1]
        subs = np.asarray(batch.subs)
        assert handled[subs == 0].all() and handled[subs == 1].all()
        assert not handled[subs == 2].any()
        ws = batch.to_packets(~handled)
        assert ws and all(p.sub == 2 for p in ws)
    finally:
        tr.close()
        await rt.stop()


async def test_pacer_spreads_tick_burst():
    """The no-queue pacer spreads a tick's egress across the configured
    window instead of one burst, and loses nothing."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        transport.pacer_spread_ms = 60.0
        transport.egress_threads = 1  # one worker: deterministic chunking
        # 4 audio tracks x 8 pkts x 4 subs = 128 entries > PACE_CHUNK(64).
        for t in range(4):
            rt.set_track(0, t, published=True, is_video=False)
        ssrcs = [transport.assign_ssrc(0, t, is_video=False) for t in range(4)]
        subs = []
        for sub_col in range(4):
            subs.append(client_socket())
            transport.register_subscriber(0, sub_col, subs[-1].getsockname())
            for t in range(4):
                rt.set_subscription(0, t, sub_col, subscribed=True)
        pub = client_socket()
        base = transport.stats["rx"]
        for t, ssrc in enumerate(ssrcs):
            for i in range(8):
                pub.sendto(rtp_packet(sn=100 + 8 * t + i, ts=960 * i, ssrc=ssrc,
                                      audio_level=20, payload=b"pace%d%d" % (t, i)),
                           (HOST, port))
        await delivered(transport, 32, base)
        res = await rt.step_once()
        transport.send_egress_batch(res.egress_batch)
        arrivals = []

        def poll() -> bool:
            for ss in subs:
                arrivals.extend(time.perf_counter() for _ in drain(ss))
            return len(arrivals) >= 128

        await until(poll, "128 paced datagrams", timeout=10.0)
        assert len(arrivals) == 128, f"paced egress lost packets: {len(arrivals)}/128"
        spread = arrivals[-1] - arrivals[0]
        assert spread >= 0.02, f"burst not spread: {spread * 1000:.1f} ms"
        assert transport._pace_pending is not None
        pub.close()
        for ss in subs:
            ss.close()
    finally:
        transport.transport.close()
        await rt.stop()


async def test_leaky_bucket_pacer_defers_and_drains_fifo():
    """rtc.pacer=leaky-bucket: per-(room, sub) byte budgets gate the batch
    egress; over-budget packets defer and drain FIFO on later ticks."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    transport.pacer_mode = "leaky-bucket"
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc = transport.assign_ssrc(room=0, track=0, is_video=False)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        base = transport.stats["rx"]
        for i in range(4):
            pub.sendto(rtp_packet(sn=100 + i, ts=960 * i, ssrc=ssrc, audio_level=20,
                                  payload=b"PAYLOAD" + bytes([i])), (HOST, port))
        await delivered(transport, 4, base)
        res = await rt.step_once()
        assert len(res.egress_batch) == 4
        R, S = DIMS.rooms, DIMS.subs
        allowed = np.zeros((R, S), np.float32)
        allowed[0, 1] = 2.0 * (8 + WIRE_OVERHEAD_BYTES)
        transport.send_egress_batch(res.egress_batch, pacer_allowed=allowed)
        first = await recv(sub, 2)
        assert len(first) == 2, f"admitted {len(first)} (want 2)"
        assert len(transport._pacer_queue) == 2
        assert transport.stats["pacer_deferred"] == 2
        allowed[0, 1] = 1000.0
        transport.send_egress_batch(empty_batch(res.egress_batch), pacer_allowed=allowed)
        second = await recv(sub, 2)
        assert len(second) == 2 and not transport._pacer_queue
        sns = [int.from_bytes(d[2:4], "big") for d in first + second]
        assert sns == sorted(sns), f"FIFO violated: {sns}"
        pub.close()
        sub.close()
    finally:
        transport.transport.close()
        await rt.stop()


async def test_h264_simulcast_switch_on_wire():
    """H264 keyframe detection (NALU types) gates simulcast layer
    switching: the selector locks a new spatial layer only at an IDR."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=True)
        rt.set_subscription(0, 0, 1, subscribed=True)
        rt.set_layer_caps(0, 0, 1, max_spatial=0)
        ssrc0 = transport.assign_ssrc(0, 0, True, layer=0, mime="video/h264")
        ssrc1 = transport.assign_ssrc(0, 0, True, layer=1, mime="video/h264")
        assert int(transport._track_pt[0, 0]) == H264_PT
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        L0, L1 = 100, 220
        sizes = []

        async def tick(sn, idr0=False, idr1=False):
            base = transport.stats["rx"]
            pub.sendto(rtp_packet(sn=sn, ts=90 * sn, ssrc=ssrc0, pt=H264_PT, marker=1,
                                  payload=_h264_payload(idr0, L0 - 1)), (HOST, port))
            pub.sendto(rtp_packet(sn=sn, ts=90 * sn, ssrc=ssrc1, pt=H264_PT, marker=1,
                                  payload=_h264_payload(idr1, L1 - 1)), (HOST, port))
            await delivered(transport, 2, base)
            res = await rt.step_once()
            transport.send_egress_batch(res.egress_batch)
            sizes.extend(len(d) - 12 for d in await recv(sub, len(res.egress_batch)))

        for sn in range(100, 112):
            await tick(sn, idr0=sn % 4 == 0)
        assert sizes and all(s == L0 for s in sizes), sizes
        sizes.clear()
        rt.set_layer_caps(0, 0, 1, max_spatial=1)
        for sn in range(112, 118):
            await tick(sn, idr0=sn % 4 == 0)
        assert sizes and all(s == L0 for s in sizes), sizes
        sizes.clear()
        await tick(118, idr1=True)
        for sn in range(119, 126):
            await tick(sn, idr1=sn % 4 == 0)
        assert L1 in sizes, sizes
        assert sizes[-3:] == [L1] * 3, sizes
        pub.close()
        sub.close()
    finally:
        transport.transport.close()
        await rt.stop()


async def test_vp9_ddless_svc_downswitch_on_wire():
    """Plain VP9 SVC (no dependency descriptor): spatial layers come from
    the VP9 picture header's SID; capping a subscriber sheds layers."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=True, is_svc=True)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc = transport.assign_ssrc(0, 0, True, svc=True, mime="video/vp9")
        assert int(transport._track_pt[0, 0]) == SVC_PT
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        SIZES = {0: 100, 1: 200, 2: 300}
        sizes = []
        sn = 100

        async def tick(keyframe=False):
            nonlocal sn
            ts = 90 * sn
            base = transport.stats["rx"]
            for sid in (0, 1, 2):
                pub.sendto(rtp_packet(
                    sn=sn, ts=ts, ssrc=ssrc, pt=SVC_PT, marker=sid == 2,
                    payload=_vp9_payload(sid=sid, keyframe=keyframe and sid == 0,
                                         pid=sn & 0x7FFF, fill=SIZES[sid] - 5)),
                    (HOST, port))
                sn += 1
            await delivered(transport, 3, base)
            res = await rt.step_once()
            transport.send_egress_batch(res.egress_batch)
            sizes.extend(len(d) - 12 for d in await recv(sub, len(res.egress_batch)))

        await tick(keyframe=True)
        for _ in range(5):
            await tick()
        assert len(set(sizes)) == 3, sizes
        rt.set_layer_caps(0, 0, 1, max_spatial=0)
        for _ in range(8):
            await tick()
        sizes.clear()                 # the transition
        for _ in range(4):
            await tick()
        assert sizes and len(set(sizes)) == 1, sizes
        pub.close()
        sub.close()
    finally:
        transport.transport.close()
        await rt.stop()


async def test_forward_latency_probe_measures_rx_to_wire():
    """Packets fed with an rx stamp yield wire-out observations covering
    queueing + staging + device + send."""
    rt = runtime()
    transport, _port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc = transport.assign_ssrc(room=0, track=0, is_video=False)
        sub = client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        dgrams = [rtp_packet(sn=100 + i, ts=960 * i, ssrc=ssrc, payload=b"x" * 40)
                  for i in range(4)]
        blob = np.frombuffer(b"".join(dgrams), np.uint8)
        lens = np.array([len(d) for d in dgrams], np.int32)
        offs = np.zeros(4, np.int32)
        np.cumsum(lens[:-1], out=offs[1:])
        t0 = time.perf_counter()
        transport.feed_batch(blob, offs, lens, np.full(4, 0x7F000001, np.uint32),
                             np.full(4, 40000, np.uint16), 4, t_rx=t0)
        # The queueing the probe must account for: at least 15 ms.
        await until(lambda: time.perf_counter() - t0 >= 0.015, "15 ms")
        res = await rt.step_once()
        transport.send_egress_batch(res.egress_batch)
        probe = transport.fwd_latency
        assert probe.n == 4
        hi = probe.max_s
        assert hi >= 0.015
        assert hi <= time.perf_counter() - t0
        assert probe.summary()["p99_ms"] >= 15.0
        sub.close()
    finally:
        transport.transport.close()
        await rt.stop()
