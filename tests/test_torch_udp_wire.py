"""The port's UDP media transport on the codec wire (livekit_server_tpu_torch
runtime.udp / dd / egress_plane on PlaneRuntime(device="cpu")): the
reference's tests/test_svc_dd_wire.py (AV1/VP9-SVC dependency-descriptor
forwarding and active-mask rewrite, a cold structure cache) and
tests/test_red_playout.py (RED encapsulation per subscriber, RED
publisher decapsulation, the playout-delay extension), and the sharded
egress plane's determinism end to end: one egress shard against four,
the same datagrams byte for byte.

Transports bind port 0; every wait polls a condition up to a deadline
(tests/torch_udp_fixture.py), where the reference tests wait with fixed
sleeps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch import native  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime, dd  # noqa: E402
from livekit_server_tpu_torch.runtime.udp import (  # noqa: E402
    DD_EXT_ID,
    OPUS_PT,
    PLAYOUT_DELAY_EXT_ID,
    RED_PT,
    build_ext_section,
)
from tests.test_native import rtp_packet, vp8_payload  # noqa: E402
from tests.test_red_playout import parse_red  # noqa: E402
from tests.torch_udp_fixture import client_socket, recv, send, udp_transport  # noqa: E402

DIMS = plane.PlaneDims(rooms=1, tracks=4, pkts=8, subs=4)


def runtime(dims=DIMS, shards=1):
    return PlaneRuntime(dims, tick_ms=10, egress_shards=shards, device="cpu")


def l1t2_structure():
    # 1 spatial x 2 temporal, 2 decode targets (dt0 = T0, dt1 = T0+T1).
    return dd.Structure(structure_id=0, num_decode_targets=2, templates=[
        dd.Template(spatial=0, temporal=0, dtis=[3, 3], fdiffs=[2]),
        dd.Template(spatial=0, temporal=1, dtis=[0, 3], fdiffs=[1]),
    ])


def av1_packet(sn, ts, ssrc, dd_bytes):
    """RTP with a DD header extension + a fake AV1 payload."""
    ext = build_ext_section([(DD_EXT_ID, dd_bytes)])
    hdr = bytes([0x80 | 0x10, 0x80 | 99]) + sn.to_bytes(2, "big") + ts.to_bytes(4, "big") \
        + ssrc.to_bytes(4, "big")
    return hdr + ext + bytes([0x0A]) + bytes(900)


def parse_dd(d: bytes):
    out = native.rtp.parse_batch(d, np.asarray([0], np.int32), np.asarray([len(d)], np.int32),
                                 dd_ext_id=DD_EXT_ID)[0]
    return int(out["dd_off"]), int(out["dd_len"])


async def test_svc_dd_forwarding_and_mask_rewrite():
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=True, is_svc=True)
        rt.set_subscription(0, 0, 1, subscribed=True)
        rt.set_layer_caps(0, 0, 1, max_spatial=2, max_temporal=0)  # T0 only
        ssrc = transport.assign_ssrc(0, 0, is_video=True, svc=True, mime="video/av1")
        assert (0, 0) in transport._svc_tracks
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        struct = l1t2_structure()
        caps = (rt.ctrl.max_spatial, rt.ctrl.max_temporal)
        got = []
        for i in range(24):
            dd_bytes = dd.build(True, True, template_id=i % 2, frame_number=i,
                                structure=struct if i == 0 else None,
                                active_mask=0b11, mask_bits=2)
            await send(transport, pub, av1_packet(1000 + i, 3000 * i, ssrc, dd_bytes), port)
            res = await rt.step_once()
            transport.send_egress_batch(res.egress_batch, layer_caps=caps)
            got += await recv(sub, len(res.egress_batch))
        assert got, "no SVC packets forwarded"
        assert (0, 0) in transport._dd_structs
        tids = []
        for d in got:
            off, ln = parse_dd(d)
            assert off >= 0, "DD extension missing on egress"
            desc = dd.parse_with_structure(d[off:off + ln], struct)
            tids.append(desc.template_id)
            if desc.active_mask is not None:
                assert desc.active_mask == 0b01, f"mask not restricted: {desc.active_mask:b}"
        assert set(tids) == {0}, f"T1 leaked: {tids}"
        pub.close()
        sub.close()
    finally:
        transport.transport.close()
        await rt.stop()


async def test_cold_cache_custom_dti_dd_forwarded_intact():
    """Structure cache cold (restart mid-stream): a DD carrying custom
    dtis cannot be interpreted, but its bytes still ride the packet."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=True, is_svc=True)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc = transport.assign_ssrc(0, 0, is_video=True, svc=True, mime="video/av1")
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        struct = l1t2_structure()
        got = []
        for i in range(6):
            if i == 0:
                dd_bytes = dd.build(True, True, template_id=0, frame_number=0,
                                    structure=struct, active_mask=0b11, mask_bits=2)
            else:
                dd_bytes = dd.build(True, True, template_id=i % 2, frame_number=i,
                                    custom_dtis=[3, 3], mask_bits=2)
            await send(transport, pub, av1_packet(2000 + i, 3000 * i, ssrc, dd_bytes), port)
            if i == 0:
                transport._dd_structs.clear()   # simulated restart
            res = await rt.step_once()
            transport.send_egress_batch(res.egress_batch)
            got += await recv(sub, len(res.egress_batch))
        assert len(got) >= 2, "no packets forwarded after cache loss"
        assert (0, 0) not in transport._dd_structs
        for d in got[1:]:
            assert parse_dd(d)[0] >= 0, "DD stripped on cold cache"
    finally:
        transport.transport.close()
        await rt.stop()


async def test_red_encapsulation_toggles_per_subscriber():
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)   # RED sub
        rt.set_subscription(0, 0, 2, subscribed=True)   # plain sub
        ssrc = transport.assign_ssrc(0, 0, is_video=False)
        transport.set_sub_red(0, 1, True)
        pub = client_socket()
        socks = {col: client_socket() for col in (1, 2)}
        for col, ss in socks.items():
            transport.register_subscriber(0, col, ss.getsockname())
        payloads = [b"opus-frame-%d" % i for i in range(6)]
        got = {1: [], 2: []}
        for i, pay in enumerate(payloads):
            await send(transport, pub, rtp_packet(sn=100 + i, ts=960 * i, ssrc=ssrc,
                                                  pt=OPUS_PT, audio_level=30, payload=pay),
                       port)
            res = await rt.step_once()
            transport.send_egress_batch(res.egress_batch,
                                        red_plan=(res.red_sn, res.red_off, res.red_ok))
            subs = np.asarray(res.egress_batch.subs)
            for col, ss in socks.items():
                got[col] += await recv(ss, int((subs == col).sum()))
        assert len(got[1]) >= 5 and len(got[2]) >= 5
        for d in got[2]:
            assert d[1] & 0x7F == OPUS_PT
        assert any(p in d for p in payloads for d in got[2])
        saw_redundancy = False
        for d in got[1]:
            assert d[1] & 0x7F == RED_PT
            blocks, prim, prim_pt = parse_red(d[12:])
            assert prim_pt == OPUS_PT
            assert prim in payloads
            for pt, off, blk in blocks:
                assert pt == OPUS_PT and blk in payloads and off > 0
                assert payloads.index(blk) < payloads.index(prim)
                saw_redundancy = True
        assert saw_redundancy, "no RED packet carried a redundancy block"
        pub.close()
        for ss in socks.values():
            ss.close()
    finally:
        transport.transport.close()
        await rt.stop()


async def test_red_publisher_decap():
    """A RED-publishing client's packets are stripped to the primary block
    before staging (redprimaryreceiver.go)."""
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc = transport.assign_ssrc(0, 0, is_video=False)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        prev, prim = b"previous-opus", b"current-opus!"
        red = bytes([0x80 | OPUS_PT, 960 >> 6, ((960 & 0x3F) << 2) | 0,
                     len(prev)]) + bytes([OPUS_PT]) + prev + prim
        got = []
        for i in range(4):
            await send(transport, pub, rtp_packet(sn=300 + i, ts=960 * (i + 1), ssrc=ssrc,
                                                  pt=RED_PT, payload=red), port)
            res = await rt.step_once()
            transport.send_egress_batch(res.egress_batch)
            got += await recv(sub, len(res.egress_batch))
        assert transport.stats.get("red_rx", 0) >= 4
        assert got, "no forwarded packets"
        for d in got:
            assert d[12:] == prim        # primary only; RED shell stripped
        pub.close()
        sub.close()
    finally:
        transport.transport.close()
        await rt.stop()


async def test_playout_delay_extension_on_video_egress():
    rt = runtime()
    transport, port = await udp_transport(rt)
    try:
        transport.playout_delay = (100, 400)  # ms
        rt.set_track(0, 0, published=True, is_video=True)
        rt.set_subscription(0, 0, 1, subscribed=True)
        ssrc = transport.assign_ssrc(0, 0, is_video=True)
        pub, sub = client_socket(), client_socket()
        transport.register_subscriber(0, 1, sub.getsockname())
        got = []
        for i in range(10):
            await send(transport, pub, rtp_packet(
                sn=500 + i, ts=3000 * i, ssrc=ssrc, pt=96,
                payload=vp8_payload(pid=100 + i, tl0=1, tid=0, keyframe=True)), port)
            res = await rt.step_once()
            transport.send_egress_batch(res.egress_batch)
            got += await recv(sub, len(res.egress_batch))
        assert got, "no forwarded video"
        for d in got:
            assert d[0] & 0x10, "X bit missing"
            assert d[12:14] == b"\xbe\xde"
            assert int.from_bytes(d[14:16], "big") == 1
            assert d[16] >> 4 == PLAYOUT_DELAY_EXT_ID
            assert d[16] & 0x0F == 2  # 3-byte value
            val = int.from_bytes(d[17:20], "big")
            assert val >> 12 == 100 // 10 and val & 0xFFF == 400 // 10
        pub.close()
        sub.close()
    finally:
        transport.transport.close()
        await rt.stop()


async def _sharded_run(shards: int, ticks: int = 8) -> list[bytes]:
    """Seeded VP8 + Opus traffic in four rooms through a runtime whose
    egress plane has `shards` shards (munge walk and send), every
    subscriber on one socket; → the media datagrams in arrival order per
    (room, sub, track), SSRCs replaced by those coordinates."""
    dims = plane.PlaneDims(rooms=4, tracks=2, pkts=4, subs=3)
    rt = runtime(dims, shards)
    transport, port = await udp_transport(rt)
    transport.attach_egress_plane(rt.egress_plane)
    rng = np.random.default_rng(3)
    try:
        sub = client_socket()
        ssrcs = {}
        for r in range(dims.rooms):
            for t in range(dims.tracks):
                rt.set_track(r, t, published=True, is_video=t == 0)
                ssrcs[(r, t)] = transport.assign_ssrc(r, t, is_video=t == 0)
                for s in range(dims.subs):
                    rt.set_subscription(r, t, s, subscribed=True)
            for s in range(dims.subs):
                transport.register_subscriber(r, s, sub.getsockname())
        pub = client_socket()
        streams: dict = {}
        for i in range(ticks):
            for (r, t), ssrc in ssrcs.items():
                payload = (vp8_payload(pid=100 + i, tl0=i, tid=0, keyframe=True) if t == 0
                           else rng.integers(0, 256, 40, dtype=np.uint8).tobytes())
                await send(transport, pub, rtp_packet(
                    sn=1000 * r + i, ts=960 * i, ssrc=ssrc, pt=96 if t == 0 else OPUS_PT,
                    payload=payload), port)
            res = await rt.step_once()
            transport.send_egress_batch(res.egress_batch)
            for d in await recv(sub, len(res.egress_batch)):
                key = transport.egress_rev[int.from_bytes(d[8:12], "big")]
                streams.setdefault(key, []).append(d[:8] + d[12:])
        return [b"".join(streams[k]) for k in sorted(streams)]
    finally:
        transport.transport.close()
        await rt.stop()


async def test_egress_plane_shards_are_byte_identical():
    """The sharded egress plane (munge walk and send over four shards)
    puts the same bytes on the wire as one shard: sharding is an
    execution strategy, never semantics."""
    one = await _sharded_run(1)
    four = await _sharded_run(4)
    assert one and sum(map(len, one)) > 0
    assert four == one
