"""The UDP media wire against the reference: the JAX package's PlaneRuntime
+ UDPMediaTransport and the port's (PlaneRuntime(device="cpu")), fed the
same seeded, sealed publisher datagrams over real loopback sockets for 30
ticks, put the same bytes on the wire: every egress datagram (opened with
its subscriber's key) and every RTCP datagram (sender reports, upstream
NACKs) is equal, in order per (destination, SSRC).

The trace carries a VP8 simulcast track (munged picture ids across a
layer switch), a VP9-SVC track with a dependency descriptor (a capped
subscriber's active mask rewritten), Opus with RED for one subscriber,
retransmissions of subscriber NACKs, and probe padding (a subscriber
whose REMB makes its allocation deficient).

Determinism: SSRCs, punch ids, the node SSRC and session keys come from
`secrets`, and SR timestamps and the transport's millisecond clock from
the wall clock; both packages' modules are given the same seeded
`secrets` and the same virtual clock (the tick index × tick period). Its
own file: one test, after the timing-sensitive reference files.
"""

import asyncio
import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.runtime import PlaneRuntime as JRuntime  # noqa: E402
from livekit_server_tpu.runtime import crypto as jcrypto  # noqa: E402
from livekit_server_tpu.runtime import dd as jdd  # noqa: E402
from livekit_server_tpu.runtime import udp as judp  # noqa: E402
from livekit_server_tpu_torch.models import plane as tplane  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime as TRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime import crypto as tcrypto  # noqa: E402
from livekit_server_tpu_torch.runtime import udp as tudp  # noqa: E402
from tests.test_native import rtp_packet, vp8_payload  # noqa: E402
from tests.torch_udp_fixture import HOST, client_socket, delivered, drain, until  # noqa: E402

R, T, K, S = 4, 4, 8, 4
VP8, SVC, OPUS = 0, 1, 2
TICKS = 30
TICK_MS = 50          # the stats window closes every 20 ticks
REMB_TICK, NACK_TICK, SR_TICK, GAP_TICK = 8, 20, 25, 12


class SeededSecrets:
    """The two `secrets` calls the transports and the key registry make,
    from one seeded generator."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def randbits(self, k: int) -> int:
        return self._rng.getrandbits(k)

    def token_bytes(self, n: int) -> bytes:
        return self._rng.randbytes(n)


class Clock:
    """The transports' millisecond clock and NTP time, virtual."""

    ms = 0.0

    def ntp_now(self) -> int:
        t = 1_800_000_000.0 + self.ms / 1000.0 + 2208988800.0
        return (int(t) << 32) | int((t % 1.0) * (1 << 32))


def install(monkeypatch, udp_mod, crypto_mod, clock: Clock) -> None:
    class LoopTime:
        def __getattr__(self, name):
            return getattr(asyncio.get_running_loop(), name)

        def time(self):
            return clock.ms / 1000.0

    shim = types.SimpleNamespace(**vars(asyncio))
    shim.get_event_loop = LoopTime
    monkeypatch.setattr(udp_mod, "asyncio", shim)
    monkeypatch.setattr(udp_mod, "ntp_now", clock.ntp_now)
    monkeypatch.setattr(udp_mod, "secrets", SeededSecrets(7))
    monkeypatch.setattr(crypto_mod, "secrets", SeededSecrets(8))


def l2t2():
    return [(s, t) for s in range(2) for t in range(2)]


class Node:
    """One package's runtime + transport, its sessions and client sockets."""

    def __init__(self, runtime_cls, dims, udp_mod, crypto_mod, dd_mod, **kw):
        self.rt = runtime_cls(dims, tick_ms=TICK_MS, egress_shards=1, **kw)
        self.udp_mod, self.crypto_mod, self.dd = udp_mod, crypto_mod, dd_mod
        self.reg = crypto_mod.MediaCryptoRegistry()
        self.structure = dd_mod.Structure(
            structure_id=0, num_decode_targets=4,
            templates=[dd_mod.Template(spatial=s, temporal=t,
                                       dtis=[3 if s <= ds and t <= dt else 0
                                             for ds, dt in l2t2()],
                                       fdiffs=[1] if t else [])
                       for s, t in l2t2()])

    async def start(self):
        u = self.udp_mod
        self.udp = await u.start_udp_transport(
            self.rt.ingest, HOST, 0, crypto=self.reg, require_encryption=True,
            nack_resolver=self.rt.resolve_nacks)
        self.port = self.udp.transport.get_extra_info("sockname")[1]
        # The sharded egress plane (one shard), as RoomManager attaches it:
        # one stream's datagrams leave in order.
        self.udp.attach_egress_plane(self.rt.egress_plane)
        self.pub_sock = client_socket()
        self.sub_socks = {}
        self.pub, self.ssrc, self.sub = {}, {}, {}
        for r in range(R):
            for t, video in ((VP8, True), (SVC, True), (OPUS, False)):
                self.rt.set_track(r, t, published=True, is_video=video, is_svc=t == SVC)
                sess = self.reg.mint()
                self.pub[(r, t)] = self.crypto_mod.MediaCryptoClient(sess.key_id, sess.key)
                if t == VP8:
                    self.ssrc[(r, t, 0)] = self.udp.assign_ssrc(r, t, True, layer=0,
                                                                session=sess)
                    self.ssrc[(r, t, 1)] = self.udp.assign_ssrc(r, t, True, layer=1,
                                                                session=sess)
                elif t == SVC:
                    self.ssrc[(r, t, 0)] = self.udp.assign_ssrc(
                        r, t, True, session=sess, svc=True, mime="video/vp9")
                else:
                    self.ssrc[(r, t, 0)] = self.udp.assign_ssrc(r, t, False, session=sess)
            for s in range(S):
                for t in (VP8, SVC, OPUS):
                    self.rt.set_subscription(r, t, s, subscribed=True)
                sess = self.reg.mint()
                self.udp.bind_sub_session(r, s, sess)
                client = self.crypto_mod.MediaCryptoClient(sess.key_id, sess.key)
                self.sub[(r, s)] = client
                sock = self.sub_socks[(r, s)] = client_socket()
                pid = self.udp.assign_subscriber_punch(r, s)
                base = self.udp.stats["rx"]
                sock.sendto(client.seal(u.PUNCH_REQ + pid.to_bytes(4, "big")),
                            (HOST, self.port))
                await delivered(self.udp, 1, base)
            self.rt.set_layer_caps(r, SVC, 1, max_spatial=0, max_temporal=1)
            self.udp.set_sub_red(r, 2, True)

    async def publish(self, tick: int, rng_seed: int) -> None:
        rng = np.random.default_rng(rng_seed)
        u = self.udp_mod
        base = self.udp.stats["rx"]
        n = 0
        kf = tick % 10 == 0
        for r in range(R):
            frames = []
            for layer in (0, 1):
                if tick == GAP_TICK and layer == 0 and r == 0:
                    continue          # lost upstream: the server NACKs it
                sn = 1000 * layer + tick
                frames.append((VP8, layer, rtp_packet(
                    sn=sn, ts=3000 * tick, ssrc=self.ssrc[(r, VP8, layer)], pt=96, marker=1,
                    payload=vp8_payload(pid=100 * layer + tick, tl0=tick & 0xFF,
                                        tid=tick % 2, keyidx=tick % 32, keyframe=kf)
                    + rng.integers(0, 256, 40 + 60 * layer, dtype=np.uint8).tobytes())))
            for i, (sp, tp) in enumerate(((0, tick % 2), (1, tick % 2))):
                desc = self.dd.build(True, True, l2t2().index((sp, tp)), tick,
                                     structure=self.structure if kf and sp == 0 else None,
                                     active_mask=0b1111 if kf and sp == 0 else None,
                                     mask_bits=4)
                ext = u.build_ext_section([(u.DD_EXT_ID, desc)])
                hdr = bytes([0x90, u.SVC_PT | (0x80 if sp == 1 else 0)]) + \
                    (2 * tick + i).to_bytes(2, "big") + (3000 * tick).to_bytes(4, "big") + \
                    self.ssrc[(r, SVC, 0)].to_bytes(4, "big")
                body = bytes([(0 if kf else 0x40) | 0x0C]) + \
                    rng.integers(0, 256, 80 + 40 * sp, dtype=np.uint8).tobytes()
                frames.append((SVC, 0, hdr + ext + body))
            frames.append((OPUS, 0, rtp_packet(
                sn=500 + tick, ts=960 * tick, ssrc=self.ssrc[(r, OPUS, 0)], pt=u.OPUS_PT,
                audio_level=20 + r,
                payload=rng.integers(0, 256, 30, dtype=np.uint8).tobytes())))
            for t, _layer, d in frames:
                self.pub_sock.sendto(self.pub[(r, t)].seal(d), (HOST, self.port))
                n += 1
        await delivered(self.udp, n, base)

    async def feedback(self, tick: int, sent: dict) -> None:
        """Subscriber RTCP of this tick: a REMB that makes room 0's sub 3
        deficient, and NACKs of the last two VP8 packets each sub 0 got."""
        u = self.udp_mod
        frames = []
        if tick >= REMB_TICK:
            media = self.udp.subscriber_ssrc(0, 3, VP8)
            frames.append(((0, 3), u.build_remb(0x5EED, 20_000.0, [media])))
        if tick == NACK_TICK:
            for r in range(R):
                media = self.udp.subscriber_ssrc(r, 0, VP8)
                got = [f for f in sent.get(((r, 0), media), []) if not 192 <= f[1] <= 223]
                sns = [int.from_bytes(f[2:4], "big") for f in got[-2:]]
                if sns:
                    frames.append(((r, 0), u.build_nack(0x5EED, media, sns)))
        for key, d in frames:
            base = self.udp.stats["rx"]
            self.sub_socks[key].sendto(self.sub[key].seal(d), (HOST, self.port))
            await delivered(self.udp, 1, base)

    async def step(self, tick: int) -> None:
        if tick == SR_TICK:
            self.udp._last_sr_ms = -1e9        # one sender-report round
        res = await self.rt.step_once()
        self.udp.send_egress_batch(
            res.egress_batch, red_plan=(res.red_sn, res.red_off, res.red_ok),
            layer_caps=(self.rt.ctrl.max_spatial, self.rt.ctrl.max_temporal),
            pacer_allowed=res.pacer_allowed)
        if res.padding:
            self.udp.send_egress(res.padding, rtx=True)

    def collect(self, out: dict) -> None:
        """Open every datagram on the client sockets → out[(dest, ssrc)]."""
        for (r, s), sock in self.sub_socks.items():
            for f in drain(sock, media_only=False):
                d = self.sub[(r, s)].open(f)
                assert d is not None, "a sealed datagram did not open"
                if d[:8] == self.udp_mod.PUNCH_ACK:
                    continue
                ssrc = int.from_bytes(d[4:8] if 192 <= d[1] <= 223 else d[8:12], "big")
                out.setdefault(((r, s), ssrc), []).append(d)
        for f in drain(self.pub_sock, media_only=False):
            kid = self.crypto_mod.parse_key_id(f)
            client = next(c for c in self.pub.values() if c.key_id == kid)
            d = client.open(f)
            assert d is not None
            out.setdefault(("pub", int.from_bytes(d[8:12], "big")), []).append(d)

    def close(self) -> None:
        self.udp.transport.close()
        for sock in (self.pub_sock, *self.sub_socks.values()):
            sock.close()


async def test_port_udp_wire_matches_reference(monkeypatch):
    clock = Clock()
    install(monkeypatch, judp, jcrypto, clock)
    ref = Node(JRuntime, jplane.PlaneDims(R, T, K, S), judp, jcrypto, jdd)
    await ref.start()
    install(monkeypatch, tudp, tcrypto, clock)
    port = Node(TRuntime, tplane.PlaneDims(R, T, K, S), tudp, tcrypto, __import__(
        "livekit_server_tpu_torch.runtime.dd", fromlist=["dd"]), device="cpu")
    await port.start()
    assert ref.ssrc == port.ssrc and ref.udp.node_ssrc == port.udp.node_ssrc
    got = {"ref": {}, "port": {}}
    try:
        for tick in range(TICKS):
            clock.ms = float(tick * TICK_MS)
            for name, node in (("ref", ref), ("port", port)):
                await node.publish(tick, rng_seed=tick)
                await node.feedback(tick, got[name])
                await node.step(tick)
            # Every egress of the tick is on the loopback sockets now.
            await until(lambda: ref.udp.stats["tx"] == port.udp.stats["tx"], "equal tx")
            for name, node in (("ref", ref), ("port", port)):
                node.collect(got[name])
        assert got["port"].keys() == got["ref"].keys()
        for key, frames in got["ref"].items():
            assert got["port"][key] == frames, f"datagrams to {key} differ"
        frames = [d for v in got["port"].values() for d in v]
        media = [d for d in frames if not 192 <= d[1] <= 223]
        rtcp = [d for d in frames if 192 <= d[1] <= 223]
        # Every feature of the trace is on the wire.
        assert any(d[1] & 0x7F == tudp.RED_PT for d in media), "no RED"
        assert any(d[1] & 0x7F == tudp.SVC_PT and d[0] & 0x10 for d in media), "no DD"
        assert any(d[0] & 0x20 for d in media), "no probe padding"
        assert port.udp.stats["rtx_tx"] > 0, "no retransmission"
        assert any(d[1] == tudp.RTCP_SR for d in rtcp), "no sender report"
        assert any(k[0] == "pub" for k in got["port"]), "no upstream NACK"
        vp8 = [d for d in media if d[1] & 0x7F == 96]
        assert len({d[14] for d in vp8}) > 1, "no munged VP8 picture ids"
    finally:
        ref.close()
        port.close()
        await ref.rt.stop()
        await port.rt.stop()
