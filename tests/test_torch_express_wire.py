"""The express lane over the UDP wire, in the port and against the JAX
package.

`test_express_udp_wire_end_to_end` ports the reference's case: express
sends leave through the real transport (`_send_express` → the native
`send_express` binding) and reach the subscriber's socket, every SN once
across both tiers.

`test_express_wire_matches_reference` feeds the JAX package's
PlaneRuntime + UDPMediaTransport and the port's (device="cpu"), each
with the lane on (express_max_subs=2), the same seeded, sealed publisher
datagrams over loopback for 24 ticks: VP8 simulcast (two layers, a
keyframe every 8 ticks) and Opus, in rooms of two subscribers (express)
and one of three (batched), with one room pinned to the batched tier for
a few ticks (a demotion and a re-promotion). Every datagram a subscriber
receives, sealed bytes and all, is equal in both packages, in order per
(destination, SSRC); so are the lane's promotions, demotions and
counters and every munger lane. Express and batched sends share one
nonce space per session: no counter repeats on any session. The
transports' `secrets` and clock are seeded and virtual in both packages
(tests/test_torch_udp_parity.py `install`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.runtime import PlaneRuntime as JRuntime  # noqa: E402
from livekit_server_tpu.runtime import crypto as jcrypto  # noqa: E402
from livekit_server_tpu.runtime import udp as judp  # noqa: E402
from livekit_server_tpu_torch import native  # noqa: E402
from livekit_server_tpu_torch.models import plane as tplane  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime as TRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime import crypto as tcrypto  # noqa: E402
from livekit_server_tpu_torch.runtime import udp as tudp  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from tests.test_native import rtp_packet, vp8_payload  # noqa: E402
from tests.test_torch_udp_parity import Clock, install  # noqa: E402
from tests.torch_udp_fixture import HOST, client_socket, delivered, drain, until, udp_transport  # noqa: E402

R, T, K, S = 4, 4, 8, 4
VP8, OPUS = 0, 2
TICKS = 24
TICK_MS = 50
SUBS = {0: 2, 1: 2, 2: 3, 3: 2}     # subscribers per room (room 2: batched)
PIN_TICKS = range(10, 14)          # room 3 pinned to the batched tier


async def test_express_udp_wire_end_to_end():
    """Express sends leave through the transport and arrive at the
    subscriber's socket: every SN exactly once across both tiers, payload
    bytes intact, and the two tiers never overlap."""
    runtime = TRuntime(tplane.PlaneDims(2, 4, 8, 4), tick_ms=10, express_max_subs=2,
                       egress_shards=1, device="cpu")
    transport, _port = await udp_transport(runtime)
    sub = client_socket()
    try:
        assert native.egress is not None and native._express_smoke(native.egress) is None
        transport.attach_egress_plane(runtime.egress_plane)
        transport.attach_express(runtime.express)
        runtime.set_track(0, 0, published=True, is_video=False)
        runtime.set_subscription(0, 0, 1, subscribed=True)
        transport.assign_ssrc(room=0, track=0, is_video=False)
        transport.register_subscriber(0, 1, sub.getsockname())
        batched_sns = []
        for i in range(6):
            runtime.ingest.push(PacketIn(room=0, track=0, sn=600 + i, ts=960 * i,
                                         size=10, payload=b"opus" + bytes([i])))
            res = await runtime.step_once()
            batched_sns.extend(p.sn for p in res.egress if not p.padding)
            transport.send_egress(res.egress)
        got = []
        await until(lambda: got.extend(drain(sub)) or len(got) >= 6, "6 datagrams")
        assert runtime.express.active[0]
        assert runtime.express.stats["express_dgrams"] >= 4
        sns = []
        for data in got:
            out = native.rtp.parse_batch(data, np.asarray([0], np.int32),
                                         np.asarray([len(data)], np.int32))[0]
            sn = int(out["sn"])
            sns.append(sn)
            off, ln = int(out["payload_off"]), int(out["payload_len"])
            assert data[off:off + ln] == b"opus" + bytes([sn - 600])
        assert sorted(sns) == [600 + i for i in range(6)]
        assert len(batched_sns) + runtime.express.stats["express_dgrams"] == 6
        assert runtime.egress_plane.stats["express_datagrams"] == \
            runtime.express.stats["express_dgrams"]
    finally:
        sub.close()
        transport.transport.close()


class Node:
    """One package's runtime + transport with the express lane on, its
    sessions and client sockets."""

    def __init__(self, runtime_cls, dims, udp_mod, crypto_mod, **kw):
        self.rt = runtime_cls(dims, tick_ms=TICK_MS, egress_shards=1,
                              express_max_subs=2, **kw)
        self.udp_mod, self.crypto_mod = udp_mod, crypto_mod
        self.reg = crypto_mod.MediaCryptoRegistry()

    async def start(self):
        u = self.udp_mod
        self.udp = await u.start_udp_transport(
            self.rt.ingest, HOST, 0, crypto=self.reg, require_encryption=True,
            nack_resolver=self.rt.resolve_nacks)
        self.port = self.udp.transport.get_extra_info("sockname")[1]
        self.udp.attach_egress_plane(self.rt.egress_plane)
        self.udp.attach_express(self.rt.express)
        self.pub_sock = client_socket()
        self.sub_socks, self.pub, self.ssrc, self.sub = {}, {}, {}, {}
        for r in range(R):
            for t, video in ((VP8, True), (OPUS, False)):
                self.rt.set_track(r, t, published=True, is_video=video)
                sess = self.reg.mint()
                self.pub[(r, t)] = self.crypto_mod.MediaCryptoClient(sess.key_id, sess.key)
                for layer in ((0, 1) if video else (0,)):
                    self.ssrc[(r, t, layer)] = self.udp.assign_ssrc(
                        r, t, video, layer=layer, session=sess)
            for s in range(SUBS[r]):
                for t in (VP8, OPUS):
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

    async def publish(self, tick: int) -> None:
        rng = np.random.default_rng(tick)
        u = self.udp_mod
        base = self.udp.stats["rx"]
        n = 0
        kf = tick % 8 == 0
        for r in range(R):
            frames = []
            for layer in (0, 1):
                frames.append((VP8, rtp_packet(
                    sn=1000 * layer + tick, ts=3000 * tick,
                    ssrc=self.ssrc[(r, VP8, layer)], pt=96, marker=1,
                    payload=vp8_payload(pid=100 * layer + tick, tl0=tick & 0xFF,
                                        tid=tick % 2, keyidx=tick % 32, keyframe=kf)
                    + rng.integers(0, 256, 40 + 60 * layer, dtype=np.uint8).tobytes())))
            frames.append((OPUS, rtp_packet(
                sn=500 + tick, ts=960 * tick, ssrc=self.ssrc[(r, OPUS, 0)],
                pt=u.OPUS_PT, audio_level=20 + r,
                payload=rng.integers(0, 256, 30, dtype=np.uint8).tobytes())))
            for t, d in frames:
                self.pub_sock.sendto(self.pub[(r, t)].seal(d), (HOST, self.port))
                n += 1
        await delivered(self.udp, n, base)

    async def step(self, tick: int) -> None:
        self.rt.set_express_pin(3, False if tick in PIN_TICKS else None)
        res = await self.rt.step_once()
        self.udp.send_egress_batch(
            res.egress_batch, red_plan=(res.red_sn, res.red_off, res.red_ok),
            layer_caps=(self.rt.ctrl.max_spatial, self.rt.ctrl.max_temporal),
            pacer_allowed=res.pacer_allowed)
        if res.padding:
            self.udp.send_egress(res.padding, rtx=True)

    def collect(self, out: dict) -> None:
        """Every media datagram on the subscriber sockets, sealed, →
        out[(dest, ssrc)] as (sealed, opened)."""
        for (r, s), sock in self.sub_socks.items():
            for f in drain(sock, media_only=False):
                d = self.sub[(r, s)].open(f)
                assert d is not None, "a sealed datagram did not open (nonce reused?)"
                if d[:8] == self.udp_mod.PUNCH_ACK or 192 <= d[1] <= 223:
                    continue
                out.setdefault(((r, s), int.from_bytes(d[8:12], "big")), []).append((f, d))

    def close(self) -> None:
        self.udp.transport.close()
        for sock in (self.pub_sock, *self.sub_socks.values()):
            sock.close()


async def test_express_wire_matches_reference(monkeypatch):
    clock = Clock()
    install(monkeypatch, judp, jcrypto, clock)
    ref = Node(JRuntime, jplane.PlaneDims(R, T, K, S), judp, jcrypto)
    await ref.start()
    install(monkeypatch, tudp, tcrypto, clock)
    port = Node(TRuntime, tplane.PlaneDims(R, T, K, S), tudp, tcrypto, device="cpu")
    await port.start()
    assert ref.ssrc == port.ssrc
    got = {"ref": {}, "port": {}}
    active = {"ref": [], "port": []}
    try:
        for tick in range(TICKS):
            clock.ms = float(tick * TICK_MS)
            for name, node in (("ref", ref), ("port", port)):
                await node.publish(tick)
                await node.step(tick)
                active[name].append(np.asarray(node.rt.express.active).copy())
            await until(lambda: ref.udp.stats["tx"] == port.udp.stats["tx"], "equal tx")
            for name, node in (("ref", ref), ("port", port)):
                node.collect(got[name])
        assert got["port"].keys() == got["ref"].keys()
        for key, frames in got["ref"].items():
            assert got["port"][key] == frames, f"datagrams to {key} differ"
        for a, b in zip(active["ref"], active["port"]):
            assert np.array_equal(a, b)
        jx, tx = ref.rt.express, port.rt.express
        assert {k: int(v) for k, v in jx.stats.items()} == tx.stats
        for name in ("cur_sp", "cur_tp", "tgt_sp", "tgt_tp", "words", "express_subs"):
            assert np.array_equal(getattr(jx, name), getattr(tx, name)), name
        for name in port.rt.munger.FIELDS:
            assert np.array_equal(getattr(ref.rt.munger, name),
                                  getattr(port.rt.munger, name)), name
        # What the run must have exercised.
        assert tx.stats["promotes"] >= 4 and tx.stats["demotes"] >= 1
        assert tx.stats["express_dgrams"] > 0 and tx.stats["takeover_pkts"] >= 0
        assert not any(a[2] for a in active["port"]), "a 3-subscriber room promoted"
        assert all(not a[3] for a in active["port"][PIN_TICKS[0]:PIN_TICKS[-1]])
        assert active["port"][-1][[0, 1, 3]].all()
        assert port.udp.stats["tx"] > tx.stats["express_dgrams"] > 0
        assert port.udp.fwd_latency_express.n == ref.udp.fwd_latency_express.n > 0
        # One nonce space per session across both tiers.
        counters: dict = {}
        for frames in got["port"].values():
            for sealed, _ in frames:
                key = tcrypto.parse_key_id(sealed)
                ctr = sealed[6:14]
                assert ctr not in counters.setdefault(key, set()), "nonce reused"
                counters[key].add(ctr)
    finally:
        ref.close()
        port.close()
        await ref.rt.stop()
        await port.rt.stop()
