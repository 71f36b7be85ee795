"""The port's WebRTC gateway against the JAX package's.

* A stock client of one package through the other package's gateway, both
  ways round, on the same seeded traffic: a publisher peer (Opus + VP8)
  and a subscriber peer (recv sections) complete STUN and DTLS, and the
  subscriber's SRTP-opened RTP is equal, byte for byte, across the two
  (`secrets` and the transports' clock seeded and virtual in both, as in
  tests/test_torch_udp_parity.py).
* With the express lane on, a gateway subscriber is never taken by it:
  the room goes express for its plain UDP subscriber while the gateway
  subscriber's media keeps riding the batched tier, in both packages.
* Renegotiation through the signal handler reuses the gateway tracks,
  unpublishes the ones a re-offer drops and answers the same SDP (bar
  the fresh ICE credentials) in both packages.
"""

import asyncio
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import livekit_server_tpu.models.plane as jplane  # noqa: E402
import livekit_server_tpu.protocol.models as jpm  # noqa: E402
import livekit_server_tpu.protocol.signal as jsignal  # noqa: E402
import livekit_server_tpu.routing.messagechannel as jchannel  # noqa: E402
import livekit_server_tpu.rtc as jrtc  # noqa: E402
import livekit_server_tpu.runtime as jruntime  # noqa: E402
import livekit_server_tpu_torch.models.plane as tplane  # noqa: E402
import livekit_server_tpu_torch.protocol.models as tpm  # noqa: E402
import livekit_server_tpu_torch.protocol.signal as tsignal  # noqa: E402
import livekit_server_tpu_torch.routing.messagechannel as tchannel  # noqa: E402
import livekit_server_tpu_torch.rtc as trtc  # noqa: E402
import livekit_server_tpu_torch.runtime as truntime  # noqa: E402
from livekit_server_tpu.runtime import crypto as jcrypto, udp as judp  # noqa: E402
from livekit_server_tpu_torch.runtime import crypto as tcrypto, udp as tudp  # noqa: E402
from tests.test_native import vp8_payload  # noqa: E402
from tests.test_torch_udp_parity import Clock, install  # noqa: E402
from tests.torch_gateway_fixture import PORT, StockWireClient, reference  # noqa: E402
from tests.torch_udp_fixture import HOST, client_socket, drain, until  # noqa: E402

PKGS = {
    "reference": dict(plane=jplane, runtime=jruntime, udp=judp, crypto=jcrypto, rtc=jrtc,
                      pm=jpm, signal=jsignal, channel=jchannel),
    "port": dict(plane=tplane, runtime=truntime, udp=tudp, crypto=tcrypto, rtc=trtc,
                 pm=tpm, signal=tsignal, channel=tchannel),
}
R, T, K, S = 2, 3, 8, 3
TICKS = 16
TICK_MS = 20


class GwNode:
    """One package's runtime + transport with its gateway; track 0 Opus,
    track 1 VP8 in room 0, published by a gateway peer."""

    def __init__(self, pkg: str, **kw):
        m = self.m = PKGS[pkg]
        extra = {} if pkg == "reference" else {"device": "cpu"}
        self.rt = m["runtime"].PlaneRuntime(m["plane"].PlaneDims(R, T, K, S), tick_ms=TICK_MS,
                                            egress_shards=1, **kw, **extra)

    async def start(self, interop, sub_clients: int = 1):
        m, rt = self.m, self.rt
        self.udp = await m["udp"].start_udp_transport(
            rt.ingest, HOST, 0, crypto=m["crypto"].MediaCryptoRegistry(),
            nack_resolver=rt.resolve_nacks)
        if rt.express is not None:
            self.udp.attach_express(rt.express)
        self.gw = self.udp.enable_gateway()
        for t, video in ((0, False), (1, True)):
            rt.set_track(0, t, published=True, is_video=video)
            self.udp.set_track_kind(0, t, video)
            for s in range(1, 1 + sub_clients):
                rt.set_subscription(0, t, s, subscribed=True)
        self.pub = StockWireClient(interop)
        answer, _ = self.gw.create_peer(self.pub.av_offer(send=True, recv=False), publish=[
            {"mid": "0", "room": 0, "track": 0, "mime": "opus"},
            {"mid": "1", "room": 0, "track": 1, "mime": "vp8"}])
        await self.pub.connect(answer)
        self.subs = []
        for s in range(1, 1 + sub_clients):
            cli = StockWireClient(interop)
            answer, _ = self.gw.create_peer(cli.av_offer(send=False, recv=True), subscribe=(0, s))
            assert "a=ssrc:%d " % self.udp.subscriber_ssrc(0, s, 1) in answer
            await cli.connect(answer)
            self.subs.append(cli)
        assert self.gw.stats["dtls_done"] == 1 + sub_clients

    async def tick(self, tick: int) -> None:
        rng = np.random.default_rng(tick)
        base = self.gw.stats["srtp_rx"]
        self.pub.send_rtp(self.pub.video_ssrc, 96, 60000 + tick, 3000 * tick,
                          vp8_payload(pid=tick, keyframe=tick % 8 == 0)
                          + rng.integers(0, 256, 80, dtype=np.uint8).tobytes())
        self.pub.send_rtp(self.pub.audio_ssrc, 111, 300 + tick, 960 * tick,
                          rng.integers(0, 256, 30, dtype=np.uint8).tobytes())
        await until(lambda: self.gw.stats["srtp_rx"] >= base + 2, "the publisher's SRTP")
        res = await self.rt.step_once()
        self.udp.send_egress_batch(res.egress_batch)

    async def close(self) -> None:
        for cli in (self.pub, *self.subs):
            cli.close()
        self.udp.transport.close()
        await self.rt.stop()


async def test_gateway_media_across_packages(monkeypatch):
    """The JAX package's client through the port's gateway and the port's
    client through the JAX package's gateway: equal opened RTP."""
    clock = Clock()
    install(monkeypatch, judp, jcrypto, clock)
    install(monkeypatch, tudp, tcrypto, clock)
    ref, port = GwNode("reference"), GwNode("port")
    await ref.start(PORT)
    await port.start(reference())
    got = {"ref": [], "port": []}
    try:
        for tick in range(TICKS):
            clock.ms = float(tick * TICK_MS)
            for node in (ref, port):
                await node.tick(tick)
            await until(lambda: ref.gw.stats["srtp_tx"] == port.gw.stats["srtp_tx"], "equal tx")
            for name, node in (("ref", ref), ("port", port)):
                got[name] += [c for k, c in node.subs[0].drain_media() if k == "rtp"]
        assert got["port"] == got["ref"]
        pts = {c[1] & 0x7F for c in got["port"]}
        assert pts == {96, 111} and len(got["port"]) >= TICKS
        for node in (ref, port):
            assert node.gw.stats["srtp_bad"] == 0 and node.gw.stats["stun_bad"] == 0
    finally:
        await ref.close()
        await port.close()


@pytest.mark.parametrize("pkg", ["reference", "port"])
async def test_express_never_takes_gateway_subscriber(pkg):
    """Room 0 has a gateway subscriber (sub 1) and a plain UDP one (sub 2):
    the lane promotes the room and owns sub 2 only, and the gateway
    subscriber gets every tick's media from the batched tier."""
    node = GwNode(pkg, express_max_subs=2)
    await node.start(PORT if pkg == "port" else reference())
    plain = client_socket()
    try:
        node.rt.set_subscription(0, 0, 2, subscribed=True)
        node.rt.set_subscription(0, 1, 2, subscribed=True)
        node.udp.register_subscriber(0, 2, plain.getsockname())
        gw_rtp, plain_n = 0, 0
        for tick in range(TICKS):
            await node.tick(tick)
            await asyncio.sleep(0.005)
            gw_rtp += sum(k == "rtp" for k, _ in node.subs[0].drain_media())
            plain_n += len(drain(plain))
            assert not node.rt.express.express_subs[0, 1]
            assert not node.udp._express_sub_provider()[0, 1]
        ex = node.rt.express
        assert ex.stats["promotes"] >= 1 and ex.express_subs[0, 2]
        assert ex.stats["express_dgrams"] > 0
        assert gw_rtp >= 2 * (TICKS - 4) and plain_n >= 2 * (TICKS - 4)
    finally:
        plain.close()
        await node.close()


def negotiate(pkg: str, offers: list) -> dict:
    """Join one participant, announce a mic, send each offer through the
    signal handler; what each package answers and binds."""
    m = PKGS[pkg]
    state = {}

    async def run():
        extra = {} if pkg == "reference" else {"device": "cpu"}
        rt = m["runtime"].PlaneRuntime(m["plane"].PlaneDims(R, T, K, S), tick_ms=TICK_MS,
                                       egress_shards=1, **extra)
        udp = await m["udp"].start_udp_transport(rt.ingest, HOST, 0,
                                                 crypto=m["crypto"].MediaCryptoRegistry())
        try:
            room = m["rtc"].Room("gw", rt)
            room.udp = udp
            sink = m["channel"].MessageChannel(size=500)
            p = m["rtc"].Participant("webrtc-user", room, response_sink=sink)
            room.join(p)
            req = m["signal"].SignalRequest
            m["rtc"].handle_participant_signal(room, p, req(
                "add_track", {"cid": "mic", "type": 0, "name": "mic"}))
            steps = []
            for offer in offers:
                m["rtc"].handle_participant_signal(room, p, req("offer", {"sdp": offer}))
                answers = []
                while True:
                    try:
                        msg = m["signal"].decode_signal_response(sink._q.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                    if msg.kind == "answer":
                        answers.append(msg.data["sdp"])
                peer = p.gateway_peer
                steps.append({
                    "answer": re.sub(r"a=(ice-ufrag|ice-pwd|fingerprint):.*|udp 2130706431 .*"
                                     r"|m=(audio|video) \d+ ", "", answers[-1]),
                    "cols": sorted((t.track_col, t.is_video, bool(t.via_gateway))
                                   for t in p.published.values()),
                    "peer_publish": sorted(peer.publish),
                    "peers": len(udp.gateway.peers_by_ufrag),
                    "bindings": sorted(udp.bindings),
                })
            room.remove_participant(p, m["pm"].DisconnectReason.CLIENT_INITIATED)
            state["steps"] = steps
            state["after_leave"] = (sorted(udp.bindings), len(udp.gateway.peers_by_ufrag),
                                    len(udp.gateway.peers_by_addr))
        finally:
            udp.transport.close()
            await rt.stop()

    asyncio.run(run())
    return state


def test_renegotiation_reuses_gateway_tracks(monkeypatch):
    install(monkeypatch, judp, jcrypto, Clock())
    install(monkeypatch, tudp, tcrypto, Clock())
    cli = StockWireClient()
    try:
        full = cli.offer()
        audio_only = cli.av_offer(send=True, recv=True).split("m=video")[0].replace(
            "a=group:BUNDLE 0 1 2 3", "a=group:BUNDLE 0")
        offers = [full, full, audio_only]
        ref, port = negotiate("reference", offers), negotiate("port", offers)
    finally:
        cli.close()
    assert port == ref
    first, again, dropped = port["steps"]
    assert "a=ice-lite" in first["answer"]
    assert again["cols"] == first["cols"] and len(first["cols"]) == 2
    assert all(via for _, _, via in first["cols"])
    assert [video for _, video, _ in dropped["cols"]] == [False]
    assert dropped["cols"][0][0] in [c for c, _, _ in first["cols"]]
    assert again["peers"] == dropped["peers"] == 1
    assert port["after_leave"] == ([], 0, 0)
