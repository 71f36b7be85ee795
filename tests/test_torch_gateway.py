"""The port's standards-lane WebRTC gateway end to end: the cases of the
reference's tests/test_gateway.py that drive live sockets, on
PlaneRuntime(device="cpu") and the port's UDPMediaTransport.

The client (tests/torch_gateway_fixture.py) is an independent
standard-wire endpoint: its own certificate, ICE credentials, the OpenSSL
DTLS client role and RFC 7714 SRTP. It speaks only STUN, DTLS, SRTP and
SDP at the server's real UDP socket, as a stock WebRTC stack would.
Transports bind port 0 and every wait polls up to a deadline.
"""

import asyncio
import secrets
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.interop import sdp, stun  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.protocol import models as pm  # noqa: E402
from livekit_server_tpu_torch.protocol.signal import SignalRequest, decode_signal_response  # noqa: E402
from livekit_server_tpu_torch.routing.messagechannel import MessageChannel  # noqa: E402
from livekit_server_tpu_torch.rtc import Participant, Room, handle_participant_signal  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.crypto import MediaCryptoRegistry  # noqa: E402
from livekit_server_tpu_torch.runtime.udp import start_udp_transport  # noqa: E402
from tests.test_native import vp8_payload  # noqa: E402
from tests.torch_gateway_fixture import StockWireClient, recv_datagram  # noqa: E402
from tests.torch_udp_fixture import until  # noqa: E402

DIMS = plane.PlaneDims(rooms=2, tracks=3, pkts=8, subs=3)


def runtime():
    return PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu")


async def setup(subscribe=True):
    """The reference's `_setup`: one gateway peer publishing Opus (track 0)
    and VP8 (track 1) in room 0, subscribed as sub 1 when `subscribe`."""
    rt = runtime()
    udp = await start_udp_transport(rt.ingest, host="127.0.0.1", port=0,
                                    crypto=MediaCryptoRegistry())
    gw = udp.enable_gateway()
    rt.set_track(0, 0, published=True, is_video=False)
    rt.set_track(0, 1, published=True, is_video=True)
    udp.set_track_kind(0, 0, False)
    udp.set_track_kind(0, 1, True)
    if subscribe:
        rt.set_subscription(0, 0, 1, subscribed=True)
        rt.set_subscription(0, 1, 1, subscribed=True)
    cli = StockWireClient()
    answer, peer = gw.create_peer(
        cli.offer(),
        publish=[
            {"mid": "0", "room": 0, "track": 0, "mime": "opus"},
            {"mid": "1", "room": 0, "track": 1, "mime": "vp8"},
        ],
        subscribe=(0, 1) if subscribe else None,
    )
    return rt, udp, gw, cli, answer, peer


def drain_sink(sink):
    out = []
    while True:
        try:
            out.append(decode_signal_response(sink._q.get_nowait()))
        except asyncio.QueueEmpty:
            return out


async def test_gateway_end_to_end_media():
    """A standard-wire client joins (STUN→DTLS→SRTP), publishes VP8 +
    Opus, and receives its subscribed media back as SRTP."""
    rt, udp, gw, cli, answer, peer = await setup()
    try:
        await cli.connect(answer)
        assert peer.dtls.handshake_complete
        assert peer.srtp_ready
        assert gw.stats["dtls_done"] == 1
        # A continuous stream (video layer liveness needs an ongoing
        # keyframe-bearing flow); PTs from the answer (opus 111, vp8 96).
        vp8 = vp8_payload(keyframe=True) + b"\x42" * 40
        got_video = got_audio = False
        deadline = time.monotonic() + 30
        i = 0
        while not (got_video and got_audio):
            assert time.monotonic() < deadline, f"no egress; udp={udp.stats} gw={gw.stats}"
            cli.send_rtp(cli.video_ssrc, 96, 100 + i, 3000 * i, vp8, marker=True)
            cli.send_rtp(cli.audio_ssrc, 111, 200 + i, 960 * i, b"\x51" * 30)
            i += 1
            await asyncio.sleep(0.02)
            res = await rt.step_once()
            udp.send_egress_batch(res.egress_batch)
            try:
                while True:
                    kind, clear = await cli.recv_media(timeout=0.2)
                    if kind != "rtp":
                        continue
                    pt = clear[1] & 0x7F
                    ssrc = int.from_bytes(clear[8:12], "big")
                    if pt == 96:
                        got_video = True
                        assert ssrc == udp.subscriber_ssrc(0, 1, 1)
                        assert clear.endswith(b"\x42" * 40)
                    elif pt == 111:
                        got_audio = True
                        assert ssrc == udp.subscriber_ssrc(0, 1, 0)
                        assert clear.endswith(b"\x51" * 30)
            except TimeoutError:
                pass
        assert gw.stats["srtp_rx"] >= 4
        assert gw.stats["srtp_tx"] >= 2
    finally:
        cli.close()
        udp.transport.close()
        await rt.stop()


async def test_gateway_rtcp_both_directions():
    """Client SRTCP reaches the server RTCP handler; server PLI reaches
    the client as SRTCP."""
    rt, udp, gw, cli, answer, peer = await setup()
    try:
        await cli.connect(answer)
        base = udp.stats["rtcp_rx"]
        cli.send_rtcp(bytes([0x80, 201, 0, 1]) + (0xCAFE).to_bytes(4, "big"))
        await until(lambda: udp.stats["rtcp_rx"] > base, f"the receiver report, gw={gw.stats}")
        assert gw.stats["srtcp_rx"] >= 1
        # One video packet so the track's SSRC latches an address.
        base = gw.stats["srtp_rx"]
        cli.send_rtp(cli.video_ssrc, 96, 500, 9000, vp8_payload(keyframe=True) + b"k" * 20)
        await until(lambda: gw.stats["srtp_rx"] > base, "the video packet")
        await rt.step_once()
        # Server → client: the PLI arrives SRTCP-protected.
        udp.send_pli(0, 1)
        kind, clear = await cli.recv_media()
        while kind != "rtcp" or clear[1] != 206:
            kind, clear = await cli.recv_media()
        assert clear[1] == 206 and (clear[0] & 0x1F) == 1  # PSFB PLI
        assert int.from_bytes(clear[8:12], "big") == cli.video_ssrc
    finally:
        cli.close()
        udp.transport.close()
        await rt.stop()


async def test_gateway_rejects_bad_stun_and_unknown_srtp():
    """Unauthenticated STUN gets no answer; SRTP from an unlatched
    address is dropped."""
    rt, udp, gw, cli, answer, peer = await setup(subscribe=False)
    try:
        ans = sdp.parse_sdp(answer)
        srv_ufrag = ans.media_ufrag(ans.media[0])
        server_addr = cli.server_address(answer)
        req = stun.build_binding_request(f"{srv_ufrag}:{cli.ufrag}", b"wrong-password-000000")
        cli.sock.sendto(req, server_addr)
        with pytest.raises(TimeoutError):
            await recv_datagram(cli.sock, timeout=0.5)
        await until(lambda: gw.stats["stun_bad"] > 0, "the bad STUN count")
        # An SRTP-looking packet from an unlatched address never reaches
        # the gateway lane: it dies as an unknown SSRC or a parse error.
        before_rx = gw.stats["srtp_rx"]
        before = udp.stats["unknown_ssrc"] + udp.stats["parse_errors"]
        cli.sock.sendto(b"\x80\x60" + bytes(10) + secrets.token_bytes(60), server_addr)
        await until(lambda: udp.stats["unknown_ssrc"] + udp.stats["parse_errors"] > before,
                    "the unknown-SSRC drop")
        assert gw.stats["srtp_rx"] == before_rx
    finally:
        cli.close()
        udp.transport.close()
        await rt.stop()


async def test_signal_offer_negotiates_gateway():
    """The signal plane's 'offer' arm: a real SDP offer creates a gateway
    peer, binds pending and auto tracks, defers the subscriber lane to
    the handshake and answers ICE-lite; a re-offer reuses the tracks;
    leave tears it all down."""
    rt = runtime()
    udp = await start_udp_transport(rt.ingest, host="127.0.0.1", port=0,
                                    crypto=MediaCryptoRegistry())
    try:
        room = Room("gw", rt)
        room.udp = udp
        cli = StockWireClient()
        sink = MessageChannel(size=500)
        p = Participant("webrtc-user", room, response_sink=sink)
        room.join(p)
        # Announce ONE track (audio); the video section auto-publishes.
        handle_participant_signal(room, p, SignalRequest(
            "add_track", {"cid": "mic", "type": 0, "name": "mic"}))
        handle_participant_signal(room, p, SignalRequest("offer", {"sdp": cli.offer()}))
        answers = [m for m in drain_sink(sink) if m.kind == "answer"]
        assert len(answers) == 1
        ans_text = answers[0].data["sdp"]
        assert "a=ice-lite" in ans_text
        ans = sdp.parse_sdp(ans_text)
        assert ans.media[0].codecs == {111: "opus"}
        assert ans.media[1].codecs == {96: "vp8"}
        peer = p.gateway_peer
        assert peer is not None
        assert {s for s, *_ in peer.publish} == {cli.audio_ssrc, cli.video_ssrc}
        assert cli.audio_ssrc in udp.bindings
        assert udp.bindings[cli.video_ssrc].is_video
        assert not p.pending_tracks
        assert len(p.published) == 2
        # The subscriber lane waits for DTLS.
        assert peer.sub == (room.slots.row, p.sub_col)
        assert (room.slots.row, p.sub_col) not in udp.sub_addrs
        # Renegotiation replaces the association and reuses the tracks.
        handle_participant_signal(room, p, SignalRequest("offer", {"sdp": cli.offer()}))
        peer2 = p.gateway_peer
        assert peer2 is not None and peer2 is not peer
        assert peer.ufrag not in udp.gateway.peers_by_ufrag
        assert len(p.published) == 2
        assert {s for s, *_ in peer2.publish} == {cli.audio_ssrc, cli.video_ssrc}
        room.remove_participant(p, pm.DisconnectReason.CLIENT_INITIATED)
        assert cli.audio_ssrc not in udp.bindings
        assert not udp.gateway.peers_by_ufrag
        cli.close()
    finally:
        udp.transport.close()
        await rt.stop()


async def test_gateway_traffic_survives_require_encryption_batch_path():
    """require_encryption drops cleartext, but STUN/DTLS/SRTP carry their
    own crypto and reach the gateway through the batch receive path
    (feed_batch), as on the per-datagram path."""
    rt = runtime()
    udp = await start_udp_transport(rt.ingest, host="127.0.0.1", port=0,
                                    crypto=MediaCryptoRegistry(), require_encryption=True)
    gw = udp.enable_gateway()
    try:
        cli = StockWireClient()
        answer, peer = gw.create_peer(cli.offer())
        ans = sdp.parse_sdp(answer)
        srv_ufrag, srv_pwd = ans.media_ufrag(ans.media[0]), ans.media_pwd(ans.media[0])
        req = stun.build_binding_request(f"{srv_ufrag}:{cli.ufrag}", srv_pwd.encode())
        udp.feed_batch(np.frombuffer(req, np.uint8), np.zeros(1, np.int64),
                       np.array([len(req)], np.int32), np.array([0x7F000001], np.uint32),
                       np.array([54321], np.uint16), 1)
        assert gw.stats["stun_rx"] == 1
        assert peer.addr_code != 0  # latched through the batch path
        rtp_like = b"\x80\x60" + bytes(50)
        before = udp.stats["plaintext_drop"]
        udp.feed_batch(np.frombuffer(rtp_like, np.uint8), np.zeros(1, np.int64),
                       np.array([len(rtp_like)], np.int32), np.array([0x7F000001], np.uint32),
                       np.array([54322], np.uint16), 1)
        assert udp.stats["plaintext_drop"] == before + 1
        cli.close()
    finally:
        udp.transport.close()
        await rt.stop()
