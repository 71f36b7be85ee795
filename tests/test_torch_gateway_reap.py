"""The port's gateway answers and its handshake TTL: the two SDP answer
cases of the reference's tests/test_gateway.py (:395, :417) and its
three gateway cases of tests/test_egress_plane.py (:332-415): the reap
logic on stub peers, an abandoned handshake reaped after
PEER_HANDSHAKE_TTL_S, an established peer never reaped.
"""

import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.interop import sdp  # noqa: E402
from livekit_server_tpu_torch.runtime import webrtc_gateway  # noqa: E402
from livekit_server_tpu_torch.runtime.webrtc_gateway import (  # noqa: E402
    PEER_HANDSHAKE_TTL_S,
    GatewayPeer,
    WebRtcGateway,
)
from tests.test_torch_gateway import setup  # noqa: E402

ICE = ("a=ice-ufrag:abcd\r\na=ice-pwd:0123456789012345678901\r\n"
       "a=fingerprint:sha-256 AA:BB\r\na=setup:actpass\r\n")


def test_answer_rejects_datachannel_and_bundles_accepted_only():
    """A browser offer's m=application (datachannel) is rejected with
    port 0 and kept out of the BUNDLE group (JSEP forbids bundling
    rejected sections)."""
    offer_text = (
        "v=0\r\no=- 1 2 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\n"
        "a=group:BUNDLE 0 1\r\n" + ICE
        + "m=audio 9 UDP/TLS/RTP/SAVPF 109\r\na=mid:0\r\na=sendonly\r\n"
        "a=rtpmap:109 opus/48000/2\r\na=ssrc:7 cname:x\r\n"
        "m=application 9 UDP/DTLS/SCTP webrtc-datachannel\r\na=mid:1\r\n"
    )
    ans_text = sdp.build_answer(sdp.parse_sdp(offer_text), "u", "p" * 22, "AB:CD", ("1.2.3.4", 5))
    bundle = [ln for ln in ans_text.split("\r\n") if ln.startswith("a=group:BUNDLE")][0]
    assert bundle == "a=group:BUNDLE 0"
    assert "m=application 0 " in ans_text


def test_answer_places_egress_ssrcs_in_matching_sections():
    """a=ssrc declarations live inside their kind's recv m-section."""
    offer_text = (
        "v=0\r\no=- 1 2 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\n" + ICE
        + "m=audio 9 UDP/TLS/RTP/SAVPF 109\r\na=mid:0\r\na=recvonly\r\n"
        "a=rtpmap:109 opus/48000/2\r\n"
        "m=video 9 UDP/TLS/RTP/SAVPF 120\r\na=mid:1\r\na=recvonly\r\n"
        "a=rtpmap:120 VP8/90000\r\n"
    )
    ans_text = sdp.build_answer(sdp.parse_sdp(offer_text), "u", "p" * 22, "AB:CD", ("1.2.3.4", 5),
                                ssrc_by_mid={"0": [111111], "1": [222222]})
    audio_part = ans_text.split("m=audio")[1].split("m=video")[0]
    video_part = ans_text.split("m=video")[1]
    assert "a=ssrc:111111" in audio_part and "a=ssrc:222222" not in audio_part
    assert "a=ssrc:222222" in video_part and "a=ssrc:111111" not in video_part


def test_gateway_reap_unit():
    """The TTL reap without a handshake: an aged handshake-incomplete
    peer is torn down by service_timers, an established one never is."""

    class StubTransport:
        crypto = None

        def release_subscriber(self, *a):
            pass

        def release_ssrc(self, *a):
            pass

    gw = object.__new__(WebRtcGateway)
    gw.transport = StubTransport()
    gw.peers_by_ufrag, gw.peers_by_addr, gw.peers_by_tuple = {}, {}, {}
    gw.stats = {}

    def mk_peer(ufrag, established):
        p = object.__new__(GatewayPeer)
        p.gateway, p.ufrag, p.pwd = gw, ufrag, "pw"
        p.dtls = None
        p.srtp_tx = object() if established else None
        p.srtp_rx = p.srtp_tx
        p.addr, p.addr_code = None, 0
        p.publish, p.sub, p.sub_registered = [], None, False
        p.pin_session = None
        p.created_s = time.monotonic()
        p._last_timer = 0.0
        gw.peers_by_ufrag[ufrag] = p
        return p

    fresh = mk_peer("fresh", established=False)
    stale = mk_peer("stale", established=False)
    done = mk_peer("done", established=True)
    stale.created_s -= PEER_HANDSHAKE_TTL_S + 1
    done.created_s -= PEER_HANDSHAKE_TTL_S * 10
    gw.service_timers()
    assert "fresh" in gw.peers_by_ufrag
    assert "stale" not in gw.peers_by_ufrag
    assert "done" in gw.peers_by_ufrag
    assert gw.stats["peers_reaped"] == 1
    assert fresh is gw.peers_by_ufrag["fresh"]


async def test_gateway_reaps_abandoned_handshakes():
    """A peer that got its answer but never completed DTLS gives back its
    ufrag, DTLS endpoint and minted crypto session after the TTL."""
    rt, udp, gw, cli, answer, peer = await setup(subscribe=True)
    try:
        assert peer.ufrag in gw.peers_by_ufrag
        assert not peer.srtp_ready
        gw.service_timers()
        assert peer.ufrag in gw.peers_by_ufrag
        peer.created_s = time.monotonic() - (webrtc_gateway.PEER_HANDSHAKE_TTL_S + 1.0)
        gw.service_timers()
        assert peer.ufrag not in gw.peers_by_ufrag
        assert gw.stats["peers_reaped"] == 1
        assert peer.pin_session is not None
        assert peer.pin_session.key_id not in udp.crypto.sessions
    finally:
        cli.close()
        udp.transport.close()
        await rt.stop()


async def test_gateway_never_reaps_established_peers():
    """Established SRTP peers belong to the signalling plane: the TTL
    covers only the handshake window."""
    rt, udp, gw, cli, answer, peer = await setup(subscribe=True)
    try:
        await cli.connect(answer)
        assert peer.srtp_ready
        peer.created_s = time.monotonic() - webrtc_gateway.PEER_HANDSHAKE_TTL_S * 10
        gw.service_timers()
        assert peer.ufrag in gw.peers_by_ufrag
        assert gw.stats.get("peers_reaped", 0) == 0
    finally:
        cli.close()
        udp.transport.close()
        await rt.stop()
