"""The port's interop modules against the JAX package's: the same inputs
give the same bytes. STUN requests and responses with fixed transaction
ids (and the same seeded `secrets` for the ICE tie-breaker), SRTP and
SRTCP protection on the same keys and seeded packets across the 16-bit
wrap, `build_answer` on fixed credentials and address, and a DTLS-SRTP
handshake between a port endpoint and a JAX-package endpoint, both ways
round, after which both sides hold the same SRTP keys.
"""

import random

import numpy as np
import pytest

pytest.importorskip("cryptography")

from livekit_server_tpu.interop import dtls as jdtls, sdp as jsdp  # noqa: E402
from livekit_server_tpu.interop import srtp as jsrtp, stun as jstun  # noqa: E402
from livekit_server_tpu_torch.interop import dtls as tdtls, sdp as tsdp  # noqa: E402
from livekit_server_tpu_torch.interop import srtp as tsrtp, stun as tstun  # noqa: E402


class SeededSecrets:
    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def token_bytes(self, n: int) -> bytes:
        return self._rng.randbytes(n)


def test_stun_messages_equal(monkeypatch):
    pwd = b"local-ice-pwd-24-chars-x"
    txn = bytes(range(12))
    attrs = [(jstun.ATTR_USERNAME, b"remote:local"), (jstun.ATTR_PRIORITY, b"\x6e\x00\x01\xff")]
    for key in (None, pwd):
        assert tstun.build_message(tstun.BINDING_REQUEST, txn, attrs, integrity_key=key) == \
            jstun.build_message(jstun.BINDING_REQUEST, txn, attrs, integrity_key=key)
    monkeypatch.setattr(jstun, "secrets", SeededSecrets(3))
    monkeypatch.setattr(tstun, "secrets", SeededSecrets(3))
    for controlling, use_candidate in ((True, True), (True, False), (False, True)):
        a = jstun.build_binding_request("remote:local", pwd, controlling, use_candidate)
        b = tstun.build_binding_request("remote:local", pwd, controlling, use_candidate)
        assert a == b
        jreq, treq = jstun.parse_stun(a, integrity_key=pwd), tstun.parse_stun(b, integrity_key=pwd)
        assert (treq.msg_type, treq.txn_id, treq.username, treq.integrity_ok, treq.fingerprint_ok) \
            == (jreq.msg_type, jreq.txn_id, jreq.username, jreq.integrity_ok, jreq.fingerprint_ok)
        for addr in (("203.0.113.7", 50123), ("2001:db8::1", 43210),
                     ("::ffff:203.0.113.5", 1234), ("fe80::1%eth0", 5), ("2001:db8::2", 9, 0, 0)):
            resp = tstun.build_binding_response(treq, addr, pwd)
            assert resp == jstun.build_binding_response(jreq, addr, pwd), addr
            msg = jstun.parse_stun(resp, integrity_key=pwd)
            assert msg.integrity_ok and msg.fingerprint_ok
    for data in (b"", b"\x80\x60" + b"x" * 30, b"\x16\xfe\xfd" + b"x" * 30):
        assert tstun.is_stun(data) == jstun.is_stun(data)
        assert tstun.parse_stun(data) is None and jstun.parse_stun(data) is None


def test_srtp_protect_equal():
    rng = np.random.default_rng(11)
    mk, ms = rng.bytes(16), rng.bytes(12)
    assert tsrtp.derive_srtp_keys(mk, ms) == jsrtp.derive_srtp_keys(mk, ms)
    ttx, jtx = tsrtp.SrtpSession(master_key=mk, master_salt=ms), jsrtp.SrtpSession(master_key=mk, master_salt=ms)
    trx, jrx = tsrtp.SrtpSession(master_key=mk, master_salt=ms), jsrtp.SrtpSession(master_key=mk, master_salt=ms)
    seq = 0xFF00
    for i in range(600):
        step = int(rng.choice([1, 1, 1, 2, 900, -3]))
        seq = (seq + step) & 0xFFFF
        ssrc = int(rng.choice([0x1234, 0xBEEF0001]))
        payload = rng.bytes(int(rng.integers(1, 200)))
        pkt = bytes([0x80, 96]) + seq.to_bytes(2, "big") + (i * 960).to_bytes(4, "big") \
            + ssrc.to_bytes(4, "big") + payload
        w = ttx.protect_rtp(pkt)
        assert w == jtx.protect_rtp(pkt), i
        assert trx.unprotect_rtp(w) == jrx.unprotect_rtp(w)
        if i % 7 == 0:
            rr = bytes([0x81, 201, 0, 7]) + ssrc.to_bytes(4, "big") + rng.bytes(24)
            w = ttx.protect_rtcp(rr)
            assert w == jtx.protect_rtcp(rr)
            assert jrx.unprotect_rtcp(w) == rr == trx.unprotect_rtcp(w)
    assert ttx._tx == jtx._tx
    assert trx._rx == jrx._rx


OFFERS = [
    # audio + simulcast VP8 send, audio + video recv, a datachannel.
    ("v=0\r\no=- 1 2 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\na=group:BUNDLE 0 1 2 3 4\r\n"
     "a=ice-ufrag:abcd\r\na=ice-pwd:0123456789012345678901\r\n"
     "a=fingerprint:sha-256 AA:BB\r\na=setup:actpass\r\n"
     "m=audio 9 UDP/TLS/RTP/SAVPF 109 63\r\na=mid:0\r\na=sendonly\r\na=rtpmap:109 opus/48000/2\r\n"
     "a=rtpmap:63 red/48000/2\r\na=extmap:1 urn:ietf:params:rtp-hdrext:ssrc-audio-level\r\n"
     "a=ssrc:7 cname:x\r\n"
     "m=video 9 UDP/TLS/RTP/SAVPF 120 121\r\na=mid:1\r\na=sendonly\r\na=rtpmap:120 VP8/90000\r\n"
     "a=rtpmap:121 rtx/90000\r\na=fmtp:121 apt=120\r\na=ssrc-group:SIM 10 11 12\r\n"
     "a=ssrc:10 cname:x\r\na=ssrc:11 cname:x\r\na=ssrc:12 cname:x\r\n"
     "m=audio 9 UDP/TLS/RTP/SAVPF 109\r\na=mid:2\r\na=recvonly\r\na=rtpmap:109 opus/48000/2\r\n"
     "m=video 9 UDP/TLS/RTP/SAVPF 98 45\r\na=mid:3\r\na=recvonly\r\na=rtpmap:98 VP9/90000\r\n"
     "a=rtpmap:45 AV1/90000\r\n"
     "m=application 9 UDP/DTLS/SCTP webrtc-datachannel\r\na=mid:4\r\n"),
    # H.264 sendrecv, session-level credentials only, no mids.
    ("v=0\r\no=- 9 2 IN IP4 10.0.0.1\r\ns=-\r\nt=0 0\r\n"
     "a=ice-ufrag:zz\r\na=ice-pwd:pppppppppppppppppppppppp\r\na=fingerprint:sha-256 01:02\r\n"
     "m=video 9 UDP/TLS/RTP/SAVPF 102\r\na=sendrecv\r\na=rtpmap:102 H264/90000\r\n"
     "a=fmtp:102 profile-level-id=42e01f;packetization-mode=1\r\n"),
]


@pytest.mark.parametrize("offer", OFFERS, ids=["av-simulcast-datachannel", "h264-sendrecv"])
def test_build_answer_equal(offer):
    t, j = tsdp.parse_sdp(offer), jsdp.parse_sdp(offer)
    assert [(m.kind, m.mid, m.direction, m.codecs, m.ssrcs, m.ssrc_groups) for m in t.media] == \
        [(m.kind, m.mid, m.direction, m.codecs, m.ssrcs, m.ssrc_groups) for m in j.media]
    for ssrc_by_mid in (None, {"2": [111111], "3": [222222, 333333]}):
        for addr in (("1.2.3.4", 5), ("127.0.0.1", 7882)):
            args = ("ufrag", "p" * 22, "AB:CD:EF", addr)
            assert tsdp.build_answer(t, *args, ssrc_by_mid=ssrc_by_mid) == \
                jsdp.build_answer(j, *args, ssrc_by_mid=ssrc_by_mid)


def handshake(client, server) -> None:
    """Shuttle datagrams between two in-memory endpoints until both finish."""
    to_server = client.pump()
    for _ in range(20):
        to_client = [d for x in to_server for d in server.feed(x)]
        to_server = [d for x in to_client for d in client.feed(x)]
        if client.handshake_complete and server.handshake_complete and not to_server:
            return
    raise AssertionError("DTLS handshake did not complete")


@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_dtls_cross_package_handshake(server_pkg):
    """A port endpoint against a JAX-package endpoint (each pinning the
    other's certificate fingerprint): both export the same SRTP keys,
    and SRTP built on them opens across the packages."""
    smod, cmod = (tdtls, jdtls) if server_pkg == "port" else (jdtls, tdtls)
    ssrtp, csrtp = (tsrtp, jsrtp) if server_pkg == "port" else (jsrtp, tsrtp)
    scert, skey, sfp = smod.generate_certificate("server")
    ccert, ckey, cfp = cmod.generate_certificate("client")
    server = smod.DtlsEndpoint("server", scert, skey, peer_fingerprint=cfp)
    client = cmod.DtlsEndpoint("client", ccert, ckey, peer_fingerprint=sfp)
    try:
        handshake(client, server)
        (slk, sls), (srk, srs) = server.export_srtp_keys()
        (clk, cls), (crk, crs) = client.export_srtp_keys()
        assert (slk, sls) == (crk, crs) and (srk, srs) == (clk, cls)
        s_tx = ssrtp.SrtpSession(master_key=slk, master_salt=sls)
        c_rx = csrtp.SrtpSession(master_key=crk, master_salt=crs)
        pkt = bytes([0x80, 111, 0, 1, 0, 0, 0, 9, 0, 0, 0x12, 0x34]) + b"opus" * 10
        assert c_rx.unprotect_rtp(s_tx.protect_rtp(pkt)) == pkt
    finally:
        server.close()
        client.close()
