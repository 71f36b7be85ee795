"""Shared pieces of the port's WebRTC gateway tests (tests/test_torch_gateway*.py).

`StockWireClient` is the reference's standard-wire endpoint
(tests/test_gateway.py:45): its own certificate, ICE credentials, the
OpenSSL DTLS client role and RFC 7714 SRTP, speaking only STUN, DTLS,
SRTP and SDP at the server's real UDP socket. It is built from one
package's interop modules (`PORT` or `reference()`), so a client of one
package can be held against the other package's gateway.
"""

import asyncio
import secrets
import socket
import time
import types

from livekit_server_tpu_torch.interop import dtls, sdp, srtp, stun

PORT = types.SimpleNamespace(dtls=dtls, sdp=sdp, srtp=srtp, stun=stun)


def reference():
    """The JAX package's interop modules (pure host code, no JAX)."""
    from livekit_server_tpu.interop import dtls as jdtls, sdp as jsdp
    from livekit_server_tpu.interop import srtp as jsrtp, stun as jstun

    return types.SimpleNamespace(dtls=jdtls, sdp=jsdp, srtp=jsrtp, stun=jstun)


async def recv_datagram(sock, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            return sock.recvfrom(65536)
        except BlockingIOError:
            await asyncio.sleep(0.002)
    raise TimeoutError("no datagram")


def rtp(ssrc: int, pt: int, sn: int, ts: int, payload: bytes, marker=True) -> bytes:
    return (bytes([0x80, (0x80 if marker else 0) | pt]) + (sn & 0xFFFF).to_bytes(2, "big")
            + (ts & 0xFFFFFFFF).to_bytes(4, "big") + ssrc.to_bytes(4, "big") + payload)


class StockWireClient:
    """A WebRTC endpoint built purely from RFC wire formats."""

    def __init__(self, interop=PORT, audio_ssrc=0x1111AAAA, video_ssrc=0x2222BBBB,
                 sim_ssrcs=None):
        self.io = interop
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.setblocking(False)
        self.cert, self.key, self.fp = interop.dtls.generate_certificate("client")
        self.ufrag = secrets.token_urlsafe(3)
        self.pwd = secrets.token_urlsafe(18)
        self.audio_ssrc = audio_ssrc
        self.video_ssrc = video_ssrc
        self.sim_ssrcs = sim_ssrcs          # VP8 simulcast layers (a=ssrc-group:SIM)
        self.dtls = None
        self.tx = None          # SrtpSession protecting what we send
        self.rx = None
        self.server_addr = None

    def av_offer(self, send=True, recv=True) -> str:
        """Opus + VP8 send sections (VP8 simulcast when `sim_ssrcs`) and
        audio + video recv sections."""
        mids = [str(i) for i in range((2 if send else 0) + (2 if recv else 0))]
        out = ("v=0\r\no=- 1 2 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\n"
               f"a=group:BUNDLE {' '.join(mids)}\r\n"
               f"a=ice-ufrag:{self.ufrag}\r\na=ice-pwd:{self.pwd}\r\n"
               f"a=fingerprint:sha-256 {self.fp}\r\na=setup:actpass\r\n")
        mid = iter(mids)
        if send:
            out += (f"m=audio 9 UDP/TLS/RTP/SAVPF 109\r\na=mid:{next(mid)}\r\na=sendonly\r\n"
                    "a=rtcp-mux\r\na=rtpmap:109 opus/48000/2\r\n"
                    "a=extmap:1 urn:ietf:params:rtp-hdrext:ssrc-audio-level\r\n"
                    f"a=ssrc:{self.audio_ssrc} cname:cli\r\n"
                    f"m=video 9 UDP/TLS/RTP/SAVPF 120\r\na=mid:{next(mid)}\r\na=sendonly\r\n"
                    "a=rtcp-mux\r\na=rtpmap:120 VP8/90000\r\n")
            if self.sim_ssrcs:
                out += f"a=ssrc-group:SIM {' '.join(map(str, self.sim_ssrcs))}\r\n"
                out += "".join(f"a=ssrc:{s} cname:cli\r\n" for s in self.sim_ssrcs)
            else:
                out += f"a=ssrc:{self.video_ssrc} cname:cli\r\n"
        if recv:
            out += (f"m=audio 9 UDP/TLS/RTP/SAVPF 109\r\na=mid:{next(mid)}\r\na=recvonly\r\n"
                    "a=rtcp-mux\r\na=rtpmap:109 opus/48000/2\r\n"
                    f"m=video 9 UDP/TLS/RTP/SAVPF 120\r\na=mid:{next(mid)}\r\na=recvonly\r\n"
                    "a=rtcp-mux\r\na=rtpmap:120 VP8/90000\r\n")
        return out

    def offer(self) -> str:
        """The reference test's offer: audio + video send, one video recv."""
        return (
            "v=0\r\no=- 1 2 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\n"
            "a=group:BUNDLE 0 1 2\r\n"
            f"a=ice-ufrag:{self.ufrag}\r\na=ice-pwd:{self.pwd}\r\n"
            f"a=fingerprint:sha-256 {self.fp}\r\na=setup:actpass\r\n"
            "m=audio 9 UDP/TLS/RTP/SAVPF 109\r\na=mid:0\r\na=sendonly\r\n"
            "a=rtcp-mux\r\na=rtpmap:109 opus/48000/2\r\n"
            "a=extmap:1 urn:ietf:params:rtp-hdrext:ssrc-audio-level\r\n"
            f"a=ssrc:{self.audio_ssrc} cname:cli\r\n"
            "m=video 9 UDP/TLS/RTP/SAVPF 120\r\na=mid:1\r\na=sendonly\r\n"
            "a=rtcp-mux\r\na=rtpmap:120 VP8/90000\r\n"
            f"a=ssrc:{self.video_ssrc} cname:cli\r\n"
            "m=video 9 UDP/TLS/RTP/SAVPF 120\r\na=mid:2\r\na=recvonly\r\n"
            "a=rtcp-mux\r\na=rtpmap:120 VP8/90000\r\n"
        )

    def server_address(self, answer_sdp: str) -> tuple:
        cand = [ln for ln in answer_sdp.split("\r\n") if ln.startswith("a=candidate:")][0].split()
        return cand[4], int(cand[5])

    async def connect(self, answer_sdp: str):
        """STUN binding → DTLS handshake → SRTP sessions."""
        io = self.io
        ans = io.sdp.parse_sdp(answer_sdp)
        assert ans.ice_lite
        m = ans.media[0]
        srv_ufrag, srv_pwd = ans.media_ufrag(m), ans.media_pwd(m)
        srv_fp = ans.media_fingerprint(m).split(None, 1)[1]
        self.server_addr = self.server_address(answer_sdp)
        # ICE connectivity check: USERNAME = remote:local, MESSAGE-
        # INTEGRITY under the REMOTE (server) pwd — RFC 8445 §7.2.2.
        req = io.stun.build_binding_request(f"{srv_ufrag}:{self.ufrag}", srv_pwd.encode())
        self.sock.sendto(req, self.server_addr)
        data, _ = await recv_datagram(self.sock)
        resp = io.stun.parse_stun(data, integrity_key=srv_pwd.encode())
        assert resp is not None and resp.msg_type == io.stun.BINDING_SUCCESS
        assert resp.integrity_ok and resp.fingerprint_ok is not False
        assert resp.attr(io.stun.ATTR_XOR_MAPPED_ADDRESS) is not None
        self.dtls = io.dtls.DtlsEndpoint("client", self.cert, self.key, peer_fingerprint=srv_fp)
        for d in self.dtls.pump():
            self.sock.sendto(d, self.server_addr)
        t0 = time.monotonic()
        while not self.dtls.handshake_complete:
            assert time.monotonic() - t0 < 10, "DTLS handshake stuck"
            data, _ = await recv_datagram(self.sock)
            if not io.dtls.is_dtls(data):
                continue
            for d in self.dtls.feed(data):
                self.sock.sendto(d, self.server_addr)
        (lk, ls), (rk, rs) = self.dtls.export_srtp_keys()
        self.tx = io.srtp.SrtpSession(master_key=lk, master_salt=ls)
        self.rx = io.srtp.SrtpSession(master_key=rk, master_salt=rs)

    def send_rtp(self, ssrc: int, pt: int, sn: int, ts: int, payload: bytes, marker=True) -> None:
        self.sock.sendto(self.tx.protect_rtp(rtp(ssrc, pt, sn, ts, payload, marker)),
                         self.server_addr)

    def send_rtcp(self, pkt: bytes) -> None:
        self.sock.sendto(self.tx.protect_rtcp(pkt), self.server_addr)

    async def recv_media(self, timeout=5.0):
        """→ (kind, clear_packet): kind 'rtp' or 'rtcp'."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            data, _ = await recv_datagram(self.sock, timeout)
            if len(data) >= 2 and 192 <= data[1] <= 223:
                clear = self.rx.unprotect_rtcp(data)
                if clear is not None:
                    return "rtcp", clear
            else:
                clear = self.rx.unprotect_rtp(data)
                if clear is not None:
                    return "rtp", clear
        raise TimeoutError("no media")

    def drain_media(self) -> list:
        """Every datagram waiting on the socket, opened: [(kind, clear)]."""
        out = []
        while True:
            try:
                data = self.sock.recv(65536)
            except BlockingIOError:
                return out
            if len(data) >= 2 and 192 <= data[1] <= 223:
                clear = self.rx.unprotect_rtcp(data)
                kind = "rtcp"
            else:
                clear = self.rx.unprotect_rtp(data)
                kind = "rtp"
            if clear is not None:
                out.append((kind, clear))

    def close(self):
        if self.dtls is not None:
            self.dtls.close()
        self.sock.close()
