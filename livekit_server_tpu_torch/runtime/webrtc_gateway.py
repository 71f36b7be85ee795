"""Standard-wire WebRTC gateway: ICE-lite + DTLS-SRTP on the media socket.

Reference parity: this is the seam the reference fills with Pion —
ICE/DTLS/SRTP termination per participant (pkg/rtc/transport.go:253-374)
and SDP negotiation (pkg/rtc/participant_sdp.go, mediaengine.go). The
SFU keeps its sealed bulk lane (runtime/crypto.py) for SDK clients;
this gateway is the STANDARDS lane that lets a stock WebRTC client
(browser / aiortc / Pion) join with no custom code:

    client offer ─→ create_peer() ─→ ICE-lite answer (interop/sdp)
    STUN binding  ─→ handle_datagram() answers + latches the address
    DTLS flight   ─→ handle_datagram() drives interop/dtls (OpenSSL)
    keys exported ─→ interop/srtp sessions (AEAD_AES_128_GCM)
    SRTP media    ─→ unprotected per packet → the SAME vectorized ingest
                     the sealed lane uses (_process_media_arrays)
    egress        ─→ ("srtp", peer) lane in UDPMediaTransport._sendto →
                     protect_rtp/protect_rtcp → wire

Per-packet Python crypto makes this the interop lane, not the bulk lane
(the sealed path's native batch AES-GCM carries the bulk load). The
reference has the same split ambition (Pion per-packet writes); both
lanes stay explicit here.

Port of the JAX package's runtime/webrtc_gateway.py, unchanged apart from
its imports: the gateway runs on the host and reaches the device only
through the transport's ingest and batched egress.
"""

from __future__ import annotations

import secrets
import time

import numpy as np

from livekit_server_tpu_torch.interop import dtls as dtls_mod
from livekit_server_tpu_torch.interop import sdp as sdp_mod
from livekit_server_tpu_torch.interop import stun as stun_mod
from livekit_server_tpu_torch.interop.srtp import SrtpSession

__all__ = ["WebRtcGateway", "GatewayPeer"]

# Handshake retransmit cadence (DTLS timer service).
TIMER_MS = 100.0
# Abandoned-handshake TTL (pion ICE disconnectedTimeout neighborhood): a
# peer created at answer time that never reaches SRTP keys within this
# window is torn down by service_timers.
PEER_HANDSHAKE_TTL_S = 30.0


class GatewayPeer:
    """One remote WebRTC endpoint: ICE creds, DTLS association, SRTP
    sessions, latched address, and its plane coordinates."""

    def __init__(self, gateway: "WebRtcGateway", ufrag: str, pwd: str):
        self.gateway = gateway
        self.ufrag = ufrag                  # our (local) ufrag for this peer
        self.pwd = pwd                      # our ice-pwd (keys STUN integrity)
        self.remote_ufrag = ""
        self.remote_pwd = ""
        self.remote_fingerprint = ""        # "AB:CD:..." from the offer
        self.dtls: dtls_mod.DtlsEndpoint | None = None
        self.srtp_tx: SrtpSession | None = None
        self.srtp_rx: SrtpSession | None = None
        self.addr: tuple | None = None      # latched via authenticated STUN
        self.addr_code: int = 0
        # Plane coordinates.
        self.publish: list[tuple] = []      # (ssrc, room, track, layer)
        self.sub: tuple | None = None       # (room, sub)
        self.sub_registered = False         # egress lane live (post-DTLS)
        # Session-pinning handle for ingest (key_id+1 scode); minted from
        # the transport's crypto registry when present.
        self.pin_session = None
        self.created_s = time.monotonic()
        self._last_timer = 0.0

    @property
    def srtp_ready(self) -> bool:
        return self.srtp_tx is not None

    def scode(self) -> int:
        return (self.pin_session.key_id + 1) if self.pin_session else 0


class WebRtcGateway:
    """Node-level gateway state; owned by UDPMediaTransport."""

    def __init__(self, transport):
        self.transport = transport
        cert, key, fp = dtls_mod.generate_certificate()
        self.cert_pem, self.key_pem, self.fingerprint = cert, key, fp
        self.peers_by_ufrag: dict[str, GatewayPeer] = {}
        self.peers_by_addr: dict[int, GatewayPeer] = {}
        # Tuple-keyed mirror: integer addr codes for IPv6 are synthetic
        # and can be pruned/re-minted, so cold-path lookups (_sendto) key
        # by the address tuple itself.
        self.peers_by_tuple: dict[tuple, GatewayPeer] = {}
        self.stats = {
            "stun_rx": 0, "stun_bad": 0, "dtls_rx": 0, "dtls_done": 0,
            "srtp_rx": 0, "srtp_bad": 0, "srtp_tx": 0, "srtcp_rx": 0,
        }

    # -- signalling-side API ---------------------------------------------

    def create_peer(
        self,
        offer_sdp: str,
        publish: list[dict] | None = None,
        subscribe: tuple | None = None,
        advertise_addr: tuple | None = None,
    ) -> tuple[str, GatewayPeer]:
        """Negotiate one peer. `publish` maps offer media sections to
        plane tracks: [{"mid": "0", "room": r, "track": t, "mime": "vp8",
        "svc": False}] — every a=ssrc in that section binds to the track
        (SIM groups become simulcast layers). `subscribe` = (room, sub)
        registers the peer for egress. Returns (answer_sdp, peer)."""
        offer = sdp_mod.parse_sdp(offer_sdp)
        if not offer.media:
            raise ValueError("offer has no media sections")
        ufrag = secrets.token_urlsafe(4)
        pwd = secrets.token_urlsafe(18)     # ≥22 chars per RFC 8445
        peer = GatewayPeer(self, ufrag, pwd)
        peer.remote_ufrag = offer.ice_ufrag or (
            offer.media and offer.media_ufrag(offer.media[0])
        ) or ""
        peer.remote_pwd = offer.media_pwd(offer.media[0]) if offer.media else ""
        fp = offer.media_fingerprint(offer.media[0])
        if fp.lower().startswith("sha-256 "):
            peer.remote_fingerprint = fp.split(None, 1)[1]
        peer.dtls = dtls_mod.DtlsEndpoint(
            "server", self.cert_pem, self.key_pem,
            peer_fingerprint=peer.remote_fingerprint or None,
        )
        crypto = getattr(self.transport, "crypto", None)
        if crypto is not None:
            peer.pin_session = crypto.mint()

        by_mid = {m.mid: m for m in offer.media}
        for spec in publish or []:
            m = by_mid.get(str(spec.get("mid", "")))
            if m is None:
                continue
            room, track = int(spec["room"]), int(spec["track"])
            mime = spec.get("mime", "vp8" if m.kind == "video" else "opus")
            svc = bool(spec.get("svc", False))
            is_video = m.kind == "video"
            # SIM group = simulcast layers in order; otherwise the
            # declared SSRCs minus RTX partners, layer 0 first.
            sim = next(
                (g[1] for g in m.ssrc_groups if g[0] == "SIM"), None
            )
            rtx_partners = {
                g[1][1] for g in m.ssrc_groups
                if g[0] == "FID" and len(g[1]) == 2
            }
            layers = sim if sim else [
                s for s in m.ssrcs if s not in rtx_partners
            ]
            for layer, ssrc in enumerate(layers):
                if self.transport.bind_client_ssrc(
                    int(ssrc), room, track, is_video, layer=layer,
                    session=peer.pin_session, svc=svc, mime=mime,
                ):
                    peer.publish.append((int(ssrc), room, track, layer))
        if subscribe is not None:
            # Egress registration is DEFERRED until the DTLS handshake
            # completes: overwriting a live (room, sub) address at offer
            # time would black-out a subscriber whose DTLS never happens
            # (keys don't exist yet, so nothing could be sent anyway).
            peer.sub = (int(subscribe[0]), int(subscribe[1]))

        self.peers_by_ufrag[ufrag] = peer
        sock = self.transport.transport.get_extra_info("sockname") if (
            self.transport.transport is not None
        ) else ("127.0.0.1", 0)
        addr = advertise_addr or (sock[0], sock[1])
        # Declare our egress SSRCs inside the matching send-capable
        # (client-recv) m-sections so strict receivers need no
        # unsignalled-SSRC latching: the first recv section of each kind
        # carries that kind's subscriber SSRCs.
        ssrc_by_mid: dict = {}
        if peer.sub is not None:
            by_kind: dict = {"audio": [], "video": []}
            for (rm, tr), kind_is_video in sorted(
                self.transport.track_kind.items()
            ):
                if rm == peer.sub[0]:
                    by_kind["video" if kind_is_video else "audio"].append(
                        self.transport.subscriber_ssrc(rm, peer.sub[1], tr)
                    )
            for m in offer.media:
                if (
                    m.kind in by_kind
                    and m.direction in ("recvonly", "sendrecv")
                    and by_kind[m.kind]
                ):
                    ssrc_by_mid[m.mid] = by_kind.pop(m.kind)
        answer = sdp_mod.build_answer(
            offer, ufrag, pwd, self.fingerprint, addr,
            ssrc_by_mid=ssrc_by_mid,
        )
        return answer, peer

    def close_peer(self, peer: GatewayPeer) -> None:
        self.peers_by_ufrag.pop(peer.ufrag, None)
        if peer.addr_code:
            self.peers_by_addr.pop(peer.addr_code, None)
        if peer.addr is not None:
            self.peers_by_tuple.pop(peer.addr, None)
        if peer.sub is not None and peer.sub_registered:
            self.transport.release_subscriber(*peer.sub)
        for ssrc, *_ in peer.publish:
            self.transport.release_ssrc(ssrc)
        if peer.dtls is not None:
            peer.dtls.close()
        crypto = getattr(self.transport, "crypto", None)
        if crypto is not None and peer.pin_session is not None:
            crypto.remove(peer.pin_session.key_id)

    # -- wire-side demux (called from UDPMediaTransport) ------------------

    def owns_addr(self, addr_code: int) -> bool:
        return addr_code in self.peers_by_addr

    def handle_datagram(self, data: bytes, addr) -> bool:
        """STUN/DTLS demux (RFC 7983 first-byte ranges). Returns True if
        consumed."""
        if stun_mod.is_stun(data):
            self._handle_stun(data, addr)
            return True
        if dtls_mod.is_dtls(data):
            return self._handle_dtls(data, addr)
        return False

    def _handle_stun(self, data: bytes, addr) -> None:
        self.stats["stun_rx"] += 1
        msg = stun_mod.parse_stun(data)
        if msg is None or msg.msg_type != stun_mod.BINDING_REQUEST:
            return
        user = msg.username or ""
        local = user.split(":", 1)[0]
        peer = self.peers_by_ufrag.get(local)
        if peer is None:
            self.stats["stun_bad"] += 1
            return
        # Verify MESSAGE-INTEGRITY under OUR ice-pwd (short-term creds).
        checked = stun_mod.parse_stun(data, integrity_key=peer.pwd.encode())
        if checked is None or checked.integrity_ok is not True:
            self.stats["stun_bad"] += 1
            return
        resp = stun_mod.build_binding_response(
            msg, addr, peer.pwd.encode()
        )
        self._raw_send(resp, addr)
        # Latch/confirm the peer's address (ICE-lite: the first
        # authenticated binding wins; USE-CANDIDATE refreshes are idempotent).
        code = self.transport._addr_code_of(addr)
        if peer.addr_code and peer.addr_code != code:
            self.peers_by_addr.pop(peer.addr_code, None)
        if peer.addr is not None and peer.addr != addr:
            self.peers_by_tuple.pop(peer.addr, None)
        peer.addr = addr
        peer.addr_code = code
        self.peers_by_addr[code] = peer
        self.peers_by_tuple[addr] = peer
        # A re-registered subscriber address: egress flows to the latched
        # address via the ("srtp", ufrag) indirection, nothing to update.

    def _handle_dtls(self, data: bytes, addr) -> bool:
        code = self.transport._addr_code_of(addr)
        peer = self.peers_by_addr.get(code)
        if peer is None or peer.dtls is None:
            return False
        self.stats["dtls_rx"] += 1
        try:
            out = peer.dtls.feed(data)
        except dtls_mod.DtlsError:
            self.stats["stun_bad"] += 1
            return True
        for d in out:
            self._raw_send(d, addr)
        if peer.dtls.handshake_complete and peer.srtp_tx is None:
            (lk, ls), (rk, rs) = peer.dtls.export_srtp_keys()
            peer.srtp_tx = SrtpSession(master_key=lk, master_salt=ls)
            peer.srtp_rx = SrtpSession(master_key=rk, master_salt=rs)
            self.stats["dtls_done"] += 1
            if peer.sub is not None and not peer.sub_registered:
                # Keys exist now — only now may egress routing switch to
                # the SRTP lane.
                peer.sub_registered = True
                self.transport.register_subscriber(
                    *peer.sub, ("srtp", peer.ufrag)
                )
        return True

    def service_timers(self) -> None:
        """DTLS retransmission timers (call ~100 ms cadence) + abandoned
        handshake reaping: a peer that never completes DTLS within
        PEER_HANDSHAKE_TTL_S holds an ufrag slot, a DTLS endpoint, and a
        minted crypto session forever (the signalling side has no
        disconnect to observe for a client that answered the offer and
        vanished) — reap it. Peers with established SRTP are NEVER
        reaped here; their lifetime belongs to the signalling plane."""
        now = time.monotonic()
        for peer in list(self.peers_by_ufrag.values()):
            if (
                peer.dtls is not None
                and not peer.dtls.handshake_complete
                and peer.addr is not None
                and now - peer._last_timer >= TIMER_MS / 1000.0
            ):
                peer._last_timer = now
                for d in peer.dtls.handle_timeout():
                    self._raw_send(d, peer.addr)
            if (
                not peer.srtp_ready
                and now - peer.created_s >= PEER_HANDSHAKE_TTL_S
            ):
                self.stats["peers_reaped"] = (
                    self.stats.get("peers_reaped", 0) + 1
                )
                self.close_peer(peer)

    # -- SRTP media -------------------------------------------------------

    def unprotect_media(
        self, pkts: list
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """[(bytes, addr_code)] SRTP datagrams → staged cleartext arrays
        (blob, offs, lens, addr_codes, scodes) for _process_media_arrays.
        SRTCP is dispatched to the transport's RTCP handler inline."""
        out: list[bytes] = []
        codes: list[int] = []
        scodes: list[int] = []
        for data, code in pkts:
            peer = self.peers_by_addr.get(int(code))
            if peer is None or peer.srtp_rx is None:
                self.stats["srtp_bad"] += 1
                continue
            if len(data) >= 2 and 192 <= data[1] <= 223:
                clear = peer.srtp_rx.unprotect_rtcp(data)
                if clear is None:
                    self.stats["srtp_bad"] += 1
                    continue
                self.stats["srtcp_rx"] += 1
                self.transport._handle_rtcp(clear, peer.addr)
                continue
            clear = peer.srtp_rx.unprotect_rtp(data)
            if clear is None:
                self.stats["srtp_bad"] += 1
                continue
            self.stats["srtp_rx"] += 1
            out.append(clear)
            codes.append(int(code))
            scodes.append(peer.scode())
        if not out:
            z = np.zeros(0, np.int64)
            return np.zeros(0, np.uint8), z, z.astype(np.int32), z, z
        lens = np.array([len(d) for d in out], np.int32)
        offs = np.zeros(len(out), np.int64)
        if len(out) > 1:
            np.cumsum(lens[:-1].astype(np.int64), out=offs[1:])
        blob = np.frombuffer(b"".join(out), np.uint8)
        return (
            blob, offs, lens,
            np.array(codes, np.int64), np.array(scodes, np.int64),
        )

    def protect_and_send(self, data: bytes, peer_key: str) -> None:
        """Egress lane for ("srtp", ufrag) subscriber addresses: SRTP for
        RTP, SRTCP for RTCP, to the peer's latched address."""
        self._send_protected(self.peers_by_ufrag.get(peer_key), data)

    def send_to_peer_addr(self, data: bytes, addr) -> bool:
        """Protect+send data bound for a gateway peer's latched address
        (server-originated RTCP toward publishers). Returns False when the
        address belongs to no peer (caller falls through to cleartext)."""
        peer = self.peers_by_tuple.get(addr)
        if peer is None:
            return False
        self._send_protected(peer, data)
        return True

    def _send_protected(self, peer: GatewayPeer | None, data: bytes) -> None:
        if peer is None or peer.srtp_tx is None or peer.addr is None:
            return
        if len(data) >= 2 and 192 <= data[1] <= 223:
            wire = peer.srtp_tx.protect_rtcp(data)
        else:
            wire = peer.srtp_tx.protect_rtp(data)
        self.stats["srtp_tx"] += 1
        self._raw_send(wire, peer.addr)

    def _raw_send(self, data: bytes, addr) -> None:
        t = self.transport.transport
        if t is not None:
            t.sendto(data, addr)

    def debug_summary(self) -> dict:
        return {
            "peers": len(self.peers_by_ufrag),
            "latched": len(self.peers_by_addr),
            "srtp_ready": sum(
                1 for p in self.peers_by_ufrag.values() if p.srtp_ready
            ),
            **self.stats,
        }
