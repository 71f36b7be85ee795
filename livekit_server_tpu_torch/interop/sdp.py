"""Minimal SDP offer/answer for the WebRTC gateway (RFC 8866 + JSEP).

Reference parity: the reference negotiates SDP through Pion with LiveKit
fixups (pkg/rtc/participant_sdp.go codec/extension munging,
pkg/rtc/mediaengine.go:30-150 registered codecs). This module implements
the subset the ICE-lite gateway needs:

  * parse a browser offer — ICE credentials, DTLS fingerprint + setup
    role, BUNDLE group, per-m-section codecs (rtpmap/fmtp), header
    extensions, SSRCs (incl. simulcast groups), directions;
  * build the answer — ICE-lite, our fingerprint, `a=setup:passive`
    (the offerer is always the DTLS client then), rtcp-mux, one host
    candidate, and OUR canonical payload-type numbers for the codecs
    both sides support (per RFC 3264 the peer sends with the PT map
    from its remote description — i.e. ours — which keeps the wire PTs
    aligned with the fixed demux map in runtime/udp.py).

Header extensions are answered only when the offered id matches the
server's fixed id (runtime/udp.py AUDIO_LEVEL_EXT_ID etc.); mismatched
ids are omitted rather than remapped — the native parser reads fixed
ids, and JSEP permits the answerer to reject any extension.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Canonical codec names → our fixed payload types (runtime/udp.py).
CODEC_PT = {
    "vp8": 96,
    "vp9": 98,
    "av1": 99,
    "h264": 100,
    "opus": 111,
    "red": 63,
}
CLOCK = {"vp8": 90000, "vp9": 90000, "av1": 90000, "h264": 90000,
         "opus": 48000, "red": 48000}
CHANNELS = {"opus": 2, "red": 2}
# Our fixed header-extension ids (must mirror runtime/udp.py).
EXT_IDS = {
    "urn:ietf:params:rtp-hdrext:ssrc-audio-level": 1,
    "http://www.webrtc.org/experiments/rtp-hdrext/playout-delay": 6,
    "https://aomediacodec.org/av1-rtp-spec/#dependency-descriptor": 8,
}


@dataclass
class MediaSection:
    kind: str                      # "audio" | "video" | other (rejected)
    mid: str = ""
    port: int = 9
    codecs: dict = field(default_factory=dict)    # pt -> codec name (lower)
    fmtp: dict = field(default_factory=dict)      # pt -> fmtp line
    extmap: dict = field(default_factory=dict)    # id -> uri
    ssrcs: list = field(default_factory=list)     # declared SSRCs, in order
    ssrc_groups: list = field(default_factory=list)  # (semantics, [ssrc...])
    direction: str = "sendrecv"
    ice_ufrag: str = ""
    ice_pwd: str = ""
    fingerprint: str = ""          # "sha-256 AB:CD:..."
    setup: str = ""
    rtcp_mux: bool = False

    def pts_for(self, name: str) -> list[int]:
        return [pt for pt, c in self.codecs.items() if c == name]


@dataclass
class SessionDesc:
    media: list = field(default_factory=list)
    bundle: list = field(default_factory=list)
    ice_ufrag: str = ""
    ice_pwd: str = ""
    fingerprint: str = ""
    setup: str = ""
    ice_lite: bool = False

    def media_ufrag(self, m: MediaSection) -> str:
        return m.ice_ufrag or self.ice_ufrag

    def media_pwd(self, m: MediaSection) -> str:
        return m.ice_pwd or self.ice_pwd

    def media_fingerprint(self, m: MediaSection) -> str:
        return m.fingerprint or self.fingerprint


def parse_sdp(text: str) -> SessionDesc:
    sess = SessionDesc()
    cur: MediaSection | None = None
    for raw in text.replace("\r\n", "\n").split("\n"):
        line = raw.strip()
        if len(line) < 2 or line[1] != "=":
            continue
        typ, val = line[0], line[2:]
        if typ == "m":
            parts = val.split()
            cur = MediaSection(kind=parts[0])
            try:
                cur.port = int(parts[1])
            except (IndexError, ValueError):
                pass
            sess.media.append(cur)
        elif typ != "a":
            continue
        elif val.startswith("group:BUNDLE"):
            sess.bundle = val.split()[1:]
        elif val == "ice-lite":
            sess.ice_lite = True
        else:
            _parse_attr(sess, cur, val)
    return sess


def _parse_attr(sess: SessionDesc, m: MediaSection | None, val: str) -> None:
    tgt = m if m is not None else sess
    if val.startswith("ice-ufrag:"):
        tgt.ice_ufrag = val[10:]
    elif val.startswith("ice-pwd:"):
        tgt.ice_pwd = val[8:]
    elif val.startswith("fingerprint:"):
        tgt.fingerprint = val[12:]
    elif val.startswith("setup:"):
        tgt.setup = val[6:]
    elif m is None:
        return
    elif val.startswith("mid:"):
        m.mid = val[4:]
    elif val == "rtcp-mux":
        m.rtcp_mux = True
    elif val in ("sendrecv", "sendonly", "recvonly", "inactive"):
        m.direction = val
    elif val.startswith("rtpmap:"):
        try:
            pt_s, spec = val[7:].split(" ", 1)
            m.codecs[int(pt_s)] = spec.split("/")[0].lower()
        except ValueError:
            pass
    elif val.startswith("fmtp:"):
        try:
            pt_s, params = val[5:].split(" ", 1)
            m.fmtp[int(pt_s)] = params
        except ValueError:
            pass
    elif val.startswith("extmap:"):
        try:
            id_s, uri = val[7:].split(" ", 1)
            m.extmap[int(id_s.split("/")[0])] = uri.strip()
        except ValueError:
            pass
    elif val.startswith("ssrc-group:"):
        parts = val[11:].split()
        try:
            m.ssrc_groups.append((parts[0], [int(x) for x in parts[1:]]))
        except ValueError:
            pass
    elif val.startswith("ssrc:"):
        try:
            ssrc = int(val[5:].split()[0])
        except (ValueError, IndexError):
            return
        if ssrc not in m.ssrcs:
            m.ssrcs.append(ssrc)


# -- answer construction ----------------------------------------------------

_FMTP = {
    "opus": "minptime=10;useinbandfec=1",
    "vp9": "profile-id=0",
    "h264": (
        "level-asymmetry-allowed=1;packetization-mode=1;"
        "profile-level-id=42e01f"
    ),
}


def _wanted_codecs(m: MediaSection) -> list[str]:
    offered = set(m.codecs.values())
    if m.kind == "audio":
        return [c for c in ("opus", "red") if c in offered]
    if m.kind == "video":
        return [c for c in ("vp8", "vp9", "av1", "h264") if c in offered]
    return []


def build_answer(
    offer: SessionDesc,
    ice_ufrag: str,
    ice_pwd: str,
    fingerprint: str,
    addr: tuple,
    session_id: int = 1,
    ssrc_by_mid: dict | None = None,
) -> str:
    """ICE-lite answer accepting every audio/video m-section whose codec
    list intersects ours. `fingerprint` is the bare hex-colon digest
    (generate_certificate's third return); addr is the media socket's
    (ip, port). `ssrc_by_mid` declares our egress SSRCs inside their
    send-capable m-sections (mid → [ssrc...])."""
    ip, port = addr[0], addr[1]
    lines = [
        "v=0",
        f"o=- {session_id} 2 IN IP4 {ip}",
        "s=-",
        "t=0 0",
        "a=ice-lite",
        "a=msid-semantic: WMS *",
    ]
    mids = [m.mid or str(i) for i, m in enumerate(offer.media)]
    # JSEP: rejected (port-0) m-sections must NOT appear in the BUNDLE
    # group — browsers fail setRemoteDescription otherwise (a stock offer
    # always carries m=application for the datachannel, which we reject).
    accepted_mids = [
        mids[i] for i, m in enumerate(offer.media) if _wanted_codecs(m)
    ]
    if accepted_mids:
        lines.append("a=group:BUNDLE " + " ".join(accepted_mids))
    for i, m in enumerate(offer.media):
        wanted = _wanted_codecs(m)
        if not wanted:
            # Rejected m-section: port 0, repeat the offered PTs (JSEP).
            pts = " ".join(str(pt) for pt in m.codecs) or "0"
            lines.append(f"m={m.kind} 0 UDP/TLS/RTP/SAVPF {pts}")
            lines.append(f"a=mid:{mids[i]}")
            lines.append("a=inactive")
            continue
        pts = [CODEC_PT[c] for c in wanted]
        lines.append(
            f"m={m.kind} {port} UDP/TLS/RTP/SAVPF "
            + " ".join(str(p) for p in pts)
        )
        lines.append(f"c=IN IP4 {ip}")
        lines.append("a=rtcp-mux")
        lines.append(f"a=mid:{mids[i]}")
        lines.append(f"a=ice-ufrag:{ice_ufrag}")
        lines.append(f"a=ice-pwd:{ice_pwd}")
        lines.append(f"a=fingerprint:sha-256 {fingerprint}")
        lines.append("a=setup:passive")
        if m.direction == "sendonly":
            lines.append("a=recvonly")
        elif m.direction == "recvonly":
            lines.append("a=sendonly")
        else:
            lines.append("a=sendrecv")
        for c in wanted:
            pt = CODEC_PT[c]
            clock = CLOCK[c]
            ch = CHANNELS.get(c)
            spec = f"{c.upper() if c != 'opus' else 'opus'}/{clock}"
            if c == "av1":
                spec = f"AV1/{clock}"
            if ch:
                spec += f"/{ch}"
            lines.append(f"a=rtpmap:{pt} {spec}")
            if c == "red":
                lines.append(f"a=fmtp:{pt} {CODEC_PT['opus']}/{CODEC_PT['opus']}")
            elif c in _FMTP:
                lines.append(f"a=fmtp:{pt} {_FMTP[c]}")
            if c in ("vp8", "vp9", "h264", "av1"):
                lines.append(f"a=rtcp-fb:{pt} nack")
                lines.append(f"a=rtcp-fb:{pt} nack pli")
                lines.append(f"a=rtcp-fb:{pt} goog-remb")
        # Extensions: only ids that already match our fixed map.
        for ext_id, uri in sorted(m.extmap.items()):
            if EXT_IDS.get(uri) == ext_id:
                lines.append(f"a=extmap:{ext_id} {uri}")
        # Our egress SSRCs, declared inside THIS section (receivers map
        # streams per m-section; a global append would misattribute them).
        for ssrc in (ssrc_by_mid or {}).get(mids[i], []):
            lines.append(f"a=ssrc:{ssrc} cname:tpu-sfu")
        lines.append(
            f"a=candidate:1 1 udp 2130706431 {ip} {port} typ host"
        )
        lines.append("a=end-of-candidates")
    return "\r\n".join(lines) + "\r\n"
