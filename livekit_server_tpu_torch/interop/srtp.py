"""SRTP/SRTCP with AEAD_AES_128_GCM (RFC 3711 framework, RFC 7714 AEAD).

Reference parity: the reference's media packets ride pion/srtp contexts
created from the DTLS-SRTP exporter (pkg/rtc/transport.go DTLS role →
srtp.Config). This is the same protection profile WebRTC negotiates by
default (SRTP_AEAD_AES_128_GCM, profile 0x0007).

Implements:
  * RFC 3711 §4.3 key derivation (AES-CM PRF) for the AEAD profile's
    key/salt lengths (RFC 7714 §5.1: 16-byte key, 12-byte salt).
  * RFC 7714 §8/§9 RTP+RTCP IV construction, AAD, encrypt/decrypt.
  * ROC (rollover counter) estimation per RFC 3711 §3.3.1 and a 64-bit
    replay window for inbound streams.

Validated against the RFC 7714 §16/§17 test vectors
(tests/test_interop_srtp.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

PROFILE_AEAD_AES_128_GCM = 0x0007
KEY_LEN = 16
SALT_LEN = 12
TAG_LEN = 16

LABEL_RTP_KEY = 0x00
LABEL_RTP_SALT = 0x02
LABEL_RTCP_KEY = 0x03
LABEL_RTCP_SALT = 0x05


def _aes_cm_derive(master_key: bytes, master_salt: bytes, label: int,
                   out_len: int) -> bytes:
    """RFC 3711 §4.3.1/§4.3.3 key derivation (kdr = 0)."""
    x = bytearray(master_salt + b"\x00\x00")        # salt is 112-bit aligned
    x[7] ^= label
    enc = Cipher(algorithms.AES(master_key), modes.ECB()).encryptor()
    out = b""
    block = 0
    while len(out) < out_len:
        ctr = bytes(x[:14]) + block.to_bytes(2, "big")
        out += enc.update(ctr)
        block += 1
    return out[:out_len]


def derive_srtp_keys(master_key: bytes, master_salt: bytes):
    """master (from the DTLS-SRTP exporter) → (rtp_key, rtp_salt,
    rtcp_key, rtcp_salt)."""
    return (
        _aes_cm_derive(master_key, master_salt, LABEL_RTP_KEY, KEY_LEN),
        _aes_cm_derive(master_key, master_salt, LABEL_RTP_SALT, SALT_LEN),
        _aes_cm_derive(master_key, master_salt, LABEL_RTCP_KEY, KEY_LEN),
        _aes_cm_derive(master_key, master_salt, LABEL_RTCP_SALT, SALT_LEN),
    )


def _estimate_roc(roc: int, s_l: int, seq: int) -> int:
    """RFC 3711 §3.3.1 ROC estimate, SIGNED (caller masks for the IV).

    Run on BOTH sides: the receiver to guess an inbound packet's ROC, and
    the sender on its own stream — protecting each packet under exactly
    the value a standard receiver will guess is the only choice that
    keeps the two in lockstep for every SN pattern (wraps with arbitrary
    gaps, cross-wrap RTX, app-level jumps)."""
    if s_l < 32768:
        return roc - 1 if seq - s_l > 32768 else roc
    return roc + 1 if s_l - seq > 32768 else roc


def _replay_accept(cur: int, window: int, started: bool, idx: int):
    """64-bit sliding replay window (RFC 3711 §3.3.2) over a monotone
    packet index — shared by the SRTP ((roc<<16)|seq) and SRTCP (31-bit
    index) paths. Returns (accepted, new_highest, new_window)."""
    if not started:
        return True, idx, 1
    if idx > cur:
        shift = idx - cur
        return True, idx, ((window << min(shift, 64)) | 1) & ((1 << 64) - 1)
    off = cur - idx
    if off >= 64 or (window >> off) & 1:
        return False, cur, window
    return True, cur, window | (1 << off)


def _rtp_iv(salt: bytes, ssrc: int, roc: int, seq: int) -> bytes:
    """RFC 7714 §8.1: 12-byte IV = (0²‖ssrc‖roc‖seq) XOR salt."""
    raw = (
        b"\x00\x00"
        + ssrc.to_bytes(4, "big")
        + roc.to_bytes(4, "big")
        + seq.to_bytes(2, "big")
    )
    return bytes(a ^ b for a, b in zip(raw, salt))


def _rtcp_iv(salt: bytes, ssrc: int, index: int) -> bytes:
    """RFC 7714 §9.1: IV = (0²‖ssrc‖0²‖0‖31-bit index) XOR salt."""
    raw = (
        b"\x00\x00"
        + ssrc.to_bytes(4, "big")
        + b"\x00\x00"
        + index.to_bytes(4, "big")
    )
    return bytes(a ^ b for a, b in zip(raw, salt))


@dataclass
class SrtpSession:
    """One direction's SRTP+SRTCP protection contexts."""

    master_key: bytes
    master_salt: bytes
    rtp_key: bytes = b""
    rtp_salt: bytes = b""
    rtcp_key: bytes = b""
    rtcp_salt: bytes = b""
    # Outbound state
    rtcp_index: int = 0
    # Inbound per-SSRC ROC/replay state: ssrc → [roc, highest_seq, window]
    _rx: dict = field(default_factory=dict)
    # Outbound per-SSRC ROC: ssrc → [roc, highest_seq, started] — st[1]
    # must stay the HIGHEST SN of the current ROC era (backward/RTX steps
    # leave it untouched), or the wrap detection desyncs.
    _tx: dict = field(default_factory=dict)
    # Inbound SRTCP replay state (RFC 3711 §3.3.2): ssrc →
    # [highest_index, window, started]
    _rx_rtcp: dict = field(default_factory=dict)

    def __post_init__(self):
        (self.rtp_key, self.rtp_salt, self.rtcp_key, self.rtcp_salt) = (
            derive_srtp_keys(self.master_key, self.master_salt)
        )
        self._rtp_aead = AESGCM(self.rtp_key)
        self._rtcp_aead = AESGCM(self.rtcp_key)

    # -- RTP --------------------------------------------------------------
    def protect_rtp(self, packet: bytes, roc: int | None = None) -> bytes:
        """Clear RTP → SRTP. ROC tracks per-SSRC automatically; pass an
        explicit roc for vector tests."""
        hdr_len = self._rtp_header_len(packet)
        seq = int.from_bytes(packet[2:4], "big")
        ssrc = int.from_bytes(packet[8:12], "big")
        if roc is None:
            st = self._tx.setdefault(ssrc, [0, seq, False])
            sguess = _estimate_roc(st[0], st[1], seq) if st[2] else st[0]
            roc = sguess & 0xFFFFFFFF
            # Advance exactly like the receiver does (signed index so a
            # roc-1 guess at roc=0 can't masquerade as a huge step).
            if not st[2] or ((sguess << 16) | seq) > ((st[0] << 16) | st[1]):
                st[0], st[1] = roc, seq
            st[2] = True
        iv = _rtp_iv(self.rtp_salt, ssrc, roc, seq)
        ct = self._rtp_aead.encrypt(iv, packet[hdr_len:], packet[:hdr_len])
        return packet[:hdr_len] + ct

    def unprotect_rtp(self, packet: bytes, roc: int | None = None) -> bytes | None:
        """SRTP → clear RTP, or None (bad tag / replay). ROC estimation
        per RFC 3711 §3.3.1; 64-bit replay window."""
        if len(packet) < 12 + TAG_LEN:
            return None
        hdr_len = self._rtp_header_len(packet)
        seq = int.from_bytes(packet[2:4], "big")
        ssrc = int.from_bytes(packet[8:12], "big")
        if roc is not None:
            sguess = roc
            st = None
        else:
            st = self._rx.setdefault(ssrc, [0, seq, 0, False])
            sguess = _estimate_roc(st[0], st[1], seq) if st[3] else st[0]
        iv = _rtp_iv(self.rtp_salt, ssrc, sguess & 0xFFFFFFFF, seq)
        try:
            pt = self._rtp_aead.decrypt(iv, packet[hdr_len:], packet[:hdr_len])
        except Exception:  # InvalidTag
            return None
        if st is not None:
            # Signed index: a roc-1 guess at roc=0 goes negative and is
            # (correctly) rejected as too old, instead of wrapping into an
            # astronomically-large index that would corrupt the state.
            idx = (sguess << 16) | seq
            cur = (st[0] << 16) | st[1]
            ok, new_cur, st[2] = _replay_accept(cur, st[2], st[3], idx)
            if not ok:
                return None  # replay
            st[0], st[1], st[3] = new_cur >> 16, new_cur & 0xFFFF, True
        return packet[:hdr_len] + pt

    @staticmethod
    def _rtp_header_len(packet: bytes) -> int:
        cc = packet[0] & 0x0F
        n = 12 + 4 * cc
        if packet[0] & 0x10 and len(packet) >= n + 4:  # extension
            ext_words = int.from_bytes(packet[n + 2 : n + 4], "big")
            n += 4 + 4 * ext_words
        return n

    # -- RTCP -------------------------------------------------------------
    def protect_rtcp(self, packet: bytes, index: int | None = None) -> bytes:
        """Clear RTCP → SRTCP (E=1). AAD = header ‖ E+index trailer
        (RFC 7714 §9.3)."""
        if index is None:
            self.rtcp_index = (self.rtcp_index + 1) & 0x7FFFFFFF
            index = self.rtcp_index
        ssrc = int.from_bytes(packet[4:8], "big")
        iv = _rtcp_iv(self.rtcp_salt, ssrc, index)
        trailer = ((1 << 31) | index).to_bytes(4, "big")
        aad = packet[:8] + trailer
        ct = self._rtcp_aead.encrypt(iv, packet[8:], aad)
        return packet[:8] + ct + trailer

    def unprotect_rtcp(self, packet: bytes) -> bytes | None:
        if len(packet) < 8 + TAG_LEN + 4:
            return None
        trailer = packet[-4:]
        index = int.from_bytes(trailer, "big") & 0x7FFFFFFF
        if not packet[-4] & 0x80:
            return None  # unencrypted SRTCP not accepted
        ssrc = int.from_bytes(packet[4:8], "big")
        iv = _rtcp_iv(self.rtcp_salt, ssrc, index)
        aad = packet[:8] + trailer
        try:
            pt = self._rtcp_aead.decrypt(iv, packet[8:-4], aad)
        except Exception:
            return None
        # SRTCP replay protection (RFC 3711 §3.3.2): sliding 64-bit window
        # over the 31-bit index, per sender SSRC — checked only after the
        # tag authenticates, so an attacker can't poison the window.
        st = self._rx_rtcp.setdefault(ssrc, [0, 0, False])
        ok, st[0], st[1] = _replay_accept(st[0], st[1], st[2], index)
        if not ok:
            return None  # replayed or too-old index
        st[2] = True
        return packet[:8] + pt
