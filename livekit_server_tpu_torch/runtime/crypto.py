"""Authenticated media-wire encryption: AEAD frames + replay protection.

Reference parity: the reference's media plane rides DTLS-SRTP — keys are
negotiated per peer connection and every RTP/RTCP packet is encrypted and
authenticated (pkg/rtc/transport.go:167 PCTransport's DTLS role,
pion/srtp underneath). This build replaces the DTLS handshake with keys
minted server-side and delivered over the ALREADY-authenticated signal
channel (the JWT-gated WebSocket — the trust anchor the reference's
token validation provides), and SRTP with an explicit-nonce AEAD frame:

    frame = 0x01 | key_id(4) | dir(1) | counter(8) | AESGCM(ct+tag)
      nonce = dir(1) | counter(8) | zeros(3)        (12 bytes)
      aad   = frame[:14]                            (header is bound)

The leading 0x01 byte cannot collide with RTP/RTCP (version bits force
byte0 >= 0x80) or the punch magic ('L'), so plaintext and sealed frames
demux on one socket. Counters are per-direction and strictly increasing;
the receiver keeps a sliding bitmap window (RFC 4303-style) so replayed
or duplicated frames authenticate but are rejected. One session per
participant: direction separation lives in the nonce, so a captured
server→client frame can never be replayed back as client→server.
"""

from __future__ import annotations

import secrets

try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # optional dependency: fall back to libcrypto below
    AESGCM = None

    class InvalidTag(Exception):
        pass


if AESGCM is None:
    # Without the `cryptography` package, drive OpenSSL's EVP interface
    # directly via ctypes (the same libcrypto native/egress.cpp links
    # against, and the EVP_* subset used is stable across 1.1/3). Only if
    # libcrypto itself is missing does the node degrade to cleartext
    # media (RoomManager skips registry creation, join responses omit
    # media_crypto; constructing any session/endpoint raises).
    import ctypes
    import ctypes.util

    def _find_libcrypto():
        for name in (
            ctypes.util.find_library("crypto"),
            "libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so",
        ):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
                lib.EVP_aes_128_gcm.restype = ctypes.c_void_p
                return lib
            except (OSError, AttributeError):
                continue
        return None

    _libcrypto = _find_libcrypto()

    if _libcrypto is not None:
        _libcrypto.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
        _libcrypto.EVP_CIPHER_CTX_free.argtypes = [ctypes.c_void_p]
        for _f in ("EVP_EncryptInit_ex", "EVP_DecryptInit_ex"):
            getattr(_libcrypto, _f).argtypes = [ctypes.c_void_p] * 5
            getattr(_libcrypto, _f).restype = ctypes.c_int
        for _f in ("EVP_EncryptUpdate", "EVP_DecryptUpdate"):
            getattr(_libcrypto, _f).argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int,
            ]
            getattr(_libcrypto, _f).restype = ctypes.c_int
        for _f in ("EVP_EncryptFinal_ex", "EVP_DecryptFinal_ex"):
            getattr(_libcrypto, _f).argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ]
            getattr(_libcrypto, _f).restype = ctypes.c_int
        _libcrypto.EVP_CIPHER_CTX_ctrl.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        _libcrypto.EVP_CIPHER_CTX_ctrl.restype = ctypes.c_int
        _EVP_CTRL_GCM_SET_TAG = 0x11
        _EVP_CTRL_GCM_GET_TAG = 0x10

        class AESGCM:  # type: ignore[no-redef]
            """API-compatible stand-in for cryptography's AESGCM
            (16-byte keys / 12-byte nonces, the only shapes used here)."""

            def __init__(self, key: bytes):
                if len(key) != 16:
                    raise ValueError("AES-128-GCM needs a 16-byte key")
                self._key = bytes(key)

            def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
                lc = _libcrypto
                ctx = lc.EVP_CIPHER_CTX_new()
                try:
                    lc.EVP_EncryptInit_ex(
                        ctx, lc.EVP_aes_128_gcm(), None, self._key, nonce
                    )
                    outl = ctypes.c_int(0)
                    if aad:
                        lc.EVP_EncryptUpdate(
                            ctx, None, ctypes.byref(outl), aad, len(aad)
                        )
                    ct = ctypes.create_string_buffer(len(data) or 1)
                    lc.EVP_EncryptUpdate(
                        ctx, ct, ctypes.byref(outl), data, len(data)
                    )
                    fin = ctypes.create_string_buffer(16)
                    lc.EVP_EncryptFinal_ex(ctx, fin, ctypes.byref(outl))
                    tag = ctypes.create_string_buffer(16)
                    lc.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_GET_TAG, 16, tag)
                    return ct.raw[: len(data)] + tag.raw
                finally:
                    lc.EVP_CIPHER_CTX_free(ctx)

            def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
                if len(data) < 16:
                    raise InvalidTag("short frame")
                lc = _libcrypto
                ct, tag = data[:-16], data[-16:]
                ctx = lc.EVP_CIPHER_CTX_new()
                try:
                    lc.EVP_DecryptInit_ex(
                        ctx, lc.EVP_aes_128_gcm(), None, self._key, nonce
                    )
                    outl = ctypes.c_int(0)
                    if aad:
                        lc.EVP_DecryptUpdate(
                            ctx, None, ctypes.byref(outl), aad, len(aad)
                        )
                    pt = ctypes.create_string_buffer(len(ct) or 1)
                    lc.EVP_DecryptUpdate(
                        ctx, pt, ctypes.byref(outl), ct, len(ct)
                    )
                    lc.EVP_CIPHER_CTX_ctrl(
                        ctx, _EVP_CTRL_GCM_SET_TAG, 16,
                        ctypes.create_string_buffer(tag, 16),
                    )
                    fin = ctypes.create_string_buffer(16)
                    ok = lc.EVP_DecryptFinal_ex(ctx, fin, ctypes.byref(outl))
                    if ok != 1:
                        raise InvalidTag("GCM tag mismatch")
                    return pt.raw[: len(ct)]
                finally:
                    lc.EVP_CIPHER_CTX_free(ctx)


HAVE_AEAD = AESGCM is not None

MAGIC = 0x01
DIR_C2S = 0
DIR_S2C = 1
HEADER_LEN = 14          # magic + key_id(4) + dir(1) + counter(8)
REPLAY_WINDOW = 1024
ALGO = "aes-128-gcm"


def _seal(aead: AESGCM, key_id: int, direction: int, counter: int, pt: bytes) -> bytes:
    header = (
        bytes([MAGIC])
        + key_id.to_bytes(4, "big")
        + bytes([direction])
        + counter.to_bytes(8, "big")
    )
    nonce = bytes([direction]) + counter.to_bytes(8, "big") + b"\x00\x00\x00"
    return header + aead.encrypt(nonce, pt, header)


def parse_key_id(frame: bytes) -> int | None:
    if len(frame) < HEADER_LEN + 16 or frame[0] != MAGIC:
        return None
    return int.from_bytes(frame[1:5], "big")


def parse_counter(frame: bytes) -> int | None:
    """Sealed frame → its 64-bit counter (the plaintext header field).
    Clients use it as the transport-wide sequence number when building
    TWCC feedback (runtime/udp.py build_twcc_feedback)."""
    if len(frame) < HEADER_LEN + 16 or frame[0] != MAGIC:
        return None
    return int.from_bytes(frame[6:14], "big")


class _Replay:
    """Sliding-window anti-replay (RFC 4303 §3.4.3 bitmap)."""

    def __init__(self) -> None:
        self.hi = -1
        self.mask = 0

    def check(self, ctr: int) -> bool:
        if ctr > self.hi:
            shift = ctr - self.hi
            # Bound the shift BEFORE computing it: counters are attacker-
            # chosen (only authenticated), and `mask << 2**60` would try to
            # allocate an exabyte-scale int from one 30-byte datagram.
            if shift >= REPLAY_WINDOW:
                self.mask = 1
            else:
                self.mask = ((self.mask << shift) | 1) & ((1 << REPLAY_WINDOW) - 1)
            self.hi = ctr
            return True
        off = self.hi - ctr
        if off >= REPLAY_WINDOW:
            return False
        bit = 1 << off
        if self.mask & bit:
            return False
        self.mask |= bit
        return True


class _Endpoint:
    """One side of a session: seals in `tx_dir`, opens frames in the
    opposite direction with authentication + replay rejection."""

    def __init__(self, key_id: int, key: bytes, tx_dir: int) -> None:
        if AESGCM is None:
            raise RuntimeError("media crypto requires the 'cryptography' package")
        self.key_id = key_id
        self.key = key
        self.aead = AESGCM(key)
        self.tx_dir = tx_dir
        self.rx_dir = 1 - tx_dir
        self.tx_counter = 0
        self._ctr_bind: tuple | None = None  # (array, index) when bound
        self.replay = _Replay()

    def next_counter(self) -> int:
        """Allocate one tx counter. A GCM nonce must NEVER repeat under a
        key, so every sealing path (per-frame control traffic here, the
        native bulk egress via its counter-array binding) allocates from
        ONE source."""
        if self._ctr_bind is not None:
            arr, i = self._ctr_bind
            v = int(arr[i])
            arr[i] = v + 1
            return v
        ctr = self.tx_counter
        self.tx_counter += 1
        return ctr

    def cur_counter(self) -> int:
        if self._ctr_bind is not None:
            arr, i = self._ctr_bind
            return int(arr[i])
        return self.tx_counter

    def bind_counter(self, arr, idx: int) -> None:
        """Move the tx counter into a shared numpy array slot (the batch
        egress allocates counter blocks vectorized from it)."""
        arr[idx] = self.cur_counter()
        self._ctr_bind = (arr, idx)

    def seal(self, plaintext: bytes) -> bytes:
        ctr = self.next_counter()
        return _seal(self.aead, self.key_id, self.tx_dir, ctr, plaintext)

    def open(self, frame: bytes) -> bytes | None:
        """frame → inner datagram; None on any tamper/replay/direction
        failure (callers count, never raise — the socket is hostile)."""
        if len(frame) < HEADER_LEN + 16 or frame[0] != MAGIC:
            return None
        if frame[5] != self.rx_dir:
            return None  # reflected frame (our own direction)
        ctr = int.from_bytes(frame[6:14], "big")
        nonce = frame[5:14] + b"\x00\x00\x00"
        try:
            pt = self.aead.decrypt(nonce, frame[HEADER_LEN:], frame[:HEADER_LEN])
        except InvalidTag:
            return None
        if not self.replay.check(ctr):
            return None
        return pt


class MediaCryptoSession(_Endpoint):
    """Server side: seals server→client, opens client→server. Carries the
    participant's media coordinates so transports can route by key alone."""

    def __init__(self, key_id: int, key: bytes) -> None:
        super().__init__(key_id, key, tx_dir=DIR_S2C)
        self.room = -1
        self.sub = -1
        # Opportunistic-mode latch: set once the client sends any frame
        # that opens under this key — from then on egress to it is sealed
        # even when the node allows cleartext (require_encryption=False).
        self.client_active = False


class MediaCryptoClient(_Endpoint):
    """Client side (SDKs / tests): the mirror image of the session."""

    def __init__(self, key_id: int, key: bytes) -> None:
        super().__init__(key_id, key, tx_dir=DIR_C2S)


class MediaCryptoRegistry:
    """key_id → session for every connected participant on this node."""

    def __init__(self) -> None:
        self.sessions: dict[int, MediaCryptoSession] = {}

    def mint(self) -> MediaCryptoSession:
        while True:
            key_id = secrets.randbits(32)
            if key_id and key_id not in self.sessions:
                break
        s = MediaCryptoSession(key_id, secrets.token_bytes(16))
        self.sessions[key_id] = s
        return s

    def get(self, key_id: int) -> MediaCryptoSession | None:
        return self.sessions.get(key_id)

    def remove(self, key_id: int) -> None:
        self.sessions.pop(key_id, None)
