"""STUN for ICE-lite (RFC 5389 wire format, RFC 8445 lite role).

Reference parity: the reference's ICE agent lives in Pion
(pion/ice via pkg/rtc/transport.go); LiveKit servers run full ICE. A
public SFU with a fixed address only *needs* the lite role (RFC 8445
§2.5): answer Binding requests on the media socket, never originate
checks. That is exactly the address-validation capability the sealed
transport's punch provides — this module speaks the standard wire for
stock clients.

Only the attributes ICE uses are implemented: USERNAME,
MESSAGE-INTEGRITY (HMAC-SHA1 over the adjusted header), FINGERPRINT
(CRC-32 ^ 0x5354554e), XOR-MAPPED-ADDRESS, USE-CANDIDATE, PRIORITY,
ICE-CONTROLLING/CONTROLLED, ERROR-CODE. Validated against the RFC 5769
test vectors (tests/test_interop_stun.py).
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import socket
import struct
import zlib
from dataclasses import dataclass, field

MAGIC_COOKIE = 0x2112A442
HEADER_LEN = 20

BINDING_REQUEST = 0x0001
BINDING_SUCCESS = 0x0101
BINDING_ERROR = 0x0111

ATTR_MAPPED_ADDRESS = 0x0001
ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_ERROR_CODE = 0x0009
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A

FINGERPRINT_XOR = 0x5354554E


def is_stun(data: bytes) -> bool:
    """RFC 5764 §5.1.2 demux: first byte 0-3 + magic cookie."""
    return (
        len(data) >= HEADER_LEN
        and data[0] < 4
        and int.from_bytes(data[4:8], "big") == MAGIC_COOKIE
    )


@dataclass
class StunMessage:
    msg_type: int
    txn_id: bytes
    attrs: list[tuple[int, bytes]] = field(default_factory=list)
    # Set by parse_stun when the wire message carried them (verification
    # needs the raw bytes up to each attribute's offset).
    integrity_ok: bool | None = None
    fingerprint_ok: bool | None = None

    def attr(self, typ: int) -> bytes | None:
        for t, v in self.attrs:
            if t == typ:
                return v
        return None

    @property
    def username(self) -> str | None:
        u = self.attr(ATTR_USERNAME)
        return u.decode("utf-8", "replace") if u is not None else None


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def parse_stun(data: bytes, integrity_key: bytes | None = None) -> StunMessage | None:
    """Parse + (optionally) verify MESSAGE-INTEGRITY and FINGERPRINT.

    Integrity per RFC 5389 §15.4: HMAC-SHA1 over the message up to (not
    including) the integrity attribute, with the header's length field
    rewritten to end just after that attribute.
    """
    if not is_stun(data):
        return None
    msg_type, length = struct.unpack("!HH", data[:4])
    if HEADER_LEN + length != len(data) or length % 4:
        return None
    txn_id = data[8:20]
    attrs: list[tuple[int, bytes]] = []
    msg = StunMessage(msg_type, txn_id, attrs)
    off = HEADER_LEN
    while off + 4 <= len(data):
        t, alen = struct.unpack("!HH", data[off : off + 4])
        val = data[off + 4 : off + 4 + alen]
        if len(val) < alen:
            return None
        if t == ATTR_MESSAGE_INTEGRITY and integrity_key is not None:
            adjusted = (
                struct.pack("!HH", msg_type, off + 4 + 20 - HEADER_LEN)
                + data[4:off]
            )
            want = hmac.new(integrity_key, adjusted, hashlib.sha1).digest()
            msg.integrity_ok = hmac.compare_digest(want, val)
        elif t == ATTR_FINGERPRINT:
            crc = zlib.crc32(
                struct.pack("!HH", msg_type, off + 4 + 4 - HEADER_LEN)
                + data[4:off]
            ) ^ FINGERPRINT_XOR
            msg.fingerprint_ok = val == struct.pack("!I", crc & 0xFFFFFFFF)
        attrs.append((t, val))
        off += 4 + _pad4(alen)
    return msg


def _xor_address(addr: tuple, txn_id: bytes) -> bytes:
    # AF_INET6 sockets report 4-tuples (host, port, flowinfo, scope_id).
    ip, port = addr[0], addr[1]
    xport = port ^ (MAGIC_COOKIE >> 16)
    if ":" in ip:
        # Dual-stack sockets report v4 peers as ::ffff:a.b.c.d and
        # link-local peers with a %zone suffix — unmap/strip before
        # encoding so v4 clients get a family-0x01 address they can route.
        ip = ip.split("%", 1)[0]
        if ip.lower().startswith("::ffff:") and "." in ip:
            ip = ip.rsplit(":", 1)[1]
    if ":" in ip:
        # RFC 5389 §15.2 family 0x02: 128-bit address XORed against
        # magic-cookie ‖ transaction-id.
        packed = socket.inet_pton(socket.AF_INET6, ip)
        mask = struct.pack("!I", MAGIC_COOKIE) + txn_id
        family = 0x02
    else:
        packed = socket.inet_pton(socket.AF_INET, ip)
        mask = struct.pack("!I", MAGIC_COOKIE)
        family = 0x01
    xip = bytes(a ^ b for a, b in zip(packed, mask))
    return struct.pack("!BBH", 0, family, xport) + xip


def build_message(
    msg_type: int,
    txn_id: bytes,
    attrs: list[tuple[int, bytes]],
    integrity_key: bytes | None = None,
    fingerprint: bool = True,
) -> bytes:
    body = b"".join(
        struct.pack("!HH", t, len(v)) + v + b"\x00" * (_pad4(len(v)) - len(v))
        for t, v in attrs
    )
    if integrity_key is not None:
        hdr = struct.pack(
            "!HHI", msg_type, len(body) + 24, MAGIC_COOKIE
        ) + txn_id
        mac = hmac.new(integrity_key, hdr + body, hashlib.sha1).digest()
        body += struct.pack("!HH", ATTR_MESSAGE_INTEGRITY, 20) + mac
    if fingerprint:
        hdr = struct.pack(
            "!HHI", msg_type, len(body) + 8, MAGIC_COOKIE
        ) + txn_id
        crc = (zlib.crc32(hdr + body) ^ FINGERPRINT_XOR) & 0xFFFFFFFF
        body += struct.pack("!HHI", ATTR_FINGERPRINT, 4, crc)
    return (
        struct.pack("!HHI", msg_type, len(body), MAGIC_COOKIE) + txn_id + body
    )


def build_binding_response(
    req: StunMessage, src_addr: tuple[str, int], integrity_key: bytes
) -> bytes:
    """ICE-lite answer: success + XOR-MAPPED-ADDRESS, integrity under the
    local ice-pwd (short-term credential)."""
    return build_message(
        BINDING_SUCCESS,
        req.txn_id,
        [(ATTR_XOR_MAPPED_ADDRESS, _xor_address(src_addr, req.txn_id))],
        integrity_key=integrity_key,
    )


def build_binding_request(
    username: str, integrity_key: bytes, controlling: bool = True,
    use_candidate: bool = True, priority: int = 1 << 24,
) -> bytes:
    """Client-side request (tests + the gateway's keepalive probes)."""
    attrs: list[tuple[int, bytes]] = [
        (ATTR_USERNAME, username.encode()),
        (
            ATTR_ICE_CONTROLLING if controlling else ATTR_ICE_CONTROLLED,
            secrets.token_bytes(8),
        ),
        (ATTR_PRIORITY, struct.pack("!I", priority)),
    ]
    if use_candidate and controlling:
        attrs.append((ATTR_USE_CANDIDATE, b""))
    return build_message(
        BINDING_REQUEST, secrets.token_bytes(12), attrs,
        integrity_key=integrity_key,
    )
