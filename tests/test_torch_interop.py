"""The port's STUN (livekit_server_tpu_torch.interop.stun): the cases of
the reference's tests/test_interop_stun.py, against the RFC 5769 test
vectors, a tampered request, roundtrips with integrity, the RFC 7983
demux, and IPv6, v4-mapped, scoped and 4-tuple XOR addresses.
"""

import binascii

import pytest

from livekit_server_tpu_torch.interop import stun

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers.
torch.set_num_threads(1)

# RFC 5769 §2.1 — sample request (short-term credential
# username "evtj:h6vY", password "VOkJxbRl1RmTxUk/WvJxBt"; username
# padded with 0x20 per the RFC's deliberate non-zero padding).
REQ = binascii.unhexlify(
    "000100582112a442b7e7a701bc34d686fa87dfae"
    "80220010" "5354554e207465737420636c69656e74"
    "00240004" "6e0001ff"
    "80290008" "932ff9b151263b36"
    "00060009" "6576746a3a68367659202020"
    "00080014" "9aeaa70cbfd8cb56781ef2b5b2d3f249c1b571a2"
    "80280004" "e57a3bcf"
)
REQ_PASSWORD = b"VOkJxbRl1RmTxUk/WvJxBt"

# RFC 5769 §2.2 — sample IPv4 response (mapped 192.0.2.1:32853).
RESP = binascii.unhexlify(
    "0101003c2112a442b7e7a701bc34d686fa87dfae"
    "8022000b" "7465737420766563746f7220"
    "00200008" "0001a147e112a643"
    "00080014" "2b91f599fd9e90c38c7489f92af9ba53f06be7d7"
    "80280004" "c07d4c96"
)


def test_rfc5769_request_parses_and_verifies():
    msg = stun.parse_stun(REQ, integrity_key=REQ_PASSWORD)
    assert msg is not None
    assert msg.msg_type == stun.BINDING_REQUEST
    assert msg.username == "evtj:h6vY"
    assert msg.integrity_ok is True
    assert msg.fingerprint_ok is True
    assert msg.attr(stun.ATTR_PRIORITY) == bytes.fromhex("6e0001ff")


def test_rfc5769_request_tamper_detected():
    bad = bytearray(REQ)
    bad[30] ^= 0x01  # flip a byte inside SOFTWARE
    msg = stun.parse_stun(bytes(bad), integrity_key=REQ_PASSWORD)
    assert msg is not None and msg.integrity_ok is False


def test_rfc5769_response_parses():
    msg = stun.parse_stun(RESP, integrity_key=REQ_PASSWORD)
    assert msg is not None
    assert msg.msg_type == stun.BINDING_SUCCESS
    assert msg.fingerprint_ok is True
    assert msg.integrity_ok is True
    xma = msg.attr(stun.ATTR_XOR_MAPPED_ADDRESS)
    port = int.from_bytes(xma[2:4], "big") ^ (stun.MAGIC_COOKIE >> 16)
    ip = bytes(
        a ^ b for a, b in zip(xma[4:8], stun.MAGIC_COOKIE.to_bytes(4, "big"))
    )
    assert port == 32853
    assert ".".join(map(str, ip)) == "192.0.2.1"


def test_binding_roundtrip_with_integrity():
    pwd = b"local-ice-pwd-24-chars-x"
    req_raw = stun.build_binding_request("remote:local", pwd)
    req = stun.parse_stun(req_raw, integrity_key=pwd)
    assert req is not None
    assert req.integrity_ok is True and req.fingerprint_ok is True
    assert req.username == "remote:local"
    assert req.attr(stun.ATTR_USE_CANDIDATE) == b""

    resp_raw = stun.build_binding_response(req, ("203.0.113.7", 50123), pwd)
    resp = stun.parse_stun(resp_raw, integrity_key=pwd)
    assert resp is not None
    assert resp.msg_type == stun.BINDING_SUCCESS
    assert resp.txn_id == req.txn_id
    assert resp.integrity_ok is True and resp.fingerprint_ok is True
    xma = resp.attr(stun.ATTR_XOR_MAPPED_ADDRESS)
    port = int.from_bytes(xma[2:4], "big") ^ (stun.MAGIC_COOKIE >> 16)
    assert port == 50123


def test_demux_rejects_non_stun():
    assert stun.parse_stun(b"\x80\x60" + b"x" * 30) is None  # RTP-ish
    assert stun.parse_stun(b"\x16\xfe\xfd" + b"x" * 30) is None  # DTLS
    assert stun.parse_stun(b"") is None


def test_xor_mapped_address_ipv6():
    """RFC 5389 §15.2 family 0x02: 128-bit address XORed against
    cookie‖txn-id (v4-only _xor_address used to emit garbage here)."""
    import socket
    import struct

    req = stun.parse_stun(
        stun.build_binding_request("u:me", b"pw"), integrity_key=b"pw"
    )
    resp = stun.build_binding_response(req, ("2001:db8::1", 43210), b"pw")
    msg = stun.parse_stun(resp, integrity_key=b"pw")
    assert msg is not None and msg.integrity_ok
    xma = msg.attr(stun.ATTR_XOR_MAPPED_ADDRESS)
    assert xma[1] == 0x02 and len(xma) == 4 + 16
    port = struct.unpack("!H", xma[2:4])[0] ^ (stun.MAGIC_COOKIE >> 16)
    mask = struct.pack("!I", stun.MAGIC_COOKIE) + req.txn_id
    ip = bytes(a ^ b for a, b in zip(xma[4:], mask))
    assert port == 43210
    assert ip == socket.inet_pton(socket.AF_INET6, "2001:db8::1")


def test_xor_mapped_address_v4_mapped_and_scoped():
    """Dual-stack quirks: ::ffff:a.b.c.d must unmap to family 0x01; a
    %zone suffix must not crash the responder."""
    import struct

    req = stun.parse_stun(
        stun.build_binding_request("u:me", b"pw"), integrity_key=b"pw"
    )
    resp = stun.build_binding_response(
        req, ("::ffff:203.0.113.5", 1234), b"pw"
    )
    xma = stun.parse_stun(resp).attr(stun.ATTR_XOR_MAPPED_ADDRESS)
    assert xma[1] == 0x01 and len(xma) == 4 + 4
    ip = bytes(
        a ^ b
        for a, b in zip(xma[4:], struct.pack("!I", stun.MAGIC_COOKIE))
    )
    assert ip == bytes([203, 0, 113, 5])
    # Scoped link-local: must produce a family-0x02 answer, not raise.
    resp = stun.build_binding_response(req, ("fe80::1%eth0", 5), b"pw")
    assert stun.parse_stun(resp).attr(stun.ATTR_XOR_MAPPED_ADDRESS)[1] == 0x02


def test_binding_response_with_4tuple_addr():
    """AF_INET6 recvfrom yields (host, port, flowinfo, scope_id) — the
    responder must accept it directly."""
    req = stun.parse_stun(
        stun.build_binding_request("u:me", b"pw"), integrity_key=b"pw"
    )
    resp = stun.build_binding_response(req, ("2001:db8::2", 9, 0, 0), b"pw")
    assert stun.parse_stun(resp).attr(stun.ATTR_XOR_MAPPED_ADDRESS)[1] == 0x02
