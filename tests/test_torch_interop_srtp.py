"""The port's SRTP (livekit_server_tpu_torch.interop.srtp, AEAD_AES_128_GCM
on `cryptography`): the first cases of the reference's
tests/test_interop_srtp.py, the RFC 3711 key derivation and the RFC 7714
vectors, tamper, replay and ROC across the 16-bit wrap, CSRC and header
extensions in the AAD, SRTCP roundtrip and tamper. The replay and
transmit-ROC cases are in tests/test_torch_interop_roc.py.
"""

import pytest

pytest.importorskip("cryptography")  # OpenSSL-backed interop lane; absent in slim images

from livekit_server_tpu_torch.interop import srtp


def _vector_session() -> srtp.SrtpSession:
    """Session with the RFC 7714 §16.1 SESSION key/salt installed directly
    (the RFC vectors give derived keys, not masters)."""
    s = srtp.SrtpSession(master_key=bytes(16), master_salt=bytes(12))
    s.rtp_key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    s.rtp_salt = bytes.fromhex("517569642070726f2071756f")
    s.rtcp_key = s.rtp_key
    s.rtcp_salt = s.rtp_salt
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    s._rtp_aead = AESGCM(s.rtp_key)
    s._rtcp_aead = AESGCM(s.rtcp_key)
    return s


RFC7714_RTP_CLEAR = bytes.fromhex(
    "8040f17b8041f8d35501a0b2"
) + b"Gallia est omnis divisa in partes tres"
RFC7714_RTP_PROTECTED = bytes.fromhex(
    "8040f17b8041f8d35501a0b2"
    "f24de3a3fb34de6cacba861c9d7e4bcabe633bd50d294e6f42a5f47a"
    "51c7d19b36de3adf8833899d7f27beb16a9152cf765ee4390cce"
)


def test_rfc3711_kdf_vectors():
    mk = bytes.fromhex("E1F97A0D3E018BE0D64FA32C06DE4139")
    ms = bytes.fromhex("0EC675AD498AFEEBB6960B3AABE6")
    assert srtp._aes_cm_derive(mk, ms, 0x00, 16).hex() == (
        "c61e7a93744f39ee10734afe3ff7a087"
    )
    assert srtp._aes_cm_derive(mk, ms, 0x02, 14).hex() == (
        "30cbbc08863d8c85d49db34a9ae1"
    )
    assert srtp._aes_cm_derive(mk, ms, 0x01, 20).hex() == (
        "cebe321f6ff7716b6fd4ab49af256a156d38baa4"
    )


def test_rfc7714_rtp_protect_vector():
    s = _vector_session()
    assert s.protect_rtp(RFC7714_RTP_CLEAR, roc=0) == RFC7714_RTP_PROTECTED


def test_rfc7714_rtp_unprotect_vector():
    s = _vector_session()
    assert s.unprotect_rtp(RFC7714_RTP_PROTECTED, roc=0) == RFC7714_RTP_CLEAR


def test_rtp_tamper_rejected():
    s = _vector_session()
    bad = bytearray(RFC7714_RTP_PROTECTED)
    bad[20] ^= 1
    assert s.unprotect_rtp(bytes(bad), roc=0) is None


def _rtp(seq: int, ssrc: int = 0x1234, payload: bytes = b"x" * 30) -> bytes:
    return (
        bytes([0x80, 96])
        + seq.to_bytes(2, "big")
        + (seq * 960).to_bytes(4, "big")
        + ssrc.to_bytes(4, "big")
        + payload
    )


def test_rtp_roundtrip_replay_and_roc():
    tx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    # Sequence crossing the 16-bit wrap: ROC must advance on both sides.
    seqs = [0xFFFE, 0xFFFF, 0, 1, 2]
    wire = [tx.protect_rtp(_rtp(q)) for q in seqs]
    for q, w in zip(seqs, wire):
        out = rx.unprotect_rtp(w)
        assert out == _rtp(q), f"seq {q:#x}"
    assert rx._rx[0x1234][0] == 1  # ROC advanced past the wrap
    # Replay of an already-seen packet is rejected.
    assert rx.unprotect_rtp(wire[-1]) is None
    assert rx.unprotect_rtp(wire[0]) is None


def test_rtp_header_with_csrc_and_extension():
    tx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    # CC=2 + one extension word: the AAD must cover the full header.
    hdr = bytearray(_rtp(7))
    hdr[0] = 0x80 | 0x10 | 2  # X + CC=2
    pkt = (
        bytes(hdr[:12])
        + b"\x00\x00\x00\x01\x00\x00\x00\x02"          # 2 CSRCs
        + b"\xbe\xde\x00\x01" + b"\x10\x40\x00\x00"    # one ext word
        + b"payload!"
    )
    out = rx.unprotect_rtp(tx.protect_rtp(pkt))
    assert out == pkt


def test_rtcp_roundtrip_and_tamper():
    tx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rr = bytes([0x81, 201, 0, 7]) + (0xCAFE).to_bytes(4, "big") + bytes(24)
    w = tx.protect_rtcp(rr)
    assert rx.unprotect_rtcp(w) == rr
    bad = bytearray(w)
    bad[10] ^= 1
    assert rx.unprotect_rtcp(bytes(bad)) is None
    # E-bit clear (unencrypted SRTCP) is not accepted.
    noe = bytearray(w)
    noe[-4] &= 0x7F
    assert rx.unprotect_rtcp(bytes(noe)) is None
