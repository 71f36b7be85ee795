"""DTLS-SRTP endpoint over OpenSSL (libssl.so.3) via ctypes.

Reference parity: the reference terminates real WebRTC DTLS through Pion
(pkg/rtc/transport.go:253-374 — DTLS handshake → SRTP key export →
pion/srtp contexts). This module is the same seam for the TPU SFU: an
in-memory DTLS state machine (datagrams in/out, no sockets of its own)
that negotiates `use_srtp` (RFC 5764) and exports AEAD_AES_128_GCM
keying material for `interop.srtp.SrtpSession`.

Design notes
  * ctypes against the system libssl/libcrypto — this image ships no
    OpenSSL headers, so a compiled shim is not an option; the crypto
    itself still runs in OpenSSL's C, only the BIO plumbing is Python.
  * Memory BIOs carry the handshake: DTLS records are self-framing, so
    the transport (runtime/udp.py) just feeds received datagrams in and
    ships produced records out. Flights are split on record boundaries
    into ≤ MTU-ish datagrams for the wire.
  * The server side is ICE-gated (the gateway only feeds DTLS from
    addresses that passed a STUN binding with our ice-pwd), so the
    DTLSv1_listen cookie exchange is deliberately skipped — same
    stance as Pion's ICE-integrated DTLS.
  * Certificates are ephemeral self-signed ECDSA P-256 (what browsers
    generate); authentication is by SDP fingerprint pinning (RFC 8122),
    not CA chains.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import datetime
import hashlib
import threading

__all__ = [
    "DtlsEndpoint",
    "DtlsError",
    "SRTP_PROFILE_NAME",
    "generate_certificate",
    "is_dtls",
]

SRTP_PROFILE_NAME = b"SRTP_AEAD_AES_128_GCM"
SRTP_PROFILE_ID = 0x0007  # RFC 7714 DTLS-SRTP protection profile id
KEY_LEN = 16
SALT_LEN = 12
EXPORT_LABEL = b"EXTRACTOR-dtls_srtp"  # RFC 5764 §4.2
MTU = 1200

# libssl constants
SSL_ERROR_WANT_READ = 2
SSL_ERROR_WANT_WRITE = 3
SSL_ERROR_ZERO_RETURN = 6
SSL_VERIFY_PEER = 0x01
SSL_OP_NO_QUERY_MTU = 0x00001000
SSL_CTRL_SET_MTU = 17
DTLS_CTRL_GET_TIMEOUT = 73
DTLS_CTRL_HANDLE_TIMEOUT = 74
BIO_C_SET_BUF_MEM_EOF_RETURN = 130


def is_dtls(data: bytes) -> bool:
    """RFC 7983 §7 demux: first byte in [20, 63]."""
    return len(data) > 0 and 20 <= data[0] <= 63


class DtlsError(Exception):
    pass


class _Lib:
    """Lazy singleton for the libssl/libcrypto handles + prototypes."""

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def get(cls) -> "_Lib":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self.ssl = ctypes.CDLL("libssl.so.3")
        self.crypto = ctypes.CDLL("libcrypto.so.3")
        s, c = self.ssl, self.crypto
        P = ctypes.c_void_p
        for name, res, arg in [
            ("DTLS_method", P, []),
            ("SSL_CTX_new", P, [P]),
            ("SSL_CTX_free", None, [P]),
            ("SSL_CTX_use_certificate", ctypes.c_int, [P, P]),
            ("SSL_CTX_use_PrivateKey", ctypes.c_int, [P, P]),
            ("SSL_CTX_set_tlsext_use_srtp", ctypes.c_int, [P, ctypes.c_char_p]),
            ("SSL_CTX_set_verify", None, [P, ctypes.c_int, P]),
            ("SSL_CTX_set_options", ctypes.c_uint64, [P, ctypes.c_uint64]),
            ("SSL_new", P, [P]),
            ("SSL_free", None, [P]),
            ("SSL_set_bio", None, [P, P, P]),
            ("SSL_set_accept_state", None, [P]),
            ("SSL_set_connect_state", None, [P]),
            ("SSL_do_handshake", ctypes.c_int, [P]),
            ("SSL_get_error", ctypes.c_int, [P, ctypes.c_int]),
            ("SSL_is_init_finished", ctypes.c_int, [P]),
            ("SSL_read", ctypes.c_int, [P, P, ctypes.c_int]),
            ("SSL_write", ctypes.c_int, [P, P, ctypes.c_int]),
            ("SSL_ctrl", ctypes.c_long, [P, ctypes.c_int, ctypes.c_long, P]),
            ("SSL_get_selected_srtp_profile", P, [P]),
            ("SSL_export_keying_material", ctypes.c_int,
             [P, P, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
              P, ctypes.c_size_t, ctypes.c_int]),
            ("SSL_get1_peer_certificate", P, [P]),
            ("SSL_shutdown", ctypes.c_int, [P]),
        ]:
            f = getattr(s, name)
            f.restype, f.argtypes = res, arg
        for name, res, arg in [
            ("BIO_new", P, [P]),
            ("BIO_s_mem", P, []),
            ("BIO_free", ctypes.c_int, [P]),
            ("BIO_write", ctypes.c_int, [P, P, ctypes.c_int]),
            ("BIO_read", ctypes.c_int, [P, P, ctypes.c_int]),
            ("BIO_ctrl_pending", ctypes.c_size_t, [P]),
            ("BIO_ctrl", ctypes.c_long, [P, ctypes.c_int, ctypes.c_long, P]),
            ("PEM_read_bio_X509", P, [P, P, P, P]),
            ("PEM_read_bio_PrivateKey", P, [P, P, P, P]),
            ("X509_free", None, [P]),
            ("EVP_PKEY_free", None, [P]),
            ("X509_digest", ctypes.c_int,
             [P, P, P, ctypes.POINTER(ctypes.c_uint)]),
            ("EVP_sha256", P, []),
            ("ERR_get_error", ctypes.c_ulong, []),
            ("ERR_error_string_n", None,
             [ctypes.c_ulong, ctypes.c_char_p, ctypes.c_size_t]),
        ]:
            f = getattr(c, name)
            f.restype, f.argtypes = res, arg
        # The verify callback must outlive every SSL_CTX using it.
        self.verify_cb = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p
        )(lambda ok, store: 1)  # fingerprint pinning replaces CA checks

    def last_error(self) -> str:
        buf = ctypes.create_string_buffer(256)
        e = self.crypto.ERR_get_error()
        if not e:
            return "no OpenSSL error queued"
        self.crypto.ERR_error_string_n(e, buf, 256)
        return buf.value.decode("ascii", "replace")


_SRTP_PROFILE_STRUCT_ID_OFFSET = ctypes.sizeof(ctypes.c_void_p)


def generate_certificate(common_name: str = "tpu-sfu") -> tuple[bytes, bytes, str]:
    """Ephemeral self-signed ECDSA P-256 cert (what WebRTC stacks mint).

    Returns (cert_pem, key_pem, sha256_fingerprint) with the fingerprint
    in SDP `a=fingerprint` form (upper-hex, colon-separated, RFC 8122).
    """
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=30))
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    fp = cert.fingerprint(hashes.SHA256()).hex().upper()
    fingerprint = ":".join(fp[i : i + 2] for i in range(0, len(fp), 2))
    return cert_pem, key_pem, fingerprint


def _split_records(blob: bytes, mtu: int = MTU) -> list[bytes]:
    """Split a mem-BIO drain (possibly several coalesced DTLS records)
    into wire datagrams: records are grouped greedily up to ~mtu, never
    split mid-record (a record must arrive whole in one datagram)."""
    out: list[bytes] = []
    cur = b""
    off = 0
    n = len(blob)
    while off + 13 <= n:
        rec_len = 13 + int.from_bytes(blob[off + 11 : off + 13], "big")
        rec = blob[off : off + rec_len]
        if cur and len(cur) + len(rec) > mtu:
            out.append(cur)
            cur = b""
        cur += rec
        off += rec_len
    if off < n:  # trailing garbage / truncated record: ship as-is
        cur += blob[off:]
    if cur:
        out.append(cur)
    return out


class DtlsEndpoint:
    """One DTLS association as a pure datagram state machine.

    Usage:
        ep = DtlsEndpoint(role="server", cert_pem=..., key_pem=...)
        to_wire = ep.pump()              # client role: initial flight
        to_wire = ep.feed(datagram)      # on every received datagram
        if ep.handshake_complete: keys = ep.export_srtp_keys()
    """

    def __init__(
        self,
        role: str,
        cert_pem: bytes,
        key_pem: bytes,
        peer_fingerprint: str | None = None,
    ):
        if role not in ("server", "client"):
            raise ValueError(role)
        self.role = role
        self.peer_fingerprint = peer_fingerprint
        self.handshake_complete = False
        self._lib = _Lib.get()
        s, c = self._lib.ssl, self._lib.crypto

        self._ctx = s.SSL_CTX_new(s.DTLS_method())
        if not self._ctx:
            raise DtlsError(f"SSL_CTX_new: {self._lib.last_error()}")
        try:
            # Cert + key from PEM through mem BIOs (no temp files).
            x509 = self._pem_obj(cert_pem, c.PEM_read_bio_X509)
            try:
                if s.SSL_CTX_use_certificate(self._ctx, x509) != 1:
                    raise DtlsError(
                        f"use_certificate: {self._lib.last_error()}"
                    )
            finally:
                c.X509_free(x509)
            pkey = self._pem_obj(key_pem, c.PEM_read_bio_PrivateKey)
            try:
                if s.SSL_CTX_use_PrivateKey(self._ctx, pkey) != 1:
                    raise DtlsError(
                        f"use_PrivateKey: {self._lib.last_error()}"
                    )
            finally:
                c.EVP_PKEY_free(pkey)
            # use_srtp returns 0 on SUCCESS (documented quirk).
            if s.SSL_CTX_set_tlsext_use_srtp(self._ctx, SRTP_PROFILE_NAME):
                raise DtlsError(
                    f"set_tlsext_use_srtp: {self._lib.last_error()}"
                )
            # WebRTC authenticates by certificate fingerprint from the
            # signalled SDP, not a CA chain: demand a peer cert, accept
            # any chain, pin the digest after the handshake.
            s.SSL_CTX_set_verify(
                self._ctx, SSL_VERIFY_PEER, self._lib.verify_cb
            )
            s.SSL_CTX_set_options(self._ctx, SSL_OP_NO_QUERY_MTU)

            self._ssl = s.SSL_new(self._ctx)
            if not self._ssl:
                raise DtlsError(f"SSL_new: {self._lib.last_error()}")
            self._rbio = c.BIO_new(c.BIO_s_mem())
            self._wbio = c.BIO_new(c.BIO_s_mem())
            # Empty mem BIO must read as retry-later, not EOF.
            c.BIO_ctrl(self._rbio, BIO_C_SET_BUF_MEM_EOF_RETURN, -1, None)
            c.BIO_ctrl(self._wbio, BIO_C_SET_BUF_MEM_EOF_RETURN, -1, None)
            s.SSL_set_bio(self._ssl, self._rbio, self._wbio)  # owns BIOs
            s.SSL_ctrl(self._ssl, SSL_CTRL_SET_MTU, MTU, None)
            if role == "server":
                s.SSL_set_accept_state(self._ssl)
            else:
                s.SSL_set_connect_state(self._ssl)
        except Exception:
            s.SSL_CTX_free(self._ctx)
            self._ctx = None
            raise

    def _pem_obj(self, pem: bytes, reader):
        c = self._lib.crypto
        bio = c.BIO_new(c.BIO_s_mem())
        try:
            c.BIO_write(bio, pem, len(pem))
            obj = reader(bio, None, None, None)
            if not obj:
                raise DtlsError(f"PEM parse: {self._lib.last_error()}")
            return obj
        finally:
            c.BIO_free(bio)

    # -- datagram pump ----------------------------------------------------

    def feed(self, datagram: bytes) -> list[bytes]:
        """Process one received DTLS datagram; returns datagrams to send."""
        if self._ctx is None:
            return []
        c = self._lib.crypto
        buf = ctypes.create_string_buffer(datagram, len(datagram))
        c.BIO_write(self._rbio, buf, len(datagram))
        return self.pump()

    def pump(self) -> list[bytes]:
        """Advance the state machine; returns produced wire datagrams."""
        if self._ctx is None:
            return []
        s = self._lib.ssl
        if not self.handshake_complete:
            ret = s.SSL_do_handshake(self._ssl)
            if ret == 1:
                self._finish_handshake()
            else:
                err = s.SSL_get_error(self._ssl, ret)
                if err not in (SSL_ERROR_WANT_READ, SSL_ERROR_WANT_WRITE):
                    raise DtlsError(
                        f"handshake: ssl_error={err} {self._lib.last_error()}"
                    )
        else:
            # Drain any post-handshake application/alert records so
            # retransmitted flights or close_notify don't wedge the BIO.
            scratch = ctypes.create_string_buffer(4096)
            while s.SSL_read(self._ssl, scratch, 4096) > 0:
                pass
        return self._drain()

    def _drain(self) -> list[bytes]:
        c = self._lib.crypto
        pending = c.BIO_ctrl_pending(self._wbio)
        if not pending:
            return []
        buf = ctypes.create_string_buffer(int(pending))
        n = c.BIO_read(self._wbio, buf, int(pending))
        if n <= 0:
            return []
        return _split_records(buf.raw[:n])

    def handle_timeout(self) -> list[bytes]:
        """DTLS retransmission timer; call at ~every 100 ms while the
        handshake is in flight. Returns retransmitted datagrams."""
        if self._ctx is None or self.handshake_complete:
            return []
        s = self._lib.ssl
        s.SSL_ctrl(self._ssl, DTLS_CTRL_HANDLE_TIMEOUT, 0, None)
        return self._drain()

    def _finish_handshake(self) -> None:
        s = self._lib.ssl
        prof = s.SSL_get_selected_srtp_profile(self._ssl)
        if not prof:
            raise DtlsError("peer did not negotiate use_srtp")
        # SRTP_PROTECTION_PROFILE struct = {const char *name; long id}.
        pid = ctypes.cast(
            ctypes.c_void_p(prof + _SRTP_PROFILE_STRUCT_ID_OFFSET),
            ctypes.POINTER(ctypes.c_ulong),
        ).contents.value
        if pid != SRTP_PROFILE_ID:
            raise DtlsError(f"unexpected SRTP profile {pid:#x}")
        if self.peer_fingerprint is not None:
            got = self.peer_fingerprint_sha256()
            if got is None or got.lower() != self.peer_fingerprint.lower():
                raise DtlsError(
                    f"peer fingerprint mismatch: {got} != "
                    f"{self.peer_fingerprint}"
                )
        self.handshake_complete = True

    # -- post-handshake ---------------------------------------------------

    def peer_fingerprint_sha256(self) -> str | None:
        s, c = self._lib.ssl, self._lib.crypto
        x509 = s.SSL_get1_peer_certificate(self._ssl)
        if not x509:
            return None
        try:
            md = ctypes.create_string_buffer(32)
            n = ctypes.c_uint(0)
            if c.X509_digest(x509, c.EVP_sha256(), md, ctypes.byref(n)) != 1:
                return None
            fp = md.raw[: n.value].hex().upper()
            return ":".join(fp[i : i + 2] for i in range(0, len(fp), 2))
        finally:
            c.X509_free(x509)

    def export_srtp_keys(self):
        """RFC 5764 §4.2 exporter → ((local_key, local_salt),
        (remote_key, remote_salt)) oriented by our role: `local` protects
        what WE send."""
        if not self.handshake_complete:
            raise DtlsError("handshake not complete")
        s = self._lib.ssl
        total = 2 * (KEY_LEN + SALT_LEN)
        out = ctypes.create_string_buffer(total)
        if s.SSL_export_keying_material(
            self._ssl, out, total, EXPORT_LABEL, len(EXPORT_LABEL),
            None, 0, 0,
        ) != 1:
            raise DtlsError(f"export: {self._lib.last_error()}")
        m = out.raw
        ck, sk = m[:KEY_LEN], m[KEY_LEN : 2 * KEY_LEN]
        cs = m[2 * KEY_LEN : 2 * KEY_LEN + SALT_LEN]
        ss = m[2 * KEY_LEN + SALT_LEN :]
        if self.role == "server":
            return (sk, ss), (ck, cs)
        return (ck, cs), (sk, ss)

    def close(self) -> None:
        if self._ctx is None:
            return
        s = self._lib.ssl
        try:
            s.SSL_shutdown(self._ssl)
        finally:
            s.SSL_free(self._ssl)      # frees the BIOs it owns
            s.SSL_CTX_free(self._ctx)
            self._ctx = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    @property
    def dtls_cookie_note(self) -> str:
        return (
            "cookie exchange skipped: DTLS is only fed from "
            "STUN-validated addresses (ICE-gated, like Pion's usage)"
        )
