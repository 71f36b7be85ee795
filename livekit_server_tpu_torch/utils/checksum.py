"""Checksummed checkpoint framing — the single serialization codec for
every snapshot that leaves process memory (the supervisor's restart
seeds, row repairs, and room snapshots).

A copy of the JAX package's utils/checksum.py; the frame format is the
same, so a frame written by either package verifies in the other.

A restore path that scatters unverified bytes into DONATED device state
turns one flipped bit in a checkpoint into a silently-wrong media plane:
`restore_room` happily scatters whatever deserializes. Every
serialized snapshot therefore rides inside a versioned frame:

    offset  size  field
    0       4     magic  b"LKCK"
    4       2     version (big-endian u16; readers reject unknown majors)
    6       2     flags   (reserved; must round-trip)
    8       8     payload length (big-endian u64)
    16      4     CRC32 of payload (zlib.crc32, big-endian u32)
    20      -     payload bytes

CRC32 is the strongest digest in the stdlib footprint this repo allows
(no xxhash wheel in the image); at checkpoint sizes (KBs..MBs) it
detects the single/multi-bit corruption class the bitflip fault model
injects.

Verification failures raise ChecksumError; callers (supervisor,
the integrity monitor) fall back one checkpoint generation instead of
committing garbage — see runtime/supervisor.py and runtime/integrity.py.
"""

from __future__ import annotations

import base64
import struct
import zlib

MAGIC = b"LKCK"
VERSION = 1
_HEADER = struct.Struct(">4sHHQI")
HEADER_SIZE = _HEADER.size  # 20 bytes


class ChecksumError(ValueError):
    """Frame failed verification (bad magic/version/length/CRC)."""


class CodecStats:
    """Process-wide codec counters, read at telemetry scrape time (the
    MessageChannel.total_dropped idiom)."""

    frames_encoded = 0
    frames_verified = 0
    verify_failures = 0


def encode_frame(payload: bytes, *, flags: int = 0) -> bytes:
    """Wrap serialized checkpoint bytes in the versioned+checksummed
    frame. The only sanctioned way to emit checkpoint bytes."""
    CodecStats.frames_encoded += 1
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return _HEADER.pack(MAGIC, VERSION, flags, len(payload), crc) + payload


def decode_frame(frame: bytes) -> bytes:
    """Verify and strip the frame; raises ChecksumError on any mismatch
    BEFORE the caller deserializes (no np.load / scatter of bad bytes)."""
    if len(frame) < HEADER_SIZE:
        _fail(f"frame truncated: {len(frame)} bytes < {HEADER_SIZE} header")
    magic, version, _flags, length, crc = _HEADER.unpack(frame[:HEADER_SIZE])
    if magic != MAGIC:
        _fail(f"bad magic {magic!r}")
    if version != VERSION:
        _fail(f"unsupported frame version {version}")
    payload = frame[HEADER_SIZE:]
    if len(payload) != length:
        _fail(f"length mismatch: header says {length}, got {len(payload)}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        _fail("CRC32 mismatch: checkpoint bytes corrupted")
    CodecStats.frames_verified += 1
    return payload


def encode_frame_b64(payload: bytes, *, flags: int = 0) -> str:
    """Framed payload as base64 text (the KV bus carries strings)."""
    return base64.b64encode(encode_frame(payload, flags=flags)).decode()


def decode_frame_b64(text: str) -> bytes:
    try:
        frame = base64.b64decode(text)
    except (ValueError, TypeError) as e:
        _fail(f"bad base64 framing: {e}")
    return decode_frame(frame)


def _fail(msg: str) -> None:
    CodecStats.verify_failures += 1
    raise ChecksumError(msg)
