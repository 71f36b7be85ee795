"""Opus codec via the system libopus (ctypes) — the MCU seat's codec.

Reference parity: the reference is an SFU and never decodes Opus
(pkg/sfu/audio/audiolevel.go reads only the header extension). This
build's BASELINE config 2 commits to a *batched active-speaker mix* —
an MCU capability — which requires real Opus decode/encode at the
server. The codec work is inherently host-side and stateful (Opus
carries inter-frame prediction state); the MIX itself is the batched
tensor op (runtime/mixer.py `_device_mix`) that scales on the device.

No headers are shipped in this image; the ABI here is the stable public
libopus API (opus_decoder_create/opus_decode/opus_encode), loaded from
libopus.so.0.

Port of the JAX package's interop/opus.py, copied as it is (it imports
neither JAX nor torch). Where libopus.so.0 is absent, `available()` is
False and every codec constructor raises OpusError.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

__all__ = ["OpusDecoder", "OpusEncoder", "available", "OpusError"]

SAMPLE_RATE = 48000
FRAME_MS = 20
FRAME_SAMPLES = SAMPLE_RATE * FRAME_MS // 1000  # 960

OPUS_APPLICATION_VOIP = 2048
OPUS_SET_BITRATE_REQUEST = 4002
OPUS_SET_INBAND_FEC_REQUEST = 4012


class OpusError(Exception):
    pass


_lib = None
_lib_missing = False


def _load():
    global _lib, _lib_missing
    if _lib is not None or _lib_missing:
        return _lib
    name = ctypes.util.find_library("opus") or "libopus.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        _lib_missing = True
        return None
    P = ctypes.c_void_p
    lib.opus_decoder_create.restype = P
    lib.opus_decoder_create.argtypes = [
        ctypes.c_int32, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    lib.opus_decode.restype = ctypes.c_int
    lib.opus_decode.argtypes = [
        P, ctypes.c_char_p, ctypes.c_int32, P, ctypes.c_int, ctypes.c_int
    ]
    lib.opus_decoder_destroy.restype = None
    lib.opus_decoder_destroy.argtypes = [P]
    lib.opus_encoder_create.restype = P
    lib.opus_encoder_create.argtypes = [
        ctypes.c_int32, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.opus_encode.restype = ctypes.c_int32
    lib.opus_encode.argtypes = [
        P, P, ctypes.c_int, ctypes.c_char_p, ctypes.c_int32
    ]
    lib.opus_encoder_destroy.restype = None
    lib.opus_encoder_destroy.argtypes = [P]
    # varargs ctl: declare the (int request, int value) shape we use.
    lib.opus_encoder_ctl.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class OpusDecoder:
    """One stream's stateful decoder → mono 48 kHz int16 frames."""

    def __init__(self, channels: int = 1):
        lib = _load()
        if lib is None:
            raise OpusError("libopus not available")
        err = ctypes.c_int(0)
        self._lib = lib
        self._dec = lib.opus_decoder_create(
            SAMPLE_RATE, channels, ctypes.byref(err)
        )
        if not self._dec or err.value != 0:
            raise OpusError(f"opus_decoder_create: {err.value}")
        self.channels = channels
        self._buf = np.zeros(FRAME_SAMPLES * channels * 6, np.int16)

    def decode(self, packet: bytes | None) -> np.ndarray:
        """One packet → int16 PCM [samples]; packet=None runs packet-loss
        concealment for a 20 ms gap."""
        n = self._lib.opus_decode(
            self._dec,
            packet if packet is not None else None,
            len(packet) if packet is not None else 0,
            self._buf.ctypes.data_as(ctypes.c_void_p),
            # PLC (packet=None) synthesizes exactly the frame size asked
            # for — ask for one 20 ms frame, not the whole scratch buffer.
            len(self._buf) // self.channels if packet is not None
            else FRAME_SAMPLES,
            0,
        )
        if n < 0:
            raise OpusError(f"opus_decode: {n}")
        return self._buf[: n * self.channels].copy()

    def close(self):
        if self._dec:
            self._lib.opus_decoder_destroy(self._dec)
            self._dec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class OpusEncoder:
    """One mixed-output stream's stateful encoder (mono 48 kHz VoIP)."""

    def __init__(self, bitrate: int = 32000, channels: int = 1):
        lib = _load()
        if lib is None:
            raise OpusError("libopus not available")
        err = ctypes.c_int(0)
        self._lib = lib
        self._enc = lib.opus_encoder_create(
            SAMPLE_RATE, channels, OPUS_APPLICATION_VOIP, ctypes.byref(err)
        )
        if not self._enc or err.value != 0:
            raise OpusError(f"opus_encoder_create: {err.value}")
        self.channels = channels
        # varargs call: no argtypes apply, so the pointer MUST be wrapped
        # (a bare Python int would be passed as a truncated 32-bit C int).
        lib.opus_encoder_ctl(
            ctypes.c_void_p(self._enc), OPUS_SET_BITRATE_REQUEST,
            ctypes.c_int(bitrate),
        )
        self._out = ctypes.create_string_buffer(4000)

    def encode(self, pcm: np.ndarray) -> bytes:
        """int16 PCM [FRAME_SAMPLES*channels] → one Opus packet."""
        pcm = np.ascontiguousarray(pcm, np.int16)
        n = self._lib.opus_encode(
            self._enc,
            pcm.ctypes.data_as(ctypes.c_void_p),
            len(pcm) // self.channels,
            self._out,
            len(self._out),
        )
        if n < 0:
            raise OpusError(f"opus_encode: {n}")
        return self._out.raw[:n]

    def close(self):
        if self._enc:
            self._lib.opus_encoder_destroy(self._enc)
            self._enc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
