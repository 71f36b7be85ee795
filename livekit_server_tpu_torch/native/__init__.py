"""Native (C++) packet-path components, loaded via ctypes.

Reference parity: the per-packet byte work the reference does in Go on the
hot path — RTP header + extension parsing and VP8 descriptor decode
(pkg/sfu/buffer/buffer.go:417, buffer/vp8.go) and egress header rewrite
(pkg/sfu/downtrack.go WriteRTP) — compiled as C++ batch libraries. One
native call per receive/send batch replaces per-packet managed-language
work.

The port's own copies of the three sources live in `native/csrc/`
(rtp_parser.cpp, egress.cpp, munge.cpp). Each is built with g++ at its
first use into `livekit_server_tpu_torch/_build/native/`, under a file
name that carries a digest of the source and the flags, so an edited
source rebuilds; the build goes to a temporary name and is renamed into
place, so processes that build at once never load a half-written file;
each build is an entry of the build ledger (runtime/compile_ledger.py).
Nothing is built at import: `rtp`, `egress` and `munge` are module
attributes resolved on first access.

A build, link, ABI or self-test failure is logged with the compiler's
output and recorded in `build_log`; the attribute is then None (egress,
munge) or the pure-Python parser `PythonRTP` (rtp), which is also the
plain version the tests hold the native parser against. `status()` says
which libraries loaded, how each was built and which libcrypto the
process mapped.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from livekit_server_tpu_torch.utils.logger import log as _log

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[1] / "_build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
# The EVP_* subset egress.cpp uses is ABI-stable across OpenSSL 1.1 and 3;
# link against whichever libcrypto the machine ships, first match wins.
LIBCRYPTO_LADDER = ("-l:libcrypto.so.3", "-l:libcrypto.so.1.1", "-lcrypto")

# Expected ABI of the compiled libraries; each .so exports an
# *_abi_version() checked at load time. A mismatch means the Python
# bindings and the source disagree: the library is refused (logged), not
# called through a wrong signature.
EGRESS_ABI = 4
MUNGE_ABI = 2

# name → {"cmd", "so", "ok", "error"} of the last build attempt of each
# library (chip_smoke.py prints it).
build_log: dict[str, dict] = {}

# Keep in sync with struct ParsedPacket in rtp_parser.cpp.
PARSED_DTYPE = np.dtype(
    [
        ("ssrc", np.uint32), ("sn", np.uint16), ("pt", np.uint8),
        ("marker", np.uint8), ("ts", np.uint32),
        ("payload_off", np.int32), ("payload_len", np.int32),
        ("audio_level", np.uint8), ("voice", np.uint8),
        ("is_vp8", np.uint8), ("keyframe", np.uint8), ("begin_pic", np.uint8),
        ("tid", np.uint8), ("layer_sync", np.uint8),
        ("picture_id", np.int32), ("tl0picidx", np.int32), ("keyidx", np.int32),
        ("dd_off", np.int32), ("dd_len", np.int32),
        ("end_frame", np.uint8), ("sid", np.int8),
    ],
    align=True,
)


def library_path(source: str, extra_flags: tuple[str, ...] = ()) -> Path:
    """The built library of csrc/<source>.cpp with `extra_flags`."""
    h = hashlib.sha256((_CSRC / f"{source}.cpp").read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS, *extra_flags)).encode())
    return _BUILD / f"lib{source}-{h.hexdigest()[:12]}.so"


def _compile(source: str, name: str, extra_flags: tuple[str, ...] = ()) -> Path | None:
    """Build (or reuse) one library; None on failure, logged with the
    compiler's output and recorded in build_log[name]."""
    so = library_path(source, extra_flags)
    src = str(_CSRC / f"{source}.cpp")
    entry = {"cmd": " ".join([CXX, *CXX_FLAGS, "-o", str(so), src, *extra_flags]),
             "so": str(so), "ok": False, "error": ""}
    build_log[name] = entry
    if so.exists():
        entry["ok"] = True
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [CXX, *CXX_FLAGS, "-o", str(tmp), src, *extra_flags],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.SubprocessError) as e:
        entry["error"] = repr(e)
        _log.error("native build failed", library=name, cmd=entry["cmd"], error=repr(e))
        return None
    if proc.returncode != 0:
        entry["error"] = proc.stderr
        _log.error("native build failed", library=name, cmd=entry["cmd"],
                   exit=proc.returncode, stderr=proc.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    entry["ok"] = True
    from livekit_server_tpu_torch.runtime.compile_ledger import LEDGER

    LEDGER.record("g++", so.name, (time.perf_counter() - t0) * 1e3)
    return so


def _refuse(name: str, err: Exception) -> None:
    """Record and log a library that built but cannot be used."""
    build_log.setdefault(name, {"cmd": "", "so": "", "ok": False, "error": ""})
    build_log[name]["ok"] = False
    build_log[name]["error"] = str(err)
    _log.error("native library refused", library=name, error=str(err))


class _NativeRTP:
    def __init__(self, so: Path):
        self.lib = ctypes.CDLL(str(so))
        self.lib.parse_rtp_batch.restype = ctypes.c_int
        self.lib.parse_rtp_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        self.lib.rewrite_rtp_batch.restype = None
        self.lib.rewrite_rtp_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        self.lib.rewrite_rtp_vp8_batch.restype = None
        self.lib.rewrite_rtp_vp8_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        self.lib.gather_ranges.restype = ctypes.c_int64
        self.lib.gather_ranges.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p,
        ]
        self.lib.reorder_slots.restype = ctypes.c_int
        self.lib.reorder_slots.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        self.native = True

    def gather_ranges(self, blob: np.ndarray, starts, lens) -> bytes:
        """bytes(blob[s0:s0+l0] + blob[s1:s1+l1] + ...) in one C call."""
        blob = np.ascontiguousarray(blob, np.uint8)
        starts_c = np.ascontiguousarray(starts, np.int64)
        lens_c = np.ascontiguousarray(lens, np.int64)
        out = np.empty(int(lens_c.sum()), np.uint8)
        n = self.lib.gather_ranges(
            blob.ctypes.data, starts_c.ctypes.data, lens_c.ctypes.data,
            len(starts_c), out.ctypes.data,
        )
        return out[: int(n)].tobytes()

    def reorder_slots(self, count: np.ndarray, fields: dict) -> tuple[int, int, int]:
        """The drain's reorder and dedup in place over a staging set:
        `count` [R, T] int32, `fields` the set's [R, T, K] per-slot arrays
        by name (C-contiguous, 1-, 4- or 8-byte items; `sn`, `layer` and
        `valid` among them). Returns (rows with two or more packets, rows
        permuted, duplicates marked), as `ingest._reorder_dedup_plain`."""
        sn, layer, valid = fields["sn"], fields["layer"], fields["valid"]
        R, T, K = sn.shape
        arrs = list(fields.values())
        if not (all(a.shape == (R, T, K) and a.flags.c_contiguous for a in arrs)
                and sn.dtype == layer.dtype == np.int32 and valid.itemsize == 1):
            raise ValueError("reorder_slots: per-slot arrays must be C-contiguous "
                             "[R, T, K], sn and layer int32, valid one byte")
        count = np.ascontiguousarray(count, np.int32)
        ptrs = np.array([a.ctypes.data for a in arrs], np.uintp)
        widths = np.array([a.itemsize for a in arrs], np.int32)
        out = np.zeros(3, np.int64)
        rc = self.lib.reorder_slots(
            R * T, K, count.ctypes.data, sn.ctypes.data, layer.ctypes.data,
            valid.ctypes.data, len(arrs), ptrs.ctypes.data, widths.ctypes.data,
            out.ctypes.data,
        )
        if rc != 0:
            raise ValueError(f"reorder_slots: item widths {widths.tolist()} not 1, 4 or 8")
        return int(out[0]), int(out[1]), int(out[2])

    def parse_batch(
        self,
        buf: bytes | bytearray,
        offsets: np.ndarray,
        lengths: np.ndarray,
        audio_level_ext: int = 1,
        vp8_pts: set[int] | None = None,
        dd_ext_id: int = 0,
        vp9_pts: set[int] | None = None,
        h264_pts: set[int] | None = None,
    ) -> np.ndarray:
        n = len(offsets)
        out = np.zeros(n, PARSED_DTYPE)
        out["dd_off"] = -1
        out["sid"] = -1

        def pt_mask(pts):
            m = np.zeros(16, np.uint8)
            for pt in pts or ():
                m[pt >> 3] |= 1 << (pt & 7)
            return m

        mask = pt_mask(vp8_pts)
        mask9 = pt_mask(vp9_pts)
        mask264 = pt_mask(h264_pts)
        # A contiguous uint8 ndarray passes zero-copy; anything else pays
        # one copy (the hot rx path always hands the former).
        if (
            isinstance(buf, np.ndarray)
            and buf.dtype == np.uint8
            and buf.flags.c_contiguous
        ):
            b = buf
        else:
            b = np.frombuffer(bytes(buf), np.uint8)
        offs = np.ascontiguousarray(offsets, np.int32)
        lens = np.ascontiguousarray(lengths, np.int32)
        self.lib.parse_rtp_batch(
            b.ctypes.data, offs.ctypes.data, lens.ctypes.data, n,
            audio_level_ext, mask.ctypes.data, out.ctypes.data, dd_ext_id,
            mask9.ctypes.data, mask264.ctypes.data,
        )
        return out

    def rewrite_batch(self, buf: bytearray, offsets, sns, tss, ssrcs) -> None:
        b = np.frombuffer(buf, np.uint8)
        offs = np.ascontiguousarray(offsets, np.int32)
        self.lib.rewrite_rtp_batch(
            b.ctypes.data, offs.ctypes.data, len(offs),
            np.ascontiguousarray(sns, np.uint16).ctypes.data,
            np.ascontiguousarray(tss, np.uint32).ctypes.data,
            np.ascontiguousarray(ssrcs, np.uint32).ctypes.data,
        )

    def rewrite_vp8_batch(
        self, buf: bytearray, offsets, lengths, sns, tss, ssrcs,
        pids, tl0s, keyidxs, vp8_flags,
    ) -> None:
        """Header + VP8 payload-descriptor rewrite (codecmunger/vp8.go:161):
        picture-id (width-preserving 7/15-bit), TL0PICIDX, KEYIDX patched
        in place from the device munger's per-(packet, subscriber) outputs."""
        b = np.frombuffer(buf, np.uint8)
        offs = np.ascontiguousarray(offsets, np.int32)
        self.lib.rewrite_rtp_vp8_batch(
            b.ctypes.data, offs.ctypes.data,
            np.ascontiguousarray(lengths, np.int32).ctypes.data, len(offs),
            np.ascontiguousarray(sns, np.uint16).ctypes.data,
            np.ascontiguousarray(tss, np.uint32).ctypes.data,
            np.ascontiguousarray(ssrcs, np.uint32).ctypes.data,
            np.ascontiguousarray(pids, np.int32).ctypes.data,
            np.ascontiguousarray(tl0s, np.int32).ctypes.data,
            np.ascontiguousarray(keyidxs, np.int32).ctypes.data,
            np.ascontiguousarray(vp8_flags, np.uint8).ctypes.data,
        )


class PythonRTP:
    """Pure-Python fallback with identical output (toolchain-free envs)."""

    native = False

    def parse_batch(self, buf, offsets, lengths, audio_level_ext=1, vp8_pts=None,
                    dd_ext_id=0, vp9_pts=None, h264_pts=None):
        buf = bytes(buf)
        vp8_pts = vp8_pts or set()
        vp9_pts = vp9_pts or set()
        h264_pts = h264_pts or set()
        out = np.zeros(len(offsets), PARSED_DTYPE)
        for i, (off, ln) in enumerate(zip(offsets, lengths)):
            o = out[i]
            o["audio_level"] = 127
            o["picture_id"] = o["tl0picidx"] = o["keyidx"] = -1
            o["payload_len"] = -1
            o["dd_off"] = -1
            o["sid"] = -1
            p = buf[off : off + ln]
            if len(p) < 12 or p[0] >> 6 != 2:
                continue
            cc = p[0] & 0x0F
            has_ext = (p[0] >> 4) & 1
            has_pad = (p[0] >> 5) & 1
            o["marker"] = p[1] >> 7
            o["pt"] = p[1] & 0x7F
            o["sn"] = int.from_bytes(p[2:4], "big")
            o["ts"] = int.from_bytes(p[4:8], "big")
            o["ssrc"] = int.from_bytes(p[8:12], "big")
            q = 12 + cc * 4
            if q > len(p):
                continue
            if has_ext:
                if q + 4 > len(p):
                    continue
                profile = int.from_bytes(p[q : q + 2], "big")
                ext_len = int.from_bytes(p[q + 2 : q + 4], "big") * 4
                ext_off = q + 4
                if ext_off + ext_len > len(p):
                    continue
                if profile == 0xBEDE:
                    j, end = ext_off, ext_off + ext_len
                    while j < end:
                        b0 = p[j]
                        if b0 == 0:
                            j += 1
                            continue
                        eid, elen = b0 >> 4, (b0 & 0x0F) + 1
                        if eid == 15 or j + 1 + elen > end:
                            break
                        if audio_level_ext > 0 and eid == audio_level_ext and elen >= 1:
                            o["voice"] = p[j + 1] >> 7
                            o["audio_level"] = p[j + 1] & 0x7F
                        if dd_ext_id > 0 and eid == dd_ext_id:
                            o["dd_off"] = off + j + 1
                            o["dd_len"] = elen
                        j += 1 + elen
                elif (profile & 0xFFF0) == 0x1000:  # two-byte extensions
                    j, end = ext_off, ext_off + ext_len
                    while j + 1 < end:
                        eid = p[j]
                        if eid == 0:
                            j += 1
                            continue
                        elen = p[j + 1]
                        if j + 2 + elen > end:
                            break
                        if audio_level_ext > 0 and eid == audio_level_ext and elen >= 1:
                            o["voice"] = p[j + 2] >> 7
                            o["audio_level"] = p[j + 2] & 0x7F
                        if dd_ext_id > 0 and eid == dd_ext_id:
                            o["dd_off"] = off + j + 2
                            o["dd_len"] = elen
                        j += 2 + elen
                q = ext_off + ext_len
            pad = p[-1] if has_pad and len(p) > q else 0
            plen = len(p) - q - pad
            if plen < 0:
                continue
            o["payload_off"] = q
            o["payload_len"] = plen
            o["end_frame"] = o["marker"]
            if int(o["pt"]) in vp9_pts and plen >= 1:
                d = p[q : q + plen]
                j = 0
                b0 = d[j]; j += 1
                I, P, L, F = b0 & 0x80, b0 & 0x40, b0 & 0x20, b0 & 0x10
                B, E = b0 & 0x08, b0 & 0x04
                o["begin_pic"] = 1 if B else 0
                o["end_frame"] = 1 if E else 0
                if I:
                    if j >= plen:
                        continue
                    pb = d[j]; j += 1
                    if pb & 0x80:
                        if j >= plen:
                            continue
                        o["picture_id"] = ((pb & 0x7F) << 8) | d[j]; j += 1
                    else:
                        o["picture_id"] = pb & 0x7F
                have_layer = False
                if L:
                    if j >= plen:
                        continue
                    lb = d[j]; j += 1
                    o["tid"] = lb >> 5
                    o["layer_sync"] = (lb >> 4) & 1
                    o["sid"] = (lb >> 1) & 0x07
                    have_layer = True
                    if not F:
                        if j >= plen:
                            continue
                        o["tl0picidx"] = d[j]; j += 1
                if not P and B and (not have_layer or int(o["sid"]) == 0):
                    o["keyframe"] = 1
                if o["keyframe"]:
                    o["layer_sync"] = 1
                continue
            if int(o["pt"]) in h264_pts and plen >= 1:
                d = p[q : q + plen]
                ntype = d[0] & 0x1F
                if 1 <= ntype <= 23:
                    o["begin_pic"] = 1
                    if ntype in (5, 7):
                        o["keyframe"] = 1
                elif ntype == 24:
                    o["begin_pic"] = 1
                    j = 1
                    while j + 2 <= plen:
                        nsz = int.from_bytes(d[j : j + 2], "big")
                        if j + 2 + nsz > plen or nsz < 1:
                            break
                        if d[j + 2] & 0x1F in (5, 7):
                            o["keyframe"] = 1
                        j += 2 + nsz
                elif ntype in (28, 29) and plen >= 2:
                    fu = d[1]
                    start = fu & 0x80
                    o["begin_pic"] = 1 if start else 0
                    if start and (fu & 0x1F) in (5, 7):
                        o["keyframe"] = 1
                if o["keyframe"]:
                    o["layer_sync"] = 1
                continue
            if int(o["pt"]) in vp8_pts and plen >= 1:
                d = p[q : q + plen]
                o["is_vp8"] = 1
                j = 0
                b0 = d[j]; j += 1
                X, S, pid3 = b0 & 0x80, (b0 >> 4) & 1, b0 & 0x07
                o["begin_pic"] = 1 if (S and pid3 == 0) else 0
                bad = False
                if X:
                    if j >= plen:
                        continue
                    xb = d[j]; j += 1
                    if xb & 0x80:  # I
                        if j >= plen:
                            continue
                        pb = d[j]; j += 1
                        if pb & 0x80:
                            if j >= plen:
                                continue
                            o["picture_id"] = ((pb & 0x7F) << 8) | d[j]; j += 1
                        else:
                            o["picture_id"] = pb & 0x7F
                    if xb & 0x40:  # L
                        if j >= plen:
                            continue
                        o["tl0picidx"] = d[j]; j += 1
                    if xb & 0x30:  # T or K
                        if j >= plen:
                            continue
                        tk = d[j]; j += 1
                        o["tid"] = tk >> 6
                        o["layer_sync"] = (tk >> 5) & 1
                        o["keyidx"] = tk & 0x1F
                if o["begin_pic"] and j < plen:
                    o["keyframe"] = 1 if (d[j] & 0x01) == 0 else 0
        return out

    def rewrite_batch(self, buf, offsets, sns, tss, ssrcs):
        for off, sn, ts, ssrc in zip(offsets, sns, tss, ssrcs):
            buf[off + 2 : off + 4] = int(sn).to_bytes(2, "big")
            buf[off + 4 : off + 8] = int(ts).to_bytes(4, "big")
            buf[off + 8 : off + 12] = int(ssrc).to_bytes(4, "big")

    def rewrite_vp8_batch(
        self, buf, offsets, lengths, sns, tss, ssrcs, pids, tl0s, keyidxs, vp8_flags
    ):
        for i, off in enumerate(offsets):
            off, ln = int(off), int(lengths[i])
            if ln < 12:
                continue  # same skip as native: never write past a runt
            buf[off + 2 : off + 4] = int(sns[i]).to_bytes(2, "big")
            buf[off + 4 : off + 8] = int(tss[i]).to_bytes(4, "big")
            buf[off + 8 : off + 12] = int(ssrcs[i]).to_bytes(4, "big")
            if not vp8_flags[i]:
                continue
            p = buf[off : off + ln]
            cc = p[0] & 0x0F
            q = 12 + cc * 4
            if (p[0] >> 4) & 1:  # extension
                if q + 4 > len(p):
                    continue
                q += 4 + int.from_bytes(p[q + 2 : q + 4], "big") * 4
            if q >= len(p):
                continue
            d = off + q  # descriptor start in buf
            b0 = buf[d]
            if not (b0 & 0x80):
                continue
            j = d + 1
            if j >= off + ln:
                continue
            xb = buf[j]
            j += 1
            pid, tl0, kidx = int(pids[i]), int(tl0s[i]), int(keyidxs[i])
            if xb & 0x80:  # I
                if j >= off + ln:
                    continue
                if buf[j] & 0x80:  # 15-bit
                    if j + 1 >= off + ln:
                        continue
                    if pid >= 0:
                        buf[j] = 0x80 | ((pid >> 8) & 0x7F)
                        buf[j + 1] = pid & 0xFF
                    j += 2
                else:
                    if pid >= 0:
                        buf[j] = pid & 0x7F
                    j += 1
            if xb & 0x40:  # L
                if j >= off + ln:
                    continue
                if tl0 >= 0:
                    buf[j] = tl0 & 0xFF
                j += 1
            if xb & 0x30:  # T or K
                if j >= off + ln:
                    continue
                if kidx >= 0:
                    buf[j] = (buf[j] & 0xE0) | (kidx & 0x1F)
                j += 1


def _build_egress() -> Path | None:
    for crypto in LIBCRYPTO_LADDER:
        so = _compile("egress", "egress", ("-pthread", crypto))
        if so is not None:
            return so
    return None


def _check_abi(lib: ctypes.CDLL, symbol: str, want: int, what: str) -> None:
    """Raise OSError unless the library reports the expected ABI version.
    A missing symbol means a pre-versioning build — also a mismatch."""
    try:
        fn = getattr(lib, symbol)
    except AttributeError as e:
        raise OSError(f"{what}: no {symbol} symbol (pre-ABI build)") from e
    fn.restype = ctypes.c_int32
    fn.argtypes = []
    got = int(fn())
    if got != want:
        raise OSError(f"{what}: ABI {got} != expected {want}")


class NativeEgress:
    """One-call-per-tick egress: datagram assembly + VP8 descriptor patch +
    AES-128-GCM seal + sendmmsg, fanned over a few threads (the native
    replacement for the per-packet Python send loop — downtrack.go WriteRTP
    + pion/srtp + pacer socket writes)."""

    SEAL_OVERHEAD = 30  # 14-byte frame header + 16-byte GCM tag

    def __init__(self, so: Path):
        self.lib = ctypes.CDLL(str(so))
        _check_abi(self.lib, "egress_abi_version", EGRESS_ABI, "libegress")
        self.lib.egress_batch_send.restype = ctypes.c_int64
        self.lib.egress_batch_send.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int32]
            + [ctypes.c_void_p] * 24     # pay_off..out_len
            + [ctypes.c_int]             # pace_window_us
        )
        self.lib.egress_plane_send.restype = ctypes.c_int64
        self.lib.egress_plane_send.argtypes = (
            [ctypes.c_int, ctypes.c_int,              # fd, n_shards
             ctypes.c_void_p, ctypes.c_void_p,        # shard_lo, shard_hi
             ctypes.c_void_p, ctypes.c_int32]         # slab, n
            + [ctypes.c_void_p] * 24                  # pay_off..out_len
            + [ctypes.c_void_p, ctypes.c_void_p,      # rooms, grp
               ctypes.c_int32, ctypes.c_int]          # grp_slots, pace_us
            + [ctypes.c_void_p] * 3                   # shard sent/built/ns
        )
        self.lib.egress_express_send.restype = ctypes.c_int64
        self.lib.egress_express_send.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int32]  # fd, slab, n
            + [ctypes.c_void_p] * 24                  # pay_off..out_len
            + [ctypes.c_void_p, ctypes.c_void_p,      # rooms, grp
               ctypes.c_int32, ctypes.c_void_p]       # grp_slots, built_out
        )
        self.lib.egress_pool_ensure.restype = None
        self.lib.egress_pool_ensure.argtypes = [ctypes.c_int]
        self.lib.egress_pool_size.restype = ctypes.c_int32
        self.lib.egress_pool_size.argtypes = []
        self.lib.send_raw.restype = ctypes.c_int64
        self.lib.send_raw.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        self.lib.rx_batch.restype = ctypes.c_int32
        self.lib.rx_batch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32,
        ]
        self.lib.open_batch.restype = None
        self.lib.open_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint8,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        # Exercise the library once so a broken libcrypto link is caught at
        # load time (and the fallback engaged), not on the first media tick.
        self._selftest()

    def _selftest(self) -> None:
        slab = b"\x90\xe0\x80\x01\x02\x20\x00hello"
        out, out_off, out_len, sent = self.send(
            fd=-1, n_threads=1, slab=slab,
            pay_off=np.array([0], np.int64),
            pay_len=np.array([len(slab)], np.int32),
            marker=np.array([1], np.uint8),
            pt=np.array([96], np.uint8),
            vp8=np.array([1], np.uint8),
            sn=np.array([7], np.uint16),
            ts=np.array([9], np.uint32),
            ssrc=np.array([3], np.uint32),
            pid=np.array([5], np.int32),
            tl0=np.array([6], np.int32),
            kidx=np.array([2], np.int32),
            ip=np.array([0x7F000001], np.uint32),
            port=np.array([1], np.uint16),
            seal=np.array([1], np.uint8),
            key_idx=np.array([0], np.int32),
            keys=np.zeros((1, 16), np.uint8),
            key_ids=np.array([42], np.uint32),
            counters=np.array([0], np.uint64),
        )
        frame = bytes(out[: out_len[0]])
        if sent != 1 or frame[0] != 0x01 or len(frame) != 14 + 12 + len(slab) + 16:
            raise OSError("egress self-test failed")
        err = _express_smoke(self)
        if err:
            raise OSError(f"egress express self-test failed: {err}")
        from livekit_server_tpu_torch.runtime.crypto import HAVE_AEAD, MediaCryptoClient

        if not HAVE_AEAD:
            return  # frame shape validated above; no Python AEAD to open with
        inner = MediaCryptoClient(42, bytes(16)).open(frame)
        # VP8 descriptor patched: 15-bit pid=5, tl0=6, keyidx=2 in T/K byte.
        if inner is None or inner[12:19] != bytes(
            [0x90, 0xE0, 0x80, 0x05, 0x06, 0x22, 0x00]
        ):
            raise OSError("egress seal self-test failed")

    def rx_batch(self, fd: int, scratch, offsets, lengths, ips, ports,
                 max_dgram: int = 2048) -> int:
        """Drain a non-blocking UDP socket with recvmmsg into caller-owned
        arrays; returns datagrams received (the batch ingress twin of
        send — one native call per event-loop wake)."""
        return int(self.lib.rx_batch(
            int(fd), scratch.ctypes.data, scratch.nbytes,
            offsets.ctypes.data, lengths.ctypes.data,
            ips.ctypes.data, ports.ctypes.data,
            len(offsets), int(max_dgram),
        ))

    def open_batch(self, blob, offsets, lengths, key_idx, keys,
                   expect_dir: int):
        """Batch-open sealed frames; returns (out, out_off, out_len) with
        out_len[i] = plaintext length or -1 on auth/direction failure."""
        n = len(offsets)
        out_len = np.full(n, -1, np.int32)
        # Plaintext ≤ frame length − 30; lay out at the frame offsets'
        # scale for simplicity (caller slices by out_off/out_len).
        sizes = np.maximum(lengths.astype(np.int64) - 30, 0)
        out_off = np.zeros(n, np.int64)
        np.cumsum(sizes[:-1], out=out_off[1:])
        out = np.zeros(int(sizes.sum()) if n else 0, np.uint8)
        blob_arr = np.frombuffer(blob, np.uint8) if not isinstance(
            blob, np.ndarray
        ) else blob
        # Bind converted arrays to locals: an inline temporary's buffer
        # could be freed before the C call executes.
        offs_c = np.ascontiguousarray(offsets, np.int32)
        lens_c = np.ascontiguousarray(lengths, np.int32)
        kidx_c = np.ascontiguousarray(key_idx, np.int32)
        keys_c = np.ascontiguousarray(keys, np.uint8)
        self.lib.open_batch(
            blob_arr.ctypes.data,
            offs_c.ctypes.data, lens_c.ctypes.data, n,
            kidx_c.ctypes.data, keys_c.ctypes.data,
            int(expect_dir),
            out.ctypes.data, out_off.ctypes.data, out_len.ctypes.data,
        )
        return out, out_off, out_len

    def send(self, fd, n_threads, slab, pay_off, pay_len, marker, pt, vp8,
             sn, ts, ssrc, pid, tl0, kidx, ip, port, seal, key_idx, keys,
             key_ids, counters, ext_blob=b"", ext_off=None, ext_len=None,
             pace_window_us=0):
        """Returns (out, out_off, out_len, sent). With fd < 0 nothing hits
        the network and `out` holds the built frames (tests / TCP path).
        `ext_blob`/`ext_off`/`ext_len` attach pre-serialized RTP header-
        extension sections (profile+length+elements+padding) per entry
        (playout delay, dependency descriptor, …); ext_len 0 = none."""
        n = len(pay_off)
        if ext_off is None:
            ext_off = np.zeros(n, np.int64)
            ext_len = np.zeros(n, np.int32)
        clear_len = 12 + ext_len.astype(np.int64) + pay_len.astype(np.int64)
        out_len = np.where(
            (seal != 0) & (key_idx >= 0), clear_len + self.SEAL_OVERHEAD, clear_len
        ).astype(np.int32)
        out_off = np.zeros(n, np.int64)
        np.cumsum(out_len[:-1], out=out_off[1:])
        out = np.zeros(int(out_off[-1]) + int(out_len[-1]) if n else 0, np.uint8)
        slab_arr = np.frombuffer(slab, np.uint8) if len(slab) else np.zeros(1, np.uint8)
        ext_arr = (
            np.frombuffer(ext_blob, np.uint8) if len(ext_blob)
            else np.zeros(1, np.uint8)
        )

        def c(a, dt):
            return np.ascontiguousarray(a, dt).ctypes.data

        sent = self.lib.egress_batch_send(
            int(fd), int(n_threads), slab_arr.ctypes.data, n,
            c(pay_off, np.int64), c(pay_len, np.int32), c(marker, np.uint8),
            c(pt, np.uint8), c(vp8, np.uint8),
            ext_arr.ctypes.data, c(ext_off, np.int64), c(ext_len, np.int32),
            c(sn, np.uint16),
            c(ts, np.uint32), c(ssrc, np.uint32), c(pid, np.int32),
            c(tl0, np.int32), c(kidx, np.int32), c(ip, np.uint32),
            c(port, np.uint16), c(seal, np.uint8), c(key_idx, np.int32),
            c(np.ascontiguousarray(keys, np.uint8), np.uint8),
            c(key_ids, np.uint32), c(counters, np.uint64),
            out.ctypes.data, out_off.ctypes.data,
            np.ascontiguousarray(out_len).ctypes.data,
            int(pace_window_us),
        )
        return out, out_off, out_len, int(sent)

    def pool_ensure(self, n: int) -> None:
        """Pre-warm the persistent shard worker pool (idempotent)."""
        self.lib.egress_pool_ensure(int(n))

    def pool_size(self) -> int:
        """Worker threads of the process's egress pool (it only grows)."""
        return int(self.lib.egress_pool_size())

    def send_sharded(self, fd, shard_lo, shard_hi, slab, pay_off, pay_len,
                     marker, pt, vp8, sn, ts, ssrc, pid, tl0, kidx, ip,
                     port, seal, key_idx, keys, key_ids, counters, rooms,
                     grp, grp_slots, ext_blob=b"", ext_off=None,
                     ext_len=None, pace_window_us=0):
        """Plane path: entries pre-sorted by (room, sub, track, k) and cut
        into room-aligned shards [shard_lo[i], shard_hi[i]), each run by a
        persistent pool worker (assemble + group-canonical reuse + seal +
        GSO/sendmmsg on its own disjoint out range). `grp[i]` >= 0 names
        the entry's canonical-cache slot (same (track, packet) group),
        -1 forces a direct build; `rooms` scopes slot validity. Returns
        (out, out_off, out_len, sent, shard_sent, shard_built, shard_ns);
        with fd < 0 nothing hits the network and `sent` counts built
        datagrams (tests / build-only mode)."""
        n = len(pay_off)
        n_shards = len(shard_lo)
        if ext_off is None:
            ext_off = np.zeros(n, np.int64)
            ext_len = np.zeros(n, np.int32)
        pay_len_c = np.ascontiguousarray(pay_len, np.int32)
        ext_len_c = np.ascontiguousarray(ext_len, np.int32)
        seal_c = np.ascontiguousarray(seal, np.uint8)
        kix_c = np.ascontiguousarray(key_idx, np.int32)
        clear_len = 12 + ext_len_c.astype(np.int64) + pay_len_c.astype(np.int64)
        out_len = np.where(
            (seal_c != 0) & (kix_c >= 0),
            clear_len + self.SEAL_OVERHEAD, clear_len,
        ).astype(np.int32)
        out_off = np.zeros(n, np.int64)
        np.cumsum(out_len[:-1], out=out_off[1:])
        out = np.zeros(int(out_off[-1]) + int(out_len[-1]) if n else 0, np.uint8)
        slab_arr = (
            np.frombuffer(slab, np.uint8) if not isinstance(slab, np.ndarray)
            else slab
        )
        if not len(slab_arr):
            slab_arr = np.zeros(1, np.uint8)
        ext_arr = (
            np.frombuffer(ext_blob, np.uint8) if len(ext_blob)
            else np.zeros(1, np.uint8)
        )
        shard_sent = np.zeros(n_shards, np.int64)
        shard_built = np.zeros(n_shards, np.int64)
        shard_ns = np.zeros(n_shards, np.int64)
        # Bind every converted array to a keep-list: a temporary's buffer
        # must outlive the C call (see open_batch's same caveat).
        keep = []

        def c(a, dt):
            arr = np.ascontiguousarray(a, dt)
            keep.append(arr)
            return arr.ctypes.data

        sent = self.lib.egress_plane_send(
            int(fd), n_shards, c(shard_lo, np.int64), c(shard_hi, np.int64),
            slab_arr.ctypes.data, n,
            c(pay_off, np.int64), pay_len_c.ctypes.data,
            c(marker, np.uint8), c(pt, np.uint8), c(vp8, np.uint8),
            ext_arr.ctypes.data, c(ext_off, np.int64), ext_len_c.ctypes.data,
            c(sn, np.uint16), c(ts, np.uint32), c(ssrc, np.uint32),
            c(pid, np.int32), c(tl0, np.int32), c(kidx, np.int32),
            c(ip, np.uint32), c(port, np.uint16),
            seal_c.ctypes.data, kix_c.ctypes.data,
            c(keys, np.uint8), c(key_ids, np.uint32), c(counters, np.uint64),
            out.ctypes.data, out_off.ctypes.data, out_len.ctypes.data,
            c(rooms, np.int32), c(grp, np.int32), int(grp_slots),
            int(pace_window_us),
            shard_sent.ctypes.data, shard_built.ctypes.data,
            shard_ns.ctypes.data,
        )
        del keep
        return out, out_off, out_len, int(sent), shard_sent, shard_built, shard_ns

    def send_express(self, fd, slab, pay_off, pay_len, marker, pt, vp8,
                     sn, ts, ssrc, pid, tl0, kidx, ip, port, seal, key_idx,
                     keys, key_ids, counters, ext_blob=b"", ext_off=None,
                     ext_len=None):
        """Express-lane path: assemble+seal(+send) a small batch inline on
        the calling thread — no shard planning, no pool handoff, no
        pacing, every entry built directly (no canonical-group staging).
        Returns (out, out_off, out_len, sent, built); with fd < 0 nothing
        hits the network and `sent` == built."""
        n = len(pay_off)
        if ext_off is None:
            ext_off = np.zeros(n, np.int64)
            ext_len = np.zeros(n, np.int32)
        pay_len_c = np.ascontiguousarray(pay_len, np.int32)
        ext_len_c = np.ascontiguousarray(ext_len, np.int32)
        seal_c = np.ascontiguousarray(seal, np.uint8)
        kix_c = np.ascontiguousarray(key_idx, np.int32)
        clear_len = 12 + ext_len_c.astype(np.int64) + pay_len_c.astype(np.int64)
        out_len = np.where(
            (seal_c != 0) & (kix_c >= 0),
            clear_len + self.SEAL_OVERHEAD, clear_len,
        ).astype(np.int32)
        out_off = np.zeros(n, np.int64)
        np.cumsum(out_len[:-1], out=out_off[1:])
        out = np.zeros(int(out_off[-1]) + int(out_len[-1]) if n else 0, np.uint8)
        slab_arr = (
            np.frombuffer(slab, np.uint8) if not isinstance(slab, np.ndarray)
            else slab
        )
        if not len(slab_arr):
            slab_arr = np.zeros(1, np.uint8)
        ext_arr = (
            np.frombuffer(ext_blob, np.uint8) if len(ext_blob)
            else np.zeros(1, np.uint8)
        )
        built = np.zeros(1, np.int64)
        # Bind every converted array to a keep-list: a temporary's buffer
        # must outlive the C call (see open_batch's same caveat).
        keep = []

        def c(a, dt):
            arr = np.ascontiguousarray(a, dt)
            keep.append(arr)
            return arr.ctypes.data

        sent = self.lib.egress_express_send(
            int(fd), slab_arr.ctypes.data, n,
            c(pay_off, np.int64), pay_len_c.ctypes.data,
            c(marker, np.uint8), c(pt, np.uint8), c(vp8, np.uint8),
            ext_arr.ctypes.data, c(ext_off, np.int64), ext_len_c.ctypes.data,
            c(sn, np.uint16), c(ts, np.uint32), c(ssrc, np.uint32),
            c(pid, np.int32), c(tl0, np.int32), c(kidx, np.int32),
            c(ip, np.uint32), c(port, np.uint16),
            seal_c.ctypes.data, kix_c.ctypes.data,
            c(keys, np.uint8), c(key_ids, np.uint32), c(counters, np.uint64),
            out.ctypes.data, out_off.ctypes.data, out_len.ctypes.data,
            None, None, 0,                            # rooms, grp, grp_slots
            built.ctypes.data,
        )
        del keep
        return out, out_off, out_len, int(sent), int(built[0])


    def send_raw(self, fd, blob, offs, lens, ips, ports) -> int:
        """GSO/sendmmsg pre-built datagrams (blob + per-entry offset/
        length/destination arrays). Load generators and relays use this to
        put wire-ready bytes on the network in a handful of syscalls.
        Returns the datagrams handed to the kernel (0 when fd < 0)."""
        blob_arr = (
            blob if isinstance(blob, np.ndarray)
            else np.frombuffer(blob, np.uint8)
        )
        offs_c = np.ascontiguousarray(offs, np.int64)
        lens_c = np.ascontiguousarray(lens, np.int32)
        ips_c = np.ascontiguousarray(ips, np.uint32)
        ports_c = np.ascontiguousarray(ports, np.uint16)
        return int(self.lib.send_raw(
            int(fd), blob_arr.ctypes.data, len(offs_c),
            offs_c.ctypes.data, lens_c.ctypes.data,
            ips_c.ctypes.data, ports_c.ctypes.data,
        ))


def _express_smoke(eg: "NativeEgress") -> str | None:
    """Exercise egress_express_send build-only and require byte parity
    with the batch path (egress_batch_send) for the same entries (one
    sealed, one clear). Returns a failure string or None; the egress
    library's load-time self-test refuses a library that fails it."""
    slab = b"\x90\xe0\x80\x01\x02\x20\x00express-smoke"
    kw = dict(
        slab=slab,
        pay_off=np.array([0, 0], np.int64),
        pay_len=np.array([len(slab)] * 2, np.int32),
        marker=np.array([1, 1], np.uint8),
        pt=np.array([96, 96], np.uint8),
        vp8=np.array([1, 1], np.uint8),
        sn=np.array([7, 8], np.uint16),
        ts=np.array([9, 9], np.uint32),
        ssrc=np.array([3, 4], np.uint32),
        pid=np.array([5, 5], np.int32),
        tl0=np.array([6, 6], np.int32),
        kidx=np.array([2, 2], np.int32),
        ip=np.array([0x7F000001] * 2, np.uint32),
        port=np.array([1, 1], np.uint16),
        seal=np.array([1, 0], np.uint8),
        key_idx=np.array([0, -1], np.int32),
        keys=np.zeros((1, 16), np.uint8),
        key_ids=np.array([42], np.uint32),
        counters=np.array([0, 0], np.uint64),
    )
    try:
        out_x, off_x, len_x, sent_x, built_x = eg.send_express(fd=-1, **kw)
    except Exception as e:
        return f"send_express crashed: {e!r}"
    if sent_x != 2 or built_x != 2:
        return f"send_express built {built_x}/2"
    out_b, off_b, len_b, _ = eg.send(fd=-1, n_threads=1, **kw)
    if not (np.array_equal(len_x, len_b) and np.array_equal(out_x, out_b)):
        return "send_express output differs from the batch path"
    return None


def _build_munge() -> Path | None:
    return _compile("munge", "munge")


class NativeMunge:
    """One-call-per-tick munge walk: expand bit-packed send/drop/switch
    masks and apply the SN/TS/VP8 rewrites (rtpmunger.go UpdateAndGetSnTs +
    codecmunger/vp8.go UpdateAndGet) with host-owned state — the rewrite
    half of DownTrack.WriteRTP. Semantics pinned to runtime/munge.py's
    numpy spec by tests/test_host_munge.py."""

    def __init__(self, so: Path):
        self.lib = ctypes.CDLL(str(so))
        _check_abi(self.lib, "munge_abi_version", MUNGE_ABI, "libmunge")
        self.lib.munge_walk.restype = ctypes.c_int64
        self.lib.munge_walk.argtypes = (
            [ctypes.c_int32] * 5 + [ctypes.c_void_p] * 11
            + [ctypes.c_void_p] * 13 + [ctypes.c_void_p] * 9
            + [ctypes.c_int64]
        )
        self.lib.munge_walk_multi.restype = ctypes.c_int64
        self.lib.munge_walk_multi.argtypes = (
            [ctypes.c_int32] + [ctypes.c_void_p] * 4   # n_shards, lo/hi/cnt/ns
            + [ctypes.c_int32] * 5 + [ctypes.c_void_p] * 11
            + [ctypes.c_void_p] * 13 + [ctypes.c_void_p] * 9
            + [ctypes.c_int64]
        )

    def walk(self, sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid,
             send_bits, drop_bits, switch_bits, state, cap: int):
        """Returns column arrays (rooms, tracks, ks, subs, sn, ts, pid,
        tl0, keyidx) of the `cap`-bounded walk; None if cap overflowed
        in the counting pre-pass (nothing mutated — caller falls back to
        the dense path). Raises RuntimeError on the -2 invariant code:
        the overflow guard fired mid-walk, AFTER state mutation began, so
        a fallback would re-apply the tick on top of half-advanced
        offsets (double-apply corruption on every walked lane). `state`
        is the HostMunger — its arrays are updated in place."""
        R, T, K = sn.shape
        S = state.sn_offset.shape[-1]
        W = send_bits.shape[-1]
        c32 = lambda x: np.ascontiguousarray(x, np.int32)  # noqa: E731
        cw = lambda x: np.ascontiguousarray(x).view(np.uint32)  # noqa: E731
        cu8 = lambda x: np.ascontiguousarray(x, np.uint8)  # noqa: E731
        sn_c, ts_c, tj_c = c32(sn), c32(ts), c32(ts_jump)
        pid_c, tl0_c, ki_c = c32(pid), c32(tl0), c32(keyidx)
        bp_c, v_c = cu8(begin_pic), cu8(valid)
        sb, db, wb = cw(c32(send_bits)), cw(c32(drop_bits)), cw(c32(switch_bits))
        outs = [np.empty(cap, np.int32) for _ in range(9)]
        st_ptrs = [
            getattr(state, f).ctypes.data for f in (
                "sn_offset", "ts_offset", "last_sn", "last_ts",
                "started", "aligned",
                "pid_offset", "tl0_offset", "ki_offset",
                "last_pid", "last_tl0", "last_ki", "v_started",
            )
        ]
        n = self.lib.munge_walk(
            R, T, K, S, W,
            sb.ctypes.data, db.ctypes.data, wb.ctypes.data,
            sn_c.ctypes.data, ts_c.ctypes.data, tj_c.ctypes.data,
            pid_c.ctypes.data, tl0_c.ctypes.data, ki_c.ctypes.data,
            bp_c.ctypes.data, v_c.ctypes.data,
            *st_ptrs,
            *[o.ctypes.data for o in outs],
            cap,
        )
        if n == -1:
            return None  # pre-pass overflow: state untouched, safe fallback
        if n < -1:
            raise RuntimeError(
                f"munge_walk invariant violation (code {n}): capacity "
                "overflow after state mutation; dense fallback would "
                "double-apply this tick"
            )
        return tuple(o[:n] for o in outs)

    def walk_multi(self, sn, ts, ts_jump, pid, tl0, keyidx, begin_pic,
                   valid, send_bits, drop_bits, switch_bits, state,
                   cap: int, r_lo, r_hi):
        """Sharded walk: each shard owns the contiguous room range
        [r_lo[i], r_hi[i]) — state rows are room-indexed, so whole-room
        ownership keeps every state write disjoint across shards. Output
        is written at exact prefix-sum bases, bit-identical to a single
        walk regardless of shard count. Returns (columns, shard_counts,
        shard_ns) with the same columns as walk(); None on pre-pass
        overflow (nothing mutated); raises on the -2 invariant code."""
        R, T, K = sn.shape
        S = state.sn_offset.shape[-1]
        W = send_bits.shape[-1]
        c32 = lambda x: np.ascontiguousarray(x, np.int32)  # noqa: E731
        cw = lambda x: np.ascontiguousarray(x).view(np.uint32)  # noqa: E731
        cu8 = lambda x: np.ascontiguousarray(x, np.uint8)  # noqa: E731
        lo_c, hi_c = c32(r_lo), c32(r_hi)
        n_shards = len(lo_c)
        shard_counts = np.zeros(n_shards, np.int64)
        shard_ns = np.zeros(n_shards, np.int64)
        sn_c, ts_c, tj_c = c32(sn), c32(ts), c32(ts_jump)
        pid_c, tl0_c, ki_c = c32(pid), c32(tl0), c32(keyidx)
        bp_c, v_c = cu8(begin_pic), cu8(valid)
        sb, db, wb = cw(c32(send_bits)), cw(c32(drop_bits)), cw(c32(switch_bits))
        outs = [np.empty(cap, np.int32) for _ in range(9)]
        st_ptrs = [
            getattr(state, f).ctypes.data for f in (
                "sn_offset", "ts_offset", "last_sn", "last_ts",
                "started", "aligned",
                "pid_offset", "tl0_offset", "ki_offset",
                "last_pid", "last_tl0", "last_ki", "v_started",
            )
        ]
        n = self.lib.munge_walk_multi(
            n_shards, lo_c.ctypes.data, hi_c.ctypes.data,
            shard_counts.ctypes.data, shard_ns.ctypes.data,
            R, T, K, S, W,
            sb.ctypes.data, db.ctypes.data, wb.ctypes.data,
            sn_c.ctypes.data, ts_c.ctypes.data, tj_c.ctypes.data,
            pid_c.ctypes.data, tl0_c.ctypes.data, ki_c.ctypes.data,
            bp_c.ctypes.data, v_c.ctypes.data,
            *st_ptrs,
            *[o.ctypes.data for o in outs],
            cap,
        )
        if n == -1:
            return None  # pre-pass overflow: state untouched, safe fallback
        if n < -1:
            raise RuntimeError(
                f"munge_walk_multi invariant violation (code {n}): "
                "capacity overflow after state mutation; dense fallback "
                "would double-apply this tick"
            )
        return tuple(o[:n] for o in outs), shard_counts, shard_ns


def _load_rtp():
    so = _compile("rtp_parser", "rtp")
    if so is not None:
        try:
            return _NativeRTP(so)
        except OSError as e:
            _refuse("rtp", e)
    return PythonRTP()


def _load_versioned(build, cls, name):
    so = build()
    if so is None:
        return None
    try:
        return cls(so)
    except OSError as e:
        _refuse(name, e)
        return None


def native_smoke() -> list[str]:
    """Strict build and ABI check of every native library: build each
    from its source (or reuse the digest-keyed build), load it, check its
    ABI version and run its self-tests (the egress library's includes the
    express path's byte parity). Returns the problems, [] when all three
    are healthy. Unlike the loaders behind `rtp`, `egress` and `munge`,
    this falls back to nothing: a library that does not load is a
    problem here, not a slower path."""
    failures: list[str] = []
    so = _compile("rtp_parser", "rtp")
    if so is None:
        failures.append("rtp_parser: build failed")
    else:
        try:
            _NativeRTP(so)
        except OSError as e:
            failures.append(f"rtp_parser: {e}")
    for name, build, cls in (("egress", _build_egress, NativeEgress),
                             ("munge", _build_munge, NativeMunge)):
        so = build()
        if so is None:
            failures.append(f"{name}: build failed")
            continue
        try:
            cls(so)
        except OSError as e:
            failures.append(f"{name}: {e}")
    return failures


_LOADERS = {
    "rtp": _load_rtp,
    "egress": lambda: _load_versioned(_build_egress, NativeEgress, "egress"),
    "munge": lambda: _load_versioned(_build_munge, NativeMunge, "munge"),
}
_load_lock = threading.Lock()


def __getattr__(name: str):
    """`rtp`, `egress` and `munge` build and load on first access."""
    if name not in _LOADERS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    with _load_lock:
        if name not in globals():
            globals()[name] = _LOADERS[name]()
    return globals()[name]


def loaded_library(stem: str = "libcrypto") -> str:
    """The file of the shared library `stem` (libcrypto unless told
    otherwise) this process has mapped ('' if none)."""
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.split()[-1]
                if stem in os.path.basename(path):
                    return path
    except OSError:
        pass
    return ""


def status() -> dict:
    """Which native libraries loaded, how each was built, and the
    libcrypto the process mapped (loads all three)."""
    rtp_lib = __getattr__("rtp")
    loaded = {
        "rtp": bool(getattr(rtp_lib, "native", False)),
        "egress": __getattr__("egress") is not None,
        "munge": __getattr__("munge") is not None,
    }
    return {
        "loaded": loaded,
        "builds": {k: dict(v) for k, v in build_log.items()},
        "libcrypto": loaded_library(),
    }
