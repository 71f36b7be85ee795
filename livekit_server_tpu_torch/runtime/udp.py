"""UDP media transport: plain RTP in, rewritten RTP out.

Reference parity: the reference's media path is Pion WebRTC over
ICE/DTLS/SRTP on the UDP mux (pkg/rtc/config.go UDPMux, rtcconfig). This
build's native path is deliberately simpler wire-wise — plain RTP over
UDP with SSRC-based session binding (the `add_track` signal response
carries the SSRC the server assigned; E2EE payloads pass through
untouched, matching the reference's encryption passthrough stance) — but
occupies the same architectural seat: socket → native batch parse
(livekit_server_tpu_torch.native.rtp) → IngestBuffer, and egress →
native header rewrite → socket.

A client's source address latches on first packet per SSRC (ICE-lite-ish
latching, like the reference's UDP mux address learning).

Port of the JAX package's runtime/udp.py. The native libraries load on
first use (livekit_server_tpu_torch.native). `attach_express` binds the
express lane (runtime/express.py) and `_send_express` carries its sends;
`relay_info` is set by the room manager when the media relay
(runtime/relay.py) runs. `enable_gateway` attaches the standards-lane
WebRTC gateway (runtime/webrtc_gateway.py). `enable_audio_mixer`, the
hook of a subsystem the port does not carry, raises an error naming its
ROADMAP item (the MCU mixer, A8).
"""

from __future__ import annotations

import asyncio
import secrets
import time
from dataclasses import dataclass

import numpy as np

from livekit_server_tpu_torch import native
from livekit_server_tpu_torch.ops.pacer import WIRE_OVERHEAD_BYTES
from livekit_server_tpu_torch.runtime import crypto as _crypto

# ops/pacer (a device-ops module that must not import host runtime code)
# hardcodes the per-packet wire overhead; pin it to the real frame layout
# here so a crypto-header change cannot silently drift the pacer budgets.
# Explicit raise, not assert: the tripwire must survive `python -O`.
if WIRE_OVERHEAD_BYTES != _crypto.HEADER_LEN + 16 + 12:
    raise ImportError(
        "ops/pacer.WIRE_OVERHEAD_BYTES out of sync with sealed-frame layout"
    )
from livekit_server_tpu_torch.runtime.crypto import (
    DIR_C2S,
    MAGIC as CRYPTO_MAGIC,
    MediaCryptoRegistry,
    MediaCryptoSession,
    parse_key_id,
)
from livekit_server_tpu_torch.runtime.ingest import IngestBuffer

VP8_PT = 96
OPUS_PT = 111
RED_PT = 63           # RFC 2198 redundancy for Opus (redreceiver.go seat)
AUDIO_LEVEL_EXT_ID = 1
PLAYOUT_DELAY_EXT_ID = 6  # one-byte ext id for playout-delay (playoutdelay.go)
DD_EXT_ID = 8             # dependency-descriptor ext id (sfu/dependencydescriptor)
SVC_PT = 98               # single-stream SVC VP9 (picture-header parse + DD)
AV1_PT = 99               # single-stream SVC AV1 (DD only — an AV1 payload
                          # must never hit the VP9 descriptor branch: its
                          # aggregation header would misparse as frame bits)
H264_PT = 100             # H264 (RFC 6184) — keyframes from NALU types

# Subscriber address punch: a client proves it owns the address it wants
# media sent to by sending this magic + its 32-bit punch id from that
# socket (the ICE-connectivity-check analog; a client-supplied address in
# a signal message is never trusted — traffic-reflection hardening).
PUNCH_REQ = b"LKPUNCH0"
PUNCH_ACK = b"LKPUNCH1"
# Sentinel for "SSRC has no latched address yet" in the vectorized rx
# path; outside both the IPv4 code space (≥ 0) and the synthetic negative
# codes (small negatives).
_NO_LATCH = -(1 << 62)

# RTCP payload types (rtcp-mux demux range per RFC 5761: byte1 in 192-223).
RTCP_SR = 200
RTCP_RR = 201
RTCP_RTPFB = 205   # FMT 1 = generic NACK, FMT 15 = transport-wide feedback
TWCC_FMT = 15
# Send-time ring depth per (room, sub): must cover the feedback RTT's worth
# of outstanding sealed sends (~300 pps × 200 ms ≈ 60; power of two).
TWCC_RING = 256
RTCP_PSFB = 206    # FMT 1 = PLI, FMT 15 = REMB (application layer feedback)
PLI_THROTTLE_MS = 500.0  # min spacing of upstream keyframe requests per
                         # track (pliThrottle — sfu/buffer config default)
# Probe padding payload: a maximal RTP pad run — 254 zeros + the count
# byte (255) that RFC 3550 §5.1 puts last when the P bit is set.
PAD_RUN = bytes(254) + b"\xff"


class ForwardLatencyProbe:
    """Wall-clock packet-in → wire-out latency histogram.

    The reference's implicit forwarding-latency spec is per-packet and
    measured on the wire (a packet enters `buffer.Buffer.Write` and leaves
    at the pacer's socket write). Here every media datagram is stamped
    when its receive batch returns from recvmmsg (rx_batch →
    IngestBuffer.t_arr) and observed when the native egress send returns —
    so the recorded latency INCLUDES tick-queueing wait, staging, the
    device step, and the kernel send, with no composed/estimated terms.

    Log-spaced bins, vectorized updates (one searchsorted+bincount per
    tick); cheap enough to stay always-on and feed /debug."""

    N_BINS = 96

    def __init__(self, lo_s: float = 5e-5, hi_s: float = 60.0):
        import threading

        self.edges = np.logspace(np.log10(lo_s), np.log10(hi_s), self.N_BINS)
        self.counts = np.zeros(self.N_BINS + 1, np.int64)
        self.n = 0
        self.sum_s = 0.0
        self.max_s = 0.0
        # Observations can come from the event loop AND the pacer worker
        # thread (paced sends run do_send off-loop); numpy += is not
        # atomic, so histogram updates serialize here. One uncontended
        # acquire per tick — noise next to the send itself.
        self._lock = threading.Lock()

    def observe(self, lat_s: np.ndarray) -> None:
        if lat_s.size == 0:
            return
        binned = np.bincount(
            np.searchsorted(self.edges, lat_s), minlength=self.N_BINS + 1
        )
        with self._lock:
            self.counts += binned
            self.n += int(lat_s.size)
            self.sum_s += float(lat_s.sum())
            m = float(lat_s.max())
            if m > self.max_s:
                self.max_s = m

    def _quantile_from(self, counts, n: int, max_s: float, q: float) -> float:
        if n == 0:
            return 0.0
        cum = np.cumsum(counts)
        b = int(np.searchsorted(cum, q * n))
        if b >= self.N_BINS:
            # Overflow bin (beyond the 60 s top edge): the exact maximum is
            # a tighter answer than the collapsed last-edge value.
            return max_s
        return float(self.edges[b])

    def quantile(self, q: float) -> float:
        """Approximate quantile in seconds (upper edge of the q-bin)."""
        with self._lock:
            counts, n, max_s = self.counts.copy(), self.n, self.max_s
        return self._quantile_from(counts, n, max_s, q)

    def reset(self) -> None:
        with self._lock:
            self.counts[:] = 0
            self.n = 0
            self.sum_s = 0.0
            self.max_s = 0.0

    def summary(self) -> dict:
        # Snapshot under the lock: the pacer worker mutates these fields
        # concurrently and /debug must not read torn stats.
        with self._lock:
            counts = self.counts.copy()
            n, sum_s, max_s = self.n, self.sum_s, self.max_s
        return {
            "n": n,
            "mean_ms": round(sum_s / n * 1000.0, 3) if n else 0.0,
            "p50_ms": round(self._quantile_from(counts, n, max_s, 0.50) * 1000.0, 3),
            "p90_ms": round(self._quantile_from(counts, n, max_s, 0.90) * 1000.0, 3),
            "p99_ms": round(self._quantile_from(counts, n, max_s, 0.99) * 1000.0, 3),
            "p999_ms": round(self._quantile_from(counts, n, max_s, 0.999) * 1000.0, 3),
            "max_ms": round(max_s * 1000.0, 3),
        }


def _red_primary(blob: bytes, start: int, length: int) -> tuple[int, int]:
    """RFC 2198 walk: (absolute offset, length) of the primary block's
    payload, or (-1, -1) if malformed (redprimaryreceiver.go decap)."""
    end = start + length
    q = start
    blocks = 0
    while q < end and blob[q] & 0x80:
        if q + 4 > end:
            return -1, -1
        blocks += ((blob[q + 2] & 0x03) << 8) | blob[q + 3]
        q += 4
    if q >= end:
        return -1, -1
    q += 1  # primary's 1-byte header (F=0 | PT)
    data_off = q + blocks
    if data_off > end:
        return -1, -1
    return data_off, end - data_off


def build_nack(sender_ssrc: int, media_ssrc: int, sns) -> bytes:
    """Generic NACK (RFC 4585 §6.2.1): (PID, BLP) pairs from a SN list."""
    sns = sorted(set(s & 0xFFFF for s in sns))
    fci = bytearray()
    i = 0
    while i < len(sns):
        pid = sns[i]
        blp = 0
        j = i + 1
        while j < len(sns) and 0 < ((sns[j] - pid) & 0xFFFF) <= 16:
            blp |= 1 << (((sns[j] - pid) & 0xFFFF) - 1)
            j += 1
        fci += pid.to_bytes(2, "big") + blp.to_bytes(2, "big")
        i = j
    length_words = 2 + len(fci) // 4
    return (
        bytes([0x80 | 1, RTCP_RTPFB])
        + length_words.to_bytes(2, "big")
        + sender_ssrc.to_bytes(4, "big")
        + media_ssrc.to_bytes(4, "big")
        + bytes(fci)
    )


def build_twcc_feedback(
    sender_ssrc: int, media_ssrc: int, entries: list[tuple[int, int]]
) -> bytes:
    """Transport-wide feedback (RTPFB fmt 15 seat, own-wire FCI): the
    client acks sealed-frame counters with its receive timestamps.

        FCI = base_ctr(8) | base_recv_us(8) | n(2) | pad(2)
              | n × (ctr_off u16 | recv_delta_us i32)

    `entries` = [(counter, recv_time_us), ...]; counters within a frame
    must span < 65536 and deltas < ±2147 s (split frames otherwise)."""
    if not entries:
        return b""
    base_ctr = min(c for c, _ in entries)
    base_us = min(u for _, u in entries)
    fci = bytearray(
        base_ctr.to_bytes(8, "big")
        + base_us.to_bytes(8, "big")
        + len(entries).to_bytes(2, "big")
        + b"\x00\x00"
    )
    for c, u in entries:
        fci += (c - base_ctr).to_bytes(2, "big")
        fci += (u - base_us).to_bytes(4, "big", signed=True)
    if len(fci) % 4:
        fci += bytes(4 - len(fci) % 4)
    length_words = 2 + len(fci) // 4
    return (
        bytes([0x80 | TWCC_FMT, RTCP_RTPFB])
        + length_words.to_bytes(2, "big")
        + sender_ssrc.to_bytes(4, "big")
        + media_ssrc.to_bytes(4, "big")
        + bytes(fci)
    )


_TWCC_ENTRY = np.dtype([("off", ">u2"), ("delta", ">i4")])


def parse_nack_fci(fci: bytes) -> list[int]:
    sns = []
    for i in range(0, len(fci) - 3, 4):
        pid = int.from_bytes(fci[i : i + 2], "big")
        blp = int.from_bytes(fci[i + 2 : i + 4], "big")
        sns.append(pid)
        for b in range(16):
            if blp & (1 << b):
                sns.append((pid + b + 1) & 0xFFFF)
    return sns


def ntp_now() -> int:
    """64-bit NTP timestamp (RFC 3550 SR wallclock)."""
    t = time.time() + 2208988800.0  # Unix → NTP epoch (1900)
    sec = int(t)
    frac = int((t - sec) * (1 << 32)) & 0xFFFFFFFF
    return ((sec & 0xFFFFFFFF) << 32) | frac


def ntp_mid32(ntp64: int) -> int:
    """Middle 32 bits of an NTP timestamp (the RR LSR/DLSR unit)."""
    return (ntp64 >> 16) & 0xFFFFFFFF


def build_sr(ssrc: int, ntp64: int, rtp_ts: int, pkts: int, octets: int) -> bytes:
    """Sender report, no report blocks (RFC 3550 §6.4.1)."""
    return (
        bytes([0x80, RTCP_SR, 0, 6])
        + (ssrc & 0xFFFFFFFF).to_bytes(4, "big")
        + ntp64.to_bytes(8, "big")
        + (rtp_ts & 0xFFFFFFFF).to_bytes(4, "big")
        + (pkts & 0xFFFFFFFF).to_bytes(4, "big")
        + (octets & 0xFFFFFFFF).to_bytes(4, "big")
    )


def parse_sr(chunk: bytes):
    """SR → (ssrc, ntp64, rtp_ts); None if truncated."""
    if len(chunk) < 28:
        return None
    return (
        int.from_bytes(chunk[4:8], "big"),
        int.from_bytes(chunk[8:16], "big"),
        int.from_bytes(chunk[16:20], "big"),
    )


def build_ext_section(exts: list[tuple[int, bytes]]) -> bytes:
    """Serialize an RTP header-extension section (RFC 8285): one-byte
    profile when every element fits, two-byte otherwise (DD structures
    exceed the one-byte form's 16-byte cap on keyframes)."""
    two_byte = any(len(d) > 16 or len(d) == 0 or i > 14 for i, d in exts)
    body = bytearray()
    if two_byte:
        profile = 0x1000
        for i, d in exts:
            body += bytes([i, len(d)]) + d
    else:
        profile = 0xBEDE
        for i, d in exts:
            body += bytes([(i << 4) | (len(d) - 1)]) + d
    body += bytes((-len(body)) % 4)
    return (
        profile.to_bytes(2, "big")
        + (len(body) // 4).to_bytes(2, "big")
        + bytes(body)
    )


def build_rr(sender_ssrc: int, media_ssrc: int, fraction_lost: int) -> bytes:
    """Receiver report with one block carrying only fraction_lost (the
    upstream loss signal of medialossproxy.go → buffer
    SetLastFractionLostReport: publishers enable Opus FEC on it)."""
    block = (
        (media_ssrc & 0xFFFFFFFF).to_bytes(4, "big")
        + bytes([fraction_lost & 0xFF])
        + b"\x00" * 19
    )
    return (
        bytes([0x80 | 1, RTCP_RR, 0, 7])
        + (sender_ssrc & 0xFFFFFFFF).to_bytes(4, "big")
        + block
    )


def build_pli(sender_ssrc: int, media_ssrc: int) -> bytes:
    return (
        bytes([0x80 | 1, RTCP_PSFB, 0, 2])
        + sender_ssrc.to_bytes(4, "big")
        + media_ssrc.to_bytes(4, "big")
    )


def build_remb(sender_ssrc: int, bitrate_bps: float, media_ssrcs) -> bytes:
    """REMB (draft-alvestrand-rmcat-remb): exp/mantissa bitrate + SSRC list."""
    bitrate = max(0, int(bitrate_bps))
    exp = 0
    while bitrate >= (1 << 18):
        bitrate >>= 1
        exp += 1
    fci = (
        b"REMB"
        + bytes([len(media_ssrcs)])
        + ((exp << 18) | bitrate).to_bytes(3, "big")
        + b"".join(s.to_bytes(4, "big") for s in media_ssrcs)
    )
    length_words = 2 + len(fci) // 4
    return (
        bytes([0x80 | 15, RTCP_PSFB])
        + length_words.to_bytes(2, "big")
        + sender_ssrc.to_bytes(4, "big")
        + (0).to_bytes(4, "big")
        + fci
    )


def parse_remb(fci: bytes) -> tuple[float, list[int]]:
    if fci[:4] != b"REMB" or len(fci) < 8:
        return 0.0, []
    n = fci[4]
    raw = int.from_bytes(fci[5:8], "big")
    bitrate = float((raw & 0x3FFFF) << (raw >> 18))
    ssrcs = [
        int.from_bytes(fci[8 + 4 * i : 12 + 4 * i], "big")
        for i in range(n)
        if 12 + 4 * i <= len(fci)
    ]
    return bitrate, ssrcs


@dataclass
class SSRCBinding:
    room: int            # room row
    track: int           # track col
    is_video: bool
    layer: int = 0       # simulcast spatial layer carried by this SSRC
    session: MediaCryptoSession | None = None  # publisher's crypto session
    svc: bool = False    # single-stream SVC (VP9/AV1): layers ride the
                         # dependency-descriptor extension, not SSRCs


class UDPMediaTransport(asyncio.DatagramProtocol):
    """One socket for the whole node (the reference's single-port UDPMux)."""

    def __init__(
        self,
        ingest: IngestBuffer,
        crypto: MediaCryptoRegistry | None = None,
        require_encryption: bool = False,
        nack_resolver=None,
    ):
        self.ingest = ingest
        # NACK → replay-packet resolver (PlaneRuntime.resolve_nacks);
        # None = RTX disabled (bare-ingest tooling/tests).
        self.nack_resolver = nack_resolver
        # Standards-lane WebRTC gateway (ICE-lite + DTLS-SRTP); created on
        # demand by enable_gateway() — the sealed lane needs none of it.
        self.gateway = None
        # MCU seat (runtime/mixer.py in the JAX package): not carried by
        # the port, so always None (enable_audio_mixer raises).
        self.audio_mixer = None
        # AEAD media-wire crypto (runtime/crypto.py — the DTLS-SRTP seat).
        # require_encryption drops every plaintext RTP/RTCP/punch datagram;
        # False keeps the legacy cleartext path for in-process tooling.
        self.crypto = crypto
        self.require_encryption = require_encryption
        self.sub_sessions: dict[tuple, MediaCryptoSession] = {}  # (room,sub)→session
        self.tcp_sinks: dict[int, object] = {}  # key_id → TCP frame writer
        self.transport: asyncio.DatagramTransport | None = None
        self.bindings: dict[int, SSRCBinding] = {}       # ssrc → coords
        self.addrs: dict[int, tuple] = {}                # ssrc → latched addr
        # Integer address identities for the vectorized rx path: IPv4
        # addresses code as (ip << 16) | port; anything else (IPv6 via the
        # asyncio endpoint) gets a synthetic negative code. Latch
        # comparisons then run as one numpy equality over the batch
        # instead of tuple hashing per packet.
        self._addr_code: dict[int, int] = {}    # ssrc → latched addr code
        self._tuple_code: dict[tuple, int] = {} # addr tuple → code
        self._code_tuple: dict[int, tuple] = {} # code → addr tuple
        self._syn_code = -2
        self.sub_addrs: dict[tuple, tuple] = {}          # (room,sub) → addr
        self.sub_ssrc: dict[tuple, dict[int, int]] = {}  # (room,sub) → {track: ssrc}
        self.track_kind: dict[tuple, bool] = {}          # (room,track) → is_video
        self.punch_ids: dict[int, list] = {}             # punch id → [key, latched_addr|None]
        self._punch_by_sub: dict[tuple, int] = {}        # (room,sub) → punch id
        self._rx_pending: list[tuple[bytes, tuple]] = []
        self._rx_scheduled = False
        self.egress_rev: dict[int, tuple] = {}           # downtrack ssrc → (room,sub,track)
        self.node_ssrc = secrets.randbits(32)            # our RTCP sender SSRC
        # Upstream loss detection (buffer.go doNACKs): per publisher SSRC.
        self._rx_hi: dict[int, int] = {}                 # ssrc → highest ext SN
        self._rx_missing: dict[int, dict[int, list]] = {}  # ssrc → {sn: [tries, due_ms]}
        self.on_pli = None                               # cb(room, track) for non-UDP publishers
        # Egress SR bookkeeping: per downtrack SSRC [pkts, octets, last_ts];
        # LSR echo table for RR → RTT (RFC 3550 A.8).
        self._tx_sr: dict[int, list] = {}
        self._sr_sent: dict[int, list] = {}              # ssrc → recent SR mid32s
        self._last_sr_ms = 0.0
        # Publisher-side SR state: upstream ssrc → (ntp64, rtp_ts) — the
        # cross-layer timestamp anchor (forwarder.go processSourceSwitch).
        # _ts_delta[(room, track, layer)] = layer's RTP-TS offset relative
        # to layer 0 at a common wallclock instant; ingest subtracts it so
        # every simulcast layer rides ONE timeline and the device munger
        # needs no TS re-anchor at a source switch.
        self.pub_sr: dict[int, tuple[int, int]] = {}
        self._ts_delta: dict[tuple, int] = {}
        self._last_pli_ms: dict[tuple, float] = {}       # (room,track) → throttle
        # Vectorized egress mirrors (the batch path reads arrays, not
        # dicts): per-(room, sub, track) downtrack SSRC, per-(room, track)
        # payload type, and SR accumulators folded at SR cadence.
        dims = ingest.dims
        R, T, S = dims.rooms, dims.tracks, dims.subs
        self._egress_ssrc_arr = np.zeros((R, S, T), np.uint32)
        self._track_pt = np.full((R, T), OPUS_PT, np.uint8)
        self._track_is_video = np.zeros((R, T), bool)
        self._track_svc = np.zeros((R, T), bool)
        # Persistent per-(room, sub) destination/session arrays: the batch
        # egress reads these with pure numpy gathers (no per-tick Python
        # loop over subscribers — the loop would scale with subscriber
        # count at north-star shapes). Resynced from the dicts only when
        # subscription state changes (`_subs_rev` bump or dict-length
        # drift from out-of-band writers like tests/bench).
        self._sub_ip = np.zeros((R, S), np.uint32)
        self._sub_port = np.zeros((R, S), np.uint16)
        self._sub_tcp = np.zeros((R, S), bool)
        self._sub_red_arr = np.zeros((R, S), bool)
        self._sub_sess_idx = np.full((R, S), -1, np.int32)
        self._sessions: list = []
        self._sess_keys = np.zeros((0, 16), np.uint8)
        self._sess_keyids = np.zeros(0, np.uint32)
        self._sess_active = np.zeros(0, np.uint8)
        self._sess_ctr = np.zeros(0, np.uint64)
        self._subs_rev = 0
        self._subs_synced = (-1, -1, -1)  # (rev, len(sub_addrs), len(sub_sessions))
        self._txsr_pkts = np.zeros((R, S, T), np.int64)
        self._txsr_oct = np.zeros((R, S, T), np.int64)
        self._txsr_ts = np.zeros((R, S, T), np.uint32)
        self._txsr_ms = np.zeros((R, S, T), np.float64)
        # TWCC send-time rings (pkg/rtc/transport.go:253-374 seat): the
        # sealed-frame counter IS the transport-wide sequence number; the
        # client acks (counter, recv_time) pairs and the host matches them
        # here to produce the delay/rate samples ops/bwe's send-side
        # estimator consumes. Sealed-path flows only — cleartext frames
        # carry no counter (those subs keep the estimate-driven budget).
        self._twcc_ms = np.zeros((R, S, TWCC_RING), np.float64)
        self._twcc_ctr = np.full((R, S, TWCC_RING), -1, np.int64)
        self._twcc_len = np.zeros((R, S, TWCC_RING), np.int32)
        # Cumulative per-(room, sub) send counters (never reset — the SR
        # accumulators fold away at SR cadence): window deltas over these
        # are the per-participant egress rates
        # (participant_traffic_load.go seat).
        self.tx_pkts = np.zeros((R, S), np.int64)
        self.tx_bytes = np.zeros((R, S), np.int64)
        # Last acked (ctr, send, recv) per sub: delay deltas must span
        # feedback-frame boundaries or one-ack-per-frame cadences would
        # never produce a delay-variation sample at all.
        self._twcc_last_ctr = np.full((R, S), -1, np.int64)
        self._twcc_last_send = np.zeros((R, S), np.float64)
        self._twcc_last_recv = np.zeros((R, S), np.float64)
        self.egress_threads = 4
        # Sharded egress orchestrator (runtime/egress_plane.py). Attached
        # by the room manager after PlaneRuntime construction; when set,
        # send_egress_batch routes through the native sharded fan-out
        # (egress_plane_send) instead of the flat n_threads pool.
        self._egress_plane = None
        # Always-on packet-in→wire-out latency histogram (stamps: rx_batch
        # return → native egress send return; includes tick-queue wait).
        self.fwd_latency = ForwardLatencyProbe()
        # Express-lane twin: arrival-driven sends skip the tick queue, so
        # their latency distribution answers a different question (decide
        # + munge + seal cost); kept separate or the batched tail would
        # bury the express p99 (and vice versa).
        self.fwd_latency_express = ForwardLatencyProbe()
        # Sampled wire-latency stage decomposer (runtime/trace.py
        # LatencyAttribution); attached by the server/bench alongside the
        # egress plane. None = no per-stage attribution.
        self.wire_stages = None
        # Media-relay advertisement (host, port, secret, ttl_s) for the
        # request_relay signal, set when the embedded relay runs.
        self.relay_info = None
        # config rtc.congestion_control.send_side_bwe — set ONCE at
        # startup (before any subscriber registers): flipping it later
        # does not refresh already-registered subscribers' fb_enabled
        # entries (the gate is evaluated on bind/register/punch events).
        self.send_side_bwe = True
        # RED (RFC 2198) opt-in per subscriber + per-(room, audio track)
        # ring of recent primary payloads (the byte half of the device's
        # encode plan; redreceiver.go).
        self.sub_red: set[tuple] = set()
        self._red_ring: dict[tuple, object] = {}
        # Playout-delay header extension on video egress
        # (rtpextension/playoutdelay.go): (min_ms, max_ms) or None.
        self.playout_delay: tuple[int, int] | None = None
        # Pacer window (pkg/sfu/pacer "no-queue"): spread a tick's
        # sendmmsg chunks across this many ms; 0 = burst. Paced sends
        # run on a dedicated worker thread (they sleep).
        self.pacer_spread_ms: float = 0.0
        # Leaky-bucket pacing (pkg/sfu/pacer leaky_bucket.go:47-200 seat):
        # per-(room, sub) byte budgets computed by the device pacer op;
        # over-budget UDP entries defer FIFO to later ticks (bounded).
        self.pacer_mode: str = ""
        self._pacer_queue: list = []
        self._pace_pool = None
        self._pace_pending = None
        # Media-loss proxy (medialossproxy.go): max subscriber-reported
        # fraction_lost per audio track, relayed upstream ~1/s so the
        # publisher's Opus encoder can enable FEC.
        self._down_frac_lost: dict[tuple, int] = {}  # (room, track) → byte
        # SVC (VP9/AV1) dependency-descriptor state: per-track structure
        # cache (structures ride keyframes only; runtime/dd.py parses) —
        # packets between keyframes resolve layers via the cached table.
        self._svc_tracks: set[tuple] = set()
        # (room, track) → [(version, Structure), ...] (last 2 kept):
        # staged packets are stamped with the version they were parsed
        # under, so egress patching one tick later never mixes an old
        # packet with a newer structure's field widths.
        self._dd_structs: dict[tuple, list] = {}
        self.stats = {
            "rx": 0, "tx": 0, "unknown_ssrc": 0, "parse_errors": 0,
            "addr_mismatch": 0, "bad_punch": 0,
            "rtcp_rx": 0, "rtcp_bad": 0, "nacks_rx": 0, "nacks_tx": 0,
            "plis_rx": 0, "plis_tx": 0, "rtx_tx": 0,
            "bad_frame": 0, "plaintext_drop": 0, "session_mismatch": 0,
        }

    # -- control-plane API ------------------------------------------------
    def _new_ssrc(self) -> int:
        """Random 32-bit SSRC (unguessable — a sequential counter would let
        an off-path sender inject media into live tracks)."""
        while True:
            ssrc = secrets.randbits(32) | 0x10000
            if ssrc not in self.bindings:
                return ssrc

    def assign_ssrc(
        self, room: int, track: int, is_video: bool, layer: int = 0,
        session: MediaCryptoSession | None = None, svc: bool = False,
        mime: str = "",
    ) -> int:
        """Bind a fresh SSRC to one (track, simulcast layer); sent back in
        signal. Simulcast publishers get one SSRC per layer, matching the
        reference's per-layer SSRCs (mediatrack.go layer SSRC bookkeeping).
        `session` pins the SSRC to its publisher's crypto session: media
        sealed under any other key is rejected even if the SSRC matches.
        `mime` picks the payload type (and thereby the ingest parser's
        codec branch): h264 → NALU keyframe scan, vp9/av1 → SVC PT (DD
        when present, VP9 picture headers otherwise), else VP8."""
        ssrc = self._new_ssrc()
        self.bindings[ssrc] = SSRCBinding(room, track, is_video, layer, session, svc)
        self._set_track_media(room, track, is_video, svc, mime)
        return ssrc

    def enable_gateway(self):
        """Create (or return) the standards-lane WebRTC gateway: ICE-lite
        STUN on this socket, DTLS-SRTP termination, SDP negotiation
        (runtime/webrtc_gateway.py; the reference's Pion seat,
        pkg/rtc/transport.go:253-374)."""
        if self.gateway is None:
            from livekit_server_tpu_torch.runtime.webrtc_gateway import WebRtcGateway

            self.gateway = WebRtcGateway(self)
        return self.gateway

    def enable_audio_mixer(self):
        """The MCU-seat audio mixer is not carried by the port."""
        raise NotImplementedError(
            "the MCU audio mixer is not ported yet (ROADMAP A8)"
        )

    def bind_client_ssrc(
        self, ssrc: int, room: int, track: int, is_video: bool,
        layer: int = 0, session: MediaCryptoSession | None = None,
        svc: bool = False, mime: str = "",
    ) -> bool:
        """Bind a CLIENT-chosen SSRC (from a gateway peer's SDP offer) to a
        plane track — assign_ssrc's twin for the standards lane, where the
        publisher picks its own SSRCs. Collisions with existing bindings
        are rejected (first owner wins, matching the latching rule for
        addresses); returns whether the bind took, so the caller never
        claims — or later releases — another publisher's SSRC."""
        if ssrc in self.bindings:
            return False
        self.bindings[ssrc] = SSRCBinding(room, track, is_video, layer, session, svc)
        self._set_track_media(room, track, is_video, svc, mime)
        return True

    def _set_track_media(
        self, room: int, track: int, is_video: bool, svc: bool, mime: str
    ) -> None:
        """Track-level media metadata shared by assign_ssrc and
        bind_client_ssrc: kind, SVC flag, and the egress payload type."""
        self.track_kind[(room, track)] = is_video
        if svc:
            self._svc_tracks.add((room, track))
            self._track_svc[room, track] = True
        m = (mime or "").lower()
        if not is_video:
            pt = OPUS_PT
        elif "av1" in m:
            pt = AV1_PT
        elif svc or "vp9" in m:
            pt = SVC_PT
        elif "h264" in m:
            pt = H264_PT
        else:
            pt = VP8_PT
        self._track_pt[room, track] = pt
        self._track_is_video[room, track] = is_video

    def bind_sub_session(
        self, room: int, sub: int, session: MediaCryptoSession
    ) -> None:
        """Attach a subscriber's crypto session: egress to (room, sub) is
        sealed under it, and its key routes TCP-fallback frames."""
        self.sub_sessions[(room, sub)] = session
        session.room = room
        session.sub = sub
        self._touch_subs()
        self._refresh_fb_enabled(room, sub)

    def _refresh_fb_enabled(self, room: int, sub: int) -> None:
        """TWCC applies to subs whose egress is actually sealed over UDP
        (counters on the wire): session bound + UDP address + sealing
        active (require_encryption, or the client spoke sealed first).
        `send_side_bwe` is the operator off-switch (config
        rtc.congestion_control.send_side_bwe)."""
        addr = self.sub_addrs.get((room, sub))
        sess = self.sub_sessions.get((room, sub))
        self.ingest.fb_enabled[room, sub] = (
            self.send_side_bwe
            and addr is not None
            and not (
                isinstance(addr, tuple) and addr
                and addr[0] in ("tcp", "srtp")
            )
            and sess is not None
            and (self.require_encryption or sess.client_active)
        )

    def _sendto(self, data: bytes, addr, session=None) -> None:
        """Single egress chokepoint: seal under the session, then route to
        the UDP socket or a TCP-fallback sink. TCP sinks are addressed as
        ("tcp", key_id) in the same addr maps the UDP path uses, so every
        consumer of sub_addrs/addrs works unchanged.

        Sealing is opportunistic in cleartext-allowed mode: a client that
        has ever spoken sealed frames (session.client_active) gets sealed
        egress; a legacy cleartext client gets cleartext. In
        require_encryption mode everything is sealed. TCP is ALWAYS
        sealed — its framing carries nothing else. Gateway peers
        (standards lane) always get SRTP/SRTCP."""
        if isinstance(addr, tuple) and addr and addr[0] == "srtp":
            if self.gateway is not None:
                self.gateway.protect_and_send(data, addr[1])
            return
        if self.gateway is not None and isinstance(addr, tuple):
            # Server-originated RTCP toward a gateway publisher's latched
            # address (PLI/NACK/RR) must ride SRTCP, never cleartext.
            if self.gateway.send_to_peer_addr(data, addr):
                return
        if isinstance(addr, tuple) and addr and addr[0] == "tcp":
            if session is None:
                return
            sink = self.tcp_sinks.get(addr[1])
            if sink is not None:
                sink(session.seal(data))
            return
        if session is not None and (self.require_encryption or session.client_active):
            data = session.seal(data)
        if self.transport is not None:
            self.transport.sendto(data, addr)

    def release_ssrc(self, ssrc: int) -> None:
        self.bindings.pop(ssrc, None)
        self.addrs.pop(ssrc, None)
        self._addr_code.pop(ssrc, None)
        self._rx_hi.pop(ssrc, None)
        self._rx_missing.pop(ssrc, None)
        self.pub_sr.pop(ssrc, None)

    def release_track(self, room: int, track: int) -> None:
        """Track unpublished: drop its kind entry + every layer SSRC."""
        self.track_kind.pop((room, track), None)
        self._last_pli_ms.pop((room, track), None)
        for key in [k for k in self._ts_delta if k[:2] == (room, track)]:
            del self._ts_delta[key]
        for ssrc in [
            s for s, b in self.bindings.items() if b.room == room and b.track == track
        ]:
            self.release_ssrc(ssrc)
        # SVC/RED state must not leak to the column's next tenant (a new
        # publisher would inherit the wrong DD template table).
        self._svc_tracks.discard((room, track))
        self._dd_structs.pop((room, track), None)
        self._red_ring.pop((room, track), None)
        self._track_pt[room, track] = OPUS_PT
        self._track_is_video[room, track] = False
        self._track_svc[room, track] = False

    def set_track_kind(self, room: int, track: int, is_video: bool) -> None:
        """Record media kind for egress PT selection (any transport)."""
        self.track_kind[(room, track)] = is_video

    def set_sub_red(self, room: int, sub: int, enabled: bool) -> None:
        """Subscriber negotiated RED audio (subscription signal field):
        audio egress to it is RFC 2198-encapsulated with the device plan's
        redundancy blocks (redreceiver.go; toggled per capability)."""
        if enabled:
            self.sub_red.add((room, sub))
        else:
            self.sub_red.discard((room, sub))
        self._touch_subs()

    def register_subscriber(self, room: int, sub: int, addr: tuple) -> None:
        """Trusted-caller egress registration (tests / in-process tooling).
        The signal plane must NOT call this with a client-supplied address —
        it hands out a punch id instead (assign_subscriber_punch)."""
        self.sub_addrs[(room, sub)] = addr
        self._touch_subs()
        self._refresh_fb_enabled(room, sub)

    def assign_subscriber_punch(self, room: int, sub: int, rotate: bool = False) -> int:
        """Mint an unguessable punch id for a subscriber. The client proves
        address ownership by sending PUNCH_REQ+id from its media socket;
        only then does egress flow to that source address.

        One outstanding id per (room, sub): repeated subscription signals
        reuse it (no unbounded growth, no widening of the guessable-id
        set; a same-address retry of a latched id just re-acks). Once
        latched, the id binds to its first source address — a replayed
        PUNCH_REQ from anywhere else is rejected, so an observer of the
        cleartext handshake cannot re-aim the stream. `rotate=True`
        (client sent udp_repunch) invalidates the old id and mints a
        fresh one: the recovery path for a NAT rebind — only the
        authenticated signal session can trigger it, never the old id."""
        key = (room, sub)
        existing = self._punch_by_sub.get(key)
        if existing is not None:
            if not rotate:
                return existing
            del self.punch_ids[existing]
        while True:
            pid = secrets.randbits(32)
            if pid and pid not in self.punch_ids:
                break
        self.punch_ids[pid] = [key, None]
        self._punch_by_sub[key] = pid
        return pid

    def release_subscriber(self, room: int, sub: int) -> None:
        """Subscriber left: stop egress and free its SSRC map (prevents
        media leaking to a stale address once the sub col is reused)."""
        self.sub_addrs.pop((room, sub), None)
        sess = self.sub_sessions.pop((room, sub), None)
        if sess is not None:
            self.tcp_sinks.pop(sess.key_id, None)
        for ssrc in (self.sub_ssrc.pop((room, sub), None) or {}).values():
            self.egress_rev.pop(ssrc, None)
            self._tx_sr.pop(ssrc, None)
            self._sr_sent.pop(ssrc, None)
        self._egress_ssrc_arr[room, sub, :] = 0
        self._txsr_pkts[room, sub, :] = 0
        self._txsr_oct[room, sub, :] = 0
        self.sub_red.discard((room, sub))
        self._touch_subs()
        self.ingest.fb_enabled[room, sub] = False
        self.ingest.sub_reset[room, sub] = True  # device per-sub state reset
        self._twcc_ctr[room, sub, :] = -1
        self._twcc_last_ctr[room, sub] = -1
        pid = self._punch_by_sub.pop((room, sub), None)
        if pid is not None:
            self.punch_ids.pop(pid, None)

    def release_room(self, room: int) -> None:
        """Room closed: drop every binding on its row."""
        for ssrc in [s for s, b in self.bindings.items() if b.room == room]:
            self.release_ssrc(ssrc)
        for key in [k for k in self.sub_addrs if k[0] == room]:
            del self.sub_addrs[key]
        for key in [k for k in self.sub_ssrc if k[0] == room]:
            for ssrc in self.sub_ssrc[key].values():
                self.egress_rev.pop(ssrc, None)
                self._tx_sr.pop(ssrc, None)
                self._sr_sent.pop(ssrc, None)
            del self.sub_ssrc[key]
        for key in [k for k in self.track_kind if k[0] == room]:
            del self.track_kind[key]
        for key in [k for k in self._last_pli_ms if k[0] == room]:
            del self._last_pli_ms[key]
        self._egress_ssrc_arr[room] = 0
        self._track_pt[room] = OPUS_PT
        self._track_is_video[room] = False
        self.tx_pkts[room] = 0
        self.tx_bytes[room] = 0
        self.ingest.rx_pkts[room] = 0
        self.ingest.rx_bytes[room] = 0
        self._txsr_pkts[room] = 0
        self._txsr_oct[room] = 0
        self.sub_red = {k for k in self.sub_red if k[0] != room}
        for key in [k for k in self._red_ring if k[0] == room]:
            del self._red_ring[key]
        self._svc_tracks = {k for k in self._svc_tracks if k[0] != room}
        self._touch_subs()
        self._track_svc[room] = False
        for key in [k for k in self._dd_structs if k[0] == room]:
            del self._dd_structs[key]
        for key in [k for k in self._ts_delta if k[0] == room]:
            del self._ts_delta[key]
        for key in [k for k in self.sub_sessions if k[0] == room]:
            sess = self.sub_sessions.pop(key)
            self.tcp_sinks.pop(sess.key_id, None)
        for key in [k for k in self._punch_by_sub if k[0] == room]:
            self.punch_ids.pop(self._punch_by_sub.pop(key), None)

    def subscriber_ssrc(self, room: int, sub: int, track: int) -> int:
        """Per-(subscriber, track) egress SSRC (DownTrack's own SSRC)."""
        m = self.sub_ssrc.setdefault((room, sub), {})
        if track not in m:
            m[track] = self._new_ssrc()
            self.egress_rev[m[track]] = (room, sub, track)
            self._egress_ssrc_arr[room, sub, track] = m[track]
        return m[track]

    # -- datagram path ----------------------------------------------------
    def connection_made(self, transport) -> None:
        self.transport = transport

    def _mark_client_active(self, session) -> None:
        """First frame that opens under a session latches sealed egress;
        the array mirror must track the exact session at that slot."""
        if session.client_active:
            return
        session.client_active = True
        j = getattr(session, "_arr_idx", None)
        if (
            j is not None
            and j < len(self._sessions)
            and self._sessions[j] is session
        ):
            self._sess_active[j] = 1
        # Sealing just latched for this client: if it's a subscriber, its
        # egress now carries counters — TWCC becomes applicable.
        room, sub = getattr(session, "room", -1), getattr(session, "sub", -1)
        if room >= 0 and sub >= 0:
            self._refresh_fb_enabled(room, sub)

    def _prune_addr_caches(self) -> None:
        """Bound the addr↔code mirrors under a spoofed-source flood while
        keeping every entry a latched SSRC still points at — evicting a
        live latch would permanently sever a non-IPv4 client, whose
        synthetic code cannot be re-derived from its tuple."""
        live = set(self._addr_code.values())
        self._code_tuple = {
            c: t for c, t in self._code_tuple.items() if c in live
        }
        self._tuple_code = {
            t: c for t, c in self._tuple_code.items() if c in live
        }

    def _addr_code_of(self, addr) -> int:
        """Integer identity for an address tuple (see __init__)."""
        c = self._tuple_code.get(addr)
        if c is None:
            import socket as _socket

            try:
                ip = int.from_bytes(_socket.inet_aton(addr[0]), "big")
                c = (ip << 16) | (int(addr[1]) & 0xFFFF)
            except (OSError, IndexError, TypeError, ValueError):
                c = self._syn_code   # non-IPv4: synthetic negative code
                self._syn_code -= 1
            if len(self._tuple_code) >= 8192 or len(self._code_tuple) >= 8192:
                self._prune_addr_caches()
            self._tuple_code[addr] = c
            self._code_tuple[c] = addr
        return c

    def _tuple_of_code(self, code: int) -> tuple:
        t = self._code_tuple.get(code)
        if t is None:
            import socket as _socket

            if code < 0:
                return ("0.0.0.0", 0)  # unknown synthetic code (never live)
            t = (
                _socket.inet_ntoa(int(code >> 16).to_bytes(4, "big")),
                int(code) & 0xFFFF,
            )
            if len(self._tuple_code) >= 8192 or len(self._code_tuple) >= 8192:
                self._prune_addr_caches()
            self._code_tuple[code] = t
            self._tuple_code[t] = code
        return t

    def feed_batch(self, blob, offs, lens, ips, ports, n,
                   t_rx: float = 0.0) -> None:
        """Batch ingress from the native recvmmsg reader: sealed frames are
        opened with ONE native AES-GCM batch call (replay windows and the
        client-active latch stay host-side), datagrams are classified
        vectorized (punch / RTCP / RTP media), and all media goes through
        ONE array demux+stage pass (_process_media_arrays) — no per-packet
        Python objects on the media path."""
        self.stats["rx"] += int(n)
        offs = offs[:n]
        lens = lens[:n]
        ips = ips[:n]
        ports = ports[:n]
        valid = lens > 0
        b0 = np.where(valid, blob[np.minimum(offs, len(blob) - 1)], 0xFF)
        sealed = (
            (b0 == CRYPTO_MAGIC) & valid
            if self.crypto is not None else np.zeros(n, bool)
        )
        addr_code = (ips.astype(np.int64) << 16) | ports.astype(np.int64)
        now_ms = asyncio.get_event_loop().time() * 1000.0
        if t_rx == 0.0:
            t_rx = time.perf_counter()

        if sealed.any():
            si = np.nonzero(sealed)[0]
            o = offs[si].astype(np.int64)
            kid = (
                (blob[o + 1].astype(np.uint32) << 24)
                | (blob[o + 2].astype(np.uint32) << 16)
                | (blob[o + 3].astype(np.uint32) << 8)
                | blob[o + 4]
            )
            sessions = {int(k): self.crypto.get(int(k)) for k in np.unique(kid)}
            keyrows: list[bytes] = []
            kmap: dict[int, int] = {}
            for k, sess in sessions.items():
                if sess is not None:
                    kmap[k] = len(keyrows)
                    keyrows.append(sess.key)
            kidx = np.array([kmap.get(int(k), -1) for k in kid], np.int32)
            keys = (
                np.frombuffer(b"".join(keyrows), np.uint8).reshape(-1, 16)
                if keyrows else np.zeros((1, 16), np.uint8)
            )
            out, ooff, olen = native.egress.open_batch(
                blob, offs[si], lens[si], kidx, keys, DIR_C2S
            )
            ctr = np.zeros(len(si), np.uint64)
            for b in range(8):
                ctr = (ctr << np.uint64(8)) | blob[o + 6 + b].astype(np.uint64)
            # Replay windows are inherently sequential per session; the
            # loop is per *sealed* packet but does dict/bitmask work only.
            good = np.zeros(len(si), bool)
            scodes = np.zeros(len(si), np.int64)
            for j in range(len(si)):
                if olen[j] < 0:
                    self.stats["bad_frame"] += 1
                    continue
                sess = sessions[int(kid[j])]
                if not sess.replay.check(int(ctr[j])):
                    self.stats["bad_frame"] += 1
                    continue
                self._mark_client_active(sess)
                good[j] = True
                scodes[j] = int(kid[j]) + 1
            gi = np.nonzero(good)[0]
            if len(gi):
                self._classify_and_process(
                    out, ooff[gi].astype(np.int32), olen[gi],
                    addr_code[si[gi]], scodes[gi], sessions, kid[gi], now_ms,
                    t_rx,
                )

        clear = valid & ~sealed
        nclear = int(clear.sum())
        if nclear:
            if self.require_encryption and self.gateway is None:
                # Secure mode: the cleartext media wire does not exist —
                # but punch probes ride sealed frames only, so anything
                # cleartext here is droppable wholesale.
                self.stats["plaintext_drop"] += nclear
            else:
                # With a gateway, "cleartext" includes STUN/DTLS/SRTP
                # (their own crypto); _classify_and_process drops the
                # rest when gateway_only is set — mirroring the
                # per-datagram path, which demuxes gateway traffic
                # BEFORE the require_encryption drop.
                ci = np.nonzero(clear)[0]
                self._classify_and_process(
                    blob, offs[ci], lens[ci], addr_code[ci],
                    np.zeros(len(ci), np.int64), None, None, now_ms, t_rx,
                    gateway_only=self.require_encryption,
                )

    def _classify_and_process(self, blob, offs, lens, addr_code, sess_code,
                              sessions, kid, now_ms, t_rx: float = 0.0,
                              gateway_only: bool = False) -> None:
        """Split one (possibly decrypted) datagram batch into punch / RTCP
        (cold, per-packet) and RTP media (hot, one vectorized pass).
        `gateway_only` (require_encryption + gateway): gateway traffic is
        processed, every other cleartext datagram is dropped."""
        b0 = blob[np.minimum(offs.astype(np.int64), len(blob) - 1)]
        b1 = blob[np.minimum(offs.astype(np.int64) + 1, len(blob) - 1)]
        maybe_punch = (b0 == PUNCH_REQ[0]) & (lens >= 12)
        is_rtcp = ~maybe_punch & (b1 >= 192) & (b1 <= 223) & (lens >= 8)
        media = ~maybe_punch & ~is_rtcp
        if self.gateway is not None and sessions is None:
            # Standards-lane demux on the cleartext batch (RFC 7983):
            # STUN/DTLS control per-packet (low rate); SRTP *and* SRTCP
            # from latched gateway addresses go through the unprotect
            # lane — SRTCP's cleartext first 8 bytes would otherwise
            # satisfy the plain-RTCP byte1 test and feed the RTCP handler
            # ciphertext.
            gw_ctl = ((b0 < 4) & (b0 != CRYPTO_MAGIC)) | ((b0 >= 20) & (b0 <= 63))
            for i in np.nonzero(gw_ctl)[0]:
                oo = int(offs[i])
                self.gateway.handle_datagram(
                    bytes(blob[oo : oo + int(lens[i])]),
                    self._tuple_of_code(int(addr_code[i])),
                )
            gw_media = np.zeros(len(offs), bool)
            if self.gateway.peers_by_addr:
                owned = np.isin(
                    addr_code,
                    np.fromiter(self.gateway.peers_by_addr, np.int64,
                                len(self.gateway.peers_by_addr)),
                )
                gw_media = ~gw_ctl & ~maybe_punch & owned & (b0 >= 128)
                if gw_media.any():
                    pkts = [
                        (bytes(blob[int(offs[i]) : int(offs[i]) + int(lens[i])]),
                         int(addr_code[i]))
                        for i in np.nonzero(gw_media)[0]
                    ]
                    self._gateway_media(pkts, t_rx)
            media = media & ~gw_ctl & ~gw_media
            is_rtcp = is_rtcp & ~gw_media
        if gateway_only:
            leftover = int(media.sum()) + int(is_rtcp.sum()) + int(
                maybe_punch.sum()
            )
            if leftover:
                self.stats["plaintext_drop"] += leftover
            return
        for i in np.nonzero(maybe_punch)[0]:
            oo = int(offs[i])
            d = bytes(blob[oo : oo + int(lens[i])])
            sess = sessions.get(int(kid[i])) if sessions is not None else None
            if d[:8] == PUNCH_REQ:
                self._handle_punch(d, self._tuple_of_code(int(addr_code[i])), sess)
            # else: first byte 'L' is not a valid RTP version — drop like
            # the parser would.
        for i in np.nonzero(is_rtcp)[0]:
            oo = int(offs[i])
            self._handle_rtcp(
                bytes(blob[oo : oo + int(lens[i])]),
                self._tuple_of_code(int(addr_code[i])),
            )
        mi = np.nonzero(media)[0]
        if len(mi):
            self._process_media_arrays(
                blob, offs[mi], lens[mi], addr_code[mi], sess_code[mi], now_ms,
                t_rx,
            )

    def datagram_received(self, data: bytes, addr) -> None:
        self.stats["rx"] += 1
        if not data:
            return
        if self.gateway is not None:
            b0 = data[0]
            # RFC 7983 demux: STUN (0-3, requests are 0x00 so the sealed
            # magic 0x01 never collides), DTLS (20-63). SRTP media shares
            # the RTP first-byte range and demuxes by latched address.
            if (b0 < 4 and b0 != CRYPTO_MAGIC) or 20 <= b0 <= 63:
                if self.gateway.handle_datagram(data, addr):
                    return
            elif b0 >= 128 and self.gateway.owns_addr(self._addr_code_of(addr)):
                self._gateway_media([(data, self._addr_code_of(addr))],
                                    time.perf_counter())
                return
        # Sealed frames lead with the crypto magic (0x01 — impossible as an
        # RTP/RTCP version byte or the punch magic 'L').
        if data[0] == CRYPTO_MAGIC and self.crypto is not None:
            key_id = parse_key_id(data)
            session = self.crypto.get(key_id) if key_id is not None else None
            inner = session.open(data) if session is not None else None
            if inner is None:
                self.stats["bad_frame"] += 1
                return
            self._mark_client_active(session)
            self._dispatch_inner(inner, addr, session)
            return
        if self.require_encryption:
            # Secure mode: the cleartext media wire does not exist.
            self.stats["plaintext_drop"] += 1
            return
        self._dispatch_inner(data, addr, None)

    def _dispatch_inner(self, data: bytes, addr, session) -> None:
        """Route one (decrypted) datagram: punch / RTCP / RTP. Shared by
        the UDP socket and the TCP-fallback framing."""
        if data[:8] == PUNCH_REQ:
            self._handle_punch(data, addr, session)
            return
        # rtcp-mux demux (RFC 5761): RTCP PTs land in byte1 192-223 — a
        # range RTP reserves — so one byte splits the flows.
        if len(data) >= 8 and 192 <= data[1] <= 223:
            self._handle_rtcp(data, addr)
            return
        # Coalesce: datagrams arriving in the same event-loop iteration are
        # parsed by ONE native parse_batch call (the batch design this
        # module documents; under media load the loop wakes with many
        # datagrams ready and the per-packet Python overhead amortizes).
        self._rx_pending.append((data, addr, session))
        if not self._rx_scheduled:
            self._rx_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush_rx)

    def _handle_twcc(self, room: int, sub: int, fci: bytes) -> None:
        """Match one transport-wide feedback frame against the send-time
        ring and accumulate this tick's delay/rate reductions (the host
        half of the ops/bwe send-side estimator). All array math; acked
        slots are invalidated so replayed/duplicate feedback is inert."""
        if len(fci) < 20:
            return
        base_ctr = int.from_bytes(fci[0:8], "big")
        base_us = int.from_bytes(fci[8:16], "big")
        n = int.from_bytes(fci[16:18], "big")
        body = fci[20 : 20 + 6 * n]
        if n == 0 or len(body) < 6 * n:
            return
        ent = np.frombuffer(body, _TWCC_ENTRY)
        ctrs = base_ctr + ent["off"].astype(np.int64)
        recv_us = base_us + ent["delta"].astype(np.int64)
        # Dedup within the frame: repeated entries would otherwise all
        # match before the slot is invalidated, inflating acked_bytes and
        # diluting the delay mean — exactly the client manipulation this
        # measurement path exists to resist.
        ctrs, first = np.unique(ctrs, return_index=True)
        recv_us = recv_us[first]
        slots = (ctrs & (TWCC_RING - 1)).astype(np.int64)
        ok = self._twcc_ctr[room, sub, slots] == ctrs
        self.stats["twcc_rx"] = self.stats.get("twcc_rx", 0) + int(n)
        if not ok.any():
            return
        ctrs, recv_us, slots = ctrs[ok], recv_us[ok], slots[ok]
        order = np.argsort(ctrs)
        ctrs, recv_us, slots = ctrs[order], recv_us[order], slots[order]
        send_ms = self._twcc_ms[room, sub, slots]
        acked_bytes = int(self._twcc_len[room, sub, slots].sum())
        self._twcc_ctr[room, sub, slots] = -1  # spend the acks
        recv_ms = recv_us.astype(np.float64) / 1000.0
        # Chain in the previous frame's last ack: deltas must span frame
        # boundaries, or a one-ack-per-frame cadence never yields a
        # delay-variation sample.
        last_c = int(self._twcc_last_ctr[room, sub])
        if 0 <= last_c < int(ctrs[0]):
            send_ms = np.r_[self._twcc_last_send[room, sub], send_ms]
            recv_ms = np.r_[self._twcc_last_recv[room, sub], recv_ms]
        self._twcc_last_ctr[room, sub] = int(ctrs[-1])
        self._twcc_last_send[room, sub] = send_ms[-1]
        self._twcc_last_recv[room, sub] = recv_ms[-1]
        # Delay-variation samples: how much more the recv gap grew than the
        # send gap (positive ⇒ queue building).
        if len(recv_ms) >= 2:
            dd = np.diff(recv_ms) - np.diff(send_ms)
            delay_sum, n_d = float(dd.sum()), len(dd)
            # Measured span, floored only against degenerate timestamps;
            # flooring to a full tick here would under-report the receive
            # rate of clients that ack in several sub-tick frames.
            span = max(float(recv_ms[-1] - recv_ms[0]), 0.1)
        else:
            # Single-ack frame: no span — bill one tick's worth.
            delay_sum, n_d = 0.0, 1
            span = float(self.ingest.tick_ms)
        self.ingest.push_twcc_feedback(
            room, sub, delay_sum, n_d, acked_bytes, span
        )

    def _handle_rtcp(self, data: bytes, addr) -> None:
        """Compound RTCP walk: NACK → sequencer lookup, PLI → keyframe
        request, REMB → BWE estimate sample, RR → loss/RTT bookkeeping
        (the RTCP half of buffer.Buffer — buffer.go:673 onwards)."""
        self.stats["rtcp_rx"] += 1
        off = 0
        while off + 8 <= len(data):
            fmt = data[off] & 0x1F
            pt = data[off + 1]
            length = (int.from_bytes(data[off + 2 : off + 4], "big") + 1) * 4
            chunk = data[off : off + length]
            off += length
            if len(chunk) < 12:
                # Valid 8-byte chunks exist (empty RR, BYE) — skip, keep
                # walking the compound; only truncation is malformed.
                if len(chunk) < 8:
                    self.stats["rtcp_bad"] += 1
                    return
                continue
            media_ssrc = int.from_bytes(chunk[8:12], "big")
            if pt == RTCP_RTPFB and fmt == 1:
                dest = self.egress_rev.get(media_ssrc)
                if dest is None:
                    continue
                room, sub, track = dest
                # Anti-spoof: feedback must come from the sub's own address.
                if self.sub_addrs.get((room, sub)) != addr:
                    self.stats["addr_mismatch"] += 1
                    continue
                sns = parse_nack_fci(chunk[12:])
                self.stats["nacks_rx"] += len(sns)
                # BWE loss channel (count) + immediate host-side replay
                # (sequencer.go:263 — answered at RTCP time, not on the
                # next tick; the reference replies immediately too).
                self.ingest.push_nack(room, sub, track, sns)
                if self.nack_resolver is not None:
                    replays = self.nack_resolver(room, sub, track, sns)
                    if replays:
                        self.send_egress(replays, rtx=True)
            elif pt == RTCP_RTPFB and fmt == TWCC_FMT:
                dest = self.egress_rev.get(media_ssrc)
                if dest is None:
                    continue
                room, sub, _track = dest
                if self.sub_addrs.get((room, sub)) != addr:
                    self.stats["addr_mismatch"] += 1
                    continue
                self._handle_twcc(room, sub, chunk[12:])
            elif pt == RTCP_PSFB and fmt == 1:
                dest = self.egress_rev.get(media_ssrc)
                if dest is None:
                    continue
                room, sub, track = dest
                if self.sub_addrs.get((room, sub)) != addr:
                    self.stats["addr_mismatch"] += 1
                    continue
                self.stats["plis_rx"] += 1
                self.send_pli(room, track)
            elif pt == RTCP_PSFB and fmt == 15:
                bitrate, ssrcs = parse_remb(chunk[12:])
                if bitrate <= 0:
                    continue
                for s in ssrcs:
                    dest = self.egress_rev.get(s)
                    if dest is None:
                        continue
                    room, sub, _track = dest
                    if self.sub_addrs.get((room, sub)) != addr:
                        self.stats["addr_mismatch"] += 1
                        break
                    self.ingest.push_feedback(room, sub, estimate=bitrate)
                    break  # one estimate per REMB: the channel is per-sub
            elif pt == RTCP_SR:
                # Publisher sender report: the (NTP, RTP-TS) anchor for
                # cross-layer timestamp alignment (forwarder.go:1456
                # processSourceSwitch reads exactly this pair).
                sr = parse_sr(chunk)
                if sr is not None:
                    ssrc, ntp64, rtp_ts = sr
                    b = self.bindings.get(ssrc)
                    if b is not None and self.addrs.get(ssrc) == addr:
                        self.pub_sr[ssrc] = (ntp64, rtp_ts)
                        self._update_ts_deltas(b.room, b.track)
            elif pt == RTCP_RR:
                # Report blocks carry subscriber-observed loss per downtrack
                # SSRC; fraction_lost feeds the BWE nack channel as a loss
                # signal (nacktracker.go ratio semantics), and LSR/DLSR
                # against our SR echo table yields RTT (RFC 3550 A.8).
                count = fmt  # RC field shares the FMT bits
                blocks = chunk[8:]
                for i in range(count):
                    b = blocks[i * 24 : i * 24 + 24]
                    if len(b) < 24:
                        break
                    ssrc = int.from_bytes(b[0:4], "big")
                    fraction = b[4] / 256.0
                    dest = self.egress_rev.get(ssrc)
                    if dest is None:
                        continue
                    room, sub, _track = dest
                    if self.sub_addrs.get((room, sub)) != addr:
                        continue
                    # Media-loss proxy (medialossproxy.go HandleMaxLoss
                    # Feedback): audio downstream loss aggregates to the
                    # per-track max and is relayed upstream at SR cadence.
                    if not self.track_kind.get((room, _track), False):
                        # Zero-loss reports are recorded too: the relay
                        # must tell the publisher when loss RECOVERS, or
                        # its Opus FEC latches on forever.
                        key = (room, _track)
                        self._down_frac_lost[key] = max(
                            self._down_frac_lost.get(key, 0), b[4]
                        )
                    # Loss itself is NOT fed to BWE here: the NACK path
                    # already counts it (push_nack → _nacks); adding
                    # fraction_lost would double-count the same event.
                    lsr = int.from_bytes(b[16:20], "big")
                    dlsr = int.from_bytes(b[20:24], "big")
                    if lsr and lsr in self._sr_sent.get(ssrc, ()):
                        units = (ntp_mid32(ntp_now()) - lsr - dlsr) & 0xFFFFFFFF
                        rtt_ms = units * 1000.0 / 65536.0
                        if 0 < rtt_ms < 10_000:
                            self.ingest.set_rtt(room, sub, rtt_ms)

    def _update_ts_deltas(self, room: int, track: int) -> None:
        """Recompute per-layer TS offsets from the latest SR anchors
        (forwarder.go:1456-1650 processSourceSwitch's NTP alignment): at a
        common wallclock instant t, layer l's RTP clock reads
        sr_rtp_l + (t - sr_ntp_l)·90k; delta_l is its lead over layer 0."""
        anchors: dict[int, tuple[int, int]] = {}
        for ssrc, b in self.bindings.items():
            if b.room == room and b.track == track and ssrc in self.pub_sr:
                anchors[b.layer] = self.pub_sr[ssrc]
        if 0 not in anchors:
            return
        ntp0, rtp0 = anchors[0]
        for layer, (ntp, rtp) in anchors.items():
            dt_s = (ntp - ntp0) / float(1 << 32)  # ntp64 is 32.32 fixed point
            delta = int(round(rtp - rtp0 - dt_s * 90_000.0))
            self._ts_delta[(room, track, layer)] = delta & 0xFFFFFFFF

    def send_pli(self, room: int, track: int) -> None:
        """Keyframe request toward the publisher: RTCP PLI to every latched
        layer SSRC of the track (downtrack.go keyframe request path); falls
        back to the on_pli callback for signal-plane (WS) publishers.
        Throttled per track (pliThrottle analog) so a PLI-spamming
        subscriber cannot force a keyframe storm on the publisher."""
        now_ms = asyncio.get_event_loop().time() * 1000.0
        if now_ms - self._last_pli_ms.get((room, track), -1e12) < PLI_THROTTLE_MS:
            return
        self._last_pli_ms[(room, track)] = now_ms
        sent = False
        if self.transport is not None or self.tcp_sinks:
            for ssrc, b in self.bindings.items():
                if b.room == room and b.track == track:
                    addr = self.addrs.get(ssrc)
                    if addr is not None:
                        self._sendto(build_pli(self.node_ssrc, ssrc), addr, b.session)
                        self.stats["plis_tx"] += 1
                        sent = True
        if not sent and self.on_pli is not None:
            self.on_pli(room, track)

    def _track_upstream_loss(self, ssrc: int, sn: int, now_ms: float) -> None:
        """Extend the per-SSRC highest-SN watermark; queue NACKs for gaps
        (buffer.go:673 doNACKs). Late arrivals clear their missing entry."""
        ext = sn & 0xFFFF
        hi = self._rx_hi.get(ssrc)
        if hi is None:
            self._rx_hi[ssrc] = ext
            return
        diff = (ext - hi) & 0xFFFF
        missing = self._rx_missing.setdefault(ssrc, {})
        if diff == 0:
            return  # duplicate of the watermark
        if diff < 0x8000:
            # In-order advance; SNs (hi+1 .. ext-1) are now missing.
            for gap in range(1, min(diff, 17)):
                missing[(hi + gap) & 0xFFFF] = [0, now_ms]
            if diff > 17:
                missing.clear()  # burst loss beyond window: resync, PLI path recovers
            self._rx_hi[ssrc] = ext
        else:
            # Out-of-order arrival: it fills a hole if we were tracking one.
            missing.pop(ext, None)

    def _send_upstream_nacks(self, now_ms: float) -> None:
        if self.transport is None and not self.tcp_sinks:
            return
        for ssrc, missing in self._rx_missing.items():
            if not missing:
                continue
            addr = self.addrs.get(ssrc)
            if addr is None:
                missing.clear()
                continue
            due = [sn for sn, st in missing.items() if st[1] <= now_ms]
            if not due:
                continue
            for sn in due:
                st = missing[sn]
                st[0] += 1
                if st[0] >= 3:  # reference's maxNackTimes
                    del missing[sn]
                else:
                    st[1] = now_ms + 30.0 * st[0]  # backoff between retries
            if due:
                b = self.bindings.get(ssrc)
                self._sendto(
                    build_nack(self.node_ssrc, ssrc, due), addr,
                    b.session if b is not None else None,
                )
                self.stats["nacks_tx"] += len(due)

    def _handle_punch(self, data: bytes, addr, session=None) -> None:
        if len(data) < 12:
            self.stats["bad_punch"] += 1
            return
        pid = int.from_bytes(data[8:12], "big")
        entry = self.punch_ids.get(pid)
        if entry is None:
            self.stats["bad_punch"] += 1
            return
        key, latched = entry
        if latched is not None and latched != addr:
            # id already bound to another source: replay/hijack attempt
            self.stats["bad_punch"] += 1
            return
        if session is not None and (session.room, session.sub) != key:
            # sealed punch under the wrong participant's key
            self.stats["bad_punch"] += 1
            return
        entry[1] = addr
        self.sub_addrs[key] = addr
        self._touch_subs()
        self._refresh_fb_enabled(*key)
        self._sendto(PUNCH_ACK + data[8:12], addr, session)

    def _flush_rx(self) -> None:
        """Drain the asyncio per-datagram queue (datagram_received / TCP
        framing path) into the shared array demux. The native recvmmsg
        reader bypasses this entirely — feed_batch goes straight to
        _process_media_arrays."""
        self._rx_scheduled = False
        pending, self._rx_pending = self._rx_pending, []
        if not pending:
            return
        now_ms = asyncio.get_event_loop().time() * 1000.0
        n = len(pending)
        lengths = np.fromiter((len(d) for d, _, _ in pending), np.int32, n)
        offsets = np.zeros(n, np.int32)
        np.cumsum(lengths[:-1], out=offsets[1:])
        blob = np.frombuffer(b"".join(d for d, _, _ in pending), np.uint8)
        addr_code = np.fromiter(
            (self._addr_code_of(a) for _, a, _ in pending), np.int64, n
        )
        sess_code = np.fromiter(
            (0 if s is None else s.key_id + 1 for _, _, s in pending),
            np.int64, n,
        )
        self._process_media_arrays(
            blob, offsets, lengths, addr_code, sess_code, now_ms
        )

    def _gateway_media(self, pkts: list, t_rx: float) -> None:
        """SRTP datagrams from latched gateway peers → per-packet
        unprotect (interop lane) → the SAME vectorized ingest stage the
        sealed lane uses, pinned by the peer's session code."""
        blob, offs, lens, codes, scodes = self.gateway.unprotect_media(pkts)
        if len(offs):
            now_ms = asyncio.get_event_loop().time() * 1000.0
            self._process_media_arrays(
                blob, offs.astype(np.int32), lens, codes, scodes, now_ms,
                t_rx,
            )

    def _process_media_arrays(
        self, blob, offsets, lengths, addr_code, sess_code, now_ms,
        t_rx: float = 0.0,
    ) -> None:
        """One native parse + one vectorized ingest stage per receive
        batch. Per-PACKET Python is limited to rare paths (RED decap, DD
        descriptors, loss-gap fallback); binding resolution is per UNIQUE
        SSRC; everything else is numpy group math. `blob` is one
        contiguous uint8 array; `addr_code`/`sess_code` are the integer
        identities from _addr_code_of / key_id + 1 (0 = plaintext)."""
        if not isinstance(blob, np.ndarray):
            blob = np.frombuffer(blob, np.uint8)
        parsed = native.rtp.parse_batch(
            blob, offsets, lengths,
            audio_level_ext=AUDIO_LEVEL_EXT_ID, vp8_pts={VP8_PT},
            dd_ext_id=DD_EXT_ID if self._svc_tracks else 0,
            vp9_pts={SVC_PT}, h264_pts={H264_PT},  # AV1_PT: DD-only, no
                                                   # payload-descriptor parse
        )

        # RED-publishing clients (pt 63): strip to the primary block before
        # staging (redprimaryreceiver.go; redundancy recovery rides NACK).
        if (parsed["pt"] == RED_PT).any():
            for i in np.nonzero(
                (parsed["payload_len"] > 0) & (parsed["pt"] == RED_PT)
            )[0]:
                st = int(offsets[i]) + int(parsed["payload_off"][i])
                po2, pl2 = _red_primary(blob, st, int(parsed["payload_len"][i]))
                if pl2 < 0:
                    parsed["payload_len"][i] = -1
                    continue
                parsed["payload_off"][i] = po2 - int(offsets[i])
                parsed["payload_len"][i] = pl2
                self.stats["red_rx"] = self.stats.get("red_rx", 0) + 1

        plen = parsed["payload_len"].astype(np.int64)
        ok = plen >= 0
        self.stats["parse_errors"] += int((~ok).sum())

        # Binding / alignment resolution per UNIQUE SSRC (dict work scales
        # with streams, not packets).
        ssrcs = parsed["ssrc"]
        uniq, inv = np.unique(ssrcs, return_inverse=True)
        U = len(uniq)
        u_known = np.zeros(U, bool)
        u_room = np.zeros(U, np.int32)
        u_track = np.zeros(U, np.int32)
        u_layer = np.zeros(U, np.int32)
        u_video = np.zeros(U, bool)
        u_svc = np.zeros(U, bool)
        u_keyed = np.zeros(U, bool)
        u_scode = np.zeros(U, np.int64)       # bound session's key_id + 1
        u_aligned = np.zeros(U, bool)
        u_delta = np.zeros(U, np.int64)
        u_latch = np.full(U, _NO_LATCH, np.int64)  # latched addr code
        for j, sv in enumerate(uniq.tolist()):
            b = self.bindings.get(sv)
            if b is None:
                continue
            u_known[j] = True
            u_room[j] = b.room
            u_track[j] = b.track
            u_layer[j] = b.layer
            u_video[j] = b.is_video
            u_svc[j] = b.svc
            if b.session is not None:
                u_keyed[j] = True
                u_scode[j] = b.session.key_id + 1
            delta = self._ts_delta.get((b.room, b.track, b.layer))
            if delta is not None:
                u_aligned[j] = True
                u_delta[j] = delta
            code = self._addr_code.get(sv)
            if code is None and sv in self.addrs:
                # Latched before the code mirror existed (restore paths).
                code = self._addr_code[sv] = self._addr_code_of(self.addrs[sv])
            if code is not None:
                u_latch[j] = code

        known = ok & u_known[inv]
        self.stats["unknown_ssrc"] += int((ok & ~u_known[inv]).sum())
        # SSRC pinned to its publisher's key: valid media sealed under a
        # DIFFERENT participant's session must not inject here. In
        # cleartext-allowed mode a plaintext packet (sess_code 0) is
        # legal even for a keyed SSRC (legacy client).
        keyed = u_keyed[inv]
        same = (sess_code == u_scode[inv]) & (u_scode[inv] > 0)
        mismatch = keyed & ~same & ((sess_code != 0) | self.require_encryption)
        self.stats["session_mismatch"] += int((known & mismatch).sum())
        cand = known & ~mismatch

        # First packet latches the source address; later packets from a
        # different address are dropped (UDP-mux address learning — without
        # this, anyone who learns an SSRC could inject media).
        first = np.full(U, -1, np.int64)
        pos = np.nonzero(cand)[0]
        first[inv[pos][::-1]] = pos[::-1]  # smallest position wins
        for j in np.nonzero((u_latch == _NO_LATCH) & (first >= 0))[0]:
            code = int(addr_code[first[j]])
            sv = int(uniq[j])
            self.addrs[sv] = self._tuple_of_code(code)
            self._addr_code[sv] = code
            u_latch[j] = code
        addr_ok = addr_code == u_latch[inv]
        self.stats["addr_mismatch"] += int((cand & ~addr_ok).sum())
        final = cand & addr_ok

        # NACK generation is video-only (the reference negotiates NACK for
        # video; audio loss is concealed, never replayed). Fast path: an
        # SSRC whose batch continues its watermark contiguously with no
        # tracked holes needs no per-packet work at all — loss is the
        # exception, so per-packet Python runs only on gap/reorder ticks.
        sn_arr = parsed["sn"]
        vid_pkts = np.nonzero(final & u_video[inv])[0]
        if len(vid_pkts):
            v_inv = inv[vid_pkts]
            order = np.argsort(v_inv, kind="stable")   # per-SSRC, arrival order
            sel = vid_pkts[order]
            v_sorted = v_inv[order]
            nv = len(sel)
            grp = np.concatenate(
                [[0], np.nonzero(np.diff(v_sorted))[0] + 1]
            )
            sns = sn_arr[sel].astype(np.int64)
            # Per-group watermark continuity check, fully vectorized: the
            # predecessor of each group's first packet is its SSRC's
            # stored watermark; every other predecessor is the previous
            # packet in the group.
            prev = np.empty(nv, np.int64)
            prev[1:] = sns[:-1]
            g_ssrc = [int(ssrcs[sel[g]]) for g in grp.tolist()]
            g_hi = [self._rx_hi.get(sv) for sv in g_ssrc]
            prev[grp] = [h if h is not None else -1 for h in g_hi]
            contiguous = ((sns - prev) & 0xFFFF) == 1
            g_ok = np.logical_and.reduceat(contiguous, grp)
            g_last = np.concatenate([grp[1:], [nv]]) - 1
            for gi_, (g, sv, hi) in enumerate(zip(grp.tolist(), g_ssrc, g_hi)):
                if (
                    g_ok[gi_]
                    and hi is not None
                    and not self._rx_missing.get(sv)
                ):
                    self._rx_hi[sv] = int(sns[g_last[gi_]])
                    continue
                e = int(grp[gi_ + 1]) if gi_ + 1 < len(grp) else nv
                for sn_v in sns[g:e].tolist():
                    self._track_upstream_loss(sv, sn_v, now_ms)

        if self.sub_red:
            # Primary-payload ring per audio track — the bytes the RED
            # egress plan references by source SN.
            from collections import deque

            for i in np.nonzero(final & ~u_video[inv])[0]:
                key = (int(u_room[inv[i]]), int(u_track[inv[i]]))
                ring = self._red_ring.get(key)
                if ring is None:
                    from livekit_server_tpu_torch.ops.red import RED_DISTANCE

                    # Depth: the plan references packets up to D behind the
                    # CURRENT tick's packets, which also enter this ring —
                    # a flush can stage up to K packets, so keep D + K.
                    ring = self._red_ring[key] = deque(
                        maxlen=RED_DISTANCE + self.ingest.dims.pkts
                    )
                st = int(offsets[i]) + int(parsed["payload_off"][i])
                ring.appendleft(
                    (int(sn_arr[i]), bytes(blob[st : st + int(plen[i])]))
                )

        idx = np.nonzero(final)[0]
        if len(idx):
            e_inv = inv[idx]
            raw_ts = parsed["ts"][idx].astype(np.int64)
            aligned = u_aligned[e_inv]
            # SR-based cross-layer alignment: subtract this layer's delta so
            # all simulcast layers share layer 0's timeline; the munger then
            # carries TS straight through a source switch (ts_aligned ⇒
            # ts_jump = -1 on device).
            ts = np.where(aligned, (raw_ts - u_delta[e_inv]) & 0xFFFFFFFF, raw_ts)
            kf = parsed["keyframe"][idx].astype(bool)
            is_vid = u_video[e_inv]
            layer = u_layer[e_inv].copy()
            temporal = parsed["tid"][idx].astype(np.int32)
            begin_pic = parsed["begin_pic"][idx].astype(bool)
            layer_sync = parsed["layer_sync"][idx].astype(bool)
            end_frame = parsed["end_frame"][idx].astype(bool)
            dd_start = np.full(len(idx), -1, np.int64)
            dd_length = np.zeros(len(idx), np.int32)
            dd_ver = np.full(len(idx), -1, np.int32)
            # Plain-VP9 SVC (no DD extension on the packet): the spatial
            # layer comes from the VP9 picture header's SID
            # (buffer.go:599-671 → vp9.go:43) — without this, DD-less VP9
            # silently loses layer switching.
            vp9_sid = parsed["sid"][idx].astype(np.int32)
            use_sid = (
                u_svc[e_inv] & (parsed["dd_off"][idx] < 0) & (vp9_sid >= 0)
            )
            layer = np.where(use_sid, vp9_sid, layer)
            svc_dd = np.nonzero(u_svc[e_inv] & (parsed["dd_off"][idx] >= 0))[0]
            if len(svc_dd):
                from livekit_server_tpu_torch.runtime import dd as dd_mod

                for j in svc_dd:
                    i = idx[j]
                    key = (int(u_room[e_inv[j]]), int(u_track[e_inv[j]]))
                    raw = bytes(blob[
                        int(parsed["dd_off"][i]) :
                        int(parsed["dd_off"][i]) + int(parsed["dd_len"][i])
                    ])
                    hist = self._dd_structs.get(key)
                    struct = hist[-1][1] if hist else None
                    ver = hist[-1][0] if hist else -1
                    try:
                        desc = (
                            dd_mod.parse(raw) if struct is None
                            else dd_mod.parse_with_structure(raw, struct)
                        )
                    except dd_mod.NeedStructure:
                        # Cold structure cache (restart mid-stream): the
                        # descriptor can't be interpreted, but its bytes
                        # are forwardable as-is — keep them on the packet
                        # (ver -1 ⇒ egress never rewrites the mask).
                        dd_start[j] = int(parsed["dd_off"][i])
                        dd_length[j] = int(parsed["dd_len"][i])
                        continue
                    except ValueError:
                        continue  # malformed: keep defaults, strip DD
                    if desc.structure is not None:
                        struct = desc.structure
                        ver += 1
                        hist = (hist or []) + [(ver, struct)]
                        self._dd_structs[key] = hist[-2:]
                        kf[j] = True            # structures ride keyframes
                        layer_sync[j] = True
                    if struct is not None:
                        # refine_layer honors per-frame custom DTIs: a frame
                        # skipped for low decode targets gets its effective
                        # temporal raised so layer selection drops it for
                        # those subscribers (the reference's custom-dti
                        # precedence in the DD selector).
                        sp, tp = desc.refine_layer(struct)
                        layer[j] = sp
                        temporal[j] = tp
                    begin_pic[j] = desc.first_packet_in_frame
                    end_frame[j] = desc.last_packet_in_frame
                    dd_start[j] = int(parsed["dd_off"][i])
                    dd_length[j] = int(parsed["dd_len"][i])
                    dd_ver[j] = ver
            self.ingest.push_batch(
                room=u_room[e_inv],
                track=u_track[e_inv],
                layer=layer,
                sn=sn_arr[idx].astype(np.int64),
                ts=ts,
                ts_aligned=aligned,
                temporal=temporal,
                keyframe=kf,
                layer_sync=layer_sync | kf,
                begin_pic=begin_pic,
                marker=parsed["marker"][idx].astype(bool),
                end_frame=end_frame,
                pid=np.maximum(parsed["picture_id"][idx], 0),
                tl0=np.maximum(parsed["tl0picidx"][idx], 0),
                keyidx=np.maximum(parsed["keyidx"][idx], 0),
                size=plen[idx].astype(np.int32),
                frame_ms=np.where(is_vid, 0, 20).astype(np.int32),
                audio_level=parsed["audio_level"][idx].astype(np.int32),
                arrival_rtp=parsed["ts"][idx].astype(np.int64),
                pay_start=offsets[idx].astype(np.int64)
                + parsed["payload_off"][idx].astype(np.int64),
                pay_length=plen[idx],
                blob=blob,
                dd_start=dd_start,
                dd_length=dd_length,
                dd_version=dd_ver,
                t_rx=t_rx if t_rx else time.perf_counter(),
            )
        self._send_upstream_nacks(now_ms)

    def _send_srs(self, now_ms: float) -> None:
        """~1/s sender reports per downtrack SSRC: RTT echo anchors + the
        receiver-side sync clients need (rtcpSenderWorker analog)."""
        if now_ms - self._last_sr_ms < 1000.0:
            return
        self._last_sr_ms = now_ms
        self._fold_txsr()
        ntp = ntp_now()
        mid = ntp_mid32(ntp)
        for ssrc, st in self._tx_sr.items():
            dest = self.egress_rev.get(ssrc)
            if dest is None:
                continue
            addr = self.sub_addrs.get((dest[0], dest[1]))
            if addr is None:
                continue
            # RFC 3550 §6.4.1: the SR's RTP TS must correspond to the SAME
            # instant as its NTP TS — extrapolate from the last packet's TS
            # by the wallclock elapsed since it was sent, else the anchor
            # skews by a frame (or unboundedly on a paused track) and
            # receiver lip-sync drifts.
            clock = 90_000 if self.track_kind.get((dest[0], dest[2]), True) else 48_000
            rtp_ts = (st[2] + int((now_ms - st[3]) * clock / 1000.0)) & 0xFFFFFFFF
            self._sendto(
                build_sr(ssrc, ntp, rtp_ts, st[0], st[1]), addr,
                self.sub_sessions.get((dest[0], dest[1])),
            )
            # Keep the last few mids: an RR may echo an SR one or two
            # behind; anything else is a stale/garbage LSR we must not
            # let poison rtt_ms (it throttles NACK replays).
            mids = self._sr_sent.setdefault(ssrc, [])
            mids.append(mid)
            del mids[:-4]
        # Media-loss proxy upstream relay (medialossproxy.go:82
        # maybeUpdateLoss, downLostUpdateDelta = 1 s): one RR per audio
        # publisher SSRC carrying the window's max subscriber loss.
        if self._down_frac_lost:
            window, self._down_frac_lost = self._down_frac_lost, {}
            for ssrc, b in self.bindings.items():
                frac = window.get((b.room, b.track))
                if frac is None:
                    continue
                addr = self.addrs.get(ssrc)
                if addr is not None:
                    self._sendto(build_rr(self.node_ssrc, ssrc, frac), addr, b.session)

    def _pacer_gate(self, batch, allowed, udp_mask) -> np.ndarray:
        """Leaky-bucket egress gate: drain the deferred queue under this
        tick's per-(room, sub) byte budgets, then admit in-batch UDP
        entries FIFO until each subscriber's budget runs out. Returns the
        admit mask; over-budget entries are queued as packets (bounded —
        overflow drops newest, a pacer is loss-tolerant by design)."""
        PACER_QUEUE_MAX = 4096
        remaining = np.asarray(allowed, np.float64).copy()
        blocked: set = set()
        if self._pacer_queue:
            send_now, keep = [], []
            for pkt in self._pacer_queue:
                key = (pkt.room, pkt.sub)
                cost = pkt.size + WIRE_OVERHEAD_BYTES
                if key in blocked or remaining[key] < cost:
                    blocked.add(key)   # FIFO per sub: block all behind it
                    keep.append(pkt)
                else:
                    remaining[key] -= cost
                    send_now.append(pkt)
            self._pacer_queue = keep
            if send_now:
                self.send_egress(send_now)
        n = len(batch)
        r, t, k, s = batch.rooms, batch.tracks, batch.ks, batch.subs
        # Budgets model wire bytes: charge the fixed per-packet overhead the
        # device bucket charges too (ops/pacer.WIRE_OVERHEAD_BYTES), or the
        # host admits a few percent more wire bytes than the bucket granted.
        sizes = (
            np.maximum(batch.payloads.length[r, t, k].astype(np.int64), 0)
            + WIRE_OVERHEAD_BYTES
        )
        S = remaining.shape[1]
        key = r.astype(np.int64) * S + s
        order = np.argsort(key, kind="stable")          # per-sub FIFO kept
        ks_ = key[order]
        cs = np.cumsum(np.where(udp_mask[order], sizes[order], 0))
        grp_first = np.r_[True, ks_[1:] != ks_[:-1]] if n else np.zeros(0, bool)
        first_idx = np.flatnonzero(grp_first)
        base = np.repeat(
            np.r_[0, cs[first_idx[1:] - 1]] if len(first_idx) else np.zeros(0),
            np.diff(np.r_[first_idx, n]),
        )
        cum = cs - base
        rem_sorted = remaining[r[order], s[order]]
        blk = np.zeros(n, bool)
        if blocked:
            blk = np.fromiter(
                ((int(a), int(b)) in blocked
                 for a, b in zip(r[order], s[order])), bool, n,
            )
        ok_sorted = (cum <= rem_sorted) & ~blk
        mask = np.empty(n, bool)
        mask[order] = ok_sorted
        mask |= ~udp_mask                                # pace UDP only
        defer = ~mask & udp_mask
        if defer.any():
            deferred = batch.to_packets(defer)
            space = PACER_QUEUE_MAX - len(self._pacer_queue)
            if len(deferred) > space:
                self.stats["pacer_dropped"] = (
                    self.stats.get("pacer_dropped", 0) + len(deferred) - space
                )
                deferred = deferred[:space]
            self._pacer_queue.extend(deferred)
            self.stats["pacer_deferred"] = (
                self.stats.get("pacer_deferred", 0) + len(deferred)
            )
        return mask

    def attach_egress_plane(self, plane) -> None:
        """Adopt the runtime's sharded egress orchestrator
        (runtime/egress_plane.py). From the next tick on,
        send_egress_batch routes through the native plane path —
        room-aligned shards on the persistent worker pool with
        multicast-shaped canonical staging — and reports per-shard
        stage timings back through `plane.record_send`."""
        self._egress_plane = plane
        if plane is not None:
            plane.warm()

    def attach_express(self, lane) -> None:
        """Bind an ExpressLane (runtime/express.py): this transport
        supplies its UDP-fast-path subscriber set and carries its wire
        sends; the lane takes each staged receive batch through the
        ingest's arrival hook."""
        lane.sub_provider = self._express_sub_provider
        lane.sender = self._send_express

    def _express_sub_provider(self) -> np.ndarray:
        """[R, S] bool — subscribers the express lane may own: plain UDP
        fast-path only. TCP-fallback, SRTP-gateway, WebSocket, and RED
        subscribers keep riding the batched tick (their egress paths
        re-encapsulate per frame and don't fit the small-batch seal)."""
        self._maybe_resync_subs()
        return (self._sub_port != 0) & ~self._sub_tcp & ~self._sub_red_arr

    def _send_express(self, cols) -> int:
        """Express-lane egress: one receive batch's forwarding decisions
        → wire, now.

        The small-batch twin of send_egress_batch: same destination
        gathers, seal/counter discipline, TWCC stamping, and SR/tx
        bookkeeping, but no shard planning, no pacer gate, and no RED/DD
        handling (RED subs and SVC rooms are express-ineligible). The
        native egress_express_send entry reuses the persistent worker
        pool, key-schedule cache, and P3FA staging of the batch path.
        Returns datagrams handed to the kernel."""
        n = len(cols)
        if n == 0:
            return 0
        self._maybe_resync_subs()
        r, t, s = cols.rooms, cols.tracks, cols.subs
        e_port = self._sub_port[r, s]
        # Re-filter against live destination state: a sub can churn (or
        # flip to TCP fallback) between the lane's retier and this
        # arrival; the batched tier will NOT cover it (the room row is
        # masked), so a dropped entry here is at worst one lost datagram
        # to a disconnecting sub.
        idx = np.nonzero(
            (e_port != 0) & ~self._sub_tcp[r, s] & (cols.pay_len > 0)
        )[0]
        if not len(idx):
            return 0
        use_native = (
            native.egress is not None and self.transport is not None
        )
        if not use_native:
            # Toolchain-free fallback: per-packet Python path (sealing
            # and protection happen inside send_egress).
            from livekit_server_tpu_torch.runtime.plane_runtime import EgressPacket

            slab = cols.slab
            pkts = []
            for j in idx:
                off, ln = int(cols.pay_off[j]), int(cols.pay_len[j])
                pkts.append(EgressPacket(
                    room=int(r[j]), track=int(t[j]), sub=int(s[j]),
                    sn=int(cols.sn[j]) & 0xFFFF,
                    ts=int(cols.ts[j]) & 0xFFFFFFFF,
                    pid=int(cols.pid[j]), tl0=int(cols.tl0[j]),
                    keyidx=int(cols.keyidx[j]), size=ln,
                    payload=bytes(slab[off:off + ln]),
                    marker=bool(cols.marker[j]),
                    t_arr=float(cols.t_arr[j]),
                ))
            _t_send0 = time.perf_counter()
            self.send_egress(pkts)
            send_now = time.perf_counter()
            if self._egress_plane is not None:
                self._egress_plane.record_express(
                    len(pkts), int((send_now - _t_send0) * 1e9)
                )
            if self.wire_stages is not None:
                self.wire_stages.observe_express(
                    cols.sn[idx], cols.t_arr[idx], send_now
                )
            return len(pkts)
        # Destination-major stable order (GSO runs in the native sender);
        # entries arrive in k-order per stream, the stable sort keeps it.
        _S = self._sub_port.shape[1]
        _T = self.ingest.dims.tracks
        composite = (r[idx].astype(np.int64) * _S + s[idx]) * _T + t[idx]
        idx = idx[np.argsort(composite, kind="stable")]
        rr_, tt_, ss_ = r[idx], t[idx], s[idx]
        ssrc = self._egress_ssrc_arr[rr_, ss_, tt_].copy()
        for m_ in np.nonzero(ssrc == 0)[0]:  # first send of a new sub only
            ssrc[m_] = self.subscriber_ssrc(
                int(rr_[m_]), int(ss_[m_]), int(tt_[m_])
            )
        try:
            now_ms = asyncio.get_event_loop().time() * 1000.0
        except RuntimeError:
            now_ms = time.monotonic() * 1000.0
        # Seal + per-session counter blocks: identical discipline to the
        # batch path — counters come from the SAME per-session array, so
        # express and batched sends never collide on a nonce.
        e_sess = self._sub_sess_idx[rr_, ss_]
        n_sess = len(self._sessions)
        if n_sess:
            seal = (e_sess >= 0) & (
                self.require_encryption
                | (self._sess_active[np.maximum(e_sess, 0)] > 0)
            )
        else:
            seal = np.zeros(len(idx), bool)
        key_idx = np.where(seal, e_sess, -1).astype(np.int32)
        ctr = np.zeros(len(idx), np.uint64)
        if seal.any():
            sealed_pos = np.nonzero(seal)[0]
            es = e_sess[sealed_pos]
            u, cnts = np.unique(es, return_counts=True)
            base = np.zeros(n_sess, np.uint64)
            base[u] = self._sess_ctr[u]
            self._sess_ctr[u] += cnts.astype(np.uint64)
            order = np.argsort(es, kind="stable")
            sorted_es = es[order]
            grp_start = np.r_[0, np.nonzero(np.diff(sorted_es))[0] + 1]
            sizes = np.diff(np.r_[grp_start, len(es)])
            ranks = np.empty(len(es), np.int64)
            ranks[order] = np.arange(len(es)) - np.repeat(grp_start, sizes)
            ctr[sealed_pos] = base[es] + ranks.astype(np.uint64)
            sp_r, sp_s = rr_[sealed_pos], ss_[sealed_pos]
            sp_slot = (ctr[sealed_pos] & np.uint64(TWCC_RING - 1)).astype(np.int64)
            self._twcc_ms[sp_r, sp_s, sp_slot] = now_ms
            self._twcc_ctr[sp_r, sp_s, sp_slot] = ctr[sealed_pos].astype(np.int64)
            self._twcc_len[sp_r, sp_s, sp_slot] = (
                cols.pay_len[idx][sealed_pos] + WIRE_OVERHEAD_BYTES
            )
        keys = self._sess_keys if n_sess else np.zeros((1, 16), np.uint8)
        key_ids = self._sess_keyids if n_sess else np.zeros(1, np.uint32)
        # Header extensions: playout-delay only (one shared 3-byte
        # section). SVC rooms are express-ineligible, so no DD patching.
        ext_blob, ext_off, ext_len = b"", None, None
        if self.playout_delay is not None:
            is_vid = self._track_is_video[rr_, tt_]
            if is_vid.any():
                mn, mx = self.playout_delay
                val = (min(mn // 10, 4095) << 12) | min(mx // 10, 4095)
                sec = build_ext_section(
                    [(PLAYOUT_DELAY_EXT_ID, val.to_bytes(3, "big"))]
                )
                ext_blob = sec
                ext_off = np.zeros(len(idx), np.int64)
                ext_len = np.where(is_vid, len(sec), 0).astype(np.int32)
        fd = self.transport.get_extra_info("socket").fileno()
        _t_send0 = time.perf_counter()
        _, _, _, sent, _ = native.egress.send_express(
            fd=fd, slab=cols.slab,
            pay_off=cols.pay_off[idx], pay_len=cols.pay_len[idx],
            marker=cols.marker[idx],
            pt=self._track_pt[rr_, tt_],
            vp8=(
                self._track_is_video[rr_, tt_] & ~self._track_svc[rr_, tt_]
            ).astype(np.uint8),
            sn=(cols.sn[idx] & 0xFFFF).astype(np.uint16),
            ts=(cols.ts[idx].astype(np.int64) & 0xFFFFFFFF).astype(np.uint32),
            ssrc=ssrc,
            pid=cols.pid[idx], tl0=cols.tl0[idx], kidx=cols.keyidx[idx],
            ip=self._sub_ip[rr_, ss_], port=e_port[idx],
            seal=seal.astype(np.uint8), key_idx=key_idx,
            keys=keys, key_ids=key_ids, counters=ctr,
            ext_blob=ext_blob, ext_off=ext_off, ext_len=ext_len,
        )
        self.stats["tx"] += sent
        if sent < len(idx):
            self.stats["tx_drop"] = (
                self.stats.get("tx_drop", 0) + len(idx) - sent
            )
        send_now = time.perf_counter()
        if self._egress_plane is not None:
            # Express sends count toward the host-egress pps/wall stats.
            self._egress_plane.record_express(
                int(sent), int((send_now - _t_send0) * 1e9)
            )
        t_arr = cols.t_arr[idx]
        stamped = t_arr[t_arr > 0.0]
        if stamped.size:
            self.fwd_latency_express.observe(send_now - stamped)
        if self.wire_stages is not None:
            self.wire_stages.observe_express(cols.sn[idx], t_arr, send_now)
        # SR/tx bookkeeping (add.at — express batches are tiny relative
        # to the plane, bincount temporaries never pay off here).
        S = self.ingest.dims.subs
        flat = (rr_.astype(np.int64) * S + ss_) * _T + tt_
        np.add.at(self._txsr_pkts.reshape(-1), flat, 1)
        np.add.at(self._txsr_oct.reshape(-1), flat, cols.pay_len[idx])
        self._txsr_ts[rr_, ss_, tt_] = (
            cols.ts[idx].astype(np.int64) & 0xFFFFFFFF
        ).astype(np.uint32)
        self._txsr_ms[rr_, ss_, tt_] = now_ms
        flat_rs = rr_.astype(np.int64) * S + ss_
        np.add.at(self.tx_pkts.reshape(-1), flat_rs, 1)
        np.add.at(
            self.tx_bytes.reshape(-1), flat_rs,
            cols.pay_len[idx].astype(np.int64) + WIRE_OVERHEAD_BYTES,
        )
        return int(sent)

    def send_egress_batch(self, batch, red_plan=None, layer_caps=None,
                          pacer_allowed=None) -> np.ndarray:
        """Vectorized tick egress (the hot half of DownTrack.WriteRTP +
        pion/srtp + pacer socket writes): per-entry field arrays are
        assembled with numpy index math and handed to ONE native call that
        builds datagrams, patches VP8 descriptors, seals, and sendmmsg()s
        across a small thread fan-out. No per-packet Python objects.

        Returns a [N] bool mask of entries that have a UDP/TCP media
        destination — the caller delivers the complement over WebSocket.
        """
        n = len(batch)
        if n == 0:
            # A quiet tick still drains the pacer's deferred queue.
            if (self.pacer_mode == "leaky-bucket" and pacer_allowed is not None
                    and self._pacer_queue):
                self._pacer_gate(batch, pacer_allowed, np.zeros(0, bool))
            return np.zeros(0, bool)
        r, t, k, s = batch.rooms, batch.tracks, batch.ks, batch.subs
        # Destination resolution: pure array gathers from the persistent
        # per-(room, sub) mirrors (resynced only on subscription churn) —
        # no per-subscriber Python loop on the per-tick path.
        self._maybe_resync_subs()
        e_port = self._sub_port[r, s]
        e_tcp = self._sub_tcp[r, s]
        has_dest = (e_port != 0) | e_tcp
        pacing = self.pacer_mode == "leaky-bucket" and pacer_allowed is not None

        if native.egress is None or self.transport is None:
            # Toolchain-free fallback: the per-packet Python path.
            pace_ok = (
                self._pacer_gate(batch, pacer_allowed, e_port != 0)
                if pacing else np.ones(n, bool)
            )
            if self.transport is not None or self.tcp_sinks:
                self.send_egress(batch.to_packets(has_dest & pace_ok))
            return has_dest

        # Shared flat index for the slab-field gathers (off/length/marker).
        _T = batch.payloads.off.shape[1]
        _K = batch.payloads.off.shape[2]
        flat_rtk = (r.astype(np.int64) * _T + t) * _K + k
        po = batch.payloads.off.reshape(-1)[flat_rtk]
        pl = batch.payloads.length.reshape(-1)[flat_rtk]
        # RED-negotiated audio entries leave the fast path: their payloads
        # are re-encapsulated per RFC 2198 from the device's plan.
        now_ms = asyncio.get_event_loop().time() * 1000.0
        red_mask = np.zeros(n, bool)
        if self.sub_red and red_plan is not None and red_plan[0].size:
            red_mask = (
                self._sub_red_arr[r, s] & (e_port != 0) & (po >= 0)
                & ~self._track_is_video[r, t]
            )
            if red_mask.any():
                self._send_red(batch, red_plan, red_mask, po, pl, now_ms)
        # RED entries already left on the wire above, so the pacer must not
        # also defer them (duplicate delivery); low-rate RED audio rides
        # unpaced, like the reference pacer's priority audio.
        pace_ok = (
            self._pacer_gate(batch, pacer_allowed, (e_port != 0) & ~red_mask)
            if pacing else np.ones(n, bool)
        )
        idx = np.nonzero((e_port != 0) & (po >= 0) & ~red_mask & pace_ok)[0]
        if len(idx):
            # Destination-major order (stable in k): consecutive entries to
            # one subscriber make long equal-size runs the native sender
            # collapses into single GSO messages — the syscall count drops
            # from per-datagram to per-(subscriber, track) burst. Within a
            # (room, sub, track) stream k-order is preserved, so SNs still
            # leave the host in order. One composite-key argsort instead of
            # a 4-key lexsort: each lexsort pass re-permutes all keys, the
            # fused int64 key sorts once (dims bound each factor).
            _S = self._sub_port.shape[1]
            composite = (
                ((r[idx].astype(np.int64) * _S + s[idx]) * _T + t[idx]) * _K
                + k[idx]
            )
            idx = idx[np.argsort(composite, kind="stable")]
            rr_, tt_, ss_ = r[idx], t[idx], s[idx]
            kk_ = k[idx]
            ssrc = self._egress_ssrc_arr[rr_, ss_, tt_].copy()
            for m_ in np.nonzero(ssrc == 0)[0]:  # first tick of a new sub only
                ssrc[m_] = self.subscriber_ssrc(int(rr_[m_]), int(ss_[m_]), int(tt_[m_]))
            e_sess = self._sub_sess_idx[rr_, ss_]
            n_sess = len(self._sessions)
            if n_sess:
                seal = (e_sess >= 0) & (
                    self.require_encryption
                    | (self._sess_active[np.maximum(e_sess, 0)] > 0)
                )
            else:
                seal = np.zeros(len(idx), bool)
            key_idx = np.where(seal, e_sess, -1).astype(np.int32)
            ctr = np.zeros(len(idx), np.uint64)
            if seal.any():
                # Allocate each session a contiguous counter block for this
                # batch, fully vectorized over the shared counter array
                # (sessions seal RTCP between ticks through the SAME array
                # slot — crypto.bind_counter — so nonces never collide).
                sealed_pos = np.nonzero(seal)[0]
                es = e_sess[sealed_pos]
                u, cnts = np.unique(es, return_counts=True)
                base = np.zeros(n_sess, np.uint64)
                base[u] = self._sess_ctr[u]
                self._sess_ctr[u] += cnts.astype(np.uint64)
                order = np.argsort(es, kind="stable")
                sorted_es = es[order]
                grp_start = np.r_[0, np.nonzero(np.diff(sorted_es))[0] + 1]
                sizes = np.diff(np.r_[grp_start, len(es)])
                ranks = np.empty(len(es), np.int64)
                ranks[order] = np.arange(len(es)) - np.repeat(grp_start, sizes)
                ctr[sealed_pos] = base[es] + ranks.astype(np.uint64)
                # TWCC send-time ring: every sealed datagram's counter is
                # its transport-wide sequence number — record send time +
                # wire size for the feedback matcher (_handle_twcc).
                sp_r, sp_s = rr_[sealed_pos], ss_[sealed_pos]
                sp_slot = (ctr[sealed_pos] & np.uint64(TWCC_RING - 1)).astype(np.int64)
                self._twcc_ms[sp_r, sp_s, sp_slot] = now_ms
                self._twcc_ctr[sp_r, sp_s, sp_slot] = ctr[sealed_pos].astype(np.int64)
                self._twcc_len[sp_r, sp_s, sp_slot] = (
                    pl[idx][sealed_pos] + WIRE_OVERHEAD_BYTES
                )
            keys = self._sess_keys if n_sess else np.zeros((1, 16), np.uint8)
            key_ids = self._sess_keyids if n_sess else np.zeros(1, np.uint32)
            ext_blob, ext_off, ext_len = b"", None, None
            if self.playout_delay is not None or self._svc_tracks:
                ext_blob, ext_off, ext_len = self._build_ext_sections(
                    batch, rr_, tt_, kk_, ss_, layer_caps
                )
            pace_us = int(self.pacer_spread_ms * 1000)
            fd = self.transport.get_extra_info("socket").fileno()
            if pace_us > 0:
                # Paced sends sleep inside the native call; run them OFF
                # the event loop (one worker: tick order preserved). If
                # the previous paced send hasn't drained, burst this one
                # inline instead of queueing stale media.
                if self._pace_pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._pace_pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="pacer"
                    )
                if self._pace_pending is not None and not self._pace_pending.done():
                    pace_us = 0
            send_args = dict(
                fd=fd,
                slab=batch.payloads.data,
                pay_off=po[idx], pay_len=pl[idx],
                marker=batch.payloads.marker.reshape(-1)[
                    flat_rtk[idx]
                ].astype(np.uint8),
                pt=self._track_pt[rr_, tt_],
                vp8=(
                    self._track_is_video[rr_, tt_] & ~self._track_svc[rr_, tt_]
                ).astype(np.uint8),
                sn=(batch.sn[idx] & 0xFFFF).astype(np.uint16),
                ts=(batch.ts[idx].astype(np.int64) & 0xFFFFFFFF).astype(np.uint32),
                ssrc=ssrc,
                pid=batch.pid[idx], tl0=batch.tl0[idx], kidx=batch.keyidx[idx],
                ip=self._sub_ip[rr_, ss_], port=e_port[idx],
                seal=seal.astype(np.uint8), key_idx=key_idx,
                keys=keys, key_ids=key_ids, counters=ctr,
                ext_blob=ext_blob, ext_off=ext_off, ext_len=ext_len,
                pace_window_us=pace_us,
            )
            n_entries = len(idx)
            plane = self._egress_plane
            use_plane = plane is not None and hasattr(native.egress, "send_sharded")
            if use_plane:
                # Sharded plane path: room-aligned entry ranges on the
                # persistent pool, canonical-group slots for the
                # multicast-shaped assembly, per-shard timings recorded.
                sh_lo, sh_hi = plane.entry_plan(rr_)
                grp, grp_slots = plane.group_slots(
                    flat_rtk[idx], tt_, kk_, _T, _K
                )
                if grp is None:
                    grp = np.full(n_entries, -1, np.int32)
                    grp_slots = 0
                send_args.update(
                    shard_lo=sh_lo, shard_hi=sh_hi,
                    rooms=rr_.astype(np.int32), grp=grp, grp_slots=grp_slots,
                )
                n_grouped = int((grp >= 0).sum())
            else:
                send_args["n_threads"] = self.egress_threads
            t_arr = (
                batch.payloads.t_arr.reshape(-1)[flat_rtk[idx]]
                if batch.payloads.t_arr is not None else None
            )

            def do_send(args=send_args, n_entries=n_entries, t_arr=t_arr,
                        sn_s=batch.sn[idx], ws=self.wire_stages,
                        t_disp=getattr(batch, "t_dispatch", 0.0),
                        t_dev=getattr(batch, "t_device_end", 0.0)):
                if use_plane:
                    (_, _, _, sent, sh_sent, sh_built,
                     sh_ns) = native.egress.send_sharded(**args)
                    plane.record_send(
                        n_entries, n_grouped, sent,
                        args["shard_lo"], args["shard_hi"],
                        sh_sent, sh_built, sh_ns,
                    )
                else:
                    _, _, _, sent = native.egress.send(**args)
                self.stats["tx"] += sent
                if sent < n_entries:
                    self.stats["tx_drop"] = (
                        self.stats.get("tx_drop", 0) + n_entries - sent
                    )
                if t_arr is not None:
                    # Wire-out stamp: the kernel has every datagram now.
                    send_now = time.perf_counter()
                    stamped = t_arr[t_arr > 0.0]
                    if stamped.size:
                        self.fwd_latency.observe(send_now - stamped)
                    if ws is not None:
                        # Sampled per-stage decomposition: arrival →
                        # dispatch (staging+queue wait), dispatch →
                        # device end, device end → wire.
                        ws.observe_batch(sn_s, t_arr, t_disp, t_dev, send_now)

            if pace_us > 0:
                self._pace_pending = self._pace_pool.submit(do_send)
            else:
                do_send()
            # SR bookkeeping accumulators, folded at SR cadence. bincount
            # allocates plane-sized temporaries — only worth it when the
            # batch is a sizable fraction of the plane; otherwise add.at
            # scales with entries sent.
            R, T, S = (self.ingest.dims.rooms, self.ingest.dims.tracks,
                       self.ingest.dims.subs)
            flat = (rr_.astype(np.int64) * S + ss_) * T + tt_
            if R * S * T <= 4 * len(flat):
                self._txsr_pkts += np.bincount(
                    flat, minlength=R * S * T
                ).reshape(R, S, T)
                self._txsr_oct += np.bincount(
                    flat, weights=pl[idx].astype(np.float64), minlength=R * S * T
                ).astype(np.int64).reshape(R, S, T)
            else:
                np.add.at(self._txsr_pkts.reshape(-1), flat, 1)
                np.add.at(self._txsr_oct.reshape(-1), flat, pl[idx])
            self._txsr_ts[rr_, ss_, tt_] = (
                batch.ts[idx].astype(np.int64) & 0xFFFFFFFF
            ).astype(np.uint32)
            self._txsr_ms[rr_, ss_, tt_] = now_ms
            flat_rs = rr_.astype(np.int64) * S + ss_
            np.add.at(self.tx_pkts.reshape(-1), flat_rs, 1)
            np.add.at(
                self.tx_bytes.reshape(-1), flat_rs,
                pl[idx].astype(np.int64) + WIRE_OVERHEAD_BYTES,
            )
        if (e_tcp & (po >= 0)).any():
            # TCP-fallback + SRTP-gateway subscribers: cold path,
            # per-frame sealing/protection via _sendto.
            self.send_egress(batch.to_packets(e_tcp & (po >= 0)))
        self._send_srs(now_ms)
        if self.gateway is not None:
            self.gateway.service_timers()
        return has_dest

    def _maybe_resync_subs(self) -> None:
        """Rebuild the destination/session arrays from the dicts when
        subscription state changed (register/release/punch/bind bump
        `_subs_rev`; the length checks catch direct dict writers)."""
        import socket as _socket

        key = (self._subs_rev, len(self.sub_addrs), len(self.sub_sessions))
        if key == self._subs_synced:
            return
        self._sub_ip[:] = 0
        self._sub_port[:] = 0
        self._sub_tcp[:] = False
        self._sub_red_arr[:] = False
        self._sub_sess_idx[:] = -1
        R, S = self._sub_ip.shape
        for (room, sub), addr in self.sub_addrs.items():
            if not (0 <= room < R and 0 <= sub < S):
                continue
            if addr[0] in ("tcp", "srtp"):
                # Non-UDP-fast-path lanes (TCP fallback, SRTP gateway):
                # egress rides the per-packet cold path via _sendto.
                self._sub_tcp[room, sub] = True
            else:
                try:
                    self._sub_ip[room, sub] = int.from_bytes(
                        _socket.inet_aton(addr[0]), "big"
                    )
                except OSError:
                    # Loud enough to find: a hostname here means a caller
                    # bypassed the resolve step; the sub gets no egress.
                    self.stats["bad_sub_addr"] = self.stats.get("bad_sub_addr", 0) + 1
                    continue
                self._sub_port[room, sub] = addr[1]
        for room, sub in self.sub_red:
            if 0 <= room < R and 0 <= sub < S:
                self._sub_red_arr[room, sub] = True
        sessions = []
        sess_idx_by_id: dict[int, int] = {}
        for (room, sub), sess in self.sub_sessions.items():
            if not (0 <= room < R and 0 <= sub < S):
                continue
            # Dedup by identity: a session bound under two keys must get
            # ONE counter slot — two slots seeded alike would hand out
            # duplicate GCM nonces under one key.
            j = sess_idx_by_id.get(id(sess))
            if j is None:
                j = sess_idx_by_id[id(sess)] = len(sessions)
                sessions.append(sess)
            self._sub_sess_idx[room, sub] = j
        self._sessions = sessions
        n = len(sessions)
        self._sess_keys = np.frombuffer(
            b"".join(x.key for x in sessions), np.uint8
        ).reshape(n, 16) if n else np.zeros((0, 16), np.uint8)
        self._sess_keyids = np.array([x.key_id for x in sessions], np.uint32)
        self._sess_active = np.array(
            [1 if x.client_active else 0 for x in sessions], np.uint8
        )
        # Shared counter slots: GCM nonces must be unique per key, so both
        # the vectorized bulk allocation and per-frame seal() draw from
        # the same array cell (crypto.bind_counter).
        self._sess_ctr = np.zeros(n, np.uint64)
        for j, x in enumerate(sessions):
            x.bind_counter(self._sess_ctr, j)
            x._arr_idx = j
        self._subs_synced = key

    def _touch_subs(self) -> None:
        self._subs_rev += 1

    def _build_ext_sections(self, batch, rr_, tt_, kk_, ss_, layer_caps):
        """Per-entry RTP header-extension sections for the native assembler:
        playout delay on video, and for SVC entries the re-attached
        dependency descriptor (sfu/dependencydescriptor) with the
        active-decode-targets bitmask patched to the subscriber's layer
        caps (videolayerselector/dependencydescriptor.go:65 selection →
        writer :254 bitmask rewrite). Sections are deduped per
        (source packet, mask) — subscribers with identical caps share
        bytes."""
        from livekit_server_tpu_torch.runtime import dd as dd_mod

        n = len(rr_)
        off = np.zeros(n, np.int64)
        ln = np.zeros(n, np.int32)
        parts: list[bytes] = []
        total = 0
        pd_bytes = b""
        pd_section_off = -1
        if self.playout_delay is not None:
            mn, mx = self.playout_delay
            # Clamp to the extension's 12-bit fields (playoutdelay.go).
            val = (min(mn // 10, 4095) << 12) | min(mx // 10, 4095)
            pd_bytes = val.to_bytes(3, "big")
            sec = build_ext_section([(PLAYOUT_DELAY_EXT_ID, pd_bytes)])
            parts.append(sec)
            pd_section_off = 0
            total += len(sec)

        is_vid = self._track_is_video[rr_, tt_]
        dd_offs = batch.payloads.dd_off
        if dd_offs is not None:
            has_dd = dd_offs[rr_, tt_, kk_] >= 0
        else:
            has_dd = np.zeros(n, bool)
        if pd_section_off >= 0:
            m = is_vid & ~has_dd
            off[m] = pd_section_off
            ln[m] = len(parts[0])

        if has_dd.any():
            max_sp, max_tp = layer_caps if layer_caps is not None else (None, None)
            data = batch.payloads.data
            cache: dict = {}
            dt_layers_cache: dict = {}
            dd_vers = batch.payloads.dd_ver
            for i in np.nonzero(has_dd)[0]:
                rr, tt, kk, ss = int(rr_[i]), int(tt_[i]), int(kk_[i]), int(ss_[i])
                ver = int(dd_vers[rr, tt, kk]) if dd_vers is not None else -1
                struct = None
                for v, st in self._dd_structs.get((rr, tt), ()):  # last 2
                    if v == ver:
                        struct = st
                        break
                mask = None
                if struct is not None and max_sp is not None:
                    layers = dt_layers_cache.get(id(struct))
                    if layers is None:
                        layers = dt_layers_cache[id(struct)] = (
                            struct.decode_target_layers()
                        )
                    sp_cap = int(max_sp[rr, tt, ss])
                    tp_cap = int(max_tp[rr, tt, ss])
                    mask = 0
                    for d_i, (sp, tp) in enumerate(layers):
                        if sp <= sp_cap and tp <= tp_cap:
                            mask |= 1 << d_i
                ck = (rr, tt, kk, mask)
                hit = cache.get(ck)
                if hit is None:
                    o = int(dd_offs[rr, tt, kk])
                    raw = data[o : o + int(batch.payloads.dd_len[rr, tt, kk])]
                    if (
                        struct is not None
                        and mask is not None
                        and mask != (1 << struct.num_decode_targets) - 1
                    ):
                        try:
                            desc = dd_mod.parse_with_structure(raw, struct)
                            buf = bytearray(raw)
                            if dd_mod.patch_active_mask(buf, 0, desc, mask):
                                raw = bytes(buf)
                        except ValueError:
                            pass  # unparseable DD forwards unmodified
                    exts = [(DD_EXT_ID, raw)]
                    if pd_bytes:
                        exts.append((PLAYOUT_DELAY_EXT_ID, pd_bytes))
                    sec = build_ext_section(exts)
                    hit = cache[ck] = (total, len(sec))
                    parts.append(sec)
                    total += len(sec)
                off[i], ln[i] = hit
        return b"".join(parts), off, ln

    def _send_red(self, batch, red_plan, red_mask, po, pl, now_ms) -> None:
        """RFC 2198 encapsulation for RED subscribers (redreceiver.go):
        primary payload + up to D redundancy blocks chosen by the device
        plan, bytes from the per-track primary ring. Cold-ish path — runs
        only for opted-in subscribers' audio packets."""
        red_sn, red_off, red_ok = red_plan
        data = batch.payloads.data
        r, t, k, s = batch.rooms, batch.tracks, batch.ks, batch.subs
        mk = batch.payloads.marker
        D = red_sn.shape[-1]
        rings: dict[tuple, dict] = {}
        for i in np.nonzero(red_mask)[0]:
            rr, tt, kk, ss = int(r[i]), int(t[i]), int(k[i]), int(s[i])
            addr = self.sub_addrs.get((rr, ss))
            if addr is None:
                continue
            prim = data[int(po[i]) : int(po[i]) + int(pl[i])]
            ring = rings.get((rr, tt))
            if ring is None:
                ring = rings[(rr, tt)] = dict(self._red_ring.get((rr, tt), ()))
            blocks = []
            for d in range(D - 1, -1, -1):  # oldest first (RFC 2198 order)
                if not red_ok[rr, tt, kk, d]:
                    continue
                pay = ring.get(int(red_sn[rr, tt, kk, d]) & 0xFFFF)
                if pay is not None and len(pay) <= 1023:
                    blocks.append((int(red_off[rr, tt, kk, d]), pay))
            payload = bytearray()
            for off_, pay in blocks:
                payload += bytes([
                    0x80 | OPUS_PT, (off_ >> 6) & 0xFF,
                    ((off_ & 0x3F) << 2) | (len(pay) >> 8), len(pay) & 0xFF,
                ])
            payload.append(OPUS_PT)
            for _, pay in blocks:
                payload += pay
            payload += prim
            hdr = bytearray(12)
            hdr[0] = 0x80
            hdr[1] = (0x80 if mk[rr, tt, kk] else 0) | RED_PT
            hdr[2:4] = (int(batch.sn[i]) & 0xFFFF).to_bytes(2, "big")
            hdr[4:8] = (int(batch.ts[i]) & 0xFFFFFFFF).to_bytes(4, "big")
            ssrc = self.subscriber_ssrc(rr, ss, tt)
            hdr[8:12] = ssrc.to_bytes(4, "big")
            self._sendto(bytes(hdr + payload), addr, self.sub_sessions.get((rr, ss)))
            self.stats["tx"] += 1
            self.stats["red_tx"] = self.stats.get("red_tx", 0) + 1
            # SR bookkeeping (same accumulators the fast path feeds).
            self._txsr_pkts[rr, ss, tt] += 1
            self._txsr_oct[rr, ss, tt] += len(payload)
            self._txsr_ts[rr, ss, tt] = int(batch.ts[i]) & 0xFFFFFFFF
            self._txsr_ms[rr, ss, tt] = now_ms
            self.tx_pkts[rr, ss] += 1
            self.tx_bytes[rr, ss] += len(payload) + WIRE_OVERHEAD_BYTES

    def _fold_txsr(self) -> None:
        """Merge batch-path SR accumulators into the per-SSRC table (runs
        at SR cadence, so the per-SSRC loop is 1/s, not per tick)."""
        nz = np.nonzero(self._txsr_pkts)
        for rr, ss, tt in zip(*nz):
            ssrc = int(self._egress_ssrc_arr[rr, ss, tt])
            if ssrc == 0:
                continue
            st = self._tx_sr.get(ssrc)
            if st is None:
                st = self._tx_sr[ssrc] = [0, 0, 0, 0.0]
            st[0] += int(self._txsr_pkts[rr, ss, tt])
            st[1] += int(self._txsr_oct[rr, ss, tt])
            st[2] = int(self._txsr_ts[rr, ss, tt])
            st[3] = float(self._txsr_ms[rr, ss, tt])
        self._txsr_pkts[:] = 0
        self._txsr_oct[:] = 0

    def send_egress(self, packets, rtx: bool = False) -> None:
        """Rewrite + send a tick's EgressPackets: assemble all datagrams in
        one buffer, ONE native rewrite call (headers + VP8 payload
        descriptors), then sendto per datagram (the batched write half of
        DownTrack.WriteRTP + pacer)."""
        if self.transport is None and not self.tcp_sinks:
            return  # no UDP socket and no TCP-fallback connections
        buf = bytearray()
        offsets: list[int] = []
        lengths: list[int] = []
        sns: list[int] = []
        tss: list[int] = []
        ssrcs: list[int] = []
        pids: list[int] = []
        tl0s: list[int] = []
        keyidxs: list[int] = []
        vp8_flags: list[int] = []
        addrs: list[tuple] = []
        sessions: list = []
        stamps: list[float] = []
        n_pad_sent = 0
        for pkt in packets:
            addr = self.sub_addrs.get((pkt.room, pkt.sub))
            is_padding = getattr(pkt, "padding", False)
            if addr is None or (not pkt.payload and not is_padding):
                continue
            is_video = self.track_kind.get((pkt.room, pkt.track), False)
            is_svc = bool(self._track_svc[pkt.room, pkt.track])
            header = bytearray(12)
            header[0] = 0x80 | (0x20 if is_padding else 0)  # P bit on padding
            # The hot path stamps _track_pt; the cold path (RTX replays,
            # TCP fallback, pacer-deferred) must match it exactly or a
            # retransmitted H264 packet arrives under a different PT than
            # its stream and is discarded.
            header[1] = (0x80 if pkt.marker else 0) | int(
                self._track_pt[pkt.room, pkt.track]
            )
            # Header extensions on this cold path too: DD for SVC packets
            # (unpatched — per-sub mask rewrite is the batch path's job)
            # and playout delay on video.
            exts = []
            if getattr(pkt, "dd", b"") and not is_padding:
                exts.append((DD_EXT_ID, pkt.dd))
            if self.playout_delay is not None and is_video and not is_padding:
                mn, mx = self.playout_delay
                val = (min(mn // 10, 4095) << 12) | min(mx // 10, 4095)
                exts.append((PLAYOUT_DELAY_EXT_ID, val.to_bytes(3, "big")))
            ext = build_ext_section(exts) if exts else b""
            if ext:
                header[0] |= 0x10
            # Probe padding carries a pure pad run: N-1 zeros + the pad
            # length byte (WritePaddingRTP's wire shape, downtrack.go:764).
            payload = pkt.payload if pkt.payload else PAD_RUN
            n_pad_sent += is_padding
            offsets.append(len(buf))
            buf += header + ext + payload
            lengths.append(12 + len(ext) + len(payload))
            sns.append(pkt.sn)
            tss.append(pkt.ts)
            ssrcs.append(self.subscriber_ssrc(pkt.room, pkt.sub, pkt.track))
            # Device-munged VP8 descriptor values reach the wire here
            # (codecmunger/vp8.go:161): after a simulcast switch or
            # temporal drop, receivers need contiguous picture ids.
            # Padding has no descriptor to rewrite.
            has_vp8 = is_video and not is_padding and not is_svc
            pids.append(pkt.pid if has_vp8 else -1)
            tl0s.append(pkt.tl0 if has_vp8 else -1)
            keyidxs.append(pkt.keyidx if has_vp8 else -1)
            vp8_flags.append(1 if has_vp8 else 0)
            addrs.append(addr)
            sessions.append(self.sub_sessions.get((pkt.room, pkt.sub)))
            if getattr(pkt, "t_arr", 0.0) > 0.0:
                stamps.append(pkt.t_arr)
            self.tx_pkts[pkt.room, pkt.sub] += 1
            # Actual wire bytes: padding packets carry PAD_RUN, not their
            # (empty) payload, and extensions count too — probe bursts are
            # exactly when egress-rate accuracy matters.
            self.tx_bytes[pkt.room, pkt.sub] += (
                len(payload) + len(ext) + WIRE_OVERHEAD_BYTES
            )
        if not offsets:
            return
        native.rtp.rewrite_vp8_batch(
            buf,
            np.asarray(offsets, np.int32),
            np.asarray(lengths, np.int32),
            np.asarray(sns, np.uint16),
            np.asarray(tss, np.uint32),
            np.asarray(ssrcs, np.uint32),
            np.asarray(pids, np.int32),
            np.asarray(tl0s, np.int32),
            np.asarray(keyidxs, np.int32),
            np.asarray(vp8_flags, np.uint8),
        )
        view = memoryview(buf)
        for off, ln, addr, sess in zip(offsets, lengths, addrs, sessions):
            self._sendto(bytes(view[off : off + ln]), addr, sess)
            self.stats["tx"] += 1
        # Latency probe: this cold path carries pacer-deferred and
        # TCP-fallback media whose delay is exactly the tail the histogram
        # must not lose (deferral adds whole ticks).
        if stamps:
            self.fwd_latency.observe(time.perf_counter() - np.array(stamps))
        if rtx:
            if n_pad_sent:
                self.stats["pad_tx"] = self.stats.get("pad_tx", 0) + n_pad_sent
            if len(offsets) > n_pad_sent:
                self.stats["rtx_tx"] = self.stats.get("rtx_tx", 0) + len(offsets) - n_pad_sent
        else:
            # SR bookkeeping rides the primary path only (replays re-send
            # old timestamps and must not advance the SR anchor).
            now_ms = asyncio.get_event_loop().time() * 1000.0
            for ssrc, ln, ts in zip(ssrcs, lengths, tss):
                st = self._tx_sr.get(ssrc)
                if st is None:
                    st = self._tx_sr[ssrc] = [0, 0, 0, 0.0]
                st[0] += 1
                st[1] += ln - 12
                st[2] = ts & 0xFFFFFFFF
                st[3] = now_ms
            self._send_srs(now_ms)


class _RawDatagramTransport:
    """Minimal DatagramTransport stand-in over a raw non-blocking socket
    (the native batch-receive path owns reads via loop.add_reader)."""

    def __init__(self, sock, loop):
        self._sock = sock
        self._loop = loop
        self._closed = False

    def sendto(self, data, addr) -> None:
        try:
            self._sock.sendto(data, addr)
        except (BlockingIOError, OSError):
            pass  # full buffer / teardown race: drop like the kernel would

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._loop.remove_reader(self._sock.fileno())
        except (OSError, ValueError):
            pass
        self._sock.close()

    def get_extra_info(self, name, default=None):
        if name == "socket":
            return self._sock
        if name == "sockname":
            return self._sock.getsockname()
        return default


async def start_udp_transport(
    ingest: IngestBuffer,
    host: str = "0.0.0.0",
    port: int = 7882,
    crypto: MediaCryptoRegistry | None = None,
    require_encryption: bool = False,
    nack_resolver=None,
) -> UDPMediaTransport:
    import socket as _socket

    loop = asyncio.get_running_loop()
    protocol = UDPMediaTransport(ingest, crypto, require_encryption, nack_resolver)
    is_v4 = ":" not in host  # rx_batch parses sockaddr_in (IPv4) only
    if native.egress is not None and is_v4:
        # Native batch-receive path: raw socket + recvmmsg per event-loop
        # wake + one batch AEAD open, instead of one asyncio protocol
        # callback (and one Python AES call) per datagram.
        sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVBUF, 4 << 20)
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDBUF, 4 << 20)
        sock.bind((host, port))
        sock.setblocking(False)
        tr = _RawDatagramTransport(sock, loop)
        protocol.connection_made(tr)
        MAXN, MAXD = 1024, 2048
        scratch = np.zeros(MAXN * MAXD, np.uint8)
        offs = np.zeros(MAXN, np.int32)
        lens = np.zeros(MAXN, np.int32)
        ips = np.zeros(MAXN, np.uint32)
        ports_a = np.zeros(MAXN, np.uint16)
        fd = sock.fileno()

        def on_readable():
            # ONE batch per wake: the reader is level-triggered, so a
            # still-full socket re-fires immediately — but other event-loop
            # work (ticks, flushes, timers) gets to run in between instead
            # of being starved by a sustained flood.
            nn = native.egress.rx_batch(fd, scratch, offs, lens, ips, ports_a, MAXD)
            if nn > 0:
                protocol.feed_batch(
                    scratch, offs, lens, ips, ports_a, nn,
                    t_rx=time.perf_counter(),
                )

        loop.add_reader(fd, on_readable)
        return protocol
    transport, _ = await loop.create_datagram_endpoint(
        lambda: protocol, local_addr=(host, port)
    )
    return protocol
