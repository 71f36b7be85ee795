"""Per-tick packet ingest: wire fields → TickInputs tensors.

Reference parity: the ingest half of buffer.Buffer (pkg/sfu/buffer/
buffer.go:268 Write → :417 calc). Arriving packets are staged into
preallocated numpy arrays with per-(room, track) write cursors; at each
tick boundary `drain()` hands the filled tensors (plus the valid mask) to
the device step and resets the cursors. Overflow (more than K packets in
one tick) drops and counts; payload bytes stay in a host slab.

A copy of the JAX package's runtime/ingest.py, cut to what the dense
tick's main path needs: push / push_batch / feedback staging, the
within-tick reorder + dedup, and the double-buffered drain, with the
numpy payload gather. Migration freezes, fault injection, the ingress
policer and the express-lane arrival hook are not carried (their
runtime features are not ported yet).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from livekit_server_tpu_torch.models import plane

# Max NACKed SNs per (room, sub) per tick counted into the BWE loss channel.
NACK_COUNT_CAP = 8


def _gather_ranges(blob: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate blob[starts[i] : starts[i] + lens[i]] for all i in one
    vectorized gather."""
    total = int(lens.sum())
    if total == 0:
        return b""
    # Repeat each range's start minus its output offset, add arange →
    # absolute source index per output byte.
    out_base = np.repeat(
        starts - np.concatenate([[np.int64(0)], np.cumsum(lens[:-1])]), lens
    )
    return (blob[out_base + np.arange(total, dtype=np.int64)]).tobytes()


def _wrap_i32(x: int) -> int:
    """uint32 bit pattern → int32 two's complement."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


@dataclass
class PayloadSlab:
    """One tick's payload bytes + [R, T, K] index arrays (drain output)."""

    data: bytes
    off: np.ndarray      # int64; -1 = no payload staged
    length: np.ndarray   # int32
    marker: np.ndarray   # bool — RTP M bit
    dd_off: np.ndarray | None = None   # int64 — DD extension bytes (-1 none)
    dd_len: np.ndarray | None = None   # int32
    dd_ver: np.ndarray | None = None   # int32

    def get(self, r: int, t: int, k: int) -> tuple[bytes, bool]:
        o = int(self.off[r, t, k])
        if o < 0:
            return b"", False
        return (
            bytes(self.data[o : o + int(self.length[r, t, k])]),
            bool(self.marker[r, t, k]),
        )

    def get_dd(self, r: int, t: int, k: int) -> bytes:
        if self.dd_off is None:
            return b""
        o = int(self.dd_off[r, t, k])
        if o < 0:
            return b""
        return bytes(self.data[o : o + int(self.dd_len[r, t, k])])


@dataclass
class PacketIn:
    """Parsed header fields of one media packet (ExtPacket analog)."""

    room: int
    track: int
    sn: int
    ts: int
    size: int
    payload: bytes = b""
    marker: bool = False
    layer: int = 0
    temporal: int = 0
    keyframe: bool = False
    layer_sync: bool = False
    begin_pic: bool = False
    pid: int = 0
    tl0: int = 0
    keyidx: int = 0
    frame_ms: int = 20
    audio_level: int = 127
    arrival_rtp: int = 0
    ts_aligned: bool = False  # ts already on the track's common timeline


class _StagingSet:
    """One of the two ping-ponged per-tick staging halves; IngestBuffer
    binds the active set's arrays as its own attributes."""

    ARRAYS = (
        "_count", "sn", "ts", "layer", "temporal", "keyframe", "layer_sync",
        "begin_pic", "end_frame", "pid", "tl0", "keyidx", "size", "frame_ms",
        "audio_level", "arrival_rtp", "ts_jump", "valid",
        "_slab", "pay_off", "pay_len", "marker",
        "dd_off", "dd_len", "dd_ver",
    )

    def __init__(self, dims: plane.PlaneDims):
        R, T, K, _ = dims
        i32 = lambda: np.zeros((R, T, K), np.int32)  # noqa: E731
        boo = lambda: np.zeros((R, T, K), bool)      # noqa: E731
        self._count = np.zeros((R, T), np.int32)
        self.sn = i32()
        self.ts = i32()
        self.layer = i32()
        self.temporal = i32()
        self.keyframe = boo()
        self.layer_sync = boo()
        self.begin_pic = boo()
        self.end_frame = boo()
        self.pid = i32()
        self.tl0 = i32()
        self.keyidx = i32()
        self.size = i32()
        self.frame_ms = i32()
        self.audio_level = np.full((R, T, K), 127, np.int32)
        self.arrival_rtp = i32()
        # -1 = SR-normalized (exact cross-layer continuity); else the
        # one-frame fallback advance at a source switch.
        self.ts_jump = np.full((R, T, K), 3000, np.int32)
        self.valid = boo()
        self._slab = bytearray()
        self.pay_off = np.full((R, T, K), -1, np.int64)
        self.pay_len = np.zeros((R, T, K), np.int32)
        self.marker = np.zeros((R, T, K), bool)
        self.dd_off = np.full((R, T, K), -1, np.int64)
        self.dd_len = np.zeros((R, T, K), np.int32)
        self.dd_ver = np.full((R, T, K), -1, np.int32)
        self.needs_scrub = False

    def scrub(self) -> None:
        """Reset for reuse: masks, cursors and payload indices only; stale
        packet fields are dead under valid=False."""
        self._slab.clear()
        self.pay_off[:] = -1
        self.pay_len[:] = 0
        self.marker[:] = False
        self.dd_off[:] = -1
        self.dd_len[:] = 0
        self.dd_ver[:] = -1
        self._count[:] = 0
        self.valid[:] = False
        self.audio_level[:] = 127
        self.needs_scrub = False


class IngestBuffer:
    """Double-buffered staging area for one node's tick inputs: two
    ping-ponged _StagingSets flipped at each drain()."""

    def __init__(self, dims: plane.PlaneDims, tick_ms: int):
        self.dims = dims
        self.tick_ms = tick_ms
        R, T, K, S = dims
        self.dropped_capacity = 0
        self._sets = (_StagingSet(dims), _StagingSet(dims))
        self._active = 0
        self._bind(self._sets[0])
        # Per-subscriber feedback staging, reset inline at drain.
        self._estimate = np.zeros((R, S), np.float32)
        self._estimate_valid = np.zeros((R, S), bool)
        self._nacks = np.zeros((R, S), np.float32)
        self.rtt_ms = np.full((R, S), 100, np.int32)  # persistent (RR-updated)
        # Track → publishing participant's subscriber slot (-1 unknown).
        self.track_pub_sub = np.full((R, T), -1, np.int32)
        # TWCC feedback accumulators, reduced to one sample per tick.
        self._fb_delay_sum = np.zeros((R, S), np.float64)
        self._fb_count = np.zeros((R, S), np.int64)
        self._fb_bytes = np.zeros((R, S), np.int64)
        self._fb_span_ms = np.zeros((R, S), np.float64)
        self.fb_enabled = np.zeros((R, S), bool)
        # One-tick reset mask for released subscriber slots.
        self.sub_reset = np.zeros((R, S), bool)
        self.rx_pkts = np.zeros((R, T), np.int64)
        self.rx_bytes = np.zeros((R, T), np.int64)
        self.nack_overflow = 0
        self._nack_seen: set = set()
        self._nack_tick_cnt = np.zeros((R, S), np.int32)
        self.dupes = 0

    def _bind(self, s: _StagingSet) -> None:
        for name in _StagingSet.ARRAYS:
            setattr(self, name, getattr(s, name))

    def scrub_retired(self) -> None:
        """Deferred reset of the set retired by the last drain()."""
        s = self._sets[1 - self._active]
        if s.needs_scrub:
            s.scrub()

    @staticmethod
    def _group_ranks(flat_rt: np.ndarray, n: int):
        """Arrival-order rank of each packet within its (room, track)
        group. Returns (order, sorted_rt, grp_start, sizes, ranks)."""
        order = np.argsort(flat_rt, kind="stable")
        sorted_rt = flat_rt[order]
        grp_start = np.r_[0, np.nonzero(np.diff(sorted_rt))[0] + 1]
        sizes = np.diff(np.r_[grp_start, n])
        ranks = np.empty(n, np.int64)
        ranks[order] = np.arange(n) - np.repeat(grp_start, sizes)
        return order, sorted_rt, grp_start, sizes, ranks

    def push(self, pkt: PacketIn) -> bool:
        """Stage one packet; False (and counted) if the tick is full."""
        r, t = pkt.room, pkt.track
        self.rx_pkts[r, t] += 1
        self.rx_bytes[r, t] += pkt.size
        k = self._count[r, t]
        if k >= self.dims.pkts:
            self.dropped_capacity += 1
            return False
        self._count[r, t] = k + 1
        self.sn[r, t, k] = pkt.sn & 0xFFFF
        self.ts[r, t, k] = _wrap_i32(pkt.ts)
        self.layer[r, t, k] = pkt.layer
        self.temporal[r, t, k] = pkt.temporal
        self.keyframe[r, t, k] = pkt.keyframe
        self.layer_sync[r, t, k] = pkt.layer_sync
        self.begin_pic[r, t, k] = pkt.begin_pic
        self.end_frame[r, t, k] = pkt.marker
        self.pid[r, t, k] = pkt.pid
        self.tl0[r, t, k] = pkt.tl0
        self.keyidx[r, t, k] = pkt.keyidx
        self.size[r, t, k] = pkt.size
        self.frame_ms[r, t, k] = pkt.frame_ms
        self.audio_level[r, t, k] = pkt.audio_level
        self.arrival_rtp[r, t, k] = _wrap_i32(pkt.arrival_rtp)
        self.ts_jump[r, t, k] = -1 if pkt.ts_aligned else 3000
        self.valid[r, t, k] = True
        if pkt.payload:
            self.pay_off[r, t, k] = len(self._slab)
            self.pay_len[r, t, k] = len(pkt.payload)
            self.marker[r, t, k] = pkt.marker
            self._slab += pkt.payload
        return True

    def push_batch(
        self, room, track, layer, sn, ts, ts_aligned, temporal, keyframe,
        layer_sync, begin_pic, marker, pid, tl0, keyidx, size, frame_ms,
        audio_level, arrival_rtp, pay_start, pay_length, blob,
        dd_start=None, dd_length=None, dd_version=None, end_frame=None,
    ) -> int:
        """Vectorized push of a whole receive batch (equal-length arrays;
        payload bytes sliced out of `blob` by (pay_start, pay_length)).
        Returns packets staged."""
        n = len(room)
        if n == 0:
            return 0
        if dd_start is None:
            dd_start = np.full(n, -1, np.int64)
            dd_length = np.zeros(n, np.int32)
        if dd_version is None:
            dd_version = np.full(n, -1, np.int32)
        if end_frame is None:
            end_frame = marker
        T, K = self.dims.tracks, self.dims.pkts
        flat_rt = room.astype(np.int64) * T + track
        # Receive accounting includes packets a full tick then drops.
        np.add.at(self.rx_pkts.reshape(-1), flat_rt, 1)
        np.add.at(self.rx_bytes.reshape(-1), flat_rt, size.astype(np.int64))
        order, sorted_rt, grp_start, sizes, ranks = self._group_ranks(flat_rt, n)
        base = self._count.reshape(-1)[flat_rt]
        k = base + ranks
        keep = k < K
        dropped = n - int(keep.sum())
        if dropped:
            self.dropped_capacity += dropped
            (room, track, k, layer, sn, ts, ts_aligned, temporal, keyframe,
             layer_sync, begin_pic, end_frame, marker, pid, tl0, keyidx,
             size, frame_ms, audio_level, arrival_rtp, pay_start,
             pay_length, dd_start, dd_length, dd_version) = (
                a[keep] for a in (
                    room, track, k, layer, sn, ts, ts_aligned, temporal,
                    keyframe, layer_sync, begin_pic, end_frame, marker, pid,
                    tl0, keyidx, size, frame_ms, audio_level, arrival_rtp,
                    pay_start, pay_length, dd_start, dd_length, dd_version)
            )
        r_, t_, k_ = room, track, k
        fi = (r_.astype(np.int64) * T + t_) * K + k_

        def put(arr, vals):
            arr.reshape(-1)[fi] = vals

        put(self.sn, sn & 0xFFFF)
        put(self.ts, ts.astype(np.int64).astype(np.int32))
        put(self.layer, layer)
        put(self.temporal, temporal)
        put(self.keyframe, keyframe)
        put(self.layer_sync, layer_sync)
        put(self.begin_pic, begin_pic)
        put(self.end_frame, end_frame)
        put(self.pid, pid)
        put(self.tl0, tl0)
        put(self.keyidx, keyidx)
        put(self.size, size)
        put(self.frame_ms, frame_ms)
        put(self.audio_level, audio_level)
        put(self.arrival_rtp, arrival_rtp.astype(np.int64).astype(np.int32))
        put(self.ts_jump, np.where(ts_aligned, -1, 3000))
        put(self.valid, True)
        lens = pay_length.astype(np.int64)
        starts = pay_start.astype(np.int64)
        offs = len(self._slab) + np.r_[np.int64(0), np.cumsum(lens[:-1])]
        # Header-only packets keep pay_off = -1 (no empty datagrams).
        put(self.pay_off, np.where(lens > 0, offs, -1))
        put(self.pay_len, lens)
        put(self.marker, marker)
        blob_arr = blob if isinstance(blob, np.ndarray) else np.frombuffer(blob, np.uint8)
        self._slab += _gather_ranges(blob_arr, starts, lens)
        dmask = dd_start >= 0
        if dmask.any():
            dstarts = dd_start[dmask].astype(np.int64)
            dlens = dd_length[dmask].astype(np.int64)
            doffs = len(self._slab) + np.r_[np.int64(0), np.cumsum(dlens[:-1])]
            didx = (r_[dmask], t_[dmask], k_[dmask])
            self.dd_off[didx] = doffs
            self.dd_len[didx] = dlens
            self.dd_ver[didx] = dd_version[dmask]
            self._slab += _gather_ranges(blob_arr, dstarts, dlens)
        uniq_rt = sorted_rt[grp_start]
        self._count.reshape(-1)[uniq_rt] = np.minimum(K, base[order][grp_start] + sizes)
        return len(r_)

    def push_twcc_feedback(self, room: int, sub: int, delay_sum_ms: float,
                           n_deltas: int, acked_bytes: int, span_ms: float) -> None:
        """Accumulate one TWCC feedback frame's reductions."""
        self._fb_delay_sum[room, sub] += delay_sum_ms
        self._fb_count[room, sub] += max(n_deltas, 0)
        self._fb_bytes[room, sub] += acked_bytes
        self._fb_span_ms[room, sub] += span_ms

    def push_feedback(self, room: int, sub: int, estimate: float | None = None,
                      nacks: int = 0) -> None:
        """Stage subscriber feedback (TWCC/REMB estimate sample, NACK count)."""
        if estimate is not None:
            self._estimate[room, sub] = estimate
            self._estimate_valid[room, sub] = True
        if nacks:
            self._nacks[room, sub] += nacks

    def push_nack(self, room: int, sub: int, track: int, sns) -> int:
        """Count NACKed SNs into the BWE loss channel, deduped per
        (sn, track) across the tick and capped at NACK_COUNT_CAP per
        (room, sub) per tick."""
        staged = 0
        for sn in sns:
            key = (room, sub, sn & 0xFFFF, track)
            if key in self._nack_seen:
                continue
            self._nack_seen.add(key)
            if self._nack_tick_cnt[room, sub] >= NACK_COUNT_CAP:
                self.nack_overflow += 1
                continue
            self._nack_tick_cnt[room, sub] += 1
            staged += 1
        if staged:
            self._nacks[room, sub] += staged
        return staged

    def set_rtt(self, room: int, sub: int, rtt_ms: int) -> None:
        """RR-derived round-trip time (replay throttle input)."""
        self.rtt_ms[room, sub] = max(1, min(int(rtt_ms), 10_000))

    def _reorder_dedup(self) -> None:
        """Sort each (room, track)'s staged packets by (layer, SN) and drop
        same-SN duplicates (buffer.go reorder + duplicate detection),
        within the tick."""
        if not (self._count > 1).any():
            return
        R, T, K = self.sn.shape
        rel = np.zeros((R, T, K), np.int32)
        for l in range(int(self.layer.max()) + 1 if self.valid.any() else 0):
            m = self.valid & (self.layer == l)
            if not m.any():
                continue
            first = np.argmax(m, axis=-1)
            base = np.take_along_axis(self.sn, first[:, :, None], axis=-1)
            d = (self.sn - base) & 0xFFFF
            rel = np.where(m, np.where(d >= 0x8000, d - 0x10000, d), rel)
        key = np.where(
            self.valid, self.layer.astype(np.int64) * (1 << 20) + rel, 1 << 40
        )
        order = np.argsort(key, axis=-1, kind="stable")
        if not (order == np.arange(K)).all():
            for arr in (
                self.sn, self.ts, self.layer, self.temporal, self.keyframe,
                self.layer_sync, self.begin_pic, self.end_frame, self.pid,
                self.tl0, self.keyidx, self.size, self.frame_ms,
                self.audio_level, self.arrival_rtp, self.ts_jump, self.valid,
                self.pay_off, self.pay_len, self.marker,
            ):
                arr[...] = np.take_along_axis(arr, order, axis=-1)
        dup = np.zeros_like(self.valid)
        dup[:, :, 1:] = (
            self.valid[:, :, 1:]
            & self.valid[:, :, :-1]
            & (self.sn[:, :, 1:] == self.sn[:, :, :-1])
            & (self.layer[:, :, 1:] == self.layer[:, :, :-1])
        )
        n = int(dup.sum())
        if n:
            self.valid[dup] = False
            self.dupes += n

    def drain(self, roll_quality: bool = False) -> tuple[plane.TickInputs, PayloadSlab]:
        """Snapshot this tick's arrays as a numpy TickInputs, then flip to
        the other staging set. Fields read after the drain (the munger
        columns, the payload slab) are copied; the pack-only fields are
        views of the retiring set, valid until the next flip (the runtime
        packs them at once). No probe padding: the runtime schedules it."""
        self._reorder_dedup()
        R, T, K, S = self.dims
        inp = plane.TickInputs(
            sn=self.sn.copy(), ts=self.ts.copy(), layer=self.layer,
            temporal=self.temporal, keyframe=self.keyframe,
            layer_sync=self.layer_sync, begin_pic=self.begin_pic.copy(),
            end_frame=self.end_frame,
            pid=self.pid.copy(), tl0=self.tl0.copy(), keyidx=self.keyidx.copy(),
            size=self.size, frame_ms=self.frame_ms,
            audio_level=self.audio_level,
            arrival_rtp=self.arrival_rtp, ts_jump=self.ts_jump.copy(),
            valid=self.valid.copy(),
            estimate=self._estimate.copy(),
            estimate_valid=self._estimate_valid.copy(),
            nacks=self._nacks.copy(),
            pub_rtt_ms=np.where(
                self.track_pub_sub >= 0,
                np.take_along_axis(
                    self.rtt_ms, np.clip(self.track_pub_sub, 0, S - 1), axis=1
                ),
                0,
            ).astype(np.float32),
            fb_delay_ms=np.where(
                self._fb_count > 0,
                self._fb_delay_sum / np.maximum(self._fb_count, 1),
                0.0,
            ).astype(np.float32),
            fb_recv_bps=np.where(
                self._fb_span_ms > 0,
                self._fb_bytes * 8000.0 / np.maximum(self._fb_span_ms, 1e-3),
                0.0,
            ).astype(np.float32),
            fb_valid=self._fb_count > 0,
            fb_enabled=self.fb_enabled.copy(),
            sub_reset=self.sub_reset.copy(),
            pad_num=np.zeros((R, S), np.int32),
            pad_track=np.full((R, S), -1, np.int32),
            tick_ms=np.int32(self.tick_ms),
            roll_quality=np.int32(1 if roll_quality else 0),
        )
        payloads = PayloadSlab(
            data=bytes(self._slab),
            off=self.pay_off.copy(),
            length=self.pay_len.copy(),
            marker=self.marker.copy(),
            dd_off=self.dd_off.copy(),
            dd_len=self.dd_len.copy(),
            dd_ver=self.dd_ver.copy(),
        )
        self._sets[self._active].needs_scrub = True
        nxt = self._sets[1 - self._active]
        if nxt.needs_scrub:
            nxt.scrub()
        self._active = 1 - self._active
        self._bind(nxt)
        self._estimate_valid[:] = False
        self._nacks[:] = 0.0
        self._fb_delay_sum[:] = 0.0
        self._fb_count[:] = 0
        self._fb_bytes[:] = 0
        self._fb_span_ms[:] = 0.0
        self.sub_reset[:] = False
        self._nack_seen.clear()
        self._nack_tick_cnt[:] = 0
        return inp, payloads
