"""Per-tick packet ingest: wire fields → TickInputs tensors.

Reference parity: the ingest half of buffer.Buffer (pkg/sfu/buffer/
buffer.go:268 Write → :417 calc). Arriving packets are staged into
preallocated numpy arrays with per-(room, track) write cursors; at each
tick boundary `drain()` hands the filled tensors (plus the valid mask) to
the device step and resets the cursors. Overflow (more than K packets in
one tick) drops and counts; payload bytes stay in a host slab.

A copy of the JAX package's runtime/ingest.py: push / push_batch /
feedback staging, the within-tick reorder + dedup (one native pass
over the rows that hold two or more packets, which also moves the DD
bytes' indices and the arrival stamps with their packets), and the
double-buffered drain, with the numpy payload gather and the arrival
stamps (`t_arr`); drops split by cause (capacity, fault, policed); the
governor's per-(room, track) ingress policer (scalar and batch paths);
and the fault injector's seams (drop / delay / duplicate / flood, with
delayed packets re-entering at drain); the migration freeze
(`frozen_rows`, the `freeze_sinks` bridge taps, `extract_row`); and
the arrival hook `on_put`, set by the express lane (runtime/express.py).

`push_batch` is timed once: its seconds and the packets it staged add
up in `stats` (`push_s`, `pushed_packets`; the runtime's stats when a
PlaneRuntime owns the buffer), and `last_push` is what the pushes
drained into the last tick took: the first one's start (perf_counter s,
0 = none) and their summed seconds, which the runtime copies into that
tick's record as its push stage. The drain's reorder adds to `stats`
the rows that held two or more packets (`reorder_rows`) and those it
permuted (`reorder_moved`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from livekit_server_tpu_torch.models import plane

# Max NACKed SNs per (room, sub) per tick counted into the BWE loss channel.
NACK_COUNT_CAP = 8


def _gather_ranges(blob: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate blob[starts[i] : starts[i] + lens[i]] for all i in one
    call: the native memcpy loop (native/csrc/rtp_parser.cpp
    gather_ranges) when the library loaded, else `_gather_ranges_plain`,
    which gives the same bytes."""
    from livekit_server_tpu_torch import native

    rtp = native.rtp
    if getattr(rtp, "native", False):
        return rtp.gather_ranges(blob, starts, lens)
    return _gather_ranges_plain(blob, starts, lens)


def _gather_ranges_plain(blob: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> bytes:
    """The numpy form of `_gather_ranges`: one vectorized gather."""
    total = int(lens.sum())
    if total == 0:
        return b""
    # Repeat each range's start minus its output offset, add arange →
    # absolute source index per output byte.
    out_base = np.repeat(
        starts - np.concatenate([[np.int64(0)], np.cumsum(lens[:-1])]), lens
    )
    return (blob[out_base + np.arange(total, dtype=np.int64)]).tobytes()


def _reorder_dedup_plain(count: np.ndarray, fields: dict) -> tuple[int, int, int]:
    """The numpy form of the drain's reorder and dedup, in place over a
    staging set's [R, T, K] per-slot `fields` (by name; `sn`, `layer`
    and `valid` among them): each row sorted stably by (layer, SN
    relative to the layer's first valid slot in the 16-bit ring), invalid
    slots last, every field permuted alike; then a valid slot equal in SN
    and layer to the valid slot before it is marked invalid. Returns
    (rows with two or more packets, rows permuted, duplicates marked)."""
    sn, layer, valid = fields["sn"], fields["layer"], fields["valid"]
    K = sn.shape[-1]
    rel = np.zeros(sn.shape, np.int32)
    for l in range(int(layer.max()) + 1 if valid.any() else 0):
        m = valid & (layer == l)
        if not m.any():
            continue
        first = np.argmax(m, axis=-1)
        base = np.take_along_axis(sn, first[:, :, None], axis=-1)
        d = (sn - base) & 0xFFFF
        rel = np.where(m, np.where(d >= 0x8000, d - 0x10000, d), rel)
    key = np.where(valid, layer.astype(np.int64) * (1 << 20) + rel, 1 << 40)
    order = np.argsort(key, axis=-1, kind="stable")
    row_moved = (order != np.arange(K)).any(axis=-1)
    if row_moved.any():
        for arr in fields.values():
            arr[...] = np.take_along_axis(arr, order, axis=-1)
    dup = np.zeros_like(valid)
    dup[:, :, 1:] = (
        valid[:, :, 1:]
        & valid[:, :, :-1]
        & (sn[:, :, 1:] == sn[:, :, :-1])
        & (layer[:, :, 1:] == layer[:, :, :-1])
    )
    n = int(dup.sum())
    if n:
        valid[dup] = False
    return int((count > 1).sum()), int(row_moved.sum()), n


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
    # Arrival stamps (time.perf_counter seconds at batch-receive return;
    # 0 = not stamped): the rx half of the packet-in → wire-out
    # forward-latency probe (runtime/udp.py observes at send return).
    t_arr: np.ndarray | None = None    # float64

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


# PacketIn's header fields besides room, track and payload, by type.
_INT_FIELDS = ("sn", "ts", "size", "layer", "temporal", "pid", "tl0", "keyidx",
               "frame_ms", "audio_level", "arrival_rtp")
_BOOL_FIELDS = ("marker", "keyframe", "layer_sync", "begin_pic", "ts_aligned")


def packet_at(cols: dict, i, room: int, track: int, payload: bytes) -> PacketIn:
    """The packet at index `i` of per-field arrays `cols`, keyed by
    PacketIn's header field names."""
    return PacketIn(room=room, track=track, payload=payload,
                    **{f: int(cols[f][i]) for f in _INT_FIELDS},
                    **{f: bool(cols[f][i]) for f in _BOOL_FIELDS})


def row_fields(arrays: dict, row: int) -> dict:
    """PacketIn's header fields of one row of [R, T, K] staging arrays
    named as IngestBuffer's (the frame-end bit is the packet's marker, a
    ts_jump of -1 its aligned timestamp), for `packet_at`."""
    cols = {f: arrays[f][row] for f in _INT_FIELDS + ("keyframe", "layer_sync", "begin_pic")}
    cols["marker"] = arrays["end_frame"][row]
    cols["ts_aligned"] = arrays["ts_jump"][row] == -1
    return cols


class _StagingSet:
    """One of the two ping-ponged per-tick staging halves; IngestBuffer
    binds the active set's arrays as its own attributes."""

    # The [R, T, K] arrays, one entry a packet slot: what the drain's
    # reorder permutes.
    SLOT_ARRAYS = (
        "sn", "ts", "layer", "temporal", "keyframe", "layer_sync",
        "begin_pic", "end_frame", "pid", "tl0", "keyidx", "size", "frame_ms",
        "audio_level", "arrival_rtp", "ts_jump", "valid",
        "pay_off", "pay_len", "marker", "t_arr", "dd_off", "dd_len", "dd_ver",
    )
    ARRAYS = ("_count", "_slab") + SLOT_ARRAYS

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
        self.t_arr = np.zeros((R, T, K), np.float64)
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
        self.t_arr[:] = 0.0
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

    def __init__(self, dims: plane.PlaneDims, tick_ms: int, stats: dict | None = None):
        self.dims = dims
        self.tick_ms = tick_ms
        self.stats = {} if stats is None else stats
        self.stats.update(push_s=0.0, pushed_packets=0, reorder_rows=0, reorder_moved=0)
        self._push_t0 = 0.0
        self._push_s0 = 0.0
        self.last_push = (0.0, 0.0)
        R, T, K, S = dims
        # Drop accounting, split by cause so shedding metrics are
        # trustworthy: capacity = tick slab overflow (real overload
        # pressure), fault = chaos-injected loss (faultinject.py),
        # policed = governor token-bucket shedding (intentional — must
        # NOT read back as pressure). `dropped` sums them.
        self.dropped_capacity = 0
        self.dropped_fault = 0
        self.dropped_policed = 0
        # Rows quiesced for migration: once a room's state snapshot is
        # taken, admitting more packets would advance munger offsets past
        # what the destination node restores (duplicate SNs on re-issue).
        self.frozen_rows: set[int] = set()
        # Freeze-window bridge taps (service/migration.py): per-row
        # capture callbacks for packets arriving while their row is
        # frozen. With a sink attached the packet is buffered and
        # forwarded to the migration target instead of silently lost —
        # the zero-audio-gap half of the freeze contract. No sink (the
        # plain handoff path) drops.
        self.freeze_sinks: dict = {}
        # Optional FaultInjector (runtime/faultinject.py) consulted by
        # push()/push_batch(); None on the default config path. Delayed
        # packets re-enter at the top of drain() for their release tick.
        self.fault = None
        self._fault_tick = 0
        # Ingress policer (governor L2+): per-(room, track) token
        # buckets, refilled at drain() so admission cost stays O(1) per
        # packet. rate == 0 disables. `_police_video` holds a LIVE view
        # of the runtime's is_video mirror when set — audio is exempt by
        # construction (video sheds first).
        self._police_rate = 0.0
        self._police_burst = 0.0
        self._police_tokens = np.zeros((R, T), np.float64)
        self._police_video = None
        # Arrival hook: called with the (rooms, tracks, ks) staging
        # coordinates after EVERY successful staging, vectorized
        # (push_batch) and per packet (push) alike, so the express lane
        # sees TCP and bridge-replayed packets too, not only the UDP fast
        # path. The fan-out masks express rooms' rows wholesale; an ingest
        # path that bypassed this hook would silently drop their media.
        self.on_put = None
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
        # Egress tx counters of the WS media path, [R, S, (pkts, bytes)].
        self.ws_tx = np.zeros((R, S, 2), np.int64)
        self.nack_overflow = 0
        self._nack_seen: set = set()
        self._nack_tick_cnt = np.zeros((R, S), np.int32)
        self.dupes = 0

    @property
    def dropped(self) -> int:
        """Total drops across causes (the split counters are the
        trustworthy signal)."""
        return self.dropped_capacity + self.dropped_fault + self.dropped_policed

    def set_policer(self, rate_pps: float, burst: float,
                    is_video: np.ndarray | None = None) -> None:
        """Arm the per-(room, track) ingress token buckets (governor L2).
        `is_video` is held by reference — tracks whose flag is False
        (audio) bypass the policer entirely."""
        self._police_rate = float(rate_pps)
        self._police_burst = float(burst)
        self._police_tokens[:] = burst
        self._police_video = is_video

    def clear_policer(self) -> None:
        self._police_rate = 0.0
        self._police_video = None

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

    def push(self, pkt: PacketIn, t_rx: float = 0.0, _fault_ok: bool = False,
             _count_rx: bool = True) -> bool:
        """Stage one packet (arrival stamp `t_rx`, 0 = none); False (and
        counted by cause) if shed."""
        if pkt.room in self.frozen_rows:
            # Mid-migration: the row's state is already shipped. A bridge
            # sink captures the packet for forwarding; otherwise it drops.
            sink = self.freeze_sinks.get(pkt.room)
            if sink is not None:
                sink(pkt)
            return False
        r, t = pkt.room, pkt.track
        # Receive accounting first: the packet arrived on the wire whatever
        # verdict follows. drain()'s delayed-release re-entry passes
        # _count_rx=False — its arrival was counted at the original push.
        if _count_rx:
            self.rx_pkts[r, t] += 1
            self.rx_bytes[r, t] += pkt.size
        if self.fault is not None and not _fault_ok:
            verdict = self.fault.on_packet(pkt, self._fault_tick)
            if verdict == "drop":
                self.dropped_fault += 1
                return False
            if verdict == "delay":
                return False  # not a drop: re-enters via drain() take_due
            if verdict == "dup":
                self.push(pkt, t_rx, _fault_ok=True)
            # Flood mode: stage seeded extra copies of this packet.
            for _ in range(self.fault.flood_copies(pkt.room)):
                self.push(pkt, t_rx, _fault_ok=True)
        if self._police_rate > 0.0 and (
            self._police_video is None or self._police_video[r, t]
        ):
            if self._police_tokens[r, t] < 1.0:
                self.dropped_policed += 1
                return False
            self._police_tokens[r, t] -= 1.0
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
        self.t_arr[r, t, k] = t_rx
        if self.on_put is not None:
            self.on_put(np.array([r], np.int64), np.array([t], np.int64),
                        np.array([k], np.int64))
        return True

    def extract_row(self, room: int) -> list:
        """Remove and return one row's staged-but-undrained packets, in
        arrival order per track. Migration freeze calls this right after
        freezing the row: drain() has no frozen filter (push-time only),
        so packets already staged would otherwise enter the device AFTER
        the snapshot and race the source teardown. Extracted packets ride
        the freeze bridge instead; their rx accounting is reversed here
        because the replay path re-counts them on whichever node wins."""
        out: list = []
        counts = self._count[room]
        if not counts.any():
            return out
        cols = row_fields(vars(self), room)
        for t in np.nonzero(counts)[0]:
            for k in range(int(counts[t])):
                if not self.valid[room, t, k]:
                    continue
                ps = int(self.pay_off[room, t, k])
                pl = int(self.pay_len[room, t, k])
                out.append(packet_at(cols, (t, k), int(room), int(t),
                                     bytes(self._slab[ps:ps + pl]) if ps >= 0 else b""))
                self.rx_pkts[room, t] -= 1
                self.rx_bytes[room, t] -= int(self.size[room, t, k])
        self._count[room] = 0
        self.valid[room] = False
        self.pay_off[room] = -1
        self.pay_len[room] = 0
        return out

    def push_batch(self, *args, **kwargs) -> int:
        """Vectorized push of a whole receive batch (`_push_batch`'s
        arguments), timed into `stats`. Returns packets staged."""
        t0 = time.perf_counter()
        n = self._push_batch(*args, **kwargs)
        st = self.stats
        st["push_s"] += time.perf_counter() - t0
        st["pushed_packets"] += n
        if not self._push_t0:
            self._push_t0 = t0
        return n

    def _push_batch(
        self, room, track, layer, sn, ts, ts_aligned, temporal, keyframe,
        layer_sync, begin_pic, marker, pid, tl0, keyidx, size, frame_ms,
        audio_level, arrival_rtp, pay_start, pay_length, blob,
        dd_start=None, dd_length=None, dd_version=None, end_frame=None,
        t_rx: float = 0.0,
    ) -> int:
        """The push: equal-length arrays; payload bytes sliced out of
        `blob` by (pay_start, pay_length); arrival stamp `t_rx`, 0 =
        none. Returns packets staged."""
        n = len(room)
        if n == 0:
            return 0
        cols = dict(sn=sn, ts=ts, size=size, marker=marker, layer=layer, temporal=temporal,
                    keyframe=keyframe, layer_sync=layer_sync, begin_pic=begin_pic, pid=pid,
                    tl0=tl0, keyidx=keyidx, frame_ms=frame_ms, audio_level=audio_level,
                    arrival_rtp=arrival_rtp, ts_aligned=ts_aligned)

        def packet(i: int) -> PacketIn:
            ps, pl = int(pay_start[i]), int(pay_length[i])
            return packet_at(cols, i, int(room[i]), int(track[i]),
                             bytes(blob[ps:ps + pl]) if ps >= 0 else b"")

        if self.fault is not None:
            # Chaos path: route the batch through the per-packet seam so
            # the seeded rng sees every packet in arrival order (the
            # reproducibility contract). Slow is fine — fault runs are
            # tests and drills, never the default config. DD extension
            # bytes are not re-staged on this path.
            staged = 0
            for i in range(n):
                staged += self.push(packet(i), t_rx)
            return staged
        if dd_start is None:
            dd_start = np.full(n, -1, np.int64)
            dd_length = np.zeros(n, np.int32)
        if dd_version is None:
            dd_version = np.full(n, -1, np.int32)
        if end_frame is None:
            end_frame = marker
        if self.frozen_rows:
            keep0 = ~np.isin(room, list(self.frozen_rows))
            if not keep0.all():
                if self.freeze_sinks:
                    # Feed frozen-row packets to their bridge sink (same
                    # capture the scalar path does) before filtering.
                    for i in np.nonzero(~keep0)[0]:
                        sink = self.freeze_sinks.get(int(room[i]))
                        if sink is not None:
                            sink(packet(i))
                (room, track, layer, sn, ts, ts_aligned, temporal, keyframe,
                 layer_sync, begin_pic, marker, pid, tl0, keyidx, size,
                 frame_ms, audio_level, arrival_rtp, pay_start, pay_length,
                 dd_start, dd_length, dd_version, end_frame) = (
                    a[keep0] for a in (
                        room, track, layer, sn, ts, ts_aligned, temporal,
                        keyframe, layer_sync, begin_pic, marker, pid, tl0,
                        keyidx, size, frame_ms, audio_level, arrival_rtp,
                        pay_start, pay_length, dd_start, dd_length,
                        dd_version, end_frame)
                )
                n = len(room)
                if n == 0:
                    return 0
        T, K = self.dims.tracks, self.dims.pkts
        flat_rt = room.astype(np.int64) * T + track
        # Receive accounting includes packets a full tick then drops.
        np.add.at(self.rx_pkts.reshape(-1), flat_rt, 1)
        np.add.at(self.rx_bytes.reshape(-1), flat_rt, size.astype(np.int64))
        order, sorted_rt, grp_start, sizes, ranks = self._group_ranks(flat_rt, n)
        if self._police_rate > 0.0:
            # Vectorized token buckets (same semantics as the scalar
            # path): each group's first floor(tokens) non-exempt packets
            # are admitted this batch; the rest are policed. Audio
            # (is_video False) bypasses entirely.
            tok = self._police_tokens.reshape(-1)
            exempt = (np.zeros(n, bool) if self._police_video is None
                      else ~self._police_video.reshape(-1)[flat_rt])
            quota = np.floor(tok[flat_rt]).astype(np.int64)
            pol = ~exempt & (ranks >= quota)
            adm = ~exempt & ~pol
            if adm.any():
                np.subtract.at(tok, flat_rt[adm], 1.0)
            n_pol = int(pol.sum())
            if n_pol:
                self.dropped_policed += n_pol
                keep1 = ~pol
                (room, track, layer, sn, ts, ts_aligned, temporal, keyframe,
                 layer_sync, begin_pic, marker, pid, tl0, keyidx, size,
                 frame_ms, audio_level, arrival_rtp, pay_start, pay_length,
                 dd_start, dd_length, dd_version, end_frame) = (
                    a[keep1] for a in (
                        room, track, layer, sn, ts, ts_aligned, temporal,
                        keyframe, layer_sync, begin_pic, marker, pid, tl0,
                        keyidx, size, frame_ms, audio_level, arrival_rtp,
                        pay_start, pay_length, dd_start, dd_length,
                        dd_version, end_frame)
                )
                n = len(room)
                if n == 0:
                    return 0
                flat_rt = room.astype(np.int64) * T + track
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
        put(self.t_arr, t_rx)
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
        if self.on_put is not None:
            self.on_put(r_, t_, k_)
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
        within the tick: the native row pass (native/csrc/rtp_parser.cpp
        reorder_slots) when the library loaded, else
        `_reorder_dedup_plain`, which gives the same arrays. Adds the rows
        holding two or more packets and the rows permuted to `stats`
        (`reorder_rows`, `reorder_moved`)."""
        if not (self._count > 1).any():
            return
        from livekit_server_tpu_torch import native

        rtp = native.rtp
        fields = {name: getattr(self, name) for name in _StagingSet.SLOT_ARRAYS}
        if getattr(rtp, "native", False):
            rows, moved, dupes = rtp.reorder_slots(self._count, fields)
        else:
            rows, moved, dupes = _reorder_dedup_plain(self._count, fields)
        self.stats["reorder_rows"] += rows
        self.stats["reorder_moved"] += moved
        self.dupes += dupes

    def drain(self, roll_quality: bool = False,
              tick_index: int = 0) -> tuple[plane.TickInputs, PayloadSlab]:
        """Snapshot this tick's arrays as a numpy TickInputs, then flip to
        the other staging set. Fields read after the drain (the munger
        columns, the payload slab) are copied; the pack-only fields are
        views of the retiring set, valid until the next flip (the runtime
        packs them at once). No probe padding: the runtime schedules it.
        `tick_index` is the tick this drain feeds (the fault injector's
        clock for delayed packets)."""
        if self._police_rate > 0.0:
            # Token refill: once per tick, clipped at the burst ceiling.
            np.minimum(self._police_tokens + self._police_rate * (self.tick_ms / 1000.0),
                       self._police_burst, out=self._police_tokens)
        if self.fault is not None:
            # Release held-back (delayed) packets whose tick has arrived:
            # they stage now, so they ride THIS tick's tensors. Their
            # arrival was rx-counted at the original push.
            for pkt in self.fault.take_due(tick_index):
                self.push(pkt, _fault_ok=True, _count_rx=False)
            self._fault_tick = tick_index + 1
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
            t_arr=self.t_arr.copy(),
        )
        self.last_push = (self._push_t0, self.stats["push_s"] - self._push_s0)
        self._push_t0, self._push_s0 = 0.0, self.stats["push_s"]
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
