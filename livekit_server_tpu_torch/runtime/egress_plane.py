"""Sharded native egress plane: per-core fan-out of the host packet walk.

The device side of a tick resolves ~R*T*K*S forwarding decisions in one
fused step; the host side then has to *realize* them as datagrams — munge
application, assembly, AES-GCM seal, socket writes. Done as one native
call on one thread, that walk is the number that caps users per node.
This module is the orchestrator that cuts the walk
into per-core shards and keeps every byte of output bit-identical to the
single-threaded path:

- **Room-aligned shards.** Egress entries arrive destination-major
  (room, sub, track, k). Shards are contiguous entry ranges cut only on
  room boundaries: munger state rows are indexed [room, track, sub], so
  whole-room ownership makes every state write (munge) and every
  canonical-cache slot (send) private to one worker — no locks on the
  per-tick path, and migration room freezes/snapshots keep working
  unchanged because a room's lanes never straddle workers.
- **Exact prefix-sum output bases.** The native walkers count before they
  write (native/munge.cpp count_range, udp.py's cumsum of out_len), so
  shard outputs land at exact offsets and the concatenated result is
  byte-identical regardless of shard count (pinned by
  tests/test_egress_plane.py).
- **Multicast-shaped assembly** (P3FA, PAPERS.md: treat N-subscriber
  delivery as constrained multicast rather than N unicasts). Entries of
  one (room, track, packet) group share everything except a 12-byte
  header and the VP8 picture-id chain: the canonical datagram — header
  template + extensions + payload — is gathered ONCE per group into a
  per-worker hot scratch slab, and each subscriber's copy is a single
  memcpy + header patch from it (native/egress.cpp CanonSlot). The AEAD
  seal itself still runs per datagram: every sealed frame carries a
  unique per-session counter, and that counter IS the GCM nonce — "seal
  once, retag per subscriber" would reuse nonces across distinct
  ciphertexts, which breaks GCM catastrophically. What the multicast
  shape removes is the per-subscriber gather/extension-build work; the
  per-byte AES cost stays and is paid from L1-hot canonical bytes.

The plane object itself is thin: it plans shard cuts (numpy searchsorted
on the sorted room column), derives canonical-group slots, and scrapes
per-shard timing/throughput out of the native calls for telemetry
(/debug/egress, livekit_host_egress_pps). One instance is shared by
PlaneRuntime (munge sharding) and UDPMediaTransport (send sharding).

A copy of the JAX package's runtime/egress_plane.py, with the express
lane's send accounting (`record_express`), the per-shard sums of every
sharded send, and the plane microbench (`bench_plane`,
`bench_plane_scaling`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

import numpy as np

# Above this many (track, packet) slots the per-worker canonical scratch
# (slots * 2048 B) stops fitting hot cache and grouping is disabled.
MAX_GROUP_SLOTS = 512

# Decay for the published packets-per-second EMA (per observe interval).
_PPS_ALPHA = 0.3


def resolve_shards(configured: int) -> int:
    """0 = auto: one shard per core, capped at 8 (the native pool caps at
    16; past 8 the seal walk is memory-bound and extra shards only add
    barrier latency)."""
    if configured > 0:
        return min(configured, 16)
    return max(1, min(8, os.cpu_count() or 1))


class EgressPlane:
    """Shard planner + stats collector for the native egress/munge path.

    Thread-safety: plan_* methods are pure; record_* methods take the
    stats lock (the paced send path calls record_send from a worker
    thread while observe() reads from the event loop).
    """

    def __init__(self, shards: int = 0, multicast_seal: bool = True):
        self.shards = resolve_shards(shards)
        self.multicast_seal = multicast_seal
        self._lock = threading.Lock()
        # Cumulative counters (monotonic; telemetry derives rates).
        self.stats: dict[str, float] = {
            "ticks": 0, "entries": 0, "datagrams": 0, "grouped_entries": 0,
            "send_ns": 0, "munge_ns": 0, "munge_entries": 0,
            "express_datagrams": 0, "express_ns": 0,
            # per-shard sums of the sharded sends: what the shards built,
            # what they handed to the kernel, and the ticks where the
            # built sum missed the entries (a shard lost to another call)
            # or the sent sum missed the built sum (socket drops)
            "shard_built_sum": 0, "shard_sent_sum": 0,
            "ticks_built_short": 0, "ticks_sent_short": 0,
        }
        # Express-lane sends land between ticks; record_express accumulates
        # them here and record_send folds them into the next tick's EMA
        # sample, so host_egress_pps covers both tiers.
        self._express_pending_dgrams = 0
        self._express_pending_ns = 0
        self.shard_sent_total = np.zeros(self.shards, np.int64)
        self.shard_ns_total = np.zeros(self.shards, np.int64)
        self.munge_shard_ns_total = np.zeros(self.shards, np.int64)
        # Last-tick snapshots (recent_ticks / debug).
        self.last_send: dict[str, Any] = {}
        self.last_munge: dict[str, Any] = {}
        self._pps_ema = 0.0
        self._ema_entries = 0.0
        self._ema_ns = 0.0
        self._warmed = False

    # -- shard planning ---------------------------------------------------

    def room_plan(self, n_rooms: int) -> tuple[np.ndarray, np.ndarray]:
        """Cut [0, n_rooms) into up to `shards` contiguous room ranges for
        the munge walk. Rooms are the unit of state ownership, so this is
        the only legal cut axis."""
        w = min(self.shards, n_rooms) or 1
        edges = (np.arange(w + 1, dtype=np.int64) * n_rooms) // w
        return edges[:-1].astype(np.int32), edges[1:].astype(np.int32)

    def entry_plan(self, rooms_sorted: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Cut a room-ascending entry column into up to `shards`
        room-aligned ranges balanced by entry count. Returns (lo, hi)
        int64 arrays; every cut lands on the first entry of a room so
        canonical groups never straddle workers."""
        n = len(rooms_sorted)
        w = min(self.shards, n) or 1
        if w == 1:
            return (np.zeros(1, np.int64), np.array([n], np.int64))
        targets = (np.arange(1, w, dtype=np.int64) * n) // w
        # Snap each target cut back to its room's first entry.
        cuts = np.searchsorted(rooms_sorted, rooms_sorted[targets], side="left")
        bounds = np.unique(np.concatenate(([0], cuts, [n])))
        return bounds[:-1].astype(np.int64), bounds[1:].astype(np.int64)

    def group_slots(
        self, flat_rtk_sorted: np.ndarray, tracks: np.ndarray,
        ks: np.ndarray, n_tracks: int, n_k: int,
    ) -> tuple[np.ndarray | None, int]:
        """Canonical-cache slot per entry: slot = track * K + k for
        entries whose (room, track, packet) group has >= 2 members (the
        canonical is worth staging only when reused), -1 otherwise.
        `flat_rtk_sorted` is the entries' room*T*K + slot composite —
        already computed by the udp staging path. Returns (None, 0) when
        grouping is off or the slot space is too large to scratch."""
        slots = n_tracks * n_k
        if not self.multicast_seal or slots > MAX_GROUP_SLOTS:
            return None, 0
        n = len(flat_rtk_sorted)
        if n == 0:
            return None, 0
        # Group sizes via bincount on the composite key, bounded: offset
        # to the min key so the count array spans only the rooms present.
        lo = int(flat_rtk_sorted.min())
        span = int(flat_rtk_sorted.max()) - lo + 1
        if span > max(4 * n, 1 << 20):
            return None, 0
        counts = np.bincount(flat_rtk_sorted - lo, minlength=span)
        grouped = counts[flat_rtk_sorted - lo] > 1
        grp = np.where(
            grouped, tracks.astype(np.int32) * n_k + ks.astype(np.int32), -1
        ).astype(np.int32)
        return grp, slots

    # -- stats ------------------------------------------------------------

    def warm(self) -> None:
        """Pre-spawn the native worker pool so the first real tick does
        not pay thread creation."""
        if self._warmed:
            return
        self._warmed = True
        if self.shards > 1:
            from livekit_server_tpu_torch import native

            if native.egress is not None:
                native.egress.pool_ensure(self.shards)

    def record_send(self, n_entries: int, n_grouped: int, sent: int,
                    shard_lo, shard_hi, shard_sent, shard_built,
                    shard_ns) -> None:
        ns = int(np.max(shard_ns)) if len(shard_ns) else 0  # critical path
        with self._lock:
            st = self.stats
            st["ticks"] += 1
            st["entries"] += n_entries
            st["grouped_entries"] += n_grouped
            st["datagrams"] += sent
            st["send_ns"] += ns
            w = len(shard_sent)
            built, sent_sum = int(np.sum(shard_built)), int(np.sum(shard_sent))
            st["shard_built_sum"] += built
            st["shard_sent_sum"] += sent_sum
            st["ticks_built_short"] += built != n_entries
            st["ticks_sent_short"] += sent_sum != built
            self.shard_sent_total[:w] += shard_sent
            self.shard_ns_total[:w] += shard_ns
            # Fold the express sends of the window that just closed into
            # this tick's EMA sample (both tiers' work over both tiers'
            # wall), then reset the accumulators.
            ema_n = n_entries + self._express_pending_dgrams
            ema_ns = ns + self._express_pending_ns
            self._express_pending_dgrams = 0
            self._express_pending_ns = 0
            self._ema_entries = (
                _PPS_ALPHA * ema_n + (1 - _PPS_ALPHA) * self._ema_entries
            )
            self._ema_ns = _PPS_ALPHA * max(ema_ns, 1) + (1 - _PPS_ALPHA) * self._ema_ns
            if self._ema_ns > 0:
                self._pps_ema = self._ema_entries / (self._ema_ns * 1e-9)
            self.last_send = {
                "entries": int(n_entries),
                "grouped": int(n_grouped),
                "sent": int(sent),
                "shards": [
                    {
                        "range": [int(a), int(b)],
                        "sent": int(s),
                        "built": int(bu),
                        "ms": round(int(nn) / 1e6, 3),
                    }
                    for a, b, s, bu, nn in zip(
                        shard_lo, shard_hi, shard_sent, shard_built, shard_ns
                    )
                ],
            }

    def record_munge(self, shard_counts, shard_ns) -> None:
        with self._lock:
            self.stats["munge_ns"] += int(np.max(shard_ns)) if len(shard_ns) else 0
            self.stats["munge_entries"] += int(np.sum(shard_counts))
            w = len(shard_ns)
            self.munge_shard_ns_total[:w] += shard_ns
            self.last_munge = {
                "counts": [int(c) for c in shard_counts],
                "ms": [round(int(n) / 1e6, 3) for n in shard_ns],
            }

    def record_express(self, sent: int, ns: int) -> None:
        """Express-lane send accounting (udp._send_express): datagrams and
        send wall, folded into the pps EMA at the next tick's record_send
        so the gauge reflects both tiers."""
        with self._lock:
            self.stats["express_datagrams"] += sent
            self.stats["express_ns"] += ns
            self._express_pending_dgrams += sent
            self._express_pending_ns += ns

    @property
    def host_egress_pps(self) -> float:
        """Datagrams/s through the native send walk, EMA over recent
        ticks; the walk wall time is the max shard (critical path)."""
        return self._pps_ema

    def observe(self) -> dict[str, Any]:
        """Snapshot for /debug/egress and the telemetry exporter."""
        with self._lock:
            send_s = self.stats["send_ns"] * 1e-9
            munge_s = self.stats["munge_ns"] * 1e-9
            return {
                "shards": self.shards,
                "multicast_seal": self.multicast_seal,
                "host_egress_pps": round(self._pps_ema, 1),
                "ticks": int(self.stats["ticks"]),
                "entries": int(self.stats["entries"]),
                "grouped_entries": int(self.stats["grouped_entries"]),
                "datagrams": int(self.stats["datagrams"]),
                "send_ms_total": round(send_s * 1000.0, 3),
                "munge_ms_total": round(munge_s * 1000.0, 3),
                "munge_entries": int(self.stats["munge_entries"]),
                "express_datagrams": int(self.stats["express_datagrams"]),
                "express_ms_total": round(self.stats["express_ns"] / 1e6, 3),
                "shard_sent": [int(x) for x in self.shard_sent_total],
                "shard_built_sum": int(self.stats["shard_built_sum"]),
                "shard_sent_sum": int(self.stats["shard_sent_sum"]),
                "ticks_built_short": int(self.stats["ticks_built_short"]),
                "ticks_sent_short": int(self.stats["ticks_sent_short"]),
                "shard_send_ms": [
                    round(int(x) / 1e6, 3) for x in self.shard_ns_total
                ],
                "shard_munge_ms": [
                    round(int(x) / 1e6, 3) for x in self.munge_shard_ns_total
                ],
                "last_send": self.last_send,
                "last_munge": self.last_munge,
            }



def bench_plane(
    plane: EgressPlane,
    n_rooms: int = 64,
    subs_per_room: int = 16,
    tracks: int = 2,
    pkts: int = 4,
    payload_len: int = 1100,
    sealed: bool = True,
    seconds: float = 2.0,
    fd: int = -1,
) -> dict[str, Any]:
    """Pure egress-plane microbench: drive the native sharded walk on a
    synthetic wire-shaped batch (no device step, no ingest) and measure
    datagrams/s through assemble+seal(+send when fd >= 0). This isolates
    the number the plane exists to move — the host packet walk — from
    tick scheduling; the bench's wire sections (tools/bench_wire.py)
    measure the end-to-end version of the same number.

    `shard_built` is what each shard built over the run: with fd < 0 the
    native call sends nothing and a shard's `sent` is 0, so the built
    counts are what shows that every shard of the plan ran."""
    from livekit_server_tpu_torch import native

    if native.egress is None:
        return {"error": "native egress unavailable"}
    rng = np.random.default_rng(7)
    n = n_rooms * subs_per_room * tracks * pkts
    slab = rng.integers(0, 256, pkts * payload_len, np.uint8)
    # Destination-major (room, sub, track, k) — the udp staging order.
    rr = np.repeat(np.arange(n_rooms, dtype=np.int32), subs_per_room * tracks * pkts)
    ss = np.tile(
        np.repeat(np.arange(subs_per_room, dtype=np.int32), tracks * pkts), n_rooms
    )
    tt = np.tile(np.repeat(np.arange(tracks, dtype=np.int32), pkts),
                 n_rooms * subs_per_room)
    kk = np.tile(np.arange(pkts, dtype=np.int32), n_rooms * subs_per_room * tracks)
    slot = tt * pkts + kk
    flat_rtk = rr.astype(np.int64) * (tracks * pkts) + slot
    grp, grp_slots = plane.group_slots(flat_rtk, tt, kk, tracks, pkts)
    if grp is None:
        grp = np.full(n, -1, np.int32)
        grp_slots = 0
    lo, hi = plane.entry_plan(rr)
    n_sess = n_rooms * subs_per_room
    args = dict(
        shard_lo=lo, shard_hi=hi, slab=slab,
        pay_off=(kk.astype(np.int64) * payload_len),
        pay_len=np.full(n, payload_len, np.int32),
        marker=(kk == pkts - 1).astype(np.uint8),
        pt=np.full(n, 96, np.uint8), vp8=np.ones(n, np.uint8),
        sn=(np.arange(n) & 0xFFFF).astype(np.uint16),
        ts=(kk.astype(np.uint32) * 3000),
        ssrc=(rr.astype(np.uint32) << 16) | ss.astype(np.uint32),
        pid=np.full(n, 77, np.int32), tl0=np.full(n, 3, np.int32),
        kidx=np.full(n, 1, np.int32),
        ip=np.full(n, 0x7F000001, np.uint32),
        port=np.full(n, 50555, np.uint16),
        seal=np.full(n, 1 if sealed else 0, np.uint8),
        key_idx=(rr * subs_per_room + ss).astype(np.int32),
        keys=rng.integers(0, 256, (n_sess, 16), np.uint8),
        key_ids=np.arange(1, n_sess + 1, dtype=np.uint32),
        rooms=rr, grp=grp, grp_slots=grp_slots,
    )
    plane.warm()
    counters = np.zeros(n, np.uint64)
    shard_built = np.zeros(len(lo), np.int64)
    ctr_base = 0
    iters = 0
    datagrams = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        # Fresh counters every pass: nonces must never repeat per session.
        counters[:] = np.uint64(ctr_base) + kk.astype(np.uint64)
        ctr_base += pkts
        out, out_off, out_len, sent, s_sent, s_built, s_ns = (
            native.egress.send_sharded(fd=fd, counters=counters, **args)
        )
        plane.record_send(n, int((grp >= 0).sum()), sent, lo, hi,
                          s_sent, s_built, s_ns)
        shard_built += s_built
        datagrams += sent
        iters += 1
    wall = time.perf_counter() - t0
    return {
        "entries_per_call": n,
        "iters": iters,
        "datagrams": datagrams,
        "wall_s": round(wall, 3),
        "pps": round(datagrams / wall, 1) if wall > 0 else 0.0,
        "shards": plane.shards,
        "shard_built": [int(x) for x in shard_built],
        "grouped_pct": round(100.0 * float((grp >= 0).mean()), 1),
        "sealed": sealed,
        "bytes_per_dgram": payload_len + 12 + (30 if sealed else 0),
    }


def bench_plane_scaling(
    payload_len: int = 1100,
    sealed: bool = True,
    seconds_per_point: float = 1.5,
    max_shards: int = 0,
    **shape: Any,
) -> dict[str, Any]:
    """pps vs shard count on THIS host: one bench_plane point per shard
    count (1, 2, 4, ... up to the core budget). Room-aligned shards share
    no state, so an N-core host should scale the sealed walk near
    linearly until the memory bus saturates — the curve makes the actual
    knee visible instead of leaving "multiply by cores" as an untested
    claim. On a 1-CPU host this degenerates to the single-shard point
    (flagged in the result).

    The native pool is one a process and only grows, so a point of k
    shards may run on a pool of more workers: each point carries the
    pool's size after it, and fails unless each of its k shards built
    entries (a k-shard plan that ran fewer shards would measure fewer
    cores than it claims)."""
    from livekit_server_tpu_torch import native

    cores = os.cpu_count() or 1
    budget = max_shards or min(cores, 8)
    ks: list[int] = []
    k = 1
    while k <= budget:
        ks.append(k)
        k *= 2
    if budget not in ks:
        ks.append(budget)
    points = []
    for k in ks:
        ep = EgressPlane(k)
        r = bench_plane(
            ep, payload_len=payload_len, sealed=sealed,
            seconds=seconds_per_point, **shape,
        )
        if "error" in r:
            return {"error": r["error"], "cores": cores}
        built = r["shard_built"]
        if len(built) != k or not all(built):
            return {"error": f"{k} shards planned, built by shard {built}",
                    "cores": cores}
        points.append({"shards": k, "pps": r["pps"], "shard_built": built,
                       "pool_size": native.egress.pool_size()})
    base = points[0]["pps"] or 1.0
    return {
        "cores": cores,
        "single_core_rig": cores <= 1,
        "sealed": sealed,
        "points": points,
        "speedup": [round(p["pps"] / base, 2) for p in points],
    }
