"""Host-side RTP/VP8 munging: the rewrite half of the forward path.

Reference parity: pkg/sfu/rtpmunger.go (UpdateAndGetSnTs :183-271,
SN-gap compaction, PacketDropped, UpdateAndGetPaddingSnTs) and
pkg/sfu/codecmunger/vp8.go (UpdateAndGet :161, dropped-picture
accounting) — run, like the reference runs them, on the CPU in the
per-packet write path. The device decides (bit-packed send/drop/switch
masks); this module rewrites SN/TS/VP8 fields with host-owned state.

As in the JAX package's runtime/munge.py, `apply_columns` runs the
native C++ walker (native/csrc/munge.cpp; `walk_multi` over the egress
plane's room shards) when the library is loaded. `apply_columns_plain`
is the numpy path, run over the active (room, track, subscriber) lanes
only: the fallback, and the plain version the tests hold the walker
against. `apply_arrivals` is the express lane's entry (runtime/
express.py): the same scan over one receive batch's lanes. The semantics
are the golden scans' (ops/rtpmunger.py, ops/vp8.py), to which
tests/test_torch_golden_scans.py holds this walk.
"""

from __future__ import annotations

import numpy as np

from livekit_server_tpu_torch.models import plane

M16 = 0xFFFF
M32 = 0xFFFFFFFF
M15 = 0x7FFF
M8 = 0xFF
M5 = 0x1F

REANCHOR_TS_THRESH = 900_000
FALLBACK_TS_JUMP = 3000


def _popcount_u32(x: np.ndarray) -> np.ndarray:
    """Per-element popcount of uint32 words."""
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> 24


def _sdiff(a, b, mask, half):
    """Signed modular difference (a - b) in a `mask`-wide ring."""
    return ((a - b + half) & mask) - half


class HostMunger:
    """Per-(room, track, subscriber) SN/TS + VP8 rewrite state; all state
    arrays are [R, T, S] int64 (value-masked to their field widths) or
    bool."""

    FIELDS = (
        "sn_offset", "ts_offset", "last_sn", "last_ts",
        "pid_offset", "tl0_offset", "ki_offset",
        "last_pid", "last_tl0", "last_ki",
        "started", "aligned", "v_started",
    )

    def __init__(self, dims: plane.PlaneDims):
        R, T, _, S = dims
        self.dims = dims
        z = lambda: np.zeros((R, T, S), np.int64)  # noqa: E731
        f = lambda: np.zeros((R, T, S), bool)      # noqa: E731
        self.sn_offset = z()
        self.ts_offset = z()
        self.last_sn = z()
        self.last_ts = z()
        self.started = f()
        self.aligned = f()
        self.pid_offset = z()
        self.tl0_offset = z()
        self.ki_offset = z()
        self.last_pid = z()
        self.last_tl0 = z()
        self.last_ki = z()
        self.v_started = f()
        # Per-shard walk stats of the last sharded apply_columns (read by
        # EgressPlane.record_munge).
        self.last_shard_counts = np.zeros(0, np.int64)
        self.last_shard_ns = np.zeros(0, np.int64)

    def apply_lanes(
        self, rr, tt, ss,                                     # [N] lanes
        sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid,  # [R, T, K]
        send, drop, switch,                                   # [N, K] bool
    ):
        """One tick of munging for the (room, track, subscriber) lanes
        (rr, tt, ss), vectorized over lanes with a loop over the K packet
        slots. A lane's state changes only where it forwards or drops a
        valid packet, so lanes with neither may be left out. Returns
        (out_sn, out_ts, out_pid, out_tl0, out_ki) [N, K] (defined where
        `send`; zero elsewhere)."""
        return self._walk(
            rr, tt, ss,
            *(np.asarray(a)[rr, tt] for a in (sn, ts, ts_jump, pid, tl0, keyidx,
                                              begin_pic, valid)),
            send, drop, switch,
        )

    def apply_arrivals(
        self,
        gr, gt,                                               # [G] lane coords
        sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid,  # [G, Kb]
        send, drop, switch,                                   # [G, Kb, S] bool
    ):
        """Express-lane munging: the same scan applied to G gathered
        (room, track) lanes over one receive batch, in arrival order. It
        advances the SAME per-(room, track, sub) state the batched
        fan-out walks, which keeps a subscriber's SN/TS space continuous
        across tier promotion and demotion. (gr, gt) must name distinct
        lanes. Returns (out_sn, out_ts, out_pid, out_tl0, out_ki)
        [G, Kb, S] (defined where `send & valid`; zero elsewhere)."""
        G, Kb = np.asarray(sn).shape
        S = send.shape[-1]
        rr, tt = np.repeat(gr, S), np.repeat(gt, S)
        ss = np.tile(np.arange(S), G)
        per_lane = (np.repeat(np.asarray(a), S, axis=0)
                    for a in (sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid))
        masks = (np.asarray(m).transpose(0, 2, 1).reshape(G * S, Kb)
                 for m in (send, drop, switch))
        outs = self._walk(rr, tt, ss, *per_lane, *masks)
        return tuple(o.reshape(G, S, Kb).transpose(0, 2, 1) for o in outs)

    def _walk(self, rr, tt, ss, sn, ts, ts_jump, pid, tl0, keyidx, begin_pic,
              valid, send, drop, switch):
        """The scan over lanes (rr, tt, ss) with per-lane packet fields
        and masks [N, K]; writes the lanes' state back."""
        st = {name: getattr(self, name)[rr, tt, ss] for name in self.FIELDS}
        sn = np.asarray(sn, np.int64) & M16
        ts = np.asarray(ts, np.int64) & M32
        pid = np.asarray(pid, np.int64) & M15
        tl0 = np.asarray(tl0, np.int64) & M8
        ki = np.asarray(keyidx, np.int64) & M5
        jump = np.asarray(ts_jump, np.int64)
        bp = np.asarray(begin_pic, bool)
        val = np.asarray(valid, bool)
        N, K = sn.shape

        out_sn = np.zeros((N, K), np.int32)
        out_ts = np.zeros((N, K), np.int64)
        out_pid = np.zeros((N, K), np.int32)
        out_tl0 = np.zeros((N, K), np.int32)
        out_ki = np.zeros((N, K), np.int32)

        for k in range(K):
            v = val[:, k]
            fwd = send[:, k] & v
            drp = drop[:, k] & v & ~fwd
            sw = switch[:, k] & fwd
            sn_k, ts_k, jump_k = sn[:, k], ts[:, k], jump[:, k]
            pkt_aligned = jump_k < 0
            jump_eff = np.where(pkt_aligned, FALLBACK_TS_JUMP, jump_k)

            # --- rtpmunger step ------------------------------------------
            sw_sn_off = (sn_k - ((st["last_sn"] + 1) & M16)) & M16
            sw_ts_off = (ts_k - ((st["last_ts"] + jump_eff) & M32)) & M32
            carry_through = pkt_aligned & st["aligned"]
            sw_ts_off = np.where(carry_through, st["ts_offset"], sw_ts_off)
            fresh = fwd & ~st["started"]
            resync = sw & st["started"]
            cur_out_ts = (ts_k - st["ts_offset"]) & M32
            shear = _sdiff(cur_out_ts, st["last_ts"], M32, 1 << 31)
            sheared = (
                fwd & ~sw & st["started"] & (np.abs(shear) > REANCHOR_TS_THRESH)
            )
            shear_ts_off = (ts_k - ((st["last_ts"] + FALLBACK_TS_JUMP) & M32)) & M32
            anchor = fresh | resync | sheared
            st["sn_offset"] = np.where(
                resync, sw_sn_off, np.where(fresh, 0, st["sn_offset"])
            )
            st["ts_offset"] = np.where(
                sheared, shear_ts_off,
                np.where(resync, sw_ts_off, np.where(fresh, 0, st["ts_offset"])),
            )
            st["aligned"] = np.where(anchor, pkt_aligned, st["aligned"])
            o_sn = (sn_k - st["sn_offset"]) & M16
            o_ts = (ts_k - st["ts_offset"]) & M32
            st["last_sn"] = np.where(fwd, o_sn, st["last_sn"])
            st["last_ts"] = np.where(fwd, o_ts, st["last_ts"])
            st["sn_offset"] = np.where(
                drp & st["started"], (st["sn_offset"] + 1) & M16, st["sn_offset"]
            )
            st["started"] = st["started"] | fwd

            # --- vp8 step ------------------------------------------------
            drp_pic = drp & bp[:, k]
            pid_k, tl0_k, ki_k = pid[:, k], tl0[:, k], ki[:, k]
            sw_pid_off = (pid_k - ((st["last_pid"] + 1) & M15)) & M15
            sw_tl0_off = (tl0_k - st["last_tl0"] - 1) & M8
            sw_ki_off = (ki_k - st["last_ki"] - 1) & M5
            v_fresh = fwd & ~st["v_started"]
            v_resync = sw & st["v_started"]
            st["pid_offset"] = np.where(
                v_resync, sw_pid_off, np.where(v_fresh, 0, st["pid_offset"])
            )
            st["tl0_offset"] = np.where(
                v_resync, sw_tl0_off, np.where(v_fresh, 0, st["tl0_offset"])
            )
            st["ki_offset"] = np.where(
                v_resync, sw_ki_off, np.where(v_fresh, 0, st["ki_offset"])
            )
            o_pid = (pid_k - st["pid_offset"]) & M15
            o_tl0 = (tl0_k - st["tl0_offset"]) & M8
            o_ki = (ki_k - st["ki_offset"]) & M5
            fwd_bp = fwd & bp[:, k]
            st["last_pid"] = np.where(fwd_bp, o_pid, st["last_pid"])
            st["last_tl0"] = np.where(fwd_bp, o_tl0, st["last_tl0"])
            st["last_ki"] = np.where(fwd_bp, o_ki, st["last_ki"])
            st["pid_offset"] = np.where(
                drp_pic & st["v_started"], (st["pid_offset"] + 1) & M15,
                st["pid_offset"],
            )
            st["v_started"] = st["v_started"] | fwd

            out_sn[:, k] = np.where(fwd, o_sn, 0)
            out_ts[:, k] = np.where(fwd, o_ts, 0)
            out_pid[:, k] = np.where(fwd, o_pid, 0)
            out_tl0[:, k] = np.where(fwd, o_tl0, 0)
            out_ki[:, k] = np.where(fwd, o_ki, 0)
        for name, lane_vals in st.items():
            getattr(self, name)[rr, tt, ss] = lane_vals
        return out_sn, out_ts, out_pid, out_tl0, out_ki

    def apply_columns(
        self,
        sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid,  # [R, T, K]
        send_bits, drop_bits, switch_bits,                    # [R, T, K, W] i32
        shard_plan=None,
    ):
        """One tick's rewrites from the device's bit-packed masks to egress
        COLUMN arrays (rooms, tracks, ks, subs, sn, ts, pid, tl0, keyidx)
        in (room, track, k, sub) order, by the native walker when it is
        loaded, else by `apply_columns_plain`.

        `shard_plan` = (r_lo, r_hi) contiguous room ranges (from
        EgressPlane.room_plan) fans the walk across the native worker
        shards. Rooms are the state-ownership unit (lanes are indexed
        [room, track, sub]), so whole-room shards keep every state write
        thread-private; the output is bit-identical to the unsharded walk
        (exact per-shard prefix-sum bases)."""
        from livekit_server_tpu_torch import native

        args = (np.asarray(sn), np.asarray(ts), np.asarray(ts_jump),
                np.asarray(pid), np.asarray(tl0), np.asarray(keyidx),
                np.asarray(begin_pic), np.asarray(valid), np.asarray(send_bits),
                np.asarray(drop_bits), np.asarray(switch_bits))
        if native.munge is not None:
            cap = int(_popcount_u32(args[8].astype(np.uint32)).sum(dtype=np.int64))
            if shard_plan is not None and len(shard_plan[0]) > 1:
                res = native.munge.walk_multi(*args, self, cap, shard_plan[0],
                                              shard_plan[1])
                if res is not None:
                    cols, self.last_shard_counts, self.last_shard_ns = res
                    return cols
            else:
                res = native.munge.walk(*args, self, cap)
                if res is not None:
                    return res
        return self.apply_columns_plain(*args)

    def apply_columns_plain(
        self,
        sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid,  # [R, T, K]
        send_bits, drop_bits, switch_bits,                    # [R, T, K, W] i32
    ):
        """One tick's rewrites from the device's bit-packed masks to egress
        COLUMN arrays (rooms, tracks, ks, subs, sn, ts, pid, tl0, keyidx),
        in (room, track, k, sub) order. Only the lanes that send or drop a
        valid packet are munged: the masks are walked as words, never
        unpacked to the dense [R, T, K, S] plane."""
        S = self.dims.subs
        val = np.asarray(valid, bool)
        send_bits = np.asarray(send_bits).view(np.uint32)
        drop_bits = np.asarray(drop_bits).view(np.uint32)
        switch_bits = np.asarray(switch_bits).view(np.uint32)
        busy = np.bitwise_or.reduce(
            np.where(val[..., None], send_bits | drop_bits, 0), axis=2
        )                                                       # [R, T, W]
        r, t, w = np.nonzero(busy)
        bit = np.arange(32, dtype=np.uint32)
        i, b = np.nonzero((busy[r, t, w][:, None] >> bit) & 1)
        rr, tt, ss = r[i], t[i], w[i] * 32 + b                  # (r, t, s) order
        keep = ss < S
        rr, tt, ss = rr[keep], tt[keep], ss[keep]
        word, shift = ss // 32, (ss % 32).astype(np.uint32)

        def lane_bits(bits):  # [R, T, K, W] → [N, K] bool
            return ((bits[rr, tt, :, word] >> shift[:, None]) & 1).astype(bool)

        send = lane_bits(send_bits)
        o_sn, o_ts, o_pid, o_tl0, o_ki = self.apply_lanes(
            rr, tt, ss, sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid,
            send, lane_bits(drop_bits), lane_bits(switch_bits),
        )
        lane, kk = np.nonzero(send & val[rr, tt])
        order = np.lexsort((ss[lane], kk, tt[lane], rr[lane]))
        lane, kk = lane[order], kk[order]
        return (
            rr[lane].astype(np.int32), tt[lane].astype(np.int32),
            kk.astype(np.int32), ss[lane].astype(np.int32),
            o_sn[lane, kk].astype(np.int32),
            (o_ts[lane, kk] & M32).astype(np.uint32).view(np.int32),
            o_pid[lane, kk].astype(np.int32),
            o_tl0[lane, kk].astype(np.int32),
            o_ki[lane, kk].astype(np.int32),
        )

    def padding(self, pad_num, pad_track, ts_advance: int):
        """Synthesize probe-padding runs after this tick's sends
        (rtpmunger.go UpdateAndGetPaddingSnTs). pad_num/pad_track [R, S]
        (-1 = none). Returns (room, track, sub, sn, ts) per padding packet
        and advances the named lanes' SN space (offset -= n, last_sn += n)."""
        pad_num = np.asarray(pad_num)
        pad_track = np.asarray(pad_track)
        rr, ss = np.nonzero((pad_num > 0) & (pad_track >= 0))
        out = []
        for r, s in zip(rr, ss):
            t = int(pad_track[r, s])
            if not self.started[r, t, s]:
                continue
            n = int(pad_num[r, s])
            base_sn = int(self.last_sn[r, t, s])
            pad_ts = (int(self.last_ts[r, t, s]) + ts_advance) & M32
            for j in range(n):
                out.append((int(r), t, int(s), (base_sn + j + 1) & M16, pad_ts))
            self.sn_offset[r, t, s] = (self.sn_offset[r, t, s] - n) & M16
            self.last_sn[r, t, s] = (base_sn + n) & M16
            self.last_ts[r, t, s] = pad_ts
        return out

    def snapshot_room(self, room: int) -> list[np.ndarray]:
        return [np.array(getattr(self, name)[room]) for name in self.FIELDS]

    def restore_room(self, room: int, arrays: list[np.ndarray]) -> None:
        if len(arrays) != len(self.FIELDS):
            raise ValueError(
                f"munger snapshot has {len(arrays)} fields, expected "
                f"{len(self.FIELDS)}"
            )
        for name, arr in zip(self.FIELDS, arrays):
            dst = getattr(self, name)
            dst[room] = np.asarray(arr, dst.dtype)

    def snapshot(self) -> list[np.ndarray]:
        return [np.array(getattr(self, name)) for name in self.FIELDS]

    def restore(self, arrays: list[np.ndarray]) -> None:
        if len(arrays) != len(self.FIELDS):
            raise ValueError("munger snapshot field count mismatch")
        for name, arr in zip(self.FIELDS, arrays):
            dst = getattr(self, name)
            dst[...] = np.asarray(arr, dst.dtype)

    def clear_room(self, room: int) -> None:
        for name in self.FIELDS:
            getattr(self, name)[room] = False if name in (
                "started", "aligned", "v_started") else 0
