"""Host-side RTP/VP8 munging: the rewrite half of the forward path.

Reference parity: pkg/sfu/rtpmunger.go (UpdateAndGetSnTs :183-271,
SN-gap compaction, PacketDropped, UpdateAndGetPaddingSnTs) and
pkg/sfu/codecmunger/vp8.go (UpdateAndGet :161, dropped-picture
accounting) — run, like the reference runs them, on the CPU in the
per-packet write path. The device decides (bit-packed send/drop/switch
masks); this module rewrites SN/TS/VP8 fields with host-owned state.

A copy of the numpy path of the JAX package's runtime/munge.py
(`apply_dense` is its spec; the native C++ walker there is host code and
is not used here).
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

    def apply_dense(
        self,
        sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid,  # [R, T, K]
        send, drop, switch,                                   # [R, T, K, S] bool
    ):
        """One tick of munging over dense masks, vectorized over (room,
        track, subscriber) with a loop over the K packet slots. Returns
        dense (out_sn, out_ts, out_pid, out_tl0, out_ki) [R, T, K, S]
        (defined where `send`; zero elsewhere)."""
        R, T, K = np.asarray(sn).shape
        S = send.shape[-1]
        sn = np.asarray(sn, np.int64) & M16
        ts = np.asarray(ts, np.int64) & M32
        pid = np.asarray(pid, np.int64) & M15
        tl0 = np.asarray(tl0, np.int64) & M8
        ki = np.asarray(keyidx, np.int64) & M5
        jump = np.asarray(ts_jump, np.int64)
        bp = np.asarray(begin_pic, bool)
        val = np.asarray(valid, bool)

        out_sn = np.zeros((R, T, K, S), np.int32)
        out_ts = np.zeros((R, T, K, S), np.int64)
        out_pid = np.zeros((R, T, K, S), np.int32)
        out_tl0 = np.zeros((R, T, K, S), np.int32)
        out_ki = np.zeros((R, T, K, S), np.int32)

        for k in range(K):
            v = val[:, :, k][:, :, None]
            fwd = send[:, :, k, :] & v
            drp = drop[:, :, k, :] & v & ~fwd
            sw = switch[:, :, k, :] & fwd
            sn_k = sn[:, :, k][:, :, None]
            ts_k = ts[:, :, k][:, :, None]
            jump_k = jump[:, :, k][:, :, None]
            pkt_aligned = jump_k < 0
            jump_eff = np.where(pkt_aligned, FALLBACK_TS_JUMP, jump_k)

            # --- rtpmunger step ------------------------------------------
            sw_sn_off = (sn_k - ((self.last_sn + 1) & M16)) & M16
            sw_ts_off = (ts_k - ((self.last_ts + jump_eff) & M32)) & M32
            carry_through = pkt_aligned & self.aligned
            sw_ts_off = np.where(carry_through, self.ts_offset, sw_ts_off)
            fresh = fwd & ~self.started
            resync = sw & self.started
            cur_out_ts = (ts_k - self.ts_offset) & M32
            shear = _sdiff(cur_out_ts, self.last_ts, M32, 1 << 31)
            sheared = (
                fwd & ~sw & self.started & (np.abs(shear) > REANCHOR_TS_THRESH)
            )
            shear_ts_off = (ts_k - ((self.last_ts + FALLBACK_TS_JUMP) & M32)) & M32
            anchor = fresh | resync | sheared
            self.sn_offset = np.where(
                resync, sw_sn_off, np.where(fresh, 0, self.sn_offset)
            )
            self.ts_offset = np.where(
                sheared, shear_ts_off,
                np.where(resync, sw_ts_off, np.where(fresh, 0, self.ts_offset)),
            )
            self.aligned = np.where(anchor, pkt_aligned, self.aligned)
            o_sn = (sn_k - self.sn_offset) & M16
            o_ts = (ts_k - self.ts_offset) & M32
            self.last_sn = np.where(fwd, o_sn, self.last_sn)
            self.last_ts = np.where(fwd, o_ts, self.last_ts)
            self.sn_offset = np.where(
                drp & self.started, (self.sn_offset + 1) & M16, self.sn_offset
            )
            self.started = self.started | fwd

            # --- vp8 step ------------------------------------------------
            drp_pic = drp & bp[:, :, k][:, :, None]
            pid_k = pid[:, :, k][:, :, None]
            tl0_k = tl0[:, :, k][:, :, None]
            ki_k = ki[:, :, k][:, :, None]
            sw_pid_off = (pid_k - ((self.last_pid + 1) & M15)) & M15
            sw_tl0_off = (tl0_k - self.last_tl0 - 1) & M8
            sw_ki_off = (ki_k - self.last_ki - 1) & M5
            v_fresh = fwd & ~self.v_started
            v_resync = sw & self.v_started
            self.pid_offset = np.where(
                v_resync, sw_pid_off, np.where(v_fresh, 0, self.pid_offset)
            )
            self.tl0_offset = np.where(
                v_resync, sw_tl0_off, np.where(v_fresh, 0, self.tl0_offset)
            )
            self.ki_offset = np.where(
                v_resync, sw_ki_off, np.where(v_fresh, 0, self.ki_offset)
            )
            o_pid = (pid_k - self.pid_offset) & M15
            o_tl0 = (tl0_k - self.tl0_offset) & M8
            o_ki = (ki_k - self.ki_offset) & M5
            fwd_bp = fwd & bp[:, :, k][:, :, None]
            self.last_pid = np.where(fwd_bp, o_pid, self.last_pid)
            self.last_tl0 = np.where(fwd_bp, o_tl0, self.last_tl0)
            self.last_ki = np.where(fwd_bp, o_ki, self.last_ki)
            self.pid_offset = np.where(
                drp_pic & self.v_started, (self.pid_offset + 1) & M15,
                self.pid_offset,
            )
            self.v_started = self.v_started | fwd

            out_sn[:, :, k, :] = np.where(fwd, o_sn, 0)
            out_ts[:, :, k, :] = np.where(fwd, o_ts, 0)
            out_pid[:, :, k, :] = np.where(fwd, o_pid, 0)
            out_tl0[:, :, k, :] = np.where(fwd, o_tl0, 0)
            out_ki[:, :, k, :] = np.where(fwd, o_ki, 0)
        return out_sn, out_ts, out_pid, out_tl0, out_ki

    def apply_columns(
        self,
        sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid,  # [R, T, K]
        send_bits, drop_bits, switch_bits,                    # [R, T, K, W] i32
    ):
        """One tick's rewrites from the device's bit-packed masks to egress
        COLUMN arrays (rooms, tracks, ks, subs, sn, ts, pid, tl0, keyidx),
        in (room, track, k, sub) order."""
        S = self.dims.subs
        send = plane.unpack_bits(send_bits, S)
        drop = plane.unpack_bits(drop_bits, S)
        switch = plane.unpack_bits(switch_bits, S)
        o_sn, o_ts, o_pid, o_tl0, o_ki = self.apply_dense(
            sn, ts, ts_jump, pid, tl0, keyidx, begin_pic, valid,
            send, drop, switch,
        )
        eff = send & np.asarray(valid, bool)[..., None]
        rr, tt, kk, ss = np.nonzero(eff)
        return (
            rr.astype(np.int32), tt.astype(np.int32),
            kk.astype(np.int32), ss.astype(np.int32),
            o_sn[rr, tt, kk, ss].astype(np.int32),
            (o_ts[rr, tt, kk, ss] & M32).astype(np.uint32).view(np.int32),
            o_pid[rr, tt, kk, ss].astype(np.int32),
            o_tl0[rr, tt, kk, ss].astype(np.int32),
            o_ki[rr, tt, kk, ss].astype(np.int32),
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

    def clear_room(self, room: int) -> None:
        for name in self.FIELDS:
            getattr(self, name)[room] = False if name in (
                "started", "aligned", "v_started") else 0
