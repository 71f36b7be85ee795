"""The reference's munger: the SN/TS rewrite of pkg/sfu/rtpmunger.go and
the picture-field rewrite of pkg/sfu/codecmunger/vp8.go, per (room,
track, subscriber) lane, for one tick's decisions.

Semantics as the golden scans formulate them (the port's ops/rtpmunger.py
`munge_tick`/`padding_tick` and ops/vp8.py `munge_tick`): the first
forwarded packet anchors a lane (offsets 0); a forwarded packet flagged
as a source switch re-anchors it, SN at last + 1, TS at last + the
packet's TS jump (or through the offset when packet and anchor both sit
on the common timeline), picture id at last + 1, TL0PICIDX and KEYIDX at
last + 1; a continuing forward whose output TS would leap by more than
900,000 re-anchors with a 3000 jump; a dropped packet of a started lane
pulls later SNs down by one, a dropped picture start pulls later picture
ids down by one. Probe padding continues a started lane's SN space after
its last packet at its last TS plus one tick.

A lane's state is a dict of [R, T, S] arrays under `FIELDS`, values held
to their field widths in int64 (TS 32 bits, SN 16, picture id 15, TL0 8,
KEYIDX 5). The scan runs over the lanes that forward or drop a valid
packet this tick, vectorized over lanes, a step per packet slot. Plain
numpy; imports nothing of the port.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("sn_offset", "ts_offset", "last_sn", "last_ts", "pid_offset", "tl0_offset",
          "ki_offset", "last_pid", "last_tl0", "last_ki", "started", "aligned", "v_started")
FLAGS = ("started", "aligned", "v_started")
ROW_FIELDS = ("room", "track", "k", "sub", "sn", "ts", "pid", "tl0", "keyidx")
SN, TS, PID, TL0, KI = 0xFFFF, 0xFFFFFFFF, 0x7FFF, 0xFF, 0x1F
SHEAR_LIMIT = 900_000
FALLBACK_JUMP = 3000


def init(rooms: int, tracks: int, subs: int) -> dict:
    return {f: np.zeros((rooms, tracks, subs), bool if f in FLAGS else np.int64)
            for f in FIELDS}


def unpack_bits(words, subs: int) -> np.ndarray:
    """[R, T, K, W] int32 words, bit s of word s // 32 per subscriber →
    [R, T, K, S] bool."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    bits = (w[..., :, None] >> np.arange(32)) & 1                 # [R, T, K, W, 32]
    return bits.reshape(*w.shape[:-1], -1)[..., :subs].astype(bool)


def _signed(x, mask: int) -> np.ndarray:
    """A `mask`-wide ring value as its signed distance from 0."""
    half = (mask + 1) // 2
    return ((x + half) & mask) - half


def munge_tick(state: dict, inp, send_bits, drop_bits, switch_bits):
    """One tick: (new state, rows). `inp`: the tick's numpy inputs (sn, ts,
    ts_jump, pid, tl0, keyidx, begin_pic, valid, [R, T, K]); the bit
    masks as the tick gives them. `rows` maps `ROW_FIELDS` to [N] int64
    columns, a row per forwarded (room, track, slot, subscriber) in that
    order; `ts` as int32 two's complement."""
    S = state["started"].shape[-1]
    valid = np.asarray(inp.valid, bool)
    send = unpack_bits(send_bits, S) & valid[..., None]              # [R, T, K, S]
    drop = unpack_bits(drop_bits, S) & valid[..., None] & ~send
    switch = unpack_bits(switch_bits, S) & send
    rr, tt, ss = np.nonzero((send | drop).any(axis=2))               # active lanes
    st = {f: state[f][rr, tt, ss] for f in FIELDS}
    lane = lambda x: np.asarray(x, np.int64)[rr, tt]  # noqa: E731  [N, K]
    sn, ts, jump = lane(inp.sn) & SN, lane(inp.ts) & TS, lane(inp.ts_jump)
    pid, tl0, ki = lane(inp.pid) & PID, lane(inp.tl0) & TL0, lane(inp.keyidx) & KI
    begin = np.asarray(inp.begin_pic, bool)[rr, tt]
    fw_all, dr_all, sw_all = (m.transpose(0, 1, 3, 2)[rr, tt, ss] for m in (send, drop, switch))
    N, K = sn.shape
    out = {f: np.zeros((N, K), np.int64) for f in ("sn", "ts", "pid", "tl0", "keyidx")}
    for k in range(K):
        fw, dr, sw, bp = fw_all[:, k], dr_all[:, k], sw_all[:, k], begin[:, k]
        s, t, j = sn[:, k], ts[:, k], jump[:, k]
        on_line = j < 0
        j = np.where(on_line, FALLBACK_JUMP, j)
        # rtpmunger: anchor, switch or shear, then rewrite.
        fresh = fw & ~st["started"]
        switched = sw & st["started"]
        shear = _signed(((t - st["ts_offset"]) & TS) - st["last_ts"], TS)
        sheared = fw & ~sw & st["started"] & (np.abs(shear) > SHEAR_LIMIT)
        sw_ts = np.where(on_line & st["aligned"], st["ts_offset"],
                         (t - st["last_ts"] - j) & TS)
        st["sn_offset"] = np.where(switched, (s - st["last_sn"] - 1) & SN,
                                   np.where(fresh, 0, st["sn_offset"]))
        st["ts_offset"] = np.where(sheared, (t - st["last_ts"] - FALLBACK_JUMP) & TS,
                                   np.where(switched, sw_ts,
                                            np.where(fresh, 0, st["ts_offset"])))
        st["aligned"] = np.where(fresh | switched | sheared, on_line, st["aligned"])
        o_sn, o_ts = (s - st["sn_offset"]) & SN, (t - st["ts_offset"]) & TS
        st["last_sn"] = np.where(fw, o_sn, st["last_sn"])
        st["last_ts"] = np.where(fw, o_ts, st["last_ts"])
        st["sn_offset"] = np.where(dr & st["started"], (st["sn_offset"] + 1) & SN,
                                   st["sn_offset"])
        st["started"] = st["started"] | fw
        # vp8: the same for the picture fields, counted per picture start.
        p, z, x = pid[:, k], tl0[:, k], ki[:, k]
        v_fresh = fw & ~st["v_started"]
        v_switched = sw & st["v_started"]
        for f, val, last, mask in (("pid_offset", p, "last_pid", PID),
                                   ("tl0_offset", z, "last_tl0", TL0),
                                   ("ki_offset", x, "last_ki", KI)):
            st[f] = np.where(v_switched, (val - st[last] - 1) & mask,
                             np.where(v_fresh, 0, st[f]))
        o_pid = (p - st["pid_offset"]) & PID
        o_tl0 = (z - st["tl0_offset"]) & TL0
        o_ki = (x - st["ki_offset"]) & KI
        for last, val in (("last_pid", o_pid), ("last_tl0", o_tl0), ("last_ki", o_ki)):
            st[last] = np.where(fw & bp, val, st[last])
        st["pid_offset"] = np.where(dr & bp & st["v_started"], (st["pid_offset"] + 1) & PID,
                                    st["pid_offset"])
        st["v_started"] = st["v_started"] | fw
        for f, val in (("sn", o_sn), ("ts", o_ts), ("pid", o_pid), ("tl0", o_tl0),
                       ("keyidx", o_ki)):
            out[f][:, k] = np.where(fw, val, 0)
    new = {f: state[f].copy() for f in FIELDS}
    for f in FIELDS:
        new[f][rr, tt, ss] = st[f]
    li, kk = np.nonzero(fw_all)
    order = np.lexsort((ss[li], kk, tt[li], rr[li]))
    li, kk = li[order], kk[order]
    rows = {"room": rr[li], "track": tt[li], "k": kk, "sub": ss[li]}
    for f in ("sn", "pid", "tl0", "keyidx"):
        rows[f] = out[f][li, kk]
    rows["ts"] = out["ts"][li, kk].astype(np.uint32).view(np.int32).astype(np.int64)
    return new, {f: np.asarray(rows[f], np.int64) for f in ROW_FIELDS}


def padding(state: dict, pad_num, pad_track, ts_advance: int):
    """Probe padding after the tick's packets: (new state, rows) for each
    (room, subscriber) with padding on a started lane of its pad track; a
    run of n packets takes SNs last + 1 .. last + n at last TS +
    `ts_advance`, and moves the lane's SN offset back by n. The j-th
    packet of a run is the row of slot -j."""
    new = {f: state[f].copy() for f in FIELDS}
    pad_num, pad_track = np.asarray(pad_num), np.asarray(pad_track)
    rows = {f: [] for f in ROW_FIELDS}
    for r, s in zip(*np.nonzero((pad_num > 0) & (pad_track >= 0))):
        t, n = int(pad_track[r, s]), int(pad_num[r, s])
        if not new["started"][r, t, s]:
            continue
        last_sn = int(new["last_sn"][r, t, s])
        ts = (int(new["last_ts"][r, t, s]) + ts_advance) & TS
        for j in range(1, n + 1):
            for f, v in zip(ROW_FIELDS, (r, t, -j, s, (last_sn + j) & SN,
                                         ts - (1 << 32) if ts >= 1 << 31 else ts, 0, 0, 0)):
                rows[f].append(int(v))
        new["sn_offset"][r, t, s] = (new["sn_offset"][r, t, s] - n) & SN
        new["last_sn"][r, t, s] = (last_sn + n) & SN
        new["last_ts"][r, t, s] = ts
    return new, {f: np.asarray(rows[f], np.int64) for f in ROW_FIELDS}
