"""The reference's staging: one tick's received packets → the tick's inputs.

What a node's receive buffer does with the packets of one tick
(pkg/sfu/buffer/buffer.go: Write, the within-tick reorder and the
duplicate check): each (room, track) takes its packets into slots
0..K-1 in arrival order and drops the rest; the slots are then sorted by
(spatial layer, sequence number relative to the layer's first packet),
and a packet whose layer and SN equal its sorted neighbour's is a
duplicate and no longer valid. Slots without a packet hold zeros (127
for the audio level, a 3000-tick fallback TS jump): the tick reads no
field of an invalid slot, and neither does the munger.

Plain numpy, written from those semantics, a loop over the (room, track)
groups that received more than one packet. It imports nothing of the
port.
"""

from __future__ import annotations

import numpy as np

from . import tick

# Fields of a received packet, as the columns of a receive batch carry
# them, that become [R, T, K] input fields of the same name.
SLOT_FIELDS = ("sn", "ts", "layer", "temporal", "keyframe", "layer_sync", "begin_pic",
               "end_frame", "pid", "tl0", "keyidx", "size", "frame_ms", "audio_level",
               "arrival_rtp")
BOOL_FIELDS = ("keyframe", "layer_sync", "begin_pic", "end_frame")
FALLBACK_TS_JUMP = 3000
SILENT_LEVEL = 127


def _i32(x) -> np.ndarray:
    """Low 32 bits as int32 two's complement."""
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _rel16(sn: int, base: int) -> int:
    """Signed distance sn - base in the 16-bit SN ring."""
    d = (sn - base) & 0xFFFF
    return d - 0x10000 if d >= 0x8000 else d


def stage_packets(dims: tick.PlaneDims, cols: dict) -> dict:
    """The [R, T, K] packet fields and `valid` of one tick from its
    receive columns (`room`, `track`, the `SLOT_FIELDS`, `ts_aligned`;
    arrival order)."""
    R, T, K, _ = dims
    out = {f: np.zeros((R, T, K), bool if f in BOOL_FIELDS else np.int32)
           for f in SLOT_FIELDS}
    out["audio_level"][:] = SILENT_LEVEL
    out["ts_jump"] = np.full((R, T, K), FALLBACK_TS_JUMP, np.int32)
    out["valid"] = np.zeros((R, T, K), bool)
    room = np.asarray(cols["room"], np.int64)
    track = np.asarray(cols["track"], np.int64)
    # Slot = arrival rank within the (room, track); rank K and on drop.
    group = room * T + track
    order = np.argsort(group, kind="stable")
    starts = np.r_[0, np.flatnonzero(np.diff(group[order])) + 1]
    rank = np.empty(len(group), np.int64)
    rank[order] = np.arange(len(group)) - np.repeat(starts, np.diff(np.r_[starts, len(group)]))
    keep = rank < K
    r, t, k = room[keep], track[keep], rank[keep]
    vals = {f: np.asarray(cols[f])[keep] for f in SLOT_FIELDS}
    vals["sn"] = np.asarray(vals["sn"], np.int64) & 0xFFFF
    vals["ts"] = _i32(vals["ts"])
    vals["arrival_rtp"] = _i32(vals["arrival_rtp"])
    for f in SLOT_FIELDS:
        out[f][r, t, k] = vals[f]
    out["ts_jump"][r, t, k] = np.where(np.asarray(cols["ts_aligned"], bool)[keep], -1,
                                       FALLBACK_TS_JUMP)
    out["valid"][r, t, k] = True
    fields = SLOT_FIELDS + ("ts_jump", "valid")
    counts = np.bincount(r * T + t, minlength=R * T).reshape(R, T)
    for gr, gt in zip(*np.nonzero(counts > 1)):
        n = int(counts[gr, gt])
        sn = out["sn"][gr, gt, :n].tolist()
        layer = out["layer"][gr, gt, :n].tolist()
        first: dict = {}
        for j in range(n):
            first.setdefault(layer[j], sn[j])
        perm = sorted(range(n), key=lambda j: (layer[j], _rel16(sn[j], first[layer[j]])))
        for f in fields:
            out[f][gr, gt, :n] = out[f][gr, gt, :n][perm]
        sn = [sn[j] for j in perm]
        layer = [layer[j] for j in perm]
        for j in range(1, n):
            if sn[j] == sn[j - 1] and layer[j] == layer[j - 1]:
                out["valid"][gr, gt, j] = False
    return out


def stage_tick(dims: tick.PlaneDims, cols: dict, estimate, estimate_valid, pub_rtt_ms,
               tick_ms: int, roll: bool) -> tick.TickInputs:
    """One tick's numpy TickInputs: the staged packets, the subscribers'
    newest estimates (`estimate` [R, S], valid where a report arrived this
    tick), the publishers' RTT [R, T], no NACKs, TWCC feedback or padding
    (the probe fills pad_num and pad_track)."""
    R, T, K, S = dims
    pk = stage_packets(dims, cols)
    zeros = lambda dt: np.zeros((R, S), dt)  # noqa: E731
    return tick.TickInputs(
        **{f: pk[f] for f in SLOT_FIELDS}, ts_jump=pk["ts_jump"], valid=pk["valid"],
        estimate=np.asarray(estimate, np.float32),
        estimate_valid=np.asarray(estimate_valid, bool),
        nacks=zeros(np.float32),
        pub_rtt_ms=np.asarray(pub_rtt_ms, np.float32),
        fb_delay_ms=zeros(np.float32), fb_recv_bps=zeros(np.float32),
        fb_valid=zeros(bool), fb_enabled=zeros(bool), sub_reset=zeros(bool),
        pad_num=zeros(np.int32), pad_track=np.full((R, S), -1, np.int32),
        tick_ms=np.int32(tick_ms), roll_quality=np.int32(1 if roll else 0),
    )
