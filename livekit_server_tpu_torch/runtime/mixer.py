"""Server-side audio mixing (the MCU seat) — BASELINE config 2.

Reference parity: the reference is SFU-only (pkg/sfu/audio/audiolevel.go
reads levels; it never decodes). This build's BASELINE commits to a
batched active-speaker mix, so the seat is real here: per-track Opus
decode (host, stateful — interop/opus.py over libopus), an [S, T] mix
(numpy at per-room scale; one batched matmul over every mixing room on
the mixer's device from DEVICE_MIX_MIN_ROOMS rooms up), and
per-subscriber Opus re-encode with self-exclusion (you never hear
yourself).

Egress rides the transport's `_sendto` chokepoint, so a mixed stream
reaches sealed, TCP-fallback, and SRTP-gateway subscribers through
their own lanes unchanged.

Opt-in: signal `subscription {"audio_mix": true}` (signalhandler) or
`AudioMixer.enable_sub` directly. Subscribers typically unsubscribe the
individual audio tracks at the same time — the mix replaces them.

Port of the JAX package's runtime/mixer.py. `_device_mix` runs on the
mixer's explicit `device` (the transport's, set by the room manager when
it attaches the transport; "cuda" unless the caller asks for the CPU);
it is one `torch.bmm` in full float32 (the reference's einsum is
outside any Pallas kernel), with no per-shape cache: torch compiles
nothing per shape. The reference's `device_entry` registration
(its analysis tooling) is not carried.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from livekit_server_tpu_torch.analysis.registry import device_entry
from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.interop import opus

__all__ = ["AudioMixer"]

OPUS_PT = 111
# A track with no packet for this long stops contributing (and stops
# burning PLC) until media resumes.
ACTIVE_TTL_S = 0.4
# Brief gaps inside an active stream are concealed by the decoder.
PLC_MAX_FRAMES = 10
# Rooms mixing this frame before the batched path takes over from the
# per-room numpy sum. Below it, one device dispatch costs more than the
# host loop; at the 1000-room shape (bench audio_mix_1kroom) the batched
# matmul is the only tractable form.
DEVICE_MIX_MIN_ROOMS = 64


@device_entry("mixer.device_mix")
def _device_mix(pcm: torch.Tensor, present: torch.Tensor, exclude: torch.Tensor):
    """Batched room mix, one batched matmul for every enabled room at
    once — the "rst,rtn->rsn" contraction of ops/mix.mix_tick with the
    include weight reduced to presence & self-exclusion (the host path's
    sum-all-tracks policy, NOT the top-K speaker gate). int16 samples
    summed in float32 are exact below 2^24 in full float32 (TF32 would
    round them), so the result is bit-equal to the numpy int32 sum after
    rounding.

    pcm [R, T, N] float32; present [R, T] bool; exclude [R, S] int32 (the
    column of the subscriber's own track, T = none); all on one device.
    Returns [R, S, N] float32 there."""
    cols = torch.arange(pcm.shape[1], dtype=torch.int32, device=pcm.device)
    inc = present[:, None, :] & (cols[None, None, :] != exclude[:, :, None])
    return torch.bmm(inc.to(torch.float32), pcm)


def _p2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


class _TrackLane:
    def __init__(self):
        self.dec = opus.OpusDecoder()
        self.pending: deque = deque(maxlen=3)   # tiny jitter absorber
        self.last_seen = 0.0
        self.plc_run = 0


class _SubLane:
    def __init__(self, ssrc: int, bitrate: int, exclude_track: int):
        self.enc = opus.OpusEncoder(bitrate=bitrate)
        self.ssrc = ssrc
        self.sn = 0
        self.ts = 0
        self.exclude_track = exclude_track


class _RoomMix:
    def __init__(self):
        self.tracks: dict[int, _TrackLane] = {}
        self.subs: dict[int, _SubLane] = {}


class AudioMixer:
    """Per-node mixing state; owned by UDPMediaTransport
    (enable_audio_mixer)."""

    def __init__(self, transport, frame_ms: int = 20, device="cuda"):
        if not opus.available():
            raise opus.OpusError("libopus not available on this host")
        self.transport = transport
        self.device = resolve(device)
        self.frame_s = frame_ms / 1000.0
        self.rooms: dict[int, _RoomMix] = {}
        self._room_arr = np.zeros(0, np.int64)
        self._next_at = 0.0
        self.device_mix_min_rooms = DEVICE_MIX_MIN_ROOMS
        self.stats = {"frames_mixed": 0, "packets_out": 0,
                      "decode_errors": 0, "device_mix_frames": 0}

    # -- control ----------------------------------------------------------

    def enable_sub(
        self, room: int, sub: int, enabled: bool = True,
        exclude_track: int = -1, bitrate: int = 32000,
    ) -> None:
        """Opt one subscriber into (or out of) the room's mixed stream.
        `exclude_track` is their own audio track column (self-exclusion)."""
        if enabled:
            rm = self.rooms.setdefault(room, _RoomMix())
            lane = rm.subs.get(sub)
            if lane is None:
                rm.subs[sub] = _SubLane(
                    self.transport._new_ssrc(), bitrate, exclude_track
                )
            else:
                lane.exclude_track = exclude_track
        else:
            rm = self.rooms.get(room)
            if rm is not None:
                rm.subs.pop(sub, None)
                if not rm.subs:
                    self.rooms.pop(room, None)
        self._room_arr = np.fromiter(self.rooms, np.int64, len(self.rooms))

    def set_publisher_track(self, room: int, sub_col: int, track: int) -> None:
        """An audio track was published by the participant holding
        `sub_col`: keep that subscriber's self-exclusion current even when
        the opt-in arrived before the publish (or across republishes)."""
        rm = self.rooms.get(room)
        if rm is not None and sub_col in rm.subs:
            rm.subs[sub_col].exclude_track = track

    def release_track(self, room: int, track: int) -> None:
        """Track column freed: its decoder state and queued payloads must
        not leak to the column's next tenant, and stale self-exclusions
        must not mute the next publisher for unrelated subscribers."""
        rm = self.rooms.get(room)
        if rm is None:
            return
        lane = rm.tracks.pop(track, None)
        if lane is not None:
            lane.dec.close()
        for sub_lane in rm.subs.values():
            if sub_lane.exclude_track == track:
                sub_lane.exclude_track = -1

    def release_room(self, room: int) -> None:
        rm = self.rooms.pop(room, None)
        if rm is not None:
            for lane in rm.tracks.values():
                lane.dec.close()
            for lane in rm.subs.values():
                lane.enc.close()
        self._room_arr = np.fromiter(self.rooms, np.int64, len(self.rooms))

    def room_mask(self, rooms: np.ndarray) -> np.ndarray:
        """Vector mask: which entries belong to mix-enabled rooms."""
        return np.isin(rooms, self._room_arr)

    # -- ingest tap (udp._process_media_arrays, audio in enabled rooms) ---

    def push(self, room: int, track: int, ts: int, payload: bytes) -> None:
        rm = self.rooms.get(room)
        if rm is None or not payload:
            return
        lane = rm.tracks.get(track)
        if lane is None:
            try:
                lane = rm.tracks[track] = _TrackLane()
            except opus.OpusError:
                return
        lane.pending.append(payload)
        lane.last_seen = time.monotonic()

    # -- frame clock ------------------------------------------------------

    def maybe_tick(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        if now < self._next_at:
            return
        # Accumulate from the PREVIOUS deadline (with a one-frame catch-up
        # clamp): rescheduling from `now` would add the caller's lateness
        # to every period, running the frame clock slower than real time
        # and overflowing the per-track jitter queues.
        self._next_at = max(self._next_at + self.frame_s, now - self.frame_s)
        self.tick(now)

    def tick(self, now: float | None = None) -> None:
        """Mix + emit one 20 ms frame for every enabled room.

        Decode is always host-side (Opus is stateful C); the mix itself
        runs per room in numpy until DEVICE_MIX_MIN_ROOMS rooms are
        active in the same frame, then switches to one batched matmul
        over every room at once (_device_mix) — the only form that holds
        the 20 ms deadline at the 1000-room shape. Both paths produce
        identical int16 frames."""
        now = time.monotonic() if now is None else now
        staged: list[tuple[int, _RoomMix, dict[int, np.ndarray]]] = []
        for room, rm in list(self.rooms.items()):
            pcm_by_track: dict[int, np.ndarray] = {}
            for track, lane in list(rm.tracks.items()):
                if lane.pending:
                    lane.plc_run = 0
                    try:
                        pcm = lane.dec.decode(lane.pending.popleft())
                    except opus.OpusError:
                        self.stats["decode_errors"] += 1
                        continue
                elif (
                    now - lane.last_seen < ACTIVE_TTL_S
                    and lane.plc_run < PLC_MAX_FRAMES
                ):
                    lane.plc_run += 1
                    try:
                        pcm = lane.dec.decode(None)  # loss concealment
                    except opus.OpusError:
                        continue
                else:
                    if now - lane.last_seen > 5.0:
                        lane.dec.close()
                        del rm.tracks[track]
                    continue
                if len(pcm) == opus.FRAME_SAMPLES:
                    pcm_by_track[track] = pcm.astype(np.int32)
            if not pcm_by_track:
                continue
            self.stats["frames_mixed"] += 1
            staged.append((room, rm, pcm_by_track))
        if len(staged) >= self.device_mix_min_rooms:
            self._mix_device(staged)
        else:
            for room, rm, pcm_by_track in staged:
                self._mix_host(room, rm, pcm_by_track)

    def _mix_host(
        self, room: int, rm: _RoomMix, pcm_by_track: dict[int, np.ndarray]
    ) -> None:
        tracks = list(pcm_by_track)
        stack = np.stack([pcm_by_track[t] for t in tracks])  # [T, N]
        total = stack.sum(axis=0)
        for sub, lane in rm.subs.items():
            mix = total
            if lane.exclude_track in pcm_by_track:
                mix = total - pcm_by_track[lane.exclude_track]
            out = np.clip(mix, -32768, 32767).astype(np.int16)
            self._encode_emit(room, sub, lane, out, pcm_by_track)

    def _mix_device(
        self, staged: list[tuple[int, _RoomMix, dict[int, np.ndarray]]]
    ) -> None:
        # Pad the frame's rooms into one [R, T, N] slab (pow2 track/sub
        # buckets, as the reference keeps its jit cache small across
        # churn) and contract once; emit walks the real subscribers only.
        N = opus.FRAME_SAMPLES
        Tm = _p2(max(len(p) for _, _, p in staged))
        Sm = _p2(max(1, max(len(rm.subs) for _, rm, _ in staged)))
        R = len(staged)
        pcm = np.zeros((R, Tm, N), np.float32)
        present = np.zeros((R, Tm), bool)
        exclude = np.full((R, Sm), Tm, np.int32)
        for i, (_room, rm, ptk) in enumerate(staged):
            col = {t: j for j, t in enumerate(ptk)}
            for t, j in col.items():
                pcm[i, j] = ptk[t]
                present[i, j] = True
            for s, lane in enumerate(rm.subs.values()):
                exclude[i, s] = col.get(lane.exclude_track, Tm)
        dev = self.device
        out = _device_mix(torch.from_numpy(pcm).to(dev), torch.from_numpy(present).to(dev),
                          torch.from_numpy(exclude).to(dev)).cpu().numpy()
        self.stats["device_mix_frames"] += 1
        for i, (room, rm, ptk) in enumerate(staged):
            for s, (sub, lane) in enumerate(rm.subs.items()):
                mixed = np.clip(
                    np.rint(out[i, s]), -32768, 32767).astype(np.int16)
                self._encode_emit(room, sub, lane, mixed, ptk)

    def _encode_emit(
        self, room: int, sub: int, lane: _SubLane,
        out: np.ndarray, pcm_by_track: dict[int, np.ndarray],
    ) -> None:
        if not out.any() and lane.exclude_track in pcm_by_track \
                and len(pcm_by_track) == 1:
            return  # only their own voice was active
        try:
            pkt = lane.enc.encode(out)
        except opus.OpusError:
            return
        self._emit(room, sub, lane, pkt)

    def _emit(self, room: int, sub: int, lane: _SubLane, payload: bytes) -> None:
        t = self.transport
        addr = t.sub_addrs.get((room, sub))
        if addr is None:
            return
        hdr = bytearray(12)
        hdr[0] = 0x80
        hdr[1] = OPUS_PT
        hdr[2:4] = (lane.sn & 0xFFFF).to_bytes(2, "big")
        hdr[4:8] = (lane.ts & 0xFFFFFFFF).to_bytes(4, "big")
        hdr[8:12] = lane.ssrc.to_bytes(4, "big")
        lane.sn += 1
        lane.ts += opus.FRAME_SAMPLES
        t._sendto(bytes(hdr) + payload, addr, t.sub_sessions.get((room, sub)))
        t.stats["tx"] += 1
        self.stats["packets_out"] += 1

    def debug_summary(self) -> dict:
        return {
            "rooms": len(self.rooms),
            "subs": sum(len(r.subs) for r in self.rooms.values()),
            "tracks": sum(len(r.tracks) for r in self.rooms.values()),
            **self.stats,
        }

    def close(self) -> None:
        for rm in self.rooms.values():
            for lane in rm.tracks.values():
                lane.dec.close()
            for lane in rm.subs.values():
                lane.enc.close()
        self.rooms.clear()
        self._room_arr = np.zeros(0, np.int64)
