"""Synthetic RTP traffic for benchmarks and integration tests.

Reference parity: test/client/trackwriter.go — the reference's integration
tests drive the SFU with synthetic ivf/ogg/null-frame tracks written into
real Pion connections. Here the equivalent is a packet-*tensor* generator:
it synthesizes one tick's worth of plausible RTP field tensors (monotonic
SN/TS per stream, simulcast layer cycling, VP8 picture ids, RFC6464 audio
levels) directly in numpy, so benches and tests can drive
`media_plane_tick` without a network.

Deterministic given (seed, tick index): generation is pure numpy on host,
mirroring how the real runtime packs host-received UDP packets into the
ingest tensors (livekit_server_tpu_torch.runtime.ingest).

Frozen into the benchmark from the port's models/synth.py (itself a copy
of the JAX package's), with the tree types taken from the benchmark's
reference (`sfu_bench/reference/tick.py`), so that later changes to the
port cannot move the benchmark's traffic. The benchmark's own additions
(packet columns for `IngestBuffer.push_batch`, the replay advance of a
cycled library) are in `sfu_bench/gen/library.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from sfu_bench.reference import tick as plane


class TrafficSpec(NamedTuple):
    """Which tracks exist and what they carry, per room (uniform rooms)."""

    video_tracks: int = 2      # simulcast VP8, 3 spatial layers
    audio_tracks: int = 2      # Opus w/ RFC6464 levels
    fps: int = 30
    tick_ms: int = 10
    video_kbps: int = 1500     # per track, summed over layers
    audio_kbps: int = 32
    svc: bool = False          # video tracks are SVC (VP9/AV1 DD path)
    # Per-subscriber channel estimate fed as BWE samples. 0 = auto: 1.25×
    # the full offered bitrate, so throughput configs measure an
    # UNCONGESTED channel (congestion behavior is exercised by tests and
    # by setting this explicitly).
    estimate_bps: float = 0.0


class TrafficState(NamedTuple):
    """Host-side per-(room, track) generator cursors."""

    sn: np.ndarray        # [R, T] uint16 cursor
    ts: np.ndarray        # [R, T] uint32 cursor
    pid: np.ndarray       # [R, T] VP8 picture id cursor
    tl0: np.ndarray       # [R, T]
    frame_phase: np.ndarray  # [R, T] ms since last frame start


def init_traffic(dims: plane.PlaneDims, spec: TrafficSpec, seed: int = 0) -> TrafficState:
    R, T = dims.rooms, dims.tracks
    rng = np.random.default_rng(seed)
    return TrafficState(
        sn=rng.integers(0, 1 << 16, (R, T)).astype(np.int64),
        ts=rng.integers(0, 1 << 31, (R, T)).astype(np.int64),
        pid=rng.integers(0, 1 << 14, (R, T)).astype(np.int64),
        tl0=rng.integers(0, 200, (R, T)).astype(np.int64),
        frame_phase=np.zeros((R, T), np.int64),
    )


def make_meta_ctrl(dims: plane.PlaneDims, spec: TrafficSpec):
    """TrackMeta / SubControl numpy tensors for a uniform fully-meshed node.

    Every room has `video_tracks` + `audio_tracks` published tracks and every
    subscriber subscribes to all of them (the reference's auto-subscribe
    default — room.go subscribeToExistingTracks).
    """
    R, T, _, S = dims
    nv = min(spec.video_tracks, T)
    used = min(nv + spec.audio_tracks, T)
    is_video = np.zeros((R, T), bool)
    is_video[:, :nv] = True
    published = np.zeros((R, T), bool)
    published[:, :used] = True
    meta = plane.TrackMeta(
        is_video=is_video,
        published=published,
        pub_muted=np.zeros((R, T), bool),
        is_svc=is_video.copy() if spec.svc else np.zeros((R, T), bool),
    )
    ctrl = plane.SubControl(
        subscribed=np.broadcast_to(published[:, :, None], (R, T, S)).copy(),
        sub_muted=np.zeros((R, T, S), bool),
        max_spatial=np.full((R, T, S), plane.MAX_LAYERS - 1, np.int32),
        max_temporal=np.full((R, T, S), 3, np.int32),
    )
    return meta, ctrl


def next_tick(
    state: TrafficState,
    dims: plane.PlaneDims,
    spec: TrafficSpec,
    tick_index: int,
    seed: int = 0,
) -> tuple[TrafficState, plane.TickInputs]:
    """Generate one tick of ingest tensors; pure host numpy."""
    R, T, K, S = dims
    rng = np.random.default_rng((seed << 20) ^ tick_index)
    nv = min(spec.video_tracks, T)
    used = min(nv + spec.audio_tracks, T)
    is_video = np.zeros((T,), bool)
    is_video[:nv] = True

    # Packets per tick per track: video ≈ bitrate/MTU, audio = one per 20 ms.
    v_pps = spec.video_kbps * 125 / 1200 / 1000 * spec.tick_ms  # pkts per tick
    a_pps = spec.tick_ms / 20.0
    want = np.where(is_video, v_pps, a_pps)
    want[used:] = 0.0
    counts = np.minimum(
        K, rng.poisson(np.broadcast_to(want, (R, T))).astype(np.int64)
    )
    k_idx = np.arange(K)
    valid = k_idx[None, None, :] < counts[:, :, None]  # [R, T, K]

    sn = (state.sn[:, :, None] + k_idx[None, None, :]) & 0xFFFF
    new_sn = (state.sn + counts) & 0xFFFF

    # Video: frame boundaries every 1000/fps ms; all packets in a tick share
    # a frame TS unless the frame rolls over mid-tick (coarse but plausible).
    frame_ms = max(1, 1000 // spec.fps)
    phase = state.frame_phase + spec.tick_ms
    new_frame = phase >= frame_ms
    phase = np.where(new_frame, phase % frame_ms, phase)
    ts_step_v = new_frame.astype(np.int64) * 90 * frame_ms
    ts_step_a = spec.tick_ms * 48  # 48 kHz Opus
    ts_step = np.where(is_video[None, :], ts_step_v, ts_step_a)
    new_ts = (state.ts + ts_step) & 0xFFFFFFFF
    ts = np.broadcast_to(new_ts[:, :, None], (R, T, K)).astype(np.int64)

    # Simulcast: packets cycle through spatial layers 0..2 weighted by size.
    layer = np.where(is_video[None, :, None], k_idx[None, None, :] % 3, 0)
    temporal = np.where(is_video[None, :, None], k_idx[None, None, :] % 2, 0)
    # Keyframe ticks mark the first packet of EVERY spatial layer (real
    # simulcast encoders key all layers together; the selector locks onto a
    # spatial layer only at a keyframe of that layer — simulcast.go:42).
    keyframe = np.logical_and(
        is_video[None, :, None],
        (tick_index % 100 == 0) & (k_idx[None, None, :] < 3),
    )
    begin_pic = np.logical_and(is_video[None, :, None], new_frame[:, :, None])
    layer_sync = keyframe | (begin_pic & (temporal == 0))

    # First packet of the new picture only (per spatial layer, one packet
    # carries begin_pic — layer == k for k < 3 under the k%3 cycling).
    begin_pic = begin_pic & (k_idx[None, None, :] == layer)

    pid_inc = new_frame.astype(np.int64)
    pid = (state.pid + pid_inc)[:, :, None] & 0x7FFF
    pid = np.broadcast_to(pid, (R, T, K))
    tl0 = (state.tl0 + pid_inc)[:, :, None] & 0xFF
    tl0 = np.broadcast_to(tl0, (R, T, K))

    mtu_v = 1200 + rng.integers(-400, 200, (R, T, K))
    size_a = rng.integers(60, 120, (R, T, K))
    size = np.where(is_video[None, :, None], mtu_v, size_a)

    # Audio levels: a rotating "speaker" per room is loud (~20 dBov), the
    # rest are quiet (~70) — exercises the active-speaker top-k.
    speaker = (tick_index // 50) % max(1, used - nv) + nv if used > nv else 0
    loud = np.full((R, T, K), 70, np.int64)
    loud[:, speaker, :] = 20 + rng.integers(-5, 5)
    audio_level = np.where(is_video[None, :, None], 127, loud)

    arrival = (ts + rng.integers(0, 90, (R, T, K))) & 0xFFFFFFFF

    est0 = spec.estimate_bps or 1.25 * 1000.0 * (
        spec.video_tracks * spec.video_kbps + spec.audio_tracks * spec.audio_kbps
    )
    estimate = rng.normal(est0, est0 * 0.05, (R, S)).clip(1e5)

    def full(x, dtype):
        return np.broadcast_to(x, (R, T, K)).astype(dtype)

    # Last generated packet of each track's tick is the frame end (coarse
    # marker-bit model; exact per-frame markers come from the wire parser).
    end_frame = valid & ~np.roll(valid, -1, axis=-1)
    end_frame[..., -1] = valid[..., -1]

    inp = plane.TickInputs(
        sn=full(sn, np.int32),
        ts=full(ts, np.int32),
        layer=full(layer, np.int32),
        temporal=full(temporal, np.int32),
        keyframe=full(keyframe, bool),
        layer_sync=full(layer_sync, bool),
        begin_pic=full(begin_pic | ~is_video[None, :, None], bool),
        end_frame=full(end_frame, bool),
        pid=full(pid, np.int32),
        tl0=full(tl0, np.int32),
        keyidx=np.zeros((R, T, K), np.int32),
        size=full(size, np.int32),
        frame_ms=full(np.where(is_video[None, :, None], 0, 20), np.int32),
        audio_level=full(audio_level, np.int32),
        arrival_rtp=full(arrival, np.int32),
        ts_jump=np.full((R, T, K), 3000, np.int32),
        valid=full(valid, bool),
        estimate=estimate.astype(np.float32),
        estimate_valid=np.ones((R, S), bool),
        nacks=np.zeros((R, S), np.float32),
        pub_rtt_ms=np.full((R, T), 50.0, np.float32),
        fb_delay_ms=np.zeros((R, S), np.float32),
        fb_recv_bps=np.zeros((R, S), np.float32),
        fb_valid=np.zeros((R, S), bool),
        fb_enabled=np.zeros((R, S), bool),
        sub_reset=np.zeros((R, S), bool),
        pad_num=np.zeros((R, S), np.int32),
        pad_track=np.full((R, S), -1, np.int32),
        tick_ms=np.int32(spec.tick_ms),
        roll_quality=np.int32(0),
    )
    new_state = TrafficState(
        sn=new_sn, ts=new_ts, pid=(state.pid + pid_inc) & 0x7FFF,
        tl0=(state.tl0 + pid_inc) & 0xFF, frame_phase=phase,
    )
    return new_state, inp
