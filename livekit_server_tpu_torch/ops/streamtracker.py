"""Batched per-layer stream liveness + bitrate + frame-rate tracking.

Reference parity: pkg/sfu/streamtracker (packet, frame and DD variants)
and buffer/fps.go, as formulated by the JAX package's
ops/streamtracker.py: one row per (track, layer) stream, updated every
tick with elementwise ops. A stream goes LIVE after `min_pkts` packets
or `min_frames` frame starts in a cycle, STOPPED after `stop_ms` of
silence; bitrate and fps are per-cycle EMAs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from livekit_server_tpu_torch.device import resolve

STOPPED = 0
LIVE = 1


class TrackerParams(NamedTuple):
    """config StreamTrackersConfig (config.go) equivalents."""

    cycle_ms: int = 500
    min_pkts: int = 5
    min_frames: int = 1
    stop_ms: int = 1000
    bitrate_alpha: float = 0.3
    fps_alpha: float = 0.3


class TrackerState(NamedTuple):
    """Per-stream rows [..., N] (N = tracks × layers)."""

    status: torch.Tensor        # int32 — STOPPED / LIVE
    cycle_pkts: torch.Tensor    # int32
    cycle_ms: torch.Tensor      # int32
    silent_ms: torch.Tensor     # int32
    cycle_bytes: torch.Tensor   # float32
    bitrate_bps: torch.Tensor   # float32
    cycle_frames: torch.Tensor  # int32
    fps: torch.Tensor           # float32


def init_state(num_streams: int, device="cuda") -> TrackerState:
    device = resolve(device)

    def z(dt):
        return torch.zeros((num_streams,), dtype=dt, device=device)

    i32, f32 = torch.int32, torch.float32
    return TrackerState(z(i32), z(i32), z(i32), z(i32), z(f32), z(f32), z(i32), z(f32))


def _ema_weights(alpha: float) -> tuple[float, float]:
    """(1 - a, a) rounded as the reference rounds them: a is a float32
    constant and 1 - a is formed in float32."""
    a = np.float32(alpha)
    return float(np.float32(1) - a), float(a)


def update_tick(state: TrackerState, params: TrackerParams, pkts, byts,
                tick_ms, frames=None):
    """Returns (state, status [..., N], changed [..., N] bool,
    bitrate_bps [..., N], fps [..., N]). `tick_ms` is an int32 scalar
    tensor."""
    if frames is None:
        frames = torch.zeros_like(pkts)
    got = pkts > 0
    silent_ms = torch.where(got, 0, state.silent_ms + tick_ms)
    cycle_pkts = state.cycle_pkts + pkts
    cycle_frames = state.cycle_frames + frames
    cycle_bytes = state.cycle_bytes + byts.to(torch.float32)
    cycle_ms = state.cycle_ms + tick_ms

    cycle_done = cycle_ms >= params.cycle_ms
    went_live = cycle_done & (
        (cycle_pkts >= params.min_pkts) | (cycle_frames >= params.min_frames)
    )
    went_dead = silent_ms >= params.stop_ms

    status = torch.where(went_live, LIVE, state.status)
    status = torch.where(went_dead, STOPPED, status)
    changed = status != state.status

    cycle_s = torch.clamp(cycle_ms.to(torch.float32), min=1.0) / 1000.0
    inst_bps = cycle_bytes * 8.0 / cycle_s
    keep, a = _ema_weights(params.bitrate_alpha)
    bitrate = torch.where(
        cycle_done,
        torch.where(state.bitrate_bps > 0, state.bitrate_bps * keep + inst_bps * a,
                    inst_bps),
        state.bitrate_bps,
    )
    bitrate = torch.where(status == STOPPED, 0.0, bitrate)
    inst_fps = cycle_frames.to(torch.float32) / cycle_s
    fkeep, fa = _ema_weights(params.fps_alpha)
    fps = torch.where(
        cycle_done,
        torch.where(state.fps > 0, state.fps * fkeep + inst_fps * fa, inst_fps),
        state.fps,
    )
    fps = torch.where(status == STOPPED, 0.0, fps)

    new_state = TrackerState(
        status=status,
        cycle_pkts=torch.where(cycle_done, 0, cycle_pkts),
        cycle_ms=torch.where(cycle_done, 0, cycle_ms),
        silent_ms=silent_ms,
        cycle_bytes=torch.where(cycle_done, 0.0, cycle_bytes),
        bitrate_bps=bitrate,
        cycle_frames=torch.where(cycle_done, 0, cycle_frames),
        fps=fps,
    )
    return new_state, status, changed, bitrate, fps
