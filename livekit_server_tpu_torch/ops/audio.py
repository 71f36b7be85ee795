"""Batched RFC 6464 audio-level / active-speaker detection.

Reference parity: pkg/sfu/audio/audiolevel.go:36-134 and the room
active-speaker loop (pkg/rtc/room.go:1278-1316), as formulated by the
JAX package's ops/audio.py. Levels are dBov in [0, 127]; smaller is
louder and 127 is digital silence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from livekit_server_tpu_torch.device import resolve

SILENT_LEVEL = 127.0


class AudioLevelParams(NamedTuple):
    """Mirrors config audio params (pkg/config/config.go AudioConfig)."""

    active_level: int = 35
    min_percentile: int = 40
    observe_interval_ms: int = 500
    smooth_intervals: int = 2


class AudioLevelState(NamedTuple):
    """Per-track accumulators + smoothed level; fields are [..., T]."""

    smoothed_level: torch.Tensor  # float32 dBov
    window_min: torch.Tensor      # float32 — loudest level this window
    active_ms: torch.Tensor       # int32
    window_ms: torch.Tensor       # int32


def init_state(num_tracks: int, device="cuda") -> AudioLevelState:
    device = resolve(device)

    def full(v, dt):
        return torch.full((num_tracks,), v, dtype=dt, device=device)

    return AudioLevelState(
        smoothed_level=full(SILENT_LEVEL, torch.float32),
        window_min=full(SILENT_LEVEL, torch.float32),
        active_ms=full(0, torch.int32),
        window_ms=full(0, torch.int32),
    )


def observe_tick(state: AudioLevelState, params: AudioLevelParams, levels,
                 frame_ms, valid, tick_ms):
    """Accumulate one tick of observations ([..., T, P]) and finalize the
    windows that elapsed. Returns (state, linear_level [..., T] float32,
    is_active [..., T] bool)."""
    lv = levels.to(torch.float32)
    dur = torch.where(valid, frame_ms, 0)
    active = valid & (lv <= float(params.active_level))

    window_min = torch.minimum(
        state.window_min, torch.where(active, lv, SILENT_LEVEL).amin(-1)
    )
    active_ms = state.active_ms + torch.where(active, dur, 0).sum(-1, dtype=torch.int32)
    window_ms = state.window_ms + tick_ms

    done = window_ms >= params.observe_interval_ms
    min_active = params.observe_interval_ms * params.min_percentile // 100
    was_active = done & (active_ms >= min_active)
    obs = torch.where(was_active, window_min, SILENT_LEVEL)

    alpha = 1.0 / max(float(params.smooth_intervals), 1.0)
    ema = state.smoothed_level + (obs - state.smoothed_level) * alpha
    # Seed directly on the first active window after silence.
    was_silent = state.smoothed_level >= 126.5
    smoothed = torch.where(
        done, torch.where(was_silent & was_active, obs, ema), state.smoothed_level
    )
    new_state = AudioLevelState(
        smoothed_level=smoothed,
        window_min=torch.where(done, SILENT_LEVEL, window_min),
        active_ms=torch.where(done, 0, active_ms),
        window_ms=torch.where(done, 0, window_ms),
    )
    linear = level_to_linear(smoothed)
    is_active = smoothed < float(params.active_level)
    return new_state, linear, is_active


def level_to_linear(dbov: torch.Tensor) -> torch.Tensor:
    """10^(-dBov/20), with digital silence mapped to 0 (ConvertAudioLevel)."""
    lin = torch.pow(10.0, -dbov.to(torch.float32) / 20.0)
    return torch.where(dbov >= 126.5, 0.0, lin)


def top_speakers(linear_levels: torch.Tensor, k: int):
    """Top-K speakers along the last (track) axis (GetActiveSpeakers).

    Ties keep the lower track index first, as `jax.lax.top_k` does: a
    stable descending sort, not `torch.topk`, whose tie order is not
    specified. Inactive tracks all tie at 0.0 on most ticks, so the rule
    decides `speaker_tracks`. Returns (levels [..., k], indices [..., k]
    int32)."""
    levels, idx = torch.sort(linear_levels, dim=-1, descending=True, stable=True)
    return levels[..., :k], idx[..., :k].to(torch.int32)
