"""Frozen into the benchmark (sfu_bench/reference/) from the port's
livekit_server_tpu_torch/ops/bwe.py: its plain PyTorch forms only, with the
imports rewritten, so that later changes to the port cannot move the
reference the benchmark judges it by.

Batched bandwidth estimation: loss/trend-based channel observation and
the send-side delay-based (TWCC) estimator.

Reference parity: pkg/sfu/streamallocator (ChannelObserver,
TrendDetector, NackTracker, the congestion state machine) and the
pion GCC seat fed by transport-wide-cc feedback, as formulated by the
JAX package's ops/bwe.py. One row per subscriber peer connection,
fields [..., S]; the estimate history is a fixed ring [..., S, W].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._device import resolve

WINDOW = 8  # estimate samples per trend window (trenddetector RequiredSamples)


class BWEParams(NamedTuple):
    """Mirrors config congestion-control tuning (config.go CongestionControlConfig)."""

    nack_ratio_threshold: float = 0.08
    nack_window_min_packets: int = 10
    estimate_required_downgrades: int = 3
    congested_min_estimate: float = 100_000.0
    stale_ticks: int = 50


class BWEState(NamedTuple):
    """Per-subscriber-PC state; fields are [..., S] (ring [..., S, W])."""

    estimate_ring: torch.Tensor
    ring_pos: torch.Tensor
    last_estimate: torch.Tensor
    nack_packets: torch.Tensor
    nack_count: torch.Tensor
    congested: torch.Tensor
    committed_channel_capacity: torch.Tensor
    ticks_since_sample: torch.Tensor


def init_state(num_subscribers: int, initial_estimate: float = 7_000_000.0,
               device="cuda") -> BWEState:
    device = resolve(device)
    s = (num_subscribers,)
    f32, i32 = torch.float32, torch.int32
    return BWEState(
        estimate_ring=torch.full(s + (WINDOW,), initial_estimate, dtype=f32, device=device),
        ring_pos=torch.zeros(s, dtype=i32, device=device),
        last_estimate=torch.full(s, initial_estimate, dtype=f32, device=device),
        nack_packets=torch.zeros(s, dtype=f32, device=device),
        nack_count=torch.zeros(s, dtype=f32, device=device),
        congested=torch.zeros(s, dtype=torch.bool, device=device),
        committed_channel_capacity=torch.full(s, initial_estimate, dtype=f32, device=device),
        ticks_since_sample=torch.zeros(s, dtype=i32, device=device),
    )


def _trend_weights(device) -> torch.Tensor:
    """Centered linear-regression slope weights over the window."""
    x = torch.arange(WINDOW, dtype=torch.float32, device=device)
    xc = x - x.mean()
    return xc / (xc * xc).sum()


def update_tick(state: BWEState, params: BWEParams, estimate, estimate_valid,
                pkts_sent, nacks):
    """One BWE tick over all subscribers. Returns (state, congested [..., S]
    bool, trend [..., S] int32, available_capacity [..., S] float32)."""
    pos = state.ring_pos % WINDOW
    slot = torch.arange(WINDOW, device=pos.device)
    write = estimate_valid[..., None] & (slot == pos[..., None])
    ring = torch.where(write, estimate[..., None], state.estimate_ring)
    ring_pos = torch.where(estimate_valid, state.ring_pos + 1, state.ring_pos)
    last_estimate = torch.where(estimate_valid, estimate, state.last_estimate)

    # Slope of the time-ordered ring: the weights rotate, not the data.
    ranks = (slot - pos[..., None] - 1) % WINDOW
    w_rot = _trend_weights(pos.device)[ranks]
    slope = (ring * w_rot).sum(-1)
    mean = ring.mean(-1)
    rel_slope = slope / torch.clamp(mean, min=1.0)
    trend = torch.where(rel_slope < -0.02, -1,
                        torch.where(rel_slope > 0.02, 1, 0)).to(torch.int32)

    nack_packets = state.nack_packets + pkts_sent
    nack_count = state.nack_count + nacks
    ratio = nack_count / torch.clamp(nack_packets, min=1.0)
    nack_bad = (nack_packets >= params.nack_window_min_packets) & (
        ratio > params.nack_ratio_threshold
    )

    # A downtrend only counts while samples are fresh.
    ticks_since = torch.where(estimate_valid, 0, state.ticks_since_sample + 1)
    congested = ((trend < 0) & (ticks_since < params.stale_ticks)) | nack_bad
    committed = torch.where(
        congested,
        torch.clamp(
            torch.minimum(state.committed_channel_capacity, last_estimate),
            min=params.congested_min_estimate,
        ),
        last_estimate,
    )
    new_state = BWEState(
        estimate_ring=ring,
        ring_pos=ring_pos,
        last_estimate=last_estimate,
        nack_packets=nack_packets * 0.5,
        nack_count=nack_count * 0.5,
        congested=congested,
        committed_channel_capacity=committed,
        ticks_since_sample=ticks_since,
    )
    return new_state, congested, trend, committed


class DelayBWEParams(NamedTuple):
    overuse_ms: float = 1.5
    underuse_ms: float = -1.5
    ema_alpha: float = 0.3
    beta: float = 0.85
    increase_per_s: float = 0.08
    min_rate_bps: float = 64_000.0
    max_rate_bps: float = 50e6
    fb_timeout_ticks: int = 50
    starve_decay: float = 0.97


class DelayBWEState(NamedTuple):
    """Per-subscriber delay-estimator state; fields [..., S]."""

    slope_ema: torch.Tensor    # float32
    rate_bps: torch.Tensor     # float32
    ticks_no_fb: torch.Tensor  # int32
    ever_fb: torch.Tensor      # bool


def delay_init_state(num_subscribers: int, initial_rate: float = 7_000_000.0,
                     device="cuda") -> DelayBWEState:
    device = resolve(device)
    s = (num_subscribers,)
    return DelayBWEState(
        slope_ema=torch.zeros(s, dtype=torch.float32, device=device),
        rate_bps=torch.full(s, initial_rate, dtype=torch.float32, device=device),
        ticks_no_fb=torch.zeros(s, dtype=torch.int32, device=device),
        ever_fb=torch.zeros(s, dtype=torch.bool, device=device),
    )


def delay_update_tick(state: DelayBWEState, params: DelayBWEParams,
                      fb_delay_ms, fb_recv_bps, fb_valid, fb_enabled,
                      pkts_sent, tick_ms):
    """Returns (state, rate_bps [..., S], overuse [..., S] bool,
    active [..., S] bool); `tick_ms` is an int32 scalar tensor."""
    ema = torch.where(
        fb_valid,
        (1.0 - params.ema_alpha) * state.slope_ema + params.ema_alpha * fb_delay_ms,
        state.slope_ema,
    )
    overuse = ema > params.overuse_ms
    underuse = ema < params.underuse_ms
    tick_s = torch.clamp(tick_ms.to(torch.float32), min=1.0) / 1000.0
    rate_up = state.rate_bps * (1.0 + params.increase_per_s * tick_s)
    rate_down = params.beta * torch.clamp(fb_recv_bps, min=params.min_rate_bps)
    rate = torch.where(
        fb_valid,
        torch.where(overuse, torch.minimum(state.rate_bps, rate_down),
                    torch.where(underuse, state.rate_bps, rate_up)),
        state.rate_bps,
    )
    ticks_no_fb = torch.where(
        fb_valid | ~fb_enabled, 0, state.ticks_no_fb + (pkts_sent > 0).to(torch.int32)
    )
    starved = ticks_no_fb > params.fb_timeout_ticks
    rate = torch.where(starved, rate * params.starve_decay, rate)
    rate = torch.clamp(rate, params.min_rate_bps, params.max_rate_bps)
    ever_fb = state.ever_fb | (fb_valid & fb_enabled)
    active = fb_enabled & (ever_fb | starved)
    new_state = DelayBWEState(slope_ema=ema, rate_bps=rate, ticks_no_fb=ticks_no_fb,
                              ever_fb=ever_fb)
    return new_state, rate, overuse & fb_enabled, active
