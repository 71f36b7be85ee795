"""Frozen into the benchmark (sfu_bench/reference/) from the port's
livekit_server_tpu_torch/ops/pacer.py: its plain PyTorch forms only, with the
imports rewritten, so that later changes to the port cannot move the
reference the benchmark judges it by.

Batched egress pacing: per-subscriber leaky bucket.

Reference parity: pkg/sfu/pacer leaky_bucket.go:47-200, as formulated by
the JAX package's ops/pacer.py: every subscriber's bucket updates in one
elementwise pass per tick; the host egress sends `allowed` bytes of its
queue per subscriber.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._device import resolve

# Per-packet wire overhead beyond the RTP payload bytes: sealed frame
# header (14) + AES-GCM tag (16) + RTP header (12).
WIRE_OVERHEAD_BYTES = 42


class PacerParams(NamedTuple):
    burst_ms: int = 100
    min_rate_bps: float = 64_000.0


class PacerState(NamedTuple):
    """Per-subscriber buckets, fields [..., S] float32."""

    tokens: torch.Tensor
    rate_bps: torch.Tensor
    queued: torch.Tensor


def init_state(num_subscribers: int, initial_rate: float = 7_000_000.0,
               device="cuda") -> PacerState:
    device = resolve(device)
    s = (num_subscribers,)
    return PacerState(
        tokens=torch.zeros(s, dtype=torch.float32, device=device),
        rate_bps=torch.full(s, initial_rate, dtype=torch.float32, device=device),
        queued=torch.zeros(s, dtype=torch.float32, device=device),
    )


def update_tick(state: PacerState, params: PacerParams, enqueued_bytes,
                rate_bps, tick_ms):
    """Returns (state, allowed_bytes [..., S], backlog_bytes [..., S]);
    `tick_ms` is an int32 scalar tensor."""
    rate = torch.clamp(rate_bps, min=params.min_rate_bps)
    dt_s = torch.clamp(tick_ms.to(torch.float32), min=1.0) / 1000.0
    cap = rate * (params.burst_ms / 1000.0) / 8.0
    tokens = torch.minimum(state.tokens + rate * dt_s / 8.0, cap)
    queued = state.queued + enqueued_bytes
    allowed = torch.minimum(queued, tokens)
    new_state = PacerState(tokens=tokens - allowed, rate_bps=rate,
                           queued=queued - allowed)
    return new_state, allowed, queued - allowed
