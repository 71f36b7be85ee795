"""Frozen into the benchmark (sfu_bench/reference/) from the port's
livekit_server_tpu_torch/ops/quality.py: its plain PyTorch forms only, with the
imports rewritten, so that later changes to the port cannot move the
reference the benchmark judges it by.

Batched connection-quality scoring (simplified E-model).

Reference parity: pkg/sfu/connectionquality/scorer.go:45-120, as
formulated by the JAX package's ops/quality.py: R-factor from loss, RTT
and jitter, MOS mapping, quality enum. Quality values: 0 POOR, 1 GOOD,
2 EXCELLENT, 3 LOST.
"""

from __future__ import annotations

import torch

QUALITY_POOR = 0
QUALITY_GOOD = 1
QUALITY_EXCELLENT = 2
QUALITY_LOST = 3


def r_factor(loss_pct, rtt_ms, jitter_ms, is_deficient=None):
    """Transmission rating factor R (float32 tensors)."""
    loss, rtt, jitter = loss_pct, rtt_ms, jitter_ms
    d = rtt / 2.0 + jitter * 2.0 + 20.0
    id_ = 0.024 * d + 0.11 * (d - 177.3) * (d > 177.3)
    ie_eff = 0.0 + (95.0 - 0.0) * loss / (loss + 25.0)
    r = 94.2 - id_ - ie_eff
    if is_deficient is not None:
        r = r - torch.where(is_deficient, 10.0, 0.0)
    return torch.clamp(r, 0.0, 100.0)


def mos(r):
    """R → mean-opinion-score (ITU G.107 mapping used by scorer.go)."""
    m = 1.0 + 0.035 * r + 7.1e-6 * r * (r - 60.0) * (100.0 - r)
    return torch.clamp(m, 1.0, 5.0)


def score_to_quality(score, has_packets):
    """MOS → ConnectionQuality enum; no packets in window ⇒ LOST."""
    q = torch.where(
        score >= 4.1, QUALITY_EXCELLENT,
        torch.where(score >= 3.5, QUALITY_GOOD, QUALITY_POOR),
    ).to(torch.int32)
    return torch.where(has_packets, q, QUALITY_LOST)


def connection_quality(loss_pct, rtt_ms, jitter_ms, has_packets, is_deficient=None):
    """Impairments → R → MOS → quality enum. Elementwise."""
    m = mos(r_factor(loss_pct, rtt_ms, jitter_ms, is_deficient))
    return m, score_to_quality(m, has_packets)


def aggregate_min(quality, mask, axis=-1):
    """Worst-of aggregation (participant = min over its tracks), masked;
    LOST dominates only if everything is LOST."""
    masked = torch.where(
        mask, torch.where(quality == QUALITY_LOST, QUALITY_POOR, quality),
        QUALITY_EXCELLENT,
    )
    worst = masked.amin(axis)
    all_lost = torch.where(mask, quality == QUALITY_LOST, True).all(axis) & mask.any(axis)
    return torch.where(all_lost, QUALITY_LOST, worst)
