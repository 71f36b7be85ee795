"""Batched per-stream RTP statistics.

Reference parity: pkg/sfu/buffer rtpstats_*.go (extended SN/TS tracking,
loss accounting, RFC 3550 interarrival jitter, receiver-report
snapshots), as formulated by the JAX package's ops/rtpstats.py. One row
per stream, fields [..., N]; the packet axis K is a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.ops import seqnum


class StreamStats(NamedTuple):
    """Per-stream receiver stats; fields are [..., N]."""

    started: torch.Tensor       # bool
    first_sn: torch.Tensor      # int32 — 16-bit SN of first packet
    highest_sn: torch.Tensor    # int32 — 16-bit highest SN seen
    sn_cycles: torch.Tensor     # int32 — SN wrap count
    highest_ts: torch.Tensor    # int32 — 32-bit highest TS seen
    received: torch.Tensor      # int32
    bytes: torch.Tensor         # int32
    dups: torch.Tensor          # int32
    jitter_q4: torch.Tensor     # int32 — RFC3550 jitter in RTP units << 4
    last_transit: torch.Tensor  # int32 — last (arrival_rtp - pkt_ts)
    snap_received: torch.Tensor
    snap_expected: torch.Tensor


def init_state(num_streams: int, device="cuda") -> StreamStats:
    device = resolve(device)

    def z():
        return torch.zeros((num_streams,), dtype=torch.int32, device=device)

    return StreamStats(
        started=torch.zeros((num_streams,), dtype=torch.bool, device=device),
        first_sn=z(), highest_sn=z(), sn_cycles=z(), highest_ts=z(),
        received=z(), bytes=z(), dups=z(), jitter_q4=z(), last_transit=z(),
        snap_received=z(), snap_expected=z(),
    )


def expected_packets(s: StreamStats) -> torch.Tensor:
    """Cumulative expected packet count = ext_highest - first + 1."""
    ext_hi = s.sn_cycles * 65536 + s.highest_sn
    return torch.where(s.started, ext_hi - s.first_sn + 1, 0)


def cumulative_lost(s: StreamStats) -> torch.Tensor:
    return torch.clamp(expected_packets(s) - s.received, min=0)


def update_tick(state: StreamStats, pkt_sn, pkt_ts, pkt_size, arrival_rtp,
                valid) -> StreamStats:
    """Fold one tick of received packets ([..., N, K], arrival order) into
    per-stream stats."""
    c = state
    for k in range(pkt_sn.shape[-1]):
        sn, ts, size = pkt_sn[..., k], pkt_ts[..., k], pkt_size[..., k]
        arr, v = arrival_rtp[..., k], valid[..., k]
        fresh = v & ~c.started
        first_sn = torch.where(fresh, sn, c.first_sn)
        hi0 = torch.where(fresh, sn, c.highest_sn)

        d = seqnum.diff16(sn, hi0)
        newer = v & (d > 0)
        dup = v & ~fresh & (d <= 0)
        wrapped = newer & (sn < hi0)
        highest_ts = torch.where(
            (v & (seqnum.diff32(ts, c.highest_ts) > 0)) | fresh, ts, c.highest_ts
        )
        # RFC 3550 jitter: J += (|D| - J) / 16 in RTP units (stored <<4);
        # `//` floors like the reference's jnp floor division.
        transit = seqnum.sub32(arr, ts)
        dtr = torch.abs(seqnum.diff32(transit, c.last_transit))
        upd = v & ~fresh
        jitter_q4 = torch.where(
            upd, c.jitter_q4 + ((dtr << 4) - c.jitter_q4) // 16, c.jitter_q4
        )
        c = StreamStats(
            started=c.started | v,
            first_sn=first_sn,
            highest_sn=torch.where(newer | fresh, sn, hi0),
            sn_cycles=torch.where(wrapped, c.sn_cycles + 1, c.sn_cycles),
            highest_ts=highest_ts,
            received=c.received + v.to(torch.int32),
            bytes=c.bytes + torch.where(v, size, 0),
            dups=c.dups + dup.to(torch.int32),
            jitter_q4=jitter_q4,
            last_transit=torch.where(v, transit, c.last_transit),
            snap_received=c.snap_received,
            snap_expected=c.snap_expected,
        )
    return c


def receiver_report(state: StreamStats):
    """Receiver-report fields since the last snapshot, and roll the
    snapshot (rtpstats_receiver.go SnapshotRcvrReport)."""
    expected = expected_packets(state)
    exp_delta = torch.clamp(expected - state.snap_expected, min=0)
    rcv_delta = torch.clamp(state.received - state.snap_received, min=0)
    lost_delta = torch.clamp(exp_delta - rcv_delta, min=0)
    fraction_q8 = torch.where(
        exp_delta > 0, (lost_delta << 8) // torch.clamp(exp_delta, min=1), 0
    )
    report = {
        "fraction_lost_q8": fraction_q8,
        "cumulative_lost": cumulative_lost(state),
        "ext_highest_sn": state.sn_cycles * 65536 + state.highest_sn,
        "jitter_rtp": state.jitter_q4 >> 4,
    }
    new_state = state._replace(snap_received=state.received, snap_expected=expected)
    return new_state, report
