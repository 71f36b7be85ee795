"""Batched RED (RFC 2198) encode planning for Opus redundancy.

Reference parity: pkg/sfu/redreceiver.go, as formulated by the JAX
package's ops/red.py: per packet, the D previous valid packets that can
ride as redundancy blocks, their 14-bit TS offsets, lengths and whether
they fit the RFC 2198 fields. Byte assembly is host-side.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.ops import scanops

MAX_TS_OFFSET = (1 << 14) - 1
MAX_BLOCK_LEN = (1 << 10) - 1
RED_DISTANCE = 2


class REDState(NamedTuple):
    """Per-track history of the last RED_DISTANCE packets, [..., T, D]."""

    hist_sn: torch.Tensor   # int32 — SN of historical packet (-1 empty)
    hist_ts: torch.Tensor   # int32
    hist_len: torch.Tensor  # int32


def init_state(num_tracks: int, device="cuda") -> REDState:
    device = resolve(device)
    shape = (num_tracks, RED_DISTANCE)
    return REDState(
        hist_sn=torch.full(shape, -1, dtype=torch.int32, device=device),
        hist_ts=torch.zeros(shape, dtype=torch.int32, device=device),
        hist_len=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def encode_plan_tick(state: REDState, sn, ts, length, valid):
    """Per-packet RED plan for one tick; packets [..., T, K].

    Returns (state, red_sn [..., T, K, D], red_offset, red_len, red_ok).
    Candidate j of packet k is the (j+1)-th most recent valid packet
    before k: from this tick when the packet's exclusive valid-rank r
    covers it, else history slot j - r. Selected by rank-match masked
    sums (exact for int32)."""
    D = RED_DISTANCE
    dev = sn.device
    valid_i = valid.to(torch.int32)
    rank = scanops.cumsum_small(valid_i, axis=-1) - valid_i          # [..., T, K]
    js = torch.arange(D, dtype=torch.int32, device=dev)
    cand_rank = rank[..., None] - 1 - js                              # [..., T, K, D]
    from_tick = cand_rank >= 0
    tick_oh = valid[..., None, None, :] & (
        rank[..., None, None, :] == cand_rank[..., None]
    )                                                                 # [..., T, K, D, K']
    hist_oh = (-cand_rank - 1)[..., None] == js                       # [..., T, K, D, D']

    def pick(tick_arr, hist_arr):
        tick_v = torch.where(tick_oh, tick_arr[..., None, None, :], 0).sum(-1, dtype=torch.int32)
        hist_v = torch.where(hist_oh, hist_arr[..., None, None, :], 0).sum(-1, dtype=torch.int32)
        return torch.where(from_tick, tick_v, hist_v)

    c_sn = pick(sn, state.hist_sn)
    c_ts = pick(ts, state.hist_ts)
    c_len = pick(length, state.hist_len)
    off = ts[..., None] - c_ts
    r_ok = (
        (c_sn >= 0)
        & valid[..., None]
        & (off > 0)
        & (off <= MAX_TS_OFFSET)
        & (c_len <= MAX_BLOCK_LEN)
        & (((sn[..., None] - c_sn) & 0xFFFF) <= D)
    )

    # New history: the last D valid packets overall, most recent first.
    total = valid_i.sum(-1, keepdim=True, dtype=torch.int32)          # [..., T, 1]
    h_rank = total - 1 - js                                           # [..., T, D]
    h_from_tick = h_rank >= 0
    h_tick_oh = valid[..., None, :] & (rank[..., None, :] == h_rank[..., None])
    h_hist_oh = (-h_rank - 1)[..., None] == js

    def pick_hist(tick_arr, hist_arr):
        tick_v = torch.where(h_tick_oh, tick_arr[..., None, :], 0).sum(-1, dtype=torch.int32)
        hist_v = torch.where(h_hist_oh, hist_arr[..., None, :], 0).sum(-1, dtype=torch.int32)
        return torch.where(h_from_tick, tick_v, hist_v)

    new_state = REDState(
        hist_sn=pick_hist(sn, state.hist_sn),
        hist_ts=pick_hist(ts, state.hist_ts),
        hist_len=pick_hist(length, state.hist_len),
    )
    return new_state, c_sn, off, c_len, r_ok
