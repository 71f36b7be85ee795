"""Batched SVC layer selection: VP9 onion layering.

Reference parity: pkg/sfu/videolayerselector/vp9.go:43, as formulated by
the JAX package's ops/svc.py (its dependency-descriptor selector is not
on the dense tick's path and is not ported yet). State fields are
[..., S]; packet fields [..., K]; the packet axis is a Python loop (the
reference's scan), outputs [..., K, S].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from livekit_server_tpu_torch.device import resolve

INVALID = -1


class SVCSelectorState(NamedTuple):
    """Per-subscriber SVC selection state, fields [..., S] int32."""

    current_spatial: torch.Tensor
    current_temporal: torch.Tensor
    target_spatial: torch.Tensor
    target_temporal: torch.Tensor


def init_state(num_subscribers: int, target_spatial: int = 2,
               target_temporal: int = 3, device="cuda") -> SVCSelectorState:
    device = resolve(device)

    def full(v):
        return torch.full((num_subscribers,), v, dtype=torch.int32, device=device)

    return SVCSelectorState(full(INVALID), full(INVALID),
                            full(target_spatial), full(target_temporal))


def select_tick(state: SVCSelectorState, pkt_spatial, pkt_temporal,
                pkt_keyframe, pkt_switch_up, pkt_end_of_frame, pkt_valid):
    """VP9-style onion SVC selection: a subscriber needs every spatial
    layer <= current_spatial. Downswitch at end of frame, upswitch at a
    keyframe carrying the target layer.

    Returns (state, fwd [..., K, S], drop, up, need_keyframe [..., S])."""
    cur_sp, cur_tp = state.current_spatial, state.current_temporal
    tgt_sp, tgt_tp = state.target_spatial, state.target_temporal
    paused = tgt_sp < 0
    fwds, drps, ups = [], [], []
    for k in range(pkt_spatial.shape[-1]):
        sid = pkt_spatial[..., k, None]
        tid = pkt_temporal[..., k, None]
        kf = pkt_keyframe[..., k, None]
        sw_up = pkt_switch_up[..., k, None]
        eof = pkt_end_of_frame[..., k, None]
        valid = pkt_valid[..., k, None]

        up = valid & kf & (tgt_sp > cur_sp) & (sid <= tgt_sp)
        sp = torch.where(up, tgt_sp, cur_sp)
        down = valid & eof & (tgt_sp >= 0) & (tgt_sp < sp)
        sp_next = torch.where(down, tgt_sp, sp)
        on_stream = valid & (sp >= 0)
        tp = torch.where(up, tgt_tp, cur_tp)
        can_up = on_stream & sw_up & (tid <= tgt_tp) & (tid > tp)
        tp = torch.where(can_up, tid, tp)
        tp = torch.where(on_stream & (tgt_tp < tp), tgt_tp, tp)

        fwd = on_stream & (sid <= sp) & (tid <= tp) & ~paused
        fwds.append(fwd)
        drps.append(on_stream & ~fwd)
        ups.append(up)
        cur_sp = torch.where(paused, INVALID, sp_next)
        cur_tp = tp
    new_state = SVCSelectorState(cur_sp, cur_tp, tgt_sp, tgt_tp)
    need_keyframe = (tgt_sp >= 0) & (tgt_sp > cur_sp)
    stack = lambda xs: torch.stack(xs, dim=-2)  # noqa: E731
    return new_state, stack(fwds), stack(drps), stack(ups), need_keyframe
