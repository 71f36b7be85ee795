"""Frozen into the benchmark (sfu_bench/reference/) from the port's
livekit_server_tpu_torch/ops/svc.py: its plain PyTorch forms only, with the
imports rewritten, so that later changes to the port cannot move the
reference the benchmark judges it by.

Batched SVC layer selection: VP9 onion layering + dependency descriptor.

Reference parity: pkg/sfu/videolayerselector/vp9.go:43 and
dependencydescriptor.go:65-430, as formulated by the JAX package's
ops/svc.py. `select_tick` is on the dense tick's path; the
dependency-descriptor selector (`dd_select_tick`) is a golden scan no
runtime path calls (the host's DD handling is held to it). State fields
are [..., S]; packet fields [..., K]; the packet axis is a Python loop
(the reference's scan), outputs [..., K, S].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._device import resolve

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


class DDSelectorState(NamedTuple):
    """Dependency-descriptor selection state, fields [..., S] int32."""

    active_dt: torch.Tensor   # current decode target index (-1 = none)
    target_dt: torch.Tensor   # allocator-desired decode target
    last_frame: torch.Tensor  # last forwarded frame number (chain check)


def init_dd_state(num_subscribers: int, target_dt: int = 0,
                  device="cuda") -> DDSelectorState:
    device = resolve(device)

    def full(v):
        return torch.full((num_subscribers,), v, dtype=torch.int32, device=device)

    return DDSelectorState(full(INVALID), full(target_dt), full(INVALID))


def _bit(mask, d):
    """Bit d of mask, False where d < 0."""
    return (((mask >> d.clamp(min=0)) & 1) != 0) & (d >= 0)


def dd_select_tick(state: DDSelectorState, pkt_dti_mask, pkt_switch_mask,
                   pkt_frame, pkt_keyframe, pkt_valid):
    """Decode-target selection (dependencydescriptor.go Select): switch
    to the target at a switch indication (or keyframe), forward packets
    present for the active decode target. `broken` [..., S] flags a
    frame-number gap on the forwarded chain (the host answers with a PLI).

    Returns (state, forward [..., K, S], drop, broken)."""
    active, target, last = state.active_dt, state.target_dt, state.last_frame
    paused = target < 0
    fwds, drps, gaps = [], [], []
    for k in range(pkt_dti_mask.shape[-1]):
        dti = pkt_dti_mask[..., k, None]
        sw_mask = pkt_switch_mask[..., k, None]
        frame = pkt_frame[..., k, None]
        kf = pkt_keyframe[..., k, None]
        valid = pkt_valid[..., k, None]

        want = (target != active) & (target >= 0)
        can_switch = valid & want & (_bit(sw_mask, target) | kf)
        active = torch.where(can_switch, target, active)
        fwd = valid & _bit(dti, active) & ~paused
        drp = valid & ~fwd & (active >= 0)
        gap = fwd & (last >= 0) & (frame - last > 1) & ~kf
        last = torch.where(fwd, frame, last)
        last = torch.where(kf & valid, frame, last)
        active = torch.where(paused, INVALID, active)
        fwds.append(fwd)
        drps.append(drp)
        gaps.append(gap)
    stack = lambda xs: torch.stack(xs, dim=-2)  # noqa: E731
    broken = stack(gaps).any(dim=-2)
    return DDSelectorState(active, target, last), stack(fwds), stack(drps), broken


def set_target(state, target):
    """Apply an allocator decision (decode target) to a DD state."""
    if isinstance(state, DDSelectorState):
        return state._replace(target_dt=torch.as_tensor(
            target, dtype=torch.int32, device=state.target_dt.device
        ).expand_as(state.target_dt).clone())
    raise TypeError("use svc.SVCSelectorState._replace for spatial/temporal targets")
