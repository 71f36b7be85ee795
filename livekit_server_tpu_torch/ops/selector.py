"""Batched simulcast / temporal video-layer selection, and the phase-0
forward decision of the dense tick.

Reference parity: pkg/sfu/videolayerselector/simulcast.go:42 and the
temporal layer selector, as formulated by the JAX package's
ops/selector.py. State fields are [..., S] int32; INVALID_LAYER (-1)
means "not forwarding".

`decide_rooms` is the hand-written CUDA kernel csrc/decide_rooms.cu on
CUDA tensors; on CPU tensors it runs `decide_rooms_plain`, the algebra of
the reference's composed fallback (select both variants per room, merge
with the subscription base, pack the bits, sum the sends).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.ops import bits, cuda, svc

INVALID_LAYER = -1


class SelectorState(NamedTuple):
    """Per-(track, subscriber) selection state; fields are [..., S] int32."""

    current_spatial: torch.Tensor
    current_temporal: torch.Tensor
    target_spatial: torch.Tensor
    target_temporal: torch.Tensor


def init_state(num_subscribers: int, target_spatial: int = 2,
               target_temporal: int = 3, device="cuda") -> SelectorState:
    device = resolve(device)

    def full(v):
        return torch.full((num_subscribers,), v, dtype=torch.int32, device=device)

    return SelectorState(full(INVALID_LAYER), full(INVALID_LAYER),
                         full(target_spatial), full(target_temporal))


def select_tick(state: SelectorState, pkt_spatial, pkt_temporal, pkt_keyframe,
                pkt_layer_sync, pkt_valid):
    """One tick of simulcast layer selection. State [..., S], packets
    [..., K]. Returns (state, forward [..., K, S], drop, switch,
    need_keyframe [..., S]): spatial switches wait for a keyframe of the
    target layer, temporal upgrades for a layer-sync point, downgrades are
    immediate, and an invalid target pauses forwarding."""
    cur_sp, cur_tp = state.current_spatial, state.current_temporal
    tgt_sp, tgt_tp = state.target_spatial, state.target_temporal
    paused = tgt_sp < 0
    fwds, drps, sws = [], [], []
    for k in range(pkt_spatial.shape[-1]):
        sp = pkt_spatial[..., k, None]
        tp = pkt_temporal[..., k, None]
        kf = pkt_keyframe[..., k, None]
        sync = pkt_layer_sync[..., k, None]
        valid = pkt_valid[..., k, None]

        want = (tgt_sp != cur_sp) & (tgt_sp >= 0)
        sw = valid & kf & want & (sp == tgt_sp)
        c_sp = torch.where(sw, tgt_sp, cur_sp)
        c_tp = torch.where(sw, tgt_tp, cur_tp)
        on_cur = valid & (sp == c_sp) & (c_sp >= 0)
        can_up = on_cur & sync & (tp <= tgt_tp)
        c_tp = torch.where(can_up & (tp > c_tp), tp, c_tp)
        c_tp = torch.where(on_cur & (tgt_tp < c_tp), tgt_tp, c_tp)

        fwd = on_cur & (tp <= c_tp)
        drp = (on_cur & ~fwd) | (on_cur & paused)
        fwds.append(fwd & ~paused)
        drps.append(drp)
        sws.append(sw)
        cur_sp = torch.where(paused, INVALID_LAYER, c_sp)
        cur_tp = c_tp
    new_state = SelectorState(cur_sp, cur_tp, tgt_sp, tgt_tp)
    need_keyframe = (tgt_sp >= 0) & (tgt_sp != cur_sp)
    stack = lambda xs: torch.stack(xs, dim=-2)  # noqa: E731
    return new_state, stack(fwds), stack(drps), stack(sws), need_keyframe


def select_both_tick(state: SelectorState, is_svc, pkt_spatial, pkt_temporal,
                     pkt_keyframe, pkt_layer_sync, pkt_end_frame, pkt_valid):
    """Merged simulcast + SVC selection over shared state, picked per
    track by `is_svc` [..., T]; state [..., T, S], packets [..., T, K].
    Batches over rooms as written (the reference's `select_both_rooms` is
    this function under vmap).

    Returns (state', fwd [..., T, K, S] bool, drop, switch,
    need_kf [..., T, S])."""
    sel_state, v_fwd, v_drop, v_switch, nk_sim = select_tick(
        state, pkt_spatial, pkt_temporal, pkt_keyframe, pkt_layer_sync,
        pkt_valid,
    )
    svc_state, s_fwd, s_drop, _s_up, nk_svc = svc.select_tick(
        svc.SVCSelectorState(*state), pkt_spatial, pkt_temporal,
        pkt_keyframe, pkt_layer_sync, pkt_end_frame, pkt_valid,
    )
    m_s = is_svc[..., None]
    merged = SelectorState(*[
        torch.where(m_s, sv, sim) for sim, sv in zip(sel_state, svc_state)
    ])
    m = is_svc[..., None, None]
    fwd = torch.where(m, s_fwd, v_fwd)
    drop = torch.where(m, s_drop, v_drop)
    switch = ~m & v_switch
    need_kf = torch.where(m_s, nk_svc, nk_sim)
    return merged, fwd, drop, switch, need_kf


def set_target(state: SelectorState, target_spatial, target_temporal) -> SelectorState:
    """Apply allocator-decided target layers (reference Forwarder.SetTargetLayer)."""
    return state._replace(
        target_spatial=target_spatial.to(torch.int32),
        target_temporal=target_temporal.to(torch.int32),
    )


def decide_rooms_plain(state: SelectorState, is_svc, is_video, base,
                       pkt_spatial, pkt_temporal, pkt_keyframe, pkt_layer_sync,
                       pkt_end_frame, pkt_valid, pkt_size, wire_overhead: int):
    """Plain PyTorch version of the phase-0 kernel (the reference's
    fallback branch, selector.py:361-387). It forms the dense
    [R, T, K, S] masks the kernel never writes out. Arguments and results
    as in `decide_rooms`."""
    sel_state, v_fwd, v_drop, v_switch, nkf_sel = select_both_tick(
        state, is_svc, pkt_spatial, pkt_temporal, pkt_keyframe,
        pkt_layer_sync, pkt_end_frame, pkt_valid,
    )
    is_vid = is_video[:, :, None, None]
    base_b = base[:, :, None, :]
    a_fwd = pkt_valid[..., None] & base_b
    fwd = torch.where(is_vid, v_fwd & base_b, a_fwd)
    drop = is_vid & v_drop & base_b
    switch = is_vid & v_switch & base_b
    need_kf = nkf_sel & base & is_video[..., None]
    size_b = pkt_size[..., None]
    i32 = torch.int32
    pkts_sent = fwd.sum(dim=(1, 2), dtype=i32)
    sent_bytes = torch.where(fwd, size_b + wire_overhead, 0).sum(dim=(1, 2), dtype=i32)
    fwd_packets = fwd.sum(dim=(1, 2, 3), dtype=i32)
    fwd_bytes = torch.where(fwd, size_b, 0).sum(dim=(1, 2, 3), dtype=i32)
    return (sel_state, bits.pack_bits(fwd), bits.pack_bits(drop),
            bits.pack_bits(switch), need_kf, pkts_sent, sent_bytes,
            fwd_packets, fwd_bytes)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cuda.library("decide_rooms")
    fn = lib.decide_rooms_launch
    fn.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fits(T: int, K: int, S: int) -> bool:
    """Whether one room's tile of the kernel fits the card's shared memory."""
    fn = cuda.library("decide_rooms").decide_rooms_fits
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return bool(fn(T, K, S))


def decide_rooms(state: SelectorState, is_svc, is_video, base, pkt_spatial,
                 pkt_temporal, pkt_keyframe, pkt_layer_sync, pkt_end_frame,
                 pkt_valid, pkt_size, wire_overhead: int):
    """The full forward decision for ALL rooms: selection + base merge +
    audio path + bit packing + send sums.

    Args: state fields [R, T, S] int32; is_svc/is_video [R, T] bool;
    base [R, T, S] bool (subscribed & ~sub_muted & publisher live);
    packets [R, T, K] (spatial/temporal/size int32, flags bool).

    Returns (state', send_bits [R,T,K,W] i32, drop_bits, switch_bits,
    need_kf [R,T,S] bool (base-merged), pkts_sent [R,S] i32,
    sent_bytes [R,S] i32 (wire_overhead included), fwd_packets [R] i32,
    fwd_bytes [R] i32).

    CUDA tensors launch the kernel (and raise if it cannot run); CPU
    tensors take `decide_rooms_plain`."""
    device = state.current_spatial.device
    if device.type == "cpu":
        return decide_rooms_plain(
            state, is_svc, is_video, base, pkt_spatial, pkt_temporal,
            pkt_keyframe, pkt_layer_sync, pkt_end_frame, pkt_valid, pkt_size,
            wire_overhead,
        )
    if device.type != "cuda":
        raise ValueError(f"decide_rooms: unsupported device {device}")

    R, T, K = pkt_spatial.shape
    S = state.current_spatial.shape[-1]
    if min(R, T, K, S) < 1:
        raise ValueError(f"decide_rooms: empty shape R={R} T={T} K={K} S={S}")
    if not _fits(T, K, S):
        raise ValueError(f"decide_rooms: one room at T={T} K={K} S={S} exceeds the "
                         "kernel's shared memory")
    W = bits.mask_words(S)
    i32, b8 = torch.int32, torch.bool
    pkt = (pkt_spatial, pkt_temporal, pkt_keyframe, pkt_layer_sync,
           pkt_end_frame, pkt_valid, pkt_size)
    names = ("pkt_spatial", "pkt_temporal", "pkt_keyframe", "pkt_layer_sync",
             "pkt_end_frame", "pkt_valid", "pkt_size")
    for t, name, dt in zip(pkt, names, (i32, i32, b8, b8, b8, b8, i32)):
        cuda.require(t, name, dt, (R, T, K), device)
    for t, name in zip(state, SelectorState._fields):
        cuda.require(t, name, i32, (R, T, S), device)
    cuda.require(is_svc, "is_svc", b8, (R, T), device)
    cuda.require(is_video, "is_video", b8, (R, T), device)
    cuda.require(base, "base", b8, (R, T, S), device)

    empty = functools.partial(torch.empty, device=device)
    send = empty((R, T, K, W), dtype=i32)
    drop = empty((R, T, K, W), dtype=i32)
    switch = empty((R, T, K, W), dtype=i32)
    out_sp = empty((R, T, S), dtype=i32)
    out_tp = empty((R, T, S), dtype=i32)
    need_kf = empty((R, T, S), dtype=b8)
    pkts_sent = empty((R, S), dtype=i32)
    sent_bytes = empty((R, S), dtype=i32)
    fwd_packets = empty((R,), dtype=i32)
    fwd_bytes = empty((R,), dtype=i32)
    ptrs = [t.data_ptr() for t in (
        *pkt, *state, is_svc, is_video, base, send, drop, switch, out_sp,
        out_tp, need_kf, pkts_sent, sent_bytes, fwd_packets, fwd_bytes,
    )]
    err = _kernel()(*ptrs, R, T, K, S, int(wire_overhead),
                    cuda.stream_handle(device))
    cuda.check(err, "decide_rooms")
    cuda.launches["decide_rooms"] += 1
    new_state = SelectorState(out_sp, out_tp, state.target_spatial,
                              state.target_temporal)
    return (new_state, send, drop, switch, need_kf, pkts_sent, sent_bytes,
            fwd_packets, fwd_bytes)
