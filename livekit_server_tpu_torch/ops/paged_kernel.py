"""Phase 0 of the live-extent paged tick: one kernel step per LIVE page.

Port of the JAX package's ops/paged_kernel.py. The paged plane keeps a
pool of P pages, each a [TP, K, SP] block of one room's (track, packet,
subscriber) plane (models/paged.py). `live_rows [NL]` names the pool ids
of the mapped pages (padded to a pow2 bucket by repeating a live row);
every function here reads only those pages of its pooled operands and
writes compact [NL]-leading results, so dead pages cost nothing.

Each step fuses, for one live page:

  * the whole forward decision (ops/selector.py `decide_rooms` at page
    shape): simulcast + SVC selection, base merge, audio path, egress
    bit packing (SP <= 32, so one mask word per (track, packet)) and the
    per-subscriber / per-page send sums;
  * the phase-1 stats/tracker routing stacks (ops/rtpstats.py
    `route_stats`), handed to `_room_tick` as `routed_stats`;
  * optionally the page-local active-speaker mix (ops/mix.py `mix_tick`
    algebra): a top-K speaker gate, self-exclusion and a gain-weighted
    sum over the page's tracks.

On CUDA tensors the wrappers launch the hand-written kernel
csrc/paged_kernel.cu (persistent blocks over tiles of consecutive
entries of `live_rows`); on CPU tensors they run the plain versions
`decide_pages_plain` and `mix_pages_plain`, which gather the live rows
and apply the plain algebra. Any other device is refused; nothing falls
back, and a page geometry whose tile does not fit the card's shared
memory raises ValueError.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, NamedTuple

import torch

from livekit_server_tpu_torch.analysis.registry import device_entry
from livekit_server_tpu_torch.models import plane
from livekit_server_tpu_torch.ops import cuda, mix, rtpstats, selector

NUM_LAYERS = plane.MAX_LAYERS   # spatial routing lanes


class LiveDecide(NamedTuple):
    """Phase-0 products for the live pages only (leading axis [NL])."""

    sel: Any                    # selector.SelectorState, leaves [NL, TP, SP]
    send_bits: torch.Tensor     # [NL, TP, K, 1] int32
    drop_bits: torch.Tensor     # [NL, TP, K, 1] int32
    switch_bits: torch.Tensor   # [NL, TP, K, 1] int32
    need_kf: torch.Tensor       # [NL, TP, SP] bool
    pkts_sent: torch.Tensor     # [NL, SP] int32
    sent_bytes: torch.Tensor    # [NL, SP] int32 (wire overhead included)
    fwd_packets: torch.Tensor   # [NL] int32
    fwd_bytes: torch.Tensor     # [NL] int32
    st: torch.Tensor            # [NL, 5, TP*L, K] int32 (rtpstats.route_stats)
    tr: torch.Tensor            # [NL, 3, TP*L] int32


# Packet fields the decide reads, in the kernel's operand order.
_PKT_FIELDS = ("layer", "temporal", "keyframe", "layer_sync", "end_frame",
               "valid", "size", "sn", "ts", "arrival_rtp", "begin_pic")
_BOOL_PKT = {"keyframe", "layer_sync", "end_frame", "valid", "begin_pic"}


def _check_rows(live_rows, SP: int, name: str) -> None:
    if live_rows.dim() != 1 or live_rows.numel() == 0:
        raise ValueError(f"{name}: live_rows must be a non-empty [NL] vector")
    if SP > 32:
        raise ValueError(f"{name}: sub page must fit one mask word, got SP={SP}")


def decide_pages_plain(sel_state, is_svc, is_video, base, inp, live_rows, *,
                       wire_overhead: int) -> LiveDecide:
    """Plain PyTorch version of the decide half: the dense phase-0 algebra
    and the stats routing over the gathered live rows. Arguments and
    results as in `decide_pages`."""
    _check_rows(live_rows, base.shape[2], "decide_pages")
    idx = live_rows.long()
    pk = {f: getattr(inp, f)[idx] for f in _PKT_FIELDS}
    svc = is_svc[idx]
    sel_c = selector.SelectorState(*[x[idx] for x in sel_state])
    (sel_new, send, drop, switch, need_kf, pkts, byts, fp, fb) = selector.decide_rooms_plain(
        sel_c, svc, is_video[idx], base[idx], pk["layer"], pk["temporal"],
        pk["keyframe"], pk["layer_sync"], pk["end_frame"], pk["valid"], pk["size"],
        wire_overhead,
    )
    st, tr = rtpstats.route_stats(svc, pk["layer"], pk["sn"], pk["ts"], pk["size"],
                                  pk["arrival_rtp"], pk["valid"], pk["begin_pic"])
    return LiveDecide(sel_new, send, drop, switch, need_kf, pkts, byts, fp, fb, st, tr)


def mix_pages_plain(pcm, level, active, sub_track, gain, live_rows, *,
                    top_k: int = mix.MIX_TOP_K):
    """Plain PyTorch version of the mix half: `mix.mix_tick` over the
    gathered live rows. Arguments and result as in `mix_pages`."""
    _check_rows(live_rows, sub_track.shape[1], "mix_pages")
    idx = live_rows.long()
    return mix.mix_tick(pcm[idx], level[idx], active[idx], sub_track[idx], gain[idx],
                        top_k=top_k)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda.library("paged_kernel").paged_kernel_launch
    fn.argtypes = [ctypes.c_void_p] * 37 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fits(TP: int, K: int, SP: int, with_decide: bool, with_mix: bool) -> bool:
    """Whether one page's tile of the kernel fits the card's shared memory."""
    fn = cuda.library("paged_kernel").paged_kernel_fits
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return bool(fn(TP, K, SP, NUM_LAYERS, int(with_decide), int(with_mix)))


def _launch(live_rows, decide_ops, mix_ops, *, wire_overhead: int, top_k: int):
    """Check the operands, allocate the compact outputs and launch
    csrc/paged_kernel.cu once. `decide_ops` is (sel_state, is_svc,
    is_video, base, inp) or None; `mix_ops` is (pcm, level, active,
    sub_track, gain) or None. Returns (decide outputs or None, mixed or
    None)."""
    device = live_rows.device
    i32, b8, f32 = torch.int32, torch.bool, torch.float32
    NL = live_rows.shape[0]
    L = NUM_LAYERS
    cuda.require(live_rows, "live_rows", i32, (NL,), device)
    empty = functools.partial(torch.empty, device=device)
    P = TP = K = SP = N = 0
    d_in, m_in, d_out, mixed = [None] * 18, [None] * 5, [None] * 12, None
    if decide_ops is not None:
        sel_state, is_svc, is_video, base, inp = decide_ops
        P, TP, SP = base.shape
        K = inp.layer.shape[2]
        for t, name in zip(sel_state, selector.SelectorState._fields):
            cuda.require(t, name, i32, (P, TP, SP), device)
        cuda.require(is_svc, "is_svc", b8, (P, TP), device)
        cuda.require(is_video, "is_video", b8, (P, TP), device)
        cuda.require(base, "base", b8, (P, TP, SP), device)
        pkts = [getattr(inp, f) for f in _PKT_FIELDS]
        for t, f in zip(pkts, _PKT_FIELDS):
            cuda.require(t, f, b8 if f in _BOOL_PKT else i32, (P, TP, K), device)
        d_in = [*sel_state, is_svc, is_video, base, *pkts]
        d_out = [empty((NL, TP, K), dtype=i32), empty((NL, TP, K), dtype=i32),
                 empty((NL, TP, K), dtype=i32), empty((NL, TP, SP), dtype=i32),
                 empty((NL, TP, SP), dtype=i32), empty((NL, TP, SP), dtype=b8),
                 empty((NL, SP), dtype=i32), empty((NL, SP), dtype=i32),
                 empty((NL,), dtype=i32), empty((NL,), dtype=i32),
                 empty((NL, 5, TP * L, K), dtype=i32), empty((NL, 3, TP * L), dtype=i32)]
    if mix_ops is not None:
        pcm, level, active, sub_track, gain = mix_ops
        Pm, TPm, N = pcm.shape
        SPm = sub_track.shape[1]
        if decide_ops is not None and (Pm, TPm, SPm) != (P, TP, SP):
            raise ValueError(f"decide_mix_pages: mix pages {(Pm, TPm, SPm)} != "
                             f"decide pages {(P, TP, SP)}")
        P, TP, SP = Pm, TPm, SPm
        cuda.require(pcm, "pcm", f32, (P, TP, N), device)
        cuda.require(level, "level", f32, (P, TP), device)
        cuda.require(active, "active", b8, (P, TP), device)
        cuda.require(gain, "gain", f32, (P, TP), device)
        cuda.require(sub_track, "sub_track", i32, (P, SP), device)
        m_in = [pcm, level, active, gain, sub_track]
        mixed = empty((NL, SP, N), dtype=f32)
    if not _fits(TP, K, SP, decide_ops is not None, mix_ops is not None):
        raise ValueError(f"paged kernel: one page at TP={TP} K={K} SP={SP} exceeds the "
                         "kernel's shared memory")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    ptrs = [ptr(t) for t in (live_rows, *d_in, *m_in, *d_out, mixed)]
    err = _kernel()(*ptrs, NL, P, TP, K, SP, N, L, int(wire_overhead), int(top_k),
                    int(decide_ops is not None), int(mix_ops is not None),
                    cuda.stream_handle(device))
    cuda.check(err, "paged_kernel")
    cuda.count_launch("paged_kernel", (NL, P, TP, K, SP, N, decide_ops is not None,
                                       mix_ops is not None))
    return (d_out if decide_ops is not None else None), mixed


def _live_decide(res, sel_state, live_rows) -> LiveDecide:
    send, drop, switch, out_sp, out_tp, need_kf, pkts, byts, fp, fb, st, tr = res
    idx = live_rows.long()
    sel_new = selector.SelectorState(out_sp, out_tp, sel_state.target_spatial[idx],
                                     sel_state.target_temporal[idx])
    return LiveDecide(sel_new, send[..., None], drop[..., None], switch[..., None],
                      need_kf, pkts, byts, fp, fb, st, tr)


def _route(name: str, device: torch.device) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version
    (CPU tensors); any other device is refused."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return True


@device_entry("paged_kernel.decide_pages")
def decide_pages(sel_state, is_svc, is_video, base, inp, live_rows, *,
                 wire_overhead: int) -> LiveDecide:
    """Phase 0 of the live-extent tick for the pages named by `live_rows`.

    Args: sel_state leaves [P, TP, SP] int32; is_svc/is_video [P, TP]
    bool; base [P, TP, SP] bool (subscribed & ~sub_muted & publisher
    live); inp a plane.TickInputs at pooled shape (packet fields
    [P, TP, K]); live_rows [NL] int32 pool ids. Operands stay at pooled
    shape: only the live pages are read. Returns LiveDecide."""
    if not _route("decide_pages", base.device):
        return decide_pages_plain(sel_state, is_svc, is_video, base, inp, live_rows,
                                  wire_overhead=wire_overhead)
    _check_rows(live_rows, base.shape[2], "decide_pages")
    res, _ = _launch(live_rows, (sel_state, is_svc, is_video, base, inp), None,
                     wire_overhead=wire_overhead, top_k=0)
    return _live_decide(res, sel_state, live_rows)


def mix_pages(pcm, level, active, sub_track, gain, live_rows, *,
              top_k: int = mix.MIX_TOP_K):
    """Active-speaker mix of the live pages: [NL, SP, N] soft-clipped PCM.
    pcm [P, TP, N] float32, level/gain [P, TP] float32, active [P, TP]
    bool, sub_track [P, SP] int32. The speaker gate is page-local, which
    equals the room-level gate when a room's tracks fit one track page."""
    if not _route("mix_pages", pcm.device):
        return mix_pages_plain(pcm, level, active, sub_track, gain, live_rows, top_k=top_k)
    _check_rows(live_rows, sub_track.shape[1], "mix_pages")
    _, mixed = _launch(live_rows, None, (pcm, level, active, sub_track, gain),
                       wire_overhead=0, top_k=top_k)
    return torch.tanh(mixed)


def decide_mix_pages(sel_state, is_svc, is_video, base, inp,
                     pcm, level, active, sub_track, gain, live_rows, *,
                     wire_overhead: int, top_k: int = mix.MIX_TOP_K):
    """Decide and mix in one pass per live page (one kernel launch on the
    card). Returns (LiveDecide, mixed [NL, SP, N])."""
    if not _route("decide_mix_pages", base.device):
        return (decide_pages_plain(sel_state, is_svc, is_video, base, inp, live_rows,
                                   wire_overhead=wire_overhead),
                mix_pages_plain(pcm, level, active, sub_track, gain, live_rows,
                                top_k=top_k))
    _check_rows(live_rows, base.shape[2], "decide_mix_pages")
    res, mixed = _launch(live_rows, (sel_state, is_svc, is_video, base, inp),
                         (pcm, level, active, sub_track, gain),
                         wire_overhead=wire_overhead, top_k=top_k)
    return _live_decide(res, sel_state, live_rows), torch.tanh(mixed)
