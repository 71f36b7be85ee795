"""Batched per-stream RTP statistics.

Reference parity: pkg/sfu/buffer rtpstats_*.go (extended SN/TS tracking,
loss accounting, RFC 3550 interarrival jitter, receiver-report
snapshots), as formulated by the JAX package's ops/rtpstats.py. One row
per stream, fields [..., N]; the packet axis K is a Python loop.

The dense tick's routing of packets into stream rows and the fold over K
run as one launch of the hand-written CUDA kernel csrc/rtpstats_rooms.cu
on CUDA tensors (`route_update_tick`); CPU tensors take the plain
`route_update_tick_plain` (`route_stats`, then `update_tick`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.ops import cuda, seqnum

MAX_LAYERS = 3    # spatial layers: stats rows a track (models/plane.py)


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


def route_stats(is_svc, layer, sn, ts, size, arrival_rtp, valid, begin_pic):
    """Sections 1–2 routing of the phase-1 core: each packet's RTP-stats
    fields one-hot routed into per-(track, layer) rows, and the tracker's
    per-(track, layer) sums. Returns (st [R, 5, T*L, K] int32 — sn, ts,
    size, arrival, valid — and tr [R, 3, T*L] int32 — packets, bytes,
    frame starts).

    Simulcast layers are separate RTP streams (one stats row each); an
    SVC track's packets all fold into row 0. Routing is a one-hot select,
    k preserved, so rows never collide. Tracker rows route by each
    packet's TRUE spatial layer. The live-page kernel
    (ops/paged_kernel.py) computes the same two stacks."""
    R, T, K = sn.shape
    L = MAX_LAYERS
    i32 = torch.int32
    lanes = torch.arange(L, dtype=i32, device=sn.device)
    eff_layer = torch.where(is_svc[:, :, None], 0, layer.clamp(0, L - 1))
    st_vals = torch.stack([sn, ts, size, arrival_rtp, valid.to(i32)], dim=1)  # [R,5,T,K]
    st = torch.where((eff_layer[..., None] == lanes)[:, None], st_vals[..., None], 0)
    st = st.permute(0, 1, 2, 4, 3).reshape(R, 5, T * L, K)
    t_lane = layer.clamp(0, L - 1)[..., None] == lanes                  # [R,T,K,L]
    ones_k = torch.ones_like(size)
    tr_vals = torch.stack([ones_k, size, ones_k], dim=1)                # [R,3,T,K]
    tr_pred = torch.stack([valid, valid, valid & begin_pic], dim=1)
    routed = torch.where(t_lane[:, None] & tr_pred[..., None], tr_vals[..., None], 0)
    return st, routed.sum(3, dtype=i32).reshape(R, 3, T * L)


def route_update_tick_plain(state: StreamStats, is_svc, layer, sn, ts, size, arrival_rtp,
                            valid, begin_pic) -> tuple[StreamStats, torch.Tensor]:
    """Plain PyTorch version of the RTP-stats kernel: `route_stats`, then
    `update_tick` over its stats stack. Arguments and results as in
    `route_update_tick`."""
    st, tr = route_stats(is_svc, layer, sn, ts, size, arrival_rtp, valid, begin_pic)
    return update_tick(state, st[:, 0], st[:, 1], st[:, 2], st[:, 3], st[:, 4] != 0), tr


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda.library("rtpstats_rooms").rtpstats_rooms_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr_array(tensors):
    """The tensors' device pointers as a C array of void*."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def route_update_tick(state: StreamStats, is_svc, layer, sn, ts, size, arrival_rtp,
                      valid, begin_pic) -> tuple[StreamStats, torch.Tensor]:
    """The dense tick's RTP-stats block: the stats routing and the fold over
    K of every (room, track)'s packets. Returns (state', tr [R, 3, T*L]
    int32 — the tracker's packets, bytes and frame starts of valid
    packets).

    Args: state fields [R, T*L] (L = MAX_LAYERS, rows t*L + l); is_svc
    [R, T] bool; packets [R, T, K] (layer/sn/ts/size/arrival_rtp int32,
    valid/begin_pic bool), in arrival order along K.

    Every device checks the operands' dtypes and shapes (CUDA also their
    device and layout); CUDA tensors launch csrc/rtpstats_rooms.cu (and
    raise if it cannot run), CPU tensors take `route_update_tick_plain`,
    and any other device raises."""
    device = sn.device
    R, T, K = sn.shape
    N = T * MAX_LAYERS
    i32, b8 = torch.int32, torch.bool
    pkt = (sn, ts, size, arrival_rtp, layer, valid, begin_pic)
    operands = [
        *zip(pkt, ("sn", "ts", "size", "arrival_rtp", "layer", "valid", "begin_pic"),
             (i32,) * 5 + (b8,) * 2, [(R, T, K)] * 7),
        (is_svc, "is_svc", b8, (R, T)),
        *[(x, name, b8 if name == "started" else i32, (R, N))
          for x, name in zip(state[:10], StreamStats._fields)],
    ]
    for x, name, dt, shape in operands:
        if device.type == "cuda":
            cuda.require(x, name, dt, shape, device)
        elif x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"route_update_tick: {name} is {x.dtype} {tuple(x.shape)}, "
                             f"expected {dt} {shape}")
    if device.type == "cpu":
        return route_update_tick_plain(state, is_svc, layer, sn, ts, size, arrival_rtp,
                                       valid, begin_pic)
    if device.type != "cuda":
        raise ValueError(f"route_update_tick: unsupported device {device}")
    if min(R, T, K) < 1:
        raise ValueError(f"route_update_tick: empty shape R={R} T={T} K={K}")

    new = [torch.empty((R, N), dtype=x.dtype, device=device) for x in state[:10]]
    tr = torch.empty((R, 3, N), dtype=i32, device=device)
    err = _kernel()(*[t.data_ptr() for t in pkt], is_svc.data_ptr(), _ptr_array(state[:10]),
                    _ptr_array(new), tr.data_ptr(), R, T, K, cuda.stream_handle(device))
    cuda.check(err, "rtpstats_rooms")
    cuda.count_launch("rtpstats_rooms", (R, T, K))
    return StreamStats(*new, state.snap_received, state.snap_expected), tr


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
