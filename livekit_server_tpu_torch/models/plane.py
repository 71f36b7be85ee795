"""The batched SFU media plane: one `media_plane_tick` advances every room,
track, packet and subscriber of a node by one tick.

Port of the JAX package's models/plane.py. The tick has the same three
phases:

  0. `selector.decide_rooms` — the whole forward decision, bit-packed
     (CUDA kernel csrc/decide_rooms.cu on the card);
  1. `_room_tick` — RTP stats, stream trackers, bitrate attribution,
     BWE, pacing, connection quality, RED planning and active speakers,
     written with the room axis R leading (the reference vmaps a
     per-room function);
  2. `allocation.allocate_budget_rooms` — layer allocation under each
     subscriber's budget, setting the next tick's selector targets
     (CUDA kernel csrc/budget_rooms.cu on the card).

Each block of the tick opens a host-clock span where it launches its ops
(utils/spans.py: plane.unpack, decide, rtpstats, streamtracker, bwe,
quality, red, audio, allocate, pack, with plane.tick around decide
through allocate), recorded only while a torch profiler records or the
thread's flight recorder is on.

The NamedTuples carry the reference's field names and order, so trees
line up leaf by leaf with the JAX package's, and `pack_tick_outputs`
writes the same flat int32 buffer layout `unpack_tick_outputs` reads.
The tick is functional: it returns a new PlaneState whose tensors the
caller rebinds (the old ones are freed to PyTorch's caching allocator,
which is the port's form of the reference's buffer donation). Control
uploads write into the state's meta/ctrl tensors in place.

Shape glossary: R rooms · T tracks/room · K packets/track/tick ·
S subscribers/room · L = MAX_LAYERS stats rows per track.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from livekit_server_tpu_torch.analysis.registry import device_entry
from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.ops import (
    allocation,
    audio,
    bwe,
    pacer,
    quality,
    red,
    rtpstats,
    scanops,
    selector,
    streamtracker,
)
from livekit_server_tpu_torch.ops.bits import mask_words, unpack_bits
from livekit_server_tpu_torch.utils import spans

MAX_LAYERS = 3
MAX_TEMPORAL = 4
SPEAKER_TOP_K = 3
SLAB_WINDOW = 64        # ticks of payload history the host retains for RTX
PAD_MAX = 8             # max probe-padding packets per subscriber per tick
TEMPORAL_FRACTIONS = (0.45, 0.65, 0.85, 1.0)


class PlaneDims(NamedTuple):
    rooms: int = 1
    tracks: int = 4        # per room
    pkts: int = 4          # per track per tick
    subs: int = 4          # per room


class TrackMeta(NamedTuple):
    """Host-written per-track control tensors, [R, T] bool."""

    is_video: torch.Tensor
    published: torch.Tensor
    pub_muted: torch.Tensor
    is_svc: torch.Tensor


class SubControl(NamedTuple):
    """Host-written per-(track, subscriber) control tensors, [R, T, S]."""

    subscribed: torch.Tensor    # bool
    sub_muted: torch.Tensor     # bool
    max_spatial: torch.Tensor   # int32
    max_temporal: torch.Tensor  # int32


class PlaneState(NamedTuple):
    """Full media-plane state, leading axis [R]."""

    meta: TrackMeta
    ctrl: SubControl
    stats: rtpstats.StreamStats          # [R, T*L]
    audio_state: audio.AudioLevelState   # [R, T]
    sel: selector.SelectorState          # [R, T, S]
    bwe_state: bwe.BWEState              # [R, S]
    delay_bwe: bwe.DelayBWEState         # [R, S]
    tracker: streamtracker.TrackerState  # [R, T*L]
    pacer_state: pacer.PacerState        # [R, S]
    red_state: red.REDState              # [R, T, D]
    temporal_bytes: torch.Tensor         # [R, T, L, MAX_TEMPORAL] float32


class TickInputs(NamedTuple):
    """Per-tick ingest tensors (host-packed; static shapes). Field
    meanings as in the reference's TickInputs."""

    # Packet fields, [R, T, K]:
    sn: torch.Tensor
    ts: torch.Tensor
    layer: torch.Tensor
    temporal: torch.Tensor
    keyframe: torch.Tensor
    layer_sync: torch.Tensor
    begin_pic: torch.Tensor
    end_frame: torch.Tensor
    pid: torch.Tensor
    tl0: torch.Tensor
    keyidx: torch.Tensor
    size: torch.Tensor
    frame_ms: torch.Tensor
    audio_level: torch.Tensor
    arrival_rtp: torch.Tensor
    ts_jump: torch.Tensor
    valid: torch.Tensor
    # Per-subscriber feedback, [R, S]:
    estimate: torch.Tensor
    estimate_valid: torch.Tensor
    nacks: torch.Tensor
    pub_rtt_ms: torch.Tensor   # [R, T] float32
    fb_delay_ms: torch.Tensor
    fb_recv_bps: torch.Tensor
    fb_valid: torch.Tensor
    fb_enabled: torch.Tensor
    sub_reset: torch.Tensor
    pad_num: torch.Tensor
    pad_track: torch.Tensor
    # Scalars (int32):
    tick_ms: torch.Tensor
    roll_quality: torch.Tensor


class TickOutputs(NamedTuple):
    """Egress + signal tensors pulled by the host after each tick; field
    order is the flat output buffer's order."""

    send_bits: torch.Tensor       # [R, T, K, W] int32
    drop_bits: torch.Tensor       # [R, T, K, W] int32
    switch_bits: torch.Tensor     # [R, T, K, W] int32
    need_keyframe: torch.Tensor   # [R, T, S] bool
    speaker_levels: torch.Tensor  # [R, SPEAKER_TOP_K] float32
    speaker_tracks: torch.Tensor  # [R, SPEAKER_TOP_K] int32
    congested: torch.Tensor       # [R, S] bool
    target_layers: torch.Tensor   # [R, S, T] int32
    fwd_packets: torch.Tensor     # [R] int32
    fwd_bytes: torch.Tensor       # [R] int32
    track_mos: torch.Tensor       # [R, T] float32
    track_quality: torch.Tensor   # [R, T] int32
    sub_quality: torch.Tensor     # [R, S] int32
    layer_live: torch.Tensor      # [R, T, L] int32
    layer_fps: torch.Tensor       # [R, T, L] float32
    track_loss_pct: torch.Tensor  # [R, T] float32
    track_jitter_ms: torch.Tensor  # [R, T] float32
    track_bps: torch.Tensor       # [R, T] float32
    committed_bps: torch.Tensor   # [R, S] float32
    pacer_allowed: torch.Tensor   # [R, S] float32
    deficient: torch.Tensor       # [R, S] bool
    red_sn: torch.Tensor          # [R, T, K, D] int32
    red_off: torch.Tensor         # [R, T, K, D] int32
    red_ok: torch.Tensor          # [R, T, K, D] bool


def _tile(x: torch.Tensor, *lead: int) -> torch.Tensor:
    return x.expand(*lead, *x.shape).clone()


@device_entry("plane.init_state")
def init_state(dims: PlaneDims, device="cuda") -> PlaneState:
    """Zeroed plane state (no track published) on `device`."""
    dev = resolve(device)
    R, T, K, S = dims
    L = MAX_LAYERS

    def tile(tree, *lead):
        return type(tree)(*[_tile(x, *lead) for x in tree])

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    b = torch.bool
    return PlaneState(
        meta=TrackMeta(z((R, T), b), z((R, T), b), z((R, T), b), z((R, T), b)),
        ctrl=SubControl(
            subscribed=z((R, T, S), b),
            sub_muted=z((R, T, S), b),
            max_spatial=torch.full((R, T, S), MAX_LAYERS - 1, dtype=torch.int32, device=dev),
            max_temporal=torch.full((R, T, S), 3, dtype=torch.int32, device=dev),
        ),
        stats=tile(rtpstats.init_state(T * L, device=dev), R),
        audio_state=tile(audio.init_state(T, device=dev), R),
        sel=tile(selector.init_state(S, device=dev), R, T),
        bwe_state=tile(bwe.init_state(S, device=dev), R),
        delay_bwe=tile(bwe.delay_init_state(S, device=dev), R),
        tracker=tile(streamtracker.init_state(T * L, device=dev), R),
        pacer_state=tile(pacer.init_state(S, device=dev), R),
        red_state=tile(red.init_state(T, device=dev), R),
        temporal_bytes=z((R, T, L, MAX_TEMPORAL), torch.float32),
    )


# ---------------------------------------------------------------------------
# Trees ↔ numpy leaves (the reference's jax.tree.flatten order: NamedTuple
# fields depth first), for carrying state and params across packages.
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Dotted field paths of a NamedTuple tree, in `tree_leaves` order
    (e.g. "pacer_state.tokens")."""
    if isinstance(tree, tuple):
        return [n for f, sub in zip(tree._fields, tree)
                for n in leaf_names(sub, f"{prefix}{f}.")]
    return [prefix[:-1]]


# Float leaves compared across backends (port vs reference, card vs CPU):
# (rtol, atol) in the leaf's own unit. Each float op may differ by an ulp
# (multiply-add contraction, powf/expf, reduction order) and the EMAs carry
# those ulps across ticks. Byte and bit-rate leaves (1e3..1e7) also go
# through the pacer bucket's cancellation (tokens - allowed), which leaves
# a few ulps of the operands as an absolute difference; every other float
# leaf (MOS, levels, fractions, ms, fps, counts) is held to 1e-6.
BYTE_LEAVES = frozenset({
    "track_bps", "committed_bps", "pacer_allowed", "temporal_bytes",
    "tokens", "queued", "rate_bps", "estimate_ring", "last_estimate",
    "committed_channel_capacity", "cycle_bytes", "bitrate_bps",
})
BYTE_TOLERANCE = (1e-5, 1e-2)
FLOAT_TOLERANCE = (1e-6, 1e-6)


def float_tolerance(name: str) -> tuple[float, float]:
    """(rtol, atol) for the float leaf at dotted path `name`."""
    return BYTE_TOLERANCE if name.rsplit(".", 1)[-1] in BYTE_LEAVES else FLOAT_TOLERANCE


def tree_map(fn, tree, *rest):
    """Apply fn leaf by leaf over NamedTuple trees of the same structure."""
    if isinstance(tree, tuple):
        return type(tree)(*[tree_map(fn, *subs) for subs in zip(tree, *rest)])
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """A tree shaped like `template` holding `leaves` in `tree_leaves`
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, tuple):
            return type(node)(*[build(sub) for sub in node])
        return next(it)

    return build(template)


def state_to_numpy(state: PlaneState) -> list[np.ndarray]:
    """PlaneState → flat list of numpy leaves in the reference's order
    (copies: never views of the state's tensors, which the runtime
    writes in place)."""
    return [x.detach().to("cpu", copy=True).numpy() for x in tree_leaves(state)]


def state_from_numpy(leaves, device="cuda") -> PlaneState:
    """Flat numpy leaves (e.g. `jax.tree.flatten` of the reference's
    PlaneState) → the port's PlaneState on `device`. Shapes come from the
    leaves; dtypes from the port's layout."""
    dev = resolve(device)
    leaves = [np.asarray(x) for x in leaves]
    R, T = leaves[0].shape
    S = leaves[4].shape[-1]
    template = init_state(PlaneDims(R, T, 1, S), device="cpu")
    spec = tree_leaves(template)
    if len(leaves) != len(spec):
        raise ValueError(f"{len(leaves)} leaves, PlaneState has {len(spec)}")
    tensors = []
    for i, (a, ref) in enumerate(zip(leaves, spec)):
        if a.shape != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {a.shape}, expected {tuple(ref.shape)}")
        tensors.append(torch.from_numpy(np.array(a)).to(ref.dtype).to(dev))
    return tree_unflatten(template, tensors)


def params_to_numpy(params: NamedTuple) -> list:
    """Params NamedTuple (AudioLevelParams, BWEParams, DelayBWEParams,
    PacerParams, TrackerParams) → its flat leaves (Python numbers)."""
    return list(params)


def params_from_numpy(cls, leaves):
    """Flat leaves → a params NamedTuple of class `cls`."""
    leaves = [np.asarray(x).item() for x in leaves]
    if len(leaves) != len(cls._fields):
        raise ValueError(f"{len(leaves)} leaves, {cls.__name__} has {len(cls._fields)}")
    return cls(*leaves)


# ---------------------------------------------------------------------------
# The tick.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _temporal_fractions(device: torch.device) -> torch.Tensor:
    """TEMPORAL_FRACTIONS on `device`, made once per device (a host→device
    copy inside the tick would stall the stream)."""
    return torch.tensor(TEMPORAL_FRACTIONS, dtype=torch.float32, device=device)


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


def _room_tick(state: PlaneState, inp: TickInputs, need_kf, pkts_sent_i,
               sent_bytes_i, audio_params, bwe_params, red_enabled: bool,
               routed_stats=None):
    """Phase-1 core over all rooms (R leading). Returns (state', partial
    outputs as a dict, bitrates [R, T, 4, 4] for phase 2).

    `routed_stats`, when given, is `route_stats`'s (st, tr) precomputed
    by the live-page kernel; the tick then skips its own routing."""
    R, T, K = inp.sn.shape
    S = state.ctrl.subscribed.shape[-1]
    L = MAX_LAYERS
    dev = inp.sn.device
    i32, f32 = torch.int32, torch.float32
    meta = state.meta

    # ---- 1. RTP stats per (track, layer) stream --------------------------
    t = spans.begin(spans.RTPSTATS)
    if routed_stats is None:
        routed_stats = route_stats(meta.is_svc, inp.layer, inp.sn, inp.ts, inp.size,
                                   inp.arrival_rtp, inp.valid, inp.begin_pic)
    st, tr_sums = routed_stats
    stats = rtpstats.update_tick(state.stats, st[:, 0], st[:, 1], st[:, 2], st[:, 3],
                                 st[:, 4] != 0)

    # ---- 2. per-layer liveness + measured [4][4] bitrate matrix ----------
    t = spans.lap(spans.RTPSTATS, t, spans.STREAMTRACKER)
    tracker, layer_status, _changed, tracker_bps, layer_fps = streamtracker.update_tick(
        state.tracker, streamtracker.TrackerParams(), tr_sums[:, 0], tr_sums[:, 1],
        inp.tick_ms, frames=tr_sums[:, 2],
    )
    layer_oh = torch.nn.functional.one_hot(
        inp.layer.clamp(0, L - 1).long(), L).to(f32)
    tm_oh = torch.nn.functional.one_hot(
        inp.temporal.clamp(0, MAX_TEMPORAL - 1).long(), MAX_TEMPORAL).to(f32)
    vbytes = torch.where(inp.valid, inp.size, 0).to(f32)
    # An elementwise product and a sum over K, not a matmul (which could
    # run in TF32): byte counts stay below 2^24, so the sum is exact.
    tick_bytes_lt = (vbytes[..., None, None] * layer_oh[..., :, None]
                     * tm_oh[..., None, :]).sum(2)                     # [R,T,L,4]
    temporal_bytes = state.temporal_bytes * 0.9 + tick_bytes_lt * 0.1
    tick_s = torch.clamp(inp.tick_ms.to(f32), min=1.0) / 1000.0
    boot_bps = temporal_bytes.sum(-1) * 8.0 / tick_s                   # [R,T,L]
    tracker_bps = tracker_bps.reshape(R, T, L)
    layer_bps = torch.where(~meta.is_svc[:, :, None] & (tracker_bps > 0),
                            tracker_bps, boot_bps)
    tot = temporal_bytes.sum(-1, keepdim=True)
    cum = scanops.cumsum_small(temporal_bytes, axis=-1)
    frac0 = _temporal_fractions(dev)
    frac = torch.where(tot > 0, cum / torch.clamp(tot, min=1e-6), frac0)
    bitrates = torch.zeros((R, T, 4, 4), dtype=f32, device=dev)
    bitrates[:, :, :L, :] = layer_bps[..., None] * frac
    # SVC onion: an SVC entry costs the cumulative sum over spatial layers.
    bitrates = torch.where(meta.is_svc[:, :, None, None],
                           scanops.cumsum_small(bitrates, axis=2), bitrates)
    bitrates = torch.where(meta.is_video[:, :, None, None], bitrates, 0.0)

    # ---- BWE per subscriber (this tick's actual send counts) -------------
    t = spans.lap(spans.STREAMTRACKER, t, spans.BWE)
    # Released slots reset their per-sub state first.
    def reset_rows(cur, init):
        m = inp.sub_reset
        return type(cur)(*[
            torch.where(m.reshape(m.shape + (1,) * (c.dim() - m.dim())), i, c)
            for c, i in zip(cur, init)
        ])

    bwe_prev = reset_rows(state.bwe_state, bwe.init_state(S, device=dev))
    delay_prev = reset_rows(state.delay_bwe, bwe.delay_init_state(S, device=dev))
    pacer_prev = reset_rows(state.pacer_state, pacer.init_state(S, device=dev))
    pkts_sent = pkts_sent_i.to(f32)
    bwe_state, congested, _trend, budget = bwe.update_tick(
        bwe_prev, bwe_params, inp.estimate, inp.estimate_valid, pkts_sent, inp.nacks,
    )
    # TWCC send-side estimate caps the budget where active.
    delay_bwe, delay_rate, delay_over, delay_active = bwe.delay_update_tick(
        delay_prev, bwe.DelayBWEParams(), inp.fb_delay_ms, inp.fb_recv_bps,
        inp.fb_valid, inp.fb_enabled, pkts_sent, inp.tick_ms,
    )
    budget = torch.where(delay_active, torch.minimum(budget, delay_rate), budget)
    congested = congested | delay_over

    # ---- leaky-bucket egress pacing --------------------------------------
    pacer_state, pacer_allowed, _backlog = pacer.update_tick(
        pacer_prev, pacer.PacerParams(), sent_bytes_i.to(f32), budget, inp.tick_ms,
    )

    # ---- connection quality (scorer.go E-model) --------------------------
    t = spans.lap(spans.BWE, t, spans.QUALITY)
    expected = rtpstats.expected_packets(stats)                        # [R,T*L]
    exp_d = torch.clamp(expected - stats.snap_expected, min=0).reshape(R, T, L)
    rcv_d = torch.clamp(stats.received - stats.snap_received, min=0).reshape(R, T, L)
    exp_t = exp_d.sum(-1, dtype=i32)
    rcv_t = rcv_d.sum(-1, dtype=i32)
    loss_pct = torch.where(
        exp_t > 0, 100.0 * (exp_t - rcv_t) / torch.clamp(exp_t, min=1), 0.0
    ).to(f32)
    jitter_rtp = (stats.jitter_q4 >> 4).reshape(R, T, L).amax(-1)
    clock_khz = torch.where(meta.is_video, 90.0, 48.0)
    jitter_ms = jitter_rtp.to(f32) / clock_khz
    has_pkts = (rcv_t > 0) & meta.published
    track_mos, track_q = quality.connection_quality(
        loss_pct, inp.pub_rtt_ms, jitter_ms, has_pkts
    )
    # A pub-muted track legitimately sends nothing: not LOST.
    track_mos = torch.where(meta.pub_muted, 5.0, track_mos)
    track_q = torch.where(meta.pub_muted, quality.QUALITY_EXCELLENT, track_q)
    track_q = torch.where(meta.published, track_q, quality.QUALITY_LOST)
    roll = inp.roll_quality > 0
    stats = stats._replace(
        snap_received=torch.where(roll, stats.received, stats.snap_received),
        snap_expected=torch.where(roll, expected, stats.snap_expected),
    )

    # ---- RED encapsulation plan (audio only) -----------------------------
    t = spans.lap(spans.QUALITY, t, spans.RED)
    is_audio_pkt = inp.valid & ~meta.is_video[:, :, None]
    if red_enabled:
        red_state, red_sn, red_off, _red_len, red_ok = red.encode_plan_tick(
            state.red_state, inp.sn, inp.ts, inp.size, is_audio_pkt,
        )
    else:
        red_state = state.red_state
        shape = (R, T, 0, red.RED_DISTANCE)
        red_sn = torch.zeros(shape, dtype=i32, device=dev)
        red_off = torch.zeros(shape, dtype=i32, device=dev)
        red_ok = torch.zeros(shape, dtype=torch.bool, device=dev)

    # ---- audio levels + active speakers ----------------------------------
    t = spans.lap(spans.RED, t, spans.AUDIO)
    audio_state, linear, is_active = audio.observe_tick(
        state.audio_state, audio_params,
        torch.where(is_audio_pkt, inp.audio_level, 127), inp.frame_ms,
        is_audio_pkt, inp.tick_ms,
    )
    k = min(SPEAKER_TOP_K, T)
    spk_levels, spk_tracks = audio.top_speakers(
        torch.where(is_active & meta.published, linear, 0.0), k
    )
    if k < SPEAKER_TOP_K:
        pad = SPEAKER_TOP_K - k
        spk_levels = torch.nn.functional.pad(spk_levels, (0, pad))
        spk_tracks = torch.nn.functional.pad(spk_tracks, (0, pad), value=-1)

    new_state = state._replace(
        stats=stats, audio_state=audio_state, bwe_state=bwe_state,
        delay_bwe=delay_bwe, tracker=tracker, pacer_state=pacer_state,
        red_state=red_state, temporal_bytes=temporal_bytes,
    )
    outputs = dict(
        need_keyframe=need_kf,
        speaker_levels=spk_levels,
        speaker_tracks=spk_tracks,
        congested=congested,
        track_mos=track_mos,
        track_quality=track_q.to(i32),
        layer_live=layer_status.reshape(R, T, L),
        layer_fps=layer_fps.reshape(R, T, L),
        track_loss_pct=loss_pct,
        track_jitter_ms=jitter_ms,
        track_bps=layer_bps.sum(-1),
        committed_bps=budget,
        pacer_allowed=pacer_allowed,
        red_sn=red_sn.to(i32),
        red_off=red_off.to(i32),
        red_ok=red_ok,
    )
    spans.end(spans.AUDIO, t)
    return new_state, outputs, bitrates


@device_entry("plane.media_plane_tick")
def media_plane_tick(state: PlaneState, inp: TickInputs,
                     audio_params: audio.AudioLevelParams = audio.AudioLevelParams(),
                     bwe_params: bwe.BWEParams = bwe.BWEParams(),
                     red_enabled: bool = True):
    """One tick of the full media plane over all rooms; returns
    (state', TickOutputs). Runs on the device of its tensors."""
    L = MAX_LAYERS
    meta, ctrl = state.meta, state.ctrl

    # ---- phase 0: forward decision over all rooms ------------------------
    t_tick = spans.begin(spans.TICK)
    t = spans.begin(spans.DECIDE)
    base = (ctrl.subscribed & ~ctrl.sub_muted
            & (meta.published & ~meta.pub_muted)[:, :, None])         # [R,T,S]
    (sel_state, send_bits, drop_bits, switch_bits, need_kf, pkts_sent,
     sent_bytes, fwd_packets, fwd_bytes) = selector.decide_rooms(
        state.sel, meta.is_svc, meta.is_video, base, inp.layer, inp.temporal,
        inp.keyframe, inp.layer_sync, inp.end_frame, inp.valid, inp.size,
        wire_overhead=pacer.WIRE_OVERHEAD_BYTES,
    )
    spans.end(spans.DECIDE, t)

    # ---- phase 1: per-room core, rooms batched ---------------------------
    new_state, outs, bitrates = _room_tick(
        state, inp, need_kf, pkts_sent, sent_bytes, audio_params, bwe_params,
        red_enabled,
    )

    # ---- phase 2: allocation over all rooms → next tick's targets --------
    t = spans.begin(spans.ALLOCATE)
    video_active = meta.is_video & meta.published & ~meta.pub_muted
    alloc_muted = ~(ctrl.subscribed & video_active[:, :, None] & ~ctrl.sub_muted)
    target_flat, _used, deficient = allocation.allocate_budget_rooms(
        bitrates,
        ctrl.max_spatial.transpose(1, 2).contiguous(),
        ctrl.max_temporal.transpose(1, 2).contiguous(),
        alloc_muted.transpose(1, 2).contiguous(),
        outs["committed_bps"],
    )                                                                  # [R,S,T]
    tgt_ts = target_flat.transpose(1, 2)                               # [R,T,S]
    sel_state = selector.set_target(
        sel_state,
        allocation.spatial_of(tgt_ts).clamp(-1, L - 1).contiguous(),
        allocation.temporal_of(tgt_ts).contiguous(),
    )
    any_deficient = deficient.any(-1)                                  # [R,S]
    sub_q = torch.where(
        outs["congested"], quality.QUALITY_POOR,
        torch.where(any_deficient, quality.QUALITY_GOOD, quality.QUALITY_EXCELLENT),
    ).to(torch.int32)
    outputs = TickOutputs(
        send_bits=send_bits, drop_bits=drop_bits, switch_bits=switch_bits,
        target_layers=target_flat, fwd_packets=fwd_packets, fwd_bytes=fwd_bytes,
        sub_quality=sub_q, deficient=any_deficient, **outs,
    )
    spans.end(spans.ALLOCATE, t)
    spans.end(spans.TICK, t_tick)
    return new_state._replace(sel=sel_state), outputs


# ---------------------------------------------------------------------------
# Wire packing: one upload + one fetch per tick.
# ---------------------------------------------------------------------------

# Fields uploaded to the device; the host-only fields (pid / tl0 / keyidx /
# ts_jump / pad_num / pad_track) feed the host munger and never cross.
PKT_FIELDS = (
    "sn", "ts", "layer", "temporal", "keyframe", "layer_sync", "begin_pic",
    "end_frame", "size", "frame_ms", "audio_level", "arrival_rtp", "valid",
)
_BOOL_FIELDS = {"keyframe", "layer_sync", "begin_pic", "end_frame", "valid"}
HOST_ONLY_PKT_FIELDS = ("pid", "tl0", "keyidx", "ts_jump")
FB_FIELDS = ("estimate", "estimate_valid", "nacks", "fb_delay_ms",
             "fb_recv_bps", "fb_valid", "fb_enabled", "sub_reset")


def pack_tick_inputs(inp: TickInputs):
    """Host-side: numpy TickInputs → (pkt [F,R,T,K] i32, fb [8,R,S] f32,
    tf [1,R,T] f32, tick_ms, roll_quality) — the reference's layout."""
    pkt = np.stack([np.asarray(getattr(inp, f)).astype(np.int32) for f in PKT_FIELDS])
    fb = np.stack([np.asarray(getattr(inp, f)).astype(np.float32) for f in FB_FIELDS])
    tf = np.asarray(inp.pub_rtt_ms, np.float32)[None]
    return pkt, fb, tf, np.int32(inp.tick_ms), np.int32(inp.roll_quality)


def wire_inputs(packed) -> np.ndarray:
    """The packed inputs as ONE flat int32 host buffer (floats as bit
    patterns), so the device step makes a single host→device copy."""
    pkt, fb, tf, tick_ms, roll = packed
    return np.concatenate([
        pkt.reshape(-1), fb.view(np.int32).reshape(-1),
        tf.view(np.int32).reshape(-1), np.asarray([tick_ms, roll], np.int32),
    ])


def unwire_inputs(buf: torch.Tensor, dims: PlaneDims):
    """Device-side inverse of `wire_inputs`: views into one int32 buffer."""
    R, T, K, S = dims
    n_pkt = len(PKT_FIELDS) * R * T * K
    n_fb = len(FB_FIELDS) * R * S
    pkt = buf[:n_pkt].view(len(PKT_FIELDS), R, T, K)
    fb = buf[n_pkt:n_pkt + n_fb].view(torch.float32).view(len(FB_FIELDS), R, S)
    tf = buf[n_pkt + n_fb:n_pkt + n_fb + R * T].view(torch.float32).view(1, R, T)
    scal = buf[n_pkt + n_fb + R * T:]
    return pkt, fb, tf, scal[0], scal[1]


def unpack_tick_inputs(pkt, fb, tf, tick_ms, roll_quality) -> TickInputs:
    """Device-side: stacked tensors → TickInputs. Host-only fields are
    zeros: the device tick never reads them."""
    t = spans.begin(spans.UNPACK)
    fields = {}
    for i, name in enumerate(PKT_FIELDS):
        x = pkt[i]
        fields[name] = x != 0 if name in _BOOL_FIELDS else x.contiguous()
    z_pkt = torch.zeros_like(pkt[0])
    for name in HOST_ONLY_PKT_FIELDS:
        fields[name] = z_pkt
    z_sub = torch.zeros(fb.shape[1:], dtype=torch.int32, device=fb.device)
    as_i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=pkt.device)  # noqa: E731
    inp = TickInputs(
        **fields,
        estimate=fb[0].contiguous(),
        estimate_valid=fb[1] > 0.5,
        nacks=fb[2].contiguous(),
        pub_rtt_ms=tf[0].contiguous(),
        fb_delay_ms=fb[3].contiguous(),
        fb_recv_bps=fb[4].contiguous(),
        fb_valid=fb[5] > 0.5,
        fb_enabled=fb[6] > 0.5,
        sub_reset=fb[7] > 0.5,
        pad_num=z_sub,
        pad_track=z_sub - 1,
        tick_ms=as_i32(tick_ms),
        roll_quality=as_i32(roll_quality),
    )
    spans.end(spans.UNPACK, t)
    return inp


def inputs_to_device(inp: TickInputs, device="cuda") -> TickInputs:
    """Numpy TickInputs (synth / ingest drain) → the device tick's
    TickInputs, through the same packing the runtime ships."""
    dev = resolve(device)
    packed = pack_tick_inputs(inp)
    buf = torch.from_numpy(wire_inputs(packed)).to(dev)
    return unpack_tick_inputs(*unwire_inputs(buf, _dims_of(inp)))


def _dims_of(inp: TickInputs) -> PlaneDims:
    R, T, K = np.shape(inp.sn)
    return PlaneDims(R, T, K, np.shape(inp.estimate)[-1])


def pack_ctrl_rows(meta: TrackMeta, ctrl: SubControl, rows):
    """Host-side half of the dirty-row control upload: gather the dirtied
    room rows of the (numpy) host mirrors into two stacked int32 arrays.
    Returns (rows [n] i32, meta_rows [4, n, T] i32, ctrl_rows
    [4, n, T, S] i32)."""
    rows = np.asarray(sorted(rows), np.int32)
    meta_rows = np.stack([np.asarray(m)[rows].astype(np.int32) for m in meta])
    ctrl_rows = np.stack([np.asarray(c)[rows].astype(np.int32) for c in ctrl])
    return rows, meta_rows, ctrl_rows


@device_entry("plane.apply_ctrl_delta")
def apply_ctrl_delta(state: PlaneState, rows, meta_rows, ctrl_rows) -> PlaneState:
    """Device-side half: write the dirtied rows into the state's control
    tensors IN PLACE (index_put on the existing tensors). Returns the
    same state for symmetry with the reference."""
    dev = state.meta.is_video.device
    idx = torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=dev)
    meta_rows = torch.as_tensor(np.asarray(meta_rows), device=dev)
    ctrl_rows = torch.as_tensor(np.asarray(ctrl_rows), device=dev)
    for i, leaf in enumerate(state.meta):
        leaf[idx] = meta_rows[i].to(leaf.dtype)
    for i, leaf in enumerate(state.ctrl):
        leaf[idx] = ctrl_rows[i].to(leaf.dtype)
    return state


def pack_tick_outputs(out: TickOutputs) -> torch.Tensor:
    """Device-side: TickOutputs → one flat int32 buffer; float32 leaves
    travel as bit patterns, bools as 0/1."""
    def flat(x):
        if x.dtype == torch.float32:
            x = x.contiguous().view(torch.int32)
        return x.to(torch.int32).reshape(-1)

    t = spans.begin(spans.PACK)
    buf = torch.cat([flat(x) for x in out])
    spans.end(spans.PACK, t)
    return buf


def unpack_tick_outputs(buf, dims: PlaneDims, red_enabled: bool = True) -> TickOutputs:
    """Host-side: flat int32 numpy buffer → TickOutputs of numpy arrays."""
    R, T, K, S = dims
    W = mask_words(S)
    Kr = K if red_enabled else 0
    shapes = {
        "send_bits": (R, T, K, W),
        "drop_bits": (R, T, K, W),
        "switch_bits": (R, T, K, W),
        "need_keyframe": (R, T, S),
        "speaker_levels": (R, SPEAKER_TOP_K),
        "speaker_tracks": (R, SPEAKER_TOP_K),
        "congested": (R, S),
        "target_layers": (R, S, T),
        "fwd_packets": (R,),
        "fwd_bytes": (R,),
        "track_mos": (R, T),
        "track_quality": (R, T),
        "sub_quality": (R, S),
        "layer_live": (R, T, MAX_LAYERS),
        "layer_fps": (R, T, MAX_LAYERS),
        "track_loss_pct": (R, T),
        "track_jitter_ms": (R, T),
        "track_bps": (R, T),
        "committed_bps": (R, S),
        "pacer_allowed": (R, S),
        "deficient": (R, S),
        "red_sn": (R, T, Kr, red.RED_DISTANCE),
        "red_off": (R, T, Kr, red.RED_DISTANCE),
        "red_ok": (R, T, Kr, red.RED_DISTANCE),
    }
    floats = {"speaker_levels", "track_mos", "track_loss_pct", "track_jitter_ms",
              "track_bps", "committed_bps", "pacer_allowed", "layer_fps"}
    bools = {"need_keyframe", "congested", "deficient", "red_ok"}
    buf = np.asarray(buf)
    pieces, off = {}, 0
    for name in TickOutputs._fields:
        n = int(np.prod(shapes[name]))
        x = buf[off:off + n].reshape(shapes[name])
        off += n
        if name in floats:
            x = x.view(np.float32)
        elif name in bools:
            x = x.astype(bool)
        pieces[name] = x
    return TickOutputs(**pieces)


def fetch_outputs(out: TickOutputs) -> np.ndarray:
    """The tick's one device→host round trip: the packed outputs as a flat
    int32 numpy buffer (the copy waits for the device)."""
    return pack_tick_outputs(out).cpu().numpy()


def device_step(state: PlaneState, wire: np.ndarray, dims: PlaneDims,
                audio_params: audio.AudioLevelParams = audio.AudioLevelParams(),
                bwe_params: bwe.BWEParams = bwe.BWEParams(),
                red_enabled: bool = True):
    """The dense runtime's device step: one host→device copy of the wired
    inputs, the tick, one device→host copy of the flat output buffer
    (which waits for the device). Returns (state', flat int32 numpy
    buffer)."""
    buf = torch.from_numpy(wire).to(state.meta.is_video.device)
    inp = unpack_tick_inputs(*unwire_inputs(buf, dims))
    state, out = media_plane_tick(state, inp, audio_params, bwe_params,
                                  red_enabled=red_enabled)
    return state, fetch_outputs(out)


def device_tick(state: PlaneState, wire: np.ndarray, dims: PlaneDims,
                audio_params: audio.AudioLevelParams = audio.AudioLevelParams(),
                bwe_params: bwe.BWEParams = bwe.BWEParams(),
                red_enabled: bool = True):
    """`device_step` and the unpack of its buffer: exactly what
    `PlaneRuntime._device_step` does per tick. Returns (state', numpy
    TickOutputs)."""
    state, flat = device_step(state, wire, dims, audio_params, bwe_params, red_enabled)
    return state, unpack_tick_outputs(flat, dims, red_enabled)


def masks_to_dense(out: TickOutputs, dims: PlaneDims):
    """Unpack the bit-packed egress masks to dense [R,T,K,S] bools."""
    S = dims.subs
    return (unpack_bits(out.send_bits, S), unpack_bits(out.drop_bits, S),
            unpack_bits(out.switch_bits, S))
