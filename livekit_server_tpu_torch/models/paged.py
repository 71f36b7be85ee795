"""Paged media plane: the dense tick re-based onto pooled device pages.

Port of the JAX package's models/paged.py. The dense plane is
`[R, T, K, S]`: every room pays the configured worst case. Here the
device state is ONE pool of P fixed-shape PAGES, each a `[tpage, K,
spage]` block of some room's (track × subscriber) plane, plus a device
page table the tick indirects through (runtime/pager.py owns the host
allocator and the canonical table mirrors). A 2-person room holds one
page; a 50-person room holds its full grid.

A page is a small dense room, so the pooled tick IS the dense tick at
dims `[P, TP, K, SP]`. Two couplings cross pages, both row gathers
through `tmembers` (the page ids of one room's sub column across its
track pages):

  1. per-subscriber send totals (BWE/pacer input), summed over the
     room's track pages — disjoint (track, pkt) blocks, so the int sums
     are exact;
  2. phase-2 cross-track allocation: each page gathers its room's FULL
     track axis (`MT·TP == T` entries, missing rows filled with the
     dense init values) so the budget algebra sees the dense operands,
     then keeps its own-tp slice of the targets.

Cross-page consistency — DUPLICATE EVERYWHERE, READ FROM ONE: the host
stages a track's packets into every sp-page of its track group and a
sub's feedback into every tp-page of its sub group, so per-track state
computes identically in all sp-duplicates (read back from sp == 0) and
per-sub state in all tp-duplicates (read back from tp == 0). Free pages
get zero inputs and init ctrl, hence no sends, and the stock tick PINS
their state to its pre-tick values, so a free page always holds pristine
init state. That invariant lets the live-extent tick
(`paged_plane_tick_live`, phase 0 in ops/paged_kernel.py) skip dead
pages entirely: their state needs no writes and their outputs are one
shared constant (`dead_page_outputs`).

Also here: the page-table delta lane (table rows, page re-init, row
moves) and the host-side pooled ↔ logical translation (`LayoutXlate`).
Every PlaneState leaf is one of three kinds — "track" `[R, T·m, …]`,
"sub" `[R, S, …]`, "track_sub" `[R, T, S, …]` — and each kind is an
index-arithmetic reshape + fancy index against the page table.

Device-side updates of the table and of the state's rows happen in place
(index_put on the existing tensors), like the dense plane's control
uploads; the live tick writes its live rows into the state in place.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from livekit_server_tpu_torch.analysis.registry import device_entry
from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.models import plane
from livekit_server_tpu_torch.models.plane import (
    MAX_LAYERS,
    SPEAKER_TOP_K,
    PlaneDims,
    PlaneState,
    TickInputs,
    TickOutputs,
)
from livekit_server_tpu_torch.ops import (
    allocation, audio, bwe, pacer, paged_kernel, quality, selector,
)
from livekit_server_tpu_torch.ops.bits import mask_words


class PagedDims(NamedTuple):
    """Logical plane dims + the page geometry over them.

    `tpage`/`spage` divide `tracks`/`subs` (pow2, spage | 32 so a sub page
    never straddles a bit-mask word): the logical plane is exactly an
    MT × MS grid of page-shaped tiles."""

    rooms: int
    tracks: int
    pkts: int
    subs: int
    tpage: int
    spage: int
    pool_pages: int

    @property
    def max_tpages(self) -> int:
        return self.tracks // self.tpage

    @property
    def max_spages(self) -> int:
        return self.subs // self.spage

    @property
    def logical(self) -> PlaneDims:
        return PlaneDims(self.rooms, self.tracks, self.pkts, self.subs)

    def pooled(self) -> PlaneDims:
        """The pool as PlaneDims: pages are the batch axis, a page is a
        [tpage, K, spage] room."""
        return PlaneDims(self.pool_pages, self.tpage, self.pkts, self.spage)


class PageTable(NamedTuple):
    """Device page table (the pager holds the canonical host copy). The
    tick indirects through the inverse maps; `rooms_pages` is the
    room → pages view for host walks."""

    rooms_pages: torch.Tensor  # [R, MT*MS] int32 — room's grid, -1 empty
    tmembers: torch.Tensor     # [P, MT] int32 — same-(room, sp) pages by tp
    pg_room: torch.Tensor      # [P] int32 — owning room (-1 free)
    pg_tp: torch.Tensor        # [P] int32 — track-page index within room
    pg_sp: torch.Tensor        # [P] int32 — sub-page index within room


def init_table(dims: PagedDims, device="cuda") -> PageTable:
    dev = resolve(device)
    P = dims.pool_pages

    def full(shape):
        return torch.full(shape, -1, dtype=torch.int32, device=dev)

    return PageTable(
        rooms_pages=full((dims.rooms, dims.max_tpages * dims.max_spages)),
        tmembers=full((P, dims.max_tpages)),
        pg_room=full((P,)), pg_tp=full((P,)), pg_sp=full((P,)),
    )


# ---------------------------------------------------------------------------
# The ticks
# ---------------------------------------------------------------------------


def _base(state: PlaneState):
    meta, ctrl = state.meta, state.ctrl
    return ctrl.subscribed & ~ctrl.sub_muted & (meta.published & ~meta.pub_muted)[:, :, None]


def _gsum(x, mem, mvalid):
    """Cross-page coupling #1: per-sub send totals over the room's track
    pages. x [N, SP] int32, mem/mvalid [N, MT] → [N, SP]."""
    return torch.where(mvalid[:, :, None], x[mem], 0).sum(1, dtype=torch.int32)


def _allocate(state: PlaneState, sel_state, outs: dict, bitrates, mem, mvalid, pg_tp):
    """Phase 2 with the room's FULL track axis (cross-page coupling #2):
    each page gathers its room's MT·TP track entries through `mem`; rows
    the room never allocated get the dense-init fill values, so the
    budget operands equal the dense plane's. Returns (selector state with
    the next tick's targets, the allocation-derived TickOutputs fields)."""
    L = MAX_LAYERS
    N, MT = mem.shape
    TP = state.meta.is_video.shape[1]
    SP = state.ctrl.subscribed.shape[2]
    meta, ctrl = state.meta, state.ctrl

    def gtrack(x, fill):  # [N, TP, ...] → [N, MT, TP, ...]
        g = x[mem]
        return torch.where(mvalid.reshape((N, MT) + (1,) * (g.dim() - 2)), g, fill)

    def to_st(x):  # [N, MT, TP, SP] → [N, SP, MT*TP]
        return x.permute(0, 3, 1, 2).reshape(N, SP, MT * TP)

    bit_g = gtrack(bitrates, 0.0).reshape(N, MT * TP, 4, 4)
    sub_g = to_st(gtrack(ctrl.subscribed, False))
    mut_g = to_st(gtrack(ctrl.sub_muted, False))
    msp_g = to_st(gtrack(ctrl.max_spatial, L - 1))
    mtp_g = to_st(gtrack(ctrl.max_temporal, 3))
    video_active = meta.is_video & meta.published & ~meta.pub_muted
    va_g = gtrack(video_active, False).reshape(N, MT * TP)
    alloc_muted = ~(sub_g & va_g[:, None, :] & ~mut_g)                 # [N, SP, MT*TP]
    target_full, _used, deficient = allocation.allocate_budget_rooms(
        *(x.contiguous() for x in (bit_g, msp_g, mtp_g, alloc_muted, outs["committed_bps"])))
    # Keep only this page's own tracks: every (tp, sp) block is computed
    # by exactly one page.
    own_tp = pg_tp.clamp(0, MT - 1).long()
    tgt4 = target_full.reshape(N, SP, MT, TP)
    tgt_own = torch.take_along_dim(tgt4, own_tp[:, None, None, None], dim=2)[:, :, 0, :]
    tgt_ts = tgt_own.transpose(1, 2)                                    # [N, TP, SP]
    sel_state = selector.set_target(
        sel_state,
        allocation.spatial_of(tgt_ts).clamp(-1, L - 1).contiguous(),
        allocation.temporal_of(tgt_ts).contiguous(),
    )
    any_deficient = deficient.any(-1)                                  # [N, SP]
    sub_q = torch.where(
        outs["congested"], quality.QUALITY_POOR,
        torch.where(any_deficient, quality.QUALITY_GOOD, quality.QUALITY_EXCELLENT),
    ).to(torch.int32)
    return sel_state, dict(target_layers=tgt_own.contiguous(), deficient=any_deficient,
                           sub_quality=sub_q)


@device_entry("paged.paged_plane_tick")
def paged_plane_tick(state: PlaneState, inp: TickInputs, table: PageTable,
                     audio_params: audio.AudioLevelParams = audio.AudioLevelParams(),
                     bwe_params: bwe.BWEParams = bwe.BWEParams(),
                     red_enabled: bool = True):
    """The stock pooled tick: the three dense phases over every page of
    the pool, with the two cross-page couplings gathered through
    `tmembers`. State/inputs at `dims.pooled()`. Returns (state',
    TickOutputs) at pool shape; unmapped pages keep their pre-tick state."""
    P = table.tmembers.shape[0]
    mem = table.tmembers.clamp(0, P - 1).long()
    mvalid = table.tmembers >= 0

    # ---- phase 0: forward decision, pages batched -------------------------
    (sel_state, send_bits, drop_bits, switch_bits, need_kf, pkts_sent, sent_bytes,
     fwd_packets, fwd_bytes) = selector.decide_rooms(
        state.sel, state.meta.is_svc, state.meta.is_video, _base(state),
        inp.layer, inp.temporal, inp.keyframe, inp.layer_sync, inp.end_frame,
        inp.valid, inp.size, wire_overhead=pacer.WIRE_OVERHEAD_BYTES,
    )
    # ---- phase 1: per-page core --------------------------------------------
    new_state, outs, bitrates = plane._room_tick(
        state, inp, need_kf, _gsum(pkts_sent, mem, mvalid),
        _gsum(sent_bytes, mem, mvalid), audio_params, bwe_params, red_enabled,
    )
    # ---- phase 2: allocation with the room's full track axis ---------------
    sel_state, alloc_outs = _allocate(state, sel_state, outs, bitrates, mem, mvalid,
                                      table.pg_tp)
    outputs = TickOutputs(send_bits=send_bits, drop_bits=drop_bits,
                          switch_bits=switch_bits, fwd_packets=fwd_packets,
                          fwd_bytes=fwd_bytes, **alloc_outs, **outs)
    # Freeze unmapped pages: zero inputs alone do NOT make a free page a
    # fixed point (pacer tokens, BWE sample age and tracker windows all
    # advance per tick), so pin dead rows to their pre-tick values. This
    # makes "a free page holds pristine init state" a property of the
    # tick, and it is what the live-extent path relies on.
    live = table.pg_room >= 0

    def freeze(n, o):
        return torch.where(live.reshape((P,) + (1,) * (n.dim() - 1)), n, o)

    return plane.tree_map(freeze, new_state._replace(sel=sel_state), state), outputs


def _zero_inputs(dims: PlaneDims, tick_ms: int, roll_quality: int, device) -> TickInputs:
    """TickInputs of a tick that carries no packets and no feedback."""
    R, T, K, S = dims
    dev = resolve(device)
    pkt = torch.zeros((len(plane.PKT_FIELDS), R, T, K), dtype=torch.int32, device=dev)
    fb = torch.zeros((len(plane.FB_FIELDS), R, S), dtype=torch.float32, device=dev)
    tf = torch.zeros((1, R, T), dtype=torch.float32, device=dev)
    return plane.unpack_tick_inputs(pkt, fb, tf, tick_ms, roll_quality)


@device_entry("paged.dead_page_outputs")
def dead_page_outputs(MT: int, TP: int, K: int, SP: int, tick_ms: int, roll_quality: int,
                      audio_params: audio.AudioLevelParams = audio.AudioLevelParams(),
                      bwe_params: bwe.BWEParams = bwe.BWEParams(),
                      red_enabled: bool = True, device="cuda") -> TickOutputs:
    """TickOutputs of ONE free page under this tick's scalars: a 1-page
    pool in init state with zero inputs, ticked by the stock tick with
    the same MT (the phase-2 gather width), so it equals every dead row
    of the stock tick. Leading axis 1."""
    rep = PagedDims(rooms=1, tracks=MT * TP, pkts=K, subs=SP, tpage=TP, spage=SP,
                    pool_pages=1)
    _, out = paged_plane_tick(
        page_init_template(rep, device),
        _zero_inputs(rep.pooled(), tick_ms, roll_quality, device),
        init_table(rep, device), audio_params, bwe_params, red_enabled=red_enabled,
    )
    return out


@functools.lru_cache(maxsize=64)
def dead_page_outputs_cached(MT: int, TP: int, K: int, SP: int, tick_ms: int,
                             roll_quality: int, audio_params, bwe_params,
                             red_enabled: bool, device) -> TickOutputs:
    """`dead_page_outputs`, computed once per distinct argument set: the
    outputs depend on nothing else, so the live tick does not run a
    1-page stock tick (two more kernel launches) every tick. Callers must
    not write into the returned tensors."""
    return dead_page_outputs(MT, TP, K, SP, tick_ms, roll_quality, audio_params,
                             bwe_params, red_enabled, device)


def _dead_for(state: PlaneState, inp: TickInputs, MT: int, audio_params, bwe_params,
              red_enabled: bool) -> TickOutputs:
    """`dead_page_outputs` for this pool's page shape and this tick's
    scalars (read from the device inputs)."""
    return dead_page_outputs(MT, state.meta.is_video.shape[1], inp.sn.shape[2],
                             state.ctrl.subscribed.shape[2], int(inp.tick_ms),
                             int(inp.roll_quality), audio_params, bwe_params,
                             red_enabled, inp.sn.device)


def live_rows_of(pg_room: np.ndarray):
    """(live_rows, live_inv, live count) of a page table's owner column:
    the mapped pool ids padded to a pow2 bucket by repeating a LIVE row
    (the live tick needs a live representative, never a dead one), and
    pool id → compact index (dead rows 0, read only masked). int32
    numpy."""
    rows = np.nonzero(np.asarray(pg_room) >= 0)[0].astype(np.int32)
    inv = np.zeros(len(pg_room), np.int32)
    inv[rows] = np.arange(len(rows), dtype=np.int32)
    n = len(rows)
    if n:
        bucket = 1 << (n - 1).bit_length()
        rows = np.concatenate([rows, np.repeat(rows[:1], bucket - n)])
    return rows, inv, n


def broadcast_dead_outputs(rep_out: TickOutputs, P: int) -> TickOutputs:
    """Tile the representative free page's outputs to the full pool (a
    fresh copy the caller may write into)."""
    return plane.tree_map(lambda r: r.expand((P,) + tuple(r.shape[1:])).clone(), rep_out)


@device_entry("paged.paged_plane_tick_live")
def paged_plane_tick_live(state: PlaneState, inp: TickInputs, table: PageTable,
                          live_rows, live_inv, decide: paged_kernel.LiveDecide,
                          audio_params: audio.AudioLevelParams = audio.AudioLevelParams(),
                          bwe_params: bwe.BWEParams = bwe.BWEParams(),
                          red_enabled: bool = True, dead: TickOutputs | None = None):
    """Phases 1–2 of the live-extent tick over the compact [NL] batch,
    then the scatter back to pool shape. `decide` is phase 0's output for
    `live_rows` [NL] int32 (pool ids, padded with duplicates of a live
    row); `live_inv` [P] int32 maps a pool id to its compact index (dead
    rows 0, read only masked). `dead` is this tick's
    `dead_page_outputs` (computed here from `inp` when None). NL >= 1.

    Writes the live rows of `state` in place and returns it with the
    pool-shape TickOutputs: dead rows keep their state and get `dead`."""
    P, MT = table.tmembers.shape
    lr = live_rows.long()
    tm_c = table.tmembers[lr]                                          # [NL, MT]
    mvalid = tm_c >= 0
    # A live page's valid tmembers always name live pages, so the
    # cross-page gathers stay inside the compact batch.
    mem = live_inv[tm_c.clamp(0, P - 1).long()].long()
    state_c = plane.tree_map(lambda a: a[lr], state)
    inp_c = inp._replace(**{f: getattr(inp, f)[lr] for f in TickInputs._fields
                            if f not in ("tick_ms", "roll_quality")})

    # ---- phase 1: per-page core over live rows only ------------------------
    new_c, outs, bitrates = plane._room_tick(
        state_c, inp_c, decide.need_kf, _gsum(decide.pkts_sent, mem, mvalid),
        _gsum(decide.sent_bytes, mem, mvalid), audio_params, bwe_params, red_enabled,
        routed_stats=(decide.st, decide.tr),
    )
    # ---- phase 2 -------------------------------------------------------------
    sel_state, alloc_outs = _allocate(state_c, decide.sel, outs, bitrates, mem, mvalid,
                                      table.pg_tp[lr])
    outputs_c = TickOutputs(send_bits=decide.send_bits, drop_bits=decide.drop_bits,
                            switch_bits=decide.switch_bits, fwd_packets=decide.fwd_packets,
                            fwd_bytes=decide.fwd_bytes, **alloc_outs, **outs)

    # ---- scatter back to pool shape ----------------------------------------
    # meta/ctrl are not written by the tick. Padded duplicate rows carry
    # identical values.
    new_c = new_c._replace(sel=sel_state)
    for field in PlaneState._fields:
        if field in ("meta", "ctrl"):
            continue
        for full, c in zip(plane.tree_leaves(getattr(state, field)),
                           plane.tree_leaves(getattr(new_c, field))):
            full.index_copy_(0, lr, c)
    if dead is None:
        dead = _dead_for(state, inp, MT, audio_params, bwe_params, red_enabled)
    outputs = broadcast_dead_outputs(dead, P)
    for full, c in zip(outputs, outputs_c):
        full.index_copy_(0, lr, c)
    return state, outputs


@device_entry("paged.paged_plane_tick_fused")
def paged_plane_tick_fused(state: PlaneState, inp: TickInputs, table: PageTable,
                           live_rows, live_inv,
                           audio_params: audio.AudioLevelParams = audio.AudioLevelParams(),
                           bwe_params: bwe.BWEParams = bwe.BWEParams(),
                           red_enabled: bool = True, dead: TickOutputs | None = None):
    """The whole live-extent tick: phase 0 on the live-page kernel
    (`paged_kernel.decide_pages`), then `paged_plane_tick_live`. With no
    live pages the state is untouched and every row gets the dead
    outputs. Writes `state` in place, like `paged_plane_tick_live`."""
    P, MT = table.tmembers.shape
    if live_rows.numel() == 0:
        if dead is None:
            dead = _dead_for(state, inp, MT, audio_params, bwe_params, red_enabled)
        return state, broadcast_dead_outputs(dead, P)
    dec = paged_kernel.decide_pages(state.sel, state.meta.is_svc, state.meta.is_video,
                                    _base(state), inp, live_rows,
                                    wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    return paged_plane_tick_live(state, inp, table, live_rows, live_inv, dec,
                                 audio_params, bwe_params, red_enabled, dead=dead)


# ---------------------------------------------------------------------------
# Device steps: one host→device copy of the pooled wire, the tick, one
# device→host copy of the flat outputs.
# ---------------------------------------------------------------------------


def stock_step(state: PlaneState, table: PageTable, wire: np.ndarray, dims: PagedDims,
               audio_params: audio.AudioLevelParams = audio.AudioLevelParams(),
               bwe_params: bwe.BWEParams = bwe.BWEParams(),
               red_enabled: bool = True):
    """The stock pooled device step. Returns (state', flat int32 numpy
    buffer at pool shape)."""
    buf = torch.from_numpy(wire).to(state.meta.is_video.device)
    inp = plane.unpack_tick_inputs(*plane.unwire_inputs(buf, dims.pooled()))
    state, out = paged_plane_tick(state, inp, table, audio_params, bwe_params, red_enabled)
    return state, plane.fetch_outputs(out)


def live_step(state: PlaneState, table: PageTable, wire: np.ndarray, dims: PagedDims,
              live_rows, live_inv,
              audio_params: audio.AudioLevelParams = audio.AudioLevelParams(),
              bwe_params: bwe.BWEParams = bwe.BWEParams(),
              red_enabled: bool = True):
    """The live-extent device step: the pooled wire up, phase 0 on the
    live-page kernel, phases 1–2 over the live rows, the scatter, the flat
    outputs down. `live_rows`/`live_inv` are device int32 tensors. The
    dead-page outputs come from `dead_page_outputs_cached`, keyed by the
    host's copy of the tick scalars (no device read).

    Returns (state', flat int32 numpy buffer at pool shape, seconds the
    phase-0 span took: device time between CUDA events on a card, host
    time on the CPU)."""
    dev = state.meta.is_video.device
    P, MT = table.tmembers.shape
    tick_ms, roll = int(wire[-2]), int(wire[-1])
    dead = dead_page_outputs_cached(MT, dims.tpage, dims.pkts, dims.spage, tick_ms, roll,
                                    audio_params, bwe_params, red_enabled, dev)
    if live_rows.numel() == 0:
        return state, plane.fetch_outputs(broadcast_dead_outputs(dead, P)), 0.0
    buf = torch.from_numpy(wire).to(dev)
    inp = plane.unpack_tick_inputs(*plane.unwire_inputs(buf, dims.pooled()))
    base = _base(state)
    if dev.type == "cuda":
        span = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        span[0].record()
    else:
        t0 = time.perf_counter()
    dec = paged_kernel.decide_pages(state.sel, state.meta.is_svc, state.meta.is_video,
                                    base, inp, live_rows,
                                    wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    if dev.type == "cuda":
        span[1].record()
    else:
        kernel_s = time.perf_counter() - t0
    state, out = paged_plane_tick_live(state, inp, table, live_rows, live_inv, dec,
                                       audio_params, bwe_params, red_enabled, dead=dead)
    flat = plane.fetch_outputs(out)   # waits for the device
    if dev.type == "cuda":
        kernel_s = span[0].elapsed_time(span[1]) / 1e3
    return state, flat, kernel_s


# ---------------------------------------------------------------------------
# Page-table delta lane: alloc/free/grow/compact events upload O(dirty
# pages) table rows, never the whole table.
# ---------------------------------------------------------------------------


def pack_table_delta(pager, delta):
    """Host half: the table rows dirtied by a drained PageDelta, from the
    pager's numpy mirrors. Dirty pages = fresh + freed + both ends of
    every move + every current page of a dirty room (tmembers of ALL of a
    room's pages change when its grid grows). Returns (page_rows,
    tmembers rows, pg_room rows, pg_tp rows, pg_sp rows, room_rows,
    rooms_pages rows)."""
    pages: set[int] = set(int(p) for p in delta.fresh_pages)
    pages.update(int(p) for p in delta.freed_pages)
    for src, dst in delta.moves:
        pages.add(int(src))
        pages.add(int(dst))
    for r in delta.rooms:
        pages.update(int(p) for p in pager.pages_of_room(int(r)))
    page_rows = np.asarray(sorted(pages), np.int32)
    room_rows = np.asarray(delta.rooms, np.int32)
    return (page_rows, pager.tmembers[page_rows], pager.pg_room[page_rows],
            pager.pg_tp[page_rows], pager.pg_sp[page_rows], room_rows,
            pager.rooms_pages[room_rows])


def _rows(x, device):
    return torch.as_tensor(np.asarray(x), device=device)


@device_entry("paged.apply_table_delta")
def apply_table_delta(table: PageTable, page_rows, tmember_rows, pg_room_rows,
                      pg_tp_rows, pg_sp_rows, room_rows, rooms_pages_rows) -> PageTable:
    """Device half: write the dirtied rows into the device table in place."""
    dev = table.pg_room.device
    pr = _rows(page_rows, dev).long()
    rr = _rows(room_rows, dev).long()
    table.rooms_pages[rr] = _rows(rooms_pages_rows, dev).to(torch.int32)
    table.tmembers[pr] = _rows(tmember_rows, dev).to(torch.int32)
    table.pg_room[pr] = _rows(pg_room_rows, dev).to(torch.int32)
    table.pg_tp[pr] = _rows(pg_tp_rows, dev).to(torch.int32)
    table.pg_sp[pr] = _rows(pg_sp_rows, dev).to(torch.int32)
    return table


@device_entry("paged.page_init_template")
def page_init_template(dims: PagedDims, device="cuda") -> PlaneState:
    """A single init page ([1, TP, K, SP] PlaneState): the source for
    fresh/freed page re-init and the fill for unmapped regions in
    pooled→logical translation."""
    return plane.init_state(PlaneDims(1, dims.tpage, dims.pkts, dims.spage), device=device)


@device_entry("paged.reinit_pages")
def reinit_pages(state: PlaneState, rows, template: PlaneState) -> PlaneState:
    """Reset `rows` to pristine init state in place — freshly allocated
    pages (a new room must not inherit the prior tenant's cursors) and
    freed pages (stale state must stop computing). Duplicate rows are
    fine (identical values)."""
    idx = _rows(rows, state.meta.is_video.device).long()
    for leaf, tleaf in zip(plane.tree_leaves(state), plane.tree_leaves(template)):
        leaf[idx] = tleaf.to(leaf.dtype)
    return state


@device_entry("paged.move_state_rows")
def move_state_rows(state: PlaneState, src, dst) -> PlaneState:
    """Replay compaction relocations as page-row copies, in place. Each
    leaf gathers every source row before it scatters, so overlapping
    src/dst sets are safe; dst rows are unique by construction."""
    dev = state.meta.is_video.device
    s, d = _rows(src, dev).long(), _rows(dst, dev).long()
    for leaf in plane.tree_leaves(state):
        leaf[d] = leaf[s]
    return state


# ---------------------------------------------------------------------------
# Host-side layout translation: pooled ↔ logical (numpy).
#
# Leaf kinds — every PlaneState leaf is one of:
#   "track":     [R, T·m, *tail]  (stats/tracker rows are t-major, so a
#                track page's m rows are one contiguous block)
#   "sub":       [R, S, *tail]
#   "track_sub": [R, T, S, *tail]
# and the pooled counterpart replaces (R, T, S) with (P, TP, SP).
# ---------------------------------------------------------------------------

_K_TRACK, _K_SUB, _K_TS = "track", "sub", "track_sub"


def _kind_tree(template: PlaneState) -> PlaneState:
    """The PlaneState tree with each leaf replaced by its kind."""
    def const(tree, kind):
        return plane.tree_map(lambda _: kind, tree)

    return PlaneState(
        meta=const(template.meta, _K_TRACK),
        ctrl=const(template.ctrl, _K_TS),
        stats=const(template.stats, _K_TRACK),
        audio_state=const(template.audio_state, _K_TRACK),
        sel=const(template.sel, _K_TS),
        bwe_state=const(template.bwe_state, _K_SUB),
        delay_bwe=const(template.delay_bwe, _K_SUB),
        tracker=const(template.tracker, _K_TRACK),
        pacer_state=const(template.pacer_state, _K_SUB),
        red_state=const(template.red_state, _K_TRACK),
        temporal_bytes=_K_TRACK,
    )


class LayoutXlate:
    """Pooled ↔ logical translation for one page-table snapshot (numpy).

    Built from the pager's mirrors; valid for one pager epoch (the index
    arrays are its only state). Reads follow duplicate-everywhere /
    read-from-one: track kinds from sp == 0 pages, sub kinds from tp == 0
    pages, track_sub kinds from every page. Writes go to ALL of a room's
    pages, re-establishing the duplication invariant."""

    def __init__(self, dims: PagedDims, pg_room, pg_tp, pg_sp):
        self.dims = dims
        self.pg_room = np.asarray(pg_room, np.int64)
        self.pg_tp = np.asarray(pg_tp, np.int64)
        self.pg_sp = np.asarray(pg_sp, np.int64)
        self.occ = self.pg_room >= 0
        self.sp0 = self.occ & (self.pg_sp == 0)
        self.tp0 = self.occ & (self.pg_tp == 0)

    # -- generic state trees ---------------------------------------------

    def state_to_logical(self, pooled_tree, fill_tree):
        """Pooled PlaneState (numpy) → logical PlaneState of numpy arrays;
        unmapped regions come from `fill_tree` (the logical init state)."""
        return plane.tree_map(self._leaf_to_logical, _kind_tree(fill_tree),
                              pooled_tree, fill_tree)

    def state_to_pooled(self, logical_tree, pooled_init_tree):
        """Logical PlaneState → pooled PlaneState of numpy arrays; free
        pages keep `pooled_init_tree` values."""
        return plane.tree_map(self._leaf_to_pooled, _kind_tree(logical_tree),
                              logical_tree, pooled_init_tree)

    def _views(self, kind, logical, pooled):
        d = self.dims
        R, T, S, P = d.rooms, d.tracks, d.subs, d.pool_pages
        MT, TP, MS, SP = d.max_tpages, d.tpage, d.max_spages, d.spage
        if kind == _K_TRACK:
            w = logical.size // (R * T)
            return logical.reshape(R, MT, TP, w), pooled.reshape(P, TP, w)
        if kind == _K_SUB:
            w = logical.size // (R * S)
            return logical.reshape(R, MS, SP, w), pooled.reshape(P, SP, w)
        w = logical.size // (R * T * S)
        return logical.reshape(R, MT, TP, MS, SP, w), pooled.reshape(P, TP, SP, w)

    def _leaf_to_logical(self, kind, pl, fill):
        pl = np.ascontiguousarray(np.asarray(pl))
        out = np.array(np.asarray(fill), copy=True)
        lv, pv = self._views(kind, out, pl)
        if kind == _K_TRACK:
            sel = self.sp0
            lv[self.pg_room[sel], self.pg_tp[sel]] = pv[sel]
        elif kind == _K_SUB:
            sel = self.tp0
            lv[self.pg_room[sel], self.pg_sp[sel]] = pv[sel]
        else:
            sel = self.occ
            lv[self.pg_room[sel], self.pg_tp[sel], :, self.pg_sp[sel]] = pv[sel]
        return out

    def _leaf_to_pooled(self, kind, lg, pooled_init):
        lg = np.ascontiguousarray(np.asarray(lg))
        out = np.array(np.asarray(pooled_init), copy=True)
        lv, pv = self._views(kind, lg, out)
        sel = self.occ
        if kind == _K_TRACK:
            pv[sel] = lv[self.pg_room[sel], self.pg_tp[sel]]
        elif kind == _K_SUB:
            pv[sel] = lv[self.pg_room[sel], self.pg_sp[sel]]
        else:
            pv[sel] = lv[self.pg_room[sel], self.pg_tp[sel], :, self.pg_sp[sel]]
        return out

    # -- tick I/O --------------------------------------------------------

    def stage_inputs(self, pkt, fb, tf):
        """Packed LOGICAL tick inputs → packed POOLED inputs: a track
        page's packets go to every sp-duplicate and a sub page's feedback
        to every tp-duplicate. Free pages read zeros."""
        d = self.dims
        R, MT, TP = d.rooms, d.max_tpages, d.tpage
        MS, SP, K = d.max_spages, d.spage, d.pkts
        roomc = np.where(self.occ, self.pg_room, 0)
        tpc = np.where(self.occ, self.pg_tp, 0)
        spc = np.where(self.occ, self.pg_sp, 0)
        F = pkt.shape[0]
        pkt_p = pkt.reshape(F, R, MT, TP, K)[:, roomc, tpc]
        pkt_p = np.where(self.occ[None, :, None, None], pkt_p, 0)
        fb_p = fb.reshape(fb.shape[0], R, MS, SP)[:, roomc, spc]
        fb_p = np.where(self.occ[None, :, None], fb_p, 0.0)
        tf_p = tf.reshape(tf.shape[0], R, MT, TP)[:, roomc, tpc]
        tf_p = np.where(self.occ[None, :, None], tf_p, 0.0)
        return pkt_p, fb_p, tf_p

    def outputs_to_logical(self, out: TickOutputs) -> TickOutputs:
        """Pooled TickOutputs (numpy) → logical TickOutputs. Bit masks
        re-pack into the logical ⌈S/32⌉ words (a sub page never straddles
        a word); per-room counters sum over the room's pages; speakers
        merge per room (`merge_speakers`)."""
        d = self.dims
        R, T, K, S = d.logical
        TP, SP, MT = d.tpage, d.spage, d.max_tpages
        W = mask_words(S)
        rooms = self.pg_room[self.occ]
        tps = self.pg_tp[self.occ]
        sps = self.pg_sp[self.occ]

        def bits(pb):  # [P, TP, K, 1] → [R, T, K, W]
            lw = np.zeros(R * T * K * W, np.uint32)
            vals = np.asarray(pb)[self.occ][:, :, :, 0].astype(np.uint32)
            shift = ((sps * SP) % 32).astype(np.uint32)
            words = (sps * SP) // 32
            shifted = vals << shift[:, None, None]
            t_glob = tps[:, None] * TP + np.arange(TP)[None, :]      # [N, TP]
            flat_idx = (
                (rooms[:, None, None] * T + t_glob[:, :, None]) * K
                + np.arange(K)[None, None, :]
            ) * W + words[:, None, None]
            np.bitwise_or.at(lw, flat_idx, shifted)
            return lw.view(np.int32).reshape(R, T, K, W)

        def ts(x, fill=0):  # [P, TP, SP, ...] → [R, T, S, ...]
            x = np.asarray(x)
            lg = np.full((R, MT, TP, d.max_spages, SP) + x.shape[3:], fill, x.dtype)
            lg[rooms, tps, :, sps] = x[self.occ]
            return lg.reshape((R, T, S) + x.shape[3:])

        def sub(x, fill=0):  # [P, SP, ...] → [R, S, ...]
            x = np.asarray(x)
            lg = np.full((R, d.max_spages, SP) + x.shape[2:], fill, x.dtype)
            s = self.tp0
            lg[self.pg_room[s], self.pg_sp[s]] = x[s]
            return lg.reshape((R, S) + x.shape[2:])

        def track(x, fill=0):  # [P, TP, ...] → [R, T, ...]
            x = np.asarray(x)
            lg = np.full((R, MT, TP) + x.shape[2:], fill, x.dtype)
            s = self.sp0
            lg[self.pg_room[s], self.pg_tp[s]] = x[s]
            return lg.reshape((R, T) + x.shape[2:])

        def room_sum(x):  # [P] → [R]
            lg = np.zeros(R, np.asarray(x).dtype)
            np.add.at(lg, rooms, np.asarray(x)[self.occ])
            return lg

        # target_layers: [P, SP, TP] own-track slices → [R, S, T]
        tgt = np.asarray(out.target_layers)
        tgt_lg = np.full((R, d.max_spages, SP, MT, TP), -1, tgt.dtype)
        tgt_lg[rooms, sps, :, tps] = tgt[self.occ]
        tgt_lg = tgt_lg.reshape(R, S, T)

        spk_lv, spk_tr = self.merge_speakers(out.speaker_levels, out.speaker_tracks)
        red_k = np.asarray(out.red_sn).shape[2]

        def red_leaf(x, dtype):
            if red_k:
                return track(x).astype(dtype)
            return np.zeros((R, T, 0, np.asarray(x).shape[3]), dtype)

        return TickOutputs(
            send_bits=bits(out.send_bits),
            drop_bits=bits(out.drop_bits),
            switch_bits=bits(out.switch_bits),
            need_keyframe=ts(out.need_keyframe, False),
            speaker_levels=spk_lv,
            speaker_tracks=spk_tr,
            congested=sub(out.congested, False),
            target_layers=tgt_lg,
            fwd_packets=room_sum(out.fwd_packets),
            fwd_bytes=room_sum(out.fwd_bytes),
            track_mos=track(out.track_mos, 0.0),
            track_quality=track(out.track_quality, quality.QUALITY_LOST),
            sub_quality=sub(out.sub_quality, quality.QUALITY_LOST),
            layer_live=track(out.layer_live),
            layer_fps=track(out.layer_fps, 0.0),
            track_loss_pct=track(out.track_loss_pct, 0.0),
            track_jitter_ms=track(out.track_jitter_ms, 0.0),
            track_bps=track(out.track_bps, 0.0),
            committed_bps=sub(out.committed_bps, 0.0),
            pacer_allowed=sub(out.pacer_allowed, 0.0),
            deficient=sub(out.deficient, False),
            red_sn=red_leaf(out.red_sn, np.int32),
            red_off=red_leaf(out.red_off, np.int32),
            red_ok=red_leaf(out.red_ok, bool),
        )

    def merge_speakers(self, levels_p, tracks_p):
        """Per-room merge of per-page top-k speaker rankings, exact
        against the dense top-k: a page's top-min(3, TP) dominates every
        track it omits, so the union of page rankings holds the room's
        top 3; a stable argsort on -level keeps the lowest-index-first
        tie rule (the all-zero case yields tracks 0, 1, 2 at level 0)."""
        d = self.dims
        R, T, TP = d.rooms, d.tracks, d.tpage
        levels_p = np.asarray(levels_p)
        tracks_p = np.asarray(tracks_p)
        lv = np.zeros((R, T), np.float32)
        for p in np.nonzero(self.sp0)[0]:
            r, tp = self.pg_room[p], self.pg_tp[p]
            for i in range(levels_p.shape[1]):
                tr = tracks_p[p, i]
                if tr >= 0:
                    lv[r, tp * TP + tr] = levels_p[p, i]
        k = min(SPEAKER_TOP_K, T)
        order = np.argsort(-lv, axis=1, kind="stable")[:, :k]
        out_lv = np.take_along_axis(lv, order, axis=1).astype(np.float32)
        out_tr = order.astype(np.int32)
        if k < SPEAKER_TOP_K:
            pad = SPEAKER_TOP_K - k
            out_lv = np.pad(out_lv, ((0, 0), (0, pad)))
            out_tr = np.pad(out_tr, ((0, 0), (0, pad)), constant_values=-1)
        return out_lv, out_tr

    def page_mask_to_rooms(self, mask):
        """[P] per-page audit mask → [R] per-room mask (OR of the room's
        pages) — the integrity monitor's map_audit_mask."""
        mask = np.asarray(mask)
        room_mask = np.zeros(self.dims.rooms, mask.dtype)
        np.bitwise_or.at(room_mask, self.pg_room[self.occ], mask[self.occ])
        return room_mask

    def sel_to_logical(self, sel_pooled, sel_fill):
        """Pooled SelectorState (numpy) → logical: each leaf is track_sub."""
        return plane.tree_map(lambda pl, fl: self._leaf_to_logical(_K_TS, pl, fl),
                              sel_pooled, sel_fill)
