"""Seeded numpy inputs for the paged-plane parity tests of the port
(tests/test_torch_paged*.py), handed to both packages.

The model-level fixture is the one of tests/test_paged_kernel.py: a
hand-built page table over PagedDims(rooms=4, tracks=4, pkts=4, subs=8,
tpage=2, spage=4, pool_pages=16) — room 0 holds one page (tp0, sp0),
room 1 the full 2x2 grid; 5 live pages, 11 dead, live_rows padded to the
pow2 bucket of 8 with a live row.
"""

from __future__ import annotations

import numpy as np
import torch

from livekit_server_tpu_torch.models import plane as tplane

DIMS = dict(rooms=4, tracks=4, pkts=4, subs=8, tpage=2, spage=4, pool_pages=16)
P, MT, MS, TP, SP, K = 16, 2, 2, 2, 4, 4


def table_arrays():
    """(rooms_pages, tmembers, pg_room, pg_tp, pg_sp, live, live_rows,
    live_inv) as int32 numpy arrays."""
    pg_room = np.full(P, -1, np.int32)
    pg_tp = np.full(P, -1, np.int32)
    pg_sp = np.full(P, -1, np.int32)
    tmembers = np.full((P, MT), -1, np.int32)
    pg_room[0], pg_tp[0], pg_sp[0] = 0, 0, 0
    tmembers[0] = [0, -1]
    grid = {(0, 0): 1, (1, 0): 2, (0, 1): 3, (1, 1): 4}
    for (tp, sp), pid in grid.items():
        pg_room[pid], pg_tp[pid], pg_sp[pid] = 1, tp, sp
    for sp in range(2):
        row = [grid[(0, sp)], grid[(1, sp)]]
        for tp in range(2):
            tmembers[grid[(tp, sp)]] = row
    rooms_pages = np.full((DIMS["rooms"], MT * MS), -1, np.int32)
    live = np.nonzero(pg_room >= 0)[0].astype(np.int32)
    live_rows = np.concatenate([live, np.repeat(live[:1], 8 - len(live))]).astype(np.int32)
    live_inv = np.zeros(P, np.int32)
    live_inv[live] = np.arange(len(live), dtype=np.int32)
    return rooms_pages, tmembers, pg_room, pg_tp, pg_sp, live, live_rows, live_inv


def control(rng, live, shape=(P, TP, K, SP)):
    """Per-page meta/control of the live pages: (is_video, published,
    is_svc, subscribed, sub_muted)."""
    P, TP, _, SP = shape
    sub = np.zeros((P, TP, SP), bool)
    mut = np.zeros((P, TP, SP), bool)
    vid = np.zeros((P, TP), bool)
    svc = np.zeros((P, TP), bool)
    pub = np.zeros((P, TP), bool)
    for p in live:
        sub[p] = rng.random((TP, SP)) < 0.7
        mut[p] = rng.random((TP, SP)) < 0.1
        vid[p] = rng.random(TP) < 0.6
        svc[p] = (rng.random(TP) < 0.3) & vid[p]
        pub[p] = rng.random(TP) < 0.9
    return vid, pub, svc, sub, mut


def inputs(rng, live, tick_ms=10, roll=0, shape=(P, TP, K, SP)) -> dict:
    """One tick of pooled TickInputs fields as numpy arrays at pool shape
    (P, TP, K, SP): live pages carry traffic, dead pages zeros."""
    P, TP, K, SP = shape

    def pk(lo, hi):
        a = np.zeros((P, TP, K), np.int32)
        for p in live:
            a[p] = rng.integers(lo, hi, (TP, K))
        return a

    def pkb(prob):
        a = np.zeros((P, TP, K), bool)
        for p in live:
            a[p] = rng.random((TP, K)) < prob
        return a

    def sb(shape, lo, hi):
        a = np.zeros(shape, np.float32)
        for p in live:
            a[p] = rng.uniform(lo, hi, shape[1:])
        return a

    return dict(
        sn=pk(0, 65536), ts=pk(0, 1 << 30), layer=pk(0, 3),
        temporal=pk(0, 4), keyframe=pkb(0.2), layer_sync=pkb(0.3),
        begin_pic=pkb(0.4), end_frame=pkb(0.4), pid=pk(0, 100),
        tl0=pk(0, 100), keyidx=pk(0, 30), size=pk(40, 1200),
        frame_ms=pk(0, 20), audio_level=pk(0, 127),
        arrival_rtp=pk(0, 1 << 28),
        ts_jump=np.zeros((P, TP, K), np.int32), valid=pkb(0.8),
        estimate=sb((P, SP), 1e5, 5e6),
        estimate_valid=sb((P, SP), 0, 1) > 0.5,
        nacks=sb((P, SP), 0, 3),
        pub_rtt_ms=sb((P, TP), 0, 80),
        fb_delay_ms=sb((P, SP), 0, 30), fb_recv_bps=sb((P, SP), 1e5, 4e6),
        fb_valid=sb((P, SP), 0, 1) > 0.4,
        fb_enabled=sb((P, SP), 0, 1) > 0.2,
        sub_reset=np.zeros((P, SP), bool),
        pad_num=np.zeros((P, SP), np.int32),
        pad_track=np.full((P, SP), -1, np.int32),
        tick_ms=np.int32(tick_ms), roll_quality=np.int32(roll),
    )


def mix_operands(rng, shape, n):
    """(pcm [P, TP, n], level [P, TP] with three equal levels at the top-K
    boundary, active, sub_track [P, SP], gain) as numpy arrays."""
    P, TP, _, SP = shape
    pcm = rng.standard_normal((P, TP, n)).astype(np.float32) * 0.3
    level = rng.random((P, TP)).astype(np.float32)
    level[:, 2] = level[:, 5] = level[:, 7]
    return (pcm, level, rng.random((P, TP)) < 0.7,
            rng.integers(-1, TP, (P, SP)).astype(np.int32),
            rng.uniform(0.5, 1.5, (P, TP)).astype(np.float32))


def port_inputs(fields: dict) -> tplane.TickInputs:
    return tplane.TickInputs(**{k: torch.as_tensor(np.asarray(v)) for k, v in fields.items()})


def with_control(state, ctrl, asarray):
    """`state` (either package's PlaneState) with the meta/control of
    `control()` written in, each array converted by `asarray`."""
    vid, pub, svc, sub, mut = (asarray(a) for a in ctrl)
    return state._replace(
        meta=state.meta._replace(is_video=vid, published=pub, is_svc=svc),
        ctrl=state.ctrl._replace(subscribed=sub, sub_muted=mut),
    )


def assert_leaves_match(port_leaves, ref_leaves, names, where):
    """Integers and bools equal; floats within `plane.float_tolerance`."""
    assert len(port_leaves) == len(ref_leaves) == len(names)
    for name, p, r in zip(names, port_leaves, ref_leaves):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        r = np.asarray(r)
        assert p.shape == r.shape, (where, name, p.shape, r.shape)
        if r.dtype.kind == "f":
            rtol, atol = tplane.float_tolerance(name)
            np.testing.assert_allclose(p, r, rtol=rtol, atol=atol, err_msg=f"{where} {name}")
        else:
            assert np.array_equal(p, r.astype(p.dtype)), (where, name)


def phase2_alloc_case(seed: int, rooms: int, tracks: int = 64, subs: int = 8, tpage: int = 4):
    """numpy operands of `allocate_budget_rooms` at the paged phase-2
    geometry [rooms, subs, tracks]: each room allocates over the full
    track extent, and the tracks past its own pages (a random multiple of
    `tpage`) are fill tracks as `models/paged.py` `_allocate` builds them
    (bitrates 0, caps MAX_LAYERS-1 / 3, muted). Returns (bitrates
    [R, T, 4, 4] f32, max_spatial, max_temporal [R, S, T] i32, muted
    [R, S, T] bool, budget [R, S] f32)."""
    rng = np.random.default_rng(seed)
    R, T, S = rooms, tracks, subs
    own = tpage * rng.integers(1, T // tpage + 1, R)
    real = np.arange(T)[None, :] < own[:, None]                         # [R, T]
    bit = rng.random((R, T, 4, 4)) * 2e6 * (rng.random((R, T, 4, 4)) > 0.3)
    bit = np.where(real[:, :, None, None], bit, 0.0).astype(np.float32)
    fill = ~real[:, None, :]                                            # [R, 1, T]
    ms = np.where(fill, tplane.MAX_LAYERS - 1, rng.integers(-1, 4, (R, S, T))).astype(np.int32)
    mt = np.where(fill, 3, rng.integers(-1, 4, (R, S, T))).astype(np.int32)
    mu = fill | (rng.random((R, S, T)) < 0.3)
    bud = (rng.random((R, S)) * 3e7).astype(np.float32)
    return bit, ms, mt, mu, bud
