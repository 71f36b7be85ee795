"""Device sections of the bench CLI (tools/bench.py).

`device_bench` is the primary metric and the ladder's rungs: the
production tick (unpack_tick_inputs → media_plane_tick →
pack_tick_outputs) stepped over a pool of packed inputs that lives on the
device, so no tick pays a host copy. The forward count, the evaluated
count (valid & subscribed) and the checksums of the packed outputs are
summed on the device and read once at the end of a window.

Timing: two windows, one of N ticks and one of 3N, each between
`torch.cuda.synchronize()` calls on the host's clock; the slope
(t_B − t_A) / 2N cancels what both windows pay once (the final counter
read, the synchronize). The host's clock is used rather than an event
pair because the same window runs on the CPU path (the tests), where
there are no CUDA events, and because the tick's eager launches are
host-bound: a device event pair would span the same launches.

The other sections keep the reference bench's meaning with the port's
means: the memory check reads `torch.cuda.mem_get_info` and
`max_memory_allocated`; `paged_capacity` is host math over a real
RoomPager; `paged_kernel` runs the live-extent tick through the hand
kernels (paged_kernel.cu, budget_rooms.cu); `audio_mix` and
`audio_mix_1kroom` run ops/mix.py and runtime/mixer.py `_device_mix`.
Their times are `tools.timing.event_ms` on the card (`wall_ms` on the
CPU): one call between an event pair, host launches included, as the
reference's chained calls were.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.models import plane, synth
from livekit_server_tpu_torch.tools.timing import event_ms, wall_ms

# bench.py's default dims and traffic: 4 × 3 Mbps simulcast video + 4 Opus
# tracks a room at a 20 ms tick (about 6–7 video packets a track a tick).
DEFAULT_DIMS = plane.PlaneDims(128, 8, 16, 16)
DEFAULT_SPEC = synth.TrafficSpec(video_tracks=4, audio_tracks=4, tick_ms=20,
                                 video_kbps=3000)

# The BASELINE.md ladder: (dims, traffic, section estimate s).
LADDER = {
    "cfg1_1room_2p_audio": (
        plane.PlaneDims(1, 2, 8, 2),
        synth.TrafficSpec(video_tracks=0, audio_tracks=2, tick_ms=20),
        25,
    ),
    "cfg2_1room_50p_audio": (
        plane.PlaneDims(1, 50, 8, 50),
        synth.TrafficSpec(video_tracks=0, audio_tracks=50, tick_ms=20),
        25,
    ),
    "cfg3_1room_25p_vp8_simulcast": (
        plane.PlaneDims(1, 25, 16, 25),
        synth.TrafficSpec(video_tracks=25, audio_tracks=0, tick_ms=20,
                          video_kbps=3000),
        25,
    ),
    "cfg4_1krooms_10p_mixed_svc": (
        plane.PlaneDims(1024, 10, 8, 10),
        synth.TrafficSpec(video_tracks=2, audio_tracks=8, tick_ms=20,
                          video_kbps=1500, svc=True),
        40,
    ),
}
# The wire bench's shape, its device tick measured alone.
WIRE_SHAPE = (plane.PlaneDims(32, 8, 8, 6),
              synth.TrafficSpec(video_tracks=4, audio_tracks=4, tick_ms=5,
                                video_kbps=3000))
# The north star: 10k rooms × 50 subscribers on one card; and the smaller
# memory claim checked when it fails.
NORTH_STAR = (plane.PlaneDims(10240, 8, 16, 50),
              synth.TrafficSpec(video_tracks=2, audio_tracks=6, tick_ms=20,
                                video_kbps=1500, svc=True))
MEM_1K = (plane.PlaneDims(1024, 8, 16, 50),
          synth.TrafficSpec(video_tracks=2, audio_tracks=6, tick_ms=20))
# The paged sections' room-size mix (80 % 2–4, 15 % 5–10, 5 % 50; seed 9).
ROOM_MIX = "80% 2-4p / 15% 5-10p / 5% 50p (seed 9)"


# -- the device window ------------------------------------------------------


class InputPool(NamedTuple):
    """Packed tick inputs stacked on the device: pkt [n, F, R, T, K] i32,
    fb [n, 8, R, S] f32, tf [n, 1, R, T] f32, and the tick scalars as
    0-d device tensors."""

    pkt: torch.Tensor
    fb: torch.Tensor
    tf: torch.Tensor
    tick_ms: torch.Tensor
    roll: torch.Tensor

    @property
    def n(self) -> int:
        return self.pkt.shape[0]


def pool_size(dims: plane.PlaneDims, ticks: int, warmup: int) -> int:
    """Distinct ticks in the input pool: up to ~128 MB of device memory,
    at least min(ticks, 8). Windows beyond the pool replay its traffic
    on live state (replayed SNs read as late packets; the selection and
    allocation work, the measured quantity, is the same)."""
    R, T, K, S = dims
    per_tick = (len(plane.PKT_FIELDS) * R * T * K + 8 * R * S + R * T) * 4
    n_want = warmup + 5 * ticks
    return max(min(ticks, 8), min(n_want, int(128e6 // max(per_tick, 1))))


def make_pool(dims: plane.PlaneDims, spec: synth.TrafficSpec, n: int, device,
              seed: int = 0) -> InputPool:
    """`n` seeded synth ticks, packed on the host and uploaded once."""
    traffic = synth.init_traffic(dims, spec, seed=seed)
    pks, fbs, tfs = [], [], []
    for i in range(n):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=seed)
        pkt, fb, tf, _, _ = plane.pack_tick_inputs(inp)
        pks.append(pkt)
        fbs.append(fb)
        tfs.append(tf)
    dev = torch.device(device)
    up = lambda xs: torch.from_numpy(np.stack(xs)).to(dev)  # noqa: E731
    return InputPool(up(pks), up(fbs), up(tfs),
                     torch.tensor(spec.tick_ms, dtype=torch.int32, device=dev),
                     torch.tensor(0, dtype=torch.int32, device=dev))


def float_words(out: plane.TickOutputs) -> torch.Tensor:
    """[N] bool over `pack_tick_outputs(out)`: True at the words of the
    float32 leaves (bit patterns), False at the integer and bool ones."""
    return torch.cat([torch.full((x.numel(),), x.dtype == torch.float32,
                                 dtype=torch.bool, device=x.device) for x in out])


def run_window(state: plane.PlaneState, pool: InputPool, start: int, ticks: int):
    """`ticks` production ticks from pool tick `start` (wrapping). Returns
    (state', ints [3] int64 = forwarded writes, evaluated (valid ×
    subscribed) pairs, the int64 sum of the packed output's integer and
    bool words; fsum float64 = the sum of its float words). Nothing is
    read back to the host: the caller reads the two tensors once."""
    dev = pool.pkt.device
    ints = torch.zeros(3, dtype=torch.int64, device=dev)
    fsum = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(ticks):
        idx = (start + i) % pool.n
        inp = plane.unpack_tick_inputs(pool.pkt[idx], pool.fb[idx], pool.tf[idx],
                                       pool.tick_ms, pool.roll)
        ev = (inp.valid[:, :, :, None] & state.ctrl.subscribed[:, :, None, :]).sum(
            dtype=torch.int64)
        state, out = plane.media_plane_tick(state, inp)
        buf = plane.pack_tick_outputs(out)
        if i == 0:
            is_float = float_words(out)
        ints += torch.stack([out.fwd_packets.sum(dtype=torch.int64), ev,
                             torch.where(is_float, 0, buf).sum(dtype=torch.int64)])
        fsum += torch.where(is_float, buf.view(torch.float32), 0.0).sum(dtype=torch.float64)
    return state, ints, fsum


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window_counts(dims: plane.PlaneDims, spec: synth.TrafficSpec, ticks: int,
                  device="cuda", seed: int = 0) -> dict:
    """One window of `ticks` distinct seeded ticks from a fresh synth
    state: the forward count, the evaluated count and the output
    checksums (integer words exact; float words summed in float64)."""
    dev = resolve(device)
    state = synth.make_state(dims, spec, device=dev)
    pool = make_pool(dims, spec, ticks, dev, seed)
    _, ints, fsum = run_window(state, pool, 0, ticks)
    fwd, ev, chk = (int(x) for x in ints.cpu())
    return {"fwd": fwd, "evaluated": ev, "checksum": chk, "float_sum": float(fsum.cpu())}


def device_bench(dims: plane.PlaneDims, spec: synth.TrafficSpec, ticks: int,
                 warmup: int, device="cuda", seed: int = 0) -> dict:
    """Forwarded writes/s, evaluated pairs/s and ms a tick of the
    production tick at `dims` (module docstring: the pool, the windows,
    the slope)."""
    dev = resolve(device)
    state = synth.make_state(dims, spec, device=dev)
    pool = make_pool(dims, spec, pool_size(dims, ticks, warmup), dev, seed)

    def window(state, n_calls, start):
        _sync(dev)
        t0 = time.perf_counter()
        ints = torch.zeros(3, dtype=torch.int64, device=dev)
        for j in range(n_calls):
            state, c, _ = run_window(state, pool, (start + j * ticks) % pool.n, ticks)
            ints += c
        c = ints.cpu()          # the window's one read; it waits for the device
        _sync(dev)
        return state, int(c[0]), int(c[1]), time.perf_counter() - t0

    # Warm-up: first launches, allocator growth; at least `warmup` ticks.
    state, _, _, _ = window(state, max(1, -(-warmup // ticks)), 0)
    state, fwd_a, ev_a, t_a = window(state, 1, ticks)
    state, fwd_b, ev_b, t_b = window(state, 3, 2 * ticks)
    res = {"ticks": ticks, "pool_ticks": pool.n}
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        res.update(peak_mem_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30, 3),
                   device_free_gib=round(free / 2**30, 3),
                   device_total_gib=round(total / 2**30, 3))
    if t_b < 1.2 * t_a:
        # Fixed cost dominates (a tiny config): window B absolute, flagged
        # so that a launch floor is not read as the tick's cost.
        res.update(fwd_writes_per_s=round(fwd_b / t_b, 1),
                   evaluated_per_s=round(ev_b / t_b, 1),
                   device_tick_ms=round(t_b / (3 * ticks) * 1000.0, 3),
                   dispatch_bound=True)
        return res
    dt = t_b - t_a
    res.update(fwd_writes_per_s=round(max(fwd_b - fwd_a, 0) / dt, 1),
               evaluated_per_s=round(max(ev_b - ev_a, 0) / dt, 1),
               device_tick_ms=round(dt / (2 * ticks) * 1000.0, 3))
    return res


# -- paged sections ---------------------------------------------------------


def _sample_room(rng) -> int:
    u = rng.random()
    if u < 0.80:
        return int(rng.integers(2, 5))
    if u < 0.95:
        return int(rng.integers(5, 11))
    return 50


def _state_bytes(state: plane.PlaneState) -> int:
    return int(sum(x.element_size() * x.numel() for x in plane.tree_leaves(state)))


def device_memory_bytes(dev: torch.device) -> int:
    """Memory of the device the plane's state lives in: the card's total,
    or the host's physical memory for the CPU path."""
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def paged_capacity(pkts: int, device="cuda") -> tuple[dict, float, int]:
    """Rooms a page pool admits from the room-size mix against the rooms
    a dense plane of the same bytes holds, and rooms a device of this
    memory would hold (90 % of it for state). Host math over a real
    RoomPager; the state bytes are measured on tensors of the device.
    Returns (section record, paged/dense ratio, rooms per device)."""
    from livekit_server_tpu_torch.runtime.pager import RoomPager
    from livekit_server_tpu_torch.runtime.slots import CapacityError

    dev = resolve(device)
    T_MAX, S_MAX, TP, SP = 64, 64, 4, 8  # covers the 50-p room
    POOL = 1024
    page_bytes = _state_bytes(plane.init_state(plane.PlaneDims(1, TP, pkts, SP), device=dev))
    dense_room_bytes = _state_bytes(
        plane.init_state(plane.PlaneDims(1, T_MAX, pkts, S_MAX), device=dev))
    rng = np.random.default_rng(9)
    pager = RoomPager(rooms=POOL, tracks=T_MAX, subs=S_MAX, tpage=TP, spage=SP,
                      pool_pages=POOL)
    admitted = 0
    hist = {"le4": 0, "le10": 0, "p50": 0}
    while True:
        p = _sample_room(rng)
        try:
            pager.alloc_room(admitted, tracks=p, subs=p)
        except CapacityError:
            break
        admitted += 1
        hist["le4" if p <= 4 else "le10" if p <= 10 else "p50"] += 1
    st = pager.stats()
    pool_bytes = POOL * page_bytes
    dense_rooms = pool_bytes // dense_room_bytes
    state_bytes = int(device_memory_bytes(dev) * 0.9)
    rec = {
        "distribution": ROOM_MIX,
        "pool_pages": POOL,
        "page_bytes": page_bytes,
        "dense_room_bytes": dense_room_bytes,
        "rooms_admitted_paged": admitted,
        "rooms_equal_memory_dense": int(dense_rooms),
        "room_mix": hist,
        "pages_mapped": st["pages_mapped"],
        "internal_slack_pages": st["internal_slack"],
        "fragmentation_ratio": st["fragmentation_ratio"],
        "device_state_bytes": state_bytes,
    }
    return (rec, round(admitted / max(dense_rooms, 1), 1),
            int(state_bytes / pool_bytes * admitted))


def _page_inputs(P: int, TP: int, K: int, SP: int, salt: int, dev) -> plane.TickInputs:
    """Seeded pooled TickInputs [P, TP, K] / [P, SP] (the reference
    bench's random page traffic)."""
    r = np.random.default_rng(100 + salt)
    pk = (P, TP, K)
    t = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt)).to(dev)  # noqa: E731
    ii = lambda lo, hi, sh: t(r.integers(lo, hi, sh), np.int32)  # noqa: E731
    bb = lambda pr, sh: t(r.random(sh) < pr, bool)  # noqa: E731
    ff = lambda lo, hi, sh: t(r.uniform(lo, hi, sh), np.float32)  # noqa: E731
    zi = lambda sh: torch.zeros(sh, dtype=torch.int32, device=dev)  # noqa: E731
    return plane.TickInputs(
        sn=ii(0, 65536, pk), ts=ii(0, 1 << 30, pk),
        layer=ii(0, 3, pk), temporal=ii(0, 4, pk),
        keyframe=bb(0.2, pk), layer_sync=bb(0.3, pk),
        begin_pic=bb(0.4, pk), end_frame=bb(0.4, pk),
        pid=ii(0, 100, pk), tl0=ii(0, 100, pk),
        keyidx=ii(0, 30, pk), size=ii(40, 1200, pk),
        frame_ms=ii(0, 20, pk), audio_level=ii(0, 127, pk),
        arrival_rtp=ii(0, 1 << 28, pk),
        ts_jump=zi(pk), valid=bb(0.8, pk),
        estimate=ff(1e5, 5e6, (P, SP)),
        estimate_valid=bb(0.5, (P, SP)),
        nacks=ff(0, 3, (P, SP)), pub_rtt_ms=ff(0, 80, (P, TP)),
        fb_delay_ms=ff(0, 30, (P, SP)),
        fb_recv_bps=ff(1e5, 4e6, (P, SP)),
        fb_valid=bb(0.6, (P, SP)), fb_enabled=bb(0.8, (P, SP)),
        sub_reset=torch.zeros((P, SP), dtype=torch.bool, device=dev),
        pad_num=zi((P, SP)),
        pad_track=torch.full((P, SP), -1, dtype=torch.int32, device=dev),
        tick_ms=torch.tensor(10, dtype=torch.int32, device=dev),
        roll_quality=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def paged_kernel_bench(device="cuda") -> dict:
    """The live-extent tick (`paged.paged_plane_tick_fused`: phase 0 on
    paged_kernel.cu, phase 2 on budget_rooms.cu) on a 512-page pool
    filled from the room-size mix, at full occupancy and after releasing
    every other room, beside the stock pooled tick at full occupancy. Work
    should follow live pages, not pool size."""
    from livekit_server_tpu_torch.models import paged
    from livekit_server_tpu_torch.runtime.pager import RoomPager
    from livekit_server_tpu_torch.runtime.slots import CapacityError

    dev = resolve(device)
    T_MAX, S_MAX, TP, SP, K = 64, 64, 4, 8, 8
    POOL = 512
    dims = paged.PagedDims(rooms=POOL, tracks=T_MAX, pkts=K, subs=S_MAX, tpage=TP,
                           spage=SP, pool_pages=POOL)
    rng = np.random.default_rng(9)
    pager = RoomPager(rooms=POOL, tracks=T_MAX, subs=S_MAX, tpage=TP, spage=SP,
                      pool_pages=POOL)
    admitted: list[int] = []
    misses = 0
    while misses < 5:
        p = _sample_room(rng)
        try:
            pager.alloc_room(len(admitted), tracks=p, subs=p)
        except CapacityError:
            misses += 1
            continue
        admitted.append(len(admitted))

    def snap():
        up = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
        table = paged.PageTable(rooms_pages=up(pager.rooms_pages), tmembers=up(pager.tmembers),
                                pg_room=up(pager.pg_room), pg_tp=up(pager.pg_tp),
                                pg_sp=up(pager.pg_sp))
        rows, inv, n_live = paged.live_rows_of(pager.pg_room)
        return table, up(rows), up(inv), n_live

    inputs = [_page_inputs(POOL, TP, K, SP, s, dev) for s in range(6)]

    def time_ticks(tick) -> float:
        st = plane.init_state(dims.pooled(), device=dev)
        tick(st, inputs[0])                      # first launches at these shapes
        times = []
        for inp in inputs[1:]:
            times.append(_ms(lambda: tick(st, inp), dev, 1))
        return round(float(np.mean(times)), 3)

    table_f, rows_f, inv_f, live_f = snap()
    ms_full = time_ticks(lambda s, i: paged.paged_plane_tick_fused(s, i, table_f, rows_f, inv_f))
    for r in admitted[::2]:
        pager.release_room(r)
    table_h, rows_h, inv_h, live_h = snap()
    ms_half = time_ticks(lambda s, i: paged.paged_plane_tick_fused(s, i, table_h, rows_h, inv_h))
    ms_stock = time_ticks(lambda s, i: paged.paged_plane_tick(s, i, table_f))
    return {
        "distribution": ROOM_MIX,
        "mode": "cuda" if dev.type == "cuda" else "cpu_plain",
        "pool_pages": POOL,
        "live_pages_full": int(live_f),
        "grid_steps_full": int(rows_f.numel()),
        "tick_ms_full": ms_full,
        "live_pages_half": int(live_h),
        "grid_steps_half": int(rows_h.numel()),
        "tick_ms_half": ms_half,
        "stock_tick_ms": ms_stock,
        "half_over_full_work_ratio": round(ms_half / max(ms_full, 1e-9), 3),
    }


# -- audio mix sections -------------------------------------------------------


def _ms(fn, dev: torch.device, reps: int) -> float:
    """One call's time: CUDA events on the card, the host clock on the CPU."""
    return event_ms(fn, reps) if dev.type == "cuda" else wall_ms(fn, reps)


def audio_mix_bench(device="cuda", trials: int = 16) -> float:
    """G.711 decode + active-speaker mix + µ-law re-encode of one 20 ms
    frame at 1 room × 50 participants, every subscriber mixed; mean ms
    over `trials` frames of fresh payloads."""
    from livekit_server_tpu_torch.ops import mix as mix_ops

    dev = resolve(device)
    R, T, S, N = 1, 50, 50, 960
    rng = np.random.default_rng(2)
    t = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt)).to(dev)  # noqa: E731

    def args():
        return (t(rng.integers(0, 256, (R, T, N)), np.uint8),
                torch.zeros((R, T), dtype=torch.int32, device=dev),
                t(rng.random((R, T)), np.float32), t(rng.random((R, T)) < 0.5, bool),
                t(np.arange(S)[None, :] % T, np.int32),
                torch.ones((R, T), dtype=torch.float32, device=dev))

    def step(payload, codec, level, active, sub_track, gain):
        pcm = mix_ops.decode_tick(payload, codec)
        return mix_ops.encode_ulaw(mix_ops.mix_tick(pcm, level, active, sub_track, gain))

    frames = [args() for _ in range(trials + 1)]
    step(*frames[0])
    return round(float(np.mean([_ms(lambda a=a: step(*a), dev, 1) for a in frames[1:]])), 3)


def audio_mix_1kroom_bench(device="cuda", trials: int = 8) -> float:
    """runtime/mixer.py `_device_mix` (presence & self-exclusion, one
    batched matmul) at 1000 rooms × 4 tracks × 4 subscribers × 960
    samples; mean ms over `trials` frames of fresh PCM."""
    from livekit_server_tpu_torch.runtime.mixer import _device_mix

    dev = resolve(device)
    R, T, S, N = 1000, 4, 4, 960
    rng = np.random.default_rng(3)
    t = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt)).to(dev)  # noqa: E731
    frames = [(t(rng.integers(-32768, 32768, (R, T, N)), np.float32),
               t(rng.random((R, T)) < 0.8, bool),
               t(rng.integers(0, T + 1, (R, S)), np.int32)) for _ in range(trials + 1)]
    _device_mix(*frames[0])
    return round(float(np.mean([_ms(lambda a=a: _device_mix(*a), dev, 1)
                                for a in frames[1:]])), 3)
