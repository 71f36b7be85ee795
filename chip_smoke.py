#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (livekit_server_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero; about two minutes on an H100):

  1. build    — compile every CUDA kernel with nvcc (one process per
                source, in parallel); print each kernel's registers and
                spills (ptxas -v) and the card's name and power limit;
  2. parity   — each dense-tick kernel against its plain PyTorch version on
                the card, seeded inputs, at PlaneDims(4, 4, 8, 40),
                (1024, 10, 8, 10) and (10240, 8, 16, 50); then the live-page
                kernel (decide_pages, mix_pages, decide_mix_pages, mix
                blocks of MIX_N samples) at page geometries (P, TP, K, SP)
                (16, 2, 4, 4) with padded duplicate live rows, (64, 8, 8,
                32) (mask bit 31) and the full 65536-page pool of
                PAGED_TIMING_DIMS filled from the room-size mix; integers,
                bools and floats (the float32 budget, the mix) must be equal
                bit for bit; at the full pool, the mix entries' device time
                (a CUDA graph of MIX_GRAPH_LAUNCHES kernel launches) and
                call time beside their byte bounds;
  3. runtime  — a PlaneRuntime at PlaneDims(1024, 10, 8, 10) (1k rooms ×
                10 participants, 2 VP9-SVC video + 2 Opus tracks per room)
                fed RUNTIME_TICKS ticks of seeded traffic through
                IngestBuffer.push_batch; forwarded packets must be > 0,
                each dense kernel's launch count must equal the tick count,
                and the first CHECK_TICKS ticks of rooms 0..7 must equal a
                CPU run of the port at PlaneDims(8, 10, 8, 10) fed the same
                packets (integers exact; floats within
                plane.float_tolerance of each leaf);
  4. paged    — a PagedPlaneRuntime (live-extent tick, kernel on) at
     runtime    PAGED_RUNTIME_DIMS, rooms admitted from bench.py's size mix
                (80 % 2–4, 15 % 5–10, 5 % 50 participants; each publishes
                one track, the first two VP9-SVC video, and subscribes to
                all others) until the pool refuses, PAGED_TICKS ticks, every
                other room released and the pool compacted at
                PAGED_RELEASE_TICK; forwarded packets > 0, the launch counts
                as stated in `paged_runtime_phase`, and the first
                CHECK_TICKS ticks of rooms 0..7 equal to a CPU
                PagedPlaneRuntime in LOGICAL form;
  5. timing   — the dense runtime's device step (plane.device_tick: upload,
                tick, fetch) at the north-star PlaneDims(10240, 8, 16, 50),
                median and p90 of TIMED_TICKS ticks after warm-up; the paged
                runtime's live-extent device step (paged.live_step) at
                PAGED_TIMING_DIMS at full occupancy and after releasing half
                the rooms; each kernel's own time beside its byte bound and
                its plain version's time, at every launch shape of each
                path: decide_rooms and allocate_budget_rooms on the
                north-star tick's operands, paged_kernel on a live step's
                at full and at half occupancy (65536 and 32768 grid steps),
                allocate_budget_rooms ([65536, 8, 64]) on the full-pool
                live step's (each first held equal to its plain version), and
                decide_rooms and allocate_budget_rooms at the dead-page
                key's one-page shape (each first held equal to its plain
                version). A
                kernel's `ms` is device time: a
                CUDA graph of GRAPH_LAUNCHES launches of the wrapper, inputs
                captured from a real tick, replayed between a CUDA event
                pair, so the wrapper's host work (checks, allocation, the
                ctypes call) is not in it; `call_ms` is one wrapper call
                between an event pair, host work included.

Output: JSON lines per phase, a `{"kernels": [...]}` JSON line (each
kernel's numbers on its own path, its ptxas registers and spill bytes,
and under `paths` its launch shape, launches, device, call and plain
times and bound on each path that launches it — paged_kernel's
half-occupancy launch under `half` and its mix entries under `mix`;
paged_kernel's `ms` is its launch alone and `wrapper_ms` the whole
decide_pages call, whose gathers of the selector targets are torch ops),
the card line from nvidia-smi, and as the last line
`{"ok": true, "device": {...}}`.
`--profile` adds torch.profiler breakdowns (device time by kernel) of a
few north-star dense ticks and a few full-pool paged steps.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from livekit_server_tpu_torch.models import paged, plane, synth
from livekit_server_tpu_torch.ops import allocation, cuda, pacer, paged_kernel, selector
from livekit_server_tpu_torch.ops.mix import MIX_TOP_K
from livekit_server_tpu_torch.runtime import PlaneRuntime
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime
from livekit_server_tpu_torch.runtime.pager import RoomPager
from livekit_server_tpu_torch.runtime.slots import CapacityError

SEED = 7
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (NVIDIA data sheet)
PARITY_SHAPES = (
    plane.PlaneDims(4, 4, 8, 40),
    plane.PlaneDims(1024, 10, 8, 10),
    plane.PlaneDims(10240, 8, 16, 50),
)
RUNTIME_DIMS = plane.PlaneDims(1024, 10, 8, 10)
RUNTIME_SPEC = synth.TrafficSpec(video_tracks=2, audio_tracks=2, tick_ms=20,
                                 video_kbps=1500, svc=True)
RUNTIME_TICKS = 40
CHECK_TICKS = 5
CHECK_ROOMS = 8
NORTH_STAR = plane.PlaneDims(10240, 8, 16, 50)
NORTH_STAR_SPEC = synth.TrafficSpec(video_tracks=2, audio_tracks=6, tick_ms=20,
                                    video_kbps=1500, svc=True)
TIMED_TICKS = 100
WARMUP_TICKS = 5
KERNEL_REPS = 50
GRAPH_LAUNCHES = 20
MIX_GRAPH_LAUNCHES = 3             # the mix writes 2 GB a launch at the full pool
PLAIN_REPS = 5

KERNELS = {
    "decide_rooms": dict(
        source="livekit_server_tpu_torch/csrc/decide_rooms.cu",
        replaces="livekit_server_tpu/ops/selector.py:213",
    ),
    "allocate_budget_rooms": dict(
        source="livekit_server_tpu_torch/csrc/budget_rooms.cu",
        replaces="livekit_server_tpu/ops/allocation.py:174",
    ),
    "paged_kernel": dict(
        source="livekit_server_tpu_torch/csrc/paged_kernel.cu",
        replaces="livekit_server_tpu/ops/paged_kernel.py:82",
    ),
}

# Paged plane (the live-extent tick). Page geometries (P, TP, K, SP) of the
# kernel parity phase; the full-width pool of PAGED_TIMING_DIMS is added to
# them. SP=32 sets mask bit 31.
PAGE_GEOMS = ((16, 2, 4, 4), (64, 8, 8, 32))
MIX_N = 960                        # 20 ms of 48 kHz audio per mix block
PAGED_RUNTIME_DIMS = paged.PagedDims(rooms=2048, tracks=64, pkts=8, subs=64,
                                     tpage=4, spage=8, pool_pages=8192)
PAGED_TIMING_DIMS = paged.PagedDims(rooms=16384, tracks=64, pkts=8, subs=64,
                                    tpage=4, spage=8, pool_pages=65536)
# Up to 2 VP9-SVC video tracks per room, the rest Opus; participant t
# publishes track t. Rooms use only their first `size` tracks.
PAGED_SPEC = synth.TrafficSpec(video_tracks=2, audio_tracks=62, tick_ms=20,
                               video_kbps=1500, svc=True)
PAGED_TICKS = 40
PAGED_RELEASE_TICK = 20
PAGED_TIMED_TICKS = 30
ROOM_MIX_SEED = 9


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def ptxas_report(text: str) -> dict:
    """Registers a thread and spill bytes (stores + loads) of the kernel in
    one library's nvcc -Xptxas -v output (each library holds one kernel)."""
    regs = re.findall(r"Used (\d+) registers", text)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
    return {"registers": int(regs[-1]) if regs else None,
            "spill_bytes": sum(int(a) + int(b) for a, b in spills) if spills else None}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Seeded kernel inputs
# ---------------------------------------------------------------------------


def decide_args(dims: plane.PlaneDims, rng, dev):
    R, T, K, S = dims
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    b = lambda p, shape: torch.from_numpy(rng.random(shape) < p).to(dev)  # noqa: E731
    state = selector.SelectorState(
        i32(rng.integers(-1, 3, (R, T, S))), i32(rng.integers(-1, 4, (R, T, S))),
        i32(rng.integers(-1, 3, (R, T, S))), i32(rng.integers(0, 4, (R, T, S))),
    )
    pkt = (i32(rng.integers(0, 3, (R, T, K))), i32(rng.integers(0, 4, (R, T, K))),
           b(0.3, (R, T, K)), b(0.5, (R, T, K)), b(0.4, (R, T, K)),
           b(0.9, (R, T, K)), i32(rng.integers(40, 1300, (R, T, K))))
    return (state, b(0.5, (R, T)), b(0.6, (R, T)), b(0.7, (R, T, S)), *pkt)


def alloc_args(dims: plane.PlaneDims, rng, dev):
    R, T, K, S = dims
    bit = (rng.random((R, T, 4, 4)) * 2e6 * (rng.random((R, T, 4, 4)) > 0.3))
    t = lambda a, dt: torch.from_numpy(a.astype(dt)).to(dev)  # noqa: E731
    return (t(bit, np.float32), t(rng.integers(-1, 4, (R, S, T)), np.int32),
            t(rng.integers(-1, 4, (R, S, T)), np.int32),
            torch.from_numpy(rng.random((R, S, T)) < 0.2).to(dev),
            t(rng.random((R, S)) * 8e6, np.float32))


def tree_equal(a, b) -> tuple[bool, float]:
    """Exact equality of two trees of tensors, and the largest absolute
    difference of their float leaves."""
    ok, err = True, 0.0
    for x, y in zip(plane.tree_leaves(a), plane.tree_leaves(b)):
        ok &= x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        if x.is_floating_point() and x.shape == y.shape:
            err = max(err, float((x - y).abs().max()) if x.numel() else 0.0)
    return ok, err


def parity_phase(dev) -> dict:
    rng = np.random.default_rng(SEED)
    errs = dict.fromkeys(KERNELS, 0.0)
    for dims in PARITY_SHAPES:
        args = decide_args(dims, rng, dev)
        ok, err = tree_equal(
            selector.decide_rooms(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES),
            selector.decide_rooms_plain(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES),
        )
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError(f"decide_rooms kernel != plain at {tuple(dims)}")
        errs["decide_rooms"] = max(errs["decide_rooms"], err)
        del args
        args = alloc_args(dims, rng, dev)
        ok, err = tree_equal(allocation.allocate_budget_rooms(*args),
                             allocation.allocate_budget_rooms_plain(*args))
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError(f"allocate_budget_rooms kernel != plain at {tuple(dims)}")
        errs["allocate_budget_rooms"] = max(errs["allocate_budget_rooms"], err)
        del args
        torch.cuda.empty_cache()
        log(f"parity ok at {tuple(dims)}")
    return errs


# ---------------------------------------------------------------------------
# Runtime on the card
# ---------------------------------------------------------------------------


def setup_rooms(rt: PlaneRuntime, spec: synth.TrafficSpec) -> None:
    """Publish the spec's tracks in every room (participant t publishes
    track t) and subscribe every participant to all of them."""
    R, T, _, S = rt.dims
    nv = min(spec.video_tracks, T)
    used = min(nv + spec.audio_tracks, T)
    for r in range(R):
        for t in range(used):
            rt.set_track(r, t, published=True, is_video=t < nv,
                         is_svc=spec.svc and t < nv, pub_sub=t % S)
            for s in range(S):
                rt.set_subscription(r, t, s, subscribed=True)


def synth_packets(inp: plane.TickInputs, rng) -> dict:
    """One synth tick → push_batch arguments (valid packets in (room,
    track, k) order, with random payload bytes of the packets' sizes)."""
    r, t, k = np.nonzero(inp.valid)
    at = lambda f: np.asarray(getattr(inp, f))[r, t, k]  # noqa: E731
    size = at("size").astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(size)[:-1]]).astype(np.int64)
    return dict(
        room=r.astype(np.int64), track=t.astype(np.int64), layer=at("layer"),
        sn=at("sn"), ts=at("ts"), ts_aligned=at("ts_jump") < 0,
        temporal=at("temporal"), keyframe=at("keyframe"),
        layer_sync=at("layer_sync"), begin_pic=at("begin_pic"),
        marker=at("end_frame"), pid=at("pid"), tl0=at("tl0"),
        keyidx=at("keyidx"), size=at("size"), frame_ms=at("frame_ms"),
        audio_level=at("audio_level"), arrival_rtp=at("arrival_rtp"),
        pay_start=starts, pay_length=size,
        blob=rng.integers(0, 256, int(size.sum()), dtype=np.uint8),
    )


def rooms_below(batch: dict, n: int) -> dict:
    keep = batch["room"] < n
    out = {k: v[keep] for k, v in batch.items() if k != "blob"}
    out["blob"] = batch["blob"]
    return out


def push(rt: PlaneRuntime, batch: dict, estimate: np.ndarray) -> None:
    rt.ingest.push_batch(**batch)
    for r in range(min(rt.dims.rooms, estimate.shape[0])):
        for s in range(rt.dims.subs):
            rt.ingest.push_feedback(r, s, estimate=float(estimate[r, s]))


def compare_outputs(got: plane.TickOutputs, want: plane.TickOutputs, n: int, tick: int,
                    worst: dict) -> None:
    """GPU rows 0..n-1 against the CPU run: integers and bools equal,
    floats within the leaf's bound; `worst` keeps each float leaf's
    largest absolute difference."""
    for name, g, w in zip(plane.TickOutputs._fields, got, want):
        g = np.asarray(g)[:n]
        if g.dtype.kind == "f":
            err = float(np.abs(g.astype(np.float64) - w).max(initial=0.0))
            worst[name] = max(worst.get(name, 0.0), err)
            rtol, atol = plane.float_tolerance(name)
            if not np.allclose(g, w, rtol=rtol, atol=atol):
                raise AssertionError(f"tick {tick}: {name} GPU vs CPU beyond "
                                     f"rtol={rtol} atol={atol} (max abs err {err})")
        elif not np.array_equal(g, w):
            raise AssertionError(f"tick {tick}: {name} GPU != CPU")


def compare_egress(got, want, n: int, tick: int) -> None:
    keep = got.rooms < n
    for col in ("rooms", "tracks", "ks", "subs", "sn", "ts", "pid", "tl0", "keyidx"):
        if not np.array_equal(getattr(got, col)[keep], getattr(want, col)):
            raise AssertionError(f"tick {tick}: egress column {col} GPU != CPU")


async def runtime_phase(dev) -> dict:
    spec, dims = RUNTIME_SPEC, RUNTIME_DIMS
    rt = PlaneRuntime(dims, tick_ms=spec.tick_ms, device=dev)
    ref = PlaneRuntime(plane.PlaneDims(CHECK_ROOMS, *dims[1:]), tick_ms=spec.tick_ms,
                       device="cpu")
    setup_rooms(rt, spec)
    setup_rooms(ref, spec)
    rng = np.random.default_rng(SEED)
    traffic = synth.init_traffic(dims, spec, seed=SEED)
    batches = []
    for i in range(RUNTIME_TICKS):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=SEED)
        batches.append((synth_packets(inp, rng), np.asarray(inp.estimate)))

    fwd = 0
    tick_s = []
    worst: dict[str, float] = {}
    cuda.reset_launches()
    for i, (batch, estimate) in enumerate(batches):
        push(rt, batch, estimate)
        t0 = time.perf_counter()
        res = await rt.step_once()
        tick_s.append(time.perf_counter() - t0)
        fwd += res.fwd_packets
        if i < CHECK_TICKS:
            push(ref, rooms_below(batch, CHECK_ROOMS), estimate)
            want = await ref.step_once()
            compare_outputs(res.outputs, want.outputs, CHECK_ROOMS, i, worst)
            compare_egress(res.egress_batch, want.egress_batch, CHECK_ROOMS, i)
    launches = dict(cuda.launches)

    if fwd <= 0:
        raise AssertionError("runtime forwarded no packets")
    expected = {"decide_rooms": RUNTIME_TICKS, "allocate_budget_rooms": RUNTIME_TICKS,
                "paged_kernel": 0}
    if launches != expected:
        raise AssertionError(f"dense runtime launches {launches}, expected {expected}")
    log(f"runtime ok: {RUNTIME_TICKS} ticks at {tuple(dims)}, {fwd} packets "
        f"forwarded, launches {launches}, step_once median "
        f"{statistics.median(tick_s) * 1e3:.3f} ms (host stage + device + fan-out)")
    print(json.dumps({"runtime_gpu_vs_cpu_max_abs_err": worst}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# North-star timing
# ---------------------------------------------------------------------------


def capture_calls(wrappers, fn):
    """Call fn() with each (module, name) wrapper wrapped, recording the
    arguments, keywords and result of its last call. Returns (fn's result,
    {name: (args, kwargs, result)})."""
    seen = {}
    originals = [(mod, name, getattr(mod, name)) for mod, name in wrappers]

    def wrap(name, f):
        def g(*a, **kw):
            res = f(*a, **kw)
            seen[name] = (a, kw, res)
            return res
        return g

    for mod, name, f in originals:
        setattr(mod, name, wrap(name, f))
    try:
        out = fn()
    finally:
        for mod, name, f in originals:
            setattr(mod, name, f)
    return out, seen


def capture_kernel_args(state, wire, dims):
    """Run one dense tick with the two kernel wrappers wrapped, recording
    the arguments and results the main path hands them."""
    (state, _), seen = capture_calls(
        [(selector, "decide_rooms"), (allocation, "allocate_budget_rooms")],
        lambda: plane.device_tick(state, wire, dims))
    return state, seen


def nbytes(*trees) -> int:
    return sum(x.numel() * x.element_size() for t in trees for x in plane.tree_leaves(t))


def decide_rooms_bytes(a, res) -> int:
    """Bytes one decide_rooms call must move: its operands (the selector
    state's four leaves) in, its outputs (the new state's current layers)
    out."""
    st = a[0]
    return nbytes(a[1:], (st.current_spatial, st.current_temporal, st.target_spatial,
                          st.target_temporal),
                  res[1:], (res[0].current_spatial, res[0].current_temporal))


def decide_pages_bytes(a, res) -> int:
    """Bytes one decide_pages call must move: each live page's slice of
    every operand and the live-row index in, the outputs out."""
    sel, is_svc, is_video, base, inp, rows = a[:6]
    P = base.shape[0]
    per_page = sum(x.element_size() * x.numel() // P for x in (
        *sel, is_svc, is_video, base,
        *(getattr(inp, f) for f in ("layer", "temporal", "keyframe", "layer_sync",
                                    "end_frame", "valid", "size", "sn", "ts",
                                    "arrival_rtp", "begin_pic"))))
    out_bytes = nbytes(res.send_bits, res.drop_bits, res.switch_bits, res.sel.current_spatial,
                       res.sel.current_temporal, res.need_kf, res.pkts_sent, res.sent_bytes,
                       res.fwd_packets, res.fwd_bytes, res.st, res.tr)
    return per_page * rows.numel() + rows.numel() * rows.element_size() + out_bytes


def mix_pages_bytes(mix, rows) -> int:
    """Bytes one mix_pages launch must move: each live page's slice of
    every mix operand and the live-row index in, the [NL, SP, N] mix out."""
    pcm, sub_track = mix[0], mix[3]
    P, nl = pcm.shape[0], rows.numel()
    return (sum(x.element_size() * x.numel() // P for x in mix) * nl
            + nl * rows.element_size() + nl * sub_track.shape[1] * pcm.shape[2] * 4)


def event_ms(fn, reps: int) -> float:
    """Median over `reps` calls of fn, each between a CUDA event pair."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps: int, launches: int = GRAPH_LAUNCHES) -> float:
    """Device time of one call of fn: `launches` calls captured in a CUDA
    graph, the graph replayed `reps` times between CUDA event pairs; the
    median replay over `launches`. Host work in fn runs once, at capture,
    and is not timed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                   # load the module outside capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return event_ms(graph.replay, reps) / launches


def north_star_setup(dev):
    """The north-star dense state and four ticks of seeded wires."""
    dims, spec = NORTH_STAR, NORTH_STAR_SPEC
    state = synth.make_state(dims, spec, device=dev)
    traffic = synth.init_traffic(dims, spec, seed=SEED)
    wires = []
    for i in range(4):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=SEED)
        wires.append(plane.wire_inputs(plane.pack_tick_inputs(inp)))
    return state, wires


def timing_phase(dev, profile: bool) -> tuple[dict, dict]:
    dims = NORTH_STAR
    state, wires = north_star_setup(dev)
    for i in range(WARMUP_TICKS):
        state, _ = plane.device_tick(state, wires[i % len(wires)], dims)
    times = []
    for i in range(TIMED_TICKS):
        t0 = time.perf_counter()
        state, out = plane.device_tick(state, wires[i % len(wires)], dims)
        times.append(time.perf_counter() - t0)
    times_ms = sorted(t * 1e3 for t in times)
    tick = {
        "dims": list(dims), "ticks": TIMED_TICKS,
        "median_ms": statistics.median(times_ms),
        "p90_ms": times_ms[int(0.9 * len(times_ms)) - 1],
        "fwd_packets_last_tick": int(out.fwd_packets.sum()),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }

    state, seen = capture_kernel_args(state, wires[0], dims)
    a, kw, res = seen["decide_rooms"]
    dec = time_kernel(selector.decide_rooms, selector.decide_rooms_plain, a, kw,
                      decide_rooms_bytes(a, res))
    dec["shape"] = list(dims)
    a2, kw2, res2 = seen["allocate_budget_rooms"]
    al = time_kernel(allocation.allocate_budget_rooms, allocation.allocate_budget_rooms_plain,
                     a2, kw2, nbytes(a2, res2))
    al["shape"] = list(a2[1].shape)
    if profile:
        profile_ticks(state, wires, dims)
    return tick, {"decide_rooms": dec, "allocate_budget_rooms": al}


def time_kernel(kernel, plain, a, kw, bytes_moved: int) -> dict:
    """A wrapper's device time (`graph_ms`), call time and its plain
    version's time on the captured operands, beside its byte bound."""
    return {
        "ms": graph_ms(lambda: kernel(*a, **kw), KERNEL_REPS),
        "call_ms": event_ms(lambda: kernel(*a, **kw), KERNEL_REPS),
        "plain_ms": event_ms(lambda: plain(*a, **kw), PLAIN_REPS),
        "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3, "bytes": bytes_moved,
    }


def profile_ticks(state, wires, dims) -> None:
    def step(i):
        nonlocal state
        state, _ = plane.device_tick(state, wires[i % len(wires)], dims)

    profile_steps(step)


def profile_steps(step) -> None:
    """torch.profiler table (device time by kernel) of 5 calls step(i)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            step(i)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), flush=True)


# ---------------------------------------------------------------------------
# Paged plane: kernel parity, the paged runtime, live-extent timing
# ---------------------------------------------------------------------------


def sample_room_size(rng) -> int:
    """Participants of one room, from bench.py's paged_kernel room-size
    mix: 80 % 2–4, 15 % 5–10, 5 % 50."""
    u = rng.random()
    if u < 0.80:
        return int(rng.integers(2, 5))
    if u < 0.95:
        return int(rng.integers(5, 11))
    return 50


def admit_rooms(pager: RoomPager, limit: int | None = None) -> list[int]:
    """Claim page grids for rooms drawn from the size mix (seed
    ROOM_MIX_SEED) until the pool refuses five requests or `limit` rooms
    (default: every row) are in. Room i sits on row i; returns the rooms'
    sizes."""
    rng = np.random.default_rng(ROOM_MIX_SEED)
    limit = pager.num_rooms if limit is None else limit
    sizes: list[int] = []
    misses = 0
    while misses < 5 and len(sizes) < limit:
        p = sample_room_size(rng)
        try:
            pager.alloc_room(len(sizes), tracks=p, subs=p)
        except CapacityError:
            misses += 1
            continue
        sizes.append(p)
    return sizes


def live_tables(pager: RoomPager, dev):
    """`paged.live_rows_of` the pager's current table, on the card."""
    rows, inv, n = paged.live_rows_of(pager.pg_room)
    return torch.from_numpy(rows).to(dev), torch.from_numpy(inv).to(dev), n


def page_args(page, rng, dev, rows=None, mix_n=MIX_N):
    """Seeded pooled operands of the live-page kernel at page geometry
    (P, TP, K, SP): decide operands, mix operands (three equal levels at
    the top-K boundary) and live_rows (half the pool, padded with a
    duplicate to a power of two, unless given)."""
    P, TP, K, SP = page
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    b = lambda p, shape: torch.from_numpy(rng.random(shape) < p).to(dev)  # noqa: E731
    state = selector.SelectorState(
        i32(rng.integers(-1, 3, (P, TP, SP))), i32(rng.integers(-1, 4, (P, TP, SP))),
        i32(rng.integers(-1, 3, (P, TP, SP))), i32(rng.integers(0, 4, (P, TP, SP))))
    pk = lambda lo, hi: i32(rng.integers(lo, hi, (P, TP, K)))  # noqa: E731
    inp = plane.TickInputs(**dict.fromkeys(plane.TickInputs._fields))._replace(
        layer=pk(-1, 4), temporal=pk(0, 4), keyframe=b(0.3, (P, TP, K)),
        layer_sync=b(0.5, (P, TP, K)), end_frame=b(0.4, (P, TP, K)),
        valid=b(0.85, (P, TP, K)), size=pk(40, 1300), sn=pk(0, 65536),
        ts=i32(rng.integers(-2**31, 2**31, (P, TP, K), dtype=np.int64)),
        arrival_rtp=pk(0, 1 << 30), begin_pic=b(0.4, (P, TP, K)))
    decide = (state, b(0.4, (P, TP)), b(0.6, (P, TP)), b(0.7, (P, TP, SP)), inp)
    level = rng.random((P, TP)).astype(np.float32)
    level[:, : min(3, TP)] = level[:, -1:]
    mix = (torch.from_numpy(rng.standard_normal((P, TP, mix_n), np.float32) * 0.3).to(dev),
           torch.from_numpy(level).to(dev), b(0.7, (P, TP)),
           i32(rng.integers(-1, TP, (P, SP))),
           torch.from_numpy(rng.uniform(0.5, 1.5, (P, TP)).astype(np.float32)).to(dev))
    if rows is None:
        n = P // 2 + 1
        live = rng.choice(P, n, replace=False)
        nl = 1 << (n - 1).bit_length()
        rows = i32(np.concatenate([live, np.repeat(live[:1], nl - n)]))
    return decide, mix, rows


def full_pool_rows(dev):
    """The live rows of the PAGED_TIMING_DIMS pool filled from the size
    mix, on the card, and the live page count."""
    d = PAGED_TIMING_DIMS
    pager = RoomPager(d.rooms, d.tracks, d.subs, tpage=d.tpage, spage=d.spage,
                      pool_pages=d.pool_pages)
    admit_rooms(pager)
    rows, _, n_live = live_tables(pager, dev)
    return rows, n_live


def decide_launch(sel_state, is_svc, is_video, base, inp, rows, **kw):
    """decide_pages' kernel launch alone: its outputs as one tuple, without
    the wrapper's gathers of the live rows' selector targets."""
    decided, _ = paged_kernel._launch(rows, (sel_state, is_svc, is_video, base, inp), None,
                                      top_k=0, **kw)
    return tuple(decided)


def mix_launch(mix, rows):
    """mix_pages' kernel launch alone (the wrapper's tanh is another op)."""
    return paged_kernel._launch(rows, None, mix, wire_overhead=0, top_k=MIX_TOP_K)[1]


def decide_mix_launch(decide, mix, rows, kw):
    """decide_mix_pages' kernel launch alone: its outputs as one tuple."""
    decided, mixed = paged_kernel._launch(rows, decide, mix, top_k=MIX_TOP_K, **kw)
    return (*decided, mixed)


def paged_parity_phase(dev) -> tuple[float, dict]:
    """decide_pages, mix_pages and decide_mix_pages against their plain
    versions at each page geometry; every output equal, the float32 mix
    included. Returns the largest absolute difference seen (0 when exact)
    and, at the full-width pool, the mix entries' device and call times
    beside their byte bounds and the mix's plain version's time."""
    rng = np.random.default_rng(SEED)
    full_rows, n_live = full_pool_rows(dev)
    d = PAGED_TIMING_DIMS
    geoms = [(g, None) for g in PAGE_GEOMS] + [((d.pool_pages, d.tpage, d.pkts, d.spage),
                                                full_rows)]
    kw = dict(wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    err = 0.0
    for page, rows in geoms:
        decide, mix, rows = page_args(page, rng, dev, rows)
        checks = (
            ("decide_pages", paged_kernel.decide_pages(*decide, rows, **kw),
             paged_kernel.decide_pages_plain(*decide, rows, **kw)),
            ("mix_pages", paged_kernel.mix_pages(*mix, rows),
             paged_kernel.mix_pages_plain(*mix, rows)),
            ("decide_mix_pages", paged_kernel.decide_mix_pages(*decide, *mix, rows, **kw),
             (paged_kernel.decide_pages_plain(*decide, rows, **kw),
              paged_kernel.mix_pages_plain(*mix, rows))),
        )
        torch.cuda.synchronize()
        for name, got, want in checks:
            ok, e = tree_equal(got, want)
            if not ok:
                raise AssertionError(f"{name} kernel != plain at page geometry {page}")
            err = max(err, e)
        del checks
        log(f"paged parity ok at page geometry {page}, {rows.numel()} grid steps")
    log(f"full-width pool: {n_live} live pages of {d.pool_pages}")
    # The mix writes [NL, SP, N] float32 (2 GB at the full pool): its device
    # time is a graph of MIX_GRAPH_LAUNCHES kernel launches; the call times
    # are the wrappers' (the tanh included).
    mix_bytes = mix_pages_bytes(mix, rows)
    decide_bytes = decide_pages_bytes((*decide, rows),
                                      paged_kernel.decide_pages(*decide, rows, **kw))
    mix_t = {
        "mix_ms": graph_ms(lambda: mix_launch(mix, rows), KERNEL_REPS, MIX_GRAPH_LAUNCHES),
        "decide_mix_ms": graph_ms(lambda: decide_mix_launch(decide, mix, rows, kw), KERNEL_REPS,
                                  MIX_GRAPH_LAUNCHES),
        "mix_call_ms": event_ms(lambda: paged_kernel.mix_pages(*mix, rows), KERNEL_REPS),
        "decide_mix_call_ms": event_ms(
            lambda: paged_kernel.decide_mix_pages(*decide, *mix, rows, **kw), KERNEL_REPS),
        "mix_plain_ms": event_ms(lambda: paged_kernel.mix_pages_plain(*mix, rows), PLAIN_REPS),
        "mix_bound_ms": mix_bytes / HBM_BYTES_PER_S * 1e3, "mix_bytes": mix_bytes,
        "decide_mix_bound_ms": (mix_bytes + decide_bytes) / HBM_BYTES_PER_S * 1e3,
        "grid": int(rows.numel()),
    }
    del decide, mix
    torch.cuda.empty_cache()
    return err, mix_t


def mask_to_rooms(inp: plane.TickInputs, sizes: np.ndarray) -> plane.TickInputs:
    """Keep the packets of each room's own tracks (track t < its size)."""
    t = np.arange(inp.valid.shape[1])
    return inp._replace(valid=inp.valid & (t[None, :, None] < sizes[:, None, None]))


def setup_paged_room(rt: PagedPlaneRuntime, row: int, size: int) -> None:
    """Room `row` with `size` participants: participant t publishes track
    t (the first two VP9-SVC video, the rest Opus) and subscribes to
    every other track. Its page grid was claimed at the full size."""
    slots = rt.slots.alloc_room(f"room{row}")
    assert slots.row == row
    for t in range(size):
        slots.alloc_track(f"t{t}")
        slots.alloc_sub(f"p{t}")
    for t in range(size):
        video = t < PAGED_SPEC.video_tracks
        rt.set_track(row, t, published=True, is_video=video, is_svc=video, pub_sub=t)
        for s in range(size):
            if s != t:
                rt.set_subscription(row, t, s, subscribed=True)


def push_paged(rt, batch: dict, estimate: np.ndarray, sizes) -> None:
    rt.ingest.push_batch(**batch)
    for r, size in enumerate(sizes):
        for s in range(size):
            rt.ingest.push_feedback(r, s, estimate=float(estimate[r, s]))


async def paged_runtime_phase(dev) -> dict:
    """PAGED_TICKS ticks of a PagedPlaneRuntime (live-extent tick, kernel
    on) over rooms admitted from the size mix; every other room is
    released and the pool compacted at PAGED_RELEASE_TICK. Checks
    forwarding, the launch counts, and the first CHECK_TICKS ticks of
    rooms 0..CHECK_ROOMS-1 against a CPU PagedPlaneRuntime in LOGICAL
    form. Returns the launch counts."""
    dims, spec = PAGED_RUNTIME_DIMS, PAGED_SPEC
    rt = PagedPlaneRuntime(dims, tick_ms=spec.tick_ms, device=dev, paged_kernel="on")
    sizes = admit_rooms(rt.pager)
    ref_sizes = sizes[:CHECK_ROOMS]
    ref = PagedPlaneRuntime(dims._replace(rooms=CHECK_ROOMS), tick_ms=spec.tick_ms,
                            device="cpu", paged_kernel="on")
    if admit_rooms(ref.pager, CHECK_ROOMS) != ref_sizes:
        raise AssertionError("reference admission differs")
    for r, size in enumerate(sizes):
        setup_paged_room(rt, r, size)
    for r, size in enumerate(ref_sizes):
        setup_paged_room(ref, r, size)
    live_pages = rt.pager.pages_mapped
    log(f"paged runtime: {len(sizes)} rooms admitted, {live_pages} live pages of "
        f"{dims.pool_pages}")

    rng = np.random.default_rng(SEED)
    logical = plane.PlaneDims(dims.rooms, dims.tracks, dims.pkts, dims.subs)
    room_sizes = np.zeros(dims.rooms, np.int64)
    room_sizes[:len(sizes)] = sizes
    traffic = synth.init_traffic(logical, spec, seed=SEED)
    fwd = 0
    live_ticks = 0
    worst: dict[str, float] = {}
    tick_s = []
    # Count the card's dead-page computations (misses of the cache in
    # front of `paged.dead_page_outputs`).
    dead_on_card = []
    fresh = paged.dead_page_outputs

    def counted(*a, **kw):
        out = fresh(*a, **kw)
        dead_on_card.extend([1] if out.fwd_packets.device.type == "cuda" else [])
        return out

    paged.dead_page_outputs = counted
    paged.dead_page_outputs_cached.cache_clear()
    cuda.reset_launches()
    for i in range(PAGED_TICKS):
        if i == PAGED_RELEASE_TICK:
            for r in range(1, len(sizes), 2):
                rt.clear_room(r)
                rt.slots.release_room(f"room{r}")
                room_sizes[r] = 0
            moves = rt.compact()
            log(f"tick {i}: released {len(sizes) // 2} rooms, compaction queued "
                f"{moves} page moves")
        traffic, inp = synth.next_tick(traffic, logical, spec, i, seed=SEED)
        inp = mask_to_rooms(inp, room_sizes)
        batch = synth_packets(inp, rng)
        estimate = np.asarray(inp.estimate)
        push_paged(rt, batch, estimate, room_sizes)
        t0 = time.perf_counter()
        res = await rt.step_once()
        tick_s.append(time.perf_counter() - t0)
        fwd += res.fwd_packets
        live_ticks += int(rt.pager.pages_mapped > 0)
        if i < CHECK_TICKS:
            push_paged(ref, rooms_below(batch, CHECK_ROOMS), estimate, ref_sizes)
            want = await ref.step_once()
            compare_outputs(res.outputs, want.outputs, CHECK_ROOMS, i, worst)
            compare_egress(res.egress_batch, want.egress_batch, CHECK_ROOMS, i)
    launches = dict(cuda.launches)
    paged.dead_page_outputs = fresh

    # The dead-page outputs are computed once per (tick_ms, roll_quality)
    # seen — one 1-page stock tick, one launch of kernels 1 and 2 — and
    # kernel 2 runs once per live tick in phase 2.
    keys = len(dead_on_card)
    expected = {"paged_kernel": live_ticks, "decide_rooms": keys,
                "allocate_budget_rooms": live_ticks + keys}
    if fwd <= 0:
        raise AssertionError("paged runtime forwarded no packets")
    if launches != expected:
        raise AssertionError(f"paged runtime launches {launches}, expected {expected}")
    if rt.stats["page_moves"] <= 0 or rt.stats["paged_kernel_ticks"] != PAGED_TICKS:
        raise AssertionError(f"paged runtime stats {rt.stats}")
    log(f"paged runtime ok: {PAGED_TICKS} ticks, {fwd} packets forwarded, launches "
        f"{launches}, page moves {rt.stats['page_moves']}, step_once median "
        f"{statistics.median(tick_s) * 1e3:.3f} ms")
    print(json.dumps({"paged_runtime": {
        "dims": list(dims), "rooms": len(sizes), "live_pages": live_pages,
        "ticks": PAGED_TICKS, "fwd_packets": fwd, "launches": launches,
        "step_once_median_ms": statistics.median(tick_s) * 1e3,
        "paged_kernel_ms_median": statistics.median(
            r["paged_kernel_ms"] for r in rt.recent_ticks),
        "gpu_vs_cpu_max_abs_err": worst,
    }}), flush=True)
    return launches


def paged_pool_state(pager: RoomPager, sizes, dims: paged.PagedDims, dev):
    """Device pool state and table for the pager's rooms (sizes[r]
    participants, each publishing one track and subscribed to all others),
    as `setup_paged_room` + the runtime's page-granular upload build it."""
    P, TP, SP = dims.pool_pages, dims.tpage, dims.spage
    room = pager.pg_room
    size = np.zeros(P, np.int64)
    size[room >= 0] = np.asarray(sizes)[room[room >= 0]]
    t = pager.pg_tp[:, None] * TP + np.arange(TP)[None, :]                 # [P, TP]
    s = pager.pg_sp[:, None] * SP + np.arange(SP)[None, :]                 # [P, SP]
    published = (room >= 0)[:, None] & (t < size[:, None])
    video = published & (t < PAGED_SPEC.video_tracks)
    subscribed = (published[:, :, None] & (s[:, None, :] < size[:, None, None])
                  & (s[:, None, :] != t[:, :, None]))
    state = plane.init_state(dims.pooled(), device=dev)
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    state = state._replace(
        meta=state.meta._replace(is_video=on(video), published=on(published), is_svc=on(video)),
        ctrl=state.ctrl._replace(subscribed=on(subscribed)))
    table = paged.init_table(dims, dev)
    paged.apply_table_delta(table, *paged.pack_table_delta(pager, pager.drain_delta()))
    return state, table


def paged_wires(pager, dims, room_sizes, n: int):
    """`n` ticks of pooled wires for the pager's current table: seeded
    logical synth traffic, masked to each room's tracks, staged onto the
    pages as the runtime stages it."""
    logical = plane.PlaneDims(dims.rooms, dims.tracks, dims.pkts, dims.subs)
    xlate = paged.LayoutXlate(dims, pager.pg_room, pager.pg_tp, pager.pg_sp)
    traffic = synth.init_traffic(logical, PAGED_SPEC, seed=SEED)
    wires = []
    for i in range(n):
        traffic, inp = synth.next_tick(traffic, logical, PAGED_SPEC, i, seed=SEED)
        pkt, fb, tf, tick_ms, roll = plane.pack_tick_inputs(mask_to_rooms(inp, room_sizes))
        pkt_p, fb_p, tf_p = xlate.stage_inputs(pkt, fb, tf)
        wires.append(plane.wire_inputs((pkt_p.astype(np.int32), fb_p.astype(np.float32),
                                        tf_p.astype(np.float32), tick_ms, roll)))
    return wires


def time_live_steps(state, table, wires, dims, rows, inv):
    """Host clock around `paged.live_step` (the runtime's device step;
    it ends in the device→host copy of the outputs) after WARMUP_TICKS."""
    for i in range(WARMUP_TICKS):
        state, _, _ = paged.live_step(state, table, wires[i % len(wires)], dims, rows, inv)
    times = []
    spans = []
    for i in range(PAGED_TIMED_TICKS):
        t0 = time.perf_counter()
        state, _, span = paged.live_step(state, table, wires[i % len(wires)], dims, rows, inv)
        times.append((time.perf_counter() - t0) * 1e3)
        spans.append(span * 1e3)
    times.sort()
    return state, {
        "median_ms": statistics.median(times),
        "p90_ms": times[int(0.9 * len(times)) - 1],
        "decide_span_median_ms": statistics.median(spans),
        "grid": int(rows.numel()),
    }


def full_pool(dev):
    """The PAGED_TIMING_DIMS pool filled from the size mix: (pager, room
    sizes per row, device state, table, live rows, live inverse, live
    pages, two ticks of wires)."""
    dims = PAGED_TIMING_DIMS
    pager = RoomPager(dims.rooms, dims.tracks, dims.subs, tpage=dims.tpage,
                      spage=dims.spage, pool_pages=dims.pool_pages)
    sizes = admit_rooms(pager)
    room_sizes = np.zeros(dims.rooms, np.int64)
    room_sizes[:len(sizes)] = sizes
    state, table = paged_pool_state(pager, sizes, dims, dev)
    rows, inv, n_live = live_tables(pager, dev)
    wires = paged_wires(pager, dims, room_sizes, 2)
    return pager, room_sizes, state, table, rows, inv, n_live, wires


def release_half(pager, room_sizes, state, table, dev):
    """Release every other room of the full pool: the freed pages
    re-initialize and drop out of the live rows, as the runtime's page-lane
    sync does. Returns (live rows, live inverse, live pages, two ticks of
    wires); state, table and room_sizes are updated in place."""
    dims = PAGED_TIMING_DIMS
    for r in range(1, int((room_sizes > 0).sum()), 2):
        pager.release_room(r)
        room_sizes[r] = 0
    delta = pager.drain_delta()
    paged.apply_table_delta(table, *paged.pack_table_delta(pager, delta))
    paged.reinit_pages(state, delta.freed_pages, paged.page_init_template(dims, dev))
    rows, inv, n_live = live_tables(pager, dev)
    return rows, inv, n_live, paged_wires(pager, dims, room_sizes, 2)


def capture_live_step(state, table, wire, rows, inv):
    """One live step of the PAGED_TIMING_DIMS pool with phase 0's and
    phase 2's wrappers wrapped; returns (state', {name: (args, kwargs,
    result)})."""
    (state, _, _), seen = capture_calls(
        [(paged_kernel, "decide_pages"), (allocation, "allocate_budget_rooms")],
        lambda: paged.live_step(state, table, wire, PAGED_TIMING_DIMS, rows, inv))
    return state, seen


def dead_key_calls(dev) -> dict:
    """The paged path's decide_rooms and allocate_budget_rooms launches of
    a dead-page key (the 1-page stock tick at PAGED_TIMING_DIMS' page
    shape): {name: (args, kwargs, result)}."""
    d = PAGED_TIMING_DIMS
    _, seen = capture_calls(
        [(selector, "decide_rooms"), (allocation, "allocate_budget_rooms")],
        lambda: paged.dead_page_outputs(d.tracks // d.tpage, d.tpage, d.pkts, d.spage,
                                        PAGED_SPEC.tick_ms, 0, device=dev))
    return seen


def require_exact(name: str, plain, a, kw, res, where: str) -> None:
    """Raise unless the kernel's result `res` equals plain(*a, **kw) bit
    for bit."""
    ok, err = tree_equal(res, plain(*a, **kw))
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError(f"{name} kernel != plain on {where} (max abs err {err})")
    log(f"{name} exact on {where}")


def time_decide_pages(seen, where: str) -> dict:
    """The captured decide_pages launch, run again on its operands (the
    step updates the pool's selector state in place after it), held equal
    to its plain version, then timed beside its byte bound and its plain
    version's time: the kernel's launch alone and the whole wrapper."""
    a, kw, _ = seen["decide_pages"]
    res = paged_kernel.decide_pages(*a, **kw)
    require_exact("paged_kernel", paged_kernel.decide_pages_plain, a, kw, res, where)
    bytes_moved = decide_pages_bytes(a, res)
    nl = int(a[5].numel())
    out = time_kernel(paged_kernel.decide_pages, paged_kernel.decide_pages_plain, a, kw,
                      bytes_moved)
    # `ms` is the kernel's own launch; `wrapper_ms` adds the wrapper's two
    # gathers of the live rows' selector targets (torch ops).
    out["wrapper_ms"] = out["ms"]
    out["ms"] = graph_ms(lambda: decide_launch(*a, **kw), KERNEL_REPS)
    out.update(bytes_per_step=bytes_moved / nl, grid=nl,
               shape=[nl, *a[4].layer.shape[1:], a[3].shape[-1]])
    return out


def paged_timing_phase(dev, profile: bool) -> tuple[dict, dict]:
    """The live-extent device step at PAGED_TIMING_DIMS filled from the
    size mix, at full occupancy and after releasing half the rooms; the
    phase-0 kernel's own time on operands captured from a live step at
    each occupancy and the phase-2 allocation's on the full pool's (each
    held equal to its plain version there first), beside their byte
    bounds and their plain versions' times; and the dead-page key's
    decide_rooms and allocate_budget_rooms launches, each held equal to
    its plain version and timed."""
    dims = PAGED_TIMING_DIMS
    pager, room_sizes, state, table, rows, inv, n_live, wires = full_pool(dev)
    sizes = room_sizes[room_sizes > 0]
    state, full = time_live_steps(state, table, wires, dims, rows, inv)
    full.update(rooms=len(sizes), live_pages=n_live)
    if profile:
        profile_steps(lambda i: paged.live_step(state, table, wires[i % 2], dims, rows, inv))

    state, seen = capture_live_step(state, table, wires[0], rows, inv)
    kernel = time_decide_pages(seen, f"the full-occupancy live step's operands ({n_live} "
                               "live pages)")
    a2, kw2, res2 = seen["allocate_budget_rooms"]
    require_exact("allocate_budget_rooms", allocation.allocate_budget_rooms_plain, a2, kw2,
                  res2, f"the paged live step's operands {list(a2[1].shape)}")
    alloc = time_kernel(allocation.allocate_budget_rooms,
                        allocation.allocate_budget_rooms_plain, a2, kw2, nbytes(a2, res2))
    alloc["shape"] = list(a2[1].shape)
    del seen, a2, kw2, res2

    # The dead-page key's launches, held to their plain versions first.
    dead_calls = dead_key_calls(dev)
    a3, kw3, res3 = dead_calls["decide_rooms"]
    st = a3[0]
    shape = list(a3[4].shape) + [st.current_spatial.shape[-1]]
    require_exact("decide_rooms", selector.decide_rooms_plain, a3, kw3, res3,
                  f"the dead-page key {shape}")
    dead = time_kernel(selector.decide_rooms, selector.decide_rooms_plain, a3, kw3,
                       decide_rooms_bytes(a3, res3))
    dead["shape"] = shape
    a4, kw4, res4 = dead_calls["allocate_budget_rooms"]
    require_exact("allocate_budget_rooms", allocation.allocate_budget_rooms_plain, a4, kw4,
                  res4, f"the dead-page key {list(a4[1].shape)}")
    alloc["dead_key"] = time_kernel(allocation.allocate_budget_rooms,
                                    allocation.allocate_budget_rooms_plain, a4, kw4,
                                    nbytes(a4, res4))
    alloc["dead_key"]["shape"] = list(a4[1].shape)
    del dead_calls, a3, kw3, res3, a4, kw4, res4
    torch.cuda.empty_cache()

    rows, inv, n_live, wires = release_half(pager, room_sizes, state, table, dev)
    state, half = time_live_steps(state, table, wires, dims, rows, inv)
    half.update(rooms=len(sizes) - len(sizes) // 2, live_pages=n_live)
    state, seen = capture_live_step(state, table, wires[0], rows, inv)
    kernel["half"] = time_decide_pages(seen, f"the half-occupancy live step's operands "
                                       f"({n_live} live pages)")
    del seen
    tick = {"dims": list(dims), "ticks": PAGED_TIMED_TICKS, "full": full, "half": half,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    return tick, {"paged_kernel": kernel, "allocate_budget_rooms": alloc, "decide_rooms": dead}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler tables of dense and paged steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    reports = cuda.build()
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"nvcc {name}: {line.strip()}")
    ptxas = {name: ptxas_report(text) for name, text in reports.items()}
    print(json.dumps({"ptxas": ptxas}), flush=True)
    card = card_line()
    log(f"build ok in {time.perf_counter() - t0:.1f} s; card: {card}")

    errs = parity_phase(dev)
    errs["paged_kernel"], mix_t = paged_parity_phase(dev)
    dense_launches = asyncio.run(runtime_phase(dev))
    paged_launches = asyncio.run(paged_runtime_phase(dev))
    tick, dense_t = timing_phase(dev, args.profile)
    paged_tick, paged_t = paged_timing_phase(dev, args.profile)

    # decide_rooms and allocate_budget_rooms belong to the dense path,
    # paged_kernel to the paged path; each kernel's top-level numbers and
    # `launches` are from its own path, and `paths` gives each path that
    # launches it: its launch shape, launches and timed numbers there (the
    # paged allocation's dead-page launch under `dead_key`).
    launches = {"dense": dense_launches, "paged": paged_launches}
    paged_t["paged_kernel"]["mix"] = mix_t
    timed = {"dense": dense_t, "paged": paged_t}
    own = {"decide_rooms": "dense", "allocate_budget_rooms": "dense", "paged_kernel": "paged"}
    kernels = []
    for name, meta in KERNELS.items():
        main_t = timed[own[name]][name]
        paths = {
            path: {"launches": launches[path][name], **timed[path][name]}
            for path in ("dense", "paged") if name in timed[path]
        }
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[own[name]][name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": errs[name], "ms": main_t["ms"], "call_ms": main_t["call_ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "paths": paths,
            **ptxas.get(name, {}),
        })
    print(json.dumps({"north_star_tick": tick}), flush=True)
    print(json.dumps({"paged_tick": paged_tick, "paged_kernel": paged_t["paged_kernel"],
                      "paged_allocate_budget_rooms": paged_t["allocate_budget_rooms"]}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
