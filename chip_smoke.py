#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (livekit_server_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero):

  1. build    — compile every CUDA kernel of the dense tick with nvcc
                (one process per source, in parallel) and print the card's
                name and power limit;
  2. parity   — each kernel against its plain PyTorch version on the card,
                seeded inputs, at PlaneDims(4, 4, 8, 40), (1024, 10, 8, 10)
                and (10240, 8, 16, 50); integers, bools and the float32
                used budget must be equal bit for bit;
  3. runtime  — a PlaneRuntime at PlaneDims(1024, 10, 8, 10) (1k rooms ×
                10 participants, 2 VP9-SVC video + 2 Opus tracks per room)
                fed RUNTIME_TICKS ticks of seeded traffic through
                IngestBuffer.push_batch; forwarded packets must be > 0,
                each kernel's launch count must equal the tick count, and
                the first CHECK_TICKS ticks of rooms 0..7 must equal a CPU
                run of the port at PlaneDims(8, 10, 8, 10) fed the same
                packets (integers exact; floats within
                plane.float_tolerance of each leaf);
  4. timing   — the runtime's device step (plane.device_tick: upload,
                tick, fetch) at the north-star PlaneDims(10240, 8, 16, 50),
                median and p90 of TIMED_TICKS ticks after warm-up, and each
                kernel's own time beside its byte bound and its plain
                version's time. A kernel's `ms` is device time: a CUDA graph
                of GRAPH_LAUNCHES launches of the wrapper, inputs captured
                from a real tick, replayed between a CUDA event pair, so
                the wrapper's host work (checks, allocation, the ctypes
                call) is not in it; `call_ms` is one wrapper call between
                an event pair, host work included.

Output: a `{"kernels": [...]}` JSON line, the card line from nvidia-smi,
and as the last line `{"ok": true, "device": {...}}`. `--profile` adds a
torch.profiler breakdown of a few north-star ticks (device time by kernel).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from livekit_server_tpu_torch.models import plane, synth
from livekit_server_tpu_torch.ops import allocation, cuda, pacer, selector
from livekit_server_tpu_torch.runtime import PlaneRuntime

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
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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
    for name, n in launches.items():
        if n != RUNTIME_TICKS:
            raise AssertionError(f"{name}: {n} launches in {RUNTIME_TICKS} ticks")
    log(f"runtime ok: {RUNTIME_TICKS} ticks at {tuple(dims)}, {fwd} packets "
        f"forwarded, launches {launches}, step_once median "
        f"{statistics.median(tick_s) * 1e3:.3f} ms (host stage + device + fan-out)")
    print(json.dumps({"runtime_gpu_vs_cpu_max_abs_err": worst}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# North-star timing
# ---------------------------------------------------------------------------


def capture_kernel_args(state, wire, dims):
    """Run one tick with the two kernel wrappers wrapped, recording the
    arguments and results the main path hands them."""
    seen = {}
    originals = (selector.decide_rooms, allocation.allocate_budget_rooms)

    def wrap(mod, name, fn):
        def f(*a, **kw):
            res = fn(*a, **kw)
            seen[name] = (a, kw, res)
            return res
        setattr(mod, name, f)

    wrap(selector, "decide_rooms", originals[0])
    wrap(allocation, "allocate_budget_rooms", originals[1])
    try:
        state, _ = plane.device_tick(state, wire, dims)
    finally:
        selector.decide_rooms, allocation.allocate_budget_rooms = originals
    return state, seen


def nbytes(*trees) -> int:
    return sum(x.numel() * x.element_size() for t in trees for x in plane.tree_leaves(t))


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


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of fn: GRAPH_LAUNCHES calls captured in a
    CUDA graph, the graph replayed `reps` times between CUDA event pairs;
    the median replay over GRAPH_LAUNCHES. Host work in fn runs once, at
    capture, and is not timed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                   # load the module outside capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return event_ms(graph.replay, reps) / GRAPH_LAUNCHES


def timing_phase(dev, profile: bool) -> tuple[dict, dict]:
    dims, spec = NORTH_STAR, NORTH_STAR_SPEC
    state = synth.make_state(dims, spec, device=dev)
    traffic = synth.init_traffic(dims, spec, seed=SEED)
    wires = []
    for i in range(4):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=SEED)
        wires.append(plane.wire_inputs(plane.pack_tick_inputs(inp)))
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
    st = a[0]
    dec_bytes = nbytes(a[1:], (st.current_spatial, st.current_temporal,
                               st.target_spatial, st.target_temporal),
                       res[1:], (res[0].current_spatial, res[0].current_temporal))
    dec = {
        "ms": graph_ms(lambda: selector.decide_rooms(*a, **kw), KERNEL_REPS),
        "call_ms": event_ms(lambda: selector.decide_rooms(*a, **kw), KERNEL_REPS),
        "plain_ms": event_ms(lambda: selector.decide_rooms_plain(*a, **kw), PLAIN_REPS),
        "bound_ms": dec_bytes / HBM_BYTES_PER_S * 1e3, "bytes": dec_bytes,
    }
    a2, kw2, res2 = seen["allocate_budget_rooms"]
    al_bytes = nbytes(a2, res2)
    al = {
        "ms": graph_ms(lambda: allocation.allocate_budget_rooms(*a2, **kw2), KERNEL_REPS),
        "call_ms": event_ms(lambda: allocation.allocate_budget_rooms(*a2, **kw2), KERNEL_REPS),
        "plain_ms": event_ms(lambda: allocation.allocate_budget_rooms_plain(*a2, **kw2),
                             PLAIN_REPS),
        "bound_ms": al_bytes / HBM_BYTES_PER_S * 1e3, "bytes": al_bytes,
    }
    if profile:
        profile_ticks(state, wires, dims)
    return tick, {"decide_rooms": dec, "allocate_budget_rooms": al}


def profile_ticks(state, wires, dims) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            state, _ = plane.device_tick(state, wires[i % len(wires)], dims)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of north-star ticks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    reports = cuda.build()
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"nvcc {name}: {line.strip()}")
    card = card_line()
    log(f"build ok in {time.perf_counter() - t0:.1f} s; card: {card}")

    errs = parity_phase(dev)
    launches = asyncio.run(runtime_phase(dev))
    tick, kt = timing_phase(dev, args.profile)

    kernels = []
    for name, meta in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": kt[name]["ms"], "call_ms": kt[name]["call_ms"],
            "plain_ms": kt[name]["plain_ms"], "bound_ms": kt[name]["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        })
    print(json.dumps({"north_star_tick": tick}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
