"""Timing helpers shared by chip_smoke.py, the bench CLI and the tick
profile: device time of a callable on the card (CUDA events, CUDA
graphs), wall time on the host, order statistics of a sample, and the
card's name and power limit as nvidia-smi reports them."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

GRAPH_LAUNCHES = 20


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


def wall_ms(fn, reps: int) -> float:
    """Median over `reps` calls of fn on the host's clock (the CPU path,
    where there are no CUDA events)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def quantiles(xs) -> dict:
    xs = sorted(xs)
    if not xs:
        return {"median": None, "p90": None}
    return {"median": statistics.median(xs),
            "p90": xs[min(len(xs) - 1, int(0.9 * len(xs)))]}


def percentiles(xs) -> dict:
    xs = sorted(xs)
    if not xs:
        return {"n": 0}
    return {"n": len(xs), "p50_ms": xs[len(xs) // 2], "p90_ms": xs[int(0.9 * (len(xs) - 1))],
            "p99_ms": xs[int(0.99 * (len(xs) - 1))]}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
