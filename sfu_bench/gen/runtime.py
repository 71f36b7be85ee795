"""Receive batches for the served path: a cycled library of seeded synth
ticks as the columns `IngestBuffer.push_batch` takes, and the
subscribers' bandwidth reports.

Tick `i` of a run is library tick `i % n` (sfu_bench/gen/library.py)
advanced `i // n` passes, as one receive batch in (room, track, slot)
order: every packet the synth generated, with a payload of real size in
one shared blob of seeded bytes (video the synth's 800–1,400 bytes, about
1,100 on average; an Opus frame of `audio_kbps` × 20 ms, 80 bytes at 32
kbps), and on each SVC video packet a dependency descriptor after its
payload: its 3 mandatory bytes, 24 where it carries the template
structure (keyframes). A packet's `size` is its payload's length.

Each subscriber reports an estimate every `every` ticks, a share of them
each tick (`phase`), the synth's estimate of that tick; between reports
the node holds the last one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from sfu_bench.gen import library, synth
from sfu_bench.reference import tick as plane

DD_BYTES, DD_STRUCTURE_BYTES = 3, 24
OPUS_FRAME_MS = 20
# Columns a pass of the library advances, with their widths, and the
# Spans field each takes.
ADVANCED = (("sn", library.SN_MASK, "sn"), ("ts", library.TS_MASK, "ts"),
            ("arrival_rtp", library.TS_MASK, "ts"), ("pid", library.PID_MASK, "pid"),
            ("tl0", library.TL0_MASK, "tl0"))


class RuntimeLibrary(NamedTuple):
    ticks: list          # per tick: push_batch's columns (numpy), blob left out
    blob: np.ndarray     # uint8: the payload and descriptor bytes every tick points into
    estimate: np.ndarray  # [n, R, S] float32: each tick's reports
    spans: library.Spans


def batch_of(inp: plane.TickInputs, spec: synth.TrafficSpec, svc_video: np.ndarray) -> dict:
    """One synth tick → push_batch's columns, offsets from 0 in the blob."""
    r, t, k = np.nonzero(np.asarray(inp.valid))
    at = lambda f: np.asarray(getattr(inp, f))[r, t, k]  # noqa: E731
    video = np.asarray(inp.frame_ms)[r, t, k] == 0
    size = np.where(video, at("size"),
                    spec.audio_kbps * 1000 * OPUS_FRAME_MS // 8000).astype(np.int64)
    svc = svc_video[t]
    dd_len = np.where(svc, np.where(at("keyframe"), DD_STRUCTURE_BYTES, DD_BYTES), 0)
    ends = np.cumsum(size + dd_len)
    pay_start = ends - size - dd_len
    return dict(
        room=r.astype(np.int64), track=t.astype(np.int64), layer=at("layer"),
        sn=at("sn").astype(np.int64), ts=at("ts"), ts_aligned=at("ts_jump") < 0,
        temporal=at("temporal"), keyframe=at("keyframe"), layer_sync=at("layer_sync"),
        begin_pic=at("begin_pic"), marker=at("end_frame"), end_frame=at("end_frame"),
        pid=at("pid"), tl0=at("tl0"), keyidx=at("keyidx"), size=size.astype(np.int32),
        frame_ms=at("frame_ms"), audio_level=at("audio_level"),
        arrival_rtp=at("arrival_rtp"), pay_start=pay_start, pay_length=size,
        dd_start=np.where(svc, pay_start + size, -1),
        dd_length=dd_len.astype(np.int32),
        dd_version=np.where(svc, 0, -1).astype(np.int32),
    )


def generate(dims: plane.PlaneDims, spec: synth.TrafficSpec, n: int, seed: int) -> RuntimeLibrary:
    lib, spans = library.generate(dims, spec, n, seed)
    svc_video = np.zeros(dims.tracks, bool)
    svc_video[:min(spec.video_tracks, dims.tracks)] = spec.svc
    ticks = [batch_of(t, spec, svc_video) for t in lib]
    size = max(int((b["pay_length"] + b["dd_length"]).sum()) for b in ticks)
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 41])
    blob = rng.integers(0, 256, max(size, 1), dtype=np.uint8)
    est = np.stack([np.asarray(t.estimate, np.float32) for t in lib])
    return RuntimeLibrary(ticks, blob, est, spans)


def advance(cols: dict, spans: library.Spans, passes: int) -> dict:
    """`cols` moved on by `passes` passes of the library (a new dict; the
    arrays it does not advance are shared)."""
    if passes == 0:
        return cols
    r, t = cols["room"], cols["track"]
    out = dict(cols)
    for f, mask, span in ADVANCED:
        x = np.asarray(cols[f], np.int64) + getattr(spans, span)[r, t] * np.int64(passes)
        out[f] = library.wrap_i32(x) if mask == library.TS_MASK else (x & mask).astype(
            np.asarray(cols[f]).dtype)
    return out


def tick_columns(lib: RuntimeLibrary, i: int) -> dict:
    """Tick `i`'s receive columns."""
    return advance(lib.ticks[i % len(lib.ticks)], lib.spans, i // len(lib.ticks))


def phase(dims: plane.PlaneDims, every: int) -> np.ndarray:
    """[R, S]: the tick (mod `every`) at which each subscriber reports."""
    return (np.arange(dims.rooms * dims.subs) % every).reshape(dims.rooms, dims.subs)


def reports(lib: RuntimeLibrary, dims: plane.PlaneDims, i: int, every: int):
    """The node's estimates at tick `i` after its reports: ([R, S]
    float32, the newest report of each subscriber, 0 before its first;
    [R, S] bool, reported this tick)."""
    ph = phase(dims, every)
    last = i - (i - ph) % every                       # newest report tick <= i
    rooms, subs = np.indices(ph.shape)
    est = lib.estimate[np.maximum(last, 0) % len(lib.ticks), rooms, subs]
    return np.where(last >= 0, est, 0.0).astype(np.float32), last == i
