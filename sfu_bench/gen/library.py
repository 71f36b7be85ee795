"""A cycled library of seeded synth ticks.

Set-up generates `n` distinct ticks of `synth.next_tick` from the seed
and one more, whose cursors give each (room, track)'s advance over one
pass of the library: its SN count, its RTP-time span, its picture-id and
TL0 steps. Tick `i` of a run is library tick `i % n` advanced `i // n`
times by those spans, so a replayed pass continues every stream where the
last one ended and never reads as late or duplicate packets, and every
pass carries the same packets, sizes and flags: the same work. Both the
program's side and the reference take tick `i` from here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from sfu_bench.gen import synth
from sfu_bench.reference import tick as plane

# Fields a pass of the library advances, and their widths.
SN_MASK, TS_MASK, PID_MASK, TL0_MASK = 0xFFFF, 0xFFFFFFFF, 0x7FFF, 0xFF


class Spans(NamedTuple):
    """Per-(room, track) advance over one pass, [R, T] int64."""

    sn: np.ndarray
    ts: np.ndarray
    pid: np.ndarray
    tl0: np.ndarray


def wrap_i32(x: np.ndarray) -> np.ndarray:
    """int64 values → int32 two's complement of their low 32 bits."""
    return (np.asarray(x, np.int64) & TS_MASK).astype(np.uint32).view(np.int32)


def generate(dims: plane.PlaneDims, spec: synth.TrafficSpec, n: int, seed: int):
    """`n` numpy TickInputs and the Spans of one pass over them."""
    traffic = synth.init_traffic(dims, spec, seed=seed)
    ticks = []
    for i in range(n + 1):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=seed)
        ticks.append(inp)
    first, after = ticks[0], ticks[n]
    lead = lambda x: np.asarray(x, np.int64)[:, :, 0]  # noqa: E731
    spans = Spans(
        sn=(lead(after.sn) - lead(first.sn)) & SN_MASK,
        ts=(lead(after.ts) - lead(first.ts)) & TS_MASK,
        pid=(lead(after.pid) - lead(first.pid)) & PID_MASK,
        tl0=(lead(after.tl0) - lead(first.tl0)) & TL0_MASK,
    )
    return ticks[:n], spans


def advance(inp: plane.TickInputs, spans: Spans, passes: int) -> plane.TickInputs:
    """`inp` moved on by `passes` passes of the library: SN, RTP time,
    arrival time, picture id and TL0 of every slot (valid or not)."""
    if passes == 0:
        return inp
    c = np.int64(passes)
    sp = lambda s: (s * c)[:, :, None]  # noqa: E731
    return inp._replace(
        sn=((np.asarray(inp.sn, np.int64) + sp(spans.sn)) & SN_MASK).astype(np.int32),
        ts=wrap_i32(np.asarray(inp.ts, np.int64) + sp(spans.ts)),
        arrival_rtp=wrap_i32(np.asarray(inp.arrival_rtp, np.int64) + sp(spans.ts)),
        pid=((np.asarray(inp.pid, np.int64) + sp(spans.pid)) & PID_MASK).astype(np.int32),
        tl0=((np.asarray(inp.tl0, np.int64) + sp(spans.tl0)) & TL0_MASK).astype(np.int32),
    )

