"""The port's block spans over the traced stretch: one block of the eager
tick, its host span a call (the launch work the host does for that block),
read from the recorder of the calling thread, the thread that ran the
stretch (`livekit_server_tpu_torch/utils/spans.py`, opened in
models/plane.py).

The recorder records while a torch profiler records, so it holds the
traced stretch's calls; its rings may also hold calls of an earlier run in
the same process and thread, so only calls that start within the
stretch's wall time before the recorder's newest stamp, and at most one a
traced tick, are read. None where the program has no recorder, where it
holds no such call (the control and the faults replace the tick), and
where the stretch saw no device work (on the CPU a span times the ops
themselves, not their launch).
"""

from __future__ import annotations

import statistics


def block_ms(rec, block: str):
    """Median host ms a call of `block`'s span over the traced stretch, or
    None."""
    t = rec.trace
    if t is None or t.busy_s <= 0 or t.ticks <= 0:
        return None
    try:
        from livekit_server_tpu_torch.utils import spans
    except ImportError:
        return None
    r = spans.current()
    if r is None or block not in spans.SPANS:
        return None
    newest = max((t0 + d for t0, d in r.last() if t0), default=0)
    since = newest - int(t.window_s * 1e9)
    durs = [d for t0, d in r.calls(spans.SPANS.index(block))[-t.ticks:] if t0 >= since]
    return statistics.median(durs) / 1e6 if durs else None
