"""The traced stretch: `torch.profiler` over a fixed number of ticks, and
its reduction to device busy time, time by device operation, and idle
gaps by the harness span that was open.

The stretch runs after the window, with the harness's spans
(`record_function`) that the path opens, such as launch and sync. Device intervals are
the profiler's kernel, memcpy and memset events; `busy_s` is the length
of their union, `window_s` the stretch's wall time on the host's clock.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

SPAN_PREFIX = "sfu_bench."


@dataclass
class TraceSummary:
    ticks: int
    window_s: float
    busy_s: float
    device_sum_s: float
    ops: dict = field(default_factory=dict)     # name -> [total_s, count]
    gaps: dict = field(default_factory=dict)    # span name -> idle s

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[short_name(n), v[0]] for n, v in top],
                "idle_gaps": [[n, s] for n, s in gaps]}

    def kernel(self, substr: str):
        """(total_s, count) of the device operations whose name holds
        `substr`; None when none ran."""
        hits = [v for n, v in self.ops.items() if substr in n]
        if not hits:
            return None
        return sum(h[0] for h in hits), sum(h[1] for h in hits)


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without the C++ noise around it: no
    `void`, no `at::native::` and `(anonymous namespace)::` qualifiers,
    no argument list, at most `width` characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:width]


def union_length(intervals) -> float:
    """Total length covered by [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The gaps in [lo, hi) that no interval covers, as (start, end)."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def attribute(gaps, spans) -> dict:
    """Idle seconds by the innermost harness span open over each part of
    each gap ("none" where no span was open). `spans`: (name, start,
    end); times in seconds on the profiler's clock."""
    edges = sorted({t for _, s, e in spans for t in (s, e)})
    seg_names = []
    for s0, s1 in zip(edges, edges[1:]):
        mid = (s0 + s1) / 2
        open_ = [(e - s, n) for n, s, e in spans if s <= mid < e]
        seg_names.append(min(open_)[1] if open_ else "none")
    out: dict = {}
    for a, b in gaps:
        i = bisect.bisect_right(edges, a)
        j = bisect.bisect_left(edges, b)
        cuts = [a] + edges[i:j] + [b]
        for k, (s0, s1) in enumerate(zip(cuts, cuts[1:])):
            seg = i - 1 + k
            name = seg_names[seg] if 0 <= seg < len(seg_names) else "none"
            out[name] = out.get(name, 0.0) + (s1 - s0)
    return out


def reduce(device_events, span_events, ticks: int, window_s: float) -> TraceSummary:
    """device_events: (name, start_s, end_s) of device operations;
    span_events: (name, start_s, end_s) of the harness spans."""
    iv = [(s, e) for _, s, e in device_events]
    ops: dict = {}
    for n, s, e in device_events:
        v = ops.setdefault(n, [0.0, 0])
        v[0] += e - s
        v[1] += 1
    gaps = {}
    if span_events:
        lo = min(s for _, s, _ in span_events)
        hi = max(e for _, _, e in span_events)
        gaps = attribute(idle_gaps(iv, lo, hi), span_events)
    return TraceSummary(ticks=ticks, window_s=window_s, busy_s=union_length(iv),
                        device_sum_s=sum(e - s for s, e in iv), ops=ops, gaps=gaps)


def profile(session, ticks: int, device) -> TraceSummary:
    """Run `ticks` ticks of `session` under the profiler and reduce."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def span(name):
        return record_function(SPAN_PREFIX + name)

    session.set_span(span)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            session.step()
        window_s = time.perf_counter() - t0
    dev_ev, spans = [], []
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name.startswith(SPAN_PREFIX):
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name[len(SPAN_PREFIX):], s, t))
        elif e.device_type == DeviceType.CUDA:
            dev_ev.append((e.name, s, t))
    return reduce(dev_ev, spans, ticks, window_s)
