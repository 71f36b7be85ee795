"""The block spans of the eager tick (livekit_server_tpu_torch/utils/spans.py,
opened in models/plane.py) on the CPU at tiny dims: each block records once
a tick, in the tick's order, nested in plane.tick, and the blocks cover the
wall clock of unpack + tick + pack; off, a tick records nothing and opens
no `record_function`; under a profiler the program did not start, the host
spans are recorded and no `plane.*` range appears; with `annotate` (the
`tools.profile_tick --trace` path) each range lines up with its span on
the unix epoch; each thread keeps its own recorder, and the count of
threads with a flight recorder on survives threads turning theirs on and
off at once; and a PlaneRuntime
with its trace ring carries the blocks into /debug/trace, inside
device_step, with `baseTimeNanoseconds`."""

import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.models import plane, synth  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.plane_runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.telemetry import trace_export  # noqa: E402
from livekit_server_tpu_torch.tools import profile_tick  # noqa: E402
from livekit_server_tpu_torch.utils import spans  # noqa: E402

DIMS = plane.PlaneDims(8, 4, 4, 4)
SPEC = synth.TrafficSpec(video_tracks=2, audio_tracks=2, svc=True)
INNER = spans.SPANS.index("decide"), spans.SPANS.index("allocate")


@pytest.fixture
def flight():
    """The calling thread's recorder, on as a flight recorder; off again
    after the test."""
    rec = spans.set_flight(True)
    yield rec
    spans.set_flight(False)
    rec.annotate = False


def _full():
    return profile_tick.full_tick(DIMS, SPEC, torch.device("cpu"))


def calls_since(rec, mark) -> list[int]:
    return [n - m for n, m in zip(rec.count, mark)]


def test_each_block_once_a_tick_in_order_inside_tick(flight):
    full = _full()
    mark = flight.mark()
    for k in range(3):
        full()
        assert calls_since(flight, mark) == [k + 1] * len(spans.SPANS)
        last = flight.last()
        starts = [t0 for t0, _ in last[:len(spans.BLOCKS)]]
        ends = [t0 + d for t0, d in last[:len(spans.BLOCKS)]]
        assert all(d > 0 for _, d in last)
        assert starts == sorted(starts)
        assert all(e <= s for e, s in zip(ends, starts[1:]))      # no overlap
        t0, d = last[spans.TICK]
        lo, hi = INNER
        assert t0 <= starts[lo] and ends[hi] <= t0 + d
        assert starts[spans.UNPACK] < t0 and t0 + d <= starts[spans.PACK]


def test_blocks_cover_the_tick(flight):
    full = _full()
    full()
    shares = []
    for _ in range(5):
        w0 = time.perf_counter_ns()
        full()
        wall = time.perf_counter_ns() - w0
        blocks = sum(d for _, d in flight.last()[:len(spans.BLOCKS)])
        shares.append(blocks / wall)
    shares.sort()
    assert 0.9 <= shares[2] <= 1.0, shares


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    import torch.autograd.profiler as prof

    opened = []
    monkeypatch.setattr(prof, "record_function", lambda name: opened.append(name))
    rec = spans.set_flight(False)
    mark = rec.mark()
    rec.annotate = True              # asked for, but the recorder is off
    try:
        _full()()
    finally:
        rec.annotate = False
    assert rec.count == mark and opened == []
    assert spans.begin(spans.UNPACK) == 0 and spans.end(spans.UNPACK, 0) == 0


def test_foreign_profiler_gets_host_spans_and_no_range():
    full = _full()
    full()
    rec = spans.recorder()
    mark = rec.mark()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        full()
        full()
    assert calls_since(rec, mark) == [2] * len(spans.SPANS)
    assert not [e.name for e in p.events() if e.name.startswith("plane.")]
    full()                            # the profiler stopped: off again
    assert calls_since(rec, mark) == [2] * len(spans.SPANS)


def test_annotated_ranges_on_the_epoch_clock(tmp_path):
    n = 3
    path = tmp_path / "tick.json"
    med = profile_tick.trace(DIMS, SPEC, str(path), device="cpu", n=n)
    assert list(med) == list(spans.SPANS) and all(ms > 0 for ms in med.values())
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    rec = spans.recorder()
    assert not rec.annotate
    for i, name in enumerate(spans.NAMES):
        evs = sorted((e for e in doc["traceEvents"]
                      if e.get("name") == name and e.get("ph") == "X"),
                     key=lambda e: e["ts"])
        assert len(evs) == n, name
        for e, (t0, _) in zip(evs, rec.calls(i)[-n:]):
            got = base + e["ts"] * 1e3
            assert abs(got - rec.epoch_ns(t0)) < 1e6, (name, got, rec.epoch_ns(t0))


def test_threads_keep_their_own_recorders():
    counts = {}

    def run(ticks: int):
        rec = spans.set_flight(True)
        full = _full()
        for _ in range(ticks):
            full()
        counts[ticks] = (rec, list(rec.count))
        spans.set_flight(False)

    threads = [threading.Thread(target=run, args=(k,)) for k in (2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts[2][1] == [2] * len(spans.SPANS)
    assert counts[3][1] == [3] * len(spans.SPANS)
    assert counts[2][0] is not counts[3][0]
    assert spans.current() is not counts[2][0] and spans.current() is not counts[3][0]


def test_flight_count_under_thread_churn():
    """Threads turning their flight recorders on and off at once leave the
    count of threads with one on where it was."""
    import sys

    base = spans._flights
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def churn():
        for _ in range(300):
            spans.set_flight(True)
            spans.set_flight(False)

    threads = [threading.Thread(target=churn) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert spans._flights == base


async def test_runtime_trace_carries_the_blocks_inside_device_step():
    rt = PlaneRuntime(plane.PlaneDims(2, 2, 2, 2), tick_ms=5, egress_shards=1, device="cpu")
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        for k in range(4):
            rt.ingest.push(PacketIn(room=0, track=0, sn=100 + k, ts=960 * k, size=8,
                                    payload=b"p" * 8))
            await rt.step_once()
    finally:
        await rt.stop()
    assert rt.stats["ctrl_upload_s"] > 0.0 and not hasattr(rt, "recent_tick_s")
    records = rt.trace.snapshot()
    assert len(records) == 4
    assert all(list(r["blocks"]) == list(spans.NAMES) for r in records)
    doc = json.loads(trace_export.export_json(records, rt.tick_ms, rt.trace.anchor))
    events = doc["traceEvents"]
    assert trace_export.validate(events) == []
    steps = [e for e in events if e["name"] == "device_step"]
    blocks = [e for e in events if e["name"].startswith("plane.")]
    assert len(blocks) == 4 * len(spans.SPANS)
    for b in blocks:
        step = next(s for s in steps if s["args"]["tick"] == b["args"]["tick"])
        assert b["tid"] == trace_export.TID_DEVICE
        assert step["ts"] <= b["ts"] and b["ts"] + b["dur"] <= step["ts"] + step["dur"] + 0.2
    # ts 0 on the epoch: within the run's wall clock, read beside it.
    assert abs(doc["baseTimeNanoseconds"] - time.time_ns()) < 60e9
    # A block outside its step is a broken trace.
    moved = [dict(b, ts=b["ts"] + 1e6) if b is blocks[0] else b for b in events]
    assert any("outside every device_step" in p for p in trace_export.validate(moved))
