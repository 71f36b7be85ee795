"""The per-block metrics (`blk_<block>_ms`, sfu_bench/blockspans.py) against
a fake recorder and record, against the port's own recorder after a few
ticks on the CPU, None without device work or without the recorder, and
every new `per_layer` entry backed by its reader."""

from __future__ import annotations

import sys

import pytest

from sfu_bench import blockspans, core, devtrace
from sfu_bench.core import RunRecord

BLOCKS = ("unpack", "decide", "rtpstats", "streamtracker", "bwe", "quality", "red",
          "audio", "allocate", "pack")
MS = 1_000_000


def record(busy_s: float = 0.02, ticks: int = 3, window_s: float = 0.05) -> RunRecord:
    summary = devtrace.TraceSummary(ticks=ticks, window_s=window_s, busy_s=busy_s,
                                    device_sum_s=busy_s)
    return RunRecord(cell="northstar_plane_steady", dims=(4, 4, 4, 4), setup_s=1.0,
                     window_s=2.0, ticks=10, writes=100, tick_s=[0.01] * 10, trace=summary)


class FakeRecorder:
    """`calls` per span index, oldest first."""

    def __init__(self, calls: dict):
        self._calls = calls

    def calls(self, span: int):
        return self._calls.get(span, [])

    def last(self):
        return [(self.calls(i) or [(0, 0)])[-1] for i in range(11)]


def read(name: str, rec):
    return core.load_module("metrics", name).read(rec)


def test_readers_take_the_stretchs_calls(monkeypatch):
    from livekit_server_tpu_torch.utils import spans

    t = 10_000 * MS
    red = spans.SPANS.index("red")
    fake = FakeRecorder({
        # An earlier run's call (before the stretch), then four calls of
        # which the stretch's three ticks are the newest three.
        red: [(t - 900 * MS, 50 * MS), (t, 1 * MS), (t + 10 * MS, 2 * MS),
              (t + 20 * MS, 4 * MS), (t + 30 * MS, 3 * MS)],
        spans.SPANS.index("unpack"): [(t - 900 * MS, 5 * MS), (t + 31 * MS, 1 * MS)],
    })
    monkeypatch.setattr(spans, "current", lambda: fake)
    rec = record(ticks=3, window_s=0.05)
    assert read("blk_red_ms", rec) == pytest.approx(3.0)
    assert read("blk_unpack_ms", rec) == pytest.approx(1.0)   # the stale call left out
    assert read("blk_audio_ms", rec) is None                  # no call of the block
    assert blockspans.block_ms(rec, "not_a_block") is None
    monkeypatch.setattr(spans, "current", lambda: None)
    assert read("blk_red_ms", rec) is None


def test_none_without_device_work_or_without_the_recorder(monkeypatch):
    import livekit_server_tpu_torch.utils as utils
    from livekit_server_tpu_torch.utils import spans

    fake = FakeRecorder({spans.SPANS.index("pack"): [(10 * MS, MS)]})
    monkeypatch.setattr(spans, "current", lambda: fake)
    assert read("blk_pack_ms", record()) == pytest.approx(1.0)
    assert read("blk_pack_ms", record(busy_s=0.0)) is None
    rec = record()
    rec.trace = None
    assert read("blk_pack_ms", rec) is None
    # A program without the recorder (the parent of the spans): None, no raise.
    monkeypatch.setitem(sys.modules, "livekit_server_tpu_torch.utils.spans", None)
    monkeypatch.delattr(utils, "spans")
    assert read("blk_pack_ms", record()) is None


def test_readers_on_the_ports_recorder():
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    from livekit_server_tpu_torch.models import plane, synth
    from livekit_server_tpu_torch.tools import profile_tick
    from livekit_server_tpu_torch.utils import spans

    full = profile_tick.full_tick(plane.PlaneDims(4, 4, 4, 4),
                                  synth.TrafficSpec(video_tracks=2, audio_tracks=2),
                                  torch.device("cpu"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            full()
    got = {b: read(f"blk_{b}_ms", record(ticks=3, window_s=30.0)) for b in BLOCKS}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got == {b: blockspans.block_ms(record(ticks=3, window_s=30.0), b) for b in BLOCKS}


def test_every_block_metric_has_its_entry_and_reader():
    m = core.manifest()
    entries = {x["name"]: x for x in m["per_layer"] if x["name"].startswith("blk_")}
    assert sorted(entries) == sorted(f"blk_{b}_ms" for b in BLOCKS)
    for b in BLOCKS:
        e = entries[f"blk_{b}_ms"]
        assert (e["unit"], e["better"], e["source"], e["moves"], e["workloads"]) == (
            "ms", "lower", "host_clock", "fwd_writes_per_s", ["northstar_plane_steady"])
        assert f"plane.{b}" in e["layer"]
        assert (core.BENCH / "metrics" / f"blk_{b}_ms.py").is_file()
        assert callable(core.load_module("metrics", f"blk_{b}_ms").read)
    # Appended after the accepted metrics, which keep their places.
    names = [x["name"] for x in m["per_layer"]]
    assert names[:5] == ["host_tick_p95_ms", "device_idle_pct", "device_ms_per_tick",
                         "b1_roofline_pct", "b2_roofline_pct"]
    assert names[5:] == [f"blk_{b}_ms" for b in BLOCKS]
