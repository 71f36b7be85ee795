"""The trace reduction and the roofline arithmetic on synthetic inputs."""

from __future__ import annotations

import pytest

from sfu_bench import devtrace, roofline, stats
from sfu_bench.core import RunRecord


def test_union_gaps_and_attribution():
    dev = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("memcpy", 3.0, 4.0), ("k1", 6.0, 7.0)]
    assert devtrace.union_length([(s, e) for _, s, e in dev]) == pytest.approx(4.0)
    spans = [("push", 0.0, 2.5), ("stage", 2.5, 5.0), ("fan_out", 5.0, 8.0)]
    s = devtrace.reduce(dev, spans, ticks=2, window_s=8.0)
    assert s.busy_s == pytest.approx(4.0) and s.device_sum_s == pytest.approx(4.5)
    assert s.gaps == pytest.approx({"push": 0.5, "stage": 1.5, "fan_out": 2.0})
    assert s.ops["k1"] == pytest.approx([2.0, 2])
    b = s.breakdown()
    assert b["device_ops"][0] == ["k1", 2.0] and len(b["device_ops"]) == 3
    assert b["idle_gaps"][0] == ["fan_out", 2.0]
    assert s.kernel("k1") == pytest.approx((2.0, 2)) and s.kernel("absent") is None


def test_nested_span_takes_the_gap():
    dev = [("k", 0.0, 1.0), ("k", 3.0, 4.0)]
    spans = [("device_step", 0.0, 4.0), ("inner", 1.5, 2.5)]
    s = devtrace.reduce(dev, spans, ticks=1, window_s=4.0)
    assert s.gaps == pytest.approx({"device_step": 1.0, "inner": 1.0})


def read(name, rec):
    from sfu_bench import core

    return core.load_module("metrics", name).read(rec)


def test_idle_and_roofline_readers():
    dims = (10240, 8, 16, 50)
    b1 = roofline.decide_rooms_bytes(*dims)
    b2 = roofline.budget_rooms_bytes(10240, 8, 50)
    assert (b1, b2) == (163_266_560, 66_682_880)   # PERF.md's kernel table
    card = "NVIDIA H100 80GB HBM3"
    k1_s = 2 * b1 / 3.35e12                        # a launch at half the bound's speed
    summary = devtrace.TraceSummary(
        ticks=4, window_s=0.1, busy_s=0.025, device_sum_s=0.03,
        ops={"decide_rooms_kernel(int const*)": [4 * k1_s, 4],
             "void budget_rooms_kernel<8>": [3 * 4 * b2 / 3.35e12, 3]})
    rec = RunRecord(cell="x", dims=dims, setup_s=1.0, window_s=2.0, ticks=10, writes=100,
                    tick_s=[0.01] * 19 + [0.05], trace=summary, device_name=card)
    assert read("device_idle_pct", rec) == pytest.approx(75.0)
    assert read("device_ms_per_tick", rec) == pytest.approx(7.5)
    assert read("b1_roofline_pct", rec) == pytest.approx(50.0)
    assert read("b2_roofline_pct", rec) == pytest.approx(25.0)
    assert read("fwd_writes_per_s", rec) == pytest.approx(50.0)
    assert read("host_tick_p95_ms", rec) == pytest.approx(10.0)
    rec.device_name = "an unknown card"
    assert read("b1_roofline_pct", rec) is None
    rec.trace = None
    assert read("device_idle_pct", rec) is None and read("b2_roofline_pct", rec) is None


def test_p95_rank_rule():
    xs = list(range(1, 101))
    assert stats.p95(xs) == 95 and stats.p95([]) is None and stats.p95([7.0]) == 7.0
