"""The tick's block spans in the flight recorder and its export
(livekit_server_tpu_torch/runtime/trace.py, telemetry/trace_export.py): the
ring keeps each tick's blocks and clears them when a slot is reused; the
export adds the block events and nothing else to a record, on the device
lane inside device_step, which `validate` checks; `baseTimeNanoseconds` is
the window's time base on the unix epoch; the paged and the meshed
runtimes carry the blocks their ticks reach; the ring, `recent_ticks` and
`stats` agree on each tick's stages (dense and paged live); and
/debug/trace and /debug/ticks serve them with the ctrl upload's seconds."""

import json
import time

import aiohttp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_paged_fixture as fx  # noqa: E402
from torch_trace_fixture import stage_rows  # noqa: E402

from livekit_server_tpu.telemetry import trace_export as jax_export  # noqa: E402
from livekit_server_tpu_torch.config import load_config  # noqa: E402
from livekit_server_tpu_torch.models import paged, plane  # noqa: E402
from livekit_server_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.plane_runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.trace import NAMES, TickTraceRing  # noqa: E402
from livekit_server_tpu_torch.service.server import create_server  # noqa: E402
from livekit_server_tpu_torch.telemetry import trace_export  # noqa: E402

MS = 1_000_000
ROOM_TICK = ("plane.rtpstats", "plane.streamtracker", "plane.bwe", "plane.quality",
             "plane.red", "plane.audio")


def _blocks_of(device_t0: float) -> list[tuple[int, int]]:
    """SpanRecorder.last-shaped spans: 11 blocks of 0.1 ms, one after the
    other from 0.1 ms into the step, plane.tick around decide..allocate."""
    t = round(device_t0 * 1e9) + MS // 10
    out = [(t + i * MS // 10, MS // 10) for i in range(10)]
    return out + [(out[1][0], 8 * MS // 10)]


def _ring(n_ticks: int = 4, cap: int = 8, with_blocks=lambda i: True) -> TickTraceRing:
    ring = TickTraceRing(cap=cap)
    for i in range(n_ticks):
        t = 100.0 + i * 0.005
        t0, dur = stage_rows(stage=(t + 0.0001, 0.001), upload=(t + 0.0012, 0.0003),
                             device_step=(t + 0.0016, 0.002), fanout=(t + 0.0037, 0.0008),
                             send=(0.0, 0.0004))
        slot = ring.record_tick(idx=i, edge=t, t0=t0, dur=dur, wake_over_us=1.0, depth=1,
                                late=False)
        if with_blocks(i):
            ring.set_blocks(slot, _blocks_of(t + 0.0016))
    return ring


def test_ring_keeps_blocks_and_clears_a_reused_slot():
    ring = _ring(n_ticks=4, with_blocks=lambda i: i % 2 == 0)
    recs = ring.snapshot()
    assert [("blocks" in r) for r in recs] == [True, False, True, False]
    assert list(recs[0]["blocks"]) == list(NAMES)
    assert recs[0]["blocks"]["plane.unpack"] == pytest.approx([recs[0]["device_t0"] + 1e-4,
                                                               1e-4])
    # Ten ticks through eight slots: the two reused slots without blocks
    # hold none of their earlier tick's.
    ring = _ring(n_ticks=10, cap=8, with_blocks=lambda i: i < 8)
    assert [("blocks" in r) for r in ring.snapshot()] == [True] * 6 + [False] * 2


def test_export_adds_only_the_block_events():
    recs = _ring(n_ticks=5).snapshot()
    bare = [{k: v for k, v in r.items() if k != "blocks"} for r in recs]
    events = trace_export.to_chrome(recs, 5)
    assert trace_export.to_chrome(bare, 5) == jax_export.to_chrome(bare, 5)
    blocks = [e for e in events if e["name"].startswith("plane.")]
    assert [e for e in events if not e["name"].startswith("plane.")] == \
        trace_export.to_chrome(bare, 5)
    assert len(blocks) == 5 * len(NAMES)
    assert {e["tid"] for e in blocks} == {trace_export.TID_DEVICE}
    assert trace_export.validate(events) == []
    step = next(e for e in events if e["name"] == "device_step" and e["args"]["tick"] == 0)
    first = next(e for e in blocks if e["name"] == "plane.unpack")
    assert first["ts"] == pytest.approx(step["ts"] + 100.0) and first["dur"] == 100.0


def test_export_base_time_on_the_epoch():
    recs = _ring(n_ticks=3).snapshot()
    anchor = (100.0, 1_800_000_000_000_000_000)
    doc = json.loads(trace_export.export_json(recs, 5, anchor))
    # The earliest stamp is tick 0's edge, at the anchor's perf_counter.
    assert doc["baseTimeNanoseconds"] == 1_800_000_000_000_000_000
    later = (99.5, 1_800_000_000_000_000_000)
    assert trace_export.base_time_ns(recs, later) == 1_800_000_000_500_000_000
    assert "baseTimeNanoseconds" not in json.loads(trace_export.export_json(recs, 5))
    assert "baseTimeNanoseconds" not in json.loads(trace_export.export_json([], 5, anchor))
    ring = TickTraceRing(cap=8)
    perf_s, epoch_ns = ring.anchor
    assert abs((time.time_ns() - epoch_ns) - (time.perf_counter() - perf_s) * 1e9) < 5e6


def test_validate_checks_block_nesting():
    events = trace_export.to_chrome(_ring(n_ticks=2).snapshot(), 5)
    steps = [e for e in events if e["name"] == "device_step"]
    unpack = next(e for e in events if e["name"] == "plane.unpack")
    outside = dict(unpack, ts=steps[0]["ts"] + steps[0]["dur"] + 500.0)
    assert any("outside every device_step" in p
               for p in trace_export.validate([*steps, outside]))
    other_lane = dict(unpack, tid=trace_export.TID_LOOP)
    assert any("outside every device_step" in p
               for p in trace_export.validate([*steps, other_lane]))
    straddle = dict(unpack, dur=steps[0]["dur"])
    assert trace_export.validate([*steps, straddle])


def _paged(mode: str):
    rt = PagedPlaneRuntime(paged.PagedDims(**fx.DIMS), tick_ms=10, egress_shards=1,
                           device="cpu", paged_kernel=mode)
    s = rt.slots.alloc_room("a")
    s.alloc_track("t0")
    s.alloc_sub("p0")
    s.alloc_sub("p1")
    return rt


@pytest.mark.parametrize("kind", ["paged_stock", "paged_live", "meshed"])
async def test_paged_and_meshed_runtimes_carry_their_blocks(kind):
    if kind == "meshed":
        rt = PlaneRuntime(plane.PlaneDims(4, 2, 2, 2), tick_ms=10, egress_shards=1,
                          mesh=tmesh.make_mesh([torch.device("cpu")] * 2))
        want = list(NAMES)
    else:
        rt = _paged("off" if kind == "paged_stock" else "on")
        want = ["plane.unpack", *ROOM_TICK, "plane.pack"]
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        for k in range(3):
            rt.ingest.push(PacketIn(room=0, track=0, sn=100 + k, ts=960 * k, size=8,
                                    payload=b"p" * 8))
            await rt.step_once()
    finally:
        await rt.stop()
    recs = rt.trace.snapshot()
    assert [sorted(r["blocks"]) for r in recs] == [sorted(want)] * 3
    events = trace_export.to_chrome(recs, rt.tick_ms)
    assert trace_export.validate(events) == []
    if kind == "paged_live":
        # The live step's phase-0 slice sits after the unpack it follows,
        # not at the step's head, where it would straddle plane.unpack.
        kernels = [e for e in events if e["name"] == "paged_kernel"]
        unpacks = {e["args"]["tick"]: e for e in events if e["name"] == "plane.unpack"}
        assert len(kernels) == 3
        for k in kernels:
            u = unpacks[k["args"]["tick"]]
            assert k["ts"] >= u["ts"] + u["dur"] - 0.2


def _push_batch(rt, k: int) -> None:
    """Two Opus packets of room 0, track 0 through the batch push."""
    z, f = np.zeros(2, np.int64), np.zeros(2, bool)
    sn = np.arange(100 + 2 * k, 102 + 2 * k, dtype=np.int64)
    rt.ingest.push_batch(z, z, z, sn, 960 * sn, f, z, f, f, f, f, z, z, z,
                         np.full(2, 8, np.int64), np.full(2, 20, np.int64),
                         np.full(2, 127, np.int64), z, np.arange(0, 16, 8), np.full(2, 8),
                         b"p" * 16)


@pytest.mark.parametrize("kind", ["dense", "paged_live"])
async def test_ring_recent_ticks_and_stats_agree(kind):
    """Each tick's stages, read three ways: the ring's snapshot, the
    tick's `recent_ticks` record and the change in `stats` over the tick
    give the same seconds for every stage they share."""
    if kind == "dense":
        rt = PlaneRuntime(plane.PlaneDims(2, 2, 2, 2), tick_ms=10, egress_shards=1,
                          device="cpu")
    else:
        rt = _paged("on")
    counters = ("push_s", "stage_s", "probe_s", "ctrl_upload_s", "device_s", "fanout_s",
                "munge_s", "paged_kernel_steps")
    try:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        for k in range(3):
            before = {c: rt.stats.get(c, 0) for c in counters}
            _push_batch(rt, k)
            await rt.step_once()
            d = {c: rt.stats.get(c, 0) - before[c] for c in counters}
            tick, rec = rt.trace.snapshot(1)[0], rt.recent_ticks[-1]
            run = tick["runtime"]
            assert rec["idx"] == tick["tick"] == k
            for key, stage in (("stage", "stage_s"), ("device", "device_s"),
                               ("fanout", "fanout_s")):
                assert rec[f"{key}_ms"] == round(tick[stage] * 1000.0, 3)
                assert d[stage] == pytest.approx(tick[stage], rel=1e-9)
            assert rec["total_ms"] == round(
                (tick["stage_s"] + tick["device_s"] + tick["fanout_s"]) * 1000.0, 3)
            assert d["ctrl_upload_s"] == pytest.approx(tick["upload_s"], rel=1e-9)
            for name, counter in (("push", "push_s"), ("probe", "probe_s"),
                                  ("munge", "munge_s")):
                assert d[counter] == pytest.approx(run[f"runtime.{name}"][1], rel=1e-9)
            assert run["runtime.stage"] == [tick["stage_t0"] + tick["retier_s"],
                                            tick["stage_s"] - tick["retier_s"]]
            assert run["runtime.device_step"] == [tick["device_t0"], tick["device_s"]]
            assert tick["fanout_t0"] <= run["runtime.munge"][0]
            assert sum(run["runtime.views"]) <= tick["fanout_t0"] + tick["fanout_s"]
            assert tick["send_s"] > 0.0
            if kind == "paged_live":
                assert tick["kernel_s"] > 0.0 and d["paged_kernel_steps"] > 0
                assert rec["paged_kernel_ms"] == round(tick["kernel_s"] * 1000.0, 3)
            else:
                assert tick["kernel_s"] == 0.0 and "paged_kernel_ms" not in rec
    finally:
        await rt.stop()


async def test_debug_routes_serve_blocks_and_upload_seconds():
    cfg = load_config(base={
        "keys": {"k": "s"}, "port": 0, "bind_addresses": ["127.0.0.1"],
        "plane": {"rooms": 2, "tracks_per_room": 2, "pkts_per_track": 2,
                  "subs_per_room": 2, "tick_ms": 10},
        "rtc": {"udp_port": 0, "tcp_port": 0}, "egress": {"shards": 1},
        "limits": {"governor_enabled": False},
    }, env={})
    srv = create_server(cfg, device="cpu")
    await srv.start()
    try:
        rt = srv.room_manager.runtime
        await rt.stop()
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        for k in range(3):
            rt.ingest.push(PacketIn(room=0, track=0, sn=100 + k, ts=960 * k, size=8,
                                    payload=b"p" * 8))
            await rt.step_once()
        base = f"http://127.0.0.1:{srv._runner.addresses[0][1]}/debug"
        async with aiohttp.ClientSession() as s:
            async with s.get(f"{base}/trace?ticks=3") as r:
                trace = await r.json()
            async with s.get(f"{base}/ticks") as r:
                ticks = await r.json()
    finally:
        await srv.stop(force=True)
    events = trace["traceEvents"]
    assert trace_export.validate(events) == []
    assert {e["name"] for e in events} >= set(NAMES)
    recs = rt.trace.snapshot(3)
    assert trace["baseTimeNanoseconds"] == trace_export.base_time_ns(recs, rt.trace.anchor)
    assert abs(trace["baseTimeNanoseconds"] - time.time_ns()) < 120e9
    assert ticks["stats"]["ctrl_upload_s"] > 0.0 and "recent_tick_s" not in ticks
    assert ticks["recent_ticks"]
