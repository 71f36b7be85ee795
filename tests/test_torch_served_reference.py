"""The port's served path (runtime/ingest.py, runtime/plane_runtime.py,
runtime/probe.py, runtime/munge.py and its native walker) against the
benchmark's plain reference of it (sfu_bench/reference: staging, probe,
tick, munge), tick by tick from the reference's own initial state, on
seeded cfg4 traffic at PlaneDims(6, 10, 8, 10): 2 SVC video and 8 Opus
tracks a room, an SN gap, one room's estimates dropped and restored so
that its subscribers switch down a layer and back up (with the keyframe
requests that brings); the probe's state and padding are compared too
(the dip's deficits come with congestion here, so no probe starts). Then the
runtime's stage counters (present, non-negative, within the tick's host
time), and its one record of each tick's stages: counted always, kept in
the trace ring only while the ring is on, and exported as `runtime.*`
spans."""

from __future__ import annotations

import asyncio
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from livekit_server_tpu_torch.models import plane as P  # noqa: E402
from livekit_server_tpu_torch.runtime.plane_runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.utils import spans  # noqa: E402
from sfu_bench import compare, core  # noqa: E402
from sfu_bench.gen import runtime as gen  # noqa: E402
from sfu_bench.paths import runtime as path  # noqa: E402
from sfu_bench.paths.plane import meta_ctrl, ref_state, roll_of, traffic_spec  # noqa: E402
from sfu_bench.reference import munge as ref_munge  # noqa: E402
from sfu_bench.reference import probe as ref_probe  # noqa: E402
from sfu_bench.reference import staging as ref_staging  # noqa: E402
from sfu_bench.reference import tick as ref  # noqa: E402

DIMS = ref.PlaneDims(6, 10, 8, 10)
TICKS = 40
EVERY, RTT_MS, TICK_MS = 5, 50, 20
GAP = (5, 1, 0)              # from this tick, room, track: a middle packet is lost
DIP = (2, 8, 24, 0.15)       # room, first and last tick, share of its estimates


def cell():
    return core.load_cell("cfg4_runtime_steady")


def traffic(seed: int):
    """The cell's mix at DIMS: a library of TICKS ticks (no wrap) with the
    SN gap and the estimate dip planted; (spec, library, (the tick that
    lost a packet, its SN)): the first tick from GAP's with three packets
    or more on GAP's track loses its second."""
    c = cell()
    spec = traffic_spec(c.config, c.traffic)
    lib = gen.generate(DIMS, spec, TICKS, seed)
    tick, room, track = GAP
    while True:
        cols = lib.ticks[tick]
        on = np.flatnonzero((cols["room"] == room) & (cols["track"] == track))
        if len(on) >= 3:
            break
        tick += 1
    lost_sn = int(cols["sn"][on[1]])
    lib.ticks[tick] = {f: np.delete(v, on[1]) for f, v in cols.items()}
    room, lo, hi, share = DIP
    est = lib.estimate.copy()
    est[lo:hi + 1, room] *= np.float32(share)
    return spec, lib._replace(estimate=est), (tick, lost_sn)


def runtime(spec, trace: bool = True) -> PlaneRuntime:
    rt = PlaneRuntime(P.PlaneDims(*DIMS), tick_ms=TICK_MS, egress_shards=1, device="cpu",
                      trace_enabled=trace)
    path.configure(rt, DIMS, spec, RTT_MS)
    return rt


async def step(rt, lib, i: int):
    """Tick i's receive batch and reports into the runtime, then its step."""
    rt.ingest.push_batch(**lib.ticks[i], blob=lib.blob)
    ph = gen.phase(DIMS, EVERY)
    for r, s in zip(*np.nonzero(ph == i % EVERY)):
        rt.ingest.push_feedback(int(r), int(s), estimate=float(lib.estimate[i, r, s]))
    return await rt.step_once()


def reference_tick(i, lib, st, pad_track, pub_rtt):
    """The reference's tick i of every room from `st` = (device leaves,
    munger, probe, previous outputs); (new st, outputs, egress rows,
    padding rows, staged inputs)."""
    est, valid = gen.reports(lib, DIMS, i, EVERY)
    inp = ref_staging.stage_tick(DIMS, gen.tick_columns(lib, i), est, valid, pub_rtt, TICK_MS,
                                 bool(roll_of(i, TICK_MS)))
    dev, munger, probe, prev = st
    out, dev, munger, probe, egress, pad, prev = path.served_tick(
        inp, i * TICK_MS, probe, prev, pad_track, dev, munger, TICK_MS, "cpu", DIMS.rooms)
    return (dev, munger, probe, prev), out, egress, pad, inp


@pytest.mark.parametrize("seed", [2**31 + 7, 3000000401])
async def test_served_path_matches_reference(seed):
    spec, lib, (gap_tick, lost_sn) = traffic(seed)
    rt = runtime(spec)
    meta, ctrl = meta_ctrl(DIMS, spec)
    pad_track = ref_probe.pad_track(meta, ctrl)
    pub_rtt = np.where(meta.published, np.float32(RTT_MS), np.float32(0.0))
    rooms = np.arange(DIMS.rooms)
    st = (ref.tree_leaves(ref_state(DIMS, spec, rooms)),
          list(ref_munge.init(DIMS.rooms, DIMS.tracks, DIMS.subs).values()),
          list(ref_probe.init(DIMS.rooms, DIMS.subs)),
          [np.zeros((DIMS.rooms, DIMS.subs), np.float32), np.zeros((DIMS.rooms, DIMS.subs), bool),
           np.zeros((DIMS.rooms, DIMS.subs), bool)])
    tally = compare.Tally(cell().limits["float_err"])
    names = ref.leaf_names(ref_state(DIMS, spec, rooms))
    egress_bad, need_kf, targets, around_gap = 0, 0, [], set()
    try:
        for i in range(TICKS):
            res = await step(rt, lib, i)
            st, out, egress, pad, inp = reference_tick(i, lib, st, pad_track, pub_rtt)
            ok = tally.leaves(list(res.outputs), list(out), list(ref.TickOutputs._fields),
                              f"tick {i} out", care=compare.care(out))
            ok &= tally.leaves(P.tree_leaves(rt.state), st[0], names, f"tick {i} state")
            ok &= tally.leaves([getattr(rt.munger, f) for f in ref_munge.FIELDS], st[1],
                               list(ref_munge.FIELDS), f"tick {i} munger")
            ok &= tally.leaves([getattr(rt.prober, f) for f in path.PROBE_FIELDS], st[2],
                               list(path.PROBE_FIELDS), f"tick {i} probe")
            tally.tick_done(ok)
            b = res.egress_batch
            got = path.rows_of((b.rooms, b.tracks, b.ks, b.subs, b.sn, b.ts, b.pid, b.tl0,
                                b.keyidx), rooms, ref_munge.ROW_FIELDS)
            egress_bad += (path.row_mismatches(got, egress)
                           + path.row_mismatches(path.padding_rows(res.padding, rooms), pad))
            need_kf += int(np.asarray(res.outputs.need_keyframe).sum())
            targets.append(np.asarray(res.outputs.target_layers)[DIP[0]])
            if i == gap_tick:
                r, t = GAP[1:]
                around_gap = {int(x) for x in inp.sn[r, t][inp.valid[r, t]]}
    finally:
        await rt.stop()
    assert tally.int_words == 0 and egress_bad == 0, (tally.first_int, egress_bad)
    assert tally.float_err <= cell().limits["float_err"], tally.worst
    # What the traffic was made to cover happened: Opus beside SVC video,
    # the dip's switch down a spatial layer and back up, keyframe requests,
    # the lost packet.
    video = np.asarray(meta.is_svc)[DIP[0]]
    assert video.sum() == 2 and (~np.asarray(meta.is_video)[DIP[0]]).sum() == 8
    spatial = np.stack(targets)[:, :, video] // P.MAX_TEMPORAL      # [ticks, S, 2]
    top = spatial.max()
    assert (spatial[DIP[1]:DIP[2] + 2] < top).any() and (spatial[-1] == top).all()
    assert need_kf > 0
    assert lost_sn not in around_gap and {lost_sn - 1, lost_sn + 1} <= around_gap


def timed_ticks(rt, lib, n: int) -> float:
    loop = asyncio.new_event_loop()
    try:
        t0 = time.perf_counter()
        for i in range(n):
            loop.run_until_complete(step(rt, lib, i))
        return time.perf_counter() - t0
    finally:
        loop.run_until_complete(rt.stop())
        loop.close()


def test_stage_counters_present_and_within_the_tick():
    spec, lib, _ = traffic(11)
    rt = runtime(spec)
    host_s = timed_ticks(rt, lib, 8)
    st = rt.stats
    stages = ("push_s", "stage_s", "probe_s", "ctrl_upload_s", "device_s", "fanout_s")
    assert all(st[k] >= 0 for k in stages + ("munge_s", "pushed_packets", "egress_rows"))
    assert st["pushed_packets"] == sum(len(lib.ticks[i]["room"]) for i in range(8))
    assert 0 < st["munge_s"] <= st["fanout_s"] and st["egress_rows"] > 0
    assert st["egress_rows"] == st["fwd_packets"]
    assert sum(st[k] for k in stages) <= host_s


@pytest.mark.parametrize("recorder", ["off", "flight", "profiler"])
def test_stage_spans_only_while_the_recorder_is_on(recorder):
    """The tick's one record of its stages: `stats` counts every stage
    whether or not anything traces; the trace ring, when on, holds each
    `runtime.*` stage once a tick; a torch profiler the program did not
    start, with the ring off, gets no stage record (no `runtime.*` range),
    and nothing turns the stepping thread's flight recorder on."""
    spec, lib, _ = traffic(13)
    rt = runtime(spec, trace=recorder == "flight")
    spans.set_flight(False)
    if recorder == "profiler":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            timed_ticks(rt, lib, 3)
        assert not [e.key for e in prof.key_averages() if e.key.startswith("runtime.")]
    else:
        timed_ticks(rt, lib, 3)
    st = rt.stats
    assert st["ticks"] == 3 and len(rt.recent_ticks) == 3
    assert all(st[k] > 0 for k in ("push_s", "stage_s", "probe_s", "ctrl_upload_s",
                                   "device_s", "fanout_s", "munge_s"))
    assert not spans.recorder().flight
    if recorder != "flight":
        assert rt.trace is None
        return
    recs = rt.trace.snapshot()
    assert [sorted(r["runtime"]) for r in recs] == [sorted(spans.RUNTIME.values())] * 3
    for r in recs:
        m0, ms = r["runtime"]["runtime.munge"]
        v0, vs = r["runtime"]["runtime.views"]
        assert r["fanout_t0"] <= m0 and m0 + ms <= v0
        assert v0 + vs <= r["fanout_t0"] + r["fanout_s"]
    assert sum(r["stage_s"] for r in recs) == pytest.approx(st["stage_s"], rel=1e-9)
    assert sum(r["runtime"]["runtime.push"][1] for r in recs) == pytest.approx(st["push_s"],
                                                                              rel=1e-9)


def test_export_carries_the_served_stages():
    """The trace export: each tick's `runtime.*` stages on their lanes, the
    munge/views split inside fan_out, the pushes on the ingest lane, and
    `validate` refusing a split outside its fan_out."""
    from livekit_server_tpu_torch.telemetry import trace_export

    spec, lib, _ = traffic(17)
    rt = runtime(spec)
    timed_ticks(rt, lib, 4)
    events = trace_export.to_chrome(rt.trace.snapshot(), rt.tick_ms)
    assert trace_export.validate(events) == []
    lanes = {}
    for e in events:
        if e["name"].startswith("runtime."):
            lanes.setdefault(e["name"], set()).add(e["tid"])
    assert lanes == {n: {trace_export.STAGE_LANES[n]} for n in spans.RUNTIME.values()}
    assert {"name": "ingest"} in [e["args"] for e in events if e["ph"] == "M"]
    munge = next(e for e in events if e["name"] == "runtime.munge")
    late = dict(munge, ts=munge["ts"] + 1e6)
    assert any("outside every fan_out" in p for p in trace_export.validate(events + [late]))
