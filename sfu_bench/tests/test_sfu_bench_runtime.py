"""The served-path cell (`cfg4_runtime_steady`, `paths/runtime.py`): its
output check catches a munge fault planted in the path's munge seam and
the control (the reference in bfloat16 in the port's tick's place); a
program without the runtime's stage counters reads None for their
readers and is still correct; the readers' arithmetic; the reference's
staging against the port's ingest on a batch with late, duplicate and
overflowing packets; the manifest's new entries, appended; and on the
card, the fault and the control at the cell's own size."""

from __future__ import annotations

import io

import numpy as np
import pytest

from sfu_bench import core, devtrace
from sfu_bench.core import RunRecord
from sfu_bench.reference import control
from sfu_bench.tests.conftest import cpu_run

CELL = "cfg4_runtime_steady"
READERS = ("rt_push_ms", "rt_stage_ms", "rt_device_step_ms", "rt_munge_ms", "rt_fanout_ms")
# Counters the runtime kept before the served path's own.
OLDER = ("stage_s", "ctrl_upload_s", "device_s", "fanout_s")


def path_module():
    return core.load_module("paths", "runtime")


@pytest.mark.parametrize("what", ["munge", "bf16"])
def test_munge_fault_and_control_are_not_correct(monkeypatch, what):
    if what == "munge":
        monkeypatch.setattr(path_module(), "munge_seam", path_module().MUNGE_FAULTS["sn_plus_one"])
        res, _, err = cpu_run(CELL)
        assert res["checks"]["egress_rows"]["value"] > 0, err
    else:
        res, _, err = cpu_run(CELL, tick_fn=control.tick_bf16)
        assert res["checks"]["float_err"]["value"] > res["checks"]["float_err"]["limit"], err
    assert res["correct"] is False and res["failed"] > 0


def test_without_the_counters_readers_give_none_and_the_run_is_correct(monkeypatch):
    session = path_module().Session
    totals = session.layer_totals
    monkeypatch.setattr(session, "layer_totals",
                        lambda self: {k: v for k, v in totals(self).items() if k in OLDER})
    res, _, err = cpu_run(CELL, trace=True)
    assert res["correct"] is True, err
    # The device step's counters are older than the others: it still reads.
    assert set(res["metrics"]) == {"rt_device_step_ms"}
    assert res["metrics"]["rt_device_step_ms"]["value"] > 0


def test_traced_run_reads_every_stage():
    res, _, err = cpu_run(CELL, trace=True)
    assert res["correct"] is True, err
    assert set(res["metrics"]) == set(READERS)
    assert all(m["value"] > 0 and m["unit"] == "ms" for m in res["metrics"].values())
    assert {n for n, _ in res["breakdown"]["idle_gaps"]} <= {"push", "step", "none"}


def test_readers_arithmetic():
    layers = {"push_s": 0.5, "stage_s": 1.0, "probe_s": 0.25, "ctrl_upload_s": 0.05,
              "device_s": 0.45, "munge_s": 0.75, "fanout_s": 2.0, "pushed_packets": 9.0}
    rec = RunRecord(cell=CELL, dims=(6, 10, 8, 10), setup_s=1.0, window_s=2.0, ticks=25,
                    writes=100, tick_s=[0.08] * 25, layers=layers,
                    trace=devtrace.TraceSummary(ticks=4, window_s=0.4, busy_s=0.0,
                                                device_sum_s=0.0))
    got = {n: core.load_module("metrics", n).read(rec) for n in READERS}
    assert got == pytest.approx({"rt_push_ms": 20.0, "rt_stage_ms": 50.0,
                                 "rt_device_step_ms": 20.0, "rt_munge_ms": 30.0,
                                 "rt_fanout_ms": 50.0})
    rec.ticks = 0
    assert all(core.load_module("metrics", n).read(rec) is None for n in READERS)


def test_reference_staging_is_the_ports_ingest():
    """Late, duplicate and overflowing packets in one batch: the
    reference's staged slots equal the port's drain, field by field."""
    from livekit_server_tpu_torch.models import plane as P
    from livekit_server_tpu_torch.runtime.ingest import IngestBuffer
    from sfu_bench.reference import staging, tick

    dims = tick.PlaneDims(2, 3, 4, 2)
    # (room, track, sn, layer): a late SN, a duplicate, SNs across the
    # 16-bit wrap, two layers, and six packets for four slots.
    pkts = [(0, 0, 10, 0), (0, 0, 12, 0), (0, 0, 11, 0), (0, 0, 12, 0),
            (0, 1, 65535, 1), (0, 1, 1, 0), (0, 1, 0, 1), (0, 1, 65534, 0),
            (1, 2, 5, 0), (1, 2, 6, 0), (1, 2, 7, 0), (1, 2, 8, 0), (1, 2, 9, 0), (1, 2, 4, 0)]
    n = len(pkts)
    rng = np.random.default_rng(3)
    cols = {f: np.asarray([p[i] for p in pkts], np.int64)
            for i, f in enumerate(("room", "track", "sn", "layer"))}
    for f in ("ts", "arrival_rtp", "pid", "tl0", "keyidx", "temporal"):
        cols[f] = rng.integers(0, 1 << 20, n)
    for f in ("keyframe", "layer_sync", "begin_pic", "marker", "ts_aligned"):
        cols[f] = rng.integers(0, 2, n).astype(bool)
    cols.update(end_frame=cols["marker"], size=rng.integers(50, 1200, n).astype(np.int32),
                frame_ms=np.full(n, 20, np.int32), audio_level=rng.integers(0, 127, n))
    ing = IngestBuffer(P.PlaneDims(*dims), 20)
    ing.push_batch(**cols, pay_start=np.zeros(n, np.int64), pay_length=np.zeros(n, np.int64),
                   blob=np.zeros(1, np.uint8))
    got, _ = ing.drain()
    want = staging.stage_packets(dims, cols)
    valid = want["valid"]
    assert np.array_equal(np.asarray(got.valid), valid) and valid.sum() == 11
    for f in staging.SLOT_FIELDS + ("ts_jump",):
        assert np.array_equal(np.asarray(getattr(got, f))[valid], want[f][valid]), f


def test_new_entries_are_appended():
    m = core.manifest()
    assert m["configs"][-1]["name"] == "cfg4_1k_rooms_10p_svc"
    assert m["workloads"][-1] == {**m["workloads"][-1], "name": CELL,
                                  "config": "cfg4_1k_rooms_10p_svc",
                                  "traffic": "runtime_steady", "chips": 1}
    assert [x["name"] for x in m["per_layer"][-5:]] == list(READERS)
    for x in m["per_layer"][-5:]:
        assert (x["unit"], x["better"], x["source"], x["moves"], x["workloads"]) == (
            "ms", "lower", "host_clock", "fwd_writes_per_s", [CELL])
    assert core.load_cell(CELL).limits == {"int_words": 0, "float_err": 0.001, "egress_rows": 0}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels have no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["munge", "bf16"])
def test_fault_and_control_on_the_card(card, monkeypatch, what):
    """At the cell's own size on the card, a 10 s window."""
    if what == "munge":
        monkeypatch.setattr(path_module(), "munge_seam", path_module().MUNGE_FAULTS["sn_plus_one"])
    res = core.run_cell(CELL, 2**31 + 1201, 10.0, False,
                        tick_fn=control.tick_bf16 if what == "bf16" else None,
                        out=io.StringIO(), err=io.StringIO())
    assert res["correct"] is False


def test_padding_rows_are_the_ports():
    """Probe padding runs of up to PAD_MAX packets: the reference's rows
    and lanes equal the port's munger's, each packet of a run in its own
    row."""
    from types import SimpleNamespace

    from livekit_server_tpu_torch.models import plane as P
    from livekit_server_tpu_torch.runtime.munge import HostMunger
    from sfu_bench.reference import munge as ref_munge, tick

    dims = tick.PlaneDims(3, 4, 2, 5)
    rng = np.random.default_rng(5)
    port = HostMunger(P.PlaneDims(*dims))
    state = ref_munge.init(3, 4, 5)
    for f in ref_munge.FIELDS:
        v = (rng.integers(0, 2, (3, 4, 5)).astype(bool) if f in ref_munge.FLAGS
             else rng.integers(0, 1 << 16, (3, 4, 5)))
        state[f] = v.copy()
        getattr(port, f)[...] = v
    pad_num = rng.integers(0, tick.PAD_MAX + 1, (3, 5)).astype(np.int32)
    pad_track = rng.integers(-1, 4, (3, 5)).astype(np.int32)
    got = [SimpleNamespace(room=r, track=t, sub=s, sn=sn, ts=ts)
           for r, t, s, sn, ts in port.padding(pad_num, pad_track, ts_advance=1800)]
    state, want = ref_munge.padding(state, pad_num, pad_track, 1800)
    path = path_module()
    rows = path.padding_rows(got, np.arange(3))
    assert len(rows["sn"]) == len(want["sn"]) > tick.PAD_MAX
    assert path.row_mismatches(rows, want) == 0
    for f in ref_munge.FIELDS:
        assert np.array_equal(getattr(port, f), state[f]), f
    rows["sn"][0] += 1
    assert path.row_mismatches(rows, want) == 1
