"""The bench's real-socket serving run (livekit_server_tpu_torch/tools/
bench_wire.py `wire_bench`) on the CPU, and its `--wire-only` child mode:

* the wire bench at 2 rooms with a 2 ms tick and the express lane on:
  no helper task error, express samples and an active express room, the
  build ledger's keys (structural checks; no latency bound here);
* `--wire-only` in a subprocess, two tick variants: the last line carries
  both runs (the bench's `wire_local` section reads it);
* the reference's latency smoke (tests/test_latency_smoke.py: express
  wire p99 under a loose bound), `slow`-marked as the reference's is.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the planes here are small.
torch.set_num_threads(1)

from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.tools.bench_wire import wire_bench  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Loose by design (the reference's bound): a tick-queued regression of
# the express path lands above it even on a busy host.
P99_BOUND_MS = 50.0


async def test_wire_bench_express_on_the_cpu():
    dims = plane.PlaneDims(rooms=2, tracks=8, pkts=8, subs=6)
    out = await wire_bench(dims, tick_ms=2, duration_s=2.0, warm_ticks=20,
                           egress_shards=1, express_max_subs=dims.subs, device="cpu")
    assert not out.get("task_errors"), out.get("task_errors")
    assert out["express_samples"] > 0, "express tier never carried traffic"
    assert out["express"]["active_rooms"], "no room promoted to express"
    assert out["ticks"] > 0 and out["fwd_packets"] > 0 and out["twcc_acks"] > 0
    assert out["device_rtt_ms"] >= 0
    assert out["kernel_builds_post_warmup"] == 0
    assert {"kernel_builds_total", "kernel_warmup_build_ms", "late_cause",
            "stages", "p99_wire_express_ms"} <= set(out)


def test_wire_only_child_prints_every_variant():
    cp = subprocess.run(
        [sys.executable, "-m", "livekit_server_tpu_torch.tools.bench", "--wire-only", "--cpu",
         "--wire-rooms", "2", "--wire-seconds", "1", "--wire-tick-ms", "5,2e",
         "--wire-kbps", "500"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True,
        text=True, timeout=240, check=True)
    last = json.loads(cp.stdout.strip().splitlines()[-1])
    assert not [k for k in last if k.endswith("_error")], last
    assert last["wire"]["tick_ms"] == 5 and last["wire"]["ticks"] > 0
    assert last["wire_tick2e"]["tick_ms"] == 2
    assert last["wire_tick2e"]["express_samples"] > 0


@pytest.mark.slow
async def test_express_wire_p99_smoke():
    dims = plane.PlaneDims(rooms=2, tracks=8, pkts=8, subs=6)
    out = await wire_bench(dims, tick_ms=2, duration_s=3.0, warm_ticks=30, video_tracks=4,
                           audio_tracks=4, low_latency=True, express_max_subs=dims.subs,
                           egress_shards=1, device="cpu")
    assert out.get("task_errors") is None or not out["task_errors"]
    assert out["express_samples"] > 0, "express tier never carried traffic"
    assert out["express"]["active_rooms"], "no room promoted to express"
    assert out["p99_wire_express_ms"] < P99_BOUND_MS, (
        f"express wire p99 {out['p99_wire_express_ms']} ms ≥ {P99_BOUND_MS} ms — "
        f"arrival-driven sends are queueing somewhere (late causes: {out['late_cause']})")
