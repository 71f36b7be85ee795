"""The twin's CLI (`python -m livekit_server_tpu_torch.runtime.traffic_twin`)
on the CPU, in a subprocess: the micro smoke exits 0 with a last line of
JSON that says ok, and a capacity sweep prints a partial line of the steps
so far after each load, then the whole curve as its last line; with wire
probes (a UDP transport on port 0 a node, probe subscribers on loopback
sockets) each step carries a measured wire p99."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _twin_cli(*args: str) -> list[dict]:
    out = subprocess.run(
        [sys.executable, "-m", "livekit_server_tpu_torch.runtime.traffic_twin", *args,
         "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=240, check=True)
    lines = out.stdout.strip().splitlines()
    assert lines and lines[-1].startswith("{"), out.stdout[-2000:]
    return [json.loads(line) for line in lines if line.startswith("{")]


def test_cli_smoke_last_line_ok():
    last = _twin_cli("--smoke", "--seed", "23")[-1]
    assert last["ok"] is True
    assert last["audio_gaps"] == 0 and last["dup_wire_packets"] == 0
    assert last["joins_admitted"] > 0


def test_cli_sweep_prints_partial_lines_then_the_curve():
    loads = [0.5, 1.0, 2.0, 4.0]
    lines = _twin_cli("--ticks", "30", "--nodes", "2", "--loads", ",".join(map(str, loads)),
                      "--wire-probes", "2")
    partial, final = lines[:-1], lines[-1]
    assert [len(p["steps"]) for p in partial] == [1, 2, 3, 4]
    assert all(p["partial"] is True for p in partial)
    assert "partial" not in final
    assert final["loads"] == loads
    assert [s["offered_load"] for s in final["steps"]] == loads
    assert final["steps"] == partial[-1]["steps"]
    assert "capacity_knee_load" in final
    for step in final["steps"]:
        assert step["dup_wire_packets"] == 0 and step["audio_gaps"] == 0
        assert step["joins_admitted"] > 0
        assert step["wire_p99_ms"] > 0
