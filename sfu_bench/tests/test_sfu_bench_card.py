"""On the card: one short run of each cell through the command, correct and
well formed. Decided inside the fixture; skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from sfu_bench import core


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels have no CPU build")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in core.read_json(
    core.ROOT / "BENCHMARK.json")["workloads"]])
def test_short_run_on_the_card(card, cell):
    res = subprocess.run(
        [sys.executable, "sfu_bench/run.py", "--workload", cell, "--seed", "2147483901",
         "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=str(core.ROOT))
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, res.stderr[-4000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["kind"] == card
    assert line["device"]["busy_s"] > 0
