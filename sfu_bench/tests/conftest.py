"""Shared pieces of the benchmark's CPU tests (run them from the checkout's
root: `python -m pytest sfu_bench/tests`)."""

from __future__ import annotations

import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Tiny dims of each cell for CPU runs: the cells' widths (tracks, packet
# slots, subscribers), a few rooms.
TINY_ROOMS = 6


def tiny_dims(cell: str):
    from sfu_bench import core
    from sfu_bench.reference.tick import PlaneDims

    d = core.dims_of(core.load_cell(cell).config)
    return PlaneDims(TINY_ROOMS, d.tracks, d.pkts, d.subs)


def cpu_run(cell: str, seed: int = 2**31 + 99, seconds: float = 2.0, trace: bool = False,
            tick_fn=None):
    """One run of `cell` on the CPU at tiny dims; (result, stdout, stderr)."""
    import torch

    from sfu_bench import core

    core.env_setup()
    torch.set_num_threads(1)   # tiny dims: one thread, so parallel test workers do not contend
    out, err = io.StringIO(), io.StringIO()
    res = core.run_cell(cell, seed, seconds, trace, device="cpu", dims=tiny_dims(cell),
                        tick_fn=tick_fn, out=out, err=err)
    last = out.getvalue().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(res))
    return res, out.getvalue(), err.getvalue()


def all_cells() -> list[str]:
    """The benchmark's cells."""
    from sfu_bench import core

    return [w["name"] for w in core.manifest()["workloads"]]
