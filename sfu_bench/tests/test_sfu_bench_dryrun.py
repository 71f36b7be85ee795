"""A run of each cell on the CPU at tiny dims, through the harness: the
port's plain path against the reference, and the result line's shape."""

from __future__ import annotations

import pytest

from sfu_bench import core
from sfu_bench.tests.conftest import all_cells, cpu_run

CELLS = all_cells()
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_is_correct_and_well_formed(cell):
    res, out, err = cpu_run(cell)
    assert list(res) == KEYS, "the check's numbers come last"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    e2e = {m["name"] for m in core.load_cell(cell).end_to_end}
    assert set(res["metrics"]) == e2e
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    lines = err.strip().splitlines()
    assert all(line.startswith("check ") for line in lines[-len(res["checks"]):])
    assert res["checks"]["int_words"]["value"] == 0


def test_traced_dry_run_reads_host_layers():
    """--trace 1: the per-layer metrics that a CPU run can read (the tick
    tail); device ones are left out, never 0."""
    res, out, err = cpu_run("northstar_plane_steady", trace=True)
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert set(res["metrics"]) == {"host_tick_p95_ms"}
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    names = {n for n, _ in res["breakdown"]["idle_gaps"]}
    assert names <= {"launch", "sync", "none"}
    assert res["correct"] is True
