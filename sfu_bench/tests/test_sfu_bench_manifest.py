"""BENCHMARK.json against the contract's shape, and every cell's files found
by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from sfu_bench import core
from sfu_bench.tests.conftest import all_cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def manifest():
    return core.read_json(core.ROOT / "BENCHMARK.json")


def test_keys_names_and_units():
    m = core.manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert m["paths"] == ["sfu_bench"] and m["command"] == ["python3", "sfu_bench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"]) and NAME.match(w["traffic"])
    for met in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(met["unit"]) and met["better"] in ("lower", "higher")
        if "layer" in met:
            assert TEXT.match(met["layer"])
    for met in m["end_to_end"]:
        assert set(met) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert met["source"] in ("host_clock", "device_trace")
        assert 0.01 <= met["bound"] <= 0.25
    for met in m["per_layer"]:
        assert set(met) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                            "moves"}
    assert len(json.dumps(m)) < 64 * 1024
    assert all(c["name"] in {w["config"] for w in m["workloads"]} for c in m["configs"])
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(m["workloads"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    m = core.manifest()
    for w in m["workloads"]:
        e2e = [x["name"] for x in m["end_to_end"] if core.reports(x, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(core.reports(x, w["name"]) for x in m["per_layer"])


def test_moves_is_reported_by_each_of_its_cells():
    m = core.manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for met in m["per_layer"]:
        assert met["moves"] in e2e
        for cell in met.get("workloads", [w["name"] for w in m["workloads"]]):
            assert core.reports(e2e[met["moves"]], cell), (met["name"], cell)


@pytest.mark.parametrize("cell", all_cells())
def test_cell_files_found_by_name(cell):
    m = core.manifest()
    c = core.load_cell(cell, m)
    assert core.load_module("paths", c.path).Session
    for met in c.end_to_end + c.per_layer:
        assert callable(core.load_module("metrics", met["name"]).read)
    cfg_file = [x for x in m["configs"] if x["name"] == c.entry["config"]][0]
    assert c.config["name"] == c.entry["config"]
    assert sorted(c.config["reduced"]) == sorted(cfg_file["reduced"])
    assert set(c.limits) >= {"int_words", "float_err"}


def test_a_new_config_traffic_and_metric_are_files_and_entries(tmp_path, monkeypatch):
    """Discovery by name: a copy of the checkout gains a configuration, a
    traffic mix and a metric as new files plus BENCHMARK.json entries, and
    the harness finds them with no edit to a file it had."""
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH, root / "sfu_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest()
    cfg = json.loads((core.ROOT / m["configs"][0]["file"]).read_text())
    cfg.update(name="ns_copy", rooms=8)
    (root / "sfu_bench/configs/ns_copy.json").write_text(json.dumps(cfg))
    tr = json.loads((core.BENCH / "traffic/plane_steady.json").read_text())
    tr["estimate_factor"] = 0.4
    (root / "sfu_bench/traffic/plane_congested.json").write_text(json.dumps(tr))
    (root / "sfu_bench/metrics/ticks_in_window.py").write_text(
        "def read(rec):\n    return rec.ticks\n")
    (root / "sfu_bench/limits/ns_copy_congested.json").write_text(
        json.dumps({"int_words": 0, "float_err": 1e-4}))
    m["configs"].append({"name": "ns_copy", "source": "a copy", "reduced": ["rooms"],
                         "file": "sfu_bench/configs/ns_copy.json", "why": "a test"})
    m["workloads"].append({"name": "ns_copy_congested", "config": "ns_copy",
                           "traffic": "plane_congested", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "ticks_in_window", "unit": "ticks", "better": "higher",
                           "source": "host_clock", "layer": "harness",
                           "moves": "fwd_writes_per_s", "workloads": ["ns_copy_congested"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    monkeypatch.setattr(core, "ROOT", root)
    monkeypatch.setattr(core, "BENCH", root / "sfu_bench")
    c = core.load_cell("ns_copy_congested")
    assert c.config["rooms"] == 8 and c.traffic["estimate_factor"] == 0.4
    assert [x["name"] for x in c.per_layer][-1] == "ticks_in_window"
    reader = core.load_module("metrics", "ticks_in_window")
    assert reader.__file__.startswith(str(root)) and reader.read(type("R", (), {"ticks": 3})) == 3
