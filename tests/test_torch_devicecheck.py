"""The port's device-entry contracts (livekit_server_tpu_torch/analysis/
devicecheck.py): the live contracts against the committed baseline, the
in-place contract at a small CPU shape, and the port's output shapes and
dtypes against the JAX package's own baseline (tools/devicecheck_baseline
.json, read as JSON — the reference's analysis is not imported).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.analysis import core, devicecheck, registry  # noqa: E402
from livekit_server_tpu_torch.models import paged, plane  # noqa: E402
from livekit_server_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent
CFG = core.load_config(REPO_ROOT).rule("devicecheck")
SMALL = plane.PlaneDims(rooms=4, tracks=4, pkts=4, subs=8)
SMALL_PD = paged.PagedDims(rooms=4, tracks=4, pkts=4, subs=8, tpage=2, spage=4,
                           pool_pages=16)

# Deliberate differences from the reference's contracts, by entry name
# (like ROADMAP C5): the reference leaf list is a prefix of the port's.
DIVERGENCES = {
    # The port's LiveDecide always carries the stats/tracker routings
    # st [NL, 5, TP*L, K] and tr [NL, 3, TP*L]: its plain path computes
    # them as its kernel does. The reference's contract was traced on its
    # fallback, which returns None for both (its phase-1 core routes the
    # stats itself there).
    "paged_kernel.decide_pages": [{"shape": [512, 5, 12, 16], "dtype": "int32"},
                                  {"shape": [512, 3, 12], "dtype": "int32"}],
}


def test_live_contracts_equal_the_committed_baseline():
    findings, stale = devicecheck.run_check(REPO_ROOT, CFG)
    assert findings == [], "\n".join(f.render() for f in findings)
    assert stale == []
    baseline = devicecheck.load_baseline(REPO_ROOT / CFG["baseline"])
    registry.import_all()
    assert set(baseline) == set(registry.DEVICE_ENTRIES)
    assert baseline["mesh.sharded_tick"]["sharding"] == [[0, 32], [32, 64]]
    # every allowance carries its reason, and names a registered entry
    allow = CFG["allow_no_inplace"]
    assert allow and all(isinstance(v, str) and v.strip() for v in allow.values())
    assert set(allow) <= set(registry.DEVICE_ENTRIES)


def test_meta_and_cpu_entries_are_declared():
    """The entries that cannot run on the meta device say why; the others
    do run there."""
    specs = devicecheck._specs()
    meta = [s for s in specs if s.not_meta is None]
    assert {s.name for s in meta} >= {"plane.init_state", "plane.apply_ctrl_delta",
                                      "paged.apply_table_delta", "mix.mix_tick",
                                      "mixer.device_mix"}
    for spec in meta:
        contract, problems = devicecheck.run_entry(spec, torch.device("meta"))
        assert contract["out"] and problems == []
    assert all(s.not_meta.strip() for s in specs if s.not_meta is not None)


def _spec(name, build, **kw):
    return devicecheck.EntrySpec(name, build, **kw)


def test_in_place_contract_at_a_small_cpu_shape():
    cpu = torch.device("cpu")
    inp = lambda dims: paged._zero_inputs(dims, 10, 0, cpu)  # noqa: E731
    # the control upload and the live paged tick write the state in place
    ok = [
        _spec("ctrl", lambda d: (plane.apply_ctrl_delta, (
            plane.init_state(SMALL, d), np.arange(2, dtype=np.int32),
            np.ones((4, 2, SMALL.tracks), np.int32),
            np.ones((4, 2, SMALL.tracks, SMALL.subs), np.int32))),
            state_args=(0,), state_out=lambda out: out),
        _spec("fused", lambda d: (paged.paged_plane_tick_fused, (
            plane.init_state(SMALL_PD.pooled(), d), inp(SMALL_PD.pooled()),
            paged.init_table(SMALL_PD, d), torch.arange(8, dtype=torch.int32),
            torch.arange(16, dtype=torch.int32) % 8)), state_args=(0,)),
        _spec("mesh", lambda d: (mesh_mod.make_sharded_tick(mesh_mod.make_mesh([d, d])), (
            mesh_mod.shard_tree(plane.init_state(SMALL, d), mesh_mod.make_mesh([d, d])),
            mesh_mod.shard_tree(inp(SMALL), mesh_mod.make_mesh([d, d])))),
            state_args=(0,), mesh=True),
    ]
    for spec in ok:
        contract, problems = devicecheck.run_entry(spec, cpu)
        assert problems == [], (spec.name, problems)
    assert contract["sharding"] == [[0, 2], [2, 4]]
    # the functional dense tick returns its state in new storage: a
    # finding unless allowed (config.toml says why it is)
    tick = _spec("tick", lambda d: (plane.media_plane_tick,
                                    (plane.init_state(SMALL, d), inp(SMALL))),
                 state_args=(0,))
    _, problems = devicecheck.run_entry(tick, cpu)
    assert len(problems) == 1 and "new storage" in problems[0]
    assert devicecheck.run_entry(tick, cpu, allow_no_inplace=True)[1] == []
    # a fresh output of a large input's shape and dtype is a copy per call
    copy = _spec("copy", lambda d: (lambda x: x + 1, (torch.zeros(1 << 18),)))
    _, problems = devicecheck.run_entry(copy, cpu)
    assert len(problems) == 1 and "fresh allocation" in problems[0]
    assert devicecheck.run_entry(copy, cpu, min_bytes=(1 << 20) + 1)[1] == []
    inplace = _spec("inplace", lambda d: (lambda x: x.add_(1), (torch.zeros(1 << 18),)))
    assert devicecheck.run_entry(inplace, cpu)[1] == []


def test_shapes_and_dtypes_equal_the_jax_package_baseline():
    port = devicecheck.load_baseline(REPO_ROOT / CFG["baseline"])
    ref = json.loads((REPO_ROOT / "tools" / "devicecheck_baseline.json").read_text())["entries"]
    common = sorted(set(port) & set(ref))
    assert set(ref) <= set(port)
    for name in common:
        got, want = port[name]["out"], ref[name]["out"]
        extra = DIVERGENCES.get(name, [])
        assert got == want + extra, name
    assert port["mesh.sharded_tick"]["out"] == ref["mesh.sharded_tick"]["out"]
    assert set(DIVERGENCES) <= set(common)


def test_diff_contracts_reports_drift_and_stale_entries():
    base = {"a": {"out": [{"shape": [4], "dtype": "int32"}], "flops": 0, "bytes": 100,
                  "state_args": [0]},
            "gone": {"out": [], "flops": 0, "bytes": 0, "state_args": []}}
    same = {"a": dict(base["a"])}
    assert devicecheck.diff_contracts(same, base) == ([], ["gone"])
    drift = {"a": {"out": [{"shape": [4], "dtype": "int64"}], "flops": 0, "bytes": 200,
                   "state_args": []},
             "new": {"out": [], "flops": 0, "bytes": 0, "state_args": []}}
    findings, stale = devicecheck.diff_contracts(drift, base)
    msgs = [f.message for f in findings]
    assert stale == ["gone"]
    assert any("output contract drifted: leaf 0: [4]/int32 → [4]/int64" in m for m in msgs)
    assert any("bytes drifted 100 → 200" in m for m in msgs)
    assert any("state_args drifted" in m for m in msgs)
    assert any("`new` has no committed contract" in m for m in msgs)
    assert all(f.rule == devicecheck.DRIFT_RULE for f in findings)
    shapes_only, _ = devicecheck.diff_contracts(drift, base, shapes_only=True)
    assert not any("bytes" in f.message for f in shapes_only)
