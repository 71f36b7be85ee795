"""The per-block tick profile (livekit_server_tpu_torch/tools/profile_tick.py)
on the CPU: `profile(...)` at a tiny shape returns the reference profile's
block labels (read from tools/profile_tick.py's source, not imported), in
its order, each with a finite positive time; the CLI's shapes are the
reference's; the CLI runs on the CPU and prints the blocks' sum."""

import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.models import plane, synth  # noqa: E402
from livekit_server_tpu_torch.tools import profile_tick  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _reference_labels() -> list[str]:
    """The label of every `timeit(fn, args, n, label)` call in the
    reference's tools/profile_tick.py, in source order."""
    tree = ast.parse((ROOT / "tools" / "profile_tick.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "timeit" and len(n.args) == 4]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [n.args[3].value for n in calls]


def _reference_shapes() -> dict:
    """SHAPES of the reference's tools/profile_tick.py: name → (dims
    args, traffic keywords)."""
    tree = ast.parse((ROOT / "tools" / "profile_tick.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "SHAPES")
    out = {}
    for key, val in zip(node.value.keys, node.value.values):
        dims_call, spec_call = val.elts
        out[key.value] = (tuple(ast.literal_eval(a) for a in dims_call.args),
                          {k.arg: ast.literal_eval(k.value) for k in spec_call.keywords})
    return out


def test_profile_blocks_are_the_references_in_order():
    detail = {}
    res = profile_tick.profile(plane.PlaneDims(4, 4, 4, 4),
                               synth.TrafficSpec(video_tracks=2, audio_tracks=2, svc=True),
                               device="cpu", n=2, detail=detail)
    labels = _reference_labels()
    assert len(labels) == 15
    assert list(res) == labels
    assert all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in res.values())
    assert all(detail[label]["method"] == "wall" for label in labels)
    total = profile_tick.blocks_sum(res)
    assert 0 < total < sum(res.values())


def test_profile_shapes_are_the_references():
    ref = _reference_shapes()
    assert list(profile_tick.SHAPES) == list(ref)
    for name, (dims, spec_kw) in ref.items():
        got_dims, got_spec = profile_tick.SHAPES[name]
        assert tuple(got_dims) == dims
        assert got_spec == synth.TrafficSpec(**spec_kw)


def test_profile_cli_on_the_cpu():
    cp = subprocess.run(
        [sys.executable, "-m", "livekit_server_tpu_torch.tools.profile_tick", "--shape",
         "default", "--device", "cpu", "--n", "1"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True, text=True,
        timeout=240, check=True)
    lines = cp.stdout.strip().splitlines()
    assert lines[0].startswith("shape=default")
    assert lines[1].startswith(profile_tick.FULL)
    assert lines[-1].startswith("sum of the blocks in the tick")
    assert len(lines) == 2 + 15
