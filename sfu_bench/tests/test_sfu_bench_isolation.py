"""What the benchmark runs imports neither JAX nor the JAX package, and its
reference imports nothing of the port. Top-level module names are compared
whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from sfu_bench import core
from sfu_bench.tests.conftest import all_cells

FORBIDDEN = {"jax", "jaxlib", "flax", "livekit_server_tpu"}

DRY_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from sfu_bench.tests.conftest import cpu_run
res, _, _ = cpu_run({cell!r})
print(json.dumps({{"correct": res["correct"],
                  "tops": sorted({{m.split(".", 1)[0] for m in sys.modules}})}}))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import sfu_bench.reference.control, sfu_bench.reference.node, sfu_bench.gen.library
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def run_py(code: str) -> str:
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(core.ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", all_cells())
def test_dry_run_loads_no_jax(cell):
    got = json.loads(run_py(DRY_RUN.format(root=str(core.ROOT), cell=cell)))
    assert got["correct"] is True
    assert not FORBIDDEN.intersection(got["tops"]), got["tops"]
    assert "livekit_server_tpu_torch" in got["tops"]


def test_reference_imports_nothing_of_the_port():
    tops = set(json.loads(run_py(REFERENCE.format(root=str(core.ROOT)))))
    assert not (FORBIDDEN | {"livekit_server_tpu_torch"}).intersection(tops), sorted(tops)
    for path in sorted((core.BENCH / "reference").rglob("*.py")) + sorted(
            (core.BENCH / "gen").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".", 1)[0]
                assert top not in FORBIDDEN | {"livekit_server_tpu_torch"}, (path, n)
