"""The port stands alone: no module of livekit_server_tpu_torch, and not
chip_smoke.py or kernel_ab.py, imports jax or the JAX package; its entry points default
to the card and refuse to fall back to the CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "livekit_server_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "livekit_server_tpu")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_imports_no_jax():
    assert len(SOURCES) > 20
    bad = {str(p.relative_to(ROOT)): names for p in SOURCES
           if (names := [n for n in _imported_modules(p) if _forbidden(n)])}
    assert not bad, f"forbidden imports: {bad}"


def test_forbidden_match_is_exact():
    """The port's own name is allowed; the reference's is not."""
    assert not _forbidden("livekit_server_tpu_torch.models.plane")
    assert _forbidden("livekit_server_tpu.models.plane")
    assert _forbidden("jax.numpy")


def test_entry_points_need_a_card_by_default(monkeypatch):
    from livekit_server_tpu_torch.models import plane, synth
    from livekit_server_tpu_torch.runtime import PlaneRuntime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dims = plane.PlaneDims(1, 2, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlaneRuntime(dims)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plane.init_state(dims)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth.make_state(dims, synth.TrafficSpec())
    assert PlaneRuntime(dims, device="cpu").state.meta.is_video.device.type == "cpu"

    from livekit_server_tpu_torch.models import paged
    from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime

    pdims = paged.PagedDims(2, 4, 2, 8, 2, 4, 4)
    for entry in (paged.init_table, paged.page_init_template, PagedPlaneRuntime):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(pdims)
    assert PagedPlaneRuntime(pdims, device="cpu").table.pg_room.device.type == "cpu"

    # The ops' init_state helpers follow the same rule: "cuda" by default,
    # an error without a card, the CPU only when asked for.
    from livekit_server_tpu_torch.ops import (
        audio, bwe, pacer, red, rtpstats, selector, streamtracker, svc,
    )

    helpers = (audio.init_state, bwe.init_state, bwe.delay_init_state,
               pacer.init_state, red.init_state, rtpstats.init_state,
               selector.init_state, streamtracker.init_state, svc.init_state)
    for init in helpers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(3)
        assert all(x.device.type == "cpu" for x in init(3, device="cpu"))
