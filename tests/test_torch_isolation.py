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
    assert PlaneRuntime(dims, egress_shards=1, device="cpu").state.meta.is_video.device.type == "cpu"

    from livekit_server_tpu_torch.models import paged
    from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime

    pdims = paged.PagedDims(2, 4, 2, 8, 2, 4, 4)
    for entry in (paged.init_table, paged.page_init_template, PagedPlaneRuntime):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(pdims)
    assert PagedPlaneRuntime(pdims, egress_shards=1, device="cpu").table.pg_room.device.type == "cpu"

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


SERVING_PROBE = r"""
import asyncio, importlib.abc, json, sys
import numpy, torch

class Absent(importlib.abc.MetaPathFinder):
    # Packages a machine serving the port need not have (cryptography is optional).
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"aiohttp", "msgpack", "yaml", "cryptography", "jax"}:
            raise ImportError(f"{name} is not installed")

sys.meta_path.insert(0, Absent())
before = {m.split(".")[0] for m in sys.modules}
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from livekit_server_tpu_torch.models import plane

async def main():
    cfg = cs.serving_config(dense_dims=plane.PlaneDims(2, 4, 4, 4))
    rm = cs.RoomManager(cfg, cs.LocalRouter(cs.LocalNode()), cs.LocalStore(),
                        telemetry=cs.TelemetryService(cfg), device="cpu")
    req, resp = cs.MessageChannel(), cs.MessageChannel()
    task = asyncio.ensure_future(rm.start_session(
        "r", {"identity": "a", "name": "a"}, req, resp))
    while not rm.rooms.get("r") or not rm.rooms["r"].participants:
        await asyncio.sleep(0.01)
    await rm.runtime.step_once()
    rm.start()
    await asyncio.sleep(0.05)
    req.close()
    await rm.stop()
    await task
    # The UDP media wire: two RoomManagers with the transport on loopback,
    # sealed publishers and punched subscribers, three lockstep ticks.
    dims = plane.PlaneDims(2, 4, 4, 4)
    rigs = [cs.UdpRig(await cs.udp_room_manager("cpu", cs.udp_config(dense_dims=dims)),
                      [4, 4], [4, 4], 2) for _ in range(2)]
    for rig in rigs:
        await rig.join(cs.RUNTIME_SPEC)
    lock = await cs.udp_lockstep(rigs[0], rigs[1], cs.RUNTIME_SPEC, 3)
    assert lock["datagrams_compared"] > 0 and cs.REQUIRE_ENCRYPTION
    for rig in rigs:
        await rig.close()
    # The failure and overload plane (supervisor, integrity audit, fault
    # injection, checkpoint frames): chip_smoke's drills on a small plane.
    report, _ = await cs.drills("cpu", plane.PlaneDims(8, 10, 8, 10))
    assert report["bitflip"]["rows_repaired"] == 1 and report["stall"]["restarts"] == 2

asyncio.run(main())
after = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(after - before)))
"""


def test_serving_path_needs_only_torch_numpy_and_stdlib():
    """What chip_smoke's serving phases load (config, RoomManager, rtc,
    routing, telemetry, the codec, the runtime loop, the UDP media wire:
    transport, native libraries, sealed frames through libcrypto; and the
    failure and overload plane: supervisor, integrity audit, governor,
    fault injection, checkpoint frames) runs with aiohttp, msgpack, PyYAML
    and cryptography absent, as they may be on a card's host, and adds no
    module outside the port, torch, numpy and the standard library."""
    import json
    import os
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", SERVING_PROBE, str(ROOT)], cwd=ROOT,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300, check=True)
    added = set(json.loads(out.stdout.strip().splitlines()[-1]))
    own = {"chip_smoke", "livekit_server_tpu_torch", "__main__"}
    # numpy's compiled random generators register the Cython runtime.
    numpy_runtime = {m for m in added if m == "cython_runtime" or m.startswith("_cython_")}
    outside = {m for m in added - own - numpy_runtime if m not in sys.stdlib_module_names}
    assert not outside, f"serving path imports {outside}"
    assert "livekit_server_tpu_torch" in added


def test_port_native_sources_are_its_own():
    """The port builds its native libraries from its own copies
    (livekit_server_tpu_torch/native/csrc) into its own build directory;
    no port source reaches for the repository's root native/ sources."""
    import re

    from livekit_server_tpu_torch import native

    pkg = ROOT / "livekit_server_tpu_torch"
    assert native._CSRC == pkg / "native" / "csrc"
    for name in ("rtp_parser", "egress", "munge"):
        assert (native._CSRC / f"{name}.cpp").is_file()
        assert native.library_path(name).parent == pkg / "_build" / "native"
    root_native = re.compile(r'parents\[\d+\]\s*/\s*"native"|ROOT\s*/\s*"native"')
    bad = [str(p.relative_to(ROOT)) for p in SOURCES if root_native.search(p.read_text())]
    assert not bad, f"sources reading the root native/: {bad}"
