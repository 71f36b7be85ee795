"""The port stands alone: no module of livekit_server_tpu_torch, and not
chip_smoke.py or kernel_ab.py, imports jax or the JAX package (the
multi-node modules copied from it included); its entry points default to
the card and refuse to fall back to the CPU; the serving path, the
multi-node plane among it, needs only torch, numpy and the standard
library; so do the traffic twin and the trace export, which the card's
machine runs without aiohttp, msgpack or PyYAML."""

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

    # The traffic twin and the trace export's self-test: the card unless
    # the caller asks for the CPU.
    import asyncio

    from livekit_server_tpu_torch.runtime import traffic_twin
    from livekit_server_tpu_torch.telemetry import trace_export

    micro = traffic_twin.Scenario.micro()
    for entry in (lambda: traffic_twin.TrafficTwin(micro, nodes=1),
                  traffic_twin.run_micro_smoke,
                  lambda: asyncio.run(traffic_twin.capacity_curve(micro)),
                  trace_export.selftest):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert traffic_twin.TrafficTwin(micro, nodes=1, device="cpu").device.type == "cpu"


# The head of every probe: the packages a machine serving the port need
# not have (cryptography is optional) made unimportable, and the modules
# loaded before the probe's own imports noted.
PROBE_HEAD = r"""
import asyncio, importlib.abc, json, sys, time
import numpy, torch

class Absent(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"aiohttp", "msgpack", "yaml", "cryptography", "jax"}:
            raise ImportError(f"{name} is not installed")

sys.meta_path.insert(0, Absent())
before = {m.split(".")[0] for m in sys.modules}
sys.path.insert(0, sys.argv[1])
"""

SERVING_PROBE = PROBE_HEAD + r"""
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
    ticks, deadline = rm.runtime.stats["ticks"], time.monotonic() + 60
    while rm.runtime.stats["ticks"] < ticks + 2:
        assert time.monotonic() < deadline, "the serving loop never ticked"
        await asyncio.sleep(0.01)
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
    # The multi-node plane (chip_smoke's migration phase, in one process):
    # a BusServer, two nodes on TCPBusClients with KVRouter, KVStore and
    # the migration and fleet planes; a room migrated, then a drain.
    from livekit_server_tpu_torch.routing import create_router
    from livekit_server_tpu_torch.routing.tcpbus import BusServer, TCPBusClient
    from livekit_server_tpu_torch.service.store import KVStore

    srv = BusServer()
    await srv.start("127.0.0.1", 0)
    nodes = []
    for _ in range(2):
        bus = await TCPBusClient.connect("127.0.0.1", srv.port)
        cfg = cs.migration_config(srv.port, plane.PlaneDims(4, 4, 4, 4))
        router = create_router(cs.LocalNode(), bus)
        node = cs.RoomManager(cfg, router, KVStore(bus), device="cpu")
        assert node.migration is not None and node.fleet is not None
        await router.register_node()
        node.start()
        nodes.append(node)
    a, b = nodes
    await a.get_or_create_room("moved")
    assert await a.migrate_room("moved", b.router.local_node.node_id)
    await a.get_or_create_room("drained")
    assert (await a.migration.drain_node())["failed"] == []
    assert set(b.rooms) == {"moved", "drained"} and not a.rooms
    for node in nodes:
        await node.stop()
    srv.close()

asyncio.run(main())
after = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(after - before)))
"""


def test_serving_path_needs_only_torch_numpy_and_stdlib():
    """What chip_smoke's serving phases load (config, RoomManager, rtc,
    routing, telemetry, the codec, the runtime loop, the UDP media wire:
    transport, native libraries, sealed frames through libcrypto; and the
    failure and overload plane: supervisor, integrity audit, governor,
    fault injection, checkpoint frames; and the multi-node plane: the TCP
    bus, KVRouter, KVStore, migration and fleet planes) runs with aiohttp,
    msgpack, PyYAML and cryptography absent, as they may be on a card's
    host, and adds no module outside the port, torch, numpy and the
    standard library."""
    outside = _loaded_outside(SERVING_PROBE)
    assert not outside, f"serving path imports {outside}"


def _loaded_outside(probe: str) -> set[str]:
    """Run `probe` in a fresh interpreter; the top-level modules it loaded
    beyond the port, chip_smoke, torch, numpy and the standard library."""
    import json
    import os
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", probe, str(ROOT)], cwd=ROOT,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300, check=True)
    added = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "livekit_server_tpu_torch" in added
    own = {"chip_smoke", "livekit_server_tpu_torch", "__main__"}
    # numpy's compiled random generators register the Cython runtime.
    numpy_runtime = {m for m in added if m == "cython_runtime" or m.startswith("_cython_")}
    return {m for m in added - own - numpy_runtime if m not in sys.stdlib_module_names}


TWIN_PROBE = PROBE_HEAD + r"""
from livekit_server_tpu_torch.runtime import traffic_twin
from livekit_server_tpu_torch.telemetry import trace_export

out = traffic_twin.run_micro_smoke(seed=23, device="cpu")
assert out["ok"] and out["joins_offered"] > 0, out
problems = trace_export.selftest(ticks=4, device="cpu")
assert problems == [], problems
after = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(after - before)))
"""


def test_twin_and_trace_export_need_only_torch_numpy_and_stdlib():
    """The twin's micro smoke (nodes built by service/stack.py, no HTTP)
    and the trace export's self-test run on the CPU with aiohttp, msgpack,
    PyYAML, cryptography and jax absent, as on the card's machine, and
    load no module outside the port, torch, numpy and the standard
    library."""
    outside = _loaded_outside(TWIN_PROBE)
    assert not outside, f"the twin imports {outside}"


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


def test_multinode_modules_are_the_ports_own():
    """The multi-node modules exist in the port as its own files, and the
    ones chip_smoke's migration phase runs import nothing beyond the
    port, torch, numpy and the standard library; nor do the node stack,
    the traffic twin and the trace export (checked statically; the
    serving and twin probes above run them)."""
    import sys

    pkg = ROOT / "livekit_server_tpu_torch"
    mods = ("routing/kv.py", "routing/tcpbus.py", "routing/fleet.py", "routing/router.py",
            "service/store.py", "service/migration.py", "service/fleetplane.py",
            "service/stack.py", "runtime/traffic_twin.py", "telemetry/trace_export.py")
    for rel in mods:
        names = {n.split(".")[0] for n in _imported_modules(pkg / rel)}
        outside = {n for n in names if n not in sys.stdlib_module_names
                   and n not in ("livekit_server_tpu_torch", "numpy", "torch")}
        assert not outside, (rel, outside)


TOOLING_PROBE = PROBE_HEAD + r"""
# torch's FLOP counter loads torch's own dependencies (sympy, and optree
# where installed) at its first use: they count as torch's
from torch.utils.flop_counter import FlopCounterMode
with FlopCounterMode(display=False):
    torch.ones(2) @ torch.ones(2)
before = {m.split(".")[0] for m in sys.modules}
import livekit_server_tpu_torch.analysis.__main__ as runner
from livekit_server_tpu_torch.analysis import core, devicecheck
from livekit_server_tpu_torch.native import poolcheck
from livekit_server_tpu_torch.runtime.compile_ledger import LEDGER

cfg = core.load_config(runner.REPO_ROOT)
project = core.load_project(runner.REPO_ROOT, ["livekit_server_tpu_torch/analysis"])
assert not [f for f in core.run_all(project, cfg) if f.rule == "GC00"]
allow = cfg.rule("devicecheck")["allow_no_inplace"]
for spec in devicecheck._specs()[:3]:
    contract, problems = devicecheck.run_entry(spec, torch.device("cpu"),
                                               allow_no_inplace=spec.name in allow)
    assert contract["out"] and problems == [], problems
rep = poolcheck.run_sequence((3, 2), 50, watchdog_s=60)
assert rep["short_calls"] == 0 and rep["shard_mismatches"] == 0, rep
LEDGER.record_launch("decide_rooms", (1, 2, 3, 4))
assert LEDGER.snapshot()["by_kind"]["launch_shape"] == 1
after = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(after - before)))
"""


def test_tooling_needs_only_torch_numpy_and_stdlib():
    """The port's own tooling — the graftcheck rules and runner, the
    device contracts, the build ledger and the egress pool stress — runs
    with aiohttp, msgpack, PyYAML, cryptography and jax absent and loads
    no module outside the port, torch, numpy and the standard library."""
    outside = _loaded_outside(TOOLING_PROBE)
    assert not outside, f"the tooling imports {outside}"
