"""Live migration across the packages.

* The same seeded audio into a two-node JAX-package cluster and a
  two-node port cluster (RoomManagers on KVRouters over a MemoryBus each,
  stepped tick by tick, the port on device="cpu"), one room migrated at
  the same tick: the munged egress (sub, track, SN, TS) of every tick on
  both nodes is equal, and after more ticks on the target its row of the
  plane state (integers and bools equal, floats within
  `plane.float_tolerance`: rtol 1e-5 for rate leaves, 1e-6 for the rest)
  and its munger lanes (equal) agree.
* Cross-package adoption over one TCP bus: a room migrated from a JAX
  node to a port node and back is adopted with its row equal, bit for
  bit, to the snapshot the source took at freeze (the LKCK frames and
  the migration messages cross between the packages). The subscriber
  control masks are left out of that comparison: restore_room clears
  them on purpose in both packages (subscriptions never travel).
* Elected failover from KV checkpoints, in each package on the same
  seeded traffic: a node's rooms, checkpointed twice (one room's newest
  generation then corrupted), restored once each by two survivors
  racing; each restored row equals the newest generation that decodes
  (bit for bit, control masks aside), and the restored rows, munger
  lanes, counters and the egress of the ticks after agree across the
  packages (floats within `plane.float_tolerance`).
* Rollback and replay: a handoff to a target that adopts and never
  ACKs rolls back; the packets captured in the freeze window are
  replayed on the source; stats, egress and the source row agree across
  the packages.
"""

import asyncio
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import torch_paged_fixture as fx  # noqa: E402

import livekit_server_tpu.config as jconfig  # noqa: E402
import livekit_server_tpu.routing as jrouting  # noqa: E402
import livekit_server_tpu.routing.router as jrouter  # noqa: E402
import livekit_server_tpu.routing.tcpbus as jtcpbus  # noqa: E402
import livekit_server_tpu.runtime.ingest as jingest  # noqa: E402
import livekit_server_tpu.service.roommanager as jrm  # noqa: E402
import livekit_server_tpu.service.store as jstore  # noqa: E402
import livekit_server_tpu_torch.config as pconfig  # noqa: E402
import livekit_server_tpu_torch.routing as prouting  # noqa: E402
import livekit_server_tpu_torch.routing.router as prouter  # noqa: E402
import livekit_server_tpu_torch.routing.tcpbus as ptcpbus  # noqa: E402
import livekit_server_tpu_torch.runtime.ingest as pingest  # noqa: E402
import livekit_server_tpu_torch.service.roommanager as prm  # noqa: E402
import livekit_server_tpu_torch.service.store as pstore  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402

JAX = SimpleNamespace(config=jconfig, routing=jrouting, router=jrouter, tcpbus=jtcpbus,
                      ingest=jingest, rm=jrm, store=jstore, port=False)
PORT = SimpleNamespace(config=pconfig, routing=prouting, router=prouter, tcpbus=ptcpbus,
                       ingest=pingest, rm=prm, store=pstore, port=True)
DIMS = plane.PlaneDims(rooms=4, tracks=4, pkts=4, subs=4)
NAMES = plane.leaf_names(plane.init_state(DIMS, device="cpu"))
CTRL = [i for i, n in enumerate(NAMES) if n.startswith("ctrl.")]
TRACKS, SUBS = (0, 1), (1, 2, 3)


def make_node(pkg, bus, tweak=None):
    """A RoomManager on a KVRouter over `bus`, its migration worker
    listening; the plane is stepped by the caller (no serving loop).
    `tweak(cfg)` edits the config first."""
    cfg = pkg.config.Config()
    p = cfg.plane
    p.rooms, p.tracks_per_room, p.pkts_per_track, p.subs_per_room = DIMS
    p.tick_ms = 10
    cfg.limits.governor_enabled = False     # its ladder reads wall-clock lateness
    cfg.egress.shards = 1
    if tweak is not None:
        tweak(cfg)
    router = pkg.routing.create_router(pkg.routing.LocalNode(), bus)
    kw = {"device": "cpu"} if pkg.port else {}
    rm = pkg.rm.RoomManager(cfg, router, pkg.store.KVStore(bus), **kw)
    rm.migration.start()
    rm.migration.on_adopt.append(lambda room: subscribe(rm, room.slots.row))
    return rm


def patient(cfg):
    """A source that waits for a slow target: under a loaded test run the
    JAX target's first restore (its jit compiles) can outlast the default
    2 s ACK timeout, and a retried PREPARE then replays the freeze window.
    The same wait for both packages' nodes, and an adoption that outlives
    a late COMMIT."""
    cfg.migration.ack_timeout_s = 60.0
    cfg.migration.adopt_ttl_s = 120.0


def subscribe(rm, row):
    """Subscriptions never travel in a snapshot: the adopting node's
    subscribers re-subscribe (the clients' reconnect)."""
    for t in TRACKS:
        rm.runtime.set_track(row, t, published=True, is_video=False)
        for s in SUBS:
            rm.runtime.set_subscription(row, t, s, subscribed=True)


def push(pkg, rm, row, tick, rng_seed):
    rng = np.random.default_rng(rng_seed * 1000 + tick)
    for t in TRACKS:
        rm.runtime.ingest.push(pkg.ingest.PacketIn(
            room=row, track=t, sn=(40000 + 100 * t + tick) & 0xFFFF, ts=960 * tick + 7 * t,
            size=int(rng.integers(20, 200)), payload=b"o" * 3,
            audio_level=int(rng.integers(0, 127))))


async def committed(rm, name, timeout=60.0):
    """Wait for the target's COMMIT handler (a spawned task) to unfreeze
    the adopted row, so the next packets stage instead of queueing in the
    adoption's bridge."""
    deadline = asyncio.get_running_loop().time() + timeout
    while name in rm.migration._adoptions:
        assert asyncio.get_running_loop().time() < deadline, "COMMIT never handled"
        await asyncio.sleep(0.005)


def egress(res):
    return sorted((p.sub, p.track, p.sn, p.ts) for p in res.egress)


def state_row(pkg, rm, row):
    leaves = (plane.state_to_numpy(rm.runtime.state) if pkg.port
              else [np.asarray(x) for x in jax.tree.leaves(rm.runtime.state)])
    return [np.asarray(a[row]) for a in leaves]


async def cluster_run(pkg, seed=3, before=6, after=6):
    bus = pkg.routing.MemoryBus()
    a, b = make_node(pkg, bus, patient), make_node(pkg, bus, patient)
    try:
        room = await a.get_or_create_room("mig")
        row = room.slots.row
        subscribe(a, row)
        ticks = []
        for i in range(before):
            push(pkg, a, row, i, seed)
            ticks.append(egress(await a.runtime.step_once()))
        assert await a.migrate_room("mig", b.router.local_node.node_id)
        await committed(b, "mig")
        row_b = b.rooms["mig"].slots.row
        for i in range(before, before + after):
            push(pkg, b, row_b, i, seed)
            ticks.append(egress(await b.runtime.step_once()))
        lanes = [np.array(getattr(b.runtime.munger, f)[row_b])
                 for f in b.runtime.munger.FIELDS]
        return ticks, state_row(pkg, b, row_b), lanes, a.runtime.slots.rooms_used
    finally:
        for rm in (a, b):
            await rm.migration.stop()


async def test_migration_matches_reference_tick_for_tick():
    want = await cluster_run(JAX)
    got = await cluster_run(PORT)
    assert got[0] == want[0]                           # munged egress, every tick
    assert all(got[0]) and len(got[0]) == 12
    fx.assert_leaves_match(got[1], want[1], NAMES, "target row after migration")
    for a, b in zip(got[2], want[2]):
        assert np.array_equal(a, b)
    assert got[3] == want[3] == 0                      # source row released


def capture_snapshots(rm):
    """Wrap rm.runtime.snapshot_room to keep what it returns."""
    taken = []
    real = rm.runtime.snapshot_room

    def snapshot_room(row):
        snap = real(row)
        taken.append(snap)
        return snap

    rm.runtime.snapshot_room = snapshot_room
    return taken


def assert_adopted_equal(adopted, frozen):
    got, want = adopted["arrays"], frozen["arrays"]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if i in CTRL:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert a.tobytes() == b.tobytes(), NAMES[i] if i < len(NAMES) else f"munger {i}"


async def test_room_adopted_across_packages_over_one_tcp_bus():
    srv = ptcpbus.BusServer()
    await srv.start("127.0.0.1", 0)
    nodes = []
    try:
        jcl = await jtcpbus.TCPBusClient.connect("127.0.0.1", srv.port)
        pcl = await ptcpbus.TCPBusClient.connect("127.0.0.1", srv.port)
        j, p = make_node(JAX, jcl, patient), make_node(PORT, pcl, patient)
        nodes = [j, p]
        room = await j.get_or_create_room("x")
        subscribe(j, room.slots.row)
        for i in range(5):
            push(JAX, j, room.slots.row, i, 11)
            await j.runtime.step_once()
        for src, dst, src_pkg in ((j, p, JAX), (p, j, PORT)):
            frozen = capture_snapshots(src)
            adopted = []
            dst.migration.on_adopt.append(
                lambda r, dst=dst: adopted.append(dst.runtime.snapshot_room(r.slots.row)))
            assert await src.migrate_room("x", dst.router.local_node.node_id)
            assert "x" in dst.rooms and "x" not in src.rooms
            await committed(dst, "x")
            assert len(frozen) == 1 and len(adopted) == 1
            assert_adopted_equal(adopted[0], frozen[0])
            assert src.runtime.slots.rooms_used == 0
            src.runtime.snapshot_room = type(src.runtime).snapshot_room.__get__(src.runtime)
            # A few ticks on the new host before the room moves on.
            row = dst.rooms["x"].slots.row
            dst_pkg = PORT if src_pkg is JAX else JAX
            for i in range(5, 8):
                push(dst_pkg, dst, row, i, 11)
                await dst.runtime.step_once()
        await jcl.close()
        await pcl.close()
    finally:
        for rm in nodes:
            await rm.migration.stop()
        srv.close()


async def crash(pkg, rm):
    """A node crash as the survivors see it: its lease gone, its registry
    entry's heartbeat stamps long stale, its workers silent."""
    r = rm.router
    await rm.migration.stop()
    node = r.local_node
    node.stats.mono_at, node.stats.updated_at = 0.0, 0.0
    await r.bus.hset(pkg.router.NODES_KEY, node.node_id, json.dumps(node.to_dict()))
    await r.bus.delete(r._lease_key(node.node_id))


def row_lanes(rm, row):
    return [np.array(getattr(rm.runtime.munger, f)[row]) for f in rm.runtime.munger.FIELDS]


FAIL_ROOMS = ("f0", "f1", "f2")


async def failover_run(pkg, seed=5):
    bus = pkg.routing.MemoryBus()
    dead, a, c = (make_node(pkg, bus) for _ in range(3))
    try:
        rows = {}
        for name in FAIL_ROOMS:
            rows[name] = (await dead.get_or_create_room(name)).slots.row
            subscribe(dead, rows[name])
        tick = 0
        for gen in range(2):                   # two checkpoint generations
            for _ in range(4):
                for i, name in enumerate(FAIL_ROOMS):
                    push(pkg, dead, rows[name], tick, seed + i)
                await dead.runtime.step_once()
                tick += 1
            await dead.checkpoint_rooms()
        ckpt = {n: [await bus.get(f"room_checkpoint:{n}"), await bus.get(f"room_checkpoint:{n}:g1")]
                for n in FAIL_ROOMS}
        # f1's newest generation rots on the bus: its restore falls back to :g1.
        bad = ckpt["f1"][0]
        await bus.set("room_checkpoint:f1", bad[:40] + ("A" if bad[40] != "A" else "B") + bad[41:])
        want = {n: dead.runtime.decode_room_snapshot(g[1] if n == "f1" else g[0])
                for n, g in ckpt.items()}
        # Traffic after the last round is lost with the node.
        for i, name in enumerate(FAIL_ROOMS):
            push(pkg, dead, rows[name], tick, seed + i)
        await dead.runtime.step_once()
        await crash(pkg, dead)
        won = await asyncio.gather(a.fleet.orchestrator.run_once(),
                                   c.fleet.orchestrator.run_once())
        hosts = {n: [rm for rm in (a, c) if n in rm.rooms] for n in FAIL_ROOMS}
        assert sum(won) == len(FAIL_ROOMS) and all(len(h) == 1 for h in hosts.values()), won
        out = {"rows": {}, "lanes": {}, "egress": [],
               "fallbacks": a.ckpt_fallbacks + c.ckpt_fallbacks}
        for name, (rm,) in hosts.items():
            row = rm.rooms[name].slots.row
            got = state_row(pkg, rm, row) + row_lanes(rm, row)
            assert_adopted_equal({"arrays": got}, want[name])
            out["rows"][name], out["lanes"][name] = got[:len(NAMES)], got[len(NAMES):]
            subscribe(rm, row)
        for t in range(tick + 1, tick + 5):
            for i, (name, (rm,)) in enumerate(hosts.items()):
                push(pkg, rm, rm.rooms[name].slots.row, t, seed + i)
            res = []
            for rm in (a, c):
                names = {room.slots.row: n for n, room in rm.rooms.items()}
                res += [(names[p.room], p.sub, p.track, p.sn, p.ts)
                        for p in (await rm.runtime.step_once()).egress]
            out["egress"].append(sorted(res))
        return out
    finally:
        for rm in (dead, a, c):
            await rm.migration.stop()


async def test_elected_failover_restores_newest_decodable_checkpoint_in_both():
    want = await failover_run(JAX)
    got = await failover_run(PORT)
    assert got["fallbacks"] == want["fallbacks"] == 1      # f1's rotten newest generation
    for name in FAIL_ROOMS:
        fx.assert_leaves_match(got["rows"][name], want["rows"][name], NAMES,
                               f"{name} restored by failover")
        for x, y in zip(got["lanes"][name], want["lanes"][name]):
            assert np.array_equal(x, y)
    assert got["egress"] == want["egress"]
    assert all(got["egress"]) and len(got["egress"]) == 4


async def rollback_run(pkg, seed=9):
    def silent_target(cfg):
        cfg.faults.enabled = True
        cfg.faults.mig_drop_prepare = True

    def quick_timeout(cfg):
        cfg.migration.ack_timeout_s = 0.3
        cfg.migration.retry_attempts = 2
        cfg.migration.retry_backoff_base_s = 0.02
        cfg.migration.retry_backoff_max_s = 0.05

    bus = pkg.routing.MemoryBus()
    a, b = make_node(pkg, bus, quick_timeout), make_node(pkg, bus, silent_target)
    try:
        room = await a.get_or_create_room("mig")
        row = room.slots.row
        subscribe(a, row)
        ticks = []
        for i in range(4):
            push(pkg, a, row, i, seed)
            ticks.append(egress(await a.runtime.step_once()))
        # Packets arriving in the freeze window, once per attempt: the
        # target adopts each PREPARE and swallows it.
        frozen_tick = iter(range(4, 6))
        b.migration.on_adopt.append(lambda r: push(pkg, a, row, next(frozen_tick), seed))
        assert not await a.migrate_room("mig", b.router.local_node.node_id)
        assert a.runtime.ingest.frozen_rows == set()
        deadline = asyncio.get_running_loop().time() + 10.0
        while "mig" in b.rooms:
            assert asyncio.get_running_loop().time() < deadline, "target kept its adoption"
            await asyncio.sleep(0.01)
        for i in range(6, 9):
            push(pkg, a, row, i, seed)
            ticks.append(egress(await a.runtime.step_once()))
        return {"ticks": ticks, "row": state_row(pkg, a, row), "lanes": row_lanes(a, row),
                "stats": {k: a.migration.stats[k] for k in ("rollbacks", "timeouts", "commits",
                                                            "bridged_out")},
                "target_rows": b.runtime.slots.rooms_used}
    finally:
        for rm in (a, b):
            await rm.migration.stop()


async def test_rollback_replays_freeze_window_as_reference():
    want = await rollback_run(JAX)
    got = await rollback_run(PORT)
    assert got["stats"] == want["stats"]
    assert want["stats"]["rollbacks"] == 1 and want["stats"]["commits"] == 0
    assert want["stats"]["timeouts"] == 2
    assert got["target_rows"] == want["target_rows"] == 0
    assert got["ticks"] == want["ticks"]
    # Every packet, the freeze window's too, reached each subscriber once,
    # in order: the replay went out on the source after the rollback.
    for t in TRACKS:
        for sub in SUBS:
            sns = [e[2] for tick in got["ticks"] for e in tick if e[:2] == (sub, t)]
            assert len(sns) == 9 and all((y - x) & 0xFFFF == 1 for x, y in zip(sns, sns[1:]))
    fx.assert_leaves_match(got["row"], want["row"], NAMES, "source row after rollback")
    for x, y in zip(got["lanes"], want["lanes"]):
        assert np.array_equal(x, y)
