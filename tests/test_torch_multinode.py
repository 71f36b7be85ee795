"""The port's multi-node serving over a real TCP bus (KVRouter on a
TCPBusClient, the port's server on device="cpu"): the counterparts of the
JAX package's tests/test_multinode.py — a cross-node session relayed over
the bus, the dead-node takeover on join, row handoff with contiguous
munged SNs, the single-shot bus handoff, the two-phase migration under
load (every pushed SN egresses exactly once across the cutover), and
room-service operations against a non-hosting node. SNs are integers
compared exactly. Waits poll conditions with deadlines."""

import asyncio

import aiohttp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.routing.tcpbus import TCPBusClient  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from tests.test_torch_service import API_KEY, API_SECRET, SignalClient  # noqa: E402
from tests.torch_cluster_fixture import slot_free, start_bus, start_tcp_node, wait_for  # noqa: E402


async def test_cross_node_session_over_tcp_bus():
    """Two servers, one bus: a room pinned to node A serves a participant
    whose WebSocket terminates on node B — the signal stream relays over
    the TCP bus (redisrouter signal relay, multinode_test.go)."""
    bus = await start_bus()
    srv_a = srv_b = None
    try:
        srv_a, _ = await start_tcp_node(bus.port)
        srv_b, _ = await start_tcp_node(bus.port)
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, srv_a.port)
            await alice.connect("shared", "alice")
            # Room is now pinned to node A.
            assert (
                await srv_b.router.get_node_for_room("shared")
                == srv_a.router.local_node.node_id
            )
            bob = SignalClient(s, srv_b.port)
            join_b = await bob.connect("shared", "bob")
            # Bob's session actually lives on node A (relayed).
            assert join_b["participant"]["identity"] == "bob"
            others = [p["identity"] for p in join_b["other_participants"]]
            assert "alice" in others
            assert "shared" in srv_a.room_manager.rooms
            assert "shared" not in srv_b.room_manager.rooms
            # Cross-node signal round trip: bob's state update reaches the
            # room on A and fans back out to alice's socket on A.
            deadline = asyncio.get_running_loop().time() + 5
            seen_bob = False
            while not seen_bob and asyncio.get_running_loop().time() < deadline:
                seen_bob = any(
                    p.get("identity") == "bob"
                    for m in alice.signals
                    for p in m.get("update", {}).get("participants", [])
                )
                await asyncio.sleep(0.05)
            assert seen_bob, f"no bob update in {alice.signals}"
            await alice.close()
            await bob.close()
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await srv.stop(force=True)
        bus.close()


async def test_dead_node_takeover():
    """Node A dies with a room pinned to it; a client hitting node B gets
    the room re-homed there instead of a dead relay (RemoveDeadNodes +
    the multinode shutdown-reconnect flow)."""
    bus = await start_bus()
    srv_a = srv_b = None
    try:
        srv_a, bus_a = await start_tcp_node(bus.port)
        srv_b, _ = await start_tcp_node(bus.port)
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, srv_a.port)
            await alice.connect("takeover", "alice")
            await alice.close()
            a_id = srv_a.router.local_node.node_id
            # Crash A: heartbeat stops and it vanishes from the registry
            # (what the dead-node reaper does after staleness) but its room
            # pin is left behind — a graceful stop would have cleaned it,
            # a crash doesn't.
            srv_a.router._stats_task.cancel()
            srv_a.router._session_task.cancel()
            util = await TCPBusClient.connect("127.0.0.1", bus.port)
            await util.hdel("nodes", a_id)
            await util.close()
            # The pin still names the dead node…
            assert await srv_b.router.get_node_for_room("takeover") == a_id
            # …but a join through B re-homes the room locally.
            bob = SignalClient(s, srv_b.port)
            join = await bob.connect("takeover", "bob")
            assert join["participant"]["identity"] == "bob"
            assert "takeover" in srv_b.room_manager.rooms
            assert (
                await srv_b.router.get_node_for_room("takeover")
                == srv_b.router.local_node.node_id
            )
            await bob.close()
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await srv.stop(force=True)
        bus.close()


async def test_room_migration_snapshot_continuity():
    """Row-level handoff: media flows through node A's plane, the room
    migrates, and the SAME stream continued on node B emits contiguous
    munged SNs — the forwarder-state seeding of participant.go:823, at
    whole-room granularity."""
    dims = plane.PlaneDims(rooms=2, tracks=4, pkts=4, subs=4)
    rt_a = PlaneRuntime(dims, tick_ms=10, egress_shards=1, device="cpu")
    rt_b = PlaneRuntime(dims, tick_ms=10, egress_shards=1, device="cpu")

    rt_a.set_track(0, 0, published=True, is_video=False)
    rt_a.set_subscription(0, 0, 1, subscribed=True)
    got_a = []
    for i in range(5):
        rt_a.ingest.push(PacketIn(room=0, track=0, sn=7000 + i, ts=960 * i,
                                  size=50, payload=b"a"))
        res = await rt_a.step_once()
        got_a += [p.sn for p in res.egress if p.sub == 1]
    assert got_a == list(range(7000, 7005))

    # Handoff A → B into a DIFFERENT row (row identity is node-local).
    snap = rt_a.snapshot_room(0)
    payload = PlaneRuntime.encode_room_snapshot(snap)
    rt_b.restore_room(1, PlaneRuntime.decode_room_snapshot(payload))

    # Track metadata migrated with the snapshot, but subscription masks
    # deliberately did NOT (a restored mask on a re-allocated sub column
    # would leak media) — the rejoining subscriber re-subscribes and its
    # munger lane resumes where it left off.
    rt_b.set_subscription(1, 0, 1, subscribed=True)
    got_b = []
    for i in range(5, 10):
        rt_b.ingest.push(PacketIn(room=1, track=0, sn=7000 + i, ts=960 * i,
                                  size=50, payload=b"b"))
        res = await rt_b.step_once()
        got_b += [p.sn for p in res.egress if p.sub == 1 and p.room == 1]
    assert got_b == list(range(7005, 7010))


async def test_room_handoff_over_bus():
    """Manager-level handoff: node A publishes the room snapshot to the
    bus and unpins; node B's get_or_create_room adopts it.

    Round-2 recorded a rare INVALID_ARGUMENT flake here. Round-3
    investigation: the snapshot-vs-donated-step discipline was audited —
    every self.state reader/writer (snapshot_room, restore_room, the test
    itself) holds state_lock, and the serving loop holds it across the
    donated device dispatch, so no donated buffer is reachable while a
    step is in flight; 16 consecutive runs under 3-4x synthetic CPU load
    did not reproduce. The round-2 environment had six stray synthetic-
    load processes running since its own flake testing (since killed),
    matching the 'extreme starvation' precondition. Treat any recurrence
    as a new bug with its own traceback, not a known shrug."""
    bus = await start_bus()
    srv_a = srv_b = None
    try:
        srv_a, _ = await start_tcp_node(bus.port)
        srv_b, _ = await start_tcp_node(bus.port)
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, srv_a.port)
            await alice.connect("mig", "alice")
            row_a = srv_a.room_manager.rooms["mig"].slots.row
            # Put distinctive state into the room row (munger offsets).
            rt = srv_a.room_manager.runtime
            rt.set_track(row_a, 0, published=True, is_video=False)
            rt.set_subscription(row_a, 0, 1, subscribed=True)
            for i in range(3):
                rt.ingest.push(PacketIn(room=row_a, track=0, sn=100 + i,
                                        ts=0, size=10, payload=b"x"))
            # The node's serving loop is running, so step_once() would race
            # its deferred fan-out (and now raises); let the loop drain the
            # pushed packets and wait for the munger lane to advance.
            for _ in range(500):
                if int(rt.munger.last_sn[row_a, 0, 1]) == 102:
                    break
                await asyncio.sleep(0.01)
            assert int(rt.munger.last_sn[row_a, 0, 1]) == 102
            await alice.close()

            assert await srv_a.room_manager.handoff_room("mig")
            assert "mig" not in srv_a.room_manager.rooms

            room_b = await srv_b.room_manager.get_or_create_room("mig")
            rt_b = srv_b.room_manager.runtime
            # Munger state for (track 0, sub 1) migrated: last outgoing SN
            # survives the hop (host-side state since the round-5 split).
            last_sn = int(rt_b.munger.last_sn[room_b.slots.row, 0, 1])
            assert last_sn == 102
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await srv.stop(force=True)
        bus.close()


async def test_two_phase_migration_under_load_over_bus():
    """The migration plane's tentpole drill over real TCP sockets: audio
    flows while the room migrates A → B through the two-phase handoff.
    Every pushed SN egresses exactly once — packets landing in the freeze
    window are bridged to the target, not dropped — and the munger lane
    continues contiguously on the target (no stream reset)."""
    bus = await start_bus()
    srv_a = srv_b = None
    try:
        # Deep per-tick packet slots: under full-suite CPU load a 10ms
        # tick can stretch past several pump periods, and the default 4
        # slots per (room, track) would capacity-drop legitimate audio
        # with no migration involved at all.
        srv_a, _ = await start_tcp_node(bus.port, pkts_per_track=16)
        srv_b, _ = await start_tcp_node(bus.port, pkts_per_track=16)
        rm_a, rm_b = srv_a.room_manager, srv_b.room_manager
        rt_a, rt_b = rm_a.runtime, rm_b.runtime
        assert rm_a.migration is not None and rm_b.migration is not None

        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, srv_a.port)
            await alice.connect("live", "alice")
            row_a = rm_a.rooms["live"].slots.row
            rt_a.set_track(row_a, 0, published=True, is_video=False)
            rt_a.set_subscription(row_a, 0, 1, subscribed=True)

            got: list[int] = []   # audio SNs egressed to sub 1, either node

            def collect(res):
                got.extend(
                    p.sn for p in res.egress if p.track == 0 and p.sub == 1
                )

            rt_a.on_tick(collect)
            rt_b.on_tick(collect)
            # Subscription masks don't travel; the adopting node re-arms
            # the listener (stand-in for the client's reconnect).
            rm_b.migration.on_adopt.append(
                lambda r: rt_b.set_subscription(
                    r.slots.row, 0, 1, subscribed=True
                )
            )

            stop = asyncio.Event()
            sent: list[int] = []

            async def pump():
                sn = 500
                while not stop.is_set():
                    for rm in (rm_a, rm_b):
                        room = rm.rooms.get("live")
                        if room is not None:
                            if not slot_free(rm, room):
                                break
                            rm.runtime.ingest.push(PacketIn(
                                room=room.slots.row, track=0, sn=sn,
                                ts=960 * (sn - 500), size=40, payload=b"s",
                            ))
                            sent.append(sn)
                            sn += 1
                            break
                    await asyncio.sleep(0.004)

            pump_task = asyncio.ensure_future(pump())
            await wait_for(lambda: len(got) >= 30, 10.0, "media flowing on A")
            assert await rm_a.migrate_room("live")
            assert "live" not in rm_a.rooms and "live" in rm_b.rooms
            assert (
                await srv_a.router.get_node_for_room("live")
                == srv_b.router.local_node.node_id
            )
            n = len(sent)
            await wait_for(lambda: len(sent) >= n + 40, 10.0, "media flowing on B")
            stop.set()
            await pump_task
            # Drain the last ticks: every pushed SN reaches a fan-out.
            row_b = rm_b.rooms["live"].slots.row
            await wait_for(lambda: int(rt_b.munger.last_sn[row_b, 0, 1]) == sent[-1],
                           10.0, "target's lane never drained")
            await wait_for(lambda: len(got) >= len(sent), 10.0, "last fan-out")

            # 100% audio continuity across the cutover: every pushed SN
            # egressed exactly once — none dropped in the freeze window,
            # none duplicated by the bridge replay. (Set equality, not
            # order: a bridged straggler may share a tick with a direct
            # push on the target.)
            assert sorted(got) == sent, (
                f"lost={sorted(set(sent) - set(got))[:10]} "
                f"dup={sorted(sn for sn in set(got) if got.count(sn) > 1)[:10]}"
            )
            assert len(got) > 60, "pump never reached the plane"
            # The lane continued — target's last SN is the last one sent.
            row_b = rm_b.rooms["live"].slots.row
            assert int(rt_b.munger.last_sn[row_b, 0, 1]) == sent[-1]
            st = rm_a.migration.stats
            assert st["commits"] == 1 and st["rollbacks"] == 0
            await alice.close()
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await srv.stop(force=True)
        bus.close()


async def test_roomservice_ops_against_non_hosting_node():
    """Admin RPCs hit node B for a room hosted on node A and are relayed
    to the hosting node over the bus (multinode_roomservice_test.go)."""
    from livekit_server_tpu_torch.auth import AccessToken, VideoGrant

    bus = await start_bus()
    srv_a = srv_b = None
    try:
        srv_a, _ = await start_tcp_node(bus.port)
        srv_b, _ = await start_tcp_node(bus.port)
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, srv_a.port)
            await alice.connect("hosted-on-a", "alice")
            assert "hosted-on-a" in srv_a.room_manager.rooms

            t = AccessToken(API_KEY, API_SECRET)
            t.grant = VideoGrant(room_admin=True, room="hosted-on-a")
            hdr = {"Authorization": f"Bearer {t.to_jwt()}"}
            base_b = f"http://127.0.0.1:{srv_b.port}/twirp/livekit.RoomService"

            # List participants via the NON-hosting node.
            async with s.post(
                f"{base_b}/ListParticipants", json={"room": "hosted-on-a"},
                headers=hdr,
            ) as r:
                assert r.status == 200, await r.text()
                parts = (await r.json())["participants"]
                assert [p["identity"] for p in parts] == ["alice"]

            # Mutate metadata via the non-hosting node; the hosting node's
            # room object changes and alice gets the update.
            async with s.post(
                f"{base_b}/UpdateRoomMetadata",
                json={"room": "hosted-on-a", "metadata": "via-node-b"},
                headers=hdr,
            ) as r:
                assert r.status == 200, await r.text()
            assert srv_a.room_manager.rooms["hosted-on-a"].info.metadata == "via-node-b"

            # Remove alice via the non-hosting node.
            async with s.post(
                f"{base_b}/RemoveParticipant",
                json={"room": "hosted-on-a", "identity": "alice"},
                headers=hdr,
            ) as r:
                assert r.status == 200, await r.text()
            deadline = asyncio.get_running_loop().time() + 3
            while (
                (room_a := srv_a.room_manager.rooms.get("hosted-on-a")) is not None
                and "alice" in room_a.participants
                and asyncio.get_running_loop().time() < deadline
            ):
                await asyncio.sleep(0.05)
            assert room_a is None or "alice" not in room_a.participants
            await alice.close()
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await srv.stop(force=True)
        bus.close()


async def test_cli_list_nodes_and_drain_over_the_bus(tmp_path):
    """`list-nodes` lists every node registered on the bus (and the
    listing invocation itself), and `drain --node ID` asks that node to
    migrate its rooms off: its room lands on the peer and it admits
    nothing more. An unknown node id fails with exit code 1."""
    import json
    import os
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    bus = await start_bus()
    srv_a = srv_b = None
    try:
        srv_a, _ = await start_tcp_node(bus.port)
        srv_b, _ = await start_tcp_node(bus.port)
        from livekit_server_tpu_torch.protocol import models as pm

        # An idle room that outlives the CLI's start (the reaper's empty
        # timeout in this config is 2 s).
        await srv_a.room_manager.get_or_create_room(
            "drained", pm.RoomInfo(name="drained", empty_timeout=120))
        cfg = tmp_path / "cluster.yaml"
        cfg.write_text(f"development: true\nkv:\n  kind: tcp\n"
                       f"  address: 127.0.0.1:{bus.port}\n")
        env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1"}

        async def cli(*args):
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "livekit_server_tpu_torch", *args, "--config", str(cfg),
                cwd=root, env=env, stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.DEVNULL)
            out, _ = await asyncio.wait_for(proc.communicate(), 60)
            return proc.returncode, out.decode()

        rc, out = await cli("list-nodes")
        assert rc == 0
        ids = {json.loads(line)["node_id"] for line in out.splitlines() if line.startswith("{")}
        a_id, b_id = srv_a.router.local_node.node_id, srv_b.router.local_node.node_id
        assert {a_id, b_id} <= ids and len(ids) == 3
        rc, out = await cli("drain", "--node", a_id)
        assert rc == 0 and f"drain requested on {a_id}" in out
        await wait_for(lambda: "drained" in srv_b.room_manager.rooms
                       and not srv_a.room_manager.rooms, 10.0, "drain")
        assert srv_a.room_manager._admission_denied("room") == "node draining"
        assert await srv_b.router.get_node_for_room("drained") == b_id
        rc, out = await cli("drain", "--node", "ND_nobody")
        assert rc == 1 and "not listening" in out
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await srv.stop(force=True)
        bus.close()
