"""The port's fleet plane and failover over a real TCP bus (routing/
fleet.py, service/fleetplane.py, RoomManager's failover worker, the
port's server on device="cpu"): the counterparts of the JAX package's
tests/test_multinode.py fleet drills and tests/test_failover.py — split
brain fencing the minority, the elected failover restoring every room of
a killed node exactly once, the rebalancer, the stale COMMIT after a heal
dropped by the epoch guard, and a node death restored from its KV
checkpoint with the munger lane contiguous. SNs are integers compared
exactly. Waits poll conditions with deadlines."""

import asyncio

import aiohttp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.routing.tcpbus import TCPBusClient  # noqa: E402
from livekit_server_tpu_torch.runtime.faultinject import FaultInjector  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.service.server import create_server  # noqa: E402
from tests.conftest import free_port  # noqa: E402
from tests.test_torch_service import SignalClient  # noqa: E402
from tests.torch_cluster_fixture import (  # noqa: E402
    slot_free, start_bus, start_fleet_node, tcp_config, wait_for,
)


async def start_chaos_node(bus_port: int, *, lease_ttl: float = 1.0):
    """tests/test_failover.py's node: failure-detection cadences tightened
    for test time (sub-second lease, fast failover scan, fast checkpoint
    cadence); the heartbeat stays well inside the lease TTL."""
    client = await TCPBusClient.connect("127.0.0.1", bus_port)
    cfg = tcp_config(free_port())
    cfg.kv.lease_ttl_s = lease_ttl
    cfg.kv.failover_interval_s = 0.15
    cfg.supervisor.checkpoint_interval_s = 0.25
    srv = create_server(cfg, bus=client, device="cpu")
    srv.router.stats_interval = 0.3  # heartbeat + lease refresh cadence
    await srv.start()
    return srv, client


async def _stop_quiet(srv) -> None:
    try:
        await srv.stop(force=True)
    except (ConnectionError, OSError):
        pass  # a killed node's bus is gone; cleanup calls fail fast


async def test_split_brain_fences_minority_and_takeover_wins():
    """The fleet plane's tentpole drill: a 2|1 bus partition darks node A
    while its room keeps producing media. The minority self-fences (wire
    mute engages while the plane is still producing — the shadow SNs
    prove the mute is load-bearing), the majority completes an elected
    takeover strictly after the mute, and the heal ends with exactly one
    owner, ZERO duplicate wire packets, and A's stale checkpoint write
    rejected by the epoch CAS."""
    bus = await start_bus()
    srv_a = srv_b = None
    try:
        srv_a, _ = await start_fleet_node(bus.port)
        srv_b, _ = await start_fleet_node(bus.port)
        rm_a, rm_b = srv_a.room_manager, srv_b.room_manager
        rt_a, rt_b = rm_a.runtime, rm_b.runtime
        a_id = srv_a.router.local_node.node_id
        b_id = srv_b.router.local_node.node_id
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, srv_a.port)
            await alice.connect("sb", "alice")
            await alice.close()
            row_a = rm_a.rooms["sb"].slots.row
            rt_a.set_track(row_a, 0, published=True, is_video=False)
            rt_a.set_subscription(row_a, 0, 1, subscribed=True)

            got: list[int] = []      # wire-visible egress (fence-gated)
            shadow: list[int] = []   # produced by A's plane WHILE fenced

            def collect_a(res):
                sns = [p.sn for p in res.egress
                       if p.track == 0 and p.sub == 1]
                # Mirror the wire gate: a fenced tick's egress never
                # reaches a socket (_dispatch_tick mute), and residual
                # packets draining after the replica closed have no
                # row→room mapping left to route them by.
                wire_visible = not rm_a.fleet.fenced and "sb" in rm_a.rooms
                (got if wire_visible else shadow).extend(sns)

            rt_a.on_tick(collect_a)
            rt_b.on_tick(
                lambda res: got.extend(
                    p.sn for p in res.egress if p.track == 0 and p.sub == 1
                )
            )

            stop = asyncio.Event()
            sent: list[int] = []

            async def pump():
                sn = 500
                while not stop.is_set():
                    pushed = False
                    # Push the SAME SN into EVERY replica: while both
                    # nodes hold the room, only the fence keeps the wire
                    # duplicate-free.
                    for rm in (rm_a, rm_b):
                        room = rm.rooms.get("sb")
                        if room is not None:
                            rm.runtime.ingest.push(PacketIn(
                                room=room.slots.row, track=0, sn=sn,
                                ts=960 * (sn - 500), size=40, payload=b"s",
                            ))
                            pushed = True
                    if pushed:
                        sent.append(sn)
                        sn += 1
                    await asyncio.sleep(0.004)

            pump_task = asyncio.ensure_future(pump())
            await wait_for(lambda: len(got) >= 10
                           and bus.state._live("room_checkpoint:sb") is not None,
                           10.0, "media and a checkpoint on A")

            bus.set_partition([[b_id], [a_id]])
            # Minority goes silent on its own, within fence_grace (+ one
            # lease beat + scheduling slop).
            await wait_for(lambda: rm_a.fleet.fenced, 3.0, "A never fenced")
            assert "fenced" in (rm_a._admission_denied("room") or "")
            # Majority elects itself and restores from A's checkpoint —
            # strictly AFTER the mute (the no-overlap timeline).
            await wait_for(lambda: "sb" in rm_b.rooms, 6.0, "no takeover")
            assert rm_a.fleet.fenced, "takeover finished before the mute"
            rt_b.set_subscription(rm_b.rooms["sb"].slots.row, 0, 1,
                                  subscribed=True)
            # Dual-replica window: B forwards while fenced A still ticks.
            n = len(got)
            await wait_for(lambda: len(got) >= n + 5 and shadow, 10.0,
                           "both replicas ticking")

            bus.heal_partition()
            # A's next good lease triggers reconcile: the stale checkpoint
            # write loses its epoch CAS, which closes A's replica, and
            # only then does A unfence.
            await wait_for(
                lambda: not rm_a.fleet.fenced and "sb" not in rm_a.rooms,
                5.0, "A never reconciled",
            )
            n = len(got)
            await wait_for(lambda: len(got) >= n + 3, 10.0, "media after the heal")
            stop.set()
            await pump_task
            # Drain the last ticks: the last pushed SN reaches B's wire.
            await wait_for(lambda: sent[-1] in got, 10.0, "the last ticks")

            # ZERO duplicate wire packets across partition + heal…
            dup = sorted(sn for sn in set(got) if got.count(sn) > 1)
            assert not dup, f"duplicate wire SNs: {dup[:10]}"
            # …and not because A went idle: its plane kept producing
            # wire-bound egress that ONLY the fence suppressed.
            assert shadow, "A's plane never produced while fenced"
            assert set(shadow) & set(got), "no suppressed would-be dup"
            # Stale owner's post-heal checkpoint write rejected by CAS.
            assert rm_a.fleet.fence.stats["writes_fenced"] >= 1
            assert rm_a.fleet.stats == {
                **rm_a.fleet.stats, "fences": 1, "recoveries": 1,
                "rooms_lost": 1,
            }
            assert rm_a.fleet.stats["muted_ticks"] > 0
            # Exactly one owner at a strictly higher epoch.
            epoch, holder = await rm_b.fleet.fence.read("sb")
            assert holder == b_id and epoch >= 2
            assert await srv_b.router.get_node_for_room("sb") == b_id
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await srv.stop(force=True)
        bus.close()


async def test_node_kill_elected_failover_restores_every_room():
    """Node-kill drill: A dies holding two rooms while two survivors
    race the same dead-pin scan. The create-lock + epoch-CAS election
    gives every room exactly one restorer, and the media room comes back
    with 100% audio continuity (every pushed SN egresses exactly once,
    lane contiguous across the failover)."""
    bus = await start_bus()
    srvs: list = [None, None, None]
    try:
        for i in range(3):
            srvs[i], _ = await start_fleet_node(bus.port)
        srv_a, srv_b, srv_c = srvs
        rm_a, rm_b, rm_c = (s.room_manager for s in srvs)
        rt_a = rm_a.runtime
        async with aiohttp.ClientSession() as s:
            for room_name in ("k1", "k2"):
                cl = SignalClient(s, srv_a.port)
                await cl.connect(room_name, "pub")
                await cl.close()
            row_a = rm_a.rooms["k1"].slots.row
            rt_a.set_track(row_a, 0, published=True, is_video=False)
            rt_a.set_subscription(row_a, 0, 1, subscribed=True)

            got: list[int] = []
            for rm in (rm_a, rm_b, rm_c):
                rm.runtime.on_tick(
                    lambda res: got.extend(
                        p.sn for p in res.egress
                        if p.track == 0 and p.sub == 1
                    )
                )
            # Subscriptions never travel in a snapshot (restore_room
            # clears the masks — a restored bit on a re-allocated sub
            # column would leak media), so model the subscriber re-attach
            # the way production does: re-subscribe at adoption time,
            # before the room is visible to ingest.
            for rm in (rm_b, rm_c):
                rm.on_adopt.append(
                    (lambda rm_: lambda room: (
                        rm_.runtime.set_subscription(
                            room.slots.row, 0, 1, subscribed=True
                        ) if room.name == "k1" else None
                    ))(rm)
                )

            live = [rm_a, rm_b, rm_c]
            stop = asyncio.Event()
            sent: list[int] = []

            async def pump():
                sn = 900
                while not stop.is_set():
                    for rm in list(live):
                        room = rm.rooms.get("k1")
                        if room is not None:
                            if not slot_free(rm, room):
                                break
                            rm.runtime.ingest.push(PacketIn(
                                room=room.slots.row, track=0, sn=sn,
                                ts=960 * (sn - 900), size=40, payload=b"s",
                            ))
                            sent.append(sn)
                            sn += 1
                            break
                    await asyncio.sleep(0.004)

            pump_task = asyncio.ensure_future(pump())
            await wait_for(lambda: len(sent) >= 20, 10.0,
                            "pump never reached A")
            # Quiesce the pump and let A's lane drain, then force a fresh
            # checkpoint so the survivors restore the full lane.
            live.remove(rm_a)
            await wait_for(
                lambda: not sent
                or int(rt_a.munger.last_sn[row_a, 0, 1]) == sent[-1],
                10.0, "A's lane never drained",
            )
            await rm_a.checkpoint_rooms()
            # Crash A: heartbeat and session relay stop; the lease lapses
            # on its own. (A's plane keeps running — its later checkpoint
            # writes must LOSE the epoch CAS once a survivor claims.)
            srv_a.router._stats_task.cancel()
            srv_a.router._session_task.cancel()

            def owners(name):
                return [rm for rm in (rm_b, rm_c) if name in rm.rooms]

            # Generous window: on a loaded shared-CPU rig a single XLA
            # compile can stall the loop 15-20 s, which once ate the whole
            # wait — the failover itself completes in ~1.2 s when the loop
            # is scheduled.
            await wait_for(
                lambda: owners("k1") and owners("k2"), 45.0,
                "rooms never failed over",
            )
            assert len(owners("k1")) == 1 and len(owners("k2")) == 1
            winner = owners("k1")[0]
            pumped_to_a = len(sent)
            await wait_for(lambda: len(sent) >= pumped_to_a + 20, 10.0,
                            "pump never reached the winner")
            stop.set()
            await pump_task
            row_w = winner.rooms["k1"].slots.row
            await wait_for(
                lambda: int(winner.runtime.munger.last_sn[row_w, 0, 1])
                == sent[-1],
                10.0, "winner's lane never drained",
            )
            await wait_for(lambda: len(got) >= len(sent), 10.0, "last fan-out")

            # 100% audio continuity: every pushed SN egressed exactly once.
            assert sorted(got) == sent, (
                f"lost={sorted(set(sent) - set(got))[:10]} "
                f"dup={sorted(sn for sn in set(got) if got.count(sn) > 1)[:10]}"
            )
            assert len(got) >= 40, "pump never reached the plane"
            # Exactly one elected restorer per room across the fleet.
            restored = sum(
                rm.fleet.orchestrator.stats["restored"] for rm in (rm_b, rm_c)
            )
            assert restored == 2
            for name in ("k1", "k2"):
                epoch, holder = await rm_b.fleet.fence.read(name)
                assert holder == owners(name)[0].fleet.fence.node_id
                assert epoch >= 2
    finally:
        for srv in srvs:
            if srv is not None:
                await srv.stop(force=True)
        bus.close()


async def test_rebalancer_sheds_hot_node_with_continuity():
    """Load-aware rebalancing rides the migration plane: the node holding
    every room sheds its emptiest one to the idle peer, and media in the
    moved room survives the hop with every SN egressing exactly once."""
    extra = {"fleet": {
        "rebalance_enabled": True, "rebalance_interval_s": 0.3,
        "rebalance_headroom": 0.25, "rebalance_max_moves": 1,
    }}
    bus = await start_bus()
    srv_a = srv_b = None
    try:
        srv_a, _ = await start_fleet_node(bus.port, extra=extra)
        srv_b, _ = await start_fleet_node(bus.port, extra=extra)
        rm_a, rm_b = srv_a.room_manager, srv_b.room_manager
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, srv_a.port)
            await alice.connect("keep", "alice")     # stays connected
            bob = SignalClient(s, srv_a.port)
            await bob.connect("mover", "bob")
            await bob.close()                        # mover: 0 participants
            row_a = rm_a.rooms["mover"].slots.row
            rm_a.runtime.set_track(row_a, 0, published=True, is_video=False)
            rm_a.runtime.set_subscription(row_a, 0, 1, subscribed=True)
            rm_b.migration.on_adopt.append(
                lambda r: rm_b.runtime.set_subscription(
                    r.slots.row, 0, 1, subscribed=True
                )
            )

            got: list[int] = []
            for rm in (rm_a, rm_b):
                rm.runtime.on_tick(
                    lambda res: got.extend(
                        p.sn for p in res.egress
                        if p.track == 0 and p.sub == 1
                    )
                )
            stop = asyncio.Event()
            sent: list[int] = []

            async def pump():
                sn = 300
                while not stop.is_set():
                    for rm in (rm_a, rm_b):
                        room = rm.rooms.get("mover")
                        if room is not None:
                            if not slot_free(rm, room):
                                break
                            rm.runtime.ingest.push(PacketIn(
                                room=room.slots.row, track=0, sn=sn,
                                ts=960 * (sn - 300), size=40, payload=b"s",
                            ))
                            sent.append(sn)
                            sn += 1
                            break
                    await asyncio.sleep(0.004)

            pump_task = asyncio.ensure_future(pump())
            # The rebalancer picks the emptiest room on the hottest node:
            # "mover" (0 participants) leaves, "keep" (alice) stays.
            # Moved = adopted on B (PREPARE) and released on A (COMMIT
            # resolution) — the source replica lives until the commit.
            await wait_for(
                lambda: "mover" in rm_b.rooms and "mover" not in rm_a.rooms,
                20.0, "no rebalance",
            )
            assert "keep" in rm_a.rooms
            moved_at = len(sent)
            await wait_for(lambda: len(sent) >= moved_at + 20, 10.0,
                            "pump never reached the target")
            stop.set()
            await pump_task
            row_b = rm_b.rooms["mover"].slots.row
            await wait_for(
                lambda: int(rm_b.runtime.munger.last_sn[row_b, 0, 1])
                == sent[-1],
                10.0, "target's lane never drained",
            )
            await wait_for(lambda: len(got) >= len(sent), 10.0, "last fan-out")

            assert sorted(got) == sent, (
                f"lost={sorted(set(sent) - set(got))[:10]} "
                f"dup={sorted(sn for sn in set(got) if got.count(sn) > 1)[:10]}"
            )
            assert rm_a.fleet.rebalancer.stats["moves"] >= 1
            assert rm_a.migration.stats["commits"] >= 1
            epoch, holder = await rm_b.fleet.fence.read("mover")
            assert holder == srv_b.router.local_node.node_id and epoch >= 2
            await alice.close()
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await srv.stop(force=True)
        bus.close()


async def test_stale_commit_after_heal_dropped_by_epoch_guard():
    """Migration under partition: an asymmetric A→B link holds the
    PREPARE in flight, the source times out and rolls back, and the heal
    delivers the whole stale handshake late — the target adopts, obeys
    the late ABORT, and a COMMIT naming the dead epoch is dropped by the
    epoch guard. Exactly one node serves the room throughout."""
    extra = {"migration": {
        "ack_timeout_s": 0.3, "retry_attempts": 1,
        "retry_backoff_base_s": 0.05, "adopt_ttl_s": 1.0,
    }}
    bus = await start_bus()
    srv_a = srv_b = None
    try:
        srv_a, cl_a = await start_fleet_node(bus.port, extra=extra)
        srv_b, _ = await start_fleet_node(bus.port, extra=extra)
        rm_a, rm_b = srv_a.room_manager, srv_b.room_manager
        a_id = srv_a.router.local_node.node_id
        b_id = srv_b.router.local_node.node_id
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, srv_a.port)
            await alice.connect("part", "alice")
            await alice.close()

            # One-way link failure: A's pushes to B are held (not lost).
            # KV still works both ways, so leases stay healthy — this is
            # a migration-plane partition, not a node death.
            bus.set_partition([], asym_pairs=[(a_id, b_id)])
            assert not await rm_a.migration.migrate_room("part", b_id)
            assert "part" in rm_a.rooms        # rolled back, still source
            stale_epoch = rm_a.migration._epoch

            bus.heal_partition()
            # The held PREPARE adopts on B, the held ABORT (or the adopt
            # reaper) releases it again — transient, never an owner.
            await wait_for(
                lambda: rm_b.migration.stats["adoptions"] >= 1, 5.0,
                "late PREPARE never adopted",
            )
            await wait_for(
                lambda: "part" not in rm_b.rooms
                and not rm_b.migration._adoptions,
                5.0, "late adoption never released",
            )
            # The COMMIT from the timed-out attempt finally arrives —
            # naming a dead epoch. The guard drops it instead of
            # finalizing a handoff the source already rolled back.
            before = rm_b.migration.stats["stale_commits"]
            await cl_a.publish(
                f"node_migrate:{b_id}",
                {"kind": "commit", "room": "part", "epoch": stale_epoch},
            )
            await wait_for(
                lambda: rm_b.migration.stats["stale_commits"] > before,
                3.0, "stale COMMIT not counted",
            )
            assert "part" not in rm_b.rooms
            # Exactly one owner the whole way: pin and epoch still name A.
            assert "part" in rm_a.rooms
            assert await srv_b.router.get_node_for_room("part") == a_id
            _epoch, holder = await rm_a.fleet.fence.read("part")
            assert holder == a_id
            assert rm_a.migration.stats["rollbacks"] >= 1
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await srv.stop(force=True)
        bus.close()


async def test_node_death_failover_restores_room_on_survivor():
    """Kill node A (non-graceful) with a room pinned to it and media
    state checkpointed: node B's failover worker adopts the room without
    any client action, the munger lane resumes from the checkpoint (the
    continued stream emits contiguous SNs, no reset), and the failover
    counter increments."""
    bus = await start_bus()
    srv_a = srv_b = None
    try:
        srv_a, _ = await start_chaos_node(bus.port)
        srv_b, _ = await start_chaos_node(bus.port)
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, srv_a.port)
            await alice.connect("chaos", "alice")
            row_a = srv_a.room_manager.rooms["chaos"].slots.row
            rt_a = srv_a.room_manager.runtime
            rt_a.set_track(row_a, 0, published=True, is_video=False)
            rt_a.set_subscription(row_a, 0, 1, subscribed=True)
            # A's serving loop carries the traffic (mixing step_once into
            # a served runtime reorders the pipelined fan-outs, which can
            # transiently run munger state BACKWARDS); munger state —
            # polled, not sampled — is the ground truth for what went out.
            for i in range(5):
                rt_a.ingest.push(PacketIn(room=row_a, track=0, sn=7000 + i,
                                          ts=960 * i, size=50, payload=b"a"))
                await asyncio.sleep(0.02)
            deadline = asyncio.get_running_loop().time() + 10
            while (int(rt_a.munger.last_sn[row_a, 0, 1]) < 7004
                   and asyncio.get_running_loop().time() < deadline):
                await asyncio.sleep(0.02)
            assert int(rt_a.munger.last_sn[row_a, 0, 1]) == 7004
            await alice.close()

            # Make sure the bus checkpoint reflects the final munger state
            # (the periodic cadence would get there too; this pins timing).
            await srv_a.room_manager.checkpoint_rooms()
            a_id = srv_a.router.local_node.node_id

            await FaultInjector().kill_node(srv_a)
            # The stale pin still names the dead node on the bus…
            assert await srv_b.router.get_node_for_room("chaos") == a_id

            # …until B's failover worker sees the lease expire and adopts.
            deadline = asyncio.get_running_loop().time() + 15
            while ("chaos" not in srv_b.room_manager.rooms
                   and asyncio.get_running_loop().time() < deadline):
                await asyncio.sleep(0.05)
            assert "chaos" in srv_b.room_manager.rooms, "failover never happened"
            # The adoption lists the room before it writes the pin (two bus
            # round trips later): wait for the pin within the same deadline.
            b_id = srv_b.router.local_node.node_id
            while (await srv_b.router.get_node_for_room("chaos") != b_id
                   and asyncio.get_running_loop().time() < deadline):
                await asyncio.sleep(0.05)
            assert await srv_b.router.get_node_for_room("chaos") == b_id

            rt_b = srv_b.room_manager.runtime
            row_b = srv_b.room_manager.rooms["chaos"].slots.row
            # Munger lane restored from the checkpoint, not reset.
            assert int(rt_b.munger.last_sn[row_b, 0, 1]) == 7004
            # The continued stream emits contiguous, monotonic SNs across
            # the node death (subscribers re-subscribe after failover, as
            # after migration — masks deliberately don't travel). B's
            # serving loop carries the traffic — stepping manually here
            # would race its pipelined fan-out and scramble arrival order.
            rt_b.set_subscription(row_b, 0, 1, subscribed=True)
            got_b = []
            rt_b.on_tick(lambda res: got_b.extend(
                p.sn for p in res.egress if p.sub == 1 and p.room == row_b))
            for i in range(5, 10):
                rt_b.ingest.push(PacketIn(room=row_b, track=0, sn=7000 + i,
                                          ts=960 * i, size=50, payload=b"b"))
                await asyncio.sleep(0.02)
            deadline = asyncio.get_running_loop().time() + 5
            while (len(got_b) < 5
                   and asyncio.get_running_loop().time() < deadline):
                await asyncio.sleep(0.05)
            assert got_b == list(range(7005, 7010))
            assert int(rt_b.munger.last_sn[row_b, 0, 1]) == 7009
            assert srv_b.telemetry.counters["livekit_room_failovers_total"] >= 1
    finally:
        for srv in (srv_a, srv_b):
            if srv is not None:
                await _stop_quiet(srv)
        bus.close()
