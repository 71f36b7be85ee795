"""The port's live migration plane (service/migration.py on the port's
RoomManager, device="cpu"): the counterparts of the JAX package's
tests/test_migration.py two-phase handoff and chaos drills, on nodes of
the port's server sharing one in-process MemoryBus. A failed handoff
leaves the room serving on the source with zero audio loss, no row leaks
on either side, and no epoch ever double-commits. SNs are integers
compared exactly. Waits poll conditions with deadlines; timeouts a drill
needs to fire are set short, the others keep the reference's 2 s."""

import asyncio

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.routing import MemoryBus  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from tests.torch_cluster_fixture import (  # noqa: E402
    pump_until, rows_used, start_node, stop_all, wait_for,
)


async def test_two_phase_commit_moves_room_and_state():
    """PREPARE → ACK → COMMIT: the room moves, the pin moves, munger
    offsets survive, the source row is released, and freeze-window
    packets bridged to the target egress there — no audio SN lost or
    duplicated across the cutover."""
    bus = MemoryBus()
    a = b = None
    try:
        a = await start_node(bus)
        b = await start_node(bus)
        rm_a, rm_b = a.room_manager, b.room_manager
        rt_a, rt_b = rm_a.runtime, rm_b.runtime
        assert rm_a.migration is not None and rm_b.migration is not None

        room = await rm_a.get_or_create_room("mig")
        row_a = room.slots.row
        rt_a.set_track(row_a, 0, published=True, is_video=False)
        rt_a.set_subscription(row_a, 0, 1, subscribed=True)
        sent = []
        for i in range(3):
            rt_a.ingest.push(PacketIn(room=row_a, track=0, sn=100 + i, ts=0,
                                      size=10, payload=b"x"))
            sent.append(100 + i)
        await pump_until(rt_a, row_a, 102)

        # Target egress collector + post-adoption re-subscribe (sub masks
        # deliberately don't travel; the real path is clients rejoining).
        got_b = []
        rt_b.on_tick(lambda res: got_b.extend(
            p.sn for p in res.egress if p.track == 0 and p.sub == 1))
        rm_b.migration.on_adopt.append(
            lambda r: rt_b.set_subscription(r.slots.row, 0, 1, subscribed=True))

        # Freeze-window packets: captured after the snapshot, bridged over.
        def feed_window(r):
            for i in range(3, 6):
                rt_a.ingest.push(PacketIn(room=row_a, track=0, sn=100 + i,
                                          ts=0, size=10, payload=b"w"))
                sent.append(100 + i)
        rm_b.migration.on_adopt.append(feed_window)

        assert await rm_a.migrate_room("mig")
        assert "mig" not in rm_a.rooms and "mig" in rm_b.rooms
        assert rows_used(a) == 0 and rows_used(b) == 1
        assert rt_a.ingest.frozen_rows == set()
        assert (await a.router.get_node_for_room("mig")
                == b.router.local_node.node_id)

        row_b = rm_b.rooms["mig"].slots.row
        # Munger lane continued (105 after the bridged window drains).
        await pump_until(rt_b, row_b, 105)
        # The fan-out of the lane's last tick lands after the lane moved.
        await wait_for(lambda: len(got_b) >= len(sent) - 3, 10.0, "the last fan-out")
        assert sorted(got_b) == sent[3:], "bridged window lost or duplicated"
        st_a, st_b = rm_a.migration.stats, rm_b.migration.stats
        assert st_a["commits"] == 1 and st_a["rollbacks"] == 0
        assert st_b["adoptions"] == 1 and st_b["commits_in"] == 1
        assert st_b["bridged_in"] == 3

        # Steady ticks on the adopting node keep the lane going.
        for i in range(6, 9):
            rt_b.ingest.push(PacketIn(room=row_b, track=0, sn=100 + i,
                                      ts=0, size=10, payload=b"s"))
        await pump_until(rt_b, row_b, 108)
    finally:
        await stop_all(a, b)


async def test_silent_target_rolls_back_with_no_leaks():
    """Drill: the target adopts every PREPARE then goes silent (killed
    mid-handoff). Every attempt times out, the source rolls back and
    keeps serving with zero audio gap, and the target's aborted
    adoptions release their rows — no leak, no double-serving."""
    bus = MemoryBus()
    a = b = None
    try:
        a = await start_node(bus, migration={"ack_timeout_s": 0.5})
        b = await start_node(
            bus, faults={"enabled": True, "mig_drop_prepare": True})
        rm_a, rm_b = a.room_manager, b.room_manager
        rt_a = rm_a.runtime

        await rm_a.get_or_create_room("mig")
        row_a = rm_a.rooms["mig"].slots.row
        rt_a.set_track(row_a, 0, published=True, is_video=False)
        rt_a.set_subscription(row_a, 0, 1, subscribed=True)
        for i in range(3):
            rt_a.ingest.push(PacketIn(room=row_a, track=0, sn=200 + i, ts=0,
                                      size=10, payload=b"x"))
        await pump_until(rt_a, row_a, 202)

        assert not await rm_a.migrate_room("mig")

        # Source: still serving, unfrozen, pin still ours.
        assert "mig" in rm_a.rooms
        assert rt_a.ingest.frozen_rows == set()
        assert (await a.router.get_node_for_room("mig")
                == a.router.local_node.node_id)
        st = rm_a.migration.stats
        assert st["rollbacks"] == 1 and st["commits"] == 0
        assert st["timeouts"] == 2          # retry_attempts
        # Target: every aborted adoption releases, nothing left behind
        # (the final abort is handled asynchronously — wait for it).
        stb = rm_b.migration.stats
        assert rm_b.fault.stats.mig_prepares_swallowed == 2
        await wait_for(lambda: "mig" not in rm_b.rooms, what="target release")
        assert rows_used(b) == 0
        assert stb["adoptions_released"] == stb["adoptions"]
        # 100% audio continuity on the source across the aborted handoff:
        # packets pushed now still advance the same lane contiguously.
        for i in range(3, 6):
            rt_a.ingest.push(PacketIn(room=row_a, track=0, sn=200 + i, ts=0,
                                      size=10, payload=b"x"))
        await pump_until(rt_a, row_a, 205)
    finally:
        await stop_all(a, b)


async def test_freeze_window_replays_locally_on_rollback():
    """Packets ingested during a failed handoff's freeze window are not
    lost: rollback replays them into the local ingest and they egress on
    the source in order."""
    bus = MemoryBus()
    a = b = None
    try:
        a = await start_node(bus, migration={"ack_timeout_s": 0.5})
        b = await start_node(
            bus, faults={"enabled": True, "mig_drop_prepare": True},
            migration={"retry_attempts": 1})
        rm_a = a.room_manager
        rt_a = rm_a.runtime
        await rm_a.get_or_create_room("mig")
        row_a = rm_a.rooms["mig"].slots.row
        rt_a.set_track(row_a, 0, published=True, is_video=False)
        rt_a.set_subscription(row_a, 0, 1, subscribed=True)
        rt_a.ingest.push(PacketIn(room=row_a, track=0, sn=300, ts=0,
                                  size=10, payload=b"x"))
        await pump_until(rt_a, row_a, 300)

        # Inject mid-freeze traffic the moment the target adopts (the
        # window between snapshot and the timeout verdict).
        def feed(r):
            for i in range(1, 4):
                rt_a.ingest.push(PacketIn(room=row_a, track=0, sn=300 + i,
                                          ts=0, size=10, payload=b"w"))
        b.room_manager.migration.on_adopt.append(feed)

        assert not await rm_a.migrate_room("mig")
        # The frozen-window packets re-entered the local plane: the lane
        # reaches 303 with no gap and no duplicate delivery.
        await pump_until(rt_a, row_a, 303)
        assert rt_a.ingest.frozen_rows == set()
    finally:
        await stop_all(a, b)


async def test_nack_renegotiates_to_next_candidate():
    """Governed admission: a draining candidate NACKs the PREPARE and the
    source renegotiates with the next ranked node — the room lands on the
    healthy peer, untouched by the refusing one."""
    bus = MemoryBus()
    a = b = c = None
    try:
        a = await start_node(bus)
        b = await start_node(bus)
        c = await start_node(bus)
        rm_a = a.room_manager
        b.room_manager.migration.draining = True   # admission-refusing peer

        await rm_a.get_or_create_room("mig")
        mig = rm_a.migration
        b_id = b.router.local_node.node_id
        c_id = c.router.local_node.node_id

        async def ranked():
            return [b_id, c_id]   # force the refusing node first

        mig._candidates = ranked
        assert await mig.migrate_room("mig")
        assert "mig" in c.room_manager.rooms
        assert "mig" not in b.room_manager.rooms and rows_used(b) == 0
        assert mig.stats["nacks_received"] == 1
        assert mig.stats["rollbacks"] == 1 and mig.stats["commits"] == 1
        assert b.room_manager.migration.stats["nacks_sent"] == 1
        assert (await a.router.get_node_for_room("mig") == c_id)
    finally:
        await stop_all(a, b, c)


async def test_late_ack_hits_epoch_guard():
    """Drill: the target delays its ACK past the source's timeout. The
    source aborts that epoch and gives up; when the stale ACK finally
    lands it finds no live attempt and is dropped — it must never
    resurrect an aborted handoff (double-commit guard)."""
    bus = MemoryBus()
    a = b = None
    try:
        a = await start_node(bus, migration={"retry_attempts": 1,
                                             "ack_timeout_s": 0.5})
        b = await start_node(
            bus, faults={"enabled": True, "mig_ack_delay_s": 1.5})
        rm_a, rm_b = a.room_manager, b.room_manager
        await rm_a.get_or_create_room("mig")

        assert not await rm_a.migrate_room("mig")
        assert "mig" in rm_a.rooms

        # Let the delayed ACK arrive and the abort settle on the target.
        await wait_for(lambda: rm_a.migration.stats["stale_acks"] == 1, what="stale ACK")
        await wait_for(lambda: "mig" not in rm_b.rooms, what="target release")
        assert rows_used(b) == 0
        assert rm_a.migration._attempts == {}
        assert rm_b.migration._adoptions == {}
        assert rm_b.fault.stats.mig_acks_delayed == 1
    finally:
        await stop_all(a, b)


async def test_corrupt_handoff_payload_is_nacked():
    """Drill: the encoded snapshot is damaged in flight. The target's
    checksum verification rejects it with a NACK — nothing is adopted
    from a payload that cannot prove integrity — and the source rolls
    back to serving."""
    bus = MemoryBus()
    a = b = None
    try:
        a = await start_node(
            bus, faults={"enabled": True, "mig_corrupt_handoff": True},
            migration={"retry_attempts": 1})
        b = await start_node(bus)
        rm_a, rm_b = a.room_manager, b.room_manager
        await rm_a.get_or_create_room("mig")

        assert not await rm_a.migrate_room("mig")
        assert "mig" in rm_a.rooms
        assert "mig" not in rm_b.rooms and rows_used(b) == 0
        assert rm_a.migration.stats["nacks_received"] == 1
        assert rm_b.migration.stats["adoptions"] == 0
        assert rm_a.fault.stats.mig_handoffs_corrupted == 1
    finally:
        await stop_all(a, b)


async def test_sever_mid_commit_rolls_back_then_succeeds():
    """Drill: the bus dies between the target's ACK and the source's
    COMMIT. The commit fails, the source rolls back (re-asserting its own
    pin — the repin may already have happened) and keeps serving; the
    orphaned adoption on the target is released; a later attempt, with
    the partition healed, commits cleanly."""
    bus = MemoryBus()
    a = b = None
    try:
        a = await start_node(
            bus, faults={"enabled": True, "mig_sever_handoffs": 1},
            migration={"retry_attempts": 1})
        b = await start_node(bus)
        rm_a, rm_b = a.room_manager, b.room_manager
        await rm_a.get_or_create_room("mig")
        a_id = a.router.local_node.node_id

        assert not await rm_a.migrate_room("mig")
        assert "mig" in rm_a.rooms
        assert await a.router.get_node_for_room("mig") == a_id
        assert rm_a.migration.stats["rollbacks"] == 1
        assert rm_a.fault.stats.mig_commits_severed == 1
        # The target's adoption was aborted — row released, no leak.
        await wait_for(lambda: "mig" not in rm_b.rooms, what="target release")
        assert rows_used(b) == 0

        # Partition healed (the seam consumed its budget): clean commit.
        assert await rm_a.migrate_room("mig")
        assert "mig" in rm_b.rooms and rows_used(a) == 0
        assert (await a.router.get_node_for_room("mig")
                == b.router.local_node.node_id)
    finally:
        await stop_all(a, b)
