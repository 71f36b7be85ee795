"""The port's node drain and single-shot handoff (service/migration.py,
RoomManager.handoff_room / checkpoint_rooms, device="cpu"): the
counterparts of the JAX package's tests/test_migration.py drain, handoff
and keyframe scenarios, on nodes of the port's server sharing one
in-process MemoryBus; and the room-checkpoint round, whose one gathered
device read must give each room the frame a per-room snapshot gives
(bytes equal)."""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.routing import MemoryBus  # noqa: E402
from tests.torch_cluster_fixture import rows_used, start_node, stop_all, wait_for  # noqa: E402


async def test_drain_moves_every_room_off_and_rejects_admissions():
    """Node drain: every room migrates off the draining node (bounded
    concurrency), all stay live on the survivors, the drained node holds
    zero rooms and refuses new admissions, and its quiescing plane is
    exempt from the watchdog."""
    bus = MemoryBus()
    a = b = c = None
    try:
        a = await start_node(bus, limits={"governor_enabled": True})
        b = await start_node(bus)
        c = await start_node(bus)
        rm_a = a.room_manager
        names = [f"room-{i}" for i in range(3)]
        for n in names:
            await rm_a.get_or_create_room(n)
        assert rows_used(a) == 3

        summary = await rm_a.migration.drain_node()
        assert summary == {"rooms": 3, "migrated": 3, "failed": []}
        assert rm_a.rooms == {} and rows_used(a) == 0
        # Every room is live on exactly one survivor, pins updated.
        for n in names:
            owner = await a.router.get_node_for_room(n)
            assert owner in (b.router.local_node.node_id,
                             c.router.local_node.node_id)
            hosting = [s for s in (b, c) if n in s.room_manager.rooms]
            assert len(hosting) == 1
            assert hosting[0].router.local_node.node_id == owner
        # The drained node: SHUTTING_DOWN, admissions refused through BOTH
        # gates (orchestrator flag + governor drain hold), watchdog off.
        from livekit_server_tpu_torch.routing.node import NodeState
        from livekit_server_tpu_torch.runtime.governor import L_MAX

        assert a.router.local_node.state == NodeState.SHUTTING_DOWN
        assert rm_a._admission_denied("room") == "node draining"
        if rm_a.governor is not None:
            assert rm_a.governor.drain_hold
            assert rm_a.governor.level == L_MAX
        if rm_a.supervisor is not None:
            assert rm_a.supervisor.draining
        # A drain message over the bus is idempotent.
        assert (await rm_a.migration.drain_node()) == {"already_draining": True}
    finally:
        await stop_all(a, b, c)


async def test_drain_with_no_peers_fails_soft():
    """A lone node drains into nobody: every room stays, the summary says
    so, and the node still refuses admissions — stop() then tears the
    rooms down normally."""
    bus = MemoryBus()
    a = None
    try:
        a = await start_node(bus)
        rm = a.room_manager
        await rm.get_or_create_room("stuck")
        summary = await rm.migration.drain_node()
        assert summary["rooms"] == 1 and summary["migrated"] == 0
        assert summary["failed"] == ["stuck"]
        assert "stuck" in rm.rooms
        assert rm._admission_denied("room") == "node draining"
    finally:
        await stop_all(a)


async def test_handoff_room_survives_bus_failure():
    """The fire-and-forget handoff must never tear down a room whose
    snapshot did not durably land: with the bus set failing, the room
    keeps serving on the source, unfrozen."""
    bus = MemoryBus()
    a = None
    try:
        a = await start_node(bus)
        rm = a.room_manager
        await rm.get_or_create_room("keep")
        row = rm.rooms["keep"].slots.row

        async def broken_set(key, value, ttl=None):
            raise ConnectionError("bus down")

        orig_set = bus.set
        bus.set = broken_set
        try:
            assert not await rm.handoff_room("keep")
        finally:
            bus.set = orig_set
        assert "keep" in rm.rooms
        assert row not in rm.runtime.ingest.frozen_rows
    finally:
        await stop_all(a)


async def test_adopted_room_solicits_keyframes():
    """The NACK blind-window satellite: adopting a room with published
    video tracks fires an immediate PLI per video track (audio tracks are
    left alone), so decoders resync without waiting for the replay ring
    to repopulate."""
    bus = MemoryBus()
    a = b = None
    try:
        a = await start_node(bus)
        b = await start_node(bus)
        rm_a, rm_b = a.room_manager, b.room_manager
        room = await rm_a.get_or_create_room("video")
        row_a = room.slots.row
        rm_a.runtime.set_track(row_a, 0, published=True, is_video=True)
        rm_a.runtime.set_track(row_a, 1, published=True, is_video=False)

        assert await rm_a.migrate_room("video")
        adopted = rm_b.rooms["video"]
        # The immediate solicitation recorded its throttle stamp for the
        # video col only; the audio col was never touched.
        assert 0 in adopted._last_pli and 1 not in adopted._last_pli
        # A republish clears the throttle and re-requests (the resync
        # hook registered on adoption).
        assert adopted.on_track_published
    finally:
        await stop_all(a, b)


async def test_checkpoint_round_gathers_rows_into_per_room_frames():
    """checkpoint_rooms reads every live row in one gathered device read
    (snapshot_rooms); each room's snapshot equals, array for array and
    bit for bit, the row read out of a full copy of the plane state at
    the same point, with the control leaves from the host mirrors and the
    munger lanes after them (the reference's snapshot_room), and the
    round rotates the generation ring (base key newest, :g1 the previous
    round)."""
    from livekit_server_tpu_torch.models import plane

    bus = MemoryBus()
    a = None
    try:
        # No cadence-driven round in between the test's two.
        a = await start_node(bus, supervisor={"checkpoint_interval_s": 600.0})
        rm = a.room_manager
        rt = rm.runtime
        rows = []
        for name in ("c0", "c1", "c2"):
            room = await rm.get_or_create_room(name)
            rows.append(room.slots.row)
            rt.set_track(room.slots.row, 0, published=True, is_video=False)
            rt.set_subscription(room.slots.row, 0, 1, subscribed=True)
        ticks = rt.stats["ticks"]
        await wait_for(lambda: rt.stats["ticks"] >= ticks + 3, 10.0, "a few ticks of state")
        async with rt.state_lock:
            batch = rt.snapshot_rooms(rows)
            full = plane.state_to_numpy(rt.state)
            single = []
            for r in rows:
                tree = plane.tree_unflatten(rt.state, [a[r] for a in full])._replace(
                    meta=plane.TrackMeta(*[np.array(m[r]) for m in rt.meta]),
                    ctrl=plane.SubControl(*[np.array(c[r]) for c in rt.ctrl]))
                single.append(plane.tree_leaves(tree) + rt.munger.snapshot_room(r))
        for got, want in zip(batch, single):
            assert len(got["arrays"]) == len(want)
            for x, y in zip(got["arrays"], want):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        await rm.checkpoint_rooms()
        first = {n: await bus.get(f"room_checkpoint:{n}") for n in ("c0", "c1", "c2")}
        assert all(first.values())
        for n in first:
            assert await bus.get(f"room_checkpoint:{n}:g1") is None
        await rm.checkpoint_rooms()
        for n, payload in first.items():
            assert await bus.get(f"room_checkpoint:{n}:g1") == payload
            snap = rt.decode_room_snapshot(await bus.get(f"room_checkpoint:{n}"))
            assert len(snap["arrays"]) == len(single[0])
        st = rm.ckpt_stats
        assert st["rounds"] == 2 and st["rooms"] == 6 and st["bytes"] > 0
    finally:
        await stop_all(a)


def test_staged_tick_row_extraction():
    """A migration takes a frozen row's packets out of the serving loop's
    staged tick (PlaneRuntime.extract_staged_row): every field as pushed,
    read from the packed device inputs even after the ingest staging set
    behind the tick's field views was scrubbed for reuse; the row's valid
    bits cleared there, the other rows' packets left; rx accounting
    reversed."""
    from livekit_server_tpu_torch.models import plane
    from livekit_server_tpu_torch.runtime import PlaneRuntime
    from livekit_server_tpu_torch.runtime.ingest import PacketIn

    rt = PlaneRuntime(plane.PlaneDims(4, 4, 4, 4), tick_ms=10, egress_shards=1, device="cpu")
    pushed = [PacketIn(room=1, track=2, sn=65534 + i, ts=(1 << 31) + 960 * i, size=30 + i,
                       payload=bytes([i]) * 5, audio_level=40 + i, frame_ms=20, layer=1,
                       temporal=i % 2, keyframe=i == 0, pid=7, tl0=3, keyidx=2,
                       arrival_rtp=123 + i, ts_aligned=i != 1) for i in range(3)]
    for pkt in pushed:
        rt.ingest.push(pkt)
    rt.ingest.push(PacketIn(room=2, track=0, sn=9, ts=0, size=10, payload=b"z"))
    assert rt.extract_staged_row(1) == []          # nothing staged yet
    rt._staged = st = rt._stage_host()
    rt.ingest.scrub_retired()
    got = rt.extract_staged_row(1)
    fields = ("track", "sn", "size", "payload", "marker", "layer", "temporal", "keyframe",
              "pid", "tl0", "keyidx", "frame_ms", "audio_level", "arrival_rtp", "ts_aligned")
    assert [[getattr(p, f) for f in fields] for p in got] == [
        [getattr(p, f) & 0xFFFF if f == "sn" else getattr(p, f) for f in fields] for p in pushed]
    assert [p.ts & 0xFFFFFFFF for p in got] == [p.ts & 0xFFFFFFFF for p in pushed]
    R, T, K, _ = rt.dims
    wire = st.wire[:len(plane.PKT_FIELDS) * R * T * K].reshape(len(plane.PKT_FIELDS), R, T, K)
    valid = wire[plane.PKT_FIELDS.index("valid")]
    assert not valid[1].any() and not st.inp.valid[1].any() and valid[2].sum() == 1
    assert rt.ingest.rx_pkts[1].sum() == 0 and rt.ingest.rx_pkts[2].sum() == 1
    assert rt.extract_staged_row(1) == []
