"""The port's PlaneRuntime over room shards (`mesh=`, 8 CPU shards)
against the JAX package's meshed PlaneRuntime (the conftest's 8 virtual
CPU devices) and the port's own unsharded runtime: the counterpart of
tests/test_parallel.py's runtime loop, plus the checkpoint family on a
meshed runtime (full frames, room rows, repair, restore), the ctrl
uploads and the staged-row extraction, and the integrity audit over a
sharded state. Then the service seams: the paged runtime over a pool
mesh (page shards) against the unsharded paged runtime,
`RoomManager(..., mesh=)` and `create_server(..., mesh=)`, and the config
guard now that `config.UNPORTED` is empty.

Egress columns must be equal. States that ticked in both packages are
held to each other with integers and bools equal and floats within
`plane.float_tolerance` (reasons in tests/test_torch_plane.py); the
meshed and the unsharded port runtimes, and every restore, bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import socket  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from livekit_server_tpu.runtime import PlaneRuntime as JaxRuntime  # noqa: E402
from livekit_server_tpu.runtime.ingest import PacketIn as JaxPacket  # noqa: E402
from livekit_server_tpu_torch.config import ConfigError, load_config  # noqa: E402
from livekit_server_tpu_torch.config import config as config_mod  # noqa: E402
from livekit_server_tpu_torch.models import paged, plane  # noqa: E402
from livekit_server_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime import integrity  # noqa: E402
from livekit_server_tpu_torch.runtime import paged_runtime as paged_runtime_mod  # noqa: E402
from livekit_server_tpu_torch.runtime.faultinject import FaultInjector, FaultSpec  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.udp import start_udp_transport  # noqa: E402
from livekit_server_tpu_torch.service.server import create_server  # noqa: E402
from tests.torch_udp_fixture import drain, until  # noqa: E402

CPU = torch.device("cpu")
MESH = tmesh.make_mesh([CPU] * 8)
DIMS = plane.PlaneDims(rooms=8, tracks=4, pkts=4, subs=4)
NAMES = plane.leaf_names(plane.init_state(DIMS, device="cpu"))


def _port(dims=DIMS, **kw):
    return PlaneRuntime(dims, tick_ms=10, egress_shards=1, device="cpu", **kw)


def _key(batch):
    return sorted(zip(np.asarray(batch.rooms).tolist(), np.asarray(batch.subs).tolist(),
                      (np.asarray(batch.sn) & 0xFFFF).tolist(), np.asarray(batch.ts).tolist()))


def _exact(got, want, where):
    assert len(got) == len(want), where
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), (where, i)


def _close(got, want, where):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        if b.dtype.kind == "f":
            rtol, atol = plane.float_tolerance(name)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{where} {name}")
        else:
            assert np.array_equal(a, b.astype(a.dtype)), (where, name)


async def test_sharded_runtime_loop_matches_single_device():
    """The stage/dispatch/complete loop against sharded state: packets
    into rooms on three different shards, egress fanned out through the
    real UDP transport, every forwarded (room, sub, sn, ts) equal to the
    JAX meshed runtime's and the port's unsharded runtime's; then the
    pipelined serving loop on the sharded state. Waits poll with a
    deadline."""
    dims = plane.PlaneDims(rooms=8, tracks=2, pkts=4, subs=2)
    rt_j = JaxRuntime(jplane.PlaneDims(*dims), tick_ms=10, mesh=jmake_mesh(n_devices=8))
    rt_m = _port(dims, mesh=MESH)
    rt_s = _port(dims)
    assert isinstance(rt_m.state, tmesh.Sharded) and rt_m.device == CPU
    udp = await start_udp_transport(rt_m.ingest, "127.0.0.1", 0)
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    sink.setblocking(False)
    rooms = (0, 3, 7)
    try:
        for rt in (rt_j, rt_m, rt_s):
            for r in rooms:
                rt.set_track(r, 0, published=True, is_video=False)
                rt.set_subscription(r, 0, 1, subscribed=True)
        for r in rooms:
            udp.assign_ssrc(r, 0, is_video=False)
            udp.register_subscriber(r, 1, sink.getsockname())
        rt_m.on_tick(lambda res: udp.send_egress_batch(res.egress_batch))
        for tick in range(4):
            for rt, cls in ((rt_j, JaxPacket), (rt_m, PacketIn), (rt_s, PacketIn)):
                for r in rooms:
                    rt.ingest.push(cls(room=r, track=0, sn=100 + tick, ts=960 * tick,
                                       size=40, payload=bytes([r]) * 40))
            res = [await rt.step_once() for rt in (rt_j, rt_m, rt_s)]
            assert _key(res[1].egress_batch) == _key(res[0].egress_batch)
            assert _key(res[1].egress_batch) == _key(res[2].egress_batch)
            assert len(res[1].egress_batch) == len(rooms)
        got = []
        await until(lambda: len(got.__iadd__(drain(sink))) >= 4 * len(rooms),
                    "the meshed runtime's egress at the sink")
        _exact(plane.state_to_numpy(tmesh.gather_tree(rt_m.state)),
               plane.state_to_numpy(rt_s.state), "meshed vs unsharded")
        _close(plane.state_to_numpy(tmesh.gather_tree(rt_m.state)),
               [np.asarray(x) for x in jax.tree.leaves(rt_j.state)], "port vs JAX")

        # The pipelined serving loop on the sharded state.
        rt_m.start()
        for tick in range(3):
            for r in rooms:
                rt_m.ingest.push(PacketIn(room=r, track=0, sn=200 + tick, ts=960 * (10 + tick),
                                          size=40, payload=b"y" * 40))
            sent = rt_m.stats["fwd_packets"]
            await until(lambda: rt_m.stats["fwd_packets"] >= sent + len(rooms),
                        "the loop's next forwarded tick")
        assert rt_m.stats["ticks"] >= 3
    finally:
        for rt in (rt_j, rt_m, rt_s):
            await rt.stop()
        udp.transport.close()
        sink.close()


def _setup(rt):
    for room in range(DIMS.rooms):
        rt.set_track(room, 0, published=True, is_video=False)
        rt.set_track(room, 1, published=True, is_video=True, is_svc=room % 3 == 1)
        for sub in (1, 2):
            rt.set_subscription(room, 0, sub, subscribed=True)
            rt.set_subscription(room, 1, sub, subscribed=True)
    return rt


async def _tick(rts, i):
    res = []
    for rt in rts:
        cls = JaxPacket if isinstance(rt, JaxRuntime) else PacketIn
        for room in range(DIMS.rooms):
            rt.ingest.push(cls(room=room, track=0, sn=(1000 + i) & 0xFFFF, ts=960 * i,
                               size=50, payload=b"a", audio_level=40 + room))
            rt.ingest.push(cls(room=room, track=1, sn=(7000 + i) & 0xFFFF, ts=3000 * i,
                               size=900, payload=b"v" * 900, keyframe=i == 0,
                               layer_sync=True, begin_pic=True, marker=True))
            rt.ingest.push_feedback(room, 1, estimate=2e6 + 1e5 * i)
        res.append(await rt.step_once())
    return res


def _ptrs(rt):
    return {x.data_ptr() for s in rt.state.shards for x in plane.tree_leaves(s)}


async def test_meshed_frames_restore_across_packages_and_layouts():
    """A meshed runtime's snapshot equals the unsharded runtime's after the
    same ticks, and its frame restores onto the JAX runtime and onto an
    unsharded port runtime; the JAX frame restores back onto a fresh
    meshed runtime (fresh tensors on every shard), and all four tick on
    equal."""
    ref, meshed, flat = _setup(JaxRuntime(jplane.PlaneDims(*DIMS), tick_ms=10)), \
        _setup(_port(mesh=MESH)), _setup(_port())
    for i in range(4):
        res = await _tick((ref, meshed, flat), i)
        assert _key(res[1].egress_batch) == _key(res[0].egress_batch) == \
            _key(res[2].egress_batch)
    msnap, fsnap, jsnap = meshed.snapshot(), flat.snapshot(), ref.snapshot()
    _exact(msnap["arrays"], fsnap["arrays"], "meshed vs unsharded snapshot")
    _exact(msnap["munger"], fsnap["munger"], "munger")
    _close(msnap["arrays"], jsnap["arrays"], "meshed vs JAX snapshot")
    for a, b in zip(meshed.snapshot_rooms([2, 5]), flat.snapshot_rooms([2, 5])):
        _exact(a["arrays"], b["arrays"], "room rows")

    blob = meshed.encode_snapshot(msnap)
    ref2, flat2 = _setup(JaxRuntime(jplane.PlaneDims(*DIMS), tick_ms=10)), _setup(_port())
    ref2.restore(ref2.decode_snapshot(blob))
    flat2.restore(flat2.decode_snapshot(blob))
    meshed2 = _setup(_port(mesh=MESH))
    before = _ptrs(meshed2)
    meshed2.restore(meshed2.decode_snapshot(ref.encode_snapshot(jsnap)))
    assert not before & _ptrs(meshed2)
    _exact(plane.state_to_numpy(tmesh.gather_tree(meshed2.state)), jsnap["arrays"], "restored")
    _exact([np.asarray(x) for x in jax.tree.leaves(ref2.state)], msnap["arrays"], "JAX restored")
    res = await _tick((ref2, meshed2, flat2), 4)
    assert _key(res[0].egress_batch) == _key(res[1].egress_batch) == _key(res[2].egress_batch)
    _close(meshed2.snapshot()["arrays"], ref2.snapshot()["arrays"], "after the restore")
    with pytest.raises(ValueError, match="leaves"):
        meshed2.restore({"tick_index": 0, "arrays": []})


async def test_meshed_repair_restore_room_bitflip_and_audit():
    """Row repair and room restore land on the owning shard in place; the
    seeded bitflip lands in the same elements as on the unsharded plane;
    the audit of the sharded state equals the unsharded audit, mask and
    per-rule counters, clean and with a corrupt row; a meshed runtime's
    monitor audits on its cadence."""
    meshed, flat = _setup(_port(mesh=MESH)), _setup(_port())
    spec = FaultSpec(bitflip_tick=3, bitflip_room=6, bitflip_leaf="pacer_state.tokens",
                     bitflip_bit=30, bitflip_count=2, seed=11)
    meshed.fault, flat.fault = FaultInjector(spec), FaultInjector(spec)
    for i in range(3):
        await _tick((meshed, flat), i)
    ckpt = flat.snapshot()
    for i in range(3, 6):
        await _tick((meshed, flat), i)
    assert meshed.fault.stats.bitflips == flat.fault.stats.bitflips == 2
    _exact(meshed.snapshot()["arrays"], flat.snapshot()["arrays"], "after the bitflip")

    ptrs = _ptrs(meshed)
    row = flat.row_snapshot_from_full(ckpt, 6)
    for rt in (meshed, flat):
        rt.repair_room_row(6, row)
        rt.restore_room(1, rt.snapshot_room(4))
    assert _ptrs(meshed) == ptrs            # written in place
    _exact(meshed.snapshot()["arrays"], flat.snapshot()["arrays"], "after repair and restore")
    for rt in (meshed, flat):
        assert not rt.ctrl.subscribed[1].any() and 1 in rt._dirty_rows
    await _tick((meshed, flat), 6)
    _exact(meshed.snapshot()["arrays"], flat.snapshot()["arrays"], "the tick after")

    for corrupt in (False, True):
        if corrupt:
            for tree, r in ((tmesh.locate(meshed.state, 5)), (flat.state, 5)):
                tree.bwe_state.last_estimate[r, 0] = float("nan")
                tree.ctrl.max_spatial[r, 1, 1] = 9
        m_mask, m_counts, m_mirror = integrity.audit_plane(
            meshed.state, integrity.init_mirror(meshed.state))
        f_mask, f_counts, _ = integrity.audit_plane(flat.state, integrity.init_mirror(flat.state))
        assert isinstance(m_mirror, tmesh.Sharded)
        assert torch.equal(m_mask, f_mask) and torch.equal(m_counts, f_counts)
        assert (int(m_mask[5]) != 0) == corrupt and int(m_mask.sum()) == int(m_mask[5])

    mon = integrity.IntegrityMonitor(meshed, audit_every_ticks=1)
    meshed.integrity = mon
    mon.maybe_audit(8)
    assert mon.audits == 1 and mon.last_mask[5] != 0 and 5 in mon.quarantined


# Two pages a shard: room 1's 2x2 grid straddles shards.
async def test_meshed_ctrl_uploads_land_on_the_owning_shard():
    """A dirty-row delta (one row), a full upload (more rows than the
    delta allows) and the governor's shed overlay give the meshed state
    the unsharded state's meta and control, row for row."""
    meshed, flat = _setup(_port(mesh=MESH)), _setup(_port())
    for rt in (meshed, flat):
        rt._upload_ctrl()           # the first upload is a full one
    for edit, kind in ((lambda rt: rt.set_layer_caps(6, 1, 2, 0, 1), "ctrl_delta_uploads"),
                       (lambda rt: [rt.set_subscription(r, 0, 3, subscribed=True)
                                    for r in (1, 4, 7)], "ctrl_full_uploads"),
                       (lambda rt: rt.set_shed(spatial_cap=0, pause_video=True),
                        "ctrl_full_uploads")):
        for rt in (meshed, flat):
            before = rt.stats[kind]
            edit(rt)
            rt._upload_ctrl()
            assert rt.stats[kind] == before + 1
        m = tmesh.gather_tree(meshed.state)
        _exact(plane.tree_leaves((m.meta, m.ctrl)),
               plane.tree_leaves((flat.state.meta, flat.state.ctrl)), kind)
    assert int(m.ctrl.max_spatial.max()) == 0 and bool(m.ctrl.sub_muted[6, 1].all())


async def test_meshed_staged_row_extraction():
    """`extract_staged_row` on a meshed runtime reads and clears the row in
    its shard's wire: the same packets as the unsharded runtime, and the
    staged tick then steps to the same outputs."""
    meshed, flat = _setup(_port(mesh=MESH)), _setup(_port())
    for rt in (meshed, flat):
        for room in (2, 5, 6):
            for k in range(3):
                rt.ingest.push(PacketIn(room=room, track=0, sn=300 + k, ts=960 * k, size=50,
                                        payload=bytes([room, k])))
        rt._staged = rt._stage_host()
    got = [rt.extract_staged_row(5) for rt in (meshed, flat)]
    assert got[0] == got[1] and [p.sn for p in got[0]] == [300, 301, 302]
    assert [meshed.extract_staged_row(r) for r in (5, 3)] == [[], []]
    outs = []
    for rt in (meshed, flat):
        st, rt._staged = rt._staged, None
        rt._upload(st)
        outs.append(rt._device_step(st))
    _exact(list(outs[0]), list(outs[1]), "the staged tick's outputs")
    assert int(outs[0].fwd_packets[5]) == 0 and int(outs[0].fwd_packets[6]) > 0


PD = paged.PagedDims(rooms=8, tracks=4, pkts=4, subs=8, tpage=2, spage=4, pool_pages=16)
ROOMS = [("a", 1, 2), ("b", 4, 8), ("c", 2, 5)]
PCOLUMNS = ("rooms", "tracks", "ks", "subs", "sn", "ts", "pid", "tl0", "keyidx")


def _setup_paged_rooms(rt):
    handles = {}
    for name, tracks, subs in ROOMS:
        s = rt.slots.alloc_room(name)
        handles[name] = s
        for i in range(tracks):
            s.alloc_track(f"t{i}")
        for i in range(subs):
            s.alloc_sub(f"p{i}")
    rt.set_track(0, 0, published=True, is_video=True)
    rt.set_subscription(0, 0, 1, subscribed=True)
    rt.set_track(1, 0, published=True, is_video=True)
    rt.set_track(1, 3, published=True, is_video=False)
    for sub in range(8):
        rt.set_subscription(1, 0, sub, subscribed=True)
    rt.set_subscription(1, 3, 2, subscribed=True)
    rt.set_track(2, 1, published=True, is_video=False)
    rt.set_subscription(2, 1, 4, subscribed=True)
    return handles


def _push_paged(rt, tick):
    for room, track, base in [(0, 0, 100), (1, 0, 500), (1, 3, 900), (2, 1, 1300)]:
        for j in range(2):
            sn = base + tick * 2 + j
            rt.ingest.push(PacketIn(room=room, track=track, sn=sn & 0xFFFF,
                                    ts=(960 * (tick * 2 + j)) & 0xFFFFFFFF, size=120,
                                    payload=b"x" * 120, keyframe=(tick == 0 and j == 0),
                                    audio_level=-(30 + (sn % 20))))


def _capture(rt, log):
    orig = rt._unpack_outputs

    def wrapped(buf):
        out = orig(buf)
        log.append(out)
        return out

    rt._unpack_outputs = wrapped


async def test_paged_runtime_pool_mesh_matches_unsharded(monkeypatch):
    """`paged_kernel="on"` under a pool mesh falls to "off" with the
    reference's warning ("auto" silently); the page-sharded runtime
    matches the unsharded stock runtime through a grow across a page
    boundary (tick 3), a release plus compaction that moves pages across
    shards (tick 5), a full restore onto fresh shards, and the audit."""
    warned = []

    class Recorder(paged_runtime_mod.Logger):
        def warn(self, msg, **kw):
            warned.append((msg, kw))

    monkeypatch.setattr(paged_runtime_mod, "Logger", Recorder)
    auto = PagedPlaneRuntime(PD, tick_ms=10, egress_shards=1, mesh=MESH)
    assert not warned and auto.pager_stats()["paged_kernel"] == "off"
    meshed = PagedPlaneRuntime(PD, tick_ms=10, egress_shards=1, mesh=MESH, paged_kernel="on")
    assert warned == [("paged_kernel forced off: pool-mesh sharding uses the stock pooled "
                       "tick", {"requested": "on"})]
    flat = PagedPlaneRuntime(PD, tick_ms=10, egress_shards=1, device="cpu", paged_kernel="off")
    assert isinstance(meshed.state, tmesh.Sharded) and isinstance(meshed.table, tmesh.Sharded)
    got, want = [], []
    _capture(meshed, got)
    _capture(flat, want)
    handles = (_setup_paged_rooms(meshed), _setup_paged_rooms(flat))
    for t in range(8):
        res = []
        for rt in (meshed, flat):
            _push_paged(rt, t)
            res.append(await rt.step_once())
        _exact(list(got[-1]), list(want[-1]), f"outputs {t}")
        for col in PCOLUMNS:
            assert np.array_equal(getattr(res[0].egress_batch, col),
                                  getattr(res[1].egress_batch, col)), (t, col)
        if t == 3:      # grow room "a" across its spage=4 boundary
            for rt, hs in zip((meshed, flat), handles):
                for i in range(2, 6):
                    hs["a"].alloc_sub(f"p{i}")
                rt.set_subscription(0, 0, 5, subscribed=True)
        if t == 5:      # free room "c", compact: pages of "b" relocate
            for rt in (meshed, flat):
                rt.slots.release_room("c")
                assert rt.compact() > 0
    _exact(plane.tree_leaves(meshed._to_logical_state()),
           plane.tree_leaves(flat._to_logical_state()), "logical state")
    for a, b in zip(meshed._sel_mirror(meshed.state), flat._sel_mirror(flat.state)):
        assert np.array_equal(a, b)
    assert meshed.stats["page_moves"] == flat.stats["page_moves"] > 0
    assert meshed.stats["cross_shard_pages"] > 0 and flat.stats["cross_shard_pages"] == 0
    _exact(plane.tree_leaves(tmesh.gather_tree(meshed.table)),
           plane.tree_leaves(flat.table), "page table")

    # The audit over page shards equals the unsharded audit.
    for rt in (meshed, flat):
        rt.integrity = integrity.IntegrityMonitor(rt, audit_every_ticks=1)
        rt.integrity.maybe_audit(8)
    assert meshed.integrity.last_mask == flat.integrity.last_mask
    assert meshed.integrity.audits == 1

    # A full restore binds fresh tensors on every shard and ticks on equal.
    snap = flat.snapshot()
    before = {x.data_ptr() for s in meshed.state.shards for x in plane.tree_leaves(s)}
    meshed.restore(snap)
    assert not before & {x.data_ptr() for s in meshed.state.shards
                         for x in plane.tree_leaves(s)}
    flat.restore(snap)
    for rt in (meshed, flat):
        _push_paged(rt, 8)
        await rt.step_once()
    _exact(list(got[-1]), list(want[-1]), "outputs after the restore")
    _exact(meshed.snapshot()["arrays"], flat.snapshot()["arrays"], "after the restore")


def _config(**plane_kw):
    base = {"limits": {"governor_enabled": False}, "rtc": {"udp_port": 0, "tcp_port": 0},
            "egress": {"shards": 1}, "keys": {"k": "s" * 32}, "port": 0,
            "plane": dict(rooms=8, tracks_per_room=4, pkts_per_track=4, subs_per_room=4,
                          tick_ms=10, **plane_kw)}
    return load_config(base=base, env={})


async def test_room_manager_and_server_take_a_mesh():
    """`create_server(cfg, device=..., mesh=)` hands the mesh through
    RoomManager to the runtime: room shards on the dense plane, page
    shards on the paged plane; a tick steps every shard."""
    rm = create_server(_config(), device="cpu", mesh=MESH).room_manager
    assert rm.runtime._mesh is MESH and len(rm.runtime.state.shards) == 8
    rm.runtime.set_track(5, 0, published=True, is_video=False)
    rm.runtime.set_subscription(5, 0, 1, subscribed=True)
    rm.runtime.ingest.push(PacketIn(room=5, track=0, sn=1, ts=0, size=40, payload=b"z"))
    res = await rm.runtime.step_once()
    assert [(p.room, p.sub) for p in res.egress] == [(5, 1)]
    await rm.runtime.stop()
    cfg = _config(pager_enabled=True, pager_tpage=2, pager_spage=2, paged_kernel="on")
    rt = create_server(cfg, device="cpu", mesh=MESH).room_manager.runtime
    assert rt._pmesh is MESH and rt._mesh is None
    assert isinstance(rt.state, tmesh.Sharded) and rt.pager_stats()["paged_kernel"] == "off"
    await rt.stop()


def test_check_ported_accepts_mesh_devices_and_refuses_a_listed_entry(monkeypatch):
    """`plane.mesh_devices: 8` passes (the shipped UNPORTED is empty, and
    nothing reads the key, as in the reference); an entry on a non-empty
    UNPORTED, patched in here, is still refused by check_ported and by
    RoomManager, and the overlay turns it off."""
    assert config_mod.UNPORTED == () and config_mod.port_overlay() == {}
    cfg = _config(mesh_devices=8)
    config_mod.check_ported(cfg)
    assert create_server(cfg, device="cpu").room_manager.runtime._mesh is None
    monkeypatch.setattr(config_mod, "UNPORTED", (
        ("plane.low_latency", lambda v: bool(v), False, "A99 (test entry)"),))
    config_mod.check_ported(cfg)
    cfg = _config(low_latency=True)
    with pytest.raises(ConfigError, match=r"plane.low_latency=True .*ROADMAP A99"):
        config_mod.check_ported(cfg)
    with pytest.raises(ConfigError, match="plane.low_latency"):
        create_server(cfg, device="cpu")
    assert config_mod.port_overlay() == {"plane": {"low_latency": False}}
    assert not config_mod.apply_port_overlay(cfg).plane.low_latency
