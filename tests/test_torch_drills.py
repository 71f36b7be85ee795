"""The port's failure and overload plane driven end to end on the CPU,
mirroring the JAX package's drills (tests/test_integrity.py,
tests/test_overload.py) without the bus. Run in both packages on the
same seeded runtime and held to each other: an unrepairable row
escalates once; a repair storm costs one supervisor restart, which
restores the checkpoint; a corrupt checkpoint falls back one generation.
The port alone (the reference has no such seam): a device step a restart
abandoned cannot reach the restored state, dense and paged; a governed
plane is spared by the watchdog while a wedged one restarts; L4 refuses
joins and publishes over the wire; and RoomManager wires all four
subsystems from the config.

Outcomes compare exactly; restored states compare with integers and
bools equal and floats within `plane.float_tolerance` (the two packages'
ticks agree to that bound), and each equals its own checkpoint bit for
bit. One file: the JAX runtimes here share one tick compile."""

import asyncio
import threading
from types import SimpleNamespace

import aiohttp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import torch_paged_fixture as fx  # noqa: E402

from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.runtime import FaultInjector as JaxInjector  # noqa: E402
from livekit_server_tpu.runtime import PlaneRuntime as JaxRuntime  # noqa: E402
from livekit_server_tpu.runtime import PlaneSupervisor as JaxSupervisor  # noqa: E402
from livekit_server_tpu.runtime.faultinject import FaultSpec as JaxSpec  # noqa: E402
from livekit_server_tpu.runtime.faultinject import _replace_leaf as jax_replace_leaf  # noqa: E402
from livekit_server_tpu.runtime.ingest import PacketIn as JaxPacket  # noqa: E402
from livekit_server_tpu.runtime.integrity import IntegrityMonitor as JaxMonitor  # noqa: E402
from livekit_server_tpu.utils import checksum as jchecksum  # noqa: E402
from livekit_server_tpu.utils.backoff import BackoffPolicy as JaxBackoff  # noqa: E402
from livekit_server_tpu_torch.config.config import Config, apply_port_overlay  # noqa: E402
from livekit_server_tpu_torch.models import paged, plane  # noqa: E402
from livekit_server_tpu_torch.ops import bwe  # noqa: E402
from livekit_server_tpu_torch.routing import LocalNode, LocalRouter  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime import governor as gov_mod  # noqa: E402
from livekit_server_tpu_torch.runtime.faultinject import (  # noqa: E402
    FaultInjector,
    FaultSpec,
    _replace_leaf,
)
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.integrity import IntegrityMonitor  # noqa: E402
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.supervisor import PlaneSupervisor  # noqa: E402
from livekit_server_tpu_torch.service.roommanager import RoomManager  # noqa: E402
from livekit_server_tpu_torch.service.store import LocalStore  # noqa: E402
from livekit_server_tpu_torch.utils import checksum  # noqa: E402
from livekit_server_tpu_torch.utils.backoff import BackoffPolicy  # noqa: E402
from tests.test_torch_service import SignalClient, running_server, token  # noqa: E402

# Every drill plane has ROOMS rooms: one JAX tick compile serves them all.
ROOMS = 6
NAMES = plane.leaf_names(plane.init_state(plane.PlaneDims(ROOMS, 4, 4, 4), device="cpu"))
PORT = SimpleNamespace(
    packet=PacketIn, monitor=IntegrityMonitor, supervisor=PlaneSupervisor,
    backoff=BackoffPolicy, injector=FaultInjector, spec=FaultSpec,
    header=checksum.HEADER_SIZE, leaves=plane.state_to_numpy)
JAX = SimpleNamespace(
    packet=JaxPacket, monitor=JaxMonitor, supervisor=JaxSupervisor,
    backoff=JaxBackoff, injector=JaxInjector, spec=JaxSpec,
    header=jchecksum.HEADER_SIZE,
    leaves=lambda state: [np.asarray(x) for x in jax.tree.leaves(state)])


def make_rt(rooms: int = ROOMS, pkg=PORT):
    """One published audio track + one subscriber per room (audio-only
    keeps selector rows inert, so injected corruption persists until the
    audit sees it), in the port or (`pkg=JAX`) the JAX package."""
    dims = (rooms, 4, 4, 4)
    if pkg is JAX:
        rt = JaxRuntime(jplane.PlaneDims(*dims), tick_ms=10)
    else:
        rt = PlaneRuntime(plane.PlaneDims(*dims), tick_ms=10, egress_shards=1, device="cpu")
    for room in range(rooms):
        rt.set_track(room, 0, published=True, is_video=False)
        rt.set_subscription(room, 0, 1, subscribed=True)
    return rt


def push_audio(rt, rooms, i: int, pkg=PORT) -> None:
    for room in rooms:
        rt.ingest.push(pkg.packet(room=room, track=0, sn=(1000 + i) & 0xFFFF, ts=960 * i,
                                  size=50, payload=b"a"))


def poison(rt, path: str, room: int, value, pkg=PORT) -> None:
    """Overwrite one room's row of a device-state leaf (on a new array)."""
    leaf = rt.state
    for part in path.split("."):
        leaf = getattr(leaf, part)
    if pkg is JAX:
        rt.state = jax_replace_leaf(rt.state, path, leaf.at[room].set(value))
        return
    leaf = leaf.clone()
    leaf[room] = value
    rt.state = _replace_leaf(rt.state, path, leaf)


def spy_restores(rt, pkg) -> list:
    """Record the state leaves right after each full restore of `rt`."""
    seen, real = [], rt.restore

    def restore(snap):
        real(snap)
        seen.append(pkg.leaves(rt.state))

    rt.restore = restore
    return seen


def assert_same_bits(got: list, want: list, where: str) -> None:
    assert len(got) == len(want), where
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), (where, NAMES[i])


async def until(cond, timeout: float = 60.0, msg: str = "condition"):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, f"timed out waiting for {msg}"
        await asyncio.sleep(0.01)


async def _unrepairable(pkg) -> dict:
    rt = make_rt(pkg=pkg)
    mon = pkg.monitor(rt, audit_every_ticks=1, max_row_repairs=2, storm_threshold=4)
    reasons: list[str] = []
    mon.escalate_cb = reasons.append
    mon.snapshot_provider = lambda: None      # no verified checkpoint at all
    rt.integrity = mon
    poison(rt, "bwe_state.ring_pos", 1, 77, pkg)
    egress = []
    for i in range(4):
        push_audio(rt, range(ROOMS), i, pkg)
        res = await rt.step_once()
        egress.append(sorted((p.room, p.sub, p.sn) for p in res.egress))
    return {"repair_failures": mon.repair_failures, "escalations": len(reasons),
            "quarantined": sorted(mon.quarantined), "egress": egress,
            "row_muted": bool(np.asarray(rt._effective_ctrl().sub_muted[1]).all())}


async def test_unrepairable_row_escalates_exactly_once():
    want = await _unrepairable(JAX)
    got = await _unrepairable(PORT)
    assert got == want
    assert got["repair_failures"] >= 1
    assert got["escalations"] == 1             # epoch guard: one escalation
    assert got["quarantined"] == [1] and got["row_muted"]   # muted while suspect
    assert all(1 not in {room for room, _, _ in tick} for tick in got["egress"])


async def _repair_storm(pkg) -> dict:
    """Ticks one at a time until the storm's escalation is requested; then
    the supervisor's watchdog takes the request (no step is in flight,
    so the restart does not race one), restores the checkpoint and
    starts the loop, which runs 5 ticks."""
    rt = make_rt(pkg=pkg)
    for i in range(2):
        push_audio(rt, range(ROOMS), i, pkg)
        await rt.step_once()
    sup = pkg.supervisor(rt, tick_deadline_s=5.0, check_interval_s=0.02,
                         checkpoint_interval_s=60.0, max_restarts=5,
                         backoff=pkg.backoff(base=0.01, max_delay=0.05))
    await sup.checkpoint_now()                # the (clean) restart seed
    seed = [np.asarray(a) for a in sup.last_snapshot["arrays"]]
    mon = pkg.monitor(rt, audit_every_ticks=1, storm_threshold=2)
    mon.snapshot_provider = sup.last_good_snapshot
    mon.escalate_cb = sup.request_restart
    rt.integrity = mon
    restored = spy_restores(rt, pkg)
    for room in range(4):                     # 4 rooms > storm threshold 2
        poison(rt, "bwe_state.ring_pos", room, 77, pkg)
    for i in range(2, 6):
        push_audio(rt, range(ROOMS), i, pkg)
        res = await rt.step_once()
        if sup._requested_restart:
            break
    out = {"escalated_at": res.tick_index, "quarantined_then": sorted(mon.quarantined),
           "egress_then": sorted((p.room, p.sub, p.sn) for p in res.egress)}
    sup.start()
    try:
        await until(lambda: sup.restart_causes.get("integrity", 0) >= 1, msg="restart")
        base = rt.stats["ticks"]
        await until(lambda: rt.stats["ticks"] >= base + 5, msg="post-restart ticks")
        out.update(restart_causes=dict(sup.restart_causes), escalations=mon.escalations,
                   quarantined=sorted(mon.quarantined), gave_up=sup.gave_up,
                   restores=len(restored), tick_after_restore=rt.tick_index > res.tick_index)
    finally:
        await sup.stop()
        await rt.stop()
    # Read the state once the step the stop left running has returned (the
    # JAX package's stop does not wait for it, and its step donates the
    # buffers it read).
    await asyncio.get_running_loop().run_in_executor(rt._executor, lambda: None)
    out["ring_max"] = int(np.asarray(rt.state.bwe_state.ring_pos).max())
    assert_same_bits(restored[0], seed, "the restore against its checkpoint")
    return out, restored[0]


async def test_repair_storm_escalates_to_one_supervisor_restart():
    want, want_state = await _repair_storm(JAX)
    got, got_state = await _repair_storm(PORT)
    assert got == want
    assert got["escalated_at"] == 2 and got["quarantined_then"] == [0, 1, 2, 3]
    assert {room for room, _, _ in got["egress_then"]} == {4, 5}       # muted that tick
    assert got["restart_causes"] == {"stall": 0, "integrity": 1} and got["restores"] == 1
    assert got["escalations"] == 1 and not got["quarantined"] and not got["gave_up"]
    assert got["ring_max"] < bwe.WINDOW                                 # restored clean
    fx.assert_leaves_match(got_state, want_state, NAMES, "the restored plane")


async def _corrupt_checkpoint(pkg) -> dict:
    rt = make_rt(pkg=pkg)
    push_audio(rt, range(ROOMS), 0, pkg)
    await rt.step_once()
    sup = pkg.supervisor(rt, checkpoint_interval_s=60.0, ckpt_generations=3)
    await sup.checkpoint_now()                        # older, clean
    older = sup.last_snapshot
    for i in range(1, 3):
        push_audio(rt, range(ROOMS), i, pkg)
        await rt.step_once()
    await sup.checkpoint_now()                        # newest
    flipped = bytearray(sup._gens[0])
    flipped[pkg.header + 5] ^= 0xFF                   # rot the newest generation
    sup._gens[0] = bytes(flipped)
    out = {"older_tick": older["tick_index"],
           "last_good_tick": sup.last_good_snapshot()["tick_index"],
           "fallbacks_at_read": sup.ckpt_fallbacks}
    restored = spy_restores(rt, pkg)
    out["restored"] = await sup._restore_from_checkpoint()   # walks the same ladder
    out.update(tick_index=rt.tick_index, fallbacks_at_restore=sup.ckpt_fallbacks)
    assert_same_bits(restored[0], [np.asarray(a) for a in older["arrays"]],
                     "the restore against the older generation")
    # The corrupt_ckpt seam damages the encoded frame where bit rot lands.
    rt.fault = pkg.injector(pkg.spec(corrupt_ckpt_every=1))
    await sup.checkpoint_now()
    out.update(ckpt_corrupted=rt.fault.stats.ckpt_corrupted,
               last_good_after_seam=sup.last_good_snapshot()["tick_index"])
    rt.fault = None
    for _ in range(3):
        await sup.checkpoint_now()
    out["generations"] = len(sup._gens)
    return out, restored[0], sup


async def test_corrupt_checkpoint_falls_back_one_generation():
    want, want_state, _ = await _corrupt_checkpoint(JAX)
    got, got_state, sup = await _corrupt_checkpoint(PORT)
    assert got == want
    assert got["last_good_tick"] == got["older_tick"] == got["tick_index"]
    assert got["fallbacks_at_read"] == 1 and got["fallbacks_at_restore"] == 2
    assert got["restored"] and got["ckpt_corrupted"] == 1
    assert got["last_good_after_seam"] == got["older_tick"] and got["generations"] == 3
    fx.assert_leaves_match(got_state, want_state, NAMES, "the older generation restored")
    # The port's checkpoint cost counters (the reference keeps none).
    assert sup.checkpoints == 6 and sup.checkpoint_fetch_s > 0 and sup.checkpoint_encode_s > 0


def _paged_rt():
    rt = PagedPlaneRuntime(paged.PagedDims(**fx.DIMS), tick_ms=10, egress_shards=1,
                           device="cpu", paged_kernel="on")
    for name, tracks, subs in (("a", 1, 2), ("b", 4, 8)):
        s = rt.slots.alloc_room(name)
        for i in range(tracks):
            s.alloc_track(f"t{i}")
        for i in range(subs):
            s.alloc_sub(f"p{i}")
    for room in range(2):
        rt.set_track(room, 0, published=True, is_video=False)
        rt.set_subscription(room, 0, 1, subscribed=True)
    return rt


@pytest.mark.parametrize("kind", ["dense", "paged"])
async def test_step_abandoned_by_a_restart_cannot_reach_restored_state(kind):
    """A device step wedged INSIDE the tick (past the epoch check) when a
    restart bumps the epoch and restores: the restore binds fresh tensors,
    and when the stale step finally runs it writes only the tensors it
    started with and commits nothing."""
    rt = make_rt() if kind == "dense" else _paged_rt()
    for i in range(2):
        push_audio(rt, range(2), i)
        await rt.step_once()
    snap = rt.snapshot()
    gate, entered = threading.Event(), threading.Event()
    real = rt._step

    def wedged(state, wire):
        entered.set()
        assert gate.wait(30)
        return real(state, wire)

    rt._step = wedged
    push_audio(rt, range(2), 2)
    st = rt._stage_host()
    rt._schedule_probe(st)
    rt._upload(st)
    fut = asyncio.get_running_loop().run_in_executor(rt._executor, rt._device_step, st)
    await until(entered.is_set, msg="the step inside the tick")
    old = plane.tree_leaves(rt.state)
    rt.bump_epoch()                            # the supervisor's restart
    rt.restore(snap)
    fresh = plane.tree_leaves(rt.state)
    restored = plane.state_to_numpy(rt.state)
    assert not {x.data_ptr() for x in old} & {x.data_ptr() for x in fresh}
    gate.set()
    assert await fut is None
    assert rt.stats["abandoned_steps"] == 1
    assert rt.stats["dropped_steps"] == 1       # it ran its tick, which never completes
    assert all(a is b for a, b in zip(plane.tree_leaves(rt.state), fresh))
    for a, b in zip(plane.state_to_numpy(rt.state), restored):
        assert a.tobytes() == b.tobytes()
    rt._step = real
    push_audio(rt, range(2), 3)
    res = await rt.step_once()                 # the restored plane ticks on
    assert res.tick_index == snap["tick_index"] and res.fwd_packets > 0


async def test_step_committed_before_a_restart_does_not_audit_the_restored_plane():
    """A step that committed just before a restart's bump and was still
    unpacking its outputs when the bump came: its audit on the cadence
    does not run, so no quarantine from the plane it committed lands on
    the restored one, and its outputs count as a dropped step."""
    rt = make_rt()
    for i in range(2):
        push_audio(rt, range(2), i)
        await rt.step_once()
    snap = rt.snapshot()
    mon = IntegrityMonitor(rt, audit_every_ticks=1, storm_threshold=2)
    escalations: list[str] = []
    mon.escalate_cb = escalations.append
    rt.integrity = mon
    poison(rt, "bwe_state.ring_pos", 0, 77)   # the step's audit would flag room 0
    gate, entered = threading.Event(), threading.Event()
    real = rt._unpack_outputs

    def wedged(buf):
        entered.set()
        assert gate.wait(30)
        return real(buf)

    rt._unpack_outputs = wedged
    push_audio(rt, range(2), 2)
    st = rt._stage_host()
    rt._schedule_probe(st)
    rt._upload(st)
    fut = asyncio.get_running_loop().run_in_executor(rt._executor, rt._device_step, st)
    await until(entered.is_set, msg="the committed step's unpack")
    rt.bump_epoch()                            # the supervisor's restart
    rt.restore(snap)
    restored = plane.tree_leaves(rt.state)
    fut.add_done_callback(rt._count_dropped)   # what the loop's restart path does
    gate.set()
    assert await fut is not None               # it committed before the bump
    await asyncio.sleep(0)
    assert mon.audits == 0 and not mon.quarantined and not escalations
    assert rt.stats["abandoned_steps"] == 0 and rt.stats["dropped_steps"] == 1
    assert all(a is b for a, b in zip(plane.tree_leaves(rt.state), restored))
    rt._unpack_outputs = real
    push_audio(rt, range(2), 3)
    await rt.step_once()                       # the restored plane audits clean
    assert mon.audits == 1 and not mon.quarantined


async def test_supervisor_spares_governed_plane_restarts_wedged_one():
    """A governed plane ticking 2x over its stall deadline is not restarted
    (the governor owns slowness); a wedged plane still is, through the
    widened deadline."""
    rt = make_rt(rooms=2)
    gov = gov_mod.OverloadGovernor(rt, escalate_ticks=10**6, dwell_ticks=10**6)
    rt.governor = gov
    gov._set_level(1, "governed for test")
    inj = FaultInjector(FaultSpec(stall_every=1, stall_s=0.12))
    rt.fault = inj
    sup = PlaneSupervisor(rt, tick_deadline_s=0.05, warmup_deadline_s=10.0,
                          check_interval_s=0.02, checkpoint_interval_s=60.0,
                          max_restarts=5, overload_grace=10.0,
                          backoff=BackoffPolicy(base=0.02, max_delay=0.1))
    await sup.checkpoint_now()
    rt.start()
    sup.start()
    try:
        base = rt.stats["ticks"]
        await until(lambda: rt.stats["ticks"] >= base + 6, msg="governed ticks")
        assert sup.restarts == 0 and not sup.gave_up
        inj.spec.stall_s = 1.5                # a wedge past the widened deadline
        await until(lambda: sup.restarts >= 1, msg="restart")
        rt.fault = None                       # the hang clears
        base = rt.stats["ticks"]
        await until(lambda: rt.stats["ticks"] >= base + 5, msg="post-restart ticks")
        assert sup.restart_causes["stall"] >= 1 and not sup.gave_up
        await until(lambda: rt.stats["abandoned_steps"] >= 1, msg="the wedged step's return")
    finally:
        await sup.stop()
        await rt.stop()


async def test_governor_l4_rejects_joins_and_publishes_over_wire():
    async with running_server(governor=True) as server:
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, server.port)
            await alice.connect("lobby", "alice")
            gov = server.room_manager.governor
            assert gov is not None            # on by default
            gov._set_level(4, "test overload")
            bob = SignalClient(s, server.port)
            bob.ws = await s.ws_connect(
                f"ws://127.0.0.1:{server.port}/rtc?access_token={token('bob', 'lobby')}")
            bob._reader = asyncio.ensure_future(bob._read())
            assert (await bob.wait_for("leave"))["reason"] == 7   # JOIN_FAILURE
            await alice.send_signal("add_track", {"cid": "mic", "type": 0, "name": "mic"})
            rr = await alice.wait_for("request_response")
            assert rr["error"]["reason"] == "node_overloaded" and rr["error"]["cid"] == "mic"
            assert gov.rejected.get("join", 0) >= 1 and gov.rejected.get("publish", 0) >= 1
            async with s.get(f"http://127.0.0.1:{server.port}/debug/overload") as r:
                j = await r.json()
            assert j["governor"]["level"] == 4
            assert j["admission_denied_reasons"].get("overload", 0) >= 2
            gov._set_level(0, "test recovered")
            carol = SignalClient(s, server.port)
            join = await carol.connect("lobby", "carol")
            assert join["participant"]["identity"] == "carol"
            for c in (alice, bob, carol):
                await c.close()


async def test_room_manager_wires_the_failure_and_overload_plane():
    cfg = apply_port_overlay(Config())
    cfg.plane.rooms, cfg.plane.subs_per_room, cfg.egress.shards = 4, 4, 1
    cfg.faults.enabled = True
    rm = RoomManager(cfg, LocalRouter(LocalNode()), LocalStore(), device="cpu")
    rt = rm.runtime
    assert rm.supervisor is not None and rm.governor is not None
    assert rm.integrity is not None and rm.fault is not None
    assert rt.governor is rm.governor and rt.integrity is rm.integrity
    assert rt.fault is rm.fault and rt.ingest.fault is rm.fault
    assert rm.integrity.snapshot_provider == rm.supervisor.last_good_snapshot
    assert rm.integrity.escalate_cb == rm.supervisor.request_restart
    assert rm.supervisor.room_checkpoint_cb is None       # no bus: ROADMAP A13
    assert rm.supervisor.tick_deadline_s == 1.0 and rm.supervisor.warmup_deadline_s == 30.0
    assert rm.integrity.audit_every == 16 and rm.governor.escalate_ticks == 20
    assert set(rm.integrity_stats()) >= {"audits", "restart_causes", "generation_fallbacks"}
    # The defaults without fault injection: the three subsystems on, no injector.
    cfg.faults.enabled = False
    rm2 = RoomManager(cfg, LocalRouter(LocalNode()), LocalStore(), device="cpu")
    assert rm2.fault is None and rm2.runtime.fault is None
    assert all(x is not None for x in (rm2.supervisor, rm2.governor, rm2.integrity))
    rm.start()
    await until(lambda: rm.supervisor._watch_task is not None, msg="supervisor start")
    await rm.checkpoint_rooms()               # single node: nothing to publish
    await rm.stop()
    assert rm.supervisor._watch_task is None and rm.supervisor._ckpt_task is None
