"""The port's build ledger (runtime/compile_ledger.py, /debug/compiles).

Its three kinds of entry: a g++ build of a native library (a cache hit
is none), an nvcc build, and the first launch of a hand kernel at a new
launch shape. On the CPU no kernel launches, so the `shapes` fixture
records a launch shape at each wrapper's plain route — the point where
the CUDA path records it — and the counterparts of the reference's
post-warm-up drills (tests/test_pager.py:457 and :494, test_overload.py
:270, test_express.py:171, test_migration.py:146) then hold
`compile_ledger.post_warmup` to 0 on the port's runtimes.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers.
torch.set_num_threads(1)

from livekit_server_tpu_torch import native  # noqa: E402
from livekit_server_tpu_torch.models import paged, plane  # noqa: E402
from livekit_server_tpu_torch.ops import allocation, cuda, paged_kernel, selector  # noqa: E402
from livekit_server_tpu_torch.routing import MemoryBus  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime, governor  # noqa: E402
from livekit_server_tpu_torch.runtime.compile_ledger import LEDGER, CompileLedger  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime  # noqa: E402
from tests.torch_cluster_fixture import pump_until, start_node, stop_all  # noqa: E402

PD = paged.PagedDims(rooms=4, tracks=4, pkts=4, subs=8, tpage=2, spage=4, pool_pages=16)
DIMS = plane.PlaneDims(rooms=2, tracks=2, pkts=4, subs=4)


@pytest.fixture
def shapes(monkeypatch):
    """A fresh ledger, and a launch shape recorded wherever a wrapper
    takes its plain route (its CUDA route records it at the launch)."""
    LEDGER.reset()

    def recorded(mod, fn_name, kernel, shape_of):
        plain = getattr(mod, fn_name)

        def wrapper(*a, **kw):
            LEDGER.record_launch(kernel, shape_of(*a, **kw))
            return plain(*a, **kw)

        monkeypatch.setattr(mod, fn_name, wrapper)

    recorded(selector, "decide_rooms_plain", "decide_rooms",
             lambda st, *a, **kw: (*a[2].shape, st.current_spatial.shape[-1]))
    recorded(allocation, "allocate_budget_rooms_plain", "allocate_budget_rooms",
             lambda br, *a, **kw: (br.shape[0], br.shape[1], a[-1].shape[-1]))
    recorded(paged_kernel, "decide_pages_plain", "paged_kernel",
             lambda sel, svc, vid, base, inp, rows, **kw: (
                 rows.shape[0], *base.shape[:2], inp.layer.shape[2], base.shape[2],
                 0, True, False))
    yield LEDGER
    LEDGER.reset()


def test_gpp_build_counts_once_and_a_cache_hit_does_not(tmp_path, monkeypatch):
    ledger = CompileLedger()
    monkeypatch.setattr("livekit_server_tpu_torch.runtime.compile_ledger.LEDGER", ledger)
    monkeypatch.setattr(native, "_BUILD", tmp_path)
    monkeypatch.setattr(native, "build_log", {})     # native.status() reads the real one
    so = native._compile("munge", "munge-ledger-test")
    assert so is not None and so.parent == tmp_path
    assert ledger.by_kind["g++"] == 1 and ledger.total == 1
    assert ledger.ms_by_kind["g++"] > 0.0
    kind, what, ms = ledger.recent[-1]
    assert kind == "g++" and what == so.name and ms > 0.0
    assert native._compile("munge", "munge-ledger-test") == so   # the cached .so
    assert ledger.total == 1


def test_new_launch_shape_counts_once(monkeypatch):
    ledger = CompileLedger()
    monkeypatch.setattr("livekit_server_tpu_torch.runtime.compile_ledger.LEDGER", ledger)
    monkeypatch.setitem(cuda.launches, "decide_rooms", 0)
    for _ in range(3):
        cuda.count_launch("decide_rooms", (64, 16, 16, 32))
    assert cuda.launches["decide_rooms"] == 3
    assert ledger.by_kind["launch_shape"] == 1
    cuda.count_launch("decide_rooms", (128, 16, 16, 32))
    assert ledger.by_kind["launch_shape"] == 2
    assert ledger.recent[-1][:2] == ("launch_shape", "decide_rooms[128, 16, 16, 32]")
    assert ledger.record_launch("allocate_budget_rooms", (64, 16, 32))
    assert not ledger.record_launch("allocate_budget_rooms", (64, 16, 32))


def test_mark_warm_moves_the_watermark():
    ledger = CompileLedger()
    ledger.record("nvcc", "libdecide_rooms.so", 1500.0)
    assert ledger.post_warmup == 1 and ledger.warmup_ms == 1500.0
    assert ledger.mark_warm() == 1
    assert ledger.post_warmup == 0
    ledger.record("g++", "libegress.so", 200.0)
    ledger.record_launch("paged_kernel", (8, 16, 2, 4, 4, 0, 1, 0))
    assert ledger.post_warmup == 2
    assert ledger.warmup_ms == 1500.0
    assert [e[0] for e in ledger.since(1)] == ["g++", "launch_shape"]
    ledger.mark_warm()
    assert ledger.post_warmup == 0 and ledger.since(ledger.total) == []
    with pytest.raises(ValueError):
        ledger.record("xla", "x")


def test_snapshot_keys_and_the_runtime_ledger():
    ledger = CompileLedger()
    ledger.record("nvcc", "a.so", 10.0)
    ledger.record_launch("decide_rooms", (1, 2, 3, 4))
    snap = ledger.snapshot()
    assert set(snap) == {"builds_total", "builds_post_warmup", "build_ms",
                         "warmup_build_ms", "by_kind", "ms_by_kind",
                         "launch_shapes", "recent"}
    assert snap["by_kind"] == {"nvcc": 1, "g++": 0, "launch_shape": 1}
    assert snap["builds_total"] == 2 and snap["launch_shapes"] == 1
    assert snap["recent"][0] == ["nvcc", "a.so", 10.0]
    ledger.reset()
    assert ledger.snapshot()["builds_total"] == 0
    rt = PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu")
    assert rt.compile_ledger is LEDGER
    rt.mark_warm()
    assert rt.post_warm_builds == 0 and rt.compile_ledger.post_warmup == 0


def _push(rt, tick: int) -> None:
    for room, track, base in [(0, 0, 100), (1, 0, 500), (1, 3, 900), (2, 1, 1300)]:
        for j in range(2):
            sn = base + tick * 2 + j
            rt.ingest.push(PacketIn(room=room, track=track, sn=sn & 0xFFFF,
                                    ts=(960 * (tick * 2 + j)) & 0xFFFFFFFF, size=120,
                                    payload=b"x" * 120, keyframe=(tick == 0 and j == 0),
                                    audio_level=-(30 + (sn % 20))))


async def test_grow_on_join_holds_the_launch_shapes(shapes):
    """A join past the room's sub extent grows its page grid; the first
    tick on the grown extent may launch at a new pow2 bucket, and after
    that the steady state adds no ledger entry."""
    prt = PagedPlaneRuntime(PD, tick_ms=10, device="cpu", egress_shards=1)
    s = prt.slots.alloc_room("g")
    s.alloc_track("t0")
    for i in range(3):
        s.alloc_sub(f"p{i}")
    prt.set_track(0, 0, published=True, is_video=False)
    prt.set_subscription(0, 0, 0, subscribed=True)

    async def tick(t):
        for j in range(2):
            prt.ingest.push(PacketIn(room=0, track=0, sn=100 + t * 2 + j,
                                     ts=960 * (t * 2 + j), size=90, payload=b"y" * 90,
                                     audio_level=-25))
        return await prt.step_once()

    for t in range(4):
        await tick(t)
    assert prt.pager.extent(0) == (2, 4)
    for i in range(3, 7):
        s.alloc_sub(f"p{i}")                    # crosses spage=4
    assert prt.pager.extent(0) == (2, 8)
    prt.set_subscription(0, 0, 6, subscribed=True)
    fwd = (await tick(4)).fwd_packets
    assert shapes.by_kind["launch_shape"] > 0
    prt.mark_warm()
    for t in range(5, 8):
        fwd += (await tick(t)).fwd_packets
    assert prt.compile_ledger.post_warmup == 0 and prt.post_warm_builds == 0
    assert fwd > 0 and prt.pager.stats()["grows"] == 1


async def test_compaction_holds_the_launch_shapes(shapes):
    prt = PagedPlaneRuntime(PD, tick_ms=10, device="cpu", egress_shards=1)
    for name, tr, sb in [("a", 1, 2), ("b", 4, 8), ("c", 2, 5)]:
        s = prt.slots.alloc_room(name)
        for i in range(tr):
            s.alloc_track(f"t{i}")
        for i in range(sb):
            s.alloc_sub(f"p{i}")
    prt.set_track(1, 0, published=True, is_video=True)
    prt.set_track(1, 3, published=True, is_video=False)
    for sub in range(8):
        prt.set_subscription(1, 0, sub, subscribed=True)
    prt.set_subscription(1, 3, 2, subscribed=True)
    for t in range(5):
        _push(prt, t)
        await prt.step_once()
    prt.slots.release_room("a")
    prt.slots.release_room("c")
    assert prt.compact() > 0
    _push(prt, 5)
    assert (await prt.step_once()).fwd_packets > 0
    prt.mark_warm()
    for t in range(6, 9):
        _push(prt, t)
        await prt.step_once()
    assert prt.compile_ledger.post_warmup == 0


async def test_governor_shed_up_and_down_holds_the_launch_shapes(shapes):
    rt = PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu")
    rt.set_track(0, 0, published=True, is_video=True)
    rt.set_track(0, 1, published=True, is_video=False)
    for sub in range(DIMS.subs):
        rt.set_subscription(0, 0, sub, subscribed=True)
        rt.set_subscription(0, 1, sub, subscribed=True)
    gov = governor.OverloadGovernor(rt, escalate_ticks=2, dwell_ticks=2)
    await rt.step_once()
    rt.mark_warm()
    levels = []
    for rec in [{"total_ms": 20.0, "late": True}] * 10 + [{"total_ms": 1.0, "late": False}] * 12:
        rt.ingest.push(PacketIn(room=0, track=1, sn=100 + len(levels), ts=0, size=20,
                                payload=b"a"))
        gov.on_tick(dict(rec))
        levels.append(gov.level)
        await rt.step_once()
    assert max(levels) >= 3 and levels[-1] == governor.L_HEALTHY
    assert rt.compile_ledger.post_warmup == 0


async def test_express_retier_holds_the_launch_shapes(shapes):
    rt = PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu", express_max_subs=2)
    rt.set_track(0, 0, published=True, is_video=False)
    for s in (1, 2):
        rt.set_subscription(0, 0, s, subscribed=True)
    rt.express.sender = len
    sn = 100

    async def windows(n):
        nonlocal sn
        for _ in range(n):
            rt.ingest.push(PacketIn(room=0, track=0, sn=sn, ts=0, size=1, payload=b"x"))
            await rt.step_once()
            sn += 1

    await windows(2)                      # batched; the 2nd boundary promotes
    assert rt.express.active[0]
    rt.mark_warm()
    await windows(3)
    rt.set_shed(pause_video=True)
    await windows(2)
    rt.set_shed(pause_video=False)
    rt.set_express_pin(0, False)          # back to batched
    await windows(2)
    assert not rt.express.active[0]
    assert rt.compile_ledger.post_warmup == 0


async def test_migration_target_holds_the_launch_shapes(shapes):
    bus = MemoryBus()
    a = b = None
    try:
        a = await start_node(bus)
        b = await start_node(bus)
        rm_a, rm_b = a.room_manager, b.room_manager
        rt_a, rt_b = rm_a.runtime, rm_b.runtime
        row_a = (await rm_a.get_or_create_room("mig")).slots.row
        rt_a.set_track(row_a, 0, published=True, is_video=False)
        rt_a.set_subscription(row_a, 0, 1, subscribed=True)
        for i in range(3):
            rt_a.ingest.push(PacketIn(room=row_a, track=0, sn=100 + i, ts=0, size=10,
                                      payload=b"x"))
        await pump_until(rt_a, row_a, 102)
        # sub masks do not travel (clients rejoin): re-subscribe on adopt
        rm_b.migration.on_adopt.append(
            lambda r: rt_b.set_subscription(r.slots.row, 0, 1, subscribed=True))
        assert await rm_a.migrate_room("mig")
        row_b = rm_b.rooms["mig"].slots.row
        rt_b.mark_warm()
        for i in range(3, 6):
            rt_b.ingest.push(PacketIn(room=row_b, track=0, sn=100 + i, ts=0, size=10,
                                      payload=b"s"))
        await pump_until(rt_b, row_b, 105)
        assert rt_b.compile_ledger.post_warmup == 0
        assert shapes.by_kind["launch_shape"] > 0
    finally:
        await stop_all(a, b)
