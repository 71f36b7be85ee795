"""The port's PagedPlaneRuntime (device="cpu") against the JAX package's
PagedPlaneRuntime, on the mixed-size room fixture of
tests/test_paged_kernel.py, through a grow-on-join across a page boundary
at tick 3 and a release plus compaction (pages move) at tick 5.

Both runtimes speak logical [R, T, S] shapes on the host, so their
logical TickOutputs are compared on every tick, and their logical state
at the end: integers and bools equal, floats within
`plane.float_tolerance` (reasons in tests/test_torch_plane.py). The
egress columns of the host munger must be equal.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch_paged_fixture as fx  # noqa: E402

from livekit_server_tpu.models import paged as jpaged  # noqa: E402
from livekit_server_tpu.runtime.ingest import PacketIn as JaxPacket  # noqa: E402
from livekit_server_tpu.runtime.paged_runtime import PagedPlaneRuntime as JaxRuntime  # noqa: E402
from livekit_server_tpu_torch.models import paged, plane  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime  # noqa: E402

PD = paged.PagedDims(**fx.DIMS)
ROOMS = [("a", 1, 2), ("b", 4, 8), ("c", 2, 5)]
COLUMNS = ("rooms", "tracks", "ks", "subs", "sn", "ts", "pid", "tl0", "keyidx")


def _setup_rooms(rt):
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


def _push(rt, packet_cls, tick):
    for room, track, base in [(0, 0, 100), (1, 0, 500), (1, 3, 900), (2, 1, 1300)]:
        for j in range(2):
            sn = base + tick * 2 + j
            rt.ingest.push(packet_cls(
                room=room, track=track, sn=sn & 0xFFFF,
                ts=(960 * (tick * 2 + j)) & 0xFFFFFFFF,
                size=120, payload=b"x" * 120,
                keyframe=(tick == 0 and j == 0),
                audio_level=-(30 + (sn % 20)),
            ))


def _capture(rt, log):
    orig = rt._unpack_outputs

    def wrapped(buf):
        out = orig(buf)
        log.append(out)
        return out

    rt._unpack_outputs = wrapped


def _port(**kw):
    return PagedPlaneRuntime(PD, tick_ms=10, egress_shards=1, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["on", "off"])
async def test_runtime_matches_reference(mode):
    ref = JaxRuntime(jpaged.PagedDims(**fx.DIMS), tick_ms=10, paged_kernel=mode)
    port = _port(paged_kernel=mode)
    want, got = [], []
    _capture(ref, want)
    _capture(port, got)
    try:
        handles = (_setup_rooms(ref), _setup_rooms(port))
        for t in range(8):
            res = []
            for rt, packet_cls in ((ref, JaxPacket), (port, PacketIn)):
                _push(rt, packet_cls, t)
                res.append(await rt.step_once())
            fx.assert_leaves_match(list(got[-1]), list(want[-1]),
                                   plane.TickOutputs._fields, t)
            for col in COLUMNS:
                assert np.array_equal(getattr(res[1].egress_batch, col),
                                      np.asarray(getattr(res[0].egress_batch, col))), (t, col)
            if t == 3:      # grow room "a" across its spage=4 boundary
                for rt, hs in zip((ref, port), handles):
                    for i in range(2, 6):
                        hs["a"].alloc_sub(f"p{i}")
                    rt.set_subscription(0, 0, 5, subscribed=True)
            if t == 5:      # free room "c", compact: pages of "b" relocate
                for rt in (ref, port):
                    rt.slots.release_room("c")
                    assert rt.compact() > 0
        ref_state = ref._to_logical_state()
        port_state = port._to_logical_state()
        fx.assert_leaves_match(plane.tree_leaves(port_state), jax.tree.leaves(ref_state),
                               plane.leaf_names(port_state), "final state")
        for a, b in zip(port._sel_mirror(port.state), ref._sel_mirror(ref.state)):
            assert np.array_equal(a, b)
        assert port.stats["paged_kernel_steps"] == ref.stats["paged_kernel_steps"]
        assert port.stats["paged_kernel_ticks"] == (8 if mode == "on" else 0)
        assert port.stats["page_moves"] > 0 and port.stats["pages_reinit"] > 0
    finally:
        await ref.stop()


async def test_grid_steps_track_live_pages():
    """Scheduled work follows live pages: with one-page rooms, halving
    the room count halves the kernel's blocks per tick at a FIXED pool."""
    dims = paged.PagedDims(rooms=8, tracks=2, pkts=2, subs=4, tpage=2, spage=4, pool_pages=8)

    async def run(n_rooms):
        rt = PagedPlaneRuntime(dims, tick_ms=10, paged_kernel="on", egress_shards=1, device="cpu")
        for r in range(n_rooms):
            s = rt.slots.alloc_room(f"r{r}")
            s.alloc_track("t0")
            s.alloc_sub("p0")
            rt.set_track(r, 0, published=True, is_video=False)
            rt.set_subscription(r, 0, 0, subscribed=True)
        for t in range(3):
            for r in range(n_rooms):
                rt.ingest.push(PacketIn(room=r, track=0, sn=100 + t, ts=960 * t, size=50,
                                        payload=b"a"))
            await rt.step_once()
        return rt.stats["paged_kernel_steps"], rt.stats["paged_kernel_ticks"]

    steps4, ticks4 = await run(4)
    steps2, ticks2 = await run(2)
    assert ticks4 == ticks2 == 3
    assert steps4 == 2 * steps2 > 0


async def test_zero_live_pages_tick():
    """No live page: nothing to launch, state untouched, the dead-page
    outputs on every row, zero kernel steps recorded."""
    rt = _port(paged_kernel="on")
    before = [x.clone() for x in plane.tree_leaves(rt.state)]
    res = await rt.step_once()
    assert res.fwd_packets == 0
    assert all(torch.equal(a, b) for a, b in zip(before, plane.tree_leaves(rt.state)))
    assert rt.stats["paged_kernel_steps"] == 0
    assert rt.stats["paged_kernel_ticks"] == 1
    assert rt.recent_ticks[-1]["paged_kernel_ms"] == 0.0
    assert rt.pager_stats()["page_live_fraction"] == 0.0


def test_constructor_validation(monkeypatch):
    """"interpret" has no meaning in the port; the layout must be paged;
    like every entry point it needs a card unless asked for the CPU."""
    with pytest.raises(ValueError, match=r"auto\|on\|off"):
        _port(paged_kernel="interpret")
    with pytest.raises(ValueError, match="paged_kernel"):
        _port(paged_kernel="bogus")
    with pytest.raises(TypeError, match="PagedDims"):
        PagedPlaneRuntime(PD.logical, egress_shards=1, device="cpu")
    assert _port(paged_kernel=True).pager_stats()["paged_kernel"] == "on"
    assert _port(paged_kernel="auto").pager_stats()["paged_kernel"] == "auto"
    assert _port(paged_kernel=False).pager_stats()["paged_kernel"] == "off"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedPlaneRuntime(PD)


async def test_occupancy_and_recent_ticks_match_reference():
    """Admission through the page pool (occupancy, pager stats) matches
    the reference, and each tick's record carries the kernel span and the
    live-page fraction."""
    ref = JaxRuntime(jpaged.PagedDims(**fx.DIMS), tick_ms=10, paged_kernel="on")
    port = _port(paged_kernel="on")
    try:
        _setup_rooms(ref)
        _setup_rooms(port)
        assert port.slots.occupancy() == ref.slots.occupancy()
        for rt, packet_cls in ((ref, JaxPacket), (port, PacketIn)):
            _push(rt, packet_cls, 0)
            await rt.step_once()
        want = ref.pager_stats()
        got = port.pager_stats()
        assert got == want
        rec = port.recent_ticks[-1]
        assert rec["paged_kernel_ms"] >= 0.0
        assert rec["page_live_fraction"] == ref.recent_ticks[-1]["page_live_fraction"] > 0.0
    finally:
        await ref.stop()
