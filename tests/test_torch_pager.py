"""The port's RoomPager and paged slot allocator (host code, copied into
livekit_server_tpu_torch.runtime) against the JAX package's, driven
through the same seeded event sequences: page tables, drained PageDeltas,
epochs, statistics and capacity errors must be equal."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from livekit_server_tpu.runtime import pager as jpager, slots as jslots  # noqa: E402
from livekit_server_tpu_torch.runtime import pager as tpager, slots as tslots  # noqa: E402

GEOM = dict(rooms=12, tracks=16, subs=32, tpage=4, spage=8, pool_pages=64)
TABLES = ("pg_room", "pg_tp", "pg_sp", "tmembers", "rooms_pages")


def _pair(**geom):
    geom = {**GEOM, **geom}
    return tpager.RoomPager(**geom), jpager.RoomPager(**geom)


def _assert_same(port, ref, where):
    for name in TABLES:
        assert np.array_equal(getattr(port, name), getattr(ref, name)), (where, name)
    assert port.epoch == ref.epoch, where
    assert port.stats() == ref.stats(), where


def _apply(pager, event):
    kind, row, tracks, subs = event
    if kind == "alloc":
        return pager.alloc_room(row, tracks=tracks, subs=subs)
    if kind == "grow":
        return pager.grow_room(row, tracks=tracks, subs=subs)
    if kind == "release":
        return pager.release_room(row)
    return pager.compact()


def _events(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        u = rng.random()
        row = int(rng.integers(0, GEOM["rooms"]))
        size = int(rng.choice([2, 3, 5, 9, 16, 30]))
        if u < 0.45:
            out.append(("alloc", row, min(size, 16), size))
        elif u < 0.7:
            out.append(("grow", row, min(size + 4, 16), size + 6))
        elif u < 0.92:
            out.append(("release", row, 0, 0))
        else:
            out.append(("compact", 0, 0, 0))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_sequence_matches_reference(seed):
    """Alloc, grow across page boundaries, release and compact: after
    every event the tables, epoch and stats are equal, and every few
    events the drained deltas (rooms, fresh/freed pages, moves) too."""
    port, ref = _pair()
    for i, event in enumerate(_events(seed)):
        if event[0] == "grow" and event[1] not in ref._rooms:
            continue
        outcomes = []
        for pager, err in ((port, tslots.CapacityError), (ref, jslots.CapacityError)):
            try:
                outcomes.append(("ok", _apply(pager, event)))
            except err as e:
                outcomes.append(("capacity", str(e)))
        assert outcomes[0] == outcomes[1], (i, event)
        _assert_same(port, ref, (i, event))
        if i % 3 == 2:
            for a, b in zip(port.drain_delta(), ref.drain_delta()):
                assert np.array_equal(a, b), (i, event)
        for row in range(GEOM["rooms"]):
            assert np.array_equal(port.pages_of_room(row), ref.pages_of_room(row))


def test_capacity_error_leaves_no_partial_allocation():
    """A request the pool cannot hold raises the port's own CapacityError
    and leaves the tables as they were, as in the reference."""
    port, ref = _pair(pool_pages=16)
    for pager in (port, ref):
        pager.alloc_room(0, tracks=16, subs=16)     # 4x2 grid → 8 pages
        pager.alloc_room(1, tracks=8, subs=16)      # 2x2 → 4 pages
    before = [getattr(port, n).copy() for n in TABLES]
    with pytest.raises(tslots.CapacityError, match="exhausted"):
        port.alloc_room(2, tracks=16, subs=16)
    with pytest.raises(jslots.CapacityError, match="exhausted"):
        ref.alloc_room(2, tracks=16, subs=16)
    for name, b in zip(TABLES, before):
        assert np.array_equal(getattr(port, name), b)
    with pytest.raises(tslots.CapacityError, match="max extent"):
        port.grow_room(1, subs=40)
    _assert_same(port, ref, "after failures")
    assert port.alloc_failures == ref.alloc_failures == 1
    assert not issubclass(tslots.CapacityError, jslots.CapacityError)


def test_geometry_validation():
    for bad in (dict(tpage=3), dict(spage=6), dict(spage=64, subs=64), dict(pool_pages=48)):
        with pytest.raises(ValueError):
            tpager.RoomPager(**{**GEOM, **bad})
        with pytest.raises(ValueError):
            jpager.RoomPager(**{**GEOM, **bad})


def test_epoch_guards_stale_page_indices():
    port, _ = _pair()
    port.alloc_room(3, tracks=2, subs=2)
    epoch = port.epoch
    port.check_epoch(epoch)
    port.grow_room(3, subs=12)
    with pytest.raises(tpager.StalePageError, match="epoch"):
        port.check_epoch(epoch)
    assert port.extent(3) == tpager.RoomExtent(tracks=4, subs=16)
    assert port.room_of_page(int(port.pages_of_room(3)[0])) == 3


def test_compaction_moves_and_deltas_match_reference():
    """Fragment the pool, compact: the (src, dst) moves, the freed pages
    that must re-initialize and the fragmentation stats equal the
    reference's."""
    port, ref = _pair()
    for pager in (port, ref):
        for row, (t, s) in enumerate([(4, 8), (8, 16), (4, 8), (16, 32), (4, 24)]):
            pager.alloc_room(row, tracks=t, subs=s)
        pager.drain_delta()
        pager.release_room(1)
        pager.release_room(3)
    assert port.stats()["fragmentation_ratio"] == ref.stats()["fragmentation_ratio"]
    moves = port.compact()
    assert moves == ref.compact() and len(moves) > 0
    for a, b in zip(port.drain_delta(), ref.drain_delta()):
        assert np.array_equal(a, b)
    _assert_same(port, ref, "compacted")


def test_paged_slot_allocator_matches_reference():
    """Rooms claim page grids through the slot facade; joins and publishes
    that cross a page boundary grow the grid; occupancy and admission
    headroom follow the pager, as in the reference."""
    allocs = []
    for pager_mod, slots_mod in ((tpager, tslots), (jpager, jslots)):
        pager = pager_mod.RoomPager(**GEOM)
        allocs.append((pager, slots_mod.PagedSlotAllocator(pager)))
    for (pager, slots) in allocs:
        a = slots.alloc_room("a")
        for i in range(10):
            a.alloc_sub(f"p{i}")          # 8 → 16 columns: one grow
        for i in range(5):
            a.alloc_track(f"t{i}")        # 4 → 8 tracks: one grow
        b = slots.alloc_room("b")
        b.alloc_sub("x")
        a.release_sub("p3")
        assert a.alloc_sub("p10") == 3    # a released column is reused
        slots.release_room("b")
    (tp, ts), (jp, js) = allocs
    assert ts.occupancy() == js.occupancy()
    assert ts.get("a").occupancy() == js.get("a").occupancy()
    assert ts.get("a").occupancy()["subs_capacity"] == 16
    _assert_same(tp, jp, "slots")
