"""RoomPager: pooled-HBM page allocation for ragged room state.

The dense plane charges every room the configured worst case — a
2-person room pays the same [T, K, S] HBM slab and kernel work as the
50-sub north star. This module is
the host half of the paged layout that fixes it (the device half is
models/paged.py): one pooled buffer of P fixed-shape PAGES, each
covering a (tpage × spage) block of one room's (track, subscriber)
plane, and a device-resident page table the tick kernels indirect
through. The layout borrows the pooled-page discipline of ragged paged
attention (PAPERS.md): fixed-size pages in one big buffer + an indirection
table beats per-room allocations because the kernels stay static-shaped
and the allocator is O(1) per event.

A room's footprint is a PAGE GRID: ceil(tracks / tpage) × ceil(subs /
spage) pages, so a 2-person room holds one page while the 50-sub room
holds its full grid — rooms/chip scales with the *actual* size
distribution instead of the padded worst case. Page (room, tp, sp)
covers logical tracks [tp·TP, (tp+1)·TP) × subs [sp·SP, (sp+1)·SP), in
order — the logical→page translation is pure index arithmetic, which
keeps checkpoints layout-independent (they serialize LOGICAL rows).

Allocation is a buddy allocator over page indices: free lists per pow2
size class, each grid request rounded up to a pow2 run (the slack is
reported as internal fragmentation), splits on alloc, buddy-coalesce on
free. `compact()` relocates every live run to the bottom of the pool —
the host side of defragmentation; the runtime turns the returned moves
into device row copies plus a page-table delta.

Concurrency/staleness contract: every structural change bumps `epoch`.
A page index is only valid under the epoch it was read at — any code
that holds one across an await or lock release must re-validate with
`check_epoch` (or re-fetch through `pages_of_room`) before using it to
index device state.

A copy of the JAX package's runtime/pager.py: pure host bookkeeping
(numpy tables only); the device-facing arrays are plain buffers for the
runtime's delta uploads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from livekit_server_tpu_torch.runtime.slots import CapacityError


class StalePageError(RuntimeError):
    """A page index minted under an older pager epoch was used after the
    table changed (re-validate across awaits/lock releases)."""


class RoomExtent(NamedTuple):
    """A room's currently-allocated logical coverage (page-granular)."""

    tracks: int
    subs: int


class PageDelta(NamedTuple):
    """One drain of pending page-table events for the device upload lane
    (the page analog of the dirty-row ctrl delta)."""

    rooms: np.ndarray        # [n] int32 — rooms whose table row changed
    fresh_pages: np.ndarray  # [m] int32 — newly mapped pages (state init)
    freed_pages: np.ndarray  # [f] int32 — unmapped pages (state re-init)
    moves: np.ndarray        # [k, 2] int32 — compaction (src, dst) rows

    @property
    def empty(self) -> bool:
        return (
            len(self.rooms) == 0
            and len(self.fresh_pages) == 0
            and len(self.freed_pages) == 0
            and len(self.moves) == 0
        )


class _Room:
    __slots__ = ("grid", "mt", "ms", "runs")

    def __init__(self, max_tp: int, max_sp: int):
        self.grid = np.full((max_tp, max_sp), -1, np.int32)
        self.mt = 0
        self.ms = 0
        self.runs: list[tuple[int, int]] = []  # (start, order)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


class RoomPager:
    """Host-side page-pool allocator + the canonical page-table mirrors.

    The numpy tables here (`pg_room`/`pg_tp`/`pg_sp`, `tmembers`,
    `rooms_pages`) are the authoritative page table; the runtime uploads
    dirty slices to their device copies at tick edges via drain_delta —
    the same mirror-then-delta protocol as the ctrl tensors.
    """

    def __init__(
        self,
        rooms: int,
        tracks: int,
        subs: int,
        *,
        tpage: int,
        spage: int,
        pool_pages: int,
    ):
        if not _is_pow2(tpage) or tracks % tpage:
            raise ValueError(
                f"tpage must be a pow2 divisor of tracks ({tpage} vs {tracks})"
            )
        if not _is_pow2(spage) or subs % spage:
            raise ValueError(
                f"spage must be a pow2 divisor of subs ({spage} vs {subs})"
            )
        if spage > 32 or 32 % spage:
            raise ValueError(
                f"spage must divide the 32-bit mask word (got {spage})"
            )
        if not _is_pow2(pool_pages):
            raise ValueError(f"pool_pages must be pow2 (got {pool_pages})")
        self.num_rooms = rooms
        self.tracks = tracks
        self.subs = subs
        self.tpage = tpage
        self.spage = spage
        self.pool_pages = pool_pages
        self.max_tpages = tracks // tpage
        self.max_spages = subs // spage
        self.min_room_pages = 1  # a minimal room is one (tpage × spage) page

        # Device-table host mirrors. tmembers[p] lists the page ids of
        # p's room sharing p's sub column across track pages — the only
        # cross-page coupling the device tick gathers through (per-sub
        # send sums + the cross-track allocation).
        self.pg_room = np.full(pool_pages, -1, np.int32)
        self.pg_tp = np.full(pool_pages, -1, np.int32)
        self.pg_sp = np.full(pool_pages, -1, np.int32)
        self.tmembers = np.full((pool_pages, self.max_tpages), -1, np.int32)
        self.rooms_pages = np.full(
            (rooms, self.max_tpages * self.max_spages), -1, np.int32
        )

        # Buddy free lists: order → set of aligned run starts.
        self._max_order = pool_pages.bit_length() - 1
        self._free: dict[int, set[int]] = {self._max_order: {0}}
        self._rooms: dict[int, _Room] = {}

        self.epoch = 0
        self._dirty_rooms: set[int] = set()
        self._fresh: set[int] = set()
        self._freed: set[int] = set()
        self._moves: list[tuple[int, int]] = []

        self.allocs = 0
        self.frees = 0
        self.grows = 0
        self.compactions = 0
        self.alloc_failures = 0
        self.peak_reserved = 0

    # -- buddy core -------------------------------------------------------

    def _alloc_run(self, order: int) -> int:
        for o in range(order, self._max_order + 1):
            runs = self._free.get(o)
            if runs:
                start = min(runs)  # lowest address: deterministic + compact
                runs.remove(start)
                while o > order:
                    o -= 1
                    self._free.setdefault(o, set()).add(start + (1 << o))
                return start
        self.alloc_failures += 1
        raise CapacityError(
            f"page pool exhausted: no free run of {1 << order} pages "
            f"({self.pages_free} pages free but fragmented)"
            if self.pages_free >= (1 << order)
            else f"page pool exhausted: need {1 << order} pages, "
            f"{self.pages_free} free"
        )

    def _free_run(self, start: int, order: int) -> None:
        while order < self._max_order:
            buddy = start ^ (1 << order)
            peers = self._free.get(order)
            if peers and buddy in peers:
                peers.remove(buddy)
                start = min(start, buddy)
                order += 1
            else:
                break
        self._free.setdefault(order, set()).add(start)

    @staticmethod
    def _order_for(n_pages: int) -> int:
        return max(0, (n_pages - 1).bit_length())

    # -- room lifecycle ---------------------------------------------------

    def _map_cells(self, row: int, room: _Room, cells: list[tuple[int, int]]) -> None:
        """Allocate one pow2 run covering `cells` grid slots and map them."""
        order = self._order_for(len(cells))
        start = self._alloc_run(order)
        room.runs.append((start, order))
        for i, (ti, si) in enumerate(cells):
            p = start + i
            room.grid[ti, si] = p
            self.pg_room[p] = row
            self.pg_tp[p] = ti
            self.pg_sp[p] = si
            self._fresh.add(p)
            self._freed.discard(p)

    def _refresh_tables(self, row: int) -> None:
        """Recompute the room's page-table mirrors after a grid change.
        tmembers of EVERY page in the room can change when mt grows (a
        new track page joins each sub column), so the whole room's pages
        refresh — still O(room pages), never O(pool)."""
        room = self._rooms[row]
        self.rooms_pages[row] = room.grid.reshape(-1)
        pages = room.grid[room.grid >= 0]
        col = np.full(self.max_tpages, -1, np.int32)
        for p in pages:
            col[: room.mt] = room.grid[: room.mt, self.pg_sp[p]]
            col[room.mt:] = -1
            self.tmembers[p] = col
        self._dirty_rooms.add(row)
        self.epoch += 1

    def alloc_room(self, row: int, tracks: int = 1, subs: int = 1) -> RoomExtent:
        """Claim a page grid covering at least (tracks, subs); a minimal
        room is one page. Raises CapacityError on pool exhaustion (the
        admission-denial surface) and leaves no partial allocation."""
        if row in self._rooms:
            return self.extent(row)
        if not (0 <= row < self.num_rooms):
            raise ValueError(f"room row {row} out of range")
        mt = max(1, -(-tracks // self.tpage))
        ms = max(1, -(-subs // self.spage))
        if mt > self.max_tpages or ms > self.max_spages:
            raise CapacityError(
                f"room exceeds max extent: {tracks}t/{subs}s vs "
                f"{self.tracks}t/{self.subs}s"
            )
        room = _Room(self.max_tpages, self.max_spages)
        cells = [(ti, si) for ti in range(mt) for si in range(ms)]
        try:
            self._map_cells(row, room, cells)
        except CapacityError:
            self._rollback(room)
            raise
        room.mt, room.ms = mt, ms
        self._rooms[row] = room
        self.allocs += 1
        self.peak_reserved = max(self.peak_reserved, self.pages_reserved)
        self._refresh_tables(row)
        return self.extent(row)

    def grow_room(
        self, row: int, tracks: int | None = None, subs: int | None = None
    ) -> RoomExtent:
        """Widen a room's grid to cover (tracks, subs) — the grow-on-join
        path when a publish/join crosses a page boundary. Existing pages
        keep their indices (no device state moves); only the NEW grid
        cells allocate. CapacityError leaves the room at its old extent."""
        room = self._rooms[row]
        mt = room.mt if tracks is None else max(room.mt, -(-tracks // self.tpage))
        ms = room.ms if subs is None else max(room.ms, -(-subs // self.spage))
        if mt > self.max_tpages or ms > self.max_spages:
            raise CapacityError(
                f"room {row} grow past max extent "
                f"({mt}x{ms} vs {self.max_tpages}x{self.max_spages} pages)"
            )
        cells = [
            (ti, si)
            for ti in range(mt)
            for si in range(ms)
            if room.grid[ti, si] < 0
        ]
        if not cells:
            room.mt, room.ms = mt, ms
            return self.extent(row)
        added_runs = len(room.runs)
        try:
            self._map_cells(row, room, cells)
        except CapacityError:
            # undo nothing: _map_cells is one run — it either fully
            # mapped or raised before mutating (alloc_run is atomic).
            del room.runs[added_runs:]
            raise
        room.mt, room.ms = mt, ms
        self.grows += 1
        self.peak_reserved = max(self.peak_reserved, self.pages_reserved)
        self._refresh_tables(row)
        return self.extent(row)

    def _rollback(self, room: _Room) -> None:
        for start, order in room.runs:
            for p in range(start, start + (1 << order)):
                if self.pg_room[p] >= 0 or p in self._fresh:
                    self.pg_room[p] = -1
                    self.pg_tp[p] = -1
                    self.pg_sp[p] = -1
                    self._fresh.discard(p)
            self._free_run(start, order)
        room.runs.clear()

    def release_room(self, row: int) -> None:
        room = self._rooms.pop(row, None)
        if room is None:
            return
        pages = room.grid[room.grid >= 0]
        for p in pages:
            self.pg_room[p] = -1
            self.pg_tp[p] = -1
            self.pg_sp[p] = -1
            self.tmembers[p] = -1
            if p in self._fresh:
                self._fresh.discard(p)
            else:
                self._freed.add(p)
        for start, order in room.runs:
            self._free_run(start, order)
        self.rooms_pages[row] = -1
        self._dirty_rooms.add(row)
        self.epoch += 1
        self.frees += 1

    def compact(self) -> list[tuple[int, int]]:
        """Defragment: relocate every live run to the bottom of a fresh
        pool (rooms in row order). Returns the mapped-page moves [(src,
        dst)] the runtime must replay as device row copies; the page
        table deltas queue alongside. O(live pages)."""
        old_rooms = dict(self._rooms)
        self._free = {self._max_order: {0}}
        moves: list[tuple[int, int]] = []
        self.pg_room[:] = -1
        self.pg_tp[:] = -1
        self.pg_sp[:] = -1
        self.tmembers[:] = -1
        for row in sorted(old_rooms):
            room = old_rooms[row]
            old_grid = room.grid.copy()
            room.runs = []
            room.grid[:] = -1
            cells = [
                (ti, si)
                for ti in range(room.mt)
                for si in range(room.ms)
                if old_grid[ti, si] >= 0
            ]
            order = self._order_for(len(cells))
            start = self._alloc_run(order)  # cannot fail: strictly packing
            room.runs.append((start, order))
            for i, (ti, si) in enumerate(cells):
                src = int(old_grid[ti, si])
                dst = start + i
                room.grid[ti, si] = dst
                self.pg_room[dst] = row
                self.pg_tp[dst] = ti
                self.pg_sp[dst] = si
                if src != dst:
                    if src in self._fresh:
                        self._fresh.discard(src)
                        self._fresh.add(dst)
                    else:
                        moves.append((src, dst))
            self._refresh_tables(row)
        # Pages that were mapped pre-compaction and are no longer mapped
        # anywhere must re-init (their stale state must not forward).
        live = {dst for _, dst in moves} | {
            int(p) for r in self._rooms.values() for p in r.grid[r.grid >= 0]
        }
        for src, _dst in moves:
            if src not in live:
                self._freed.add(src)
        self._moves.extend(moves)
        self.compactions += 1
        self.epoch += 1
        return moves

    # -- queries ----------------------------------------------------------

    def extent(self, row: int) -> RoomExtent:
        room = self._rooms[row]
        return RoomExtent(tracks=room.mt * self.tpage, subs=room.ms * self.spage)

    def pages_of_room(self, row: int) -> np.ndarray:
        """The room's mapped page ids (epoch-scoped — see module doc)."""
        room = self._rooms.get(row)
        if room is None:
            return np.empty(0, np.int32)
        return room.grid[room.grid >= 0].astype(np.int32)

    def room_of_page(self, page: int) -> int:
        return int(self.pg_room[page])

    def check_epoch(self, epoch: int) -> None:
        """Re-validate a page handle minted at `epoch`: raises
        StalePageError if the table changed since."""
        if epoch != self.epoch:
            raise StalePageError(
                f"page table epoch moved {epoch} -> {self.epoch}; "
                "re-fetch page indices before touching device state"
            )

    # -- delta lane -------------------------------------------------------

    def drain_delta(self) -> PageDelta:
        """Pending page events since the last drain, for the device
        upload (page-table rows + fresh/freed page state init + move
        copies). Clears the queues."""
        # Never reinit a currently-mapped page: a page released to _freed
        # can be re-mapped before the drain (compaction picking it as a
        # move destination) — the reinit runs AFTER the move replay and
        # would wipe the relocated state. alloc_room already migrates
        # such pages _freed -> _fresh; this filter closes the compaction
        # path. An unmapped stale page still reinits as usual.
        freed = [p for p in sorted(self._freed) if self.pg_room[p] < 0]
        delta = PageDelta(
            rooms=np.asarray(sorted(self._dirty_rooms), np.int32),
            fresh_pages=np.asarray(sorted(self._fresh), np.int32),
            freed_pages=np.asarray(freed, np.int32),
            moves=np.asarray(self._moves, np.int32).reshape(-1, 2),
        )
        self._dirty_rooms = set()
        self._fresh = set()
        self._freed = set()
        self._moves = []
        return delta

    # -- stats ------------------------------------------------------------

    @property
    def pages_reserved(self) -> int:
        return self.pool_pages - self.pages_free

    @property
    def pages_free(self) -> int:
        return sum(len(v) << o for o, v in self._free.items())

    @property
    def pages_mapped(self) -> int:
        return int((self.pg_room >= 0).sum())

    def stats(self) -> dict:
        free = self.pages_free
        largest = max(
            ((1 << o) for o, v in self._free.items() if v), default=0
        )
        return {
            "pages_total": self.pool_pages,
            "pages_used": self.pages_reserved,
            "pages_free": free,
            "pages_mapped": self.pages_mapped,
            # reserved-but-unmapped slack inside pow2 runs:
            "internal_slack": self.pages_reserved - self.pages_mapped,
            # external fragmentation: how much of the free space is
            # unreachable by the largest-class request (0 = one run).
            "fragmentation_ratio": (
                0.0 if free == 0 else round(1.0 - largest / free, 4)
            ),
            "free_runs_by_order": {
                o: len(v) for o, v in sorted(self._free.items()) if v
            },
            "rooms": len(self._rooms),
            "epoch": self.epoch,
            "allocs": self.allocs,
            "frees": self.frees,
            "grows": self.grows,
            "compactions": self.compactions,
            "alloc_failures": self.alloc_failures,
            "peak_pages_used": self.peak_reserved,
            "tpage": self.tpage,
            "spage": self.spage,
        }
