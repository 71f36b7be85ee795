"""PagedPlaneRuntime: the tick loop over pooled device pages.

Port of the JAX package's runtime/paged_runtime.py (single device).
PlaneRuntime's host side — control mirrors, ingest, munger, sequencer,
fan-out — speaks LOGICAL dense [R, T, S] shapes. This subclass swaps only
the device layout underneath it through the seams of plane_runtime.py:
the device state is ONE pool of P `[tpage, K, spage]` pages
(models/paged.py) indirected through a device page table whose canonical
host copy lives in the RoomPager (runtime/pager.py). Rooms claim page
grids through PagedSlotAllocator instead of pre-paying the dense worst
case.

Upload protocol: at every tick edge `_upload_ctrl` first drains the
pager's PageDelta — table rows, compaction row moves, then fresh/freed
page re-init — and then ships the dirtied rooms' control at page
granularity. A free page always holds pristine init state.

Tick variants (`paged_kernel`): "off" runs the stock pooled tick over the
whole pool; "on" and "auto" run the live-extent tick — phase 0 on the
live-page kernel (ops/paged_kernel.py; CUDA on a card, the plain version
on device="cpu"), its span recorded per tick as `paged_kernel_ms` with
the kernel's block count, then phases 1–2 over the live rows only.
`live_rows` is refreshed when the page lane syncs. With no live page the
tick moves no state and every row gets the dead-page outputs.

Staleness: page indices are valid only under the pager epoch they were
read at. `_step_xlate` is pinned when the device table last matched the
pager and translates that step's outputs. Inputs staged between an epoch
bump and the next upload are at most one tick stale: packets for pages
that moved or were freed land on re-initialized (unsubscribed) pages and
drop, never misroute.

Checkpoints, repairs and restores speak the LOGICAL dense form
(`_to_logical_state`, `_write_logical_row`), so a paged snapshot frame is
the same as a dense one and crosses layouts and packages. The integrity
audit runs over the pooled page rows; `map_audit_mask` folds its mask to
rooms and adds the page-table check (BIT_TABLE) against the host copy of
what the last page sync uploaded.

Pool mesh (`mesh=`, parallel/mesh.py), as the reference's: the pooled
state and the page table are split over the mesh's devices by page
(`shard_pool`), the tick is the stock pooled one (`paged_kernel` forced
"off", with the reference's warning when it was asked for), and each
shard ticks its pages with copies of the pages its rooms hold on other
shards (`PoolPlan`, rebuilt at each page sync; the copies count in
`stats["cross_shard_pages"]`). Table, control and row writes land on the
owning shard; a restore binds fresh tensors on every shard.
"""

from __future__ import annotations

import numpy as np
import torch

from livekit_server_tpu_torch.models import paged, plane
from livekit_server_tpu_torch.parallel import mesh as mesh_mod
from livekit_server_tpu_torch.runtime import integrity
from livekit_server_tpu_torch.runtime.munge import HostMunger
from livekit_server_tpu_torch.runtime.pager import RoomPager
from livekit_server_tpu_torch.runtime.plane_runtime import (
    PlaneRuntime,
    StagedTick,
    _to_device,
)
from livekit_server_tpu_torch.runtime.slots import PagedSlotAllocator
from livekit_server_tpu_torch.utils.logger import Logger


def _numpy(tree):
    return plane.tree_map(lambda x: x.cpu().numpy(), tree)


class PagedPlaneRuntime(PlaneRuntime):
    """PlaneRuntime over the pooled paged device layout."""

    def __init__(self, dims: paged.PagedDims, *, mesh=None, paged_kernel: str = "auto",
                 **kwargs):
        if not isinstance(dims, paged.PagedDims):
            raise TypeError("PagedPlaneRuntime requires paged.PagedDims")
        if isinstance(paged_kernel, bool):
            paged_kernel = "on" if paged_kernel else "off"
        if paged_kernel not in ("auto", "on", "off"):
            raise ValueError(f"paged_kernel must be auto|on|off, got {paged_kernel!r}")
        if mesh is not None and paged_kernel != "off":
            # The live-page kernel runs over the whole pool on one
            # device; the page-sharded tick stays the stock one.
            if paged_kernel != "auto":
                Logger(plane="paged").warn(
                    "paged_kernel forced off: pool-mesh sharding uses "
                    "the stock pooled tick", requested=paged_kernel,
                )
            paged_kernel = "off"
        # Pool-axis mesh, kept apart from the base class's room mesh (the
        # dense tick's): the pooled tick couples pages across shards.
        self._pmesh = mesh
        if mesh is not None:
            kwargs["device"] = mesh.devices[0]
        self.pdims = dims
        self._pk_mode = paged_kernel
        self._pk_enabled = paged_kernel != "off"
        self._kernel_s_scratch = 0.0
        self._kernel_steps_scratch = 0
        self.pager = RoomPager(
            dims.rooms, dims.tracks, dims.subs,
            tpage=dims.tpage, spage=dims.spage, pool_pages=dims.pool_pages,
        )
        self._xlate: paged.LayoutXlate | None = None
        self._xlate_epoch = -1
        self._lfill = None
        self._pfill = None
        self._live_n = 0
        P, MT = dims.pool_pages, dims.max_tpages
        # What the DEVICE table should hold (the pager's mirrors as of the
        # last page sync) — the page-table audit's baseline; the live
        # pager may legitimately be ahead (a queued delta).
        self._dev_tables = (
            np.full(P, -1, np.int32), np.full(P, -1, np.int32),
            np.full(P, -1, np.int32), np.full((P, MT), -1, np.int32),
        )
        self.table_repairs = 0
        super().__init__(dims.logical, **kwargs)
        # The base constructor wired a dense SlotAllocator; rooms claim
        # page grids, so admission and occupancy route through the pager.
        self.slots = PagedSlotAllocator(self.pager)
        self._step_xlate = self._xlate_cached()
        self.stats.update({
            "page_delta_uploads": 0, "page_rows_uploaded": 0,
            "pages_reinit": 0, "page_moves": 0, "cross_shard_pages": 0,
            # Kernel accounting: steps == the padded live-page bucket per
            # tick (blocks the kernel launched).
            "paged_kernel_ticks": 0, "paged_kernel_steps": 0,
        })

    # -- seam hooks -------------------------------------------------------

    def _init_device_state(self) -> plane.PlaneState:
        self.table = paged.init_table(self.pdims, self.device)
        self._page_template = paged.page_init_template(self.pdims, self.device)
        # `paged.live_rows_of` the device table; empty until the first
        # page sync.
        self._live_rows = torch.zeros(0, dtype=torch.int32, device=self.device)
        self._live_inv = torch.zeros(self.pdims.pool_pages, dtype=torch.int32,
                                     device=self.device)
        return plane.init_state(self.pdims.pooled(), device=self.device)

    def _init_step(self) -> None:
        if self._pmesh is not None:
            self.state = mesh_mod.shard_pool(self.state, self._pmesh)
            self.table = mesh_mod.shard_pool(self.table, self._pmesh)
            self._pool_tick = mesh_mod.ShardedPoolTick(
                self._pmesh, self._ap, self._bp, self.red_enabled)
            self._pool_plan = mesh_mod.PoolPlan(self._pmesh, self._dev_tables[3])
            self._step = self._sharded_stock_step
            return
        self._step = self._live_step if self._pk_enabled else self._stock_step

    def _sharded_stock_step(self, state, wires):
        """The stock pooled step over page shards: each shard's wire up,
        the sharded tick, each shard's flat outputs down."""
        inp = mesh_mod.upload_wires(wires, self._pmesh, self.pdims.pooled())
        state, bufs = self._pool_tick.step(state, inp, self.table, self._pool_plan)
        self.stats["cross_shard_pages"] += self._pool_plan.copies
        return state, bufs

    def _stock_step(self, state, wire):
        return paged.stock_step(state, self.table, wire, self.pdims, self._ap, self._bp,
                                self.red_enabled)

    def _live_step(self, state, wire):
        """Live-extent device step; the phase-0 span and block count go to
        scratch fields that `_device_step` copies onto the StagedTick."""
        state, buf, self._kernel_s_scratch = paged.live_step(
            state, self.table, wire, self.pdims, self._live_rows, self._live_inv,
            self._ap, self._bp, self.red_enabled,
        )
        self._kernel_steps_scratch = int(self._live_rows.numel())
        return state, buf

    def _pack_inputs(self, inp: plane.TickInputs) -> np.ndarray:
        pkt, fb, tf, tick_ms, roll = plane.pack_tick_inputs(inp)
        pkt_p, fb_p, tf_p = self._xlate_cached().stage_inputs(pkt, fb, tf)
        packed = (pkt_p.astype(np.int32), fb_p.astype(np.float32),
                  tf_p.astype(np.float32), tick_ms, roll)
        if self._pmesh is not None:
            return mesh_mod.shard_wires(packed, self._pmesh)
        return plane.wire_inputs(packed)

    def _unpack_outputs(self, buf) -> plane.TickOutputs:
        if self._pmesh is not None:
            out = mesh_mod.join_outputs(buf, self.pdims.pooled(), self.red_enabled)
        else:
            out = plane.unpack_tick_outputs(buf, self.pdims.pooled(), self.red_enabled)
        # _step_xlate, not _xlate_cached(): the outputs belong to the table
        # the step actually saw.
        return self._step_xlate.outputs_to_logical(out)

    def _sel_mirror(self, state) -> tuple:
        if self._pmesh is not None:
            state = mesh_mod.gather_tree(state)
        return tuple(self._step_xlate.sel_to_logical(_numpy(state.sel),
                                                     self._logical_fill().sel))

    def _device_step(self, st: StagedTick) -> plane.TickOutputs | None:
        out = super()._device_step(st)
        if out is not None and self._pk_enabled:
            st.kernel_s = self._kernel_s_scratch
            st.kernel_steps = self._kernel_steps_scratch
        return out

    def _tick_rec_extras(self, st: StagedTick) -> dict:
        if not self._pk_enabled:
            return {}
        self.stats["paged_kernel_ticks"] += 1
        self.stats["paged_kernel_steps"] += st.kernel_steps
        return {
            "paged_kernel_ms": round(st.kernel_s * 1000.0, 3),
            "page_live_fraction": round(self._live_n / self.pdims.pool_pages, 4),
        }

    # -- layout translation ------------------------------------------------

    def _xlate_cached(self) -> paged.LayoutXlate:
        """The translation snapshot for the CURRENT pager epoch (its index
        arrays are copies, so it stays a valid point-in-time snapshot)."""
        if self._xlate is None or self._xlate_epoch != self.pager.epoch:
            self._xlate = paged.LayoutXlate(
                self.pdims, self.pager.pg_room.copy(), self.pager.pg_tp.copy(),
                self.pager.pg_sp.copy(),
            )
            self._xlate_epoch = self.pager.epoch
        return self._xlate

    def _logical_fill(self) -> plane.PlaneState:
        """Logical init state (numpy broadcast views): the fill for
        unmapped regions in pooled→logical translation."""
        if self._lfill is None:
            d = self.dims
            tpl = plane.init_state(plane.PlaneDims(1, d.tracks, d.pkts, d.subs), device="cpu")
            self._lfill = plane.tree_map(
                lambda a: np.broadcast_to(a.numpy(), (d.rooms,) + tuple(a.shape[1:])), tpl)
        return self._lfill

    def _pooled_fill(self) -> plane.PlaneState:
        """Pooled init state (numpy broadcast views of the page template):
        the value of free pages in logical→pooled translation."""
        if self._pfill is None:
            P = self.pdims.pool_pages
            self._pfill = plane.tree_map(
                lambda a: np.broadcast_to(a.cpu().numpy(), (P,) + tuple(a.shape[1:])),
                self._page_template)
        return self._pfill

    def _to_logical_state(self) -> plane.PlaneState:
        """The device pool as a LOGICAL PlaneState of numpy arrays (the
        page lane is flushed first, so the translation matches the device
        table). Caller holds state_lock."""
        self._sync_pages()
        with self._on_stream():
            pooled = _numpy(self._pooled_state())
        return self._xlate_cached().state_to_logical(pooled, self._logical_fill())

    def _pooled_state(self) -> plane.PlaneState:
        """The whole pooled state; on a pool mesh, its shards joined on
        the host."""
        return mesh_mod.gather_tree(self.state) if self._pmesh is not None else self.state

    # -- page-table delta lane --------------------------------------------

    def _apply_table_delta(self, page_rows, tmember_rows, pg_room_rows, pg_tp_rows,
                           pg_sp_rows, room_rows, rooms_pages_rows) -> None:
        """`paged.apply_table_delta` onto the device table; on a pool mesh,
        page rows onto the shard owning the page, room rows onto the shard
        owning the room."""
        if self._pmesh is None:
            paged.apply_table_delta(self.table, page_rows, tmember_rows, pg_room_rows,
                                    pg_tp_rows, pg_sp_rows, room_rows, rooms_pages_rows)
            return
        d, none = self.pdims, np.empty(0, np.int32)
        W = d.max_tpages * d.max_spages
        for i, pos, local in mesh_mod.split_rows(self._pmesh, d.pool_pages, page_rows):
            paged.apply_table_delta(
                self.table.shards[i], local, np.asarray(tmember_rows)[pos],
                np.asarray(pg_room_rows)[pos], np.asarray(pg_tp_rows)[pos],
                np.asarray(pg_sp_rows)[pos], none, np.empty((0, W), np.int32))
        for i, pos, local in mesh_mod.split_rows(self._pmesh, d.rooms, room_rows):
            paged.apply_table_delta(
                self.table.shards[i], none, np.empty((0, d.max_tpages), np.int32),
                none, none, none, local, np.asarray(rooms_pages_rows)[pos])

    def _sync_pages(self) -> None:
        """Drain the pager's pending page events into the device: table
        rows, compaction row moves, then fresh/freed page re-init (moves
        land before the re-init wipes their sources). Afterwards the
        device table equals the pager's mirrors and `_step_xlate` is
        re-pinned."""
        delta = self.pager.drain_delta()
        if not delta.empty:
            rows = paged.pack_table_delta(self.pager, delta)
            self._apply_table_delta(*rows)
            if len(delta.moves):
                if self._pmesh is None:
                    paged.move_state_rows(self.state, delta.moves[:, 0], delta.moves[:, 1])
                else:
                    # Every source row is read before any destination is
                    # written, across shards too.
                    moved = mesh_mod.read_rows(self.state, delta.moves[:, 0])
                    mesh_mod.write_rows(self.state, delta.moves[:, 1],
                                        plane.tree_leaves(moved))
                self.stats["page_moves"] += len(delta.moves)
            reinit = np.concatenate([delta.fresh_pages, delta.freed_pages])
            if len(reinit):
                if self._pmesh is None:
                    paged.reinit_pages(self.state, reinit, self._page_template)
                else:
                    mesh_mod.write_rows(self.state, reinit, [
                        np.broadcast_to(a[:1], (len(reinit),) + a.shape[1:])
                        for a in plane.tree_leaves(self._pooled_fill())])
                self.stats["pages_reinit"] += len(reinit)
            # Rooms whose grid changed re-assert control onto their
            # (possibly fresh or relocated) pages at this same edge.
            self._dirty_rows.update(int(r) for r in delta.rooms)
            self._dev_tables = (
                self.pager.pg_room.copy(), self.pager.pg_tp.copy(),
                self.pager.pg_sp.copy(), self.pager.tmembers.copy(),
            )
            if self._pmesh is not None:
                self._pool_plan = mesh_mod.PoolPlan(self._pmesh, self._dev_tables[3])
            if self.integrity is not None:
                # Page identity changed under the audit mirror's cursors;
                # re-baseline instead of flagging relocated streams.
                self.integrity.on_layout_change()
            self.stats["page_delta_uploads"] += 1
            self.stats["page_rows_uploaded"] += len(rows[0])
            self._refresh_live_rows()
        self._step_xlate = self._xlate_cached()

    def _refresh_live_rows(self) -> None:
        rows, inv, self._live_n = paged.live_rows_of(self.pager.pg_room)
        self._live_rows = torch.from_numpy(rows).to(self.device)
        self._live_inv = torch.from_numpy(inv).to(self.device)

    def _upload_ctrl(self) -> None:
        """Page lane first, then the dirty rooms' control at PAGE
        granularity: each page row is a [TP] / [TP, SP] block gathered
        from the logical host mirrors."""
        self._sync_pages()
        rows = self._dirty_rows
        if not self._ctrl_dirty and not rows:
            return
        if self._ctrl_dirty or len(rows) > self.ctrl_delta_max_rows:
            page_rows = np.nonzero(self.pager.pg_room >= 0)[0].astype(np.int32)
            self.stats["ctrl_full_uploads"] += 1
        else:
            parts = [self.pager.pages_of_room(int(r)) for r in sorted(rows)]
            page_rows = np.concatenate(parts).astype(np.int32)
            self.stats["ctrl_delta_uploads"] += 1
            self.stats["ctrl_delta_rows"] += len(rows)
        if len(page_rows):
            pr, meta_rows, ctrl_rows = self._pack_ctrl_pages(page_rows)
            if self._pmesh is None:
                plane.apply_ctrl_delta(self.state, pr, meta_rows, ctrl_rows)
            else:
                for i, pos, local in mesh_mod.split_rows(self._pmesh, self.pdims.pool_pages,
                                                         pr):
                    plane.apply_ctrl_delta(self.state.shards[i], local, meta_rows[:, pos],
                                           ctrl_rows[:, pos])
            self.stats["ctrl_upload_bytes"] += meta_rows.nbytes + ctrl_rows.nbytes
        self._dirty_rows = set()
        self._ctrl_dirty = False

    def _pack_ctrl_pages(self, page_rows):
        """`plane.pack_ctrl_rows` at page granularity: each mapped page's
        [TP] meta / [TP, SP] control block out of the logical mirrors."""
        d = self.pdims
        pr = np.sort(np.asarray(page_rows, np.int32))
        rooms, tps, sps = self.pager.pg_room[pr], self.pager.pg_tp[pr], self.pager.pg_sp[pr]
        ctrl = self._effective_ctrl()
        meta_rows = np.stack([
            np.asarray(m).reshape(d.rooms, d.max_tpages, d.tpage)[rooms, tps].astype(np.int32)
            for m in self.meta
        ])
        ctrl_rows = np.stack([
            np.asarray(c).reshape(d.rooms, d.max_tpages, d.tpage, d.max_spages, d.spage)
            [rooms, tps, :, sps].astype(np.int32)
            for c in ctrl
        ])
        return pr, meta_rows, ctrl_rows

    # -- integrity plane ---------------------------------------------------

    def map_audit_mask(self, mask: np.ndarray) -> np.ndarray:
        """[P] per-page audit mask → [R] per-room mask, plus the page-table
        check: the device table is delta-maintained from the pager's
        mirrors, so any divergence from the last-sync copy is corruption —
        repair the table rows from the host copy at once and flag the
        touched rooms (their state computed through a corrupt
        indirection, so it is suspect too). Runs on the worker thread
        with state_lock held and the runtime's stream current (via
        maybe_audit)."""
        room_mask = self._step_xlate.page_mask_to_rooms(mask).astype(np.int32)
        bad_rooms = self._audit_page_table()
        if bad_rooms is not None:
            room_mask[bad_rooms] |= np.int32(integrity.BIT_TABLE)
        return room_mask

    def _audit_page_table(self) -> np.ndarray | None:
        """[R] bool of the rooms a diverged device table row touches (the
        true owner and the phantom one), after re-writing those rows from
        the host copy; None when the table matches."""
        mr, mt, ms, mtm = self._dev_tables
        t = mesh_mod.gather_tree(self.table) if self._pmesh is not None else self.table
        dr, dt, ds, dtm = (x.to("cpu", copy=True).numpy()
                           for x in (t.pg_room, t.pg_tp, t.pg_sp, t.tmembers))
        bad = (dr != mr) | (dt != mt) | (ds != ms) | (dtm != mtm).any(axis=1)
        if not bad.any():
            return None
        R = self.dims.rooms
        bad_rooms = np.zeros(R, bool)
        for owner in (mr[bad], dr[bad]):  # true owner + phantom pointee
            valid = (owner >= 0) & (owner < R)
            bad_rooms[owner[valid]] = True
        rows = np.nonzero(bad)[0].astype(np.int32)
        # The host copy is authoritative: re-scatter the diverged rows.
        self._apply_table_delta(
            rows, mtm[rows], mr[rows], mt[rows], ms[rows],
            np.empty(0, np.int32),
            np.empty((0, self.pager.rooms_pages.shape[1]), np.int32),
        )
        self.table_repairs += len(rows)
        return bad_rooms

    # -- checkpoint / repair / restore (LOGICAL form) ----------------------

    def _write_logical_row(self, row: int, leaves: list) -> None:
        """Scatter one LOGICAL room row into every page of the room's grid
        (re-establishing the duplicate-everywhere invariant), in place on
        the runtime's stream. Page ids are read after a page-lane flush,
        under the lock."""
        self._sync_pages()
        pages = self.pager.pages_of_room(row)
        if len(pages) == 0:
            return
        d = self.pdims
        tps = self.pager.pg_tp[pages].astype(np.int64)
        sps = self.pager.pg_sp[pages].astype(np.int64)
        tmpl = self.state.shards[0] if self._pmesh is not None else self.state
        row_tree = plane.tree_unflatten(tmpl, [np.asarray(a) for a in leaves])

        def rowfun(kind, lrow, pooled_leaf):
            a = np.ascontiguousarray(lrow)
            if kind == paged._K_TRACK:
                w = a.size // d.tracks
                v = a.reshape(d.max_tpages, d.tpage, w)[tps]
            elif kind == paged._K_SUB:
                w = a.size // d.subs
                v = a.reshape(d.max_spages, d.spage, w)[sps]
            else:
                w = a.size // (d.tracks * d.subs)
                v = a.reshape(d.max_tpages, d.tpage, d.max_spages, d.spage, w)[tps, :, sps]
            return v.reshape((len(pages),) + tuple(pooled_leaf.shape[1:]))

        rows_tree = plane.tree_map(rowfun, paged._kind_tree(row_tree), row_tree, tmpl)
        if self._pmesh is not None:
            mesh_mod.write_rows(self.state, pages, plane.tree_leaves(rows_tree))
            return
        with self._on_stream():
            idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
            for leaf, rws in zip(plane.tree_leaves(self.state), plane.tree_leaves(rows_tree)):
                leaf[idx] = _to_device(rws, leaf)

    def snapshot(self) -> dict:
        return {"tick_index": self.tick_index,
                "arrays": plane.tree_leaves(self._to_logical_state()),
                "munger": self.munger.snapshot()}

    def snapshot_room(self, row: int) -> dict:
        tree = plane.tree_map(lambda a: np.array(a[row]), self._to_logical_state())
        tree = tree._replace(
            meta=plane.TrackMeta(*[np.array(m[row]) for m in self.meta]),
            ctrl=plane.SubControl(*[np.array(c[row]) for c in self.ctrl]),
        )
        return {"arrays": plane.tree_leaves(tree) + self.munger.snapshot_room(row)}

    def repair_room_row(self, row: int, snap: dict) -> None:
        lflat = plane.tree_leaves(self._logical_fill())
        self._check_leaves(lflat, snap["arrays"], row=True)
        self.munger.restore_room(row, snap["arrays"][len(lflat):])
        self._write_logical_row(row, snap["arrays"][:len(lflat)])
        # Same post-repair hygiene as the dense path: the replay ring
        # references pre-repair SN spaces; host mirrors stay
        # authoritative and re-assert at the next edge.
        self.host_seq.clear_room(row)
        self._dirty_rows.add(row)

    def extract_staged_row(self, row: int) -> None:
        """Not done on the paged plane (its staged inputs are packed per
        page): a migration settles the staged tick instead."""
        return None

    def snapshot_rooms(self, rows: list[int]) -> list[dict]:
        """`snapshot_room` of each row (the paged row is read through its
        pages, one room at a time)."""
        return [self.snapshot_room(row) for row in rows]

    def restore_room(self, row: int, snap: dict) -> None:
        self.host_seq.clear_room(row)
        lfill = self._logical_fill()
        lflat = plane.tree_leaves(lfill)
        self._check_leaves(lflat, snap["arrays"], row=True)
        dev_arrays = snap["arrays"][:len(lflat)]
        snap_tree = plane.tree_unflatten(lfill, [np.asarray(a) for a in dev_arrays])
        # The incoming room's live tracks may exceed this row's current
        # page extent (the adopter allocated minimally): grow the grid to
        # cover every published track column BEFORE writing the row, so
        # the publisher state lands instead of truncating.
        live = np.nonzero(np.asarray(snap_tree.meta.published))[0]
        need_t = int(live[-1]) + 1 if len(live) else 1
        if len(self.pager.pages_of_room(row)) == 0:
            self.pager.alloc_room(row, tracks=need_t)
        else:
            self.pager.grow_room(row, tracks=need_t)
        self.munger.restore_room(row, snap["arrays"][len(lflat):])
        self._write_logical_row(row, dev_arrays)
        for host_arr, snap_arr in zip(self.meta, snap_tree.meta):
            host_arr[row] = snap_arr
        # Subscription masks are not carried (see the dense docstring):
        # destination sub columns are allocated fresh.
        self._reset_restored_ctrl(row)

    def restore(self, snap: dict) -> None:
        """Restore from a LOGICAL snapshot onto freshly allocated pool
        tensors. Rooms resident in this node's pager take their rows;
        logical rows without pages drop — the checkpoint stays
        layout-independent, placement is the restoring node's business."""
        self._sync_pages()
        self._check_leaves(plane.tree_leaves(self._logical_fill()), snap.get("arrays"),
                           row=False)
        logical = plane.tree_unflatten(self._logical_fill(),
                                       [np.asarray(a) for a in snap["arrays"]])
        pooled = self._xlate_cached().state_to_pooled(logical, self._pooled_fill())
        if self._pmesh is not None:
            host = [_to_device(a, torch.empty(0, dtype=leaf.dtype)) for leaf, a in
                    zip(plane.tree_leaves(self.state.shards[0]), plane.tree_leaves(pooled))]
            self.state = mesh_mod.shard_pool(
                plane.tree_unflatten(self.state.shards[0], host), self._pmesh)
        else:
            with self._on_stream():
                self.state = plane.tree_unflatten(self.state, [
                    _to_device(a, leaf) for leaf, a in
                    zip(plane.tree_leaves(self.state), plane.tree_leaves(pooled))])
        if "munger" in snap:
            self.munger.restore(snap["munger"])
        else:
            self.munger = HostMunger(self.dims)
        self.tick_index = snap["tick_index"]
        self._ctrl_dirty = True
        if self.integrity is not None:
            self.integrity.on_full_restore()

    # -- admin -------------------------------------------------------------

    def compact(self) -> int:
        """Defragment the page pool (host side now; the device moves and
        the table delta replay at the next tick-edge sync). Returns the
        number of device row moves queued."""
        return len(self.pager.compact())

    def pager_stats(self) -> dict:
        st = self.pager.stats()
        st["table_repairs"] = self.table_repairs
        st["paged_kernel"] = self._pk_mode if self._pk_enabled else "off"
        st["page_live_fraction"] = round(self._live_n / self.pdims.pool_pages, 4)
        return st
