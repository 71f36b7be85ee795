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

Not carried yet (see ROADMAP.md): the pool mesh, the page-table
integrity audit, snapshots / restore / row repair.
"""

from __future__ import annotations

import numpy as np
import torch

from livekit_server_tpu_torch.models import paged, plane
from livekit_server_tpu_torch.runtime.pager import RoomPager
from livekit_server_tpu_torch.runtime.plane_runtime import PlaneRuntime, StagedTick
from livekit_server_tpu_torch.runtime.slots import PagedSlotAllocator


def _numpy(tree):
    return plane.tree_map(lambda x: x.cpu().numpy(), tree)


class PagedPlaneRuntime(PlaneRuntime):
    """PlaneRuntime over the pooled paged device layout."""

    def __init__(self, dims: paged.PagedDims, *, paged_kernel: str = "auto", **kwargs):
        if not isinstance(dims, paged.PagedDims):
            raise TypeError("PagedPlaneRuntime requires paged.PagedDims")
        if isinstance(paged_kernel, bool):
            paged_kernel = "on" if paged_kernel else "off"
        if paged_kernel not in ("auto", "on", "off"):
            raise ValueError(f"paged_kernel must be auto|on|off, got {paged_kernel!r}")
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
        self._live_n = 0
        super().__init__(dims.logical, **kwargs)
        # The base constructor wired a dense SlotAllocator; rooms claim
        # page grids, so admission and occupancy route through the pager.
        self.slots = PagedSlotAllocator(self.pager)
        self._step_xlate = self._xlate_cached()
        self.stats.update({
            "page_delta_uploads": 0, "page_rows_uploaded": 0,
            "pages_reinit": 0, "page_moves": 0,
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
        self._step = self._live_step if self._pk_enabled else self._stock_step

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
        return plane.wire_inputs((pkt_p.astype(np.int32), fb_p.astype(np.float32),
                                  tf_p.astype(np.float32), tick_ms, roll))

    def _unpack_outputs(self, buf) -> plane.TickOutputs:
        out = plane.unpack_tick_outputs(buf, self.pdims.pooled(), self.red_enabled)
        # _step_xlate, not _xlate_cached(): the outputs belong to the table
        # the step actually saw.
        return self._step_xlate.outputs_to_logical(out)

    def _sel_mirror(self, state) -> tuple:
        return tuple(self._step_xlate.sel_to_logical(_numpy(state.sel),
                                                     self._logical_fill().sel))

    def _device_step(self, st: StagedTick) -> plane.TickOutputs:
        out = super()._device_step(st)
        if self._pk_enabled:
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

    def _to_logical_state(self) -> plane.PlaneState:
        """The device pool as a LOGICAL PlaneState of numpy arrays (the
        page lane is flushed first, so the translation matches the device
        table). Caller holds state_lock."""
        self._sync_pages()
        return self._xlate_cached().state_to_logical(_numpy(self.state), self._logical_fill())

    # -- page-table delta lane --------------------------------------------

    def _sync_pages(self) -> None:
        """Drain the pager's pending page events into the device: table
        rows, compaction row moves, then fresh/freed page re-init (moves
        land before the re-init wipes their sources). Afterwards the
        device table equals the pager's mirrors and `_step_xlate` is
        re-pinned."""
        delta = self.pager.drain_delta()
        if not delta.empty:
            rows = paged.pack_table_delta(self.pager, delta)
            paged.apply_table_delta(self.table, *rows)
            if len(delta.moves):
                paged.move_state_rows(self.state, delta.moves[:, 0], delta.moves[:, 1])
                self.stats["page_moves"] += len(delta.moves)
            reinit = np.concatenate([delta.fresh_pages, delta.freed_pages])
            if len(reinit):
                paged.reinit_pages(self.state, reinit, self._page_template)
                self.stats["pages_reinit"] += len(reinit)
            # Rooms whose grid changed re-assert control onto their
            # (possibly fresh or relocated) pages at this same edge.
            self._dirty_rows.update(int(r) for r in delta.rooms)
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
            plane.apply_ctrl_delta(self.state, pr, meta_rows, ctrl_rows)
            self.stats["ctrl_upload_bytes"] += meta_rows.nbytes + ctrl_rows.nbytes
        self._dirty_rows = set()
        self._ctrl_dirty = False

    def _pack_ctrl_pages(self, page_rows):
        """`plane.pack_ctrl_rows` at page granularity: each mapped page's
        [TP] meta / [TP, SP] control block out of the logical mirrors."""
        d = self.pdims
        pr = np.sort(np.asarray(page_rows, np.int32))
        rooms, tps, sps = self.pager.pg_room[pr], self.pager.pg_tp[pr], self.pager.pg_sp[pr]
        meta_rows = np.stack([
            np.asarray(m).reshape(d.rooms, d.max_tpages, d.tpage)[rooms, tps].astype(np.int32)
            for m in self.meta
        ])
        ctrl_rows = np.stack([
            np.asarray(c).reshape(d.rooms, d.max_tpages, d.tpage, d.max_spages, d.spage)
            [rooms, tps, :, sps].astype(np.int32)
            for c in self.ctrl
        ])
        return pr, meta_rows, ctrl_rows

    # -- admin -------------------------------------------------------------

    def compact(self) -> int:
        """Defragment the page pool (host side now; the device moves and
        the table delta replay at the next tick-edge sync). Returns the
        number of device row moves queued."""
        return len(self.pager.compact())

    def pager_stats(self) -> dict:
        st = self.pager.stats()
        st["paged_kernel"] = self._pk_mode if self._pk_enabled else "off"
        st["page_live_fraction"] = round(self._live_n / self.pdims.pool_pages, 4)
        return st
