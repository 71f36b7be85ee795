"""State-integrity plane: on-device invariant auditing + row repair.

Port of the JAX package's runtime/integrity.py. The supervisor catches a
plane that *stops* and the governor catches a plane that *slows*; this
module catches a plane that keeps ticking while its state is silently
wrong (a NaN'd row, a stream cursor that jumped backwards, a bit flipped
by the fault injector). Two halves:

* ``audit_plane(state, mirror)`` — a reduction over the whole PlaneState
  in torch ops, run on the device the state lives on, every
  ``integrity.audit_every_ticks`` ticks right after the device step
  commits. It emits a per-room violation bitmask [R] plus per-rule
  counters; only those few dozen bytes cross to the host. (The reference
  jits the same reduction as one XLA program; here the float leaves are
  concatenated once so their two row reductions are two launches.) On a
  mesh (parallel/mesh.py) the reduction runs once per shard, on the
  shard's device: the room masks join in room order and the per-rule
  counters sum, which equals the unsharded audit.

* ``IntegrityMonitor`` — the host-side repair ladder. A flagged room is
  quarantined the same tick (fan-out masked in ``_fan_out``, egress muted
  through the effective-ctrl overlay), then repaired by restoring ONLY
  that row from the supervisor's last verified checkpoint. Bounded
  attempts; row repair failing or a violation storm escalates to a
  supervisor full restart-from-snapshot (restart cause ``integrity``, vs
  the watchdog's ``stall``).

Audit rules (bit per rule, see AUDIT_RULES):

  bit 0  nonfinite — any NaN/Inf in a float leaf of the room's state
  bit 1  range     — |x| > 1e30 in a float leaf (a single high-exponent
                     bitflip usually stays finite; this catches it)
  bit 2  cursor    — per-stream (ext seqnum, received) went BACKWARDS
                     vs the previous audit's mirror while the stream
                     identity (started + first_sn) is unchanged, so
                     legitimate stream resets don't trip it
  bit 3  ctrl      — max_spatial/max_temporal outside their valid range
  bit 4  bounds    — selector layers out of bounds, or a negative BWE
                     ring cursor (the reference also flags one past
                     bwe.WINDOW; see audit_plane)
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from livekit_server_tpu_torch.models import plane
from livekit_server_tpu_torch.ops import selector
from livekit_server_tpu_torch.parallel.mesh import Sharded
from livekit_server_tpu_torch.runtime import trace
from livekit_server_tpu_torch.utils.checksum import ChecksumError
from livekit_server_tpu_torch.utils.logger import Logger

AUDIT_RULES = ("nonfinite", "range", "cursor", "ctrl", "bounds")
NUM_RULES = len(AUDIT_RULES)

BIT_NONFINITE = 1 << 0
BIT_RANGE = 1 << 1
BIT_CURSOR = 1 << 2
BIT_CTRL = 1 << 3
BIT_BOUNDS = 1 << 4
# Set by the PAGED runtime's map_audit_mask, not by audit_plane: the
# device page table diverged from the pager's host mirror of what it last
# uploaded (corruption of the indirection layer itself). The table rows
# are repaired from the host copy at once; the rooms that computed
# through the corrupt mapping still quarantine + row-repair like any
# other violation.
BIT_TABLE = 1 << 5

# Finite values past this are treated as corruption: no real rate, byte
# count, jitter, or audio level in the plane approaches 1e30, but a
# flipped exponent bit on any normal float32 lands far above it.
RANGE_LIMIT = 1e30


class AuditMirror(NamedTuple):
    """Stream-cursor registers from the previous audit, [R, T*L].

    ext_sn folds the wrap counter in (sn_cycles * 65536 + highest_sn) so
    a legitimate 16-bit SN wrap between audits is still monotonic.
    """

    started: torch.Tensor   # bool
    first_sn: torch.Tensor  # int32
    ext_sn: torch.Tensor    # int32
    received: torch.Tensor  # int32


def init_mirror(state: plane.PlaneState | Sharded) -> AuditMirror | Sharded:
    if isinstance(state, Sharded):
        return state.map(init_mirror)
    s = state.stats
    return AuditMirror(
        started=torch.zeros_like(s.started),
        first_sn=torch.zeros_like(s.first_sn),
        ext_sn=torch.zeros_like(s.highest_sn),
        received=torch.zeros_like(s.received),
    )


def _rows_any(bad: torch.Tensor, rooms: int) -> torch.Tensor:
    return bad.reshape(rooms, -1).any(dim=1)


def audit_plane(
    state: plane.PlaneState | Sharded, mirror: AuditMirror | Sharded
) -> tuple[torch.Tensor, torch.Tensor, AuditMirror | Sharded]:
    """Integrity reduction -> (mask [R] int32, counts [5] int32, new
    mirror), all on the state's device; for a sharded state, the mask and
    counts on the host and the mirror sharded like the state."""
    if isinstance(state, Sharded):
        parts = [audit_plane(s, m) for s, m in zip(state.shards, mirror.shards)]
        return (torch.cat([p[0].cpu() for p in parts]),
                sum(p[1].cpu() for p in parts),
                Sharded(state.mesh, [p[2] for p in parts]))
    rooms = state.audio_state.smoothed_level.shape[0]

    floats = [leaf.reshape(rooms, -1) for leaf in plane.tree_leaves(state)
              if leaf.is_floating_point()]
    flat = torch.cat(floats, dim=1)
    bad_finite = ~torch.isfinite(flat).all(dim=1)
    bad_range = (flat.abs() > RANGE_LIMIT).any(dim=1)

    s = state.stats
    ext_sn = s.sn_cycles * 65536 + s.highest_sn
    same_stream = mirror.started & s.started & (s.first_sn == mirror.first_sn)
    went_back = same_stream & ((ext_sn < mirror.ext_sn) | (s.received < mirror.received))
    bad_cursor = went_back.any(dim=1)
    new_mirror = AuditMirror(started=s.started.clone(), first_sn=s.first_sn.clone(),
                             ext_sn=ext_sn, received=s.received.clone())

    c = state.ctrl
    bad_ctrl = _rows_any(
        (c.max_spatial < 0) | (c.max_spatial >= plane.MAX_LAYERS)
        | (c.max_temporal < 0) | (c.max_temporal >= plane.MAX_TEMPORAL), rooms)

    sel = state.sel
    layer_oob = torch.zeros(rooms, dtype=torch.bool, device=flat.device)
    for arr, hi in ((sel.current_spatial, plane.MAX_LAYERS),
                    (sel.target_spatial, plane.MAX_LAYERS),
                    (sel.current_temporal, plane.MAX_TEMPORAL),
                    (sel.target_temporal, plane.MAX_TEMPORAL)):
        layer_oob |= _rows_any((arr < selector.INVALID_LAYER) | (arr >= hi), rooms)
    # The BWE ring cursor only ever grows and is read modulo bwe.WINDOW,
    # so only a negative one is out of bounds. The reference also flags
    # ring_pos >= WINDOW, which every room reaches after WINDOW receiver
    # estimates on a clean state (a divergence by design: ROADMAP C5).
    layer_oob |= _rows_any(state.bwe_state.ring_pos < 0, rooms)

    rules = torch.stack((bad_finite, bad_range, bad_cursor, bad_ctrl, layer_oob))
    bits = torch.bitwise_left_shift(
        1, torch.arange(NUM_RULES, dtype=torch.int32, device=flat.device))
    mask = (rules.to(torch.int32) * bits[:, None]).sum(dim=0, dtype=torch.int32)
    counts = rules.sum(dim=1, dtype=torch.int32)
    return mask, counts, new_mirror


class IntegrityMonitor:
    """Host driver for the audit and the repair ladder.

    ``maybe_audit`` runs on the device-step worker thread with state_lock
    held by the caller, on the runtime's stream; it reads device state and
    mutates plain-Python monitor fields (GIL-safe). ``process`` runs on
    the event loop at the serving loop's window edge (outside the tick's
    lock region) and takes state_lock around each row repair.
    """

    def __init__(
        self,
        runtime: Any,
        *,
        audit_every_ticks: int = 16,
        max_row_repairs: int = 3,
        storm_threshold: int = 4,
        log: Logger | None = None,
    ) -> None:
        self.runtime = runtime
        self.audit_every = max(1, int(audit_every_ticks))
        self.max_row_repairs = max(1, int(max_row_repairs))
        self.storm_threshold = max(1, int(storm_threshold))
        self.log = (log or Logger()).with_fields(component="integrity")

        # () -> decoded full-plane snapshot dict or None; wired to the
        # supervisor's last verified checkpoint generation.
        self.snapshot_provider: Callable[[], dict | None] | None = None
        # (reason) -> None; wired to supervisor.request_restart.
        self.escalate_cb: Callable[[str], None] | None = None

        self.quarantined: set[int] = set()
        self._pending_repair: set[int] = set()
        self._row_attempts: dict[int, int] = {}
        self._mirror: AuditMirror | None = None
        self._escalated_epoch = -1
        # Latched between escalate_cb and on_full_restore: the restart
        # request and the restore land on the event loop while the worker
        # thread keeps ticking (and auditing) the still-corrupt state —
        # possibly in the new run_epoch, which the epoch guard alone
        # would treat as fresh corruption and escalate again.
        self._restore_pending = False

        self.audits = 0
        self.violations_total = 0
        self.rows_quarantined = 0
        self.rows_repaired = 0
        self.repair_failures = 0
        self.escalations = 0
        self.rule_violations = {name: 0 for name in AUDIT_RULES}
        self.last_audit_tick = -1
        self.last_mask: list[int] = []
        self.audit_s = 0.0

    # -- device-step side ------------------------------------------------

    def maybe_audit(self, tick_index: int) -> None:
        """Run the audit if this tick is on the audit cadence. Called from
        PlaneRuntime._device_step AFTER the new state is committed; the
        caller holds state_lock and has the runtime's stream current."""
        if tick_index % self.audit_every:
            return
        rt = self.runtime
        t0 = time.perf_counter()
        if self._mirror is None:
            self._mirror = init_mirror(rt.state)
        mask_dev, counts_dev, self._mirror = audit_plane(rt.state, self._mirror)
        mask = mask_dev.cpu().numpy()
        counts = counts_dev.cpu().numpy()
        # Paged layout: the audit ran over POOLED page rows; the runtime
        # maps the per-page mask to per-room (OR of the room's pages) and
        # folds in its page-table check (BIT_TABLE). Dense runtimes have
        # no mapper — the mask is already per-room.
        mapper = getattr(rt, "map_audit_mask", None)
        if mapper is not None:
            mask = mapper(mask)
        self.audit_s += time.perf_counter() - t0
        self.audits += 1
        self.last_audit_tick = tick_index
        self.last_mask = [int(m) for m in mask]
        if not mask.any():
            # Rooms that audited clean and are out of quarantine have
            # demonstrably recovered; forget their repair attempts.
            for row in list(self._row_attempts):
                if row not in self.quarantined:
                    del self._row_attempts[row]
            return
        self._handle_violations(mask, counts, tick_index)

    def _handle_violations(self, mask: np.ndarray, counts: np.ndarray,
                           tick_index: int) -> None:
        rt = self.runtime
        flagged = [int(r) for r in np.nonzero(mask)[0]]
        for name, n in zip(AUDIT_RULES, counts):
            self.rule_violations[name] += int(n)
        self.violations_total += len(flagged)
        self.log.warn("integrity audit flagged rooms", tick=tick_index, rooms=flagged,
                      mask=[int(mask[r]) for r in flagged])
        # Quarantine first — even when escalating, flagged rooms stop
        # fanning out corrupt media the same tick.
        bb = getattr(rt, "blackbox", None)
        for row in flagged:
            if row not in self.quarantined:
                self.quarantined.add(row)
                self.rows_quarantined += 1
                if bb is not None:
                    bb.emit(row, trace.EV_QUARANTINE, float(tick_index))
                    bb.dump_to(row, "quarantine")
        rt._ctrl_dirty = True
        if self._restore_pending:
            # A full restore is already in flight; what we just audited
            # is the same corruption, pre-restore. The rows stay
            # quarantined — don't burn repair attempts or escalate again.
            return
        if len(flagged) > self.storm_threshold:
            self._escalate(f"integrity storm: {len(flagged)} rooms flagged at tick {tick_index}")
            return
        for row in flagged:
            attempts = self._row_attempts.get(row, 0) + 1
            self._row_attempts[row] = attempts
            if attempts > self.max_row_repairs:
                self._escalate(f"room {row} still corrupt after {attempts - 1} row repairs")
                return
            self._pending_repair.add(row)

    def _escalate(self, reason: str) -> None:
        rt = self.runtime
        if self._restore_pending or self._escalated_epoch == rt.run_epoch:
            return  # one full restart per plane epoch / in-flight restore
        self._escalated_epoch = rt.run_epoch
        self.escalations += 1
        self._pending_repair.clear()
        bb = getattr(rt, "blackbox", None)
        if bb is not None:
            bb.emit(bb.NODE, trace.EV_ESCALATE, float(self.escalations))
            bb.dump_to(bb.NODE, "integrity_escalation")
        self.log.error("integrity escalation: full restart requested", reason=reason)
        if self.escalate_cb is not None:
            self.escalate_cb(reason)
            self._restore_pending = True

    # -- event-loop side -------------------------------------------------

    async def process(self) -> None:
        """Drain the repair queue: restore each flagged row from the last
        verified checkpoint. Called from PlaneRuntime._run at the window
        edge (and after _complete on the step_once path), never with
        state_lock already held."""
        if not self._pending_repair:
            return
        rt = self.runtime
        rows = sorted(self._pending_repair)
        self._pending_repair.clear()
        snap = self.snapshot_provider() if self.snapshot_provider else None
        bb = getattr(rt, "blackbox", None)
        for row in rows:
            if row not in self.quarantined:
                continue
            if snap is None:
                self.repair_failures += 1
                self._escalate(f"room {row} corrupt and no verified checkpoint to repair from")
                return
            try:
                row_snap = rt.row_snapshot_from_full(snap, row)
                async with rt.state_lock:
                    rt.repair_room_row(row, row_snap)
            except (ChecksumError, ValueError, KeyError, IndexError) as e:
                self.repair_failures += 1
                self.log.warn("row repair rejected", room=row, error=str(e))
                if bb is not None:
                    bb.emit(row, trace.EV_REPAIR_FAIL)
                    bb.dump_to(row, "repair_failed")
                self._escalate(f"row repair failed for room {row}: {e}")
                return
            self.quarantined.discard(row)
            # The row's cursors legitimately rewound to checkpoint time;
            # drop the mirror so the next audit re-baselines instead of
            # flagging the rewind.
            self._mirror = None
            rt._ctrl_dirty = True
            self.rows_repaired += 1
            self.log.info("room row repaired from checkpoint", room=row)
            if bb is not None:
                bb.emit(row, trace.EV_REPAIR_OK)
                bb.dump_to(row, "repair_ok")

    # -- restore hooks ---------------------------------------------------

    def on_row_restore(self, row: int) -> None:
        """A row was legitimately rewritten (a room snapshot restored into
        it): clear its quarantine history and re-baseline cursors."""
        self.quarantined.discard(row)
        self._pending_repair.discard(row)
        self._row_attempts.pop(row, None)
        self._mirror = None

    def on_layout_change(self) -> None:
        """The paged runtime applied a page-table delta (alloc / free /
        grow / compaction): page rows changed identity under the audit
        mirror's cursors, so re-baseline instead of flagging relocated
        streams as rewinds."""
        self._mirror = None

    def on_full_restore(self) -> None:
        """The whole plane was restored (supervisor restart)."""
        self.quarantined.clear()
        self._pending_repair.clear()
        self._row_attempts.clear()
        self._mirror = None
        self._restore_pending = False

    # -- introspection ---------------------------------------------------

    def stats_dict(self) -> dict:
        return {
            "audits": self.audits,
            "violations_total": self.violations_total,
            "violations_by_rule": dict(self.rule_violations),
            "rows_quarantined": self.rows_quarantined,
            "rows_repaired": self.rows_repaired,
            "repair_failures": self.repair_failures,
            "escalations": self.escalations,
            "quarantined_rows": sorted(self.quarantined),
            "audit_every_ticks": self.audit_every,
            "last_audit_tick": self.last_audit_tick,
            "audit_s": self.audit_s,
        }
