"""The tick loop: control mutations in, device step, outputs fanned out.

Port of the JAX package's runtime/plane_runtime.py, cut to the dense
single-device path. Per tick:

  1. stage host ingest (IngestBuffer.drain) and pack the device inputs
     into ONE flat int32 buffer;
  2. upload dirty control rows (or the full mirrors) into the state's
     meta/ctrl tensors in place;
  3. the device step: one host→device copy of the packed inputs, the
     tick (models/plane.media_plane_tick), one device→host copy of the
     flat output buffer;
  4. fan out: host munging of the bit-packed masks into egress columns,
     speakers, keyframe requests, congestion → registered callbacks.

The serving loop (`start` → `_run` → `stop`) pipelines three stages
within one tick window: stage N+1 ‖ device N ‖ fan-out N-1; `step_once`
runs one tick sequentially (tests, warm-up) and refuses to run while the
loop does.

The device layout is behind five seams (`_init_device_state`,
`_init_step`, `_pack_inputs`, `_unpack_outputs`, `_sel_mirror`) plus
`_tick_rec_extras`; runtime/paged_runtime.py overrides them to run the
pooled paged plane under the same host side, which speaks LOGICAL dense
[R, T, S] shapes throughout.

The runtime owns the sharded egress plane (runtime/egress_plane.py): its
room plan shards the native munge walk here, and the UDP transport
routes each tick's sends through it.

The failure and overload plane hooks in here as in the reference: the
governor's shed overlay (`set_shed`, `_effective_ctrl`, which the ctrl
upload ships in place of the raw mirrors) and its per-tick sensor feed
(`_complete`); the integrity audit after the commit in `_device_step`,
the quarantine mask at fan-out and the row repairs at the window edge;
the fault injector's stall and bitflip seams; the supervisor's
`run_epoch` guard; and checkpoint/resume — `snapshot`/`restore` and the
room-row forms — carrying state in the reference's leaf order, so frames
cross between the two packages.

State is written in place (the ctrl upload, the paged tick's scatters),
so a device step works on the state it found when it started, and every
full restore binds freshly allocated tensors: a step a supervisor
restart abandoned cannot reach what the restarted loop uses.

The express lane (runtime/express.py; `express_max_subs` > 0) hooks in
as in the reference: its tier boundary runs in `_stage_host` right
before the drain, the device step posts it the selector mirror after
the commit, and the fan-out clears the express rooms' fast-path
subscriber bits and records the window's express sends in the replay
ring. The mirror is posted under the commit lock and only while the
step's run is current, like the audit: a step a restart left behind
never hands the lane a mirror of the state it abandoned.

Room shards (`mesh=`, parallel/mesh.py), as the reference's mesh: the
state is split over the mesh's devices by room, each tick packs one wire
per shard and steps every shard (`make_sharded_tick`), and the outputs
join in room order. Ctrl deltas and row writes land on the shard that
owns the row, in place; snapshots, the express mirror and the audit read
every shard; a full restore binds fresh tensors on every shard.

Not carried yet (see ROADMAP.md): pinned host buffers and graph capture
of the tick, and the compile ledger.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import io
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

import numpy as np
import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.models import plane
from livekit_server_tpu_torch.ops import audio as audio_ops, bwe as bwe_ops
from livekit_server_tpu_torch.parallel import mesh as mesh_mod
from livekit_server_tpu_torch.runtime import trace as trace_mod
from livekit_server_tpu_torch.runtime.egress_plane import EgressPlane
from livekit_server_tpu_torch.runtime.ingest import (
    IngestBuffer,
    PacketIn,
    packet_at,
    row_fields,
)
from livekit_server_tpu_torch.runtime.munge import HostMunger
from livekit_server_tpu_torch.runtime.probe import PAD_BYTES, ProbeController
from livekit_server_tpu_torch.runtime.slots import SlotAllocator
from livekit_server_tpu_torch.utils import checksum


@dataclass
class EgressPacket:
    """One packet to deliver to one subscriber (host egress unit)."""

    room: int
    track: int
    sub: int
    sn: int
    ts: int
    pid: int
    tl0: int
    keyidx: int
    size: int
    payload: bytes
    marker: bool = False
    padding: bool = False  # probe padding (RTP P-bit; no media payload)
    dd: bytes = b""       # dependency-descriptor ext bytes (SVC tracks)
    t_arr: float = 0.0    # rx stamp (forward-latency probe; 0 = unstamped)


@dataclass
class EgressBatch:
    """One tick's egress as column arrays, [N] over egress entries;
    payload bytes stay in the ingest slab."""

    rooms: np.ndarray     # int32
    tracks: np.ndarray    # int32
    ks: np.ndarray        # int32 — packet slot within the tick
    subs: np.ndarray      # int32
    sn: np.ndarray        # int32 (16-bit munged)
    ts: np.ndarray        # int32 (32-bit munged, two's complement)
    pid: np.ndarray       # int32
    tl0: np.ndarray       # int32
    keyidx: np.ndarray    # int32
    payloads: Any         # PayloadSlab
    # Attribution stamps (runtime/trace.py LatencyAttribution): when the
    # owning tick was dispatched to the device and when its step
    # committed. 0.0 = unstamped (tracing off, tests).
    t_dispatch: float = 0.0
    t_device_end: float = 0.0

    def __len__(self) -> int:
        return len(self.rooms)

    def to_packets(self, mask: np.ndarray | None = None) -> list[EgressPacket]:
        """Materialize EgressPacket objects (WS delivery, TCP fallback,
        tests); `mask` selects a subset of entries."""
        idx = np.nonzero(mask)[0] if mask is not None else range(len(self.rooms))
        ta = self.payloads.t_arr
        out = []
        for i in idx:
            r, t, k = int(self.rooms[i]), int(self.tracks[i]), int(self.ks[i])
            payload, marker = self.payloads.get(r, t, k)
            out.append(EgressPacket(
                room=r, track=t, sub=int(self.subs[i]),
                sn=int(self.sn[i]) & 0xFFFF, ts=int(self.ts[i]) & 0xFFFFFFFF,
                pid=int(self.pid[i]), tl0=int(self.tl0[i]),
                keyidx=int(self.keyidx[i]), size=len(payload), payload=payload,
                marker=marker, dd=self.payloads.get_dd(r, t, k),
                t_arr=float(ta[r, t, k]) if ta is not None else 0.0,
            ))
        return out


class HostSequencer:
    """Host-side NACK/RTX replay ring (pkg/sfu/sequencer.go:82-370 seat):
    one ring per (room, sub), slot = munged SN & (RING-1), replays
    RTT-throttled per slot and bounded per resolve and per second."""

    RING = 512
    BURST_CAP = 16
    BUDGET_PER_S = 256

    def __init__(self, dims: plane.PlaneDims):
        R, S = dims.rooms, dims.subs
        self._tk = dims.tracks * dims.pkts
        self._k = dims.pkts
        self._s = S
        self.budget = np.full((R, S), self.BUDGET_PER_S, np.int32)
        self._budget_refill_ms = np.zeros((R, S), np.int64)
        shape = (R, S, self.RING)
        self.key = np.full(shape, -1, np.int32)
        self.sn = np.full(shape, -1, np.int32)
        self.track = np.full(shape, -1, np.int32)
        self.ts = np.zeros(shape, np.int64)
        self.pid = np.zeros(shape, np.int32)
        self.tl0 = np.zeros(shape, np.int32)
        self.keyidx = np.zeros(shape, np.int32)
        self.at_tick = np.full(shape, -(1 << 30), np.int64)
        self.last_ms = np.full(shape, -(1 << 60), np.int64)

    def record(self, batch: EgressBatch, tick_idx: int) -> None:
        """Vectorized ring update from one tick's egress batch
        (last write wins on duplicate slots)."""
        if not len(batch):
            return
        slot = batch.sn & (self.RING - 1)
        w = tick_idx % plane.SLAB_WINDOW
        flat = (batch.rooms.astype(np.int64) * self._s + batch.subs) * self.RING + slot
        self.key.reshape(-1)[flat] = w * self._tk + batch.tracks * self._k + batch.ks
        self.sn.reshape(-1)[flat] = batch.sn & 0xFFFF
        self.track.reshape(-1)[flat] = batch.tracks
        self.ts.reshape(-1)[flat] = batch.ts.astype(np.int64) & 0xFFFFFFFF
        self.pid.reshape(-1)[flat] = batch.pid
        self.tl0.reshape(-1)[flat] = batch.tl0
        self.keyidx.reshape(-1)[flat] = batch.keyidx
        self.at_tick.reshape(-1)[flat] = tick_idx

    def clear_room(self, room: int) -> None:
        self.sn[room] = -1
        self.key[room] = -1
        self.track[room] = -1
        self.budget[room] = self.BUDGET_PER_S
        self._budget_refill_ms[room] = 0
        self.last_ms[room] = -(1 << 60)


@dataclass
class TickResult:
    """Host-visible outputs of one tick."""

    tick_index: int
    egress_batch: EgressBatch
    speakers: dict[int, list[tuple[int, float]]]     # room → [(track, level)]
    need_keyframe: list[tuple[int, int, int]]        # (room, track, sub)
    congested: dict[int, list[int]]                  # room → [sub]
    fwd_packets: int
    fwd_bytes: int
    tick_s: float
    padding: list[EgressPacket] = field(default_factory=list)
    outputs: Any = None            # the tick's TickOutputs (numpy)
    # Quality / stats views of the outputs that the rooms and telemetry
    # read, indexed by room row (the rest are in `outputs`).
    track_quality: Any = None     # [R, T] int32 ConnectionQuality enum
    track_mos: Any = None         # [R, T] float32
    sub_quality: Any = None       # [R, S] int32
    track_loss_pct: Any = None    # [R, T] float32
    track_jitter_ms: Any = None   # [R, T] float32
    target_layers: Any = None     # [R, S, T] int32 (-1 = paused)
    track_bps: Any = None         # [R, T] float32
    # RED plan (ops/red): per-packet redundancy candidates for the host
    # egress to assemble (redreceiver.go seat).
    red_sn: Any = None            # [R, T, K, D] int32
    red_off: Any = None           # [R, T, K, D] int32
    red_ok: Any = None            # [R, T, K, D] bool
    pacer_allowed: Any = None     # [R, S] float32 — leaky-bucket byte budgets
    quality_window_closed: bool = False
    _egress_cache: list[EgressPacket] | None = None

    @property
    def egress(self) -> list[EgressPacket]:
        """Lazy object view of egress_batch (WS fan-out, tests)."""
        if self._egress_cache is None:
            self._egress_cache = self.egress_batch.to_packets()
        return self._egress_cache


@dataclass
class StagedTick:
    """One tick's host-staged inputs, carried through the three-stage
    pipeline (stage N+1 ‖ device N ‖ fan-out N-1) with its per-stage
    timings. `wire` is the packed device input, a buffer of its own: the
    ingest staging set it was packed from is free again as soon as
    `_stage_host` returns, whatever the device copy is doing."""

    inp: plane.TickInputs
    payloads: Any
    idx: int
    roll: bool
    wire: np.ndarray | None = None   # the packed device inputs, one buffer
    stage_s: float = 0.0
    device_s: float = 0.0
    kernel_s: float = 0.0            # paged live path: phase-0 kernel span
    kernel_steps: int = 0            # paged live path: kernel blocks launched
    edge: float = 0.0      # scheduled dispatch edge (perf_counter)
    deadline: float = 0.0  # owning-tick egress deadline; 0 = unaccounted
    depth: int = 0         # pipeline depth this tick ran at
    edge_over_us: float = 0.0  # wake overshoot past the dispatch edge
    # Express-lane handoff (runtime/express.py): rooms whose fast-path
    # subscribers were already served on arrival during this tick's
    # window (their bits are masked at fan-out), the packed sub-bit
    # words to clear, and the window's send log for the replay ring.
    express_rows: Any = None
    express_words: Any = None
    express_log: Any = None
    # Span start stamps for the trace ring: staging start, the express
    # retier's slice of it, the ctrl-upload window and the device
    # dispatch time.
    stage_t0: float = 0.0
    retier_s: float = 0.0
    upload_t0: float = 0.0
    upload_s: float = 0.0
    device_t0: float = 0.0


class PlaneRuntime:
    """Owns the device plane state + the host mirrors and tick loop."""

    def __init__(self, dims: plane.PlaneDims, tick_ms: int = 10,
                 audio_params=None, bwe_params=None, red_enabled: bool = True,
                 low_latency: bool = False, trace_enabled: bool = True,
                 trace_ring_ticks: int = 512, trace_sample_every: int = 64,
                 blackbox_events: int = 64, egress_shards: int = 0,
                 egress_multicast: bool = True, express_max_subs: int = 0,
                 express_max_rooms: int = 16, device="cuda", mesh=None):
        # Room shards over the mesh's devices (None: one device). The
        # runtime's own device (its stream, host-side consumers) is then
        # the mesh's first.
        self._mesh = mesh
        self.device = resolve(device) if mesh is None else mesh.devices[0]
        # The ctrl upload (event-loop thread) and the device step (the
        # executor's thread) both enqueue on this one stream, in the order
        # state_lock admits them; a per-thread current stream cannot split
        # them.
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.dims = dims
        self.tick_ms = tick_ms
        self.red_enabled = red_enabled
        # low_latency: complete each tick's egress before the next tick
        # starts (about one tick less forward latency) instead of
        # overlapping it with the next device step.
        self.low_latency = low_latency
        self.slots = SlotAllocator(dims.rooms, dims.tracks, dims.subs)
        self.ingest = IngestBuffer(dims, tick_ms)
        self.tick_index = 0
        # Index of the newest tick whose fan-out has run (-1: none yet);
        # `settle_staged` waits on it.
        self.completed_tick = -1
        # The serving loop's staged tick, not yet dispatched (None when
        # there is none); `extract_staged_row` takes a row's packets out.
        self._staged: StagedTick | None = None
        self._ap = audio_params or audio_ops.AudioLevelParams()
        self._bp = bwe_params or bwe_ops.BWEParams()

        R, T, S = dims.rooms, dims.tracks, dims.subs
        # Host mirrors of the control tensors; mutated by the control
        # plane, uploaded at tick boundaries when dirty.
        self.meta = plane.TrackMeta(
            is_video=np.zeros((R, T), bool),
            published=np.zeros((R, T), bool),
            pub_muted=np.zeros((R, T), bool),
            is_svc=np.zeros((R, T), bool),
        )
        self.ctrl = plane.SubControl(
            subscribed=np.zeros((R, T, S), bool),
            sub_muted=np.zeros((R, T, S), bool),
            max_spatial=np.full((R, T, S), plane.MAX_LAYERS - 1, np.int32),
            max_temporal=np.full((R, T, S), 3, np.int32),
        )
        self._ctrl_dirty = True          # full upload needed
        self._dirty_rows: set[int] = set()
        self.ctrl_delta_max_rows = max(1, dims.rooms // 8)
        # Governor shed overlay (runtime/governor.py): applied to the
        # EFFECTIVE control tensors at upload time, never written into
        # the authoritative `self.ctrl` mirrors — snapshots, restores and
        # recovery all keep every subscriber's true desired caps, and
        # un-shedding is just a re-upload.
        self.shed_spatial_cap = plane.MAX_LAYERS - 1   # no clamp
        self.shed_pause_video = False
        # Subscriptions exempt from the L3 video pause (screen shares,
        # active-speaker pins via update_track_settings).
        self.pinned = np.zeros((R, T, S), bool)
        # Optional OverloadGovernor; None unless RoomManager attaches
        # one. _complete feeds it each finished tick's verdict.
        self.governor = None
        # Bumped by PlaneSupervisor on restart (`bump_epoch`): a device step
        # that started before the bump must not commit its result over
        # restored state (the stale step ran — or is still wedged — on the
        # abandoned executor thread), and the loop's cancel path leaves it
        # there. The step's epoch check and its commit hold _commit_lock,
        # as the bump does, so no step commits after a bump returned.
        self.run_epoch = 0
        self._commit_lock = threading.Lock()
        # Optional FaultInjector (runtime/faultinject.py); None on the
        # default config path.
        self.fault = None
        # Optional IntegrityMonitor (runtime/integrity.py); None unless
        # RoomManager attaches one. _device_step runs its audit on the
        # cadence; the loop drains its row-repair queue; quarantined rows
        # are masked at fan-out and muted in the effective ctrl.
        self.integrity = None

        self.state = self._init_device_state()
        self._init_step()
        self.munger = HostMunger(dims)
        # Two-tier latency plane (runtime/express.py): small rooms forward
        # on packet arrival against the last device selector mirror
        # instead of waiting for the batched tick. None when
        # express_max_subs == 0 (the default).
        self.express = None
        if express_max_subs > 0:
            from livekit_server_tpu_torch.runtime.express import ExpressLane

            self.express = ExpressLane(self, express_max_subs, express_max_rooms)
        # Sharded native egress plane: one instance plans the room-aligned
        # shard cuts of both the munge walk (_fan_out) and the send walk
        # (the UDP transport attaches it) and aggregates per-shard stats.
        self.egress_plane = EgressPlane(egress_shards, egress_multicast)
        self._munge_shard_plan = self.egress_plane.room_plan(dims.rooms)
        self._slab_history: list = [None] * plane.SLAB_WINDOW
        self.host_seq = HostSequencer(dims)
        self.prober = ProbeController(dims, tick_ms)
        self._last_committed = np.zeros((R, S), np.float32)
        self._last_congested = np.zeros((R, S), bool)
        self._last_deficient = np.zeros((R, S), bool)
        self._task: asyncio.Task | None = None
        self._complete_task: asyncio.Task | None = None
        # Guards self.state across the device step (run in the worker
        # thread) vs. other coroutines touching it.
        self.state_lock = asyncio.Lock()
        self._on_tick: list[Callable[[TickResult], Awaitable[None] | None]] = []
        self.stats = {
            "ticks": 0, "fwd_packets": 0, "fwd_bytes": 0, "late_ticks": 0,
            # Pipeline shape: cumulative per-stage seconds + stall count
            # (a window that found the previous fan-out still running).
            "stage_s": 0.0, "device_s": 0.0, "fanout_s": 0.0,
            "pipeline_stalls": 0,
            "ctrl_full_uploads": 0, "ctrl_delta_uploads": 0,
            "ctrl_delta_rows": 0, "ctrl_upload_bytes": 0,
            # Device steps a supervisor restart abandoned (they returned
            # without committing their state).
            "abandoned_steps": 0,
            # Device steps that ran their tick on the card but whose tick
            # never completes: abandoned after the tick ran, or committed
            # just before a restart whose loop dropped their outputs.
            "dropped_steps": 0,
            # The express lane's post-commit selector reads: count and
            # cumulative seconds (each a device read of four [R, T, S]
            # leaves on the runtime's stream).
            "express_mirrors": 0, "express_mirror_s": 0.0,
        }
        self.recent_tick_s: deque = deque(maxlen=120)  # /debug/ticks window
        # Per-tick stage records (idx/depth/stage_ms/device_ms/fanout_ms/
        # total_ms/late + subclass extras), newest last.
        self.recent_ticks: deque = deque(maxlen=120)
        # Tick-edge sleep calibration: measured coarse-sleep overshoot of
        # this host (seconds; < 0 = not yet calibrated) and the last
        # wake's overshoot past its edge.
        self._sleep_bias = -1.0
        self._edge_overshoot_us = 0.0
        # One worker: device steps are strictly ordered.
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="plane")
        # Set by mark_warm: the kernels are built and a tick has run.
        self.warm = False
        # Tick span ring and sampled wire-latency attribution (None when
        # tracing is off); the per-room black box is always on.
        self.trace = None
        self.wire_stages = None
        if trace_enabled:
            self.trace = trace_mod.TickTraceRing(trace_ring_ticks)
            self.wire_stages = trace_mod.LatencyAttribution(trace_sample_every)
        self.blackbox = trace_mod.BlackBox(R, blackbox_events)

    # -- device-layout seams (overridden by PagedPlaneRuntime) ------------

    def _init_device_state(self) -> plane.PlaneState:
        """Allocate the device plane state (dense layout; on the host
        when `_init_step` shards it over a mesh)."""
        return plane.init_state(self.dims, device="cpu" if self._mesh else self.device)

    def _init_step(self) -> None:
        """Bind the device step: (state, wire) → (state', flat numpy
        output buffer); on a mesh, (sharded state, one wire per shard) →
        (state', one buffer per shard). The meshed step returns a new
        state, committed like the unsharded one (a step a restart
        abandoned never wrote the committed tensors)."""
        if self._mesh is not None:
            self.state = mesh_mod.shard_tree(self.state, self._mesh)
            tick = mesh_mod.make_sharded_tick(self._mesh, self._ap, self._bp, donate=False,
                                              red_enabled=self.red_enabled)
            self._step = functools.partial(tick.device_step, dims=self.dims)
            return
        self._step = functools.partial(
            plane.device_step, dims=self.dims, audio_params=self._ap,
            bwe_params=self._bp, red_enabled=self.red_enabled,
        )

    def _pack_inputs(self, inp: plane.TickInputs):
        """Logical numpy TickInputs → the device step's one upload buffer
        (one per shard on a mesh)."""
        if self._mesh is not None:
            return mesh_mod.shard_wires(plane.pack_tick_inputs(inp), self._mesh)
        return plane.wire_inputs(plane.pack_tick_inputs(inp))

    def _unpack_outputs(self, buf) -> plane.TickOutputs:
        """The device step's output buffer(s) → LOGICAL-shape TickOutputs."""
        if self._mesh is not None:
            return mesh_mod.join_outputs(buf, self.dims, self.red_enabled)
        return plane.unpack_tick_outputs(buf, self.dims, self.red_enabled)

    def _sel_mirror(self, state) -> tuple:
        """The selector state in LOGICAL [R, T, S] shape: (current_spatial,
        current_temporal, target_spatial, target_temporal) numpy arrays."""
        if self._mesh is not None:
            return tuple(x.numpy() for x in mesh_mod.gather_tree(state.map(lambda s: s.sel)))
        return tuple(x.cpu().numpy() for x in state.sel)

    def _state_tree(self) -> plane.PlaneState:
        """A tree of the state's structure (a shard's, on a mesh)."""
        return self.state.shards[0] if self._mesh is not None else self.state

    def _host_state(self) -> plane.PlaneState:
        """The whole state; on a mesh, its shards joined on the host."""
        return mesh_mod.gather_tree(self.state) if self._mesh is not None else self.state

    def _tick_rec_extras(self, st: StagedTick) -> dict:
        """Extra fields for this tick's `recent_ticks` record; the paged
        runtime adds the kernel span and the live-page fraction."""
        return {}

    def _on_stream(self):
        """Enqueue on the runtime's stream (no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def occupancy(self) -> dict:
        """Per-resource occupancy (rooms/tracks/subs used vs pool) for
        admission gating and /debug; `admittable_rooms` is how many more
        minimal rooms this plane could accept."""
        return self.slots.occupancy()

    # -- control-plane mutation API (host mirrors; applied at tick edge) --
    def set_track(self, room: int, track: int, *, published: bool, is_video: bool,
                  pub_muted: bool = False, is_svc: bool = False,
                  pub_sub: int | None = None) -> None:
        self.meta.published[room, track] = published
        self.meta.is_video[room, track] = is_video
        self.meta.pub_muted[room, track] = pub_muted
        self.meta.is_svc[room, track] = is_svc
        if pub_sub is not None:
            self.ingest.track_pub_sub[room, track] = pub_sub
        if not published:
            self.ctrl.subscribed[room, track, :] = False
            self.ingest.track_pub_sub[room, track] = -1
        self._dirty_rows.add(room)

    def set_subscription(self, room: int, track: int, sub: int, *,
                         subscribed: bool, sub_muted: bool = False) -> None:
        self.ctrl.subscribed[room, track, sub] = subscribed
        self.ctrl.sub_muted[room, track, sub] = sub_muted
        self._dirty_rows.add(room)

    def set_layer_caps(self, room: int, track: int, sub: int,
                       max_spatial: int, max_temporal: int = 3) -> None:
        self.ctrl.max_spatial[room, track, sub] = max_spatial
        self.ctrl.max_temporal[room, track, sub] = max_temporal
        self._dirty_rows.add(room)

    def bump_epoch(self) -> None:
        """Invalidate the device step in flight (a supervisor restart):
        once this returns, no step that started before it commits."""
        with self._commit_lock:
            self.run_epoch += 1

    def set_pinned(self, room: int, track: int, sub: int, pinned: bool) -> None:
        """Exempt one subscription from the governor's L3 video pause
        (screen shares, active speakers). Dirty-row like any ctrl edit:
        the pin participates in the effective upload."""
        self.pinned[room, track, sub] = pinned
        self._dirty_rows.add(room)

    def set_shed(self, *, spatial_cap: int | None = None,
                 pause_video: bool | None = None) -> None:
        """Governor actuator: set the shed overlay. A change forces a
        full ctrl upload at the next tick edge — transitions are rare
        (ladder moves), so the O(R·T·S) copy is fine; the authoritative
        mirrors stay untouched."""
        changed = False
        if spatial_cap is not None and spatial_cap != self.shed_spatial_cap:
            self.shed_spatial_cap = int(spatial_cap)
            changed = True
        if pause_video is not None and pause_video != self.shed_pause_video:
            self.shed_pause_video = bool(pause_video)
            changed = True
        if changed:
            self._ctrl_dirty = True

    def _effective_ctrl(self) -> plane.SubControl:
        """The SubControl actually uploaded: desired caps with the shed
        overlay applied (spatial clamp; L3 mutes non-pinned video subs)
        and integrity-quarantined rooms fully muted. Reads only host
        mirrors — callable without the state lock."""
        cap = self.shed_spatial_cap
        quarantined = self.integrity.quarantined if self.integrity is not None else None
        if cap >= plane.MAX_LAYERS - 1 and not self.shed_pause_video and not quarantined:
            return self.ctrl
        sub_muted = self.ctrl.sub_muted
        if self.shed_pause_video:
            vid = (self.meta.is_video & self.meta.published)[:, :, None]
            sub_muted = sub_muted | (vid & ~self.pinned)
        if quarantined:
            # Quarantine mutes the WHOLE flagged room row (its state is
            # suspect end to end); other rooms keep full audio + video.
            qmask = np.zeros_like(self.ctrl.sub_muted)
            qmask[sorted(quarantined)] = True
            sub_muted = sub_muted | qmask
        return plane.SubControl(
            subscribed=self.ctrl.subscribed,
            sub_muted=sub_muted,
            max_spatial=np.minimum(self.ctrl.max_spatial, cap),
            max_temporal=self.ctrl.max_temporal,
        )

    def set_express_pin(self, room: int, pin: bool | None) -> None:
        """Pin one room's latency tier: True = express lane, False =
        batched tick, None = automatic (subscriber-count eligibility).
        No-op when the express lane is off. Takes effect at the next
        tick boundary."""
        if self.express is not None:
            self.express.set_pin(room, pin)

    def clear_room(self, room: int) -> None:
        self.meta.published[room, :] = False
        self.meta.pub_muted[room, :] = False
        self.ctrl.subscribed[room, :, :] = False
        self.ingest.track_pub_sub[room, :] = -1
        self.ingest.fb_enabled[room, :] = False
        self.ingest.sub_reset[room, :] = True  # next tenant: fresh BWE state
        self.host_seq.clear_room(room)
        self.munger.clear_room(room)
        if self.express is not None:
            # Tier state (pin, activation, selector mirror) must not leak
            # into the next tenant or past a migration snapshot.
            self.express.clear_room(room)
        self._dirty_rows.add(room)

    def on_tick(self, cb: Callable[[TickResult], Awaitable[None] | None]) -> None:
        self._on_tick.append(cb)

    # -- tick ------------------------------------------------------------
    def _upload_ctrl(self) -> None:
        """Ship pending host-mirror control mutations to the device: the
        dirtied room rows (O(dirty rows) bytes), or the full mirrors when
        the full flag is set or too many rows are dirty, with the shed and
        quarantine overlay applied (`_effective_ctrl`). Writes into the
        state's tensors in place. Caller holds state_lock; reached through
        `_upload`."""
        rows = self._dirty_rows
        if not self._ctrl_dirty and not rows:
            return
        ctrl = self._effective_ctrl()
        if self._ctrl_dirty or len(rows) > self.ctrl_delta_max_rows:
            if self._mesh is None:
                pairs = [(self.state, (0, self.dims.rooms))]
            else:
                pairs = zip(self.state.shards,
                            mesh_mod.room_sharding(self._mesh, self.dims.rooms))
            for state, (a, b) in pairs:
                for dst, src in zip((*state.meta, *state.ctrl), (*self.meta, *ctrl)):
                    dst.copy_(torch.from_numpy(src[a:b]))
            self.stats["ctrl_full_uploads"] += 1
        else:
            r, meta_rows, ctrl_rows = plane.pack_ctrl_rows(self.meta, ctrl, rows)
            if self._mesh is None:
                plane.apply_ctrl_delta(self.state, r, meta_rows, ctrl_rows)
            else:
                # Each dirtied row lands on the shard that owns it.
                for i, pos, local in mesh_mod.split_rows(self._mesh, self.dims.rooms, r):
                    plane.apply_ctrl_delta(self.state.shards[i], local,
                                           meta_rows[:, pos], ctrl_rows[:, pos])
            self.stats["ctrl_delta_uploads"] += 1
            self.stats["ctrl_delta_rows"] += len(rows)
            self.stats["ctrl_upload_bytes"] += meta_rows.nbytes + ctrl_rows.nbytes
        self._dirty_rows = set()
        self._ctrl_dirty = False

    def _upload(self, st: StagedTick) -> None:
        """The ctrl upload of `st`'s dispatch, timed, on the runtime's
        stream. Caller holds state_lock (event-loop thread)."""
        st.upload_t0 = time.perf_counter()
        with self._on_stream():
            self._upload_ctrl()
        st.upload_s = time.perf_counter() - st.upload_t0

    def _device_step(self, st: StagedTick) -> plane.TickOutputs | None:
        """The device round trip: one upload of the packed inputs, the
        tick, one fetch of the flat output buffer (the fetch waits for the
        device), then the integrity audit of the committed state on its
        cadence. Caller holds state_lock; runs on the executor's thread.
        The upload reads `st.wire`, which no staging set aliases.

        Returns None (instead of outputs) when a supervisor restart
        abandoned this step mid-flight: the epoch check straddles the
        injected stall, and the step works on the state it found at its
        start, so a woken stale thread never touches — or commits over, or
        audits — the state the restart restored."""
        epoch = self.run_epoch
        state = self.state
        t0 = time.perf_counter()
        st.device_t0 = t0
        if self.fault is not None:
            self.fault.maybe_stall()
        if epoch != self.run_epoch:
            self.stats["abandoned_steps"] += 1
            return None
        with self._on_stream():
            if self.fault is not None:
                self.fault.maybe_bitflip(state, st.idx)
            state, buf = self._step(state, st.wire)
            with self._commit_lock:
                if epoch != self.run_epoch:
                    self.stats["abandoned_steps"] += 1
                    self.stats["dropped_steps"] += 1
                    return None  # restarted mid-step: the result belongs to a dead run
                self.state = state
            out = self._unpack_outputs(buf)
            if self.express is not None and self.express.wants_mirror():
                # The express lane's selector mirror of the committed
                # state, consumed at the next retier (decisions made from
                # it are at most one tick stale). Posted under the commit
                # lock, and only while this step's run is current.
                m0 = time.perf_counter()
                mirror = self._sel_mirror(state)
                with self._commit_lock:
                    if epoch == self.run_epoch:
                        self.express.post_mirror(*mirror)
                self.stats["express_mirrors"] += 1
                self.stats["express_mirror_s"] += time.perf_counter() - m0
            if self.integrity is not None:
                # Audit the committed state on the cadence; the fetched
                # mask is a few dozen bytes. Under the commit lock, and
                # only while this step's run is current: a restart's bump
                # waits for an audit in progress, and a step it left
                # behind never audits (its quarantines would land on the
                # restored plane).
                with self._commit_lock:
                    if epoch == self.run_epoch:
                        self.integrity.maybe_audit(st.idx)
        st.device_s = time.perf_counter() - t0
        return out

    def _stage_host(self) -> StagedTick:
        """Claim a tick index, drain the ingest buffer, pack the device
        inputs into a fresh wire buffer. Touches host-owned state only, so
        it needs no lock and overlaps an in-flight device step: the drain
        flips to the other staging set, and the packing consumes the
        retired set's field views before that set can be drained again."""
        t0 = time.perf_counter()
        idx = self.tick_index
        self.tick_index += 1
        # Close the quality/stats window about once per second.
        q_ticks = max(1, 1000 // self.tick_ms)
        roll = (idx + 1) % q_ticks == 0
        ex_rows = ex_words = ex_log = None
        retier_s = 0.0
        if self.express is not None:
            # Tier boundary, in the same event-loop slice as the drain
            # (atomic with respect to arrivals and migration freezes):
            # close the ending window, re-tier, and take over the closing
            # window for freshly promoted rooms. Returns the rooms whose
            # fast-path subscriber bits this tick's fan-out must skip.
            r0 = time.perf_counter()
            ex_rows, ex_words, ex_log = self.express.tick_boundary(self.ingest)
            retier_s = time.perf_counter() - r0
        inp, payloads = self.ingest.drain(roll_quality=roll, tick_index=idx)
        self._slab_history[idx % plane.SLAB_WINDOW] = payloads
        wire = self._pack_inputs(inp)
        st = StagedTick(inp=inp, payloads=payloads, idx=idx, roll=roll, wire=wire,
                        express_rows=ex_rows, express_words=ex_words,
                        express_log=ex_log)
        st.stage_t0 = t0
        st.retier_s = retier_s
        st.stage_s = time.perf_counter() - t0
        return st

    def _schedule_probe(self, st: StagedTick) -> None:
        """Probe scheduling (probe_controller.go) against the previous
        tick's outputs; padding rides the first live video track each
        subscriber is subscribed to. pad_num/pad_track are host-only."""
        vid = self.meta.is_video & self.meta.published & ~self.meta.pub_muted
        cand = vid[:, :, None] & self.ctrl.subscribed
        pad_track = np.where(cand.any(axis=1), cand.argmax(axis=1), -1).astype(np.int32)
        pad_num = self.prober.update(
            now_ms=st.idx * self.tick_ms,
            committed=self._last_committed,
            congested=self._last_congested,
            deficient=self._last_deficient,
            estimate=np.asarray(st.inp.estimate),
            estimate_valid=np.asarray(st.inp.estimate_valid),
            pad_track=pad_track,
        )
        st.inp = st.inp._replace(pad_num=np.asarray(pad_num, np.int32),
                                 pad_track=pad_track)

    def _mirror_probe_inputs(self, out: plane.TickOutputs) -> None:
        self._last_committed = np.asarray(out.committed_bps)
        self._last_congested = np.asarray(out.congested)
        self._last_deficient = np.asarray(out.deficient)

    async def _complete(self, out: plane.TickOutputs, st: StagedTick) -> TickResult:
        """Host post-step: fan out + callbacks. Per-stage work times sum
        into tick_s, and lateness is judged against the owning tick's
        deadline (dispatch edge + (1 + depth) periods), after the delivery
        callbacks have run."""
        c0 = time.perf_counter()
        result = self._fan_out(
            out, st.payloads, st.inp, 0.0, st.idx,
            express=(st.express_rows, st.express_words, st.express_log),
        )
        fanout_s = time.perf_counter() - c0
        # Attribution stamps for the wire-latency decomposition: the UDP
        # transport reads them off the batch inside the callbacks below.
        result.egress_batch.t_dispatch = st.device_t0
        result.egress_batch.t_device_end = st.device_t0 + st.device_s
        result.tick_s = st.stage_s + st.device_s + fanout_s
        result.quality_window_closed = st.roll
        self.recent_tick_s.append(round(result.tick_s, 5))
        self.stats["ticks"] += 1
        self.completed_tick = max(self.completed_tick, st.idx)
        self.stats["fwd_packets"] += result.fwd_packets
        self.stats["fwd_bytes"] += result.fwd_bytes
        self.stats["stage_s"] += st.stage_s
        self.stats["device_s"] += st.device_s
        self.stats["fanout_s"] += fanout_s
        s0 = time.perf_counter()
        for cb in self._on_tick:
            r = cb(result)
            if asyncio.iscoroutine(r):
                await r
        send_s = time.perf_counter() - s0
        # Egress leaves inside the callbacks, so the deadline check runs
        # after them.
        late = bool(st.deadline) and time.perf_counter() > st.deadline
        if late:
            self.stats["late_ticks"] += 1
        tick_rec = {
            "idx": st.idx, "depth": st.depth,
            "stage_ms": round(st.stage_s * 1000.0, 3),
            "device_ms": round(st.device_s * 1000.0, 3),
            "fanout_ms": round(fanout_s * 1000.0, 3),
            "total_ms": round(result.tick_s * 1000.0, 3),
            "late": late,
            "edge_overshoot_us": round(st.edge_over_us, 1),
            "fwd_packets": result.fwd_packets,
        }
        # Per-shard egress timing: the send callbacks above just ran, so
        # the plane's last-send snapshot is this tick's (munge likewise).
        ep = self.egress_plane
        if ep.last_munge:
            tick_rec["munge_shard_ms"] = ep.last_munge.get("ms")
        if ep.last_send:
            tick_rec["egress_shard_ms"] = [s["ms"] for s in ep.last_send.get("shards", [])]
        tick_rec.update(self._tick_rec_extras(st))
        self.recent_ticks.append(tick_rec)
        if self.trace is not None:
            slot = self.trace.record_tick(
                st.idx, st.edge, st.stage_t0, st.stage_s, st.retier_s,
                st.upload_t0, st.upload_s, st.device_t0, st.device_s,
                c0, fanout_s, send_s, st.edge_over_us, st.depth, late,
                kernel_s=st.kernel_s,
            )
            if ep.last_send:
                shards = ep.last_send.get("shards", ())
                munge_ms = ep.last_munge.get("ms", ()) if ep.last_munge else ()
                for i in range(len(shards)):
                    self.trace.set_shard(
                        slot, i, munge_ms[i] if i < len(munge_ms) else 0.0,
                        shards[i]["ms"],
                    )
        self.stats["sleep_bias_us"] = round(max(self._sleep_bias, 0.0) * 1e6, 1)
        self.stats["edge_overshoot_us"] = round(self._edge_overshoot_us, 1)
        if self.governor is not None:
            # Close the overload loop on the finished tick's verdict.
            self.governor.on_tick(tick_rec)
        return result

    def mark_warm(self) -> None:
        """Record that the kernels are built and the first tick ran (the
        server calls it after its warm step). The port has no compile
        ledger: a CUDA kernel is built once, at its first launch."""
        self.warm = True

    def extract_staged_row(self, row: int) -> list[PacketIn] | None:
        """Take one row's packets out of the serving loop's staged tick
        (drained from ingest, not dispatched yet), in (track, slot) order:
        their valid bits are cleared in the tick's packed device inputs
        and its host inputs, and their rx accounting is reversed, as
        `IngestBuffer.extract_row` does. None when this runtime cannot
        (the caller then settles the staged tick instead). A migration
        freezing a row takes these with the ingest buffer's, so only the
        tick in flight must finish before the snapshot (`settle_staged`).

        The packet fields are read from the packed inputs (and the host-
        only ones from the drain's copies): the staged tick's other field
        views belong to an ingest staging set that may already be
        scrubbed for reuse."""
        st = self._staged
        if st is None:
            return []
        R, T, K, _ = self.dims
        wire, local = st.wire, row
        if self._mesh is not None:
            # The row's shard wire, at the row's local index.
            R //= self._mesh.size
            wire, local = st.wire[row // R], row % R
        F = len(plane.PKT_FIELDS)
        pkt = wire[:F * R * T * K].reshape(F, R, T, K)[:, local:local + 1]
        valid = pkt[plane.PKT_FIELDS.index("valid"), 0]
        tracks, slots = np.nonzero(valid)
        if not len(tracks):
            return []
        inp, ing = st.inp, self.ingest
        cols = row_fields({**dict(zip(plane.PKT_FIELDS, pkt)),
                           **{f: getattr(inp, f)[row:row + 1]
                              for f in plane.HOST_ONLY_PKT_FIELDS}}, 0)
        out = []
        for t, k in zip(tracks.tolist(), slots.tolist()):
            payload, _ = st.payloads.get(row, t, k)
            out.append(packet_at(cols, (t, k), row, t, payload))
            ing.rx_pkts[row, t] -= 1
            ing.rx_bytes[row, t] -= int(cols["size"][t, k])
        valid[:] = 0
        inp.valid[row] = False        # the drain's own copy
        return out

    async def settle_staged(self, timeout_s: float = 5.0, staged: bool = True) -> bool:
        """Wait until every tick staged before this call has run its
        device step and its fan-out (the pipelined loop stages tick N+1
        while step N runs); with `staged` False, only the tick in flight.
        A migration freezes a row, then settles before it snapshots:
        packets the loop had already drained for the row are then in the
        snapshot and went out from this node, instead of entering a step
        after the snapshot, or after the handoff closed the row, where
        they would be lost (it takes the staged tick's packets out with
        `extract_staged_row` when it can, and need not wait for that
        tick). False when `timeout_s` passed first (a step a restart
        abandoned never completes)."""
        target = self.tick_index - 1 - (0 if staged or self._staged is None else 1)
        deadline = time.perf_counter() + timeout_s
        while self.completed_tick < target:
            if time.perf_counter() >= deadline:
                return False
            await asyncio.sleep(self.tick_ms / 4000.0)
        return True

    async def step_once(self) -> TickResult:
        """One sequential tick (tests, warm-up, manual stepping); the
        device round trip runs on the executor's thread so the event loop
        never blocks on the card.

        Refused while the serving loop runs: this path's immediate
        fan-out could land before the loop's deferred fan-out of an
        earlier tick, which would then rewrite munger lanes backwards and
        emit egress out of wire order."""
        if self._task is not None and not self._task.done():
            raise RuntimeError(
                "step_once() while the serving loop is running: its "
                "immediate fan-out would land ahead of the loop's deferred "
                "fan-out of an earlier tick and rewrite munger lanes "
                "backwards (out-of-wire-order egress). Stop the loop first "
                "or consume ticks via on_tick()."
            )
        loop = asyncio.get_running_loop()
        st = self._stage_host()
        self._schedule_probe(st)
        async with self.state_lock:
            self._upload(st)
            out = await loop.run_in_executor(self._executor, self._device_step, st)
        if out is None:
            raise asyncio.CancelledError("device step abandoned by restart")
        self._mirror_probe_inputs(out)
        self.ingest.scrub_retired()
        result = await self._complete(out, st)
        if self.integrity is not None:
            # Sequential path: repair right after the tick that audited.
            await self.integrity.process()
        return result

    def resolve_nacks(self, room: int, sub: int, track: int, sns) -> list[EgressPacket]:
        """NACKed munged SNs → replay EgressPackets, at RTCP time (the
        resolve half of sequencer.go:263). Misses return nothing (the
        client re-NACKs); a hit within one RTT of its last replay is
        throttled."""
        hs = self.host_seq
        now_ms = int(time.monotonic() * 1000)
        if now_ms - int(hs._budget_refill_ms[room, sub]) >= 1000:
            hs.budget[room, sub] = hs.BUDGET_PER_S
            hs._budget_refill_ms[room, sub] = now_ms
        rtt = max(1, int(self.ingest.rtt_ms[room, sub]))
        K = self.dims.pkts
        budget_before = int(hs.budget[room, sub])
        replays: list[EgressPacket] = []
        for sn in sns:
            if len(replays) >= hs.BURST_CAP or hs.budget[room, sub] <= 0:
                break
            sn &= 0xFFFF
            slot = sn & (hs.RING - 1)
            if int(hs.sn[room, sub, slot]) != sn:
                continue
            if int(hs.track[room, sub, slot]) != track:
                continue
            # Age gate: the slab slot recycles after SLAB_WINDOW ticks.
            if self.tick_index - int(hs.at_tick[room, sub, slot]) > plane.SLAB_WINDOW - 2:
                continue
            if now_ms - int(hs.last_ms[room, sub, slot]) < rtt:
                continue
            w, tk = divmod(int(hs.key[room, sub, slot]), hs._tk)
            t, k = divmod(tk, K)
            slab = self._slab_history[w]
            if slab is None:
                continue
            payload, marker = slab.get(room, t, k)
            if not payload:
                continue
            hs.last_ms[room, sub, slot] = now_ms
            hs.budget[room, sub] -= 1
            replays.append(EgressPacket(
                room=room, track=t, sub=sub, sn=sn,
                ts=int(hs.ts[room, sub, slot]) & 0xFFFFFFFF,
                pid=int(hs.pid[room, sub, slot]),
                tl0=int(hs.tl0[room, sub, slot]),
                keyidx=int(hs.keyidx[room, sub, slot]),
                size=len(payload), payload=payload, marker=marker,
                dd=slab.get_dd(room, t, k),
            ))
        if replays:
            self.stats["rtx_packets"] = self.stats.get("rtx_packets", 0) + len(replays)
        if budget_before > 0 and int(hs.budget[room, sub]) <= 0:
            # Replay budget newly exhausted: a NACK storm on this
            # (room, sub) pair. Black-box it and dump the room's recorder.
            self.blackbox.emit(room, trace_mod.EV_NACK_STORM, float(sub), float(len(sns)))
            self.blackbox.dump_to(room, "nack_storm")
        return replays

    def _assemble_padding(self, inp) -> list[EgressPacket]:
        """Probe padding synthesis (the host half of WritePaddingRTP)."""
        pads = self.munger.padding(inp.pad_num, inp.pad_track,
                                   ts_advance=self.tick_ms * 90)
        return [
            EgressPacket(room=r, track=t, sub=s, sn=sn, ts=ts, pid=0, tl0=0,
                         keyidx=0, size=PAD_BYTES, payload=b"", padding=True)
            for (r, t, s, sn, ts) in pads
        ]

    def _fan_out(self, out: plane.TickOutputs, payloads, inp, tick_s: float,
                 tick_idx: int | None = None,
                 express: tuple | None = None) -> TickResult:
        """Bit-packed egress masks → host munge (the native walker, sharded
        by the egress plane's room plan) → column arrays, plus the speaker
        / keyframe / congestion / quality views of the tick's outputs.
        `express` = (rows, words, log) of the express lane's window."""
        send_bits, drop_bits, switch_bits = out.send_bits, out.drop_bits, out.switch_bits
        if self.integrity is not None and self.integrity.quarantined:
            # Same-tick quarantine: a room flagged by THIS tick's audit
            # must not fan out its (suspect) sends even once — the ctrl
            # mute only lands at the next upload edge. Zeroing the row's
            # egress bits also freezes its munger lanes at their last
            # good values.
            rows = [r for r in self.integrity.quarantined if r < send_bits.shape[0]]
            if rows:
                send_bits, drop_bits, switch_bits = (
                    np.array(send_bits), np.array(drop_bits), np.array(switch_bits))
                send_bits[rows] = 0
                drop_bits[rows] = 0
                switch_bits[rows] = 0
        ex_rows, ex_words, ex_log = express if express is not None else (None,) * 3
        if ex_rows is not None and len(ex_rows):
            # Express-handled rooms: their fast-path subscribers were
            # served (and their munger lanes advanced) on arrival during
            # this tick's window, so clear exactly those subscriber bits:
            # the batched walk neither re-sends nor re-advances them.
            # WS/TCP/RED subscribers of the same rooms keep their bits.
            send_bits, drop_bits, switch_bits = (
                np.array(send_bits), np.array(drop_bits), np.array(switch_bits))
            clear = ~ex_words[:, None, None, :]
            send_bits[ex_rows] &= clear
            drop_bits[ex_rows] &= clear
            switch_bits[ex_rows] &= clear
        rr, tt, kk, ss, b_sn, b_ts, b_pid, b_tl0, b_ki = self.munger.apply_columns(
            inp.sn, inp.ts, inp.ts_jump, inp.pid, inp.tl0, inp.keyidx,
            inp.begin_pic, inp.valid, send_bits, drop_bits, switch_bits,
            shard_plan=self._munge_shard_plan,
        )
        if len(self.munger.last_shard_ns):
            self.egress_plane.record_munge(
                self.munger.last_shard_counts, self.munger.last_shard_ns
            )
            self.munger.last_shard_ns = self.munger.last_shard_ns[:0]
        batch = EgressBatch(rooms=rr, tracks=tt, ks=kk, subs=ss, sn=b_sn, ts=b_ts,
                            pid=b_pid, tl0=b_tl0, keyidx=b_ki, payloads=payloads)
        speakers: dict[int, list[tuple[int, float]]] = {}
        lv, tr = out.speaker_levels, out.speaker_tracks
        for r in range(lv.shape[0]):
            row = [(int(tr[r, i]), float(lv[r, i])) for i in range(lv.shape[1])
                   if tr[r, i] >= 0 and lv[r, i] > 0]
            if row:
                speakers[r] = row
        nk = [(int(r), int(t), int(s)) for r, t, s in zip(*np.nonzero(out.need_keyframe))]
        congested: dict[int, list[int]] = {}
        for r, s in zip(*np.nonzero(out.congested)):
            congested.setdefault(int(r), []).append(int(s))
        eff_idx = self.tick_index if tick_idx is None else tick_idx
        self.host_seq.record(batch, eff_idx)
        if ex_log is not None and len(ex_log):
            # Express sends of this window, recorded against the same slab
            # now that it is kept in _slab_history. The drain's reorder
            # pass can permute staging slots within a (room, track) after
            # the log was written, so entries whose slot no longer holds
            # their wire SN are dropped: a replay miss the client
            # re-NACKs, never a wrong payload.
            T, K = self.dims.tracks, self.dims.pkts
            lflat = (ex_log.rooms.astype(np.int64) * T + ex_log.tracks) * K + ex_log.ks
            ok = (np.asarray(inp.sn).reshape(-1)[lflat] & 0xFFFF) == ex_log.orig_sn
            if not ok.all():
                if self.express is not None:
                    self.express.stats["replay_drops"] += int((~ok).sum())
                ex_log = ex_log.take(ok)
            self.host_seq.record(ex_log, eff_idx)
        padding = self._assemble_padding(inp)
        if padding:
            self.stats["pad_packets"] = self.stats.get("pad_packets", 0) + len(padding)
        return TickResult(
            tick_index=eff_idx,
            egress_batch=batch,
            padding=padding,
            speakers=speakers,
            need_keyframe=nk,
            congested=congested,
            fwd_packets=int(out.fwd_packets.sum()),
            fwd_bytes=int(out.fwd_bytes.sum()),
            tick_s=tick_s,
            outputs=out,
            track_quality=out.track_quality,
            track_mos=out.track_mos,
            sub_quality=out.sub_quality,
            track_loss_pct=out.track_loss_pct,
            track_jitter_ms=out.track_jitter_ms,
            track_bps=out.track_bps,
            target_layers=out.target_layers,
            red_sn=out.red_sn,
            red_off=out.red_off,
            red_ok=out.red_ok,
            pacer_allowed=out.pacer_allowed,
        )

    # -- loop ------------------------------------------------------------
    def start(self) -> None:
        if self._task is None:
            self.egress_plane.warm()  # spawn shard workers off the hot path
            self._task = asyncio.ensure_future(self._run())

    async def _calibrate_sleep(self) -> None:
        """Measure this host's asyncio coarse-sleep overshoot once at loop
        start; the median of a short burst (plus a small spin cushion)
        becomes the pre-edge margin `_sleep_until` subtracts before its
        yield-spin tail."""
        if self._sleep_bias >= 0:
            return
        samples = []
        for _ in range(8):
            t0 = time.perf_counter()
            await asyncio.sleep(0.001)
            samples.append(time.perf_counter() - t0 - 0.001)
        self._sleep_bias = min(max(float(np.median(samples)) + 2e-4, 3e-4), 4e-3)

    async def _sleep_until(self, when: float) -> None:
        """Window-edge sleep: a coarse asyncio.sleep to just short of the
        edge, then a yield loop for the tail, so arrival callbacks keep
        running while the dispatch lands close to the edge. The wake
        overshoot is recorded; a coarse sleep that blows through the edge
        widens the margin (EWMA, capped)."""
        bias = self._sleep_bias if self._sleep_bias >= 0 else 0.0015
        delay = when - time.perf_counter() - bias
        if delay > 0:
            await asyncio.sleep(delay)
        while time.perf_counter() < when:
            await asyncio.sleep(0)
        over = time.perf_counter() - when
        self._edge_overshoot_us = over * 1e6
        if over > 2.5e-4 and self._sleep_bias >= 0:
            self._sleep_bias = min(self._sleep_bias + 0.25 * over, 4e-3)

    def _edge(self, st: StagedTick, next_at: float, depth: int, period: float) -> None:
        """Deadline accounting and probe scheduling of a staged tick at
        its dispatch edge."""
        st.depth = depth
        st.edge = next_at
        st.deadline = next_at + (1 + depth) * period
        self._schedule_probe(st)

    async def _run(self) -> None:
        """Three-stage pipelined serving loop: within one tick window,

            stage N+1  ‖  device N  ‖  fan-out N-1

        Tick N, staged during the previous window, is dispatched to the
        executor's thread at the window edge; while the card runs it, the
        event loop stages tick N+1 (ingest drain + input packing, into the
        other ingest staging set) and runs tick N-1's fan-out and egress.

        The completion queue is bounded at 1: if host egress cannot keep
        up, the loop degrades to sequential (counted in pipeline_stalls)
        instead of queueing stale sends, and a stalled device step holds
        the loop at `await fut` with no tick staged past the one already
        prepared, so depth is bounded by construction.

        self.state has one owner: only the ctrl upload and the dispatched
        device step touch it, on one stream, and exactly that span runs
        under state_lock. Staging reads host mirrors only and takes no
        lock."""
        period = self.tick_ms / 1000.0
        await self._calibrate_sleep()
        next_at = time.perf_counter() + period
        loop = asyncio.get_running_loop()
        pending: tuple | None = None   # (out, StagedTick) awaiting fan-out
        pending_task: asyncio.Task | None = None
        staged: StagedTick | None = None  # pre-staged next tick
        depth = 0 if self.low_latency else 1
        try:
            while True:
                if staged is not None:
                    # No device step completes while the loop sleeps, so
                    # the mirrors _schedule_probe reads cannot change.
                    self._edge(staged, next_at, depth, period)
                await self._sleep_until(next_at)
                if self.integrity is not None and self.integrity._pending_repair:
                    # Drain the row-repair queue filled by the last audit,
                    # at the window edge and OUTSIDE the lock region below:
                    # each repair takes state_lock itself, and the
                    # repaired row's dirtied ctrl re-uploads in this tick.
                    await self.integrity.process()
                if pending_task is not None:
                    # Backpressure: the previous fan-out is still running.
                    if not pending_task.done():
                        self.stats["pipeline_stalls"] += 1
                    await asyncio.shield(pending_task)
                    pending_task = self._complete_task = None
                if staged is None:
                    # Cold start, post-resync, or low-latency mode: stage
                    # at the window edge.
                    staged = self._stage_host()
                    self._edge(staged, next_at, depth, period)
                cur, staged = staged, None
                self._staged = None
                cur.edge_over_us = self._edge_overshoot_us
                stopping = False
                epoch = self.run_epoch
                await self.state_lock.acquire()
                try:
                    self._upload(cur)
                    fut = loop.run_in_executor(self._executor, self._device_step, cur)
                    if pending is not None:
                        pending_task = self._complete_task = asyncio.ensure_future(
                            self._complete(pending[0], pending[1]))
                        pending = None
                    if not self.low_latency:
                        # Stage N+1 while device N runs in the worker.
                        staged = self._staged = self._stage_host()
                    # Fan-out N-1 (the task above) and arriving-packet
                    # handlers run on the event loop during this await.
                    try:
                        out = await asyncio.shield(fut)
                    except asyncio.CancelledError:
                        if self.run_epoch != epoch:
                            # A supervisor restart: abandon the step (its
                            # thread may be wedged); it commits nothing,
                            # or committed before the bump and its outputs
                            # go with this loop.
                            fut.add_done_callback(self._count_dropped)
                            raise
                        # Stopping: the step runs on in the worker thread
                        # regardless. Let it finish (under the lock) so its
                        # tick completes in the drain below instead of
                        # vanishing with its launches done.
                        stopping = True
                        out = await fut
                finally:
                    self.state_lock.release()
                if out is None:
                    # Abandoned by a supervisor restart that raced the
                    # step's completion: bail to the drain handler.
                    raise asyncio.CancelledError("device step abandoned by restart")
                self._mirror_probe_inputs(out)
                self.ingest.scrub_retired()
                pending = (out, cur)
                if stopping:
                    raise asyncio.CancelledError
                if self.low_latency:
                    # Fan out this tick now; `pending` is cleared before
                    # the await so a cancellation inside _complete cannot
                    # make the drain below run the same tick twice.
                    to_complete, pending = pending, None
                    await self._complete(to_complete[0], to_complete[1])
                next_at += period
                if next_at < time.perf_counter() - 5 * period:
                    next_at = time.perf_counter() + period  # resync after stall
        except asyncio.CancelledError:
            # Drain: every dispatched tick's device step has run; its
            # egress, callbacks and stats must not vanish at shutdown. (A
            # tick staged but not dispatched is dropped, as in the
            # reference.)
            self._staged = None
            if pending_task is not None:
                await pending_task
                self._complete_task = None
            if pending is not None:
                await self._complete(pending[0], pending[1])
            raise

    def _count_dropped(self, fut: asyncio.Future) -> None:
        """Done callback of a step the restart left behind: a step that
        returned outputs committed before the epoch bump, and its tick
        goes with the cancelled loop (one that returned None counted
        itself)."""
        if not fut.cancelled() and fut.exception() is None and fut.result() is not None:
            self.stats["dropped_steps"] += 1

    async def stop(self) -> None:
        """Cancel the loop and wait for its drain. A cancellation of the
        caller itself (a supervisor stopped in the middle of a restart's
        stop) propagates: taking it for the loop's own would let the
        restart run on after its supervisor was told to stop."""
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                if _cancelling():
                    raise
            self._task = None
        if self._complete_task is not None:
            self._complete_task.cancel()
            try:
                await self._complete_task
            except asyncio.CancelledError:
                if _cancelling():
                    raise
            self._complete_task = None

    # -- checkpoint / resume ---------------------------------------------
    # Snapshots hold numpy leaves in the reference's `jax.tree.flatten`
    # order (plane.tree_leaves), so a frame encoded by either package
    # decodes and restores in the other. Device reads and writes run on the
    # runtime's stream; callers hold state_lock.

    def snapshot(self) -> dict[str, Any]:
        """Serializable plane snapshot: device decision state + the
        host-side munger offsets (migration seeding analog)."""
        with self._on_stream():
            arrays = plane.state_to_numpy(self._host_state())
        return {"tick_index": self.tick_index, "arrays": arrays,
                "munger": self.munger.snapshot()}

    def snapshot_room(self, row: int) -> dict[str, Any]:
        """One room row's slice of the plane state — the room handoff
        payload (participant.go:823 MaybeStartMigration seeds the same
        per-forwarder state on the destination node). Control tensors come
        from the HOST mirrors (authoritative: they may hold un-uploaded
        mutations newer than the device copy); everything else is sliced
        on the device so only one row crosses to the host. The host
        munger's row rides along after the device leaves."""
        return self.snapshot_rooms([row])[0]

    def snapshot_rooms(self, rows: list[int]) -> list[dict[str, Any]]:
        """`snapshot_room` of many rows at one point in time, with one
        device → host copy per state leaf (the rows gathered on the
        device) — the room-checkpoint round's read."""
        if not rows:
            return []
        idx = torch.as_tensor(rows, dtype=torch.long)
        with self._on_stream():
            if self._mesh is not None:
                leaves = [x.numpy() for x in
                          plane.tree_leaves(mesh_mod.read_rows(self.state, rows))]
            else:
                leaves = [x.index_select(0, idx.to(x.device)).to("cpu").numpy()
                          for x in plane.tree_leaves(self.state)]
        out = []
        for i, row in enumerate(rows):
            tree = plane.tree_unflatten(self._state_tree(), [a[i, ...] for a in leaves])
            tree = tree._replace(
                meta=plane.TrackMeta(*[np.array(m[row]) for m in self.meta]),
                ctrl=plane.SubControl(*[np.array(c[row]) for c in self.ctrl]),
            )
            out.append({"arrays": plane.tree_leaves(tree) + self.munger.snapshot_room(row)})
        return out

    @staticmethod
    def encode_room_snapshot(snap: dict[str, Any]) -> str:
        """Room snapshot → checksummed npz frame, base64 (the form a room
        checkpoint travels in). The frame lets every restore path verify
        the bytes before any scatter."""
        buf = io.BytesIO()
        np.savez_compressed(buf, *snap["arrays"])
        return checksum.encode_frame_b64(buf.getvalue())

    @staticmethod
    def decode_room_snapshot(payload: str) -> dict[str, Any]:
        """Verify + decode a room checkpoint; raises ChecksumError on a
        corrupt frame BEFORE np.load touches the bytes."""
        z = np.load(io.BytesIO(checksum.decode_frame_b64(payload)))
        # savez names leaves arr_0..arr_N; z.files sorts lexically (arr_10
        # before arr_2), so index numerically.
        return {"arrays": [z[f"arr_{i}"] for i in range(len(z.files))]}

    @staticmethod
    def encode_snapshot(snap: dict[str, Any]) -> bytes:
        """Full-plane snapshot → checksummed npz frame (the supervisor's
        checkpoint-generation format)."""
        arrays = list(snap["arrays"]) + list(snap.get("munger", []))
        buf = io.BytesIO()
        np.savez_compressed(buf, *arrays, tick_index=np.int64(snap["tick_index"]),
                            n_state=np.int64(len(snap["arrays"])))
        return checksum.encode_frame(buf.getvalue())

    @staticmethod
    def decode_snapshot(blob: bytes) -> dict[str, Any]:
        """Verify + decode a full-plane checkpoint into the snapshot()
        dict shape; ChecksumError on corruption, ValueError/KeyError on a
        malformed archive."""
        z = np.load(io.BytesIO(checksum.decode_frame(blob)))
        n_arrays = sum(1 for f in z.files if f.startswith("arr_"))
        n_state = int(z["n_state"])
        arrays = [z[f"arr_{i}"] for i in range(n_arrays)]
        return {"tick_index": int(z["tick_index"]), "arrays": arrays[:n_state],
                "munger": arrays[n_state:]}

    @staticmethod
    def _check_leaves(flat: list, arrays, row: bool) -> None:
        """Validate a snapshot's leaves against the LIVE plane spec
        (count, shape, dtype compatibility) before anything is written
        into device state. `flat` holds the plane's leaves (tensors or
        numpy arrays); a row snapshot (`row`) holds each leaf's row plus
        the host munger's fields, a full one the leaves alone."""
        kind = "snapshot" if row else "full snapshot"
        extra = len(HostMunger.FIELDS) if row else 0
        n = 0 if arrays is None else len(arrays)
        if n != len(flat) + extra:
            raise ValueError(
                f"{kind} has {n} leaves, plane has {len(flat)} + {extra} munger "
                f"fields — source/destination plane versions differ"
            )
        where = "row shape" if row else "shape"
        for i, (leaf, a) in enumerate(zip(flat, arrays)):
            a = np.asarray(a)
            want = tuple(leaf.shape[1:] if row else leaf.shape)
            if tuple(a.shape) != want:
                raise ValueError(
                    f"{kind} leaf {i} {where} {tuple(a.shape)} != "
                    f"plane {where} {want} — dims mismatch"
                )
            if not np.can_cast(a.dtype, _np_dtype(leaf), casting="same_kind"):
                raise ValueError(
                    f"{kind} leaf {i} dtype {a.dtype} incompatible with "
                    f"plane dtype {_np_dtype(leaf)}"
                )

    @staticmethod
    def row_snapshot_from_full(snap: dict[str, Any], row: int) -> dict[str, Any]:
        """Slice one room's row out of a FULL snapshot() dict, in the
        snapshot_room() wire shape (state leaves then munger fields) —
        how the integrity monitor turns the supervisor's last verified
        checkpoint into a row-repair payload."""
        return {
            "arrays": [np.asarray(a[row]) for a in snap["arrays"]]
            + [np.asarray(m[row]) for m in snap.get("munger", [])]
        }

    def _write_row(self, row: int, leaves: list) -> None:
        """Write one room row of every device leaf from numpy, in place,
        on the runtime's stream; on a mesh, on the shard that owns it."""
        with self._on_stream():
            if self._mesh is not None:
                mesh_mod.write_rows(self.state, [row], [np.asarray(a)[None] for a in leaves])
                return
            for leaf, a in zip(plane.tree_leaves(self.state), leaves):
                leaf[row] = _to_device(a, leaf)

    def repair_room_row(self, row: int, snap: dict[str, Any]) -> None:
        """Integrity row repair: overwrite ONE corrupt room row from a
        verified checkpoint without disturbing any other row.

        Unlike restore_room, the HOST mirrors stay authoritative: this
        node's meta/ctrl were never suspect — only the device row was — so
        the row's current subscriptions survive and the dirty-row upload
        re-asserts them over the checkpoint's older device copy at the
        next tick edge. Callers hold state_lock."""
        flat = plane.tree_leaves(self._state_tree())
        self._check_leaves(flat, snap["arrays"], row=True)
        self.munger.restore_room(row, snap["arrays"][len(flat):])
        self._write_row(row, snap["arrays"][:len(flat)])
        # The replay ring references pre-repair munger SN spaces; replaying
        # across the rewind would emit wrong-SN bytes. Clients re-NACK.
        self.host_seq.clear_room(row)
        self._dirty_rows.add(row)

    def restore_room(self, row: int, snap: dict[str, Any]) -> None:
        """Seed `row` from a room snapshot (taken here or on another
        node): munger/VP8 offsets continue mid-stream, so subscribers see
        contiguous SN/TS instead of a stream reset. The host-side replay
        ring is NOT carried: NACKs of pre-snapshot packets miss until the
        ring repopulates.

        Subscription masks are NOT carried over: the destination's slot
        allocator hands out sub columns fresh, and a restored subscribed
        bit on a column later given to a different participant would leak
        media to someone who never subscribed. Callers hold state_lock."""
        self.host_seq.clear_room(row)
        flat = plane.tree_leaves(self._state_tree())
        self._check_leaves(flat, snap["arrays"], row=True)
        dev_arrays = snap["arrays"][:len(flat)]
        self.munger.restore_room(row, snap["arrays"][len(flat):])
        self._write_row(row, dev_arrays)
        # Mirror the row's track metadata back to the host copies (other
        # rows' possibly-dirty host state stays untouched)…
        snap_tree = plane.tree_unflatten(self._state_tree(), dev_arrays)
        for host_arr, snap_arr in zip(self.meta, snap_tree.meta):
            host_arr[row] = snap_arr
        # …but clear the subscriber-facing control masks (see docstring).
        self._reset_restored_ctrl(row)

    def _reset_restored_ctrl(self, row: int) -> None:
        """A restored room row's subscriber-facing control masks start
        clear (restore_room's docstring says why); the next ctrl upload
        clears them on device too. The integrity monitor drops the row's
        quarantine history and re-baselines its audit cursors, which
        rewound on purpose."""
        self.ctrl.subscribed[row] = False
        self.ctrl.sub_muted[row] = False
        self.ctrl.max_spatial[row] = plane.MAX_LAYERS - 1
        self.ctrl.max_temporal[row] = 3
        self._dirty_rows.add(row)
        if self.integrity is not None:
            self.integrity.on_row_restore(row)

    def restore(self, snap: dict[str, Any]) -> None:
        """Restore the whole plane from a snapshot() dict, onto freshly
        allocated device tensors (never the ones a step in flight holds;
        on a mesh, fresh tensors on every shard). Callers hold
        state_lock."""
        if self._mesh is not None:
            # The plane's leaves at their global shapes, without data.
            flat = [torch.empty((self.dims.rooms,) + tuple(x.shape[1:]), dtype=x.dtype,
                                device="meta")
                    for x in plane.tree_leaves(self._state_tree())]
            self._check_leaves(flat, snap.get("arrays"), row=False)
            host = [_to_device(a, torch.empty(0, dtype=leaf.dtype))
                    for leaf, a in zip(flat, snap["arrays"])]
            self.state = mesh_mod.shard_tree(
                plane.tree_unflatten(self._state_tree(), host), self._mesh)
        else:
            flat = plane.tree_leaves(self.state)
            self._check_leaves(flat, snap.get("arrays"), row=False)
            with self._on_stream():
                self.state = plane.tree_unflatten(
                    self.state, [_to_device(a, leaf) for leaf, a in zip(flat, snap["arrays"])])
        if "munger" in snap:
            self.munger.restore(snap["munger"])
        else:
            # A munger-less snapshot must not pair restored device
            # decisions with STALE SN/TS offsets — every lane would keep
            # rewriting against the wrong anchor. Reset so lanes anchor
            # fresh instead (a one-time stream reset, like a new room).
            self.munger = HostMunger(self.dims)
        self.tick_index = snap["tick_index"]
        self._ctrl_dirty = True
        if self.integrity is not None:
            self.integrity.on_full_restore()


def _cancelling() -> bool:
    """Whether the running task has a cancellation request of its own."""
    task = asyncio.current_task()
    return task is not None and task.cancelling() > 0


def _np_dtype(leaf) -> np.dtype:
    """The numpy dtype of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _to_device(a, like: torch.Tensor) -> torch.Tensor:
    """A new tensor (never a view of `a`) holding numpy `a` with `like`'s
    dtype, on its device."""
    a = np.require(np.asarray(a), requirements=("C", "W"))
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype, copy=True)
