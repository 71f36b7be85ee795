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

Not carried yet (see ROADMAP.md): the device mesh, the express lane,
egress-plane sharding, the overload governor, the integrity audit, fault
injection, the trace ring, the compile ledger, snapshots/restore and the
pipelined serving loop (`_run`); the munger runs its numpy path.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

import numpy as np
import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.models import plane
from livekit_server_tpu_torch.ops import audio as audio_ops, bwe as bwe_ops
from livekit_server_tpu_torch.runtime.ingest import IngestBuffer
from livekit_server_tpu_torch.runtime.munge import HostMunger
from livekit_server_tpu_torch.runtime.probe import PAD_BYTES, ProbeController
from livekit_server_tpu_torch.runtime.slots import SlotAllocator


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
    padding: bool = False
    dd: bytes = b""


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

    def __len__(self) -> int:
        return len(self.rooms)


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
    quality_window_closed: bool = False


@dataclass
class StagedTick:
    """One tick's host-staged inputs and its per-stage timings."""

    inp: plane.TickInputs
    payloads: Any
    idx: int
    roll: bool
    wire: np.ndarray | None = None   # the packed device inputs, one buffer
    stage_s: float = 0.0
    device_s: float = 0.0


class PlaneRuntime:
    """Owns the device plane state + the host mirrors and tick loop."""

    def __init__(self, dims: plane.PlaneDims, tick_ms: int = 10,
                 audio_params=None, bwe_params=None, red_enabled: bool = True,
                 device="cuda"):
        self.device = resolve(device)
        self.dims = dims
        self.tick_ms = tick_ms
        self.red_enabled = red_enabled
        self.slots = SlotAllocator(dims.rooms, dims.tracks, dims.subs)
        self.ingest = IngestBuffer(dims, tick_ms)
        self.tick_index = 0
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

        self.state = plane.init_state(dims, device=self.device)
        self.munger = HostMunger(dims)
        self._slab_history: list = [None] * plane.SLAB_WINDOW
        self.host_seq = HostSequencer(dims)
        self.prober = ProbeController(dims, tick_ms)
        self._last_committed = np.zeros((R, S), np.float32)
        self._last_congested = np.zeros((R, S), bool)
        self._last_deficient = np.zeros((R, S), bool)
        # Guards self.state across the device step (run in a worker
        # thread) vs. other coroutines touching it.
        self.state_lock = asyncio.Lock()
        self._on_tick: list[Callable[[TickResult], Awaitable[None] | None]] = []
        self.stats = {
            "ticks": 0, "fwd_packets": 0, "fwd_bytes": 0,
            "stage_s": 0.0, "device_s": 0.0, "fanout_s": 0.0,
            "ctrl_full_uploads": 0, "ctrl_delta_uploads": 0,
            "ctrl_delta_rows": 0, "ctrl_upload_bytes": 0,
        }

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

    def clear_room(self, room: int) -> None:
        self.meta.published[room, :] = False
        self.meta.pub_muted[room, :] = False
        self.ctrl.subscribed[room, :, :] = False
        self.ingest.track_pub_sub[room, :] = -1
        self.ingest.fb_enabled[room, :] = False
        self.ingest.sub_reset[room, :] = True  # next tenant: fresh BWE state
        self.host_seq.clear_room(room)
        self.munger.clear_room(room)
        self._dirty_rows.add(room)

    def on_tick(self, cb: Callable[[TickResult], Awaitable[None] | None]) -> None:
        self._on_tick.append(cb)

    # -- tick ------------------------------------------------------------
    def _upload_ctrl(self) -> None:
        """Ship pending host-mirror control mutations to the device: the
        dirtied room rows (O(dirty rows) bytes), or the full mirrors when
        the full flag is set or too many rows are dirty. Writes into the
        state's tensors in place. Caller holds state_lock."""
        rows = self._dirty_rows
        if not self._ctrl_dirty and not rows:
            return
        if self._ctrl_dirty or len(rows) > self.ctrl_delta_max_rows:
            for dst, src in zip((*self.state.meta, *self.state.ctrl),
                                (*self.meta, *self.ctrl)):
                dst.copy_(torch.from_numpy(src))
            self.stats["ctrl_full_uploads"] += 1
        else:
            r, meta_rows, ctrl_rows = plane.pack_ctrl_rows(self.meta, self.ctrl, rows)
            plane.apply_ctrl_delta(self.state, r, meta_rows, ctrl_rows)
            self.stats["ctrl_delta_uploads"] += 1
            self.stats["ctrl_delta_rows"] += len(rows)
            self.stats["ctrl_upload_bytes"] += meta_rows.nbytes + ctrl_rows.nbytes
        self._dirty_rows = set()
        self._ctrl_dirty = False

    def _device_step(self, st: StagedTick) -> plane.TickOutputs:
        """The device round trip: one upload of the packed inputs, the
        tick, one fetch of the flat output buffer (the fetch waits for the
        device). Caller holds state_lock; runs in a worker thread."""
        t0 = time.perf_counter()
        self.state, out = plane.device_tick(
            self.state, st.wire, self.dims, self._ap, self._bp, self.red_enabled,
        )
        st.device_s = time.perf_counter() - t0
        return out

    def _stage_host(self) -> StagedTick:
        """Claim a tick index, drain the ingest buffer, pack the device
        inputs. Touches host-owned state only."""
        t0 = time.perf_counter()
        idx = self.tick_index
        self.tick_index += 1
        # Close the quality/stats window about once per second.
        q_ticks = max(1, 1000 // self.tick_ms)
        roll = (idx + 1) % q_ticks == 0
        inp, payloads = self.ingest.drain(roll_quality=roll)
        self._slab_history[idx % plane.SLAB_WINDOW] = payloads
        wire = plane.wire_inputs(plane.pack_tick_inputs(inp))
        st = StagedTick(inp=inp, payloads=payloads, idx=idx, roll=roll, wire=wire)
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
        """Host post-step: fan out + callbacks."""
        c0 = time.perf_counter()
        result = self._fan_out(out, st.payloads, st.inp, st.idx)
        fanout_s = time.perf_counter() - c0
        result.tick_s = st.stage_s + st.device_s + fanout_s
        result.quality_window_closed = st.roll
        self.stats["ticks"] += 1
        self.stats["fwd_packets"] += result.fwd_packets
        self.stats["fwd_bytes"] += result.fwd_bytes
        self.stats["stage_s"] += st.stage_s
        self.stats["device_s"] += st.device_s
        self.stats["fanout_s"] += fanout_s
        for cb in self._on_tick:
            r = cb(result)
            if asyncio.iscoroutine(r):
                await r
        return result

    async def step_once(self) -> TickResult:
        """One sequential tick. The device round trip runs in a worker
        thread so the event loop never blocks on the card."""
        st = self._stage_host()
        self._schedule_probe(st)
        async with self.state_lock:
            self._upload_ctrl()
            out = await asyncio.to_thread(self._device_step, st)
        self._mirror_probe_inputs(out)
        self.ingest.scrub_retired()
        return await self._complete(out, st)

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

    def _fan_out(self, out: plane.TickOutputs, payloads, inp, tick_idx: int) -> TickResult:
        """Bit-packed egress masks → host munge → column arrays, plus the
        speaker / keyframe / congestion views of the tick's outputs."""
        rr, tt, kk, ss, b_sn, b_ts, b_pid, b_tl0, b_ki = self.munger.apply_columns(
            inp.sn, inp.ts, inp.ts_jump, inp.pid, inp.tl0, inp.keyidx,
            inp.begin_pic, inp.valid, out.send_bits, out.drop_bits, out.switch_bits,
        )
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
        self.host_seq.record(batch, tick_idx)
        padding = self._assemble_padding(inp)
        if padding:
            self.stats["pad_packets"] = self.stats.get("pad_packets", 0) + len(padding)
        return TickResult(
            tick_index=tick_idx,
            egress_batch=batch,
            padding=padding,
            speakers=speakers,
            need_keyframe=nk,
            congested=congested,
            fwd_packets=int(out.fwd_packets.sum()),
            fwd_bytes=int(out.fwd_bytes.sum()),
            tick_s=0.0,
            outputs=out,
        )
