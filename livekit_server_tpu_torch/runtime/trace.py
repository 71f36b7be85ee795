"""Flight-recorder tracing plane: tick spans, sampled wire-latency
attribution, and per-room black-box event rings.

A copy of the JAX package's runtime/trace.py. A standing diagnosis
capability with a hard overhead budget — everything on the per-tick path
is a handful of scalar stores into preallocated numpy arrays (no
dict/f-string/list construction):

- **TickTraceRing** — one record per tick in a fixed ring: the dispatch
  edge, the start and duration of each of the tick's stages (utils/
  spans.py `STAGES`: the pushes drained into it, stage_host with its
  nested express retier, the probe, ctrl upload, device step with the
  paged kernel's span, fan-out with its munge/views split, egress send),
  wake overshoot, depth, lateness, and per-egress-shard munge/send
  walls. The port's PlaneRuntime copies each tick's record here
  (`StagedTick`'s two stage rows), with the host spans of the tick's
  blocks inside its device step (the block spans of models/plane.py,
  utils/spans.py, re-exported here); `snapshot` reads it back as the
  reference's records, plus the served path's `runtime.*` stages.
- **LatencyAttribution** — a deterministic 1-in-K sample of egress
  packets (sampled on the munged SN, so the set is stable across runs)
  whose arrival stamp is decomposed at the wire into staging / device /
  egress stage latencies, plus the express tier's arrival→wire latency.
  Feeds `livekit_wire_latency_stage_ms` and `livekit_forward_latency_ms`.
  Its feeders are the UDP transport's two send paths (runtime/udp.py
  `send_egress_batch` observes each tick's sent entries against the
  batch's dispatch and device-end stamps; `_send_express` the express
  tier's arrival→wire latency).
- **BlackBox** — per-room ring of the last M lifecycle / governor /
  integrity / migration / express events, dumped to the log (and kept
  for /debug/blackbox/{room}) on quarantine, repair failure, supervisor
  restart, migration rollback, or a NACK storm — the post-mortem no
  longer depends on whatever counters happened to be scraped.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np

from livekit_server_tpu_torch.utils.spans import (  # noqa: F401
    DEVICE_STEP,
    FANOUT,
    KERNEL,
    MUNGE,
    NAMES,
    RETIER,
    RUNTIME,
    SEND,
    SPANS,
    STAGE,
    UPLOAD,
    set_flight,
)
from livekit_server_tpu_torch.utils.spans import STAGES as TICK_STAGES

# Egress-shard lanes a tick record can hold (EgressPlane caps at 16).
MAX_SHARDS = 16

# -- black-box event codes -------------------------------------------------
# Scalar int codes so the hot-path emit is a pure store; names resolve at
# dump time only.
EV_ROOM_OPEN = 1        # a = room row
EV_ROOM_CLOSE = 2       # a = room row
EV_JOIN = 3             # a = participant count after join
EV_LEAVE = 4            # a = participant count after leave
EV_GOV_LEVEL = 10       # a = old level, b = new level
EV_QUARANTINE = 20      # a = tick index
EV_REPAIR_OK = 21       # a = tick index
EV_REPAIR_FAIL = 22     # a = repair failures total
EV_ESCALATE = 23        # node lane; a = escalations total
EV_RESTART = 30         # node lane; a = attempt number
EV_MIG_FREEZE = 40      # a = epoch
EV_MIG_COMMIT = 41      # a = epoch
EV_MIG_ABORT = 42       # a = epoch
EV_NACK_STORM = 50      # a = subscriber, b = NACKed SN count
EV_PROMOTE = 60         # express tier promotion
EV_DEMOTE = 61          # express tier demotion

EVENT_NAMES = {
    EV_ROOM_OPEN: "room_open", EV_ROOM_CLOSE: "room_close",
    EV_JOIN: "join", EV_LEAVE: "leave",
    EV_GOV_LEVEL: "governor_level",
    EV_QUARANTINE: "quarantine", EV_REPAIR_OK: "repair_ok",
    EV_REPAIR_FAIL: "repair_fail", EV_ESCALATE: "escalate",
    EV_RESTART: "restart",
    EV_MIG_FREEZE: "migration_freeze", EV_MIG_COMMIT: "migration_commit",
    EV_MIG_ABORT: "migration_abort",
    EV_NACK_STORM: "nack_storm",
    EV_PROMOTE: "express_promote", EV_DEMOTE: "express_demote",
}

# Wire-latency stages in attribution order. `staging` is arrival →
# device dispatch (slab wait + tick-queueing), `device` the step itself,
# `egress` device commit → kernel send (munge/assemble/seal/send plus the
# pipeline's deferred fan-out wait); `total` is their measured (not
# composed) arrival→wire sum and `express` the arrival-driven tier's
# whole path — kept separate so the batched tail never buries it.
STAGES = ("staging", "device", "egress", "total", "express")
_S_STAGING, _S_DEVICE, _S_EGRESS, _S_TOTAL, _S_EXPRESS = range(len(STAGES))


class TickTraceRing:
    """Fixed ring of per-tick span records, preallocated columns.

    Single writer (the event loop's `_complete`); `record_tick` and
    `set_shard` are stores into the preallocated columns only — the
    bounded hot-path API.
    `snapshot` (cold path: /debug/trace, tools/trace) materializes the
    newest records as dicts for the exporter."""

    def __init__(self, cap: int = 512):
        cap = max(8, int(cap))
        self.cap = cap
        self.idx = np.full(cap, -1, np.int64)
        self.edge = np.zeros(cap, np.float64)
        # Each stage's start and duration (perf_counter s, TICK_STAGES
        # order); 0 where the tick did not record it.
        self.t0 = np.zeros((cap, len(TICK_STAGES)), np.float64)
        self.dur = np.zeros((cap, len(TICK_STAGES)), np.float64)
        self.wake_over_us = np.zeros(cap, np.float32)
        self.depth = np.zeros(cap, np.int8)
        self.late = np.zeros(cap, np.int8)
        self.n_shards = np.zeros(cap, np.int8)
        self.shard_munge_ms = np.zeros((cap, MAX_SHARDS), np.float32)
        self.shard_send_ms = np.zeros((cap, MAX_SHARDS), np.float32)
        # Host spans of the tick's blocks (SPANS order), on this ring's
        # clock; a duration of 0 where the block did not run.
        self.block_t0 = np.zeros((cap, len(SPANS)), np.float64)
        self.block_dur = np.zeros((cap, len(SPANS)), np.float64)
        # (perf_counter s, unix epoch ns) read together: the exporter's
        # baseTimeNanoseconds.
        self.anchor = (time.perf_counter(), time.time_ns())
        self._pos = 0
        self.recorded = 0

    def record_tick(self, idx: int, edge: float, t0, dur, wake_over_us: float,
                    depth: int, late: bool) -> int:
        """Copy one tick in: its index, dispatch edge, its stages' starts
        and durations (`t0`, `dur`: TICK_STAGES-long rows), wake
        overshoot, depth and lateness. Returns the slot."""
        slot = self._pos
        self.idx[slot] = idx
        self.edge[slot] = edge
        self.t0[slot] = t0
        self.dur[slot] = dur
        self.wake_over_us[slot] = wake_over_us
        self.depth[slot] = depth
        self.late[slot] = late
        self.n_shards[slot] = 0
        self.block_dur[slot] = 0.0
        self._pos = (slot + 1) % self.cap
        self.recorded += 1
        return slot

    def set_shard(self, slot: int, lane: int, munge_ms: float,
                  send_ms: float) -> None:
        if lane >= MAX_SHARDS:
            return
        self.shard_munge_ms[slot, lane] = munge_ms
        self.shard_send_ms[slot, lane] = send_ms
        if lane + 1 > self.n_shards[slot]:
            self.n_shards[slot] = lane + 1

    def set_blocks(self, slot: int, last) -> None:
        """The tick's block spans: `SpanRecorder.last`'s (start,
        duration) ns pairs, SPANS order."""
        for i, (t0, dur) in enumerate(last):
            self.block_t0[slot, i] = t0 * 1e-9
            self.block_dur[slot, i] = dur * 1e-9

    def snapshot(self, n: int | None = None) -> list[dict[str, Any]]:
        """Newest `n` records (all when None), oldest first — cold path."""
        have = min(self.recorded, self.cap)
        take = have if n is None else max(0, min(int(n), have))
        out: list[dict[str, Any]] = []
        for i in range(take):
            slot = (self._pos - take + i) % self.cap
            if self.idx[slot] < 0:
                continue
            ns = int(self.n_shards[slot])
            t0, dur = self.t0[slot], self.dur[slot]
            rec = {
                "tick": int(self.idx[slot]),
                "edge": float(self.edge[slot]),
                "stage_t0": float(t0[STAGE]),
                "stage_s": float(dur[STAGE]),
                "retier_s": float(dur[RETIER]),
                "upload_t0": float(t0[UPLOAD]),
                "upload_s": float(dur[UPLOAD]),
                "device_t0": float(t0[DEVICE_STEP]),
                "device_s": float(dur[DEVICE_STEP]),
                "kernel_s": float(dur[KERNEL]),
                "fanout_t0": float(t0[FANOUT]),
                "fanout_s": float(dur[FANOUT]),
                "send_s": float(dur[SEND]),
                "wake_over_us": float(self.wake_over_us[slot]),
                "depth": int(self.depth[slot]),
                "late": bool(self.late[slot]),
                "shard_munge_ms": [
                    float(x) for x in self.shard_munge_ms[slot, :ns]
                ],
                "shard_send_ms": [
                    float(x) for x in self.shard_send_ms[slot, :ns]
                ],
            }
            ran = np.flatnonzero(self.block_dur[slot] > 0.0)
            if len(ran):
                rec["blocks"] = {
                    NAMES[i]: [float(self.block_t0[slot, i]),
                               float(self.block_dur[slot, i])]
                    for i in ran
                }
            if t0[MUNGE] > 0.0:
                rec["runtime"] = self._stages(t0, dur)
            out.append(rec)
        return out

    @staticmethod
    def _stages(t0, dur) -> dict[str, list[float]]:
        """A tick's served-path stages (`RUNTIME`) as `runtime.<stage>`:
        [start, duration] (perf_counter s), each where the tick recorded
        it. `runtime.stage` is the staging after the express retier; the
        push's duration is the summed seconds of the pushes drained into
        the tick, from the first one's start."""
        out = {}
        for s, name in RUNTIME.items():
            s0, ds = float(t0[s]), float(dur[s])
            if s == STAGE:
                rs = float(dur[RETIER])
                s0, ds = s0 + rs, ds - rs
            if s0 > 0.0:
                out[name] = [s0, ds]
        return out


class LatencyAttribution:
    """Deterministic 1-in-K sampled per-stage wire-latency recorder.

    The sample predicate is `sn % sample_every == 0` on the munged
    sequence number of already-stamped entries (`t_arr > 0`): no RNG on
    the hot path, the same packets sample on every run, and the cost is
    one vectorized mask per send call. Sampled stage latencies land in
    small per-stage rings of raw millisecond values; `drain()` hands the
    new samples to telemetry (histograms), `summary()` computes exact
    percentiles over the retained window for bench/debug.

    Thread-safety: observe_* are called from the event loop AND the
    pacer worker (udp.do_send runs off-loop when paced), so pushes
    serialize on a lock — one uncontended acquire per send call."""

    CAP = 4096  # retained samples per stage (at 1-in-64 this is minutes)

    def __init__(self, sample_every: int = 64):
        self.sample_every = max(1, int(sample_every))
        n = len(STAGES)
        self.ring = np.zeros((n, self.CAP), np.float32)
        self.total = np.zeros(n, np.int64)       # lifetime samples pushed
        self._drained = np.zeros(n, np.int64)    # consumed watermark
        self._lock = threading.Lock()

    def _push(self, stage: int, vals_ms: np.ndarray) -> None:
        m = len(vals_ms)
        if not m:
            return
        if m > self.CAP:
            vals_ms = vals_ms[-self.CAP:]
            m = self.CAP
        with self._lock:
            pos = int(self.total[stage]) % self.CAP
            end = pos + m
            if end <= self.CAP:
                self.ring[stage, pos:end] = vals_ms
            else:
                k = self.CAP - pos
                self.ring[stage, pos:] = vals_ms[:k]
                self.ring[stage, : end - self.CAP] = vals_ms[k:]
            self.total[stage] += m

    def _mask(self, sn: np.ndarray, t_arr: np.ndarray) -> np.ndarray:
        return (sn % self.sample_every == 0) & (t_arr > 0.0)

    def observe_batch(self, sn, t_arr, t_dispatch: float,
                      t_device_end: float, now: float) -> None:
        """Batched-tier send: decompose each sampled entry's arrival→wire
        latency at the tick's dispatch and device-commit boundaries.
        No-ops when the batch predates the stamps (t_dispatch == 0)."""
        if t_arr is None or t_dispatch <= 0.0 or t_device_end <= 0.0:
            return
        sn = np.asarray(sn)
        t_arr = np.asarray(t_arr, np.float64)
        m = self._mask(sn, t_arr)
        if not m.any():
            return
        ta = t_arr[m]
        # A packet can arrive after the tick it rides was dispatched
        # (late slab stragglers): clip, the stage split stays >= 0.
        staging = np.maximum(t_dispatch - ta, 0.0) * 1e3
        device_ms = max(t_device_end - t_dispatch, 0.0) * 1e3
        egress_ms = max(now - t_device_end, 0.0) * 1e3
        self._push(_S_STAGING, staging.astype(np.float32))
        self._push(_S_DEVICE, np.full(len(ta), device_ms, np.float32))
        self._push(_S_EGRESS, np.full(len(ta), egress_ms, np.float32))
        self._push(_S_TOTAL, ((now - ta) * 1e3).astype(np.float32))

    def observe_express(self, sn, t_arr, now: float) -> None:
        """Express-tier send: one arrival→wire stage (the lane skips the
        tick entirely); also feeds `total` so the combined forward-latency
        histogram covers both tiers."""
        sn = np.asarray(sn)
        t_arr = np.asarray(t_arr, np.float64)
        m = self._mask(sn, t_arr)
        if not m.any():
            return
        lat = ((now - t_arr[m]) * 1e3).astype(np.float32)
        self._push(_S_EXPRESS, lat)
        self._push(_S_TOTAL, lat)

    def reset(self) -> None:
        """Discard the retained window (bench measurement-window start:
        warmup/compile-era samples would poison the percentiles)."""
        with self._lock:
            self.total[:] = 0
            self._drained[:] = 0

    def drain(self) -> dict[str, np.ndarray]:
        """New samples per stage since the last drain (telemetry scrape).
        A burst past CAP between drains keeps the newest CAP."""
        out: dict[str, np.ndarray] = {}
        with self._lock:
            for s, name in enumerate(STAGES):
                total = int(self.total[s])
                new = total - int(self._drained[s])
                if new <= 0:
                    continue
                new = min(new, self.CAP)
                pos = total % self.CAP
                lo = (pos - new) % self.CAP
                if lo + new <= self.CAP:
                    vals = self.ring[s, lo:lo + new].copy()
                else:
                    vals = np.concatenate(
                        [self.ring[s, lo:], self.ring[s, : pos]]
                    )
                self._drained[s] = total
                out[name] = vals
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        """Exact percentiles over each stage's retained window (bench and
        /debug/trace sidecar; cold path)."""
        out: dict[str, dict[str, float]] = {}
        with self._lock:
            for s, name in enumerate(STAGES):
                n = int(min(self.total[s], self.CAP))
                if not n:
                    continue
                w = self.ring[s, :n].astype(np.float64)
                out[name] = {
                    "n": int(self.total[s]),
                    "p50_ms": round(float(np.percentile(w, 50)), 3),
                    "p90_ms": round(float(np.percentile(w, 90)), 3),
                    "p99_ms": round(float(np.percentile(w, 99)), 3),
                    "mean_ms": round(float(w.mean()), 3),
                }
        return out


class BlackBox:
    """Per-room flight recorder: ring of the last M (t, code, a, b)
    events per room row, plus one node lane (row R) for room-less events
    (governor level moves, supervisor restarts).

    `emit` is the hot-path API: four scalar stores and a
    monotonic stamp, no allocation. `dump`/`dump_to` are cold paths that
    materialize a lane as dicts, log it, and retain the last few dumps
    for /debug/blackbox/{room}."""

    NODE = -1  # emit(room=NODE, ...) targets the node lane

    def __init__(self, rooms: int, events: int = 64, log=None):
        self.rooms = int(rooms)
        self.events = max(4, int(events))
        lanes = self.rooms + 1
        self.t = np.zeros((lanes, self.events), np.float64)
        self.code = np.zeros((lanes, self.events), np.int16)
        self.a = np.zeros((lanes, self.events), np.float64)
        self.b = np.zeros((lanes, self.events), np.float64)
        self.pos = np.zeros(lanes, np.int32)
        self.total = np.zeros(lanes, np.int64)
        self.log = log
        from collections import deque

        # Bounded dump retention for /debug/blackbox (explicit cap).
        self.last_dumps: deque = deque(maxlen=8)
        self.dumps = 0

    def _lane(self, room: int) -> int:
        if 0 <= room < self.rooms:
            return room
        return self.rooms

    def emit(self, room: int, code: int, a: float = 0.0,
             b: float = 0.0) -> None:
        lane = self._lane(room)
        slot = self.pos[lane]
        self.t[lane, slot] = time.monotonic()
        self.code[lane, slot] = code
        self.a[lane, slot] = a
        self.b[lane, slot] = b
        self.pos[lane] = (slot + 1) % self.events
        self.total[lane] += 1

    def dump(self, room: int) -> list[dict[str, Any]]:
        """One lane's events, oldest first (cold path)."""
        lane = self._lane(room)
        have = int(min(self.total[lane], self.events))
        pos = int(self.pos[lane])
        out = []
        for i in range(have):
            slot = (pos - have + i) % self.events
            code = int(self.code[lane, slot])
            out.append({
                "t": round(float(self.t[lane, slot]), 6),
                "event": EVENT_NAMES.get(code, str(code)),
                "a": float(self.a[lane, slot]),
                "b": float(self.b[lane, slot]),
            })
        return out

    def dump_to(self, room: int, reason: str) -> list[dict[str, Any]]:
        """Dump a lane on a trigger (quarantine, repair failure, restart,
        migration rollback, NACK storm): log it and retain it for
        /debug/blackbox. Returns the dumped events."""
        events = self.dump(room)
        record = {
            "room": int(room),
            "reason": reason,
            "at": round(time.monotonic(), 6),
            "events": events,
        }
        self.last_dumps.append(record)
        self.dumps += 1
        if self.log is not None:
            self.log.warn(
                "black-box dump", room=int(room), reason=reason,
                n_events=len(events), events=events[-16:],
            )
        return events
