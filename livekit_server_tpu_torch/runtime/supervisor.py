"""PlaneSupervisor: tick watchdog + restart-from-snapshot for the media plane.

Port of the JAX package's runtime/supervisor.py. The reference SFU
survives a wedged loop because every goroutine is independently
restartable; this runtime concentrates the whole node in one device step
per tick, so a single hung device step takes every room down. The
supervisor restores the reference's failure story at the plane level:

  - tick watchdog — samples the runtime's tick counter; no progress for
    `tick_deadline_s` while the loop is supposed to be running means the
    plane is stalled (hung device step, wedged worker thread, runaway
    callback)
  - bounded restart-from-snapshot — on stall (or a crashed serving loop)
    the task is cancelled WITHOUT waiting for the device step in flight
    (PlaneRuntime.stop, by contrast, finishes it), the possibly-wedged
    executor thread is ABANDONED (a fresh single-worker executor takes
    over), device+munger state is restored from the last periodic
    snapshot onto freshly allocated tensors, and the loop starts again
    — with exponential backoff between attempts and a hard cap, after
    which the supervisor gives up loudly rather than flap forever
  - periodic checkpoints — a full-plane snapshot on a cadence (the
    restart seed), plus an optional per-room checkpoint callback the
    RoomManager uses to publish room rows to the KV bus (the failover
    seed surviving nodes restore from; see service/roommanager.py).
    Checkpoints are kept as K encoded GENERATIONS, each wrapped in the
    utils/checksum frame; restore walks newest→oldest and falls back a
    generation (counter + warn) on a corrupt or shape-mismatched frame
    instead of committing garbage into device state. The snapshot is a
    blocking device → host fetch under state_lock and the encode runs on
    the event loop, as in the reference; their cost is counted
    (`checkpoint_fetch_s`, `checkpoint_encode_s`).
  - restart-cause taxonomy — `stall` (watchdog) vs `integrity`
    (requested by the IntegrityMonitor's escalation ladder via
    request_restart), with separate counters.

Restart rewinds at most one checkpoint interval of munger advance:
packets forwarded after the snapshot are re-issued with the same SNs
(duplicates, which receivers tolerate), never skipped.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Awaitable, Callable

from livekit_server_tpu_torch.runtime.trace import EV_RESTART
from livekit_server_tpu_torch.utils.backoff import BackoffPolicy
from livekit_server_tpu_torch.utils.logger import Logger


class PlaneSupervisor:
    def __init__(
        self,
        runtime,
        *,
        tick_deadline_s: float = 1.0,
        warmup_deadline_s: float = 30.0,
        check_interval_s: float = 0.1,
        checkpoint_interval_s: float = 2.0,
        max_restarts: int = 5,
        overload_grace: float = 5.0,
        ckpt_generations: int = 3,
        backoff: BackoffPolicy | None = None,
        telemetry=None,
        log: Logger | None = None,
    ):
        self.runtime = runtime
        self.tick_deadline_s = tick_deadline_s
        self.warmup_deadline_s = max(warmup_deadline_s, tick_deadline_s)
        self.check_interval_s = check_interval_s
        self.checkpoint_interval_s = checkpoint_interval_s
        self.max_restarts = max_restarts
        # Stall-deadline multiplier while the overload governor is
        # engaged: a governed plane is slow BECAUSE it is shedding load,
        # and a restart both loses the shed state and re-offers the full
        # load to a cold plane — the restart-storm failure mode. Genuine
        # no-progress still restarts once the widened deadline passes.
        self.overload_grace = max(1.0, overload_grace)
        self.backoff = backoff or BackoffPolicy(base=0.1, max_delay=5.0)
        self.telemetry = telemetry
        self.log = log or Logger()
        # Awaited on the checkpoint cadence; RoomManager points this at
        # its per-room bus publisher.
        self.room_checkpoint_cb: Callable[[], Awaitable[None]] | None = None
        self.last_snapshot: dict[str, Any] | None = None
        # Encoded (checksummed) checkpoint generations, newest first.
        # Restore verifies each frame and falls back a generation on
        # corruption; the corrupt_ckpt fault writes damage HERE, so the
        # in-memory last_snapshot above is kept only as a same-process
        # compatibility convenience and is NOT the restart seed.
        self._gens: deque = deque(maxlen=max(1, int(ckpt_generations)))
        self.ckpt_fallbacks = 0      # generations skipped as corrupt/invalid
        self.restarts = 0            # lifetime restart count (telemetry)
        self.restart_causes: dict[str, int] = {"stall": 0, "integrity": 0}
        self.gave_up = False
        # Node drain (service/migration.py): a draining plane quiesces on
        # purpose — rooms migrate away and tick progress may legitimately
        # stop. The watchdog must not read that as a stall and "restore"
        # rooms the drain just handed off.
        self.draining = False
        # Self-fenced (service/fleetplane.py quorum loss): restarts are
        # quiesced the same way — a restart would restore rooms from KV
        # checkpoints that may already belong to the takeover winner.
        self.fenced = False
        # Checkpoint cost on the event loop, summed: the locked snapshot
        # (device → host fetch, lock wait included) and the encode (npz
        # compression + frame).
        self.checkpoints = 0
        self.checkpoint_fetch_s = 0.0
        self.checkpoint_encode_s = 0.0
        self._attempts = 0           # consecutive restarts without health
        self._requested_restart = "" # set by request_restart(), watchdog-consumed
        self._watch_task: asyncio.Task | None = None
        self._ckpt_task: asyncio.Task | None = None
        self._ticks_seen = -1
        self._progress_at = 0.0
        self._baseline_ticks = -1

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._watch_task is None:
            self._progress_at = time.monotonic()
            self._baseline_ticks = self.runtime.stats.get("ticks", 0)
            self._watch_task = asyncio.ensure_future(self._watchdog())
        if self._ckpt_task is None:
            self._ckpt_task = asyncio.ensure_future(self._checkpointer())

    async def stop(self) -> None:
        for attr in ("_watch_task", "_ckpt_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)

    # -- checkpoint cadence ----------------------------------------------
    async def checkpoint_now(self) -> None:
        """One full-plane snapshot (the restart seed), then the per-room
        callback. Taken under state_lock so the donated device step never
        has the arrays mid-flight. The snapshot is encoded + checksummed
        into the generation ring; the corrupt_ckpt fault seam damages the
        encoded bytes here, exactly where real bit rot would land."""
        t0 = time.perf_counter()
        async with self.runtime.state_lock:
            self.last_snapshot = self.runtime.snapshot()
        t1 = time.perf_counter()
        blob = self.runtime.encode_snapshot(self.last_snapshot)
        t2 = time.perf_counter()
        self.checkpoints += 1
        self.checkpoint_fetch_s += t1 - t0
        self.checkpoint_encode_s += t2 - t1
        fault = getattr(self.runtime, "fault", None)
        if fault is not None:
            blob = fault.corrupt_ckpt(blob)
        self._gens.appendleft(blob)
        if self.room_checkpoint_cb is not None:
            await self.room_checkpoint_cb()

    def last_good_snapshot(self) -> dict[str, Any] | None:
        """Newest checkpoint generation that verifies, decoded — the
        IntegrityMonitor's row-repair source. Corrupt generations are
        skipped with a counter + warn."""
        for i, blob in enumerate(self._gens):
            try:
                return self.runtime.decode_snapshot(blob)
            except (ValueError, KeyError, OSError) as e:  # ChecksumError ⊂ ValueError
                self.ckpt_fallbacks += 1
                self.log.warn(
                    "checkpoint generation corrupt; falling back",
                    generation=i, error=str(e),
                )
        return None

    async def _checkpointer(self) -> None:
        while True:
            await asyncio.sleep(self.checkpoint_interval_s)
            try:
                await self.checkpoint_now()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — a failed checkpoint
                # (bus outage mid-publish) must not kill the cadence; the
                # next interval retries with fresher state anyway.
                self.log.warn("plane checkpoint failed", error=str(e))

    # -- requested restarts (integrity escalation) -------------------------
    def request_restart(self, reason: str) -> None:
        """Ask for a full restart-from-snapshot (cause `integrity`).
        Thread-safe: the IntegrityMonitor calls this from the device-step
        worker; the watchdog poll consumes the flag on the event loop, so
        requested restarts serialize with stall restarts."""
        if not self._requested_restart:
            self._requested_restart = reason

    # -- watchdog ---------------------------------------------------------
    def _stalled(self, now: float) -> str:
        """Non-empty reason string when the plane needs a restart."""
        task = self.runtime._task
        if task is None:
            return ""  # not started (or stopped on purpose): nothing to guard
        if task.done():
            if task.cancelled():
                return ""  # deliberate stop between our samples
            exc = task.exception()
            return f"serving loop died: {exc!r}" if exc else "serving loop exited"
        ticks = self.runtime.stats.get("ticks", 0)
        if ticks != self._ticks_seen:
            self._ticks_seen = ticks
            self._progress_at = now
            if self._attempts:
                self.log.info("plane healthy after restart", restarts=self.restarts)
            self._attempts = 0  # healthy: future failures start a fresh budget
            return ""
        # The first tick after a (re)start may legitimately block for many
        # seconds in a cold kernel build; restarting mid-build loses the
        # in-flight tick's packets AND abandons a worker thread in the
        # middle of it. Hold the relaxed warmup deadline until the first
        # tick completes.
        deadline = (
            self.tick_deadline_s
            if ticks > self._baseline_ticks
            else self.warmup_deadline_s
        )
        # "Overloaded but making progress" is the governor's job, not
        # ours: while it is engaged (level > 0) widen the stall deadline
        # so load-induced lateness cannot trigger a restart storm. A
        # truly wedged plane still trips the widened deadline.
        gov = getattr(self.runtime, "governor", None)
        if gov is not None and gov.level > 0 and ticks > self._baseline_ticks:
            deadline = max(deadline, self.tick_deadline_s * self.overload_grace)
        if now - self._progress_at > deadline:
            return f"tick watchdog: no progress in {now - self._progress_at:.2f}s"
        return ""

    async def _watchdog(self) -> None:
        while True:
            await asyncio.sleep(self.check_interval_s)
            if self.draining or self.fenced:
                # Quiescing on purpose: never restart a drain or a
                # fenced minority that must stay silent.
                continue
            cause = "stall"
            reason = self._requested_restart
            if reason:
                self._requested_restart = ""
                cause = "integrity"
            else:
                reason = self._stalled(time.monotonic())
            if not reason:
                continue
            if self._attempts >= self.max_restarts:
                self.gave_up = True
                self.log.error(
                    "plane restart budget exhausted; supervisor giving up",
                    attempts=self._attempts, reason=reason,
                )
                return
            await self._restart(reason, cause=cause)

    async def _restart(self, reason: str, cause: str = "stall") -> None:
        rt = self.runtime
        attempt = self._attempts
        self._attempts += 1
        self.log.warn("restarting media plane", reason=reason, cause=cause,
                      attempt=self._attempts, cap=self.max_restarts)
        # Invalidate any in-flight device step FIRST: a stale step
        # completing on the abandoned thread must not commit its state
        # over the restore below, and the loop's cancel path reads the
        # bump as "abandon the step in flight, do not wait for it".
        rt.bump_epoch()
        await rt.stop()
        # The old worker thread may be wedged inside the device call
        # forever; hand the runtime a fresh executor and let the stale
        # thread die with its daemon flag.
        old = rt._executor
        rt._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="plane")
        old.shutdown(wait=False)
        await self._restore_from_checkpoint()
        await asyncio.sleep(self.backoff.delay(attempt))
        self._ticks_seen = rt.stats.get("ticks", 0)
        self._baseline_ticks = self._ticks_seen
        self._progress_at = time.monotonic()
        rt.start()
        self.restarts += 1
        self.restart_causes[cause] = self.restart_causes.get(cause, 0) + 1
        bb = getattr(rt, "blackbox", None)
        if bb is not None:
            bb.emit(bb.NODE, EV_RESTART, float(self._attempts))
            bb.dump_to(bb.NODE, f"plane_restart:{cause}")
        if self.telemetry is not None:
            self.telemetry.add("livekit_plane_restarts_total")
            self.telemetry.add(
                "livekit_plane_restarts_by_cause_total", cause=cause
            )

    async def _restore_from_checkpoint(self) -> bool:
        """Restore the plane from the newest checkpoint generation that
        both VERIFIES (checksum) and VALIDATES (leaf shapes/dtypes vs the
        live plane). Each rejected generation counts a fallback. With no
        usable generation (fresh supervisor, or all corrupt) the plane
        restarts on its current state, copied through the host onto fresh
        tensors: the runtime writes state in place, so the restarted loop
        must not share tensors with a step the restart abandoned."""
        rt = self.runtime
        for i, blob in enumerate(list(self._gens)):
            try:
                snap = rt.decode_snapshot(blob)
                async with rt.state_lock:
                    rt.restore(snap)
                return True
            except (ValueError, KeyError, OSError) as e:
                self.ckpt_fallbacks += 1
                self.log.warn(
                    "checkpoint generation rejected at restore; falling back",
                    generation=i, error=str(e),
                )
        if self.last_snapshot is not None:
            # Same-process fallback: the raw dict snapshot (cannot have
            # bit-rotted — it never left memory unencoded).
            async with rt.state_lock:
                rt.restore(self.last_snapshot)
            return True
        async with rt.state_lock:
            rt.restore(rt.snapshot())
        return False
