"""Block spans of the eager tick: where each block of models/plane.py's
tick starts and how long the host takes to launch it, per thread; and
the names of a served tick's timed stages.

The tick's blocks (`BLOCKS`, in tick order) each open a span where they
launch their ops; `tick` encloses decide through allocate. A span is two
`perf_counter_ns` reads and a few scalar stores into the calling thread's
preallocated ring for that span, and is recorded only while the recorder
is on: while a torch profiler records, or while the thread's flight
recorder is on (`set_flight`: a PlaneRuntime with its trace ring turns it
on for the thread that runs its device step). Off, opening a span reads
two flags and closing it returns at once.

A served tick's stages (`STAGES`) are not spans of this recorder: the
runtime times each once into the tick's record (runtime/plane_runtime.py
`StagedTick`), and its `stats` counters and trace ring (runtime/trace.py)
read that record. The stages a trace export shows are `RUNTIME`'s, named
`runtime.<stage>`.

With `annotate` on, each span also opens a `record_function` range named
after it (`plane.<span>`). Only the program's own tooling turns it on
(`tools.profile_tick --trace`): a range that encloses kernels shows in a
profiler's device events too, so a profiler the program did not start
gets the host-clock spans alone.

Times are perf_counter nanoseconds; `SpanRecorder.epoch_ns` converts one
to the unix epoch through the anchor taken when the recorder was made,
the clock of a torch profiler's Chrome trace (`baseTimeNanoseconds` plus
`ts`).

Torch-free, and importing nothing of the package: models/plane.py
imports it at load time, and runtime/plane_runtime.py, runtime/trace.py
and telemetry/trace_export.py read its stage names.
"""

from __future__ import annotations

import sys
import threading
import time

BLOCKS = ("unpack", "decide", "rtpstats", "streamtracker", "bwe", "quality", "red",
          "audio", "allocate", "pack")
SPANS = BLOCKS + ("tick",)
(UNPACK, DECIDE, RTPSTATS, STREAMTRACKER, BWE, QUALITY, RED, AUDIO, ALLOCATE, PACK,
 TICK) = range(len(SPANS))
NAMES = tuple(f"plane.{s}" for s in SPANS)
# A served tick's timed stages: the ingest pushes drained into it, its
# staging (drain and pack) with the express retier inside it, the probe,
# the ctrl upload, the device step with the paged kernel's span inside
# it, the fan-out with the munge walk and the views after it, and the
# egress send.
STAGES = ("push", "stage", "retier", "probe", "upload", "device_step", "kernel", "fanout",
          "munge", "views", "send")
(PUSH, STAGE, RETIER, PROBE, UPLOAD, DEVICE_STEP, KERNEL, FANOUT, MUNGE, VIEWS,
 SEND) = range(len(STAGES))
# The stages a trace export shows, by their span names.
RUNTIME = {s: f"runtime.{STAGES[s]}" for s in (PUSH, STAGE, PROBE, DEVICE_STEP, MUNGE, VIEWS)}
CAP = 512           # calls each span's ring keeps

_now = time.perf_counter_ns


class SpanRecorder:
    """One thread's rings: the start and duration (perf_counter ns) of the
    newest `cap` calls of each span."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.flight = False         # the thread's flight recorder is on (set_flight)
        self.annotate = False       # also open record_function ranges
        self.t0 = [[0] * cap for _ in SPANS]
        self.dur = [[0] * cap for _ in SPANS]
        self.count = [0] * len(SPANS)
        self._ranges: list = []
        self.anchor_ns = _now()
        self.anchor_epoch_ns = time.time_ns()

    def epoch_ns(self, t_ns: int) -> int:
        """A perf_counter_ns stamp on the unix epoch, through the anchor."""
        return self.anchor_epoch_ns + (t_ns - self.anchor_ns)

    def mark(self) -> list[int]:
        """The calls each span has recorded so far (for `last`)."""
        return list(self.count)

    def last(self, mark: list[int] | None = None) -> list[tuple[int, int]]:
        """(start, duration) in ns of each span's newest call, in `SPANS`
        order; (0, 0) for a span with no call since `mark`."""
        out = []
        for i, n in enumerate(self.count):
            if n == 0 or (mark is not None and n == mark[i]):
                out.append((0, 0))
            else:
                j = (n - 1) % self.cap
                out.append((self.t0[i][j], self.dur[i][j]))
        return out

    def calls(self, span: int) -> list[tuple[int, int]]:
        """(start, duration) in ns of the span's retained calls, oldest
        first."""
        n = self.count[span]
        take = min(n, self.cap)
        return [(self.t0[span][j % self.cap], self.dur[span][j % self.cap])
                for j in range(n - take, n)]

    def _open(self, span: int) -> None:
        from torch.autograd.profiler import record_function

        r = record_function(NAMES[span])
        r.__enter__()
        self._ranges.append(r)

    def _close(self) -> None:
        self._ranges.pop().__exit__(None, None, None)


class _Local(threading.local):
    rec: SpanRecorder | None = None


_local = _Local()
_prof = None            # torch.autograd.profiler, once torch has loaded it
_flights = 0            # threads whose flight recorder is on
_flights_lock = threading.Lock()


def _profiler():
    """torch.autograd.profiler, whose `_is_profiler_enabled` says whether a
    torch profiler records; None before torch is loaded."""
    global _prof
    _prof = sys.modules.get("torch.autograd.profiler")
    return _prof


def recorder() -> SpanRecorder:
    """The calling thread's recorder, made on first use."""
    rec = _local.rec
    if rec is None:
        rec = _local.rec = SpanRecorder()
    return rec


def current() -> SpanRecorder | None:
    """The calling thread's recorder, or None where it has none."""
    return _local.rec


def set_flight(on: bool) -> SpanRecorder:
    """Turn the calling thread's flight recorder on or off; returns the
    thread's recorder."""
    global _flights
    rec = recorder()
    if rec.flight != on:
        with _flights_lock:
            rec.flight = on
            _flights += 1 if on else -1
    return rec


def begin(span: int) -> int:
    """Open `span`: its start stamp, or 0 while the recorder is off."""
    p = _prof or _profiler()
    if p is None or not p._is_profiler_enabled:
        if not _flights:
            return 0
        rec = _local.rec
        if rec is None or not rec.flight:
            return 0
    else:
        rec = recorder()
    t0 = _now()
    if rec.annotate:
        rec._open(span)
    return t0


def end(span: int, t0: int) -> int:
    """Close `span`, opened at `t0` (0: not recorded); returns the stamp
    it closed at, or 0."""
    if not t0:
        return 0
    t1 = _now()
    rec = _local.rec
    n = rec.count[span]
    j = n % rec.cap
    rec.t0[span][j] = t0
    rec.dur[span][j] = t1 - t0
    rec.count[span] = n + 1
    if rec._ranges:
        rec._close()
    return t1


def lap(span: int, t0: int, nxt: int) -> int:
    """Close `span` and open `nxt` at the stamp it closed at, so that
    adjacent blocks leave no gap; returns that stamp, or 0."""
    if not t0:
        return 0
    t1 = end(span, t0)
    rec = _local.rec
    if rec.annotate:
        rec._open(nxt)
    return t1
