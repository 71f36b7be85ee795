"""Build ledger: count the port's one-off builds, fail drills that rebuild.

The counterpart of the reference's recompile watchdog. The port has no
XLA and no tracing; what stands for a backend compile there — a one-off
cost that must not recur once a node serves — is one of three things:

  * `nvcc`: a CUDA kernel built by `ops/cuda.py` `build`, with the
    seconds it took;
  * `g++`: a native library built by `native/__init__.py` `_compile`,
    with the seconds it took (a cache hit on an existing `.so` is not a
    build);
  * `launch_shape`: the first launch of a hand kernel at a
    (kernel, launch shape) this process has not launched before,
    recorded by the three wrappers that add to `ops/cuda.py` `launches`
    at the point where they do. This is the port's analogue of a shape
    that escaped the pow2 buckets: the runtimes pad their extents to
    fixed shapes and pow2 buckets precisely so that steady state
    launches at shapes it has seen.

Usage: `PlaneRuntime.__init__` installs the ledger as
`self.compile_ledger`, the node stack calls `mark_warm()` after its warm
step, and from then on `post_warmup` must stay 0 on the serving path.
`/debug/compiles` returns `snapshot()`, and `/metrics` carries
`livekit_kernel_builds_total` and `livekit_kernel_builds_post_warmup`
(the counterparts of the reference's `livekit_xla_compiles_*`).

The ledger is one per process, like the builds it counts: every runtime
in a process shares it (tests reset the counters).
"""

from __future__ import annotations

import threading
from collections import deque

KINDS = ("nvcc", "g++", "launch_shape")


class CompileLedger:
    """Process-wide build counter with a warm-up watermark."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.total = 0
        self.total_ms = 0.0
        self.by_kind = dict.fromkeys(KINDS, 0)
        self.ms_by_kind = dict.fromkeys(KINDS, 0.0)
        self._warm_total = 0
        self._warm_ms = 0.0
        self._warm_set = False
        self._shapes: set[tuple] = set()
        # (kind, what, ms) ring for /debug/compiles — enough to see what
        # was built without growing unbounded
        self.recent: deque[tuple[str, str, float]] = deque(maxlen=64)

    def record(self, kind: str, what: str, ms: float = 0.0) -> None:
        """Count one build of `kind` (one of KINDS)."""
        if kind not in KINDS:
            raise ValueError(f"unknown build kind {kind!r}")
        with self._lock:
            self.total += 1
            self.total_ms += ms
            self.by_kind[kind] += 1
            self.ms_by_kind[kind] += ms
            self.recent.append((kind, what, round(ms, 2)))

    def record_launch(self, kernel: str, shape: tuple) -> bool:
        """Note a launch of `kernel` at `shape`; the first at a shape this
        process has not launched counts as a `launch_shape` entry.
        Returns True when it counted."""
        key = (kernel, tuple(int(d) for d in shape))
        with self._lock:
            if key in self._shapes:
                return False
            self._shapes.add(key)
        self.record("launch_shape", f"{kernel}{list(key[1])}")
        return True

    def mark_warm(self) -> int:
        """Set the watermark: builds after this are steady-state rebuilds —
        the thing the ledger exists to catch. Returns the total at the
        watermark."""
        with self._lock:
            self._warm_total = self.total
            self._warm_ms = self.total_ms
            self._warm_set = True
            return self.total

    @property
    def post_warmup(self) -> int:
        with self._lock:
            return self.total - self._warm_total

    @property
    def warmup_ms(self) -> float:
        """Build time spent before the watermark."""
        with self._lock:
            return self._warm_ms if self._warm_set else self.total_ms

    def since(self, total: int) -> list[tuple[str, str, float]]:
        """The entries recorded after the ledger stood at `total` (as far
        as the ring reaches back)."""
        with self._lock:
            n = min(self.total - total, len(self.recent))
            return list(self.recent)[len(self.recent) - n:] if n > 0 else []

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "builds_total": self.total,
                "builds_post_warmup": self.total - self._warm_total,
                "build_ms": round(self.total_ms, 1),
                "warmup_build_ms": round(
                    self._warm_ms if self._warm_set else self.total_ms, 1),
                "by_kind": dict(self.by_kind),
                "ms_by_kind": {k: round(v, 1) for k, v in self.ms_by_kind.items()},
                "launch_shapes": len(self._shapes),
                "recent": [list(e) for e in list(self.recent)[-8:]],
            }

    def reset(self) -> None:
        """Test seam: zero the counters and forget the launch shapes."""
        with self._lock:
            self.total = 0
            self.total_ms = 0.0
            self.by_kind = dict.fromkeys(KINDS, 0)
            self.ms_by_kind = dict.fromkeys(KINDS, 0.0)
            self._warm_total = 0
            self._warm_ms = 0.0
            self._warm_set = False
            self._shapes.clear()
            self.recent.clear()


LEDGER = CompileLedger()
