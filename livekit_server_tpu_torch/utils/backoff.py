"""Uniform retry/timeout/backoff policy for every re-dial path.

A copy of the JAX package's utils/backoff.py. One policy object for
every re-dial and restart path (the plane supervisor's restart backoff
here): exponential backoff with full jitter (the AWS architecture-blog
shape — deterministic under a seeded rng for chaos tests), an attempt
cap, and a circuit breaker so a dependency that is hard-down stops
consuming the caller's event loop with futile dials.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with full jitter (default on).

    delay(n) ~ uniform(floor·cap, cap) with cap = min(base · mult^n,
    max_delay) — the AWS architecture-blog full-jitter shape, floored at
    `jitter_floor`·cap so a pathological draw cannot spin-dial at ~0 ms.
    Full jitter decorrelates a fleet of clients re-dialing the same dead
    bus after a regional cut: N clients draw independently across 90% of
    the cap instead of landing on the same deterministic beat and
    thundering the bus in synchronized waves. Pass a seeded
    `random.Random` for reproducible chaos drills (each simulated client
    gets its own seed; same seeds → byte-identical delay sequences).
    """

    base: float = 0.05
    max_delay: float = 5.0
    multiplier: float = 2.0
    max_attempts: int = 0        # 0 = unbounded
    jitter: bool = True
    jitter_floor: float = 0.1    # fraction of cap a draw can never go below

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        cap = min(self.base * (self.multiplier ** attempt), self.max_delay)
        if not self.jitter:
            return cap
        r = rng.random() if rng is not None else random.random()
        return cap * (self.jitter_floor + (1.0 - self.jitter_floor) * r)

    def exhausted(self, attempt: int) -> bool:
        return bool(self.max_attempts) and attempt >= self.max_attempts


class CircuitBreaker:
    """Failure-rate trip switch shared by retry loops.

    closed → open after `threshold` consecutive failures; open rejects
    instantly (no dial, no sleep) until `cooldown_s` elapses, then one
    half-open probe is allowed through — success closes, failure re-opens.
    """

    def __init__(self, threshold: int = 8, cooldown_s: float = 10.0):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.opened_at = 0.0
        self.trips = 0

    @property
    def open(self) -> bool:
        if self.failures < self.threshold:
            return False
        return (time.monotonic() - self.opened_at) < self.cooldown_s

    def allow(self) -> bool:
        """True if a call may proceed (closed, or half-open probe)."""
        return not self.open

    def record_success(self) -> None:
        self.failures = 0

    def record_failure(self) -> None:
        self.failures += 1
        if self.failures == self.threshold:
            self.opened_at = time.monotonic()
            self.trips += 1
        elif self.failures > self.threshold:
            # Half-open probe failed: restart the cooldown window.
            self.opened_at = time.monotonic()


class CircuitOpen(ConnectionError):
    """Raised when the breaker rejects a call without attempting it."""


class RetryAborted(Exception):
    """Raised when `should_abort` turns true between attempts (e.g. the
    owning client was closed while its reconnect loop slept)."""


def _default_give_up(attempts: int, err: BaseException) -> None:
    from livekit_server_tpu_torch.utils.logger import log

    log.warn(
        "retry_async giving up",
        attempts=attempts, error=type(err).__name__, detail=str(err),
    )


async def retry_async(
    fn: Callable[[], Awaitable[T]],
    policy: BackoffPolicy,
    *,
    retry_on: tuple[type[BaseException], ...] = (ConnectionError, OSError),
    timeout: float | None = None,
    breaker: CircuitBreaker | None = None,
    on_retry: Callable[[int, BaseException], None] | None = None,
    on_give_up: Callable[[int, BaseException], None] | None = None,
    wait_when_open: bool = False,
    should_abort: Callable[[], bool] | None = None,
    rng: random.Random | None = None,
) -> T:
    """Run `fn` under the policy: per-attempt `timeout`, backoff between
    attempts, breaker consulted before each. Raises the last error when
    attempts are exhausted, or CircuitOpen when the breaker rejects.

    `on_give_up(attempts, err)` fires once, just before the final raise
    at exhaustion (default: logs the attempt count — a silent give-up
    looks identical to a hang from the caller's side). `wait_when_open`
    turns a breaker rejection into a cooldown sleep instead of
    CircuitOpen — the shape a persistent reconnect loop wants.
    `should_abort` is polled before each attempt; True raises
    RetryAborted (e.g. the owning client was closed mid-backoff)."""
    attempt = 0
    while True:
        if should_abort is not None and should_abort():
            raise RetryAborted("aborted between retry attempts")
        if breaker is not None and not breaker.allow():
            if not wait_when_open:
                raise CircuitOpen("circuit breaker open")
            await asyncio.sleep(breaker.cooldown_s)
            continue
        try:
            if timeout is not None:
                result = await asyncio.wait_for(fn(), timeout)
            else:
                result = await fn()
        except retry_on + (asyncio.TimeoutError,) as e:  # noqa: PERF203
            if breaker is not None:
                breaker.record_failure()
            if policy.exhausted(attempt + 1):
                (on_give_up or _default_give_up)(attempt + 1, e)
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            await asyncio.sleep(policy.delay(attempt, rng))
            attempt += 1
            continue
        if breaker is not None:
            breaker.record_success()
        return result
