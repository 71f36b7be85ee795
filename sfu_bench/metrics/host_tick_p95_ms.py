"""95th percentile over the window's ticks of one tick's time, from its
first launch to its completion (host clock; each tick ends at a
synchronize). A per-layer metric of the tick loop: the host's launch
work paces it, and its spread between runs is too wide for a bound an
end-to-end metric may have."""

from sfu_bench import stats


def read(rec):
    p = stats.p95(rec.tick_s)
    return None if p is None else 1000.0 * p
