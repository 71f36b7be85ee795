"""Device time (kernels, memcpy, memset, summed) a tick over the traced
stretch (profiler trace)."""


def read(rec):
    t = rec.trace
    if t is None or t.device_sum_s <= 0:
        return None
    return 1000.0 * t.device_sum_s / t.ticks
