"""Share of the traced stretch's wall time in which no kernel, memcpy or
memset ran on the card (profiler trace)."""


def read(rec):
    t = rec.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
