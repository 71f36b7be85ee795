"""Forwarded (packet, subscriber) writes of every tick completed in the
window, over the window's wall time (host clock)."""


def read(rec):
    return rec.writes / rec.window_s if rec.window_s > 0 else None
