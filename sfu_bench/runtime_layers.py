"""The served path's stage counters over the untraced window: each reader
of `metrics/rt_*_ms.py` gives a stage's seconds a tick in ms, from the
window's change in the runtime's `stats` counters (`paths/runtime.py`
`layer_totals`). None where a counter it needs is missing, as in a
program older than the counters."""

from __future__ import annotations


def ms_per_tick(rec, *counters: str, minus: str | None = None):
    """1000 × (the sum of `counters`, less `minus`) ÷ the window's ticks."""
    need = counters + ((minus,) if minus else ())
    if rec.ticks <= 0 or any(c not in rec.layers for c in need):
        return None
    s = sum(rec.layers[c] for c in counters) - (rec.layers[minus] if minus else 0.0)
    return 1000.0 * s / rec.ticks
