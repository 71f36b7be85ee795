"""Order statistics of the window's ticks.

The 95th percentile takes the rank rule of the port's tools/timing.py
`percentiles` (the sorted sample's element at int(q · (n − 1))), frozen
here so that later changes to the port cannot move the yardstick.
"""

from __future__ import annotations


def p95(xs) -> float | None:
    """The sorted sample's element at int(0.95 · (n − 1)); None when empty."""
    xs = sorted(xs)
    if not xs:
        return None
    return xs[int(0.95 * (len(xs) - 1))]
