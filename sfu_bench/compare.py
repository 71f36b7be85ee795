"""The comparison that decides `correct`: the program's numbers against the
reference's, leaf by leaf.

Integer and bool leaves (send/drop/switch bits, keyframe requests,
targets, counts, qualities, selector layers, RTP stats counters) are
exact: `int_words` counts the words that differ. Float
leaves (rates, levels, EMAs, budgets) are held by `float_err`, the
largest gap of an element from the reference's, scaled by the reference's
magnitude there or by a thousandth of the leaf's largest magnitude,
whichever is larger (so leaves that sit near zero, where any rounding is
a large relative error, are judged against their own scale).
"""

from __future__ import annotations

import numpy as np

# float_err of a float leaf that is non-finite where the reference's is not.
NON_FINITE = 1e30


def care(out) -> dict:
    """Words of a tick's outputs that carry meaning where not all do. A
    RED candidate's RTP-time offset counts only where the plan takes the
    candidate (`red_ok`): elsewhere it is the slot's own RTP time, and an
    empty ingest slot keeps whatever RTP time the staging set held last."""
    return {"red_off": np.asarray(out.red_ok, bool)}


class Tally:
    """Running totals of one run's comparisons."""

    def __init__(self, float_limit: float):
        self.float_limit = float_limit
        self._tick_err = 0.0
        self.int_words = 0
        self.float_err = 0.0
        self.worst = ""            # where float_err was read
        self.first_int = ""        # the first integer leaf that differed
        self.ticks = 0
        self.bad_ticks = 0
        self.full = []             # ticks compared at full width

    def leaves(self, got, want, names, where: str, care: dict | None = None) -> bool:
        """Compare lists of arrays; False when an integer word differs.
        Float gaps go into `float_err` and into this tick's largest gap.
        `care` maps a leaf's name to a bool mask of the words that carry
        meaning (the others are not compared)."""
        ok = True
        care = care or {}
        for g, w, n in zip(got, want, names):
            g, w = np.asarray(g), np.asarray(w)
            if n in care and g.shape == w.shape:
                m = np.asarray(care[n], bool)
                g, w = g[m], w[m]
            if g.shape != w.shape:
                self.int_words += max(g.size, w.size)
                self.first_int = self.first_int or f"{where}:{n} shape {g.shape} vs {w.shape}"
                ok = False
                continue
            if w.dtype.kind == "f":
                g64, w64 = g.astype(np.float64), w.astype(np.float64)
                if not (np.isfinite(g64).all() and np.isfinite(w64).all()):
                    same = np.array_equal(g64, w64, equal_nan=True)
                    if not same:
                        self.float_err = self._tick_err = NON_FINITE
                        self.worst = f"{where}:{n} non-finite"
                        ok = False
                    continue
                scale = max(float(np.abs(w64).max(initial=0.0)) * 1e-3, 1e-12)
                err = np.abs(g64 - w64) / np.maximum(np.abs(w64), scale)
                e = float(err.max(initial=0.0))
                self._tick_err = max(self._tick_err, e)
                if e > self.float_err:
                    self.float_err, self.worst = e, f"{where}:{n}"
            else:
                bad = int((g.astype(np.int64) != w.astype(np.int64)).sum())
                if bad:
                    self.int_words += bad
                    self.first_int = self.first_int or f"{where}:{n}"
                    ok = False
        return ok

    def missing(self, what: str) -> None:
        """A comparison that could not be made counts as an integer
        difference."""
        self.int_words += 1
        self.first_int = self.first_int or f"missing: {what}"

    def tick_done(self, ok: bool) -> None:
        """Close one checked tick: bad when an integer word differed or a
        float gap passed the limit."""
        self.ticks += 1
        self.bad_ticks += 0 if ok and self._tick_err <= self.float_limit else 1
        self._tick_err = 0.0

    def checks(self, limits: dict) -> list:
        from sfu_bench.core import Check

        return [Check("int_words", self.int_words, limits["int_words"]),
                Check("float_err", self.float_err, limits["float_err"])]
