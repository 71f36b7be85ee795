"""Median over the traced stretch of the host span of `plane.decide` a call,
in ms (phase 0: the base mask and selector.decide_rooms (B1);
models/plane.py): the launch work the host does for that block of the eager
tick (sfu_bench/blockspans.py)."""

from sfu_bench import blockspans


def read(rec):
    return blockspans.block_ms(rec, "decide")
