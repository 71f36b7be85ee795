"""Median over the traced stretch of the host span of `plane.pack` a call,
in ms (pack_tick_outputs; models/plane.py): the launch work the host does
for that block of the eager tick (sfu_bench/blockspans.py)."""

from sfu_bench import blockspans


def read(rec):
    return blockspans.block_ms(rec, "pack")
