"""Median over the traced stretch of the host span of `plane.bwe` a call, in
ms (the row resets, bwe.update_tick, delay_update_tick, pacer.update_tick;
models/plane.py): the launch work the host does for that block of the eager
tick (sfu_bench/blockspans.py)."""

from sfu_bench import blockspans


def read(rec):
    return blockspans.block_ms(rec, "bwe")
