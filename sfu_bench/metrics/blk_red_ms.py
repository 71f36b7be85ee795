"""Median over the traced stretch of the host span of `plane.red` a call, in
ms (red.encode_plan_tick or its empty branch; models/plane.py): the launch
work the host does for that block of the eager tick
(sfu_bench/blockspans.py)."""

from sfu_bench import blockspans


def read(rec):
    return blockspans.block_ms(rec, "red")
