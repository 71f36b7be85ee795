"""Median over the traced stretch of the host span of `plane.allocate` a
call, in ms (phase 2: the masks, allocate_budget_rooms (B2), set_target,
TickOutputs; models/plane.py): the launch work the host does for that block
of the eager tick (sfu_bench/blockspans.py)."""

from sfu_bench import blockspans


def read(rec):
    return blockspans.block_ms(rec, "allocate")
