"""Median over the traced stretch of the host span of `plane.audio` a call,
in ms (observe_tick, top_speakers, the state and outputs assembly;
models/plane.py): the launch work the host does for that block of the eager
tick (sfu_bench/blockspans.py)."""

from sfu_bench import blockspans


def read(rec):
    return blockspans.block_ms(rec, "audio")
