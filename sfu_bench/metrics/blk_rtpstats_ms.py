"""Median over the traced stretch of the host span of `plane.rtpstats` a
call, in ms (route_stats and rtpstats.update_tick; models/plane.py): the
launch work the host does for that block of the eager tick
(sfu_bench/blockspans.py)."""

from sfu_bench import blockspans


def read(rec):
    return blockspans.block_ms(rec, "rtpstats")
