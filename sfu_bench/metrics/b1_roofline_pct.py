"""B1 `decide_rooms` (csrc/decide_rooms.cu): least time from the bytes its
shapes need at the card's peak memory rate, over its profiled time a
launch (kernel name `decide_rooms_kernel`)."""

from sfu_bench import roofline


def read(rec):
    k = rec.trace.kernel("decide_rooms_kernel") if rec.trace is not None else None
    if not k:
        return None
    R, T, K, S = rec.dims
    return roofline.roofline_pct(roofline.decide_rooms_bytes(R, T, K, S), k[0] / k[1],
                                 rec.device_name)
