"""B2 `allocate_budget_rooms` (csrc/budget_rooms.cu): least time from the
bytes its shapes need at the card's peak memory rate, over its profiled
time a launch (kernel name `budget_rooms_kernel`)."""

from sfu_bench import roofline


def read(rec):
    k = rec.trace.kernel("budget_rooms_kernel") if rec.trace is not None else None
    if not k:
        return None
    R, T, K, S = rec.dims
    return roofline.roofline_pct(roofline.budget_rooms_bytes(R, T, S), k[0] / k[1],
                                 rec.device_name)
