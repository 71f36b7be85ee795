"""Process start to the start of the window: imports, the build or cache
load, state, the traffic library, warm-up (host clock)."""


def read(rec):
    return rec.setup_s
