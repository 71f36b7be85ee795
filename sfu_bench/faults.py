"""Faults planted under the timed path, each of which the output check has
to catch (sfu_bench/tests and `control.py --fault`). Each is a tick
function in the port's tick's place, (state, inputs) → (state', outputs),
over the port's own tick `base`."""

from __future__ import annotations


def stale_state(base):
    """A step that returns its state unchanged (the outputs are the
    tick's)."""
    def tick(state, inp, *a, **k):
        _, out = base(state, inp, *a, **k)
        return state, out
    return tick


def half_rooms(base):
    """Half of the batch left out: rooms from R/2 on keep their state and
    give zero outputs."""
    def tick(state, inp, *a, **k):
        new, out = base(state, inp, *a, **k)
        h = state.meta.is_video.shape[0] // 2

        def keep(n, o):
            n = n.clone()
            n[h:] = o[h:]
            return n

        def zero(x):
            x = x.clone()
            x[h:] = 0
            return x
        new = type(new)(*[_map2(keep, a_, b_) for a_, b_ in zip(new, state)])
        return new, type(out)(*[zero(x) for x in out])
    return tick


def altered_send(base):
    """An answer altered where it is produced: the first send bit of every
    room's first packet slot flipped."""
    def tick(state, inp, *a, **k):
        new, out = base(state, inp, *a, **k)
        bits = out.send_bits.clone()
        bits[:, 0, 0, 0] ^= 1
        return new, out._replace(send_bits=bits)
    return tick


def _map2(fn, a, b):
    if isinstance(a, tuple):
        return type(a)(*[_map2(fn, x, y) for x, y in zip(a, b)])
    return fn(a, b)


FAULTS = {"stale_state": stale_state, "half_rooms": half_rooms, "altered_send": altered_send}
