"""Parity of the port's layer selection and phase-0 forward decision
(livekit_server_tpu_torch.ops.selector / svc) with the JAX reference.

Seeded numpy inputs go through both packages; the JAX kernel runs as its
own tests run it on the CPU (Pallas interpret mode), beside its composed
fallback. Every output is integer or bool and must match exactly.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from livekit_server_tpu.ops import selector as jsel, svc as jsvc  # noqa: E402
from livekit_server_tpu_torch.ops import selector as tsel, svc as tsvc  # noqa: E402

WIRE_OVERHEAD = 42
# Jitted once per shape: the kernel in Pallas interpret mode, and the
# composed fallback.
_JAX_INTERPRET = jax.jit(functools.partial(
    jsel.decide_rooms, wire_overhead=WIRE_OVERHEAD, interpret=True))
_JAX_FALLBACK = jax.jit(functools.partial(
    jsel.decide_rooms, wire_overhead=WIRE_OVERHEAD, use_pallas=False))


def _decide_inputs(rng, R, T, K, S, cur=None):
    st = [
        rng.integers(-1, 3, (R, T, S)) if cur is None else cur[0],
        rng.integers(-1, 4, (R, T, S)) if cur is None else cur[1],
        rng.integers(-1, 3, (R, T, S)),          # -1 targets: paused
        rng.integers(0, 4, (R, T, S)),
    ]
    st = [np.asarray(x, np.int32) for x in st]
    flags = [rng.random((R, T)) < 0.5, rng.random((R, T)) < 0.6,
             rng.random((R, T, S)) < 0.7]
    pkt = [rng.integers(0, 3, (R, T, K)).astype(np.int32),
           rng.integers(0, 4, (R, T, K)).astype(np.int32),
           rng.random((R, T, K)) < 0.3, rng.random((R, T, K)) < 0.5,
           rng.random((R, T, K)) < 0.4, rng.random((R, T, K)) < 0.9,
           rng.integers(40, 1300, (R, T, K)).astype(np.int32)]
    return st, flags, pkt


def _run_both(st, flags, pkt):
    j_args = [jsel.SelectorState(*map(jnp.asarray, st)),
              *map(jnp.asarray, flags), *map(jnp.asarray, pkt)]
    t_args = [tsel.SelectorState(*map(torch.from_numpy, st)),
              *map(torch.from_numpy, flags), *map(torch.from_numpy, pkt)]
    port = tsel.decide_rooms(*t_args, wire_overhead=WIRE_OVERHEAD)
    return port, _JAX_INTERPRET(*j_args), _JAX_FALLBACK(*j_args)


def _leaves(out):
    return [*out[0], *out[1:]]


def _assert_exact(port, ref):
    for i, (p, r) in enumerate(zip(_leaves(port), _leaves(ref))):
        r = np.asarray(r)
        p = p.numpy()
        assert p.shape == r.shape, i
        assert np.array_equal(p, r.astype(p.dtype)), i


@pytest.mark.parametrize("dims", [(4, 3, 5, 7), (2, 3, 4, 40)])
def test_decide_rooms_matches_interpret_and_fallback(dims):
    """Simulcast and SVC tracks, paused targets, audio tracks, and S up to
    40 (W = 2 mask words): every output equal to the JAX kernel (interpret
    mode) and to its fallback."""
    rng = np.random.default_rng(sum(dims))
    port, interp, fallback = _run_both(*_decide_inputs(rng, *dims))
    _assert_exact(port, interp)
    _assert_exact(port, fallback)


def test_decide_rooms_state_feedback_parity():
    """The updated selector state fed back across ticks stays identical
    (drift would only show through the current/target loop)."""
    rng = np.random.default_rng(23)
    R, T, K, S = 2, 3, 4, 40   # the shape of a case above: one compile
    st, flags, _ = _decide_inputs(rng, R, T, K, S)
    st[0][:] = -1
    st[1][:] = -1
    for tick in range(4):
        _, _, pkt = _decide_inputs(rng, R, T, K, S)
        port, interp, _ = _run_both(st, flags, pkt)
        _assert_exact(port, interp)
        st = [np.array(x) for x in interp[0]]


def _select_inputs(rng, T, K, S):
    state = [rng.integers(-1, 3, (T, S)), rng.integers(-1, 4, (T, S)),
             rng.integers(-1, 3, (T, S)), rng.integers(0, 4, (T, S))]
    state = [np.asarray(x, np.int32) for x in state]
    pkt = [rng.integers(0, 3, (T, K)).astype(np.int32),
           rng.integers(0, 4, (T, K)).astype(np.int32),
           rng.random((T, K)) < 0.3, rng.random((T, K)) < 0.5,
           rng.random((T, K)) < 0.4, rng.random((T, K)) < 0.9]
    return state, pkt


@pytest.mark.parametrize("variant", ["simulcast", "svc", "both"])
def test_select_tick_matches_reference(variant):
    """Per-track selection scans: simulcast (selector.select_tick), SVC
    (svc.select_tick) and the merged select_both_tick."""
    rng = np.random.default_rng(5)
    T, K, S = 5, 6, 9
    state, pkt = _select_inputs(rng, T, K, S)
    js = [jnp.asarray(x) for x in state]
    jp = [jnp.asarray(x) for x in pkt]
    ts = [torch.from_numpy(x) for x in state]
    tp = [torch.from_numpy(x) for x in pkt]
    if variant == "simulcast":
        ref = jax.vmap(jsel.select_tick)(jsel.SelectorState(*js), jp[0], jp[1],
                                         jp[2], jp[3], jp[5])
        port = tsel.select_tick(tsel.SelectorState(*ts), tp[0], tp[1], tp[2],
                                tp[3], tp[5])
    elif variant == "svc":
        ref = jax.vmap(jsvc.select_tick)(jsvc.SVCSelectorState(*js), *jp)
        port = tsvc.select_tick(tsvc.SVCSelectorState(*ts), *tp)
    else:
        is_svc = rng.random(T) < 0.5
        ref = jsel.select_both_tick(jsel.SelectorState(*js), jnp.asarray(is_svc), *jp)
        port = tsel.select_both_tick(tsel.SelectorState(*ts),
                                     torch.from_numpy(is_svc), *tp)
    for p, r in zip(_leaves(port), _leaves(ref)):
        assert np.array_equal(p.numpy(), np.asarray(r))
